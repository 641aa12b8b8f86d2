"""The share of the traced part in which no device operation ran (the
profiler's timeline)."""

from cellbench.readers import idle_share


def read(record):
    return idle_share(record)
