"""Real lanes over dispatched lanes in the window's dispatches (the
service's ``stats()``, read at the window's start and end)."""

from cellbench.readers import batch_occupancy


def read(record):
    return batch_occupancy(record)
