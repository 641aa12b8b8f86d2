"""The roofline time of the traced part's work (``work/``: the traffic's
steps, each channel read and written once) over the device's busy time in
that part (the union of every kernel, copy and set, from the profiler)."""

from cellbench.readers import roofline_share


def read(record):
    return roofline_share(record)
