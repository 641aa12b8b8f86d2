"""The whole step's share of the card's peak: the roofline time of the
traced part's work (``work/``) over the traced part's length."""

from cellbench.readers import step_mfu


def read(record):
    return step_mfu(record)
