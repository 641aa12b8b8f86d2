"""Mean host ms a dispatch spends in the port's ``ensemble.assemble`` and
``ensemble.launch`` spans, over the window's dispatches outside the traced
part."""

from cellbench.readers import spans_ms_per


def read(record):
    return spans_ms_per(record, ("ensemble.assemble", "ensemble.launch"),
                        "ensemble.launch")
