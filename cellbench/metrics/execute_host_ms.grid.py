"""Mean ms a ``Model.execute`` call spends outside its ``executor.run``:
the initial totals, the report's totals and ``last_execute``, and the
conservation check (the port's ``model.execute`` span less its child),
over the window's calls outside the traced part."""

from cellbench.readers import self_ms


def read(record):
    return self_ms(record, "model.execute", "executor.run")
