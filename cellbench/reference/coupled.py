"""``Coupled``: every cell sheds ``flow_rate`` times its value times the
value of the modulating channel in the same cell."""


def outflow(values: dict, flow: dict):
    return flow["flow_rate"] * values[flow["attr"]] * values[flow["modulator"]]
