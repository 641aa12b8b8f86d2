"""``Diffusion``: every cell sheds ``flow_rate`` times its value."""


def outflow(values: dict, flow: dict):
    return flow["flow_rate"] * values[flow["attr"]]
