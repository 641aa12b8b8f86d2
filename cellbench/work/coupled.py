"""``Coupled``'s outflow, ``rate * v * m``: two multiplications a
cell-step, reading the flow's channel and its modulator."""


def ops(flow: dict) -> int:
    return 2


def reads(flow: dict) -> set:
    return {flow["attr"], flow["modulator"]}
