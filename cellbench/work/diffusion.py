"""``Diffusion``'s outflow: one multiplication a cell-step, reading the
flow's own channel."""


def ops(flow: dict) -> int:
    return 1


def reads(flow: dict) -> set:
    return {flow["attr"]}
