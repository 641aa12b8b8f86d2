"""The neighbourhoods a configuration may name, as ``(row, column)``
offsets in row-major order. A cell sheds to its in-bounds neighbours; the
grid does not wrap."""

NEIGHBOURHOODS = {
    "moore8": ((-1, -1), (-1, 0), (-1, 1),
               (0, -1), (0, 1),
               (1, -1), (1, 0), (1, 1)),
}


def offsets(config: dict) -> tuple:
    name = config["neighbourhood"]
    if name not in NEIGHBOURHOODS:
        raise ValueError(f"unknown neighbourhood {name!r}")
    if config.get("boundary") != "closed":
        raise ValueError(f"unknown boundary {config.get('boundary')!r}")
    return NEIGHBOURHOODS[name]
