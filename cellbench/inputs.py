"""Inputs made from the seed, on the device, in a few large calls.

Each stream of numbers has its own generator, seeded from ``(seed,
stream...)`` through SHA-256, so any whole number is a seed (the driver's
are above 2**31) and the same seed gives the same inputs: the reference
makes them again after the window instead of keeping the program's copy.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(stream)).encode())
    return int.from_bytes(h.digest()[:8], "little") & (2**63 - 1)


def host_rng(seed: int, *stream) -> np.random.Generator:
    """The host's generator of one stream (schedules, samples)."""
    return np.random.default_rng(stream_seed(seed, *stream))


def _generator(seed: int, stream: tuple, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def draw(config: dict, shape: tuple, seed: int, stream: tuple,
         device) -> torch.Tensor:
    """``shape`` values of the configuration's initial law, in its storage
    dtype, made on ``device`` in one call."""
    law = config["init"]
    if law["law"] != "uniform":
        raise ValueError(f"unknown initial law {law['law']!r}")
    g = _generator(seed, stream, device)
    t = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    t.mul_(float(law["high"]) - float(law["low"])).add_(float(law["low"]))
    return t.to(dtype_of(config["storage_dtype"]))


def channels(config: dict) -> list[str]:
    """Every channel a flow of the configuration reads or writes, in the
    order the flows name them."""
    out: list[str] = []
    for f in config["flows"]:
        for key in ("attr", "modulator"):
            ch = f.get(key)
            if ch is not None and ch not in out:
                out.append(ch)
    return out


def grid(config: dict, side: int, seed: int, device) -> dict:
    """One ``side``² grid: every channel of the configuration."""
    names = channels(config)
    t = draw(config, (len(names), side, side), seed, ("grid", side), device)
    return {ch: t[i] for i, ch in enumerate(names)}


def pool(config: dict, side: int, count: int, seed: int, device) -> list:
    """``count`` distinct ``side``² grids, each a dict of channels."""
    names = channels(config)
    t = draw(config, (count, len(names), side, side), seed,
             ("pool", side, count), device)
    return [{ch: t[k, i] for i, ch in enumerate(names)}
            for k in range(count)]
