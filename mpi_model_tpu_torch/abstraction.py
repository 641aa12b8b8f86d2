"""L0 type abstraction: the backend-neutral datatype seam, mapped to torch.

Counterpart of ``mpi_model_tpu/abstraction.py``: the same ``DataType`` enum
(its integer values are the native C ABI tags, so they never change) and the
same ``get_abstraction_data_type`` front door, with ``to_torch`` in place of
``to_jax``, and the JAX package's ``to_numpy`` (the oracle's dtype),
``to_native`` (the C engine's tag, ``native.py``) and ``itemsize``; each of
these takes a ``DataType`` or anything ``get_abstraction_data_type`` maps.
Unsupported types raise ``UnsupportedDataTypeError``.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np
import torch


class DataType(enum.IntEnum):
    """Backend-neutral scalar datatype tags (native ABI values: do not
    reorder)."""

    INT8 = 0
    UINT8 = 1
    INT16 = 2
    UINT16 = 3
    INT32 = 4
    UINT32 = 5
    INT64 = 6
    UINT64 = 7
    FLOAT32 = 8
    FLOAT64 = 9
    BFLOAT16 = 10
    FLOAT16 = 11
    BOOL = 12


class UnsupportedDataTypeError(TypeError):
    """Raised for types outside the supported set."""


_CANONICAL: dict[str, DataType] = {t.name.lower(): t for t in DataType}

_PY_SCALARS: dict[type, DataType] = {
    int: DataType.INT64,
    float: DataType.FLOAT64,
    bool: DataType.BOOL,
}

_TORCH: dict[DataType, torch.dtype] = {
    DataType.INT8: torch.int8,
    DataType.UINT8: torch.uint8,
    DataType.INT16: torch.int16,
    DataType.UINT16: torch.uint16,
    DataType.INT32: torch.int32,
    DataType.UINT32: torch.uint32,
    DataType.INT64: torch.int64,
    DataType.UINT64: torch.uint64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT16: torch.float16,
    DataType.BOOL: torch.bool,
}


def get_abstraction_data_type(tp: Any) -> DataType:
    """Map a dtype-like (torch/numpy dtype, str, python scalar type) to
    ``DataType``."""
    if isinstance(tp, DataType):
        return tp
    if isinstance(tp, type) and tp in _PY_SCALARS:
        return _PY_SCALARS[tp]
    if isinstance(tp, torch.dtype):
        name = str(tp).removeprefix("torch.")
    elif isinstance(tp, str) and tp in _CANONICAL:
        # numpy knows "bfloat16" only once ml_dtypes is loaded
        name = tp
    else:
        try:
            name = np.dtype(tp).name
        except TypeError as exc:
            name = getattr(tp, "name", None) or getattr(tp, "__name__", None)
            if name is None:
                raise UnsupportedDataTypeError(
                    f"unsupported data type: {tp!r}") from exc
    dt = _CANONICAL.get(str(name))
    if dt is None:
        raise UnsupportedDataTypeError(f"unsupported data type: {tp!r}")
    return dt


def to_torch(dt: DataType) -> torch.dtype:
    """DataType → torch dtype (bf16 maps to ``torch.bfloat16``)."""
    return _TORCH[DataType(dt)]



def to_numpy(dt: Any) -> np.dtype:
    """DataType → numpy dtype (the oracle's). numpy has no bfloat16 (the
    JAX package takes ``ml_dtypes``'s, which the port does not load), so a
    bf16 request raises; the port's host copies of a bf16 channel are
    float32 (``CellularSpace.to_numpy``)."""
    dt = get_abstraction_data_type(dt)
    if dt == DataType.BFLOAT16:
        raise UnsupportedDataTypeError(
            "numpy has no bfloat16; the port's host copies of bf16 "
            "channels are float32")
    return np.dtype(dt.name.lower())


def to_native(dt: Any) -> int:
    """DataType → the native engine's dtype tag (``mmtpu_dtype_t``, the
    enum's value)."""
    return int(get_abstraction_data_type(dt))


def itemsize(dt: Any) -> int:
    """Size in bytes of one scalar of this type."""
    return to_torch(get_abstraction_data_type(dt)).itemsize
