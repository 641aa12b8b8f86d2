"""Attribute: a named cell payload (counterpart of
``mpi_model_tpu/core/attribute.py``). A channel of the grid is a named
``[dim_x, dim_y]`` tensor; this class is the scalar view used at the API
boundary."""

from __future__ import annotations

import dataclasses
from typing import Union

from ..abstraction import DataType, get_abstraction_data_type


@dataclasses.dataclass(frozen=True)
class Attribute:
    """A (key, value) cell payload; ``key`` may be an int or a name."""

    key: Union[int, str]
    value: float

    @property
    def name(self) -> str:
        return self.key if isinstance(self.key, str) else f"attr{self.key}"

    def get_key(self) -> Union[int, str]:
        return self.key

    def get_value(self) -> float:
        return self.value

    def data_type(self) -> DataType:
        return get_abstraction_data_type(type(self.value))
