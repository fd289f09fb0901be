"""ScalarInfo: the "maybe-known" scalar.

Equivalent of the reference's ScalarInfoTyped (src/scalar_info.rs:8,96):
either a concrete numeric value or a SymbolicScalar. Used for tensor
dims and for element values of shape-carrying tensors during inference.

The port's copy of whisper_tensor_tpu/scalar_info.py, unchanged
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from .symbolic import SymbolicScalar

Num = Union[int, float, bool]


@dataclass(frozen=True)
class ScalarInfo:
    numeric: Optional[Num] = None
    symbolic: Optional[SymbolicScalar] = None

    def __post_init__(self):
        if (self.numeric is None) == (self.symbolic is None):
            raise ValueError("exactly one of numeric/symbolic must be set")

    # ------------------------------------------------------------------
    @staticmethod
    def of(v: Union[Num, SymbolicScalar, "ScalarInfo"]) -> "ScalarInfo":
        if isinstance(v, ScalarInfo):
            return v
        if isinstance(v, SymbolicScalar):
            return ScalarInfo(symbolic=v)
        return ScalarInfo(numeric=v)

    @property
    def is_known(self) -> bool:
        return self.numeric is not None

    def value(self) -> Num:
        if self.numeric is None:
            raise ValueError(f"scalar is symbolic: {self.symbolic}")
        return self.numeric

    def value_or(self, default: Num) -> Num:
        return self.numeric if self.numeric is not None else default

    # dims arithmetic used by shape inference -------------------------
    def __add__(self, other: "ScalarInfo") -> "ScalarInfo":
        other = ScalarInfo.of(other)
        if self.is_known and other.is_known:
            return ScalarInfo(numeric=self.numeric + other.numeric)
        if self.symbolic is not None and other.is_known:
            return ScalarInfo(symbolic=self.symbolic + int(other.numeric))
        if other.symbolic is not None and self.is_known:
            return ScalarInfo(symbolic=other.symbolic + int(self.numeric))
        raise _unknown()

    def __mul__(self, other: "ScalarInfo") -> "ScalarInfo":
        other = ScalarInfo.of(other)
        if self.is_known and other.is_known:
            return ScalarInfo(numeric=self.numeric * other.numeric)
        # symbolic * 1 and symbolic * known-0 simplify
        for a, b in ((self, other), (other, self)):
            if b.is_known and b.numeric == 1 and a.symbolic is not None:
                return a
            if b.is_known and b.numeric == 0:
                return ScalarInfo(numeric=0)
        raise _unknown()

    def equals(self, other: "ScalarInfo") -> Optional[bool]:
        """Three-valued equality: True/False if decidable, None if unknown."""
        other = ScalarInfo.of(other)
        if self.is_known and other.is_known:
            return self.numeric == other.numeric
        if self.symbolic is not None and other.symbolic is not None:
            if self.symbolic.same_symbol(other.symbolic):
                return self.symbolic.offset == other.symbolic.offset
        return None

    def __repr__(self) -> str:
        return repr(self.numeric if self.is_known else self.symbolic)


def _unknown() -> Exception:
    return ValueError("arithmetic over two distinct symbols is not representable")
