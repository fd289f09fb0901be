"""TensorInfo: the 4-level knowledge lattice of tensor metadata.

Equivalent of the reference's TensorInfo (src/tensor_info.rs:870):
what is statically known about a tensor, ordered from most to least:

  NUMERIC  — full value known (a concrete small tensor; used when shapes
             flow through Shape/Gather/Concat chains)
  SHAPED   — dtype + per-dim ScalarInfo (dims may be symbolic)
  RANKED   — dtype + rank only
  MINIMAL  — dtype only

Inference must never *contradict* ground truth; returning a lower level
is always allowed (validated by milli.validate_infer, mirroring the
reference's ablation harness src/milli_graph/validate_infer.rs:23-60).

The port's copy of whisper_tensor_tpu/tensor_info.py, unchanged
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .dtype import DType
from .scalar_info import ScalarInfo
from .symbolic import SymbolicScalar


class Level(enum.IntEnum):
    MINIMAL = 0
    RANKED = 1
    SHAPED = 2
    NUMERIC = 3


DimLike = Union[int, SymbolicScalar, ScalarInfo]


@dataclass(frozen=True)
class TensorInfo:
    dtype: DType
    level: Level
    # SHAPED+: tuple of ScalarInfo dims. RANKED: tuple of None of len rank.
    shape: Optional[Tuple[ScalarInfo, ...]] = None
    rank_: Optional[int] = None
    # NUMERIC: concrete value (host numpy array)
    value: Optional[np.ndarray] = field(default=None, compare=False)

    # -- constructors ---------------------------------------------------
    @staticmethod
    def minimal(dtype: DType) -> "TensorInfo":
        return TensorInfo(dtype, Level.MINIMAL)

    @staticmethod
    def ranked(dtype: DType, rank: int) -> "TensorInfo":
        return TensorInfo(dtype, Level.RANKED, rank_=rank)

    @staticmethod
    def shaped(dtype: DType, dims: Sequence[DimLike]) -> "TensorInfo":
        sh = tuple(ScalarInfo.of(d) for d in dims)
        return TensorInfo(dtype, Level.SHAPED, shape=sh, rank_=len(sh))

    @staticmethod
    def numeric(value: np.ndarray, dtype: Optional[DType] = None) -> "TensorInfo":
        value = np.asarray(value)
        dt = dtype or DType.from_numpy(value.dtype)
        sh = tuple(ScalarInfo.of(int(d)) for d in value.shape)
        return TensorInfo(dt, Level.NUMERIC, shape=sh, rank_=value.ndim, value=value)

    # -- queries ----------------------------------------------------------
    @property
    def rank(self) -> Optional[int]:
        return self.rank_

    def dims(self) -> Optional[Tuple[ScalarInfo, ...]]:
        return self.shape if self.level >= Level.SHAPED else None

    def concrete_shape(self) -> Optional[Tuple[int, ...]]:
        """Fully-known integer shape, or None."""
        if self.shape is None:
            return None
        out = []
        for d in self.shape:
            if not d.is_known:
                return None
            out.append(int(d.value()))
        return tuple(out)

    def num_elements(self) -> Optional[int]:
        cs = self.concrete_shape()
        if cs is None:
            return None
        n = 1
        for d in cs:
            n *= d
        return n

    def forget_value(self) -> "TensorInfo":
        """Drop to SHAPED (used by the infer-ablation validator)."""
        if self.level is not Level.NUMERIC:
            return self
        return TensorInfo(self.dtype, Level.SHAPED, shape=self.shape, rank_=self.rank_)

    def forget_shape(self) -> "TensorInfo":
        if self.level <= Level.RANKED:
            return self
        return TensorInfo(self.dtype, Level.RANKED, rank_=self.rank_)

    def forget_rank(self) -> "TensorInfo":
        return TensorInfo(self.dtype, Level.MINIMAL)

    def at_level(self, level: Level) -> "TensorInfo":
        ti = self
        if level < Level.NUMERIC:
            ti = ti.forget_value()
        if level < Level.SHAPED:
            ti = ti.forget_shape()
        if level < Level.RANKED:
            ti = ti.forget_rank()
        return ti

    # -- lattice compatibility -------------------------------------------
    def consistent_with(self, truth: "TensorInfo") -> bool:
        """True iff nothing this info claims contradicts `truth`.

        `truth` is assumed to be at NUMERIC (ground-truth) level.
        """
        if self.dtype != truth.dtype:
            return False
        if self.rank_ is not None and truth.rank_ is not None and self.rank_ != truth.rank_:
            return False
        if self.shape is not None and truth.shape is not None:
            for a, b in zip(self.shape, truth.shape):
                if a.is_known and b.is_known and a.value() != b.value():
                    return False
        if self.value is not None and truth.value is not None:
            if self.value.shape != truth.value.shape:
                return False
            if not _values_equal(self.value, truth.value):
                return False
        return True

    def __repr__(self) -> str:
        if self.level is Level.MINIMAL:
            return f"TensorInfo({self.dtype.name})"
        if self.level is Level.RANKED:
            return f"TensorInfo({self.dtype.name}, rank={self.rank_})"
        dims = ",".join(repr(d) for d in (self.shape or ()))
        tag = "=" if self.level is Level.NUMERIC else ""
        return f"TensorInfo({self.dtype.name}, [{dims}]{tag})"


def _values_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype == np.dtype(object) or b.dtype == np.dtype(object):
        return bool(np.all(a == b))
    an = np.asarray(a, dtype=np.float64) if a.dtype.kind == "f" else a
    bn = np.asarray(b, dtype=np.float64) if b.dtype.kind == "f" else b
    try:
        return bool(np.allclose(an, bn, rtol=1e-5, atol=1e-7, equal_nan=True))
    except TypeError:
        return bool(np.all(a == b))
