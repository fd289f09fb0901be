"""Helpers the PyTorch lowerings share (the port's own; the reference
lowers to jnp, whose dtype coverage is wider than torch's).

Two torch gaps shape them:
  * low-precision floats: the oracle contract computes bf16/f16/f8
    elementwise math in f32 and rounds back once (milli/ops/common.py);
    torch has almost no f8 arithmetic at all, so every lowering that
    computes goes through `up` and `down`;
  * wide unsigned ints: torch stores uint16/32/64 but lacks most
    arithmetic, comparison and sorting on them. `widen` gives a signed
    type that holds every value (u16 -> i32, u32 -> i64) and u64 as its
    int64 bit pattern, exact for add, sub, mul, bitwise ops and left
    shifts (two's complement wraps as uint64 does); `order_key` maps u64
    to an int64 whose signed order is the unsigned order, for
    comparisons, min/max and sorting. A u64 division, modulo or right
    shift reads values below 2**63 only.
"""

from __future__ import annotations

import numpy as np
import torch

from ...dtype import from_torch

LOW_FLOATS = (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
              torch.float8_e5m2)
_WIDE = {torch.uint16: torch.int32, torch.uint32: torch.int64}
WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
_U64_FLIP = -(1 << 63)


def up(t: torch.Tensor) -> torch.Tensor:
    """f32 for a low-precision float, else t."""
    return t.float() if t.dtype in LOW_FLOATS else t


def down(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round a computed result back to `dtype` (no-op when equal)."""
    return t if t.dtype == dtype else t.to(dtype)


def widen(t: torch.Tensor) -> torch.Tensor:
    """A wide unsigned tensor in a signed type torch computes in."""
    if t.dtype in _WIDE:
        return t.to(_WIDE[t.dtype])
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return t


def narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `widen`: back to the unsigned type (wrapping)."""
    if dtype == torch.uint64 and t.dtype == torch.int64:
        return t.view(torch.uint64)
    return down(t, dtype)


def order_key(t: torch.Tensor) -> torch.Tensor:
    """A tensor torch can compare and sort with the order of t's values."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64) ^ _U64_FLIP
    return widen(t)


def from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint64:
        return (k ^ _U64_FLIP).view(torch.uint64)
    return narrow(k, dtype)


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The host (numpy) dtype of a device dtype."""
    return from_torch(dtype).to_numpy()
