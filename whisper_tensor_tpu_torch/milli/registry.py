"""Lowering table: milli op KIND -> PyTorch implementation.

The port's op classes (milli/ops, copies of the reference's without
`to_jax`) carry the numpy `eval` and shape inference; the lowerings
are keyed by `op.KIND`. A lowering has the reference's `to_jax`
signature plus the device:

    fn(op, inputs, static, device) -> list of output tensors

`inputs` are tensors (None for an absent optional input); `static`
holds, per input, its value as a numpy array where the executor folded
it on the host (shape arguments, constants), else None.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

LOWERINGS: Dict[str, Callable] = {}


def lowering(kind: str):
    """Register the decorated function as the lowering of `kind`."""

    def deco(fn: Callable) -> Callable:
        if kind in LOWERINGS:
            raise ValueError(f"two lowerings registered for {kind}")
        LOWERINGS[kind] = fn
        return fn

    return deco


class NeedsStatic(NotImplementedError):
    """Raised by a lowering that needs input `index` as a host value (a
    Reshape target, Slice bounds, a TopK k) when the executor could not
    fold it. The executor then lifts the graph inputs that value depends
    on to host values and keys its plan on them (the reference lifts
    small integer feeds to trace-time statics the same way,
    backends/eval_backend.py:283-318)."""

    def __init__(self, index: int, what: str):
        super().__init__(f"{what}: input {index} must be static "
                         f"(host-folded)")
        self.index = index


def need_static(static, idx: int, what: str) -> np.ndarray:
    """`static[idx]` as a numpy array, or NeedsStatic."""
    if static is None or idx >= len(static) or static[idx] is None:
        raise NeedsStatic(idx, what)
    return np.asarray(static[idx])
