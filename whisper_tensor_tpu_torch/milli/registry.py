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

LOWERINGS: Dict[str, Callable] = {}


def lowering(kind: str):
    """Register the decorated function as the lowering of `kind`."""

    def deco(fn: Callable) -> Callable:
        if kind in LOWERINGS:
            raise ValueError(f"two lowerings registered for {kind}")
        LOWERINGS[kind] = fn
        return fn

    return deco
