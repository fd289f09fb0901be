"""Shared dtype-exactness helpers for milli-op oracle kernels.

Oracle semantics rule (matching the reference NDArray backend): ops on
bf16/f16/f8 inputs compute in f32 and round the result back to the
storage dtype. Every bf16/f16/f8 value is exactly representable in f32
and the final downcast is correctly rounded, so elementwise results are
bit-exact. Contractions control their accumulate dtype explicitly
(reference src/milli_graph/ops/binary.rs:530-620).

The port's copy of whisper_tensor_tpu/milli/ops/common.py, without
`np_dtype_of`, which nothing of the port calls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...dtype import DType
from ...scalar_info import ScalarInfo
from ...tensor_info import TensorInfo

try:
    import ml_dtypes

    SMALL_FLOAT_NP = (
        np.dtype(ml_dtypes.bfloat16),
        np.dtype(ml_dtypes.float8_e4m3fn),
        np.dtype(ml_dtypes.float8_e5m2),
        np.dtype(np.float16),
    )
except ImportError:  # pragma: no cover
    SMALL_FLOAT_NP = (np.dtype(np.float16),)


def upcast_for_compute(arr: np.ndarray) -> Tuple[np.ndarray, Optional[np.dtype]]:
    """If arr is a small float, return (f32 view, original dtype); else (arr, None)."""
    if arr.dtype in SMALL_FLOAT_NP:
        return arr.astype(np.float32), arr.dtype
    return arr, None


def downcast_result(arr: np.ndarray, orig: Optional[np.dtype]) -> np.ndarray:
    return arr if orig is None else arr.astype(orig)


def unary_compute(arr: np.ndarray, fn) -> np.ndarray:
    x, orig = upcast_for_compute(arr)
    return downcast_result(fn(x), orig)


def binary_compute(a: np.ndarray, b: np.ndarray, fn, bool_out: bool = False) -> np.ndarray:
    xa, oa = upcast_for_compute(a)
    xb, ob = upcast_for_compute(b)
    out = fn(xa, xb)
    if bool_out:
        return out.astype(np.bool_)
    return downcast_result(out, oa or ob)


# ---------------------------------------------------------------------------
# shape-inference helpers
# ---------------------------------------------------------------------------


def broadcast_dims(
    a: Sequence[ScalarInfo], b: Sequence[ScalarInfo]
) -> Optional[List[ScalarInfo]]:
    """Numpy-style broadcast of two symbolic shapes; None if undecidable."""
    la, lb = len(a), len(b)
    n = max(la, lb)
    out: List[ScalarInfo] = []
    for i in range(n):
        da = a[la - n + i] if la - n + i >= 0 else ScalarInfo.of(1)
        db = b[lb - n + i] if lb - n + i >= 0 else ScalarInfo.of(1)
        if da.is_known and da.value() == 1:
            out.append(db)
        elif db.is_known and db.value() == 1:
            out.append(da)
        elif da.equals(db):
            out.append(da)
        elif da.is_known and db.is_known:
            if da.value() != db.value():
                raise ValueError(f"cannot broadcast {da} with {db}")
            out.append(da)
        else:
            eq = da.equals(db)
            if eq is True:
                out.append(da)
            elif da.is_known:
                out.append(da)  # symbolic other side must equal or be 1; assume known wins
            elif db.is_known:
                out.append(db)
            else:
                return None
    return out


def elementwise_infer(infos: List[TensorInfo], out_dtype: Optional[DType] = None) -> TensorInfo:
    dt = out_dtype or infos[0].dtype
    # try shaped broadcast
    shapes = [i.dims() for i in infos]
    if all(s is not None for s in shapes):
        dims = list(shapes[0])
        ok = True
        for s in shapes[1:]:
            bd = broadcast_dims(dims, list(s))
            if bd is None:
                ok = False
                break
            dims = bd
        if ok:
            return TensorInfo.shaped(dt, dims)
    ranks = [i.rank for i in infos]
    if all(r is not None for r in ranks):
        return TensorInfo.ranked(dt, max(ranks))
    return TensorInfo.minimal(dt)
