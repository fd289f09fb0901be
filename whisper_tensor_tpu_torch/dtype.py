"""DType <-> torch.dtype, and host <-> device transfers.

Counterpart of the numpy/jax mappings in whisper_tensor_tpu/dtype.py.
Only the element types the text slice runs are mapped; every other
DType raises NotImplementedError naming itself.

bf16 crosses between host and device as raw 16-bit words: numpy has no
bf16 of its own (the reference uses ml_dtypes' bfloat16), and
``torch.from_numpy`` rejects ml_dtypes arrays. When ml_dtypes is
missing, the reference stores BF16 tensors on the host as float32; such
an array is uploaded as float32 and cast to bf16 on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from whisper_tensor_tpu.dtype import DType

try:
    import ml_dtypes

    _NP_BF16: Optional[np.dtype] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # the reference then keeps BF16 as float32 on host
    _NP_BF16 = None

_TORCH = {
    DType.F32: torch.float32,
    DType.F16: torch.float16,
    DType.BF16: torch.bfloat16,
    DType.I64: torch.int64,
    DType.I32: torch.int32,
    DType.I8: torch.int8,
    DType.U8: torch.uint8,
    DType.BOOL: torch.bool,
}
_DTYPE = {v: k for k, v in _TORCH.items()}


def to_torch(dt: DType) -> torch.dtype:
    """The torch dtype of a DType; NotImplementedError for the rest."""
    try:
        return _TORCH[dt]
    except KeyError:
        raise NotImplementedError(
            f"DType {dt.name} has no torch mapping in the port yet "
            f"(mapped: {', '.join(d.name for d in _TORCH)})") from None


def from_torch(dt: torch.dtype) -> DType:
    try:
        return _DTYPE[dt]
    except KeyError:
        raise NotImplementedError(
            f"torch dtype {dt} has no DType mapping in the port yet") from None


def to_device(arr: np.ndarray, device: torch.device,
              dtype: Optional[DType] = None) -> torch.Tensor:
    """Upload a host array. `dtype` is the declared element type: an
    array that arrives in another float type (BF16 kept as float32 on a
    host without ml_dtypes) is cast on the device after the copy."""
    arr = np.asarray(arr, order="C")     # (ascontiguousarray makes 0-d 1-d)
    if device.type == "cpu":
        # never alias the host array: lowerings may write in place
        arr = arr.copy()
    if _NP_BF16 is not None and arr.dtype == _NP_BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    if dtype is not None:
        want = to_torch(dtype)
        if t.dtype != want:
            t = t.to(want)
    return t


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a small host array without waiting for the device: on CUDA
    it is staged in pinned memory and copied on the current stream
    (PyTorch's copy from pageable memory synchronizes the stream, which
    would stall a pipelined loop). The array may change afterwards."""
    t = torch.from_numpy(np.array(arr, order="C"))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Download a tensor into the reference's host representation:
    bf16 as ml_dtypes.bfloat16 (float32 where ml_dtypes is missing)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if _NP_BF16 is None:
            return t.float().numpy()
        return t.contiguous().view(torch.int16).numpy().view(_NP_BF16)
    return t.numpy()
