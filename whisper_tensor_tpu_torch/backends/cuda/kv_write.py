"""Ragged KV-cache write: the CUDA kernel's wrapper and its plain version.

Replaces ragged_kv_write (whisper_tensor_tpu/backends/pallas/kv_write.py
:104). The kernel is csrc/kv_write.cu; its source note says what bounds
it on the H100 and how its design answers that.

The TPU kernel's gate (kv_write.py:82-101: D % 128, L % 8, S = 1, the
update in the cache's type) follows the TPU's tiling and DMA. This
kernel takes any H, L and D, any S <= L (the batcher's admission
prefill and chunked-prefill pieces write S > 1 rows), an update of the
cache's type or f32 into a bf16 cache, and an update with any strides.
"""

from __future__ import annotations

import torch

from .build import check, library, raw_stream

_MODES = {(torch.bfloat16, torch.bfloat16): 0,
          (torch.float32, torch.float32): 1,
          (torch.bfloat16, torch.float32): 2}


def clamped_start(start: torch.Tensor, length: int, n: int) -> torch.Tensor:
    """Where a write of n elements at `start` lands on an axis of
    `length`: a negative start counts from the end (numpy slicing in the
    oracle, jax.lax.dynamic_update_slice in the reference), then XLA's
    clamp to [0, length - n] keeps the write inside."""
    start = start.long()
    return torch.where(start < 0, start + length, start).clamp(0, length - n)


def ragged_kv_write_plain(cache, update, pos) -> torch.Tensor:
    """cache[b, :, p:p+S, :] = update[b], p = pos[b] clamped to [0, L-S]
    after a negative pos[b] counts from the end (clamped_start), written
    into `cache`, which is returned; the update is cast to the cache's
    type (round to nearest even)."""
    S, L = update.shape[2], cache.shape[2]
    start = clamped_start(pos.reshape(-1), L, S)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=cache.device)[None, :]
    cache.movedim(2, 1)[rows, cols] = update.movedim(2, 1).to(cache.dtype)
    return cache


def ragged_kv_write(cache, update, pos) -> torch.Tensor:
    """cache (B, H, L, D) bf16 or f32, contiguous; update (B, H, S, D)
    of the cache's type or f32 into a bf16 cache, any strides; pos (B,)
    int64 or int32. Writes in place and returns `cache`.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise when it does not take them."""
    if cache.device.type == "cpu":
        return ragged_kv_write_plain(cache, update, pos)
    mode = _MODES.get((cache.dtype, update.dtype))
    ok = (mode is not None and cache.ndim == update.ndim == 4
          and update.shape[0] == cache.shape[0]
          and update.shape[1] == cache.shape[1]
          and update.shape[3] == cache.shape[3]
          and 0 < update.shape[2] <= cache.shape[2])
    if not ok:
        raise ValueError(
            f"ragged_kv_write kernel: unsupported cache {tuple(cache.shape)} "
            f"{cache.dtype}, update {tuple(update.shape)} {update.dtype}: it "
            f"writes a (B, H, S, D) update, S <= L, of the cache's type (bf16 "
            f"or f32) or f32 into a bf16 cache")
    B, H, L, D = cache.shape
    if not cache.is_contiguous() or update.device != cache.device:
        raise ValueError(f"ragged_kv_write kernel: the cache must be "
                         f"contiguous and the update on {cache.device}")
    if pos.dtype not in (torch.int64, torch.int32) or pos.ndim != 1 \
            or pos.shape[0] != B or pos.device != cache.device:
        raise ValueError(f"ragged_kv_write kernel: pos must be int64/int32 "
                         f"of shape ({B},) on {cache.device}, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if cache.numel() == 0 or update.numel() == 0:
        return cache
    pos64 = pos.to(torch.int64).contiguous()
    code = library().wt_ragged_kv_write(
        cache.data_ptr(), update.data_ptr(), pos64.data_ptr(), B, H, L, D,
        update.shape[2], *update.stride(), mode,
        raw_stream(cache.device))
    check(code, "ragged_kv_write kernel")
    ragged_kv_write.launches += 1
    return cache


ragged_kv_write.launches = 0
