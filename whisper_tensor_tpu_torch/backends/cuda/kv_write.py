"""Ragged KV-cache write: the CUDA kernel's wrappers and their plain
versions.

Replaces ragged_kv_write (whisper_tensor_tpu/backends/pallas/kv_write.py
:104). The kernel is csrc/kv_write.cu; its source note says what bounds
it on the H100 and how its design answers that. One launch writes one
cache (`ragged_kv_write`) or a layer's K and V caches (`kv_write_pair`,
the lowering of the KVWrite op that milli/transforms.py:pair_cache_writes
makes of the recipes' two cache writes).

The TPU kernel's gate (kv_write.py:82-101: D % 128, L % 8, S = 1, the
update in the cache's type) follows the TPU's tiling and DMA. This
kernel takes any H, L and D, any S <= L (the batcher's admission
prefill and chunked-prefill pieces write S > 1 rows), an update of the
cache's type, or f32 or f16 into a bf16 cache (an f16 model over the
server's bf16 cache: XLA's round to nearest), an update with any strides, and
a start per row (B,) or one for every row (), int64 or int32. It also
takes a bf16 or f16 update into an f32 cache (a bf16 model over the text
interface's default f32 cache), widened in the kernel: exact, so the
write is the plain version's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from . import refuse_grad
from .build import (CARD_SMS, card_sms, check, kernel_limits, library,
                    raw_stream)

_MODES = {(torch.bfloat16, torch.bfloat16): 0,
          (torch.float32, torch.float32): 1,
          (torch.bfloat16, torch.float32): 2,
          (torch.bfloat16, torch.float16): 3,
          (torch.float32, torch.bfloat16): 4,
          (torch.float32, torch.float16): 5}
# The CPU defaults, for the plan's tests, of what wt_kv_write_limits reads
# of the kernel on the card: threads a block and blocks a multiprocessor
# (its launch bounds), as the H100 gives them.
THREADS = 128
BLOCKS_PER_SM = 16
MAX_UNITS = 1 << 30
_DTYPES = {2: torch.bfloat16, 4: torch.float32}     # by bytes a value


def clamped_start(start: torch.Tensor, length: int, n: int) -> torch.Tensor:
    """Where a write of n elements at `start` lands on an axis of
    `length`: a negative start counts from the end (numpy slicing in the
    oracle, jax.lax.dynamic_update_slice in the reference), then XLA's
    clamp to [0, length - n] keeps the write inside."""
    start = start.long()
    return torch.where(start < 0, start + length, start).clamp(0, length - n)


def ragged_kv_write_plain(cache, update, pos) -> torch.Tensor:
    """cache[b, :, p:p+S, :] = update[b], p = pos[b] (or the scalar pos
    for every row) clamped to [0, L-S] after a negative pos counts from
    the end (clamped_start), written into `cache`, which is returned; the
    update is cast to the cache's type (round to nearest even)."""
    S, L = update.shape[2], cache.shape[2]
    start = clamped_start(pos.reshape(-1), L, S)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=cache.device)[None, :]
    cache.movedim(2, 1)[rows, cols] = update.movedim(2, 1).to(cache.dtype)
    return cache


def kv_write_pair_plain(cache_k, update_k, cache_v, update_v, pos
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv_write_pair's semantics in plain PyTorch: two
    ragged_kv_write_plain writes with one start."""
    return (ragged_kv_write_plain(cache_k, update_k, pos),
            ragged_kv_write_plain(cache_v, update_v, pos))


# -- the launch plan ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def kv_write_limits(cache_bytes: int = 2, update_bytes: Optional[int] = None,
                    device: Optional[int] = None) -> Tuple[int, int, int]:
    """(threads a block, blocks a multiprocessor, multiprocessors) of the
    kernel for a cache of `cache_bytes` a value and an update of
    `update_bytes` (the cache's by default): read on CUDA device `device`
    (wt_kv_write_limits: the occupancy calculator), or for None the CPU
    defaults above."""
    if device is None:
        return THREADS, BLOCKS_PER_SM, CARD_SMS
    mode = _MODES[_DTYPES[cache_bytes], _DTYPES[update_bytes or cache_bytes]]
    threads, blocks, _ = kernel_limits("wt_kv_write_limits", device, mode)
    return threads, blocks, card_sms(device)


@dataclass(frozen=True)
class KVWritePlan:
    """How one launch runs (csrc/kv_write.cu): the caches' S * D runs cut
    into units of 16 bytes of the cache, `units_per_slab` a (row, head)
    slab and `units` in all, over `blocks` blocks whose threads stride
    over the units."""
    units_per_slab: int
    units: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def kv_write_plan(caches: int, B: int, H: int, S: int, D: int,
                  cache_bytes: int = 2, update_bytes: Optional[int] = None,
                  device: Optional[int] = None) -> KVWritePlan:
    """The launch plan for `caches` (1 or 2) caches of (B, H, L, D) taking
    (B, H, S, D) updates: one unit a thread while the card holds them all
    at once (a decode step's 16-byte vectors; a 128-row piece spread over
    every multiprocessor), else one wave of blocks, each thread striding
    over several units. The kernel's limits come from `device`
    (kv_write_limits; None: the CPU defaults)."""
    threads, per_sm, sms = kv_write_limits(cache_bytes, update_bytes, device)
    per_slab = -(-S * D // (16 // cache_bytes))
    units = caches * B * H * per_slab
    return KVWritePlan(per_slab, units,
                       max(1, min(-(-units // threads), per_sm * sms)))


# -- the wrappers ---------------------------------------------------------


def ragged_kv_write(cache, update, pos) -> torch.Tensor:
    """cache (B, H, L, D) bf16 or f32, contiguous; update (B, H, S, D)
    of the cache's type, f32 or f16 into a bf16 cache, or bf16 or f16
    into an f32 cache, any strides; pos (B,) or () int64 or int32.
    Writes in place and returns `cache`.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise when it does not take them. `ragged_kv_write.launches`
    counts every launch of the kernel, of this wrapper's and of
    kv_write_pair's."""
    refuse_grad("ragged_kv_write", cache, update)
    if cache.device.type == "cpu":
        return ragged_kv_write_plain(cache, update, pos)
    _launch((cache,), (update,), pos)
    return cache


def kernel_takes(cache: torch.Tensor, update: torch.Tensor) -> bool:
    """Whether the kernel takes one write of `update` into `cache` along
    axis 2, for any start it takes: a contiguous 4-D cache of a type
    pair the kernel has a mode for, an update of the cache's B, H and D
    with 0 < S <= L, both on one device."""
    return ((cache.dtype, update.dtype) in _MODES
            and cache.ndim == update.ndim == 4
            and update.shape[:2] == cache.shape[:2]
            and update.shape[3] == cache.shape[3]
            and 0 < update.shape[2] <= cache.shape[2]
            and cache.is_contiguous() and cache.device == update.device)


def kv_write_pair(cache_k, update_k, cache_v, update_v, pos
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's K and V writes in one launch: ragged_kv_write of
    (cache_k, update_k) and of (cache_v, update_v) at the same pos. The
    two caches have one shape and type, the two updates one shape and
    type, each its own strides. Returns (cache_k, cache_v), written in
    place.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise when it does not take them. The launch counts once in
    `kv_write_pair.launches` and once in `ragged_kv_write.launches`."""
    refuse_grad("kv_write_pair", cache_k, update_k, cache_v, update_v)
    if cache_k.device.type == "cpu":
        return kv_write_pair_plain(cache_k, update_k, cache_v, update_v, pos)
    if _launch((cache_k, cache_v), (update_k, update_v), pos):
        kv_write_pair.launches += 1
    return cache_k, cache_v


# the checked launch constants by shape key: (device index, the geometry
# the C entry reads, as int64), or None for a write of nothing
_GEOMETRY: Dict[tuple, Optional[Tuple[int, ctypes.Array]]] = {}


def _launch(caches, updates, pos) -> bool:
    """Launch the kernel on CUDA caches (one or two) and their updates:
    shapes, types, strides and devices are checked once per key, then
    only the pointers change. Returns whether it launched (False for a
    write of nothing)."""
    key = (pos.shape, pos.stride(), pos.dtype, pos.get_device()) + tuple(
        (c.shape, c.stride(), c.dtype, c.get_device(),
         u.shape, u.stride(), u.dtype, u.get_device())
        for c, u in zip(caches, updates))
    entry = _GEOMETRY.get(key)
    if entry is None:
        if key in _GEOMETRY:
            return False
        entry = _GEOMETRY[key] = _geometry(caches, updates, pos)
        if entry is None:
            return False
    index, geom = entry
    pair = len(caches) == 2
    code = library().wt_kv_write(
        caches[0].data_ptr(), updates[0].data_ptr(),
        caches[1].data_ptr() if pair else None,
        updates[1].data_ptr() if pair else None, pos.data_ptr(), geom,
        raw_stream(index))
    check(code, "kv_write kernel")
    ragged_kv_write.launches += 1
    return True


def _geometry(caches, updates, pos):
    """(device index, int64 geometry of wt_kv_write), None for a write
    of nothing, or raise for what the kernel does not take."""
    cache, update = caches[0], updates[0]
    mode = _MODES.get((cache.dtype, update.dtype))
    ok = (mode is not None and cache.ndim == update.ndim == 4
          and update.shape[0] == cache.shape[0]
          and update.shape[1] == cache.shape[1]
          and update.shape[3] == cache.shape[3]
          and 0 < update.shape[2] <= cache.shape[2]
          and all(c.shape == cache.shape and c.dtype == cache.dtype
                  for c in caches)
          and all(u.shape == update.shape and u.dtype == update.dtype
                  for u in updates))
    if not ok:
        raise ValueError(
            f"kv_write kernel: unsupported caches "
            f"{[(tuple(c.shape), c.dtype) for c in caches]}, updates "
            f"{[(tuple(u.shape), u.dtype) for u in updates]}: it writes "
            f"(B, H, S, D) updates, S <= L, of the cache's type (bf16 or "
            f"f32), f32 or f16 into a bf16 cache, or bf16 or f16 into an "
            f"f32 cache, into caches of one shape and type, from updates "
            f"of one shape and type")
    B, H, L, D = cache.shape
    S = update.shape[2]
    device = cache.device
    if any(not c.is_contiguous() for c in caches) or any(
            t.device != device for t in caches + updates):
        raise ValueError(f"kv_write kernel: the caches must be contiguous "
                         f"and every tensor on {device}")
    if pos.dtype not in (torch.int64, torch.int32) or pos.device != device \
            or not (pos.ndim == 0 or tuple(pos.shape) == (B,)):
        raise ValueError(f"kv_write kernel: pos must be int64/int32 of "
                         f"shape ({B},) or () on {device}, got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    if cache.numel() == 0 or update.numel() == 0:
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    plan = kv_write_plan(len(caches), B, H, S, D, cache.element_size(),
                         update.element_size(), index)
    if plan.units >= MAX_UNITS or L > 2 ** 31 - 1:
        raise ValueError(f"kv_write kernel: unsupported size, {plan.units} "
                         f"units of 16 bytes (at most {MAX_UNITS - 1})")
    strides = [s for u in updates for s in u.stride()]
    geom = [len(caches), B, H, L, D, S, mode, int(pos.dtype == torch.int32),
            pos.stride(0) if pos.ndim else 0, plan.units_per_slab,
            plan.units, plan.blocks] + strides + [0] * (8 - len(strides))
    return index, (ctypes.c_longlong * len(geom))(*geom)


ragged_kv_write.launches = 0
kv_write_pair.launches = 0
