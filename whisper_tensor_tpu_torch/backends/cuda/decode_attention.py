"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces ragged_decode_attention
(whisper_tensor_tpu/backends/pallas/decode_attention.py:179). The
kernel is csrc/decode_attention.cu; its source note says what bounds it
on the H100 and how its design answers that.

The v5e gates of the TPU kernel (batch below 64, a key block of at most
512 that divides L) are measurements of that chip and are not carried
over: this kernel takes any batch, cache length and GQA group size, at
head dim 64, 128 or 256 (the TPU kernel's D % 128 == 0 or D == 64 at the
head dims the repo's recipes use), with q in bf16, f32 or f16.

The kernel splits each row's key range over blocks when the batch does
not fill the card (decode_splits) and merges the splits' partial softmax
states in a second pass; merge_partial_softmax is that pass in plain
PyTorch, the reference the tests hold it to.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import refuse_grad
from .build import (CARD_SMS, card_sms, check, device_index, kernel_limits,
                    library, raw_stream)

MIN_CHUNK = 32            # keys of one split at least: one key tile
HEAD_DIMS = (64, 128, 256)
Q_TYPES = (torch.bfloat16, torch.float32, torch.float16)
# the kernel's blocks a multiprocessor by head dim (the 48 KB ring at
# D = 128; launch bounds of 4): the CPU default of what wt_decode_limits
# reads on the card, for every group at D = 128 and for GPT-2's (a group
# of 1) at D = 64 (other groups' registers give 4 there); at D = 256 the
# 96 KB ring leaves room for 2
BLOCKS_PER_SM = {128: 4, 64: 5, 256: 2}


def heads_per_block(Hq: int, Hkv: int) -> int:
    """Query heads of one block: the largest divisor of the group size
    Hq / Hkv up to 8. The CPU default of what wt_decode_limits reads of
    csrc/decode_attention.cu on the card."""
    rep = Hq // Hkv
    return next(h for h in range(min(rep, 8), 0, -1) if rep % h == 0)


@functools.lru_cache(maxsize=None)
def decode_limits(Hq: int, Hkv: int, D: int = 128,
                  device: Optional[int] = None) -> Tuple[int, int, int]:
    """(query heads a block, blocks a multiprocessor, multiprocessors) of
    the kernel for groups of Hq / Hkv heads of dim D: read on CUDA device
    `device` (wt_decode_limits: the occupancy calculator), or for None
    the CPU defaults the plan's tests use."""
    if device is None:
        return heads_per_block(Hq, Hkv), BLOCKS_PER_SM[D], CARD_SMS
    heads, blocks, _ = kernel_limits("wt_decode_limits", device, Hq, Hkv, D)
    return heads, blocks, card_sms(device)


@functools.lru_cache(maxsize=4096)
def decode_splits(B: int, Hq: int, Hkv: int, L: int, D: int = 128,
                  device: Optional[int] = None) -> Tuple[int, int]:
    """(splits, chunk): split c of a row takes keys [c * chunk, (c + 1) *
    chunk), chunk * splits >= L > (splits - 1) * chunk. From the shapes
    alone (pos stays on the device): one split when the B x head-block
    grid already holds 2 blocks a multiprocessor; else as many splits as
    keep the grid within the blocks the multiprocessors hold at once
    (each block streams its chunk with few tiles in flight, so more
    blocks hide more latency), down to MIN_CHUNK keys a split. The
    kernel's limits at head dim D come from `device` (decode_limits)."""
    heads, per_sm, sms = decode_limits(Hq, Hkv, D, device)
    blocks = B * (Hq // heads)
    if blocks >= 2 * sms:
        return 1, L
    splits = min(max(2, per_sm * sms // blocks), max(1, L // MIN_CHUNK))
    chunk = -(-L // splits)
    return -(-L // chunk), chunk


def merge_partial_softmax(m, l, acc) -> torch.Tensor:
    """The kernel's second pass in plain PyTorch: m, l (..., S) f32 the
    running max and sum of each split, acc (..., S, D) f32 its
    unnormalized output. m* = max m_i; l = sum l_i e^(m_i - m*); out =
    sum acc_i e^(m_i - m*) / l. An empty split (m = -inf, l = 0) weighs
    0, and an output whose l is 0 is 0. Returns (..., D) f32."""
    mx = m.amax(-1, keepdim=True)
    w = torch.where(m == -math.inf, torch.zeros_like(m),
                    torch.exp(m - mx.clamp_min(torch.finfo(m.dtype).min)))
    total = (l * w).sum(-1, keepdim=True)
    out = (acc * w[..., None]).sum(-2)
    return torch.where(total > 0, out / torch.where(total > 0, total, 1.0),
                       torch.zeros_like(out))


def decode_attention_plain(q, k, v, pos, scale: float) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch: row b attends keys
    0..min(pos[b], L-1); f32 scores and softmax; out in q's type. Any
    head dims, Hq a multiple of Hkv."""
    B, Hq, _, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    pos = pos.reshape(-1).expand(B).long().clamp(0, L - 1)
    qf = q.float().reshape(B, Hkv, rep, D) * scale
    s = torch.matmul(qf, k.float().transpose(-1, -2))      # (B, Hkv, rep, L)
    live = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.float())                        # (B, Hkv, rep, Dv)
    return out.reshape(B, Hq, 1, v.shape[-1]).to(q.dtype)


def decode_attention(q, k, v, pos, scale: float) -> torch.Tensor:
    """q (B, Hq, 1, D) bf16, f32 or f16, D 64, 128 or 256; k, v (B, Hkv,
    L, D) bf16; pos
    int64 or int32 of shape () or (B,). Returns (B, Hq, 1, D) in q's
    type.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise when it does not take them. A call that splits the keys
    (decode_splits) runs two device kernels, the splits and their merge;
    the launch counter counts calls, one per call."""
    refuse_grad("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, scale)
    ok = q.ndim == k.ndim == 4 and v.shape == k.shape
    if ok:
        B, Hq, Sq, D = q.shape
        Hkv, L = k.shape[1], k.shape[2]
        ok = (Sq == 1 and k.shape[0] == B and D == k.shape[3]
              and D in HEAD_DIMS
              and Hkv > 0 and Hq % Hkv == 0
              and q.dtype in Q_TYPES and B <= 65535
              and k.dtype == v.dtype == torch.bfloat16)
    if not ok:
        raise ValueError(
            f"decode_attention kernel: unsupported q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
            f"{v.dtype}: it takes one bf16, f32 or f16 query step over a "
            f"bf16 cache, head dim 64, 128 or 256 for q, k and v, Hq a "
            f"multiple of Hkv and at most 65,535 rows")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{q.device}")
    if pos.dtype not in (torch.int64, torch.int32) or pos.ndim > 1 \
            or pos.numel() not in (1, B) or pos.device != q.device:
        raise ValueError(f"decode_attention kernel: pos must be int64/int32 "
                         f"of shape () or ({B},) on {q.device}, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    return _launch(q, k, v, pos, scale, *decode_splits(
        B, Hq, Hkv, L, D, device_index(q.device)))


def _launch(q, k, v, pos, scale: float, splits: int, chunk: int):
    """Launch the kernel on checked CUDA inputs, the keys split into
    `splits` runs of `chunk` (decode_attention's plan, or another that
    chip_smoke.py --plans times)."""
    B, Hq, _, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    pos64 = pos if pos.dtype == torch.int64 and pos.shape == (B,) and \
        pos.is_contiguous() else \
        pos.reshape(-1).expand(B).to(torch.int64).contiguous()
    out = torch.empty_like(q)
    acc = ml = None
    if splits > 1:
        # the partial states: acc (B, Hq, splits, D), then (m, l) pairs
        n = B * Hq * splits
        scratch = torch.empty(n * (D + 2), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()
        ml = acc + n * D * 4
    code = library().wt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos64.data_ptr(),
        out.data_ptr(), acc, ml,
        Q_TYPES.index(q.dtype), B, Hq, Hkv, L, D, splits, chunk,
        float(scale), raw_stream(q.device))
    check(code, "decode_attention kernel")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
