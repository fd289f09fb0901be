"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces flash_attention (whisper_tensor_tpu/backends/pallas/
attention.py:175). The kernel is csrc/flash_attention.cu; its source
note says what bounds it on the H100, how its design answers that, and
what of the TPU kernel it leaves out (the KV-chunk carry, the padding to
128, the environment knobs and the 4 GiB threshold).

The Attention lowering (milli/ops/attention.py) sends the bf16 prefills
this wrapper takes here: with a position mask (the pos-bound mode),
is_causal (the causal mode) or an additive (1|B, 1, Sq, Skv) mask (the
additive mode; GPT-2's scalar-position graph and the Gemma recipes).
Head dims 64, 128 and 256: the TPU kernel's D % 128 == 0 or D == 64 at
the head dims the repo's recipes use.

When the grid does not fill the card, the kernel splits each block's
keys over blocks (flash_splits) and merges the splits' partial softmax
states in a second pass, as decode_attention does;
decode_attention.merge_partial_softmax is that pass in plain PyTorch.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import agreement_bound
from .build import (CARD_SMS, card_sms, check, device_index, kernel_limits,
                    library, raw_stream)

KEY_TILE = 64             # keys a split unit: splits are whole units
BLOCK_ROWS = 128          # query rows a block (heads x positions)
MAX_SPLITS = 16
HEAD_DIMS = (64, 128, 256)
# the kernel's blocks a multiprocessor by head dim: the CPU default of
# what wt_flash_limits reads on the card
BLOCKS_PER_SM = {128: 1, 64: 1, 256: 1}


def heads_per_block(Hq: int, Hkv: int) -> int:
    """Query heads of one block: the most of 8, 4, 2, 1 that divide the
    group size. The CPU default of what wt_flash_limits reads of
    csrc/flash_attention.cu on the card."""
    rep = Hq // Hkv
    return next(h for h in (8, 4, 2, 1) if rep % h == 0)


@functools.lru_cache(maxsize=None)
def flash_limits(Hq: int, Hkv: int, D: int,
                 device: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(query heads a block, query positions a block, blocks a
    multiprocessor, multiprocessors) of the kernel for groups of Hq / Hkv
    heads of dim D: read on CUDA device `device` (wt_flash_limits: the
    occupancy calculator), or for None the CPU defaults."""
    if device is None:
        heads = heads_per_block(Hq, Hkv)
        return heads, BLOCK_ROWS // heads, BLOCKS_PER_SM[D], CARD_SMS
    heads, tq, blocks = kernel_limits("wt_flash_limits", device, Hq, Hkv, D)
    return heads, tq, blocks, card_sms(device)


@functools.lru_cache(maxsize=4096)
def flash_splits(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
                 device: Optional[int] = None) -> Tuple[int, int]:
    """(splits, chunk): split c of a block takes keys [c * chunk, (c + 1)
    * chunk), chunk a whole number of KEY_TILE tiles, chunk * splits >=
    Skv > (splits - 1) * chunk. From the shapes alone (pos stays on the
    device): one split when the grid (B x head blocks x query tiles)
    fills a wave of the card (blocks a multiprocessor x its
    multiprocessors); else as many as fill one wave, at most MAX_SPLITS
    and one tile each. The kernel's limits come from `device`
    (flash_limits)."""
    heads, tq, per_sm, sms = flash_limits(Hq, Hkv, D, device)
    blocks = B * (Hq // heads) * -(-Sq // tq)
    tiles = -(-Skv // KEY_TILE)
    wave = per_sm * sms
    if blocks >= wave:
        return 1, tiles * KEY_TILE
    per = -(-tiles // min(-(-wave // blocks), tiles, MAX_SPLITS))
    return -(-tiles // per), per * KEY_TILE


def flash_agreement_bound(ref: torch.Tensor, magnitude: torch.Tensor
                          ) -> torch.Tensor:
    """Per-element bound on |kernel - plain| (or on the TPU kernel
    against the plain version). `magnitude` is the plain version run
    with |v|: M = sum_j p_j |v_j| / l. Three parts:
      * agreement_bound(ref, M): one bf16 ulp of the output (2^-7 |ref|),
        as both round their f32 result once, and 2^-16 M of f32
        summation-order noise in the scores and the value sums;
      * 2^-7 M: both round each unnormalized probability p_j to bf16 once
        (at most half an ulp, 2^-8 of p_j), but the kernel rounds
        exp(s_j - m) against the running max m of the key tiles seen so
        far and rescales later, the plain version against the row's
        final max. So a term p_j v_j / l may differ by two half-ulps,
        2^-7 of p_j |v_j| / l, and the terms add up to 2^-7 M."""
    return agreement_bound(ref, magnitude) + 2.0 ** -7 * magnitude.float().abs()


def flash_attention_plain(q, k, v, scale: float, *, causal: bool = False,
                          mask=None, pos_bound=None) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch. q (B, Hq, Sq, D); k, v
    (B, Hkv, Skv, Dv), Hq a multiple of Hkv; mask additive (1|B, 1, Sq,
    Skv); pos_bound (B,) or (): query row s of batch b sees key j iff
    j <= pos[b] + s; causal: iff j <= s + (Skv - Sq). Scores and softmax
    statistics in f32; the unnormalized probabilities are rounded to v's
    type before the value product, which sums in f32, and the sum of the
    (unrounded) probabilities divides at the end; a row with no visible
    key gives zeros. Returns (B, Hq, Sq, Dv) in q's type."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    s = torch.matmul(q.float().reshape(B, Hkv, rep, Sq, D),
                     k.float().unsqueeze(2).transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float().reshape(mask.shape[0], 1, 1, Sq, Skv)
    j = torch.arange(Skv, device=q.device)
    row = torch.arange(Sq, device=q.device)[:, None]
    if causal:
        s = s.masked_fill(j > row + (Skv - Sq), -torch.inf)
    if pos_bound is not None:
        pos = pos_bound.reshape(-1).expand(B).long()
        hidden = j > pos.view(B, 1, 1) + row          # (B, Sq, Skv)
        s = s.masked_fill(hidden.view(B, 1, 1, Sq, Skv), -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float().unsqueeze(2))
    out = out / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)


def flash_attention(q, k, v, scale: float, *, causal: bool = False,
                    mask=None, pos_bound=None) -> torch.Tensor:
    """q (B, Hq, Sq, D) bf16, read through its strides (the feature
    stride must be 1); k, v (B, Hkv, Skv, D) bf16 contiguous; D 64, 128
    or 256; mask f32-castable (1|B, 1, Sq, Skv); pos_bound int64/int32 ()
    or (B,), read on the device. pos_bound excludes causal and mask.
    Returns (B, Hq, Sq, D) bf16.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise when it does not take them. A call that splits the keys
    (flash_splits) runs two device kernels, the splits and their merge;
    the launch counter counts calls, one per call."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal=causal,
                                     mask=mask, pos_bound=pos_bound)
    ok = q.ndim == k.ndim == 4 and v.shape == k.shape
    if ok:
        B, Hq, Sq, D = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        ok = (k.shape[0] == B and D == k.shape[3] and D in HEAD_DIMS
              and Hkv > 0 and Hq % Hkv == 0 and B <= 65535
              and q.dtype == k.dtype == v.dtype == torch.bfloat16)
    if not ok:
        raise ValueError(
            f"flash_attention kernel: unsupported q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
            f"{v.dtype}: it takes bf16 q, k and v of one head dim, 64, "
            f"128 or 256, Hq a multiple of Hkv and at most 65,535 rows")
    if q.device != k.device or q.stride(3) != 1:
        raise ValueError(f"flash_attention kernel: q must lie on {k.device} "
                         f"with feature stride 1, got strides {q.stride()}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{q.device}")
    if pos_bound is not None and (causal or mask is not None):
        raise ValueError("flash_attention kernel: pos_bound excludes causal "
                         "and mask")
    pos = None
    if pos_bound is not None:
        if pos_bound.dtype not in (torch.int64, torch.int32) \
                or pos_bound.ndim > 1 or pos_bound.numel() not in (1, B) \
                or pos_bound.device != q.device:
            raise ValueError(
                f"flash_attention kernel: pos_bound must be int64/int32 of "
                f"shape () or ({B},) on {q.device}, got {pos_bound.dtype} "
                f"{tuple(pos_bound.shape)}")
        pos = pos_bound.reshape(-1).expand(B).to(torch.int64).contiguous()
    mask_sb = 0
    if mask is not None:
        if mask.ndim != 4 or mask.shape[0] not in (1, B) \
                or tuple(mask.shape[1:]) != (1, Sq, Skv) \
                or mask.device != q.device:
            raise ValueError(
                f"flash_attention kernel: mask must be (1|{B}, 1, {Sq}, "
                f"{Skv}) on {q.device}, got {tuple(mask.shape)}")
        mask = mask.float().contiguous()
        mask_sb = Sq * Skv if mask.shape[0] == B and B > 1 else 0
    splits, chunk = flash_splits(B, Hq, Hkv, Sq, Skv, D,
                                 device_index(q.device))
    return _launch(q, k, v, mask, mask_sb, pos, causal, scale, splits, chunk)


def _launch(q, k, v, mask, mask_sb: int, pos, causal: bool, scale: float,
            splits: int, chunk: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs (mask f32 contiguous, pos
    int64 (B,) or None) by a split plan: flash_attention's, or another
    that a test forces."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty(B, Hq, Sq, D, dtype=q.dtype, device=q.device)
    acc = ml = None
    if splits > 1:
        # the partial states: acc (splits, B, Hq, Sq, D), then (m, l)
        n = splits * B * Hq * Sq
        scratch = torch.empty(n * (D + 2), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()
        ml = acc + n * D * 4
    code = library().wt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if pos is None else pos.data_ptr(), out.data_ptr(), acc, ml,
        B, Hq, Hkv, Sq, Skv, D, q.stride(0), q.stride(1), q.stride(2),
        mask_sb, int(causal), float(scale), splits, chunk,
        raw_stream(q.device))
    check(code, "flash_attention kernel")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
