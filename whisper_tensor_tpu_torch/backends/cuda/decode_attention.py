"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces ragged_decode_attention
(whisper_tensor_tpu/backends/pallas/decode_attention.py:179). The
kernel is csrc/decode_attention.cu; its source note says what bounds it
on the H100 and how its design answers that.

The v5e gates of the TPU kernel (batch below 64, a key block of at most
512 that divides L) are measurements of that chip and are not carried
over: this kernel takes any batch, cache length and GQA group size.
"""

from __future__ import annotations

import math

import torch

from .build import check, library


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
    """q (B, Hq, 1, D) bf16 or f32; k, v (B, Hkv, L, D) bf16; pos
    int64 or int32 of shape () or (B,). Returns (B, Hq, 1, D) in q's
    type.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise when it does not take them."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, scale)
    ok = q.ndim == k.ndim == 4 and v.shape == k.shape
    if ok:
        B, Hq, Sq, D = q.shape
        Hkv, L = k.shape[1], k.shape[2]
        ok = (Sq == 1 and k.shape[0] == B and D == k.shape[3] == 128
              and Hkv > 0 and Hq % Hkv == 0
              and q.dtype in (torch.bfloat16, torch.float32)
              and k.dtype == v.dtype == torch.bfloat16)
    if not ok:
        raise ValueError(
            f"decode_attention kernel: unsupported q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
            f"{v.dtype}: it takes one bf16 or f32 query step over a bf16 "
            f"cache, head dim 128 for q, k and v, and Hq a multiple of Hkv")
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
    pos64 = pos.reshape(-1).expand(B).to(torch.int64).contiguous()
    out = torch.empty_like(q)
    code = library().wt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos64.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.float32), B, Hq, Hkv, L, D,
        float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(code, "decode_attention kernel")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
