"""Attention and Rotary lowerings.

Counterparts of whisper_tensor_tpu/milli/ops/attention.py:147-260
(Attention) and :547 (Rotary).

Attention with a rank-0 or rank-1 integer POSITION mask (the recipes'
`pos`): query row s of batch b sees keys j <= pos[b] + s. A rank-0
mask is broadcast to (B,) first, as the reference does at :170-171.
A single-query step (Sq == 1) over a bf16 cache runs the hand-written
decode-attention kernel (backends/cuda/decode_attention.py), which
raises on a CUDA device for shapes it does not take (a head dim other
than 128); every other call, prefill included, runs the plain f32 path
below, which mirrors the reference's XLA path: scores in f32, softmax
in f32, the probabilities rounded to the input type, the value product
accumulated in f32.
"""

from __future__ import annotations

import math

import torch

from ...backends.cuda.decode_attention import decode_attention
from ..registry import lowering

_EXACT = (torch.float32, torch.float64, torch.float16)


def _to_4d(op, inputs):
    """(q, k, v, mask, was_3d) in the 4-D layout, past KV concatenated."""
    q, k, v = inputs[0], inputs[1], inputs[2]
    mask = inputs[3] if len(inputs) > 3 else None
    past_k = inputs[4] if len(inputs) > 4 else None
    past_v = inputs[5] if len(inputs) > 5 else None
    was_3d = q.ndim == 3
    if was_3d:
        hq = op.q_heads
        hkv = op.kv_heads or hq
        B, Sq, Skv = q.shape[0], q.shape[1], k.shape[1]
        q = q.reshape(B, Sq, hq, q.shape[2] // hq).transpose(1, 2)
        k = k.reshape(B, Skv, hkv, k.shape[2] // hkv).transpose(1, 2)
        v = v.reshape(B, Skv, hkv, v.shape[2] // hkv).transpose(1, 2)
    if past_k is not None:
        k = torch.cat([past_k, k], dim=2)
    if past_v is not None:
        v = torch.cat([past_v, v], dim=2)
    return q, k, v, mask, was_3d


def position_mask(pos: torch.Tensor, sq: int, skv: int) -> torch.Tensor:
    """(B,) positions -> dense boolean (B, 1, Sq, Skv) visibility."""
    j = torch.arange(skv, device=pos.device).view(1, 1, 1, skv)
    s = torch.arange(sq, device=pos.device).view(1, 1, sq, 1)
    return j <= (pos.long().view(-1, 1, 1, 1) + s)


@lowering("Attention")
def attention(op, inputs, static, device):
    out_dt = inputs[0].dtype
    q, k, v, mask, was_3d = _to_4d(op, inputs)
    pk, pv = k, v                       # present_key / present_value
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = op.scale if op.scale is not None else 1.0 / math.sqrt(D)
    need_qk = op.n_out >= 4

    def finish(y, qk=None):
        if was_3d:
            y = y.transpose(1, 2).reshape(B, Sq, Hq * y.shape[-1])
        outs = [y.to(out_dt), pk, pv]
        if qk is not None:
            outs.append(qk.to(out_dt))
        return outs[:op.n_out]

    if mask is not None and mask.ndim in (0, 1):
        pos = mask.reshape(-1).expand(B) if mask.ndim == 0 else mask
        if (Sq == 1 and not need_qk and not op.softcap and not op.is_causal
                and k.dtype == v.dtype == torch.bfloat16):
            # (a cache read in place is contiguous already: no copy)
            return finish(decode_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), pos, scale))
        mask = position_mask(pos, Sq, Skv)

    rep = 1 if need_qk else Hq // Hkv
    if need_qk and Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    # bf16 products are exact in f32, so f32 operands give the
    # reference's "bf16 in, f32 accumulate" numerics; f16/f32/f64 run
    # at full f32 (the reference's Precision.HIGHEST)
    low = q.dtype not in _EXACT
    qf, kf, vf = q.float(), k.float(), v.float()
    if rep > 1:
        # grouped GQA: (B, Hkv, rep, Sq, D) against (B, Hkv, 1, Skv, D)
        scores = torch.matmul(qf.reshape(B, Hkv, rep, Sq, D),
                              kf.unsqueeze(2).transpose(-1, -2)) * scale
    else:
        scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    qk_out = scores
    if mask is not None:
        m = mask
        if rep > 1:
            m = (m.reshape(B, Hkv, rep, *m.shape[2:])
                 if m.ndim == 4 and m.shape[1] == Hq
                 else m.unsqueeze(2) if m.ndim == 4 else m)
        if m.dtype == torch.bool:
            scores = scores.masked_fill(~m, -1e30)
        else:
            scores = scores + m.float()
    if op.is_causal:
        causal = torch.ones(Sq, Skv, dtype=torch.bool,
                            device=q.device).tril(Skv - Sq)
        scores = scores.masked_fill(~causal, -1e30)
    if op.qk_mode >= 1:
        qk_out = scores
    if op.softcap > 0:
        scores = op.softcap * torch.tanh(scores / op.softcap)
    if op.qk_mode >= 2:
        qk_out = scores
    p = torch.softmax(scores, dim=-1)
    if op.qk_mode >= 3:
        qk_out = p
    if low:
        p = p.to(q.dtype).float()       # the reference rounds p to bf16
    if rep > 1:
        out = torch.matmul(p, vf.unsqueeze(2)).reshape(B, Hq, Sq, v.shape[-1])
    else:
        out = torch.matmul(p, vf)
    return finish(out, qk_out if need_qk else None)


@lowering("Rotary")
def rotary(op, inputs, static, device):
    x = inputs[0]
    cos, sin = inputs[1], inputs[2]
    pos = inputs[3] if len(inputs) > 3 and inputs[3] is not None else None
    xf = x.float()
    was_3d = xf.ndim == 3
    if was_3d:
        xf = xf.reshape(xf.shape[0], xf.shape[1], op.num_heads, -1)
        xf = xf.transpose(1, 2)
    B, H, S, D = xf.shape
    rd = op.rotary_dim or D
    xr, xpass = xf[..., :rd], xf[..., rd:]
    cosf, sinf = cos.float(), sin.float()
    if pos is not None:
        # XLA clamps out-of-range gather indices; so does this
        idx = pos.long().clamp(0, cosf.shape[0] - 1)
        cosf, sinf = cosf[idx], sinf[idx]
    elif cosf.ndim == 2:
        cosf, sinf = cosf[:S], sinf[:S]
    while cosf.ndim < 3:
        cosf, sinf = cosf[None], sinf[None]
    cosf, sinf = cosf[:, None], sinf[:, None]
    half = rd // 2
    if cosf.shape[-1] == rd:
        cosf, sinf = cosf[..., :half], sinf[..., :half]
    if op.interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rot = torch.stack([x1 * cosf - x2 * sinf, x2 * cosf + x1 * sinf],
                          dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = torch.cat([x1 * cosf - x2 * sinf, x2 * cosf + x1 * sinf],
                        dim=-1)
    out = torch.cat([rot, xpass], dim=-1) if rd < D else rot
    if was_3d:
        out = out.transpose(1, 2).reshape(B, S, H * D)
    return [out.to(x.dtype)]
