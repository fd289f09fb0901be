"""Attention and Rotary: the milli op classes and their PyTorch
lowerings.

The classes are the port's copy of AttentionMilli and RotaryMilli from
whisper_tensor_tpu/milli/ops/attention.py (numpy `eval` and shape
inference; no `to_jax`). The lowerings are the counterparts of its
`to_jax` at :147-260 (Attention) and :547 (Rotary).

Attention with a rank-0 or rank-1 integer POSITION mask (the recipes'
`pos`): query row s of batch b sees keys j <= pos[b] + s. A rank-0
mask is broadcast to (B,) first, as the reference does at :170-171.
Without softcap, a qk output or is_causal, such a call over a bf16
cache goes to a hand-written kernel's wrapper when the wrapper takes it
(`pos_mode`: head dim 64, 128 or 256, Dv = D, Hq a multiple of Hkv, at
most 65,535 rows); on a CUDA device the wrapper launches the kernel:
  * a single-query step (Sq == 1) to decode_attention
    (backends/cuda/decode_attention.py; q bf16, f16 or f32);
  * a prefill (Sq > 1) with bf16 q, k and v to flash_attention
    (backends/cuda/flash_attention.py), in its pos-bound mode: the
    visibility rule stays in registers and the key loop stops at the
    last visible key.
A prefill in bf16 takes flash_attention's other two modes too
(`flash_mode`): an is_causal call without a mask its causal mode, and a
call with an additive float mask of shape (1|B, 1, Sq, Skv) its additive
mode (GPT-2's scalar-position step graph and the Gemma recipes emit
one), when there is no softcap and no qk output, D is 64, 128 or 256,
Dv = D and Hq is a multiple of Hkv: exactly the calls the wrapper takes.
The TPU kernels gate on D % 128 == 0 or D == 64 and leave every other
head dim to XLA; here head dims 384 and above run the plain path too.
The reference keeps these modes behind an opt-in gate measured on the
v5e (backends/pallas/attention.py:94-125); on the H100 the additive mode
runs at a quarter of the plain path's time (PERF.md).

Rows that see no key follow the oracle: a causal row (Sq > Skv) takes
the mean of v, as the oracle's finite -1e30 fill gives, and an additive
mask is shifted by its row maximum first (softmax does not change), so a
row masked by a large finite value everywhere keeps the scores' order
as the oracle's float64 scores do, where f32 would round them away.

Every other call (f32 caches among them, as the TPU kernel is bf16
only) runs the plain f32 path below, which mirrors the reference's XLA
path: scores in f32, softmax in f32, the probabilities rounded to the
input type, the value product accumulated in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...backends.cuda.decode_attention import (
    HEAD_DIMS as DECODE_HEAD_DIMS, Q_TYPES as DECODE_Q_TYPES,
    decode_attention)
from ...backends.cuda.flash_attention import (
    HEAD_DIMS as FLASH_HEAD_DIMS, flash_attention)
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering


def _np_softmax(x, axis=-1):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


@dataclass
class AttentionMilli(MilliOp):
    """Scaled dot-product attention (full ONNX opset-23 Attention).

    inputs: q, k, v [, mask [, past_key [, past_value]]] — None gaps
    stay positional.  4-D layout: q (B, Hq, Sq, D), k (B, Hkv, Skv, D),
    v (B, Hkv, Skv, Dv).  3-D layout (B, S, H*D) is accepted when
    q_heads is set (kv_heads for GQA); Y then comes back 3-D while the
    present outputs are always 4-D, per the ONNX spec.
    GQA: Hq may be a multiple of Hkv.  mask is additive (or boolean),
    broadcastable to (B, Hq, Sq, S_total).

    outputs (n_out of): Y, present_key, present_value, qk_matmul_output
    qk_mode selects the captured stage per ONNX qk_matmul_output_mode:
    0 = scaled QK^T, 1 = after mask/causal bias, 2 = after softcap,
    3 = after softmax.  Stage order follows the ONNX-23 reference:
    bias first, then softcap, then softmax (with 0/-inf masks this is
    numerically identical to the Gemma-2 cap-then-mask order the
    in-house recipes assume, because tanh saturates at the mask floor).

    wt extension — rank-0/rank-1 POSITION mask: an integer mask of
    shape () or (B,) is a (per-row) position; query row s of batch b
    may attend keys j <= mask[b] + s (exactly the visibility the
    recipes built as a dense Where mask from `pos`).  The port's
    lowering (below) sends such calls to its CUDA kernels; `eval` here
    synthesizes the dense boolean mask.
    """

    scale: Optional[float] = None
    is_causal: bool = False
    softcap: float = 0.0
    qk_mode: int = 0
    q_heads: int = 0
    kv_heads: int = 0
    n_out: int = 1
    KIND = "Attention"

    def _norm(self, xp, inputs):
        """Normalize the input surface to 4-D (q, k, v, mask, was_3d),
        concatenating past KV into k/v along the sequence axis."""
        q, k, v = inputs[0], inputs[1], inputs[2]
        mask = inputs[3] if len(inputs) > 3 else None
        past_k = inputs[4] if len(inputs) > 4 else None
        past_v = inputs[5] if len(inputs) > 5 else None
        was_3d = q.ndim == 3
        if was_3d:
            Hq = self.q_heads
            Hkv = self.kv_heads or Hq
            B, Sq = q.shape[0], q.shape[1]
            Skv = k.shape[1]
            q = xp.swapaxes(q.reshape(B, Sq, Hq, q.shape[2] // Hq), 1, 2)
            k = xp.swapaxes(k.reshape(B, Skv, Hkv, k.shape[2] // Hkv), 1, 2)
            v = xp.swapaxes(v.reshape(B, Skv, Hkv, v.shape[2] // Hkv), 1, 2)
        if past_k is not None:
            k = xp.concatenate([past_k, k], axis=2)
        if past_v is not None:
            v = xp.concatenate([past_v, v], axis=2)
        return q, k, v, mask, was_3d

    @staticmethod
    def _expand_pos_mask(xp, pos, Sq, Skv):
        """Rank-1 position mask -> dense boolean (B, 1, Sq, Skv):
        query row s of batch b sees keys j <= pos[b] + s."""
        j = xp.arange(Skv).reshape(1, 1, 1, Skv).astype(pos.dtype)
        s = xp.arange(Sq).reshape(1, 1, Sq, 1).astype(pos.dtype)
        return j <= (pos.reshape(-1, 1, 1, 1) + s)

    def eval(self, inputs):
        out_dt = inputs[0].dtype
        q, k, v, mask, was_3d = self._norm(np, inputs)
        if mask is not None and mask.ndim in (0, 1):
            mask = self._expand_pos_mask(np, np.reshape(mask, (-1,)),
                                         q.shape[2], k.shape[2])
        qf = q.astype(np.float32)
        kf = k.astype(np.float32)
        vf = v.astype(np.float32)
        B, Hq, Sq, D = qf.shape
        Hkv = kf.shape[1]
        rep = Hq // Hkv
        if rep > 1:
            kf = np.repeat(kf, rep, axis=1)
            vf = np.repeat(vf, rep, axis=1)
        scale = self.scale if self.scale is not None else 1.0 / np.sqrt(D)
        scores = np.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        qk_out = scores
        if mask is not None:
            if mask.dtype == np.bool_:
                scores = np.where(mask, scores, np.float32(-1e30))
            else:
                scores = scores + mask.astype(np.float32)
        if self.is_causal:
            Skv = kf.shape[2]
            causal = np.tril(np.ones((Sq, Skv), dtype=bool), k=Skv - Sq)
            scores = np.where(causal, scores, np.float32(-1e30))
        if self.qk_mode >= 1:
            qk_out = scores
        if self.softcap > 0:
            scores = self.softcap * np.tanh(scores / self.softcap)
        if self.qk_mode >= 2:
            qk_out = scores
        p = _np_softmax(scores, axis=-1)
        if self.qk_mode >= 3:
            qk_out = p
        y = np.einsum("bhqk,bhkd->bhqd", p, vf).astype(out_dt)
        if was_3d:
            yB, yH, yS, yDv = y.shape
            y = np.swapaxes(y, 1, 2).reshape(yB, yS, yH * yDv)
        outs = [y, k, v, qk_out.astype(out_dt)]
        return outs[:self.n_out]

    def infer(self, infos):
        if all(i is None or i.level is Level.NUMERIC for i in infos) \
                and all(i is not None for i in infos[:3]):
            outs = self.eval([None if i is None else i.value for i in infos])
            return [TensorInfo.numeric(o) for o in outs]
        q, k, v = infos[0], infos[1], infos[2]
        has_past = len(infos) > 4 and infos[4] is not None
        if self.n_out == 1 and not has_past and q.rank == 4:
            dq, dv = q.dims(), v.dims()
            if dq is not None and dv is not None:
                return [TensorInfo.shaped(q.dtype, [dq[0], dq[1], dq[2], dv[3]])]
            return [TensorInfo.ranked(q.dtype, 4)]
        # multi-output / past-KV / 3-D surfaces: Y keeps q's rank, the
        # present outputs are always 4-D, the qk capture is 4-D; seq
        # dims after past-concat are left unknown (conservative lattice
        # level — validate-by-default eval accepts any lower level)
        outs = []
        if q.rank is not None:
            outs.append(TensorInfo.ranked(q.dtype, q.rank))
        else:
            outs.append(TensorInfo.minimal(q.dtype))
        if self.n_out >= 2:
            outs.append(TensorInfo.ranked(k.dtype, 4)
                        if k is not None else TensorInfo.minimal(q.dtype))
        if self.n_out >= 3:
            outs.append(TensorInfo.ranked(v.dtype, 4)
                        if v is not None else TensorInfo.minimal(q.dtype))
        if self.n_out >= 4:
            outs.append(TensorInfo.ranked(q.dtype, 4))
        return outs[:self.n_out]


@dataclass
class RotaryMilli(MilliOp):
    """Rotary position embedding.

    inputs: x (B, H, S, D) — or (B, S, H*D) when num_heads is set —
            cos (S', D/2 or D), sin (S', D/2 or D)
            [, position_ids (B, S) or (S,)]
    Without position_ids the caches may also be (B, S, D/2) per the
    ONNX-23 spec (rows already positioned).
    interleaved=False (GPT-NeoX style halves) or True (GPT-J pairs).
    rotary_dim: apply to the first `rotary_dim` features only (0 = all).
    """

    interleaved: bool = False
    rotary_dim: int = 0
    num_heads: int = 0
    KIND = "Rotary"

    def _tables(self, xp, cos, sin, pos, S):
        # select rows by positions; 3-D (B,S,half) caches come
        # pre-positioned (the ONNX-23 no-position_ids form)
        if pos is not None:
            cos = cos[pos.astype(np.int64) if isinstance(pos, np.ndarray) else pos]
            sin = sin[pos.astype(np.int64) if isinstance(pos, np.ndarray) else pos]
        elif cos.ndim == 2:
            cos = cos[:S]
            sin = sin[:S]
        return cos, sin

    def eval(self, inputs):
        x = inputs[0]
        cos, sin = inputs[1], inputs[2]
        pos = inputs[3] if len(inputs) > 3 and inputs[3] is not None else None
        out_dt = x.dtype
        xf = x.astype(np.float32)
        was_3d = xf.ndim == 3
        if was_3d:
            Bx, Sx = xf.shape[0], xf.shape[1]
            xf = np.swapaxes(xf.reshape(Bx, Sx, self.num_heads, -1), 1, 2)
        B, H, S, D = xf.shape
        rd = self.rotary_dim or D
        xr, xpass = xf[..., :rd], xf[..., rd:]
        cos, sin = self._tables(xf, cos.astype(np.float32), sin.astype(np.float32), pos, S)
        # shape cos/sin to (B or 1, 1, S, rd/2)
        while cos.ndim < 3:
            cos = cos[None]
            sin = sin[None]
        cos = cos[:, None, :, :]
        sin = sin[:, None, :, :]
        half = rd // 2
        if cos.shape[-1] == rd:  # full-width tables
            cos_h, sin_h = cos[..., :half], sin[..., :half]
        else:
            cos_h, sin_h = cos, sin
        if self.interleaved:
            x1 = xr[..., 0::2]
            x2 = xr[..., 1::2]
            o1 = x1 * cos_h - x2 * sin_h
            o2 = x2 * cos_h + x1 * sin_h
            rot = np.empty_like(xr)
            rot[..., 0::2] = o1
            rot[..., 1::2] = o2
        else:
            x1 = xr[..., :half]
            x2 = xr[..., half:]
            rot = np.concatenate([x1 * cos_h - x2 * sin_h,
                                  x2 * cos_h + x1 * sin_h], axis=-1)
        out = np.concatenate([rot, xpass], axis=-1) if rd < D else rot
        if was_3d:
            out = np.swapaxes(out, 1, 2).reshape(B, S, H * D)
        return [out.astype(out_dt)]

    def infer(self, infos):
        i = infos[0]
        if all(f is not None and f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [i.forget_value()]


# -- lowerings ----------------------------------------------------------


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


def flash_mode(op, q, k, v, mask, need_qk: bool) -> Optional[str]:
    """"causal" or "additive" when this call takes flash_attention in
    that mode: exactly the calls its wrapper takes (once k and v are
    contiguous). None sends it to the plain path."""
    if need_qk or op.softcap or q.ndim != 4 or k.ndim != 4:
        return None
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not (Sq > 1 and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and tuple(v.shape) == tuple(k.shape) and k.shape[0] == B
            and D == k.shape[3] and D in FLASH_HEAD_DIMS and Hkv > 0
            and Hq % Hkv == 0 and B <= 65535):
        return None
    if op.is_causal:
        return "causal" if mask is None else None
    if mask is not None and mask.is_floating_point() and mask.ndim == 4 \
            and mask.shape[0] in (1, B) \
            and tuple(mask.shape[1:]) == (1, Sq, Skv):
        return "additive"
    return None


def pos_mode(op, q, k, v, pos, need_qk: bool) -> Optional[str]:
    """"decode" when this position-mask call takes decode_attention,
    "flash_pos" when it takes flash_attention's pos-bound mode: exactly
    the calls their wrappers take (once k and v are contiguous). None
    sends it to the plain path: a head dim the kernels lack (Phi-3's 96),
    Dv != D, an f32 or f16 cache, a softcap (Gemma-2), a qk output."""
    if need_qk or op.softcap or op.is_causal or q.ndim != 4 or k.ndim != 4:
        return None
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if not (tuple(v.shape) == tuple(k.shape) and k.shape[0] == B
            and D == k.shape[3] and Hkv > 0 and Hq % Hkv == 0
            and B <= 65535 and k.dtype == v.dtype == torch.bfloat16
            and pos.dtype in (torch.int64, torch.int32)
            and pos.numel() in (1, B)):
        return None
    if Sq == 1 and D in DECODE_HEAD_DIMS and q.dtype in DECODE_Q_TYPES:
        return "decode"
    if Sq > 1 and D in FLASH_HEAD_DIMS and q.dtype == torch.bfloat16:
        return "flash_pos"
    return None


def shift_rows(mask: torch.Tensor) -> torch.Tensor:
    """An additive mask less its row maximum (where finite): the softmax
    is the same, and a row masked everywhere by one large finite value
    keeps the scores' order."""
    top = mask.amax(dim=-1, keepdim=True)
    return mask - torch.where(torch.isfinite(top), top, torch.zeros_like(top))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash(mode: str, q, k, v, mask, scale) -> torch.Tensor:
    """flash_attention in `mode` (flash_mode's, or "flash_pos", where
    `mask` is the (B,) positions)."""
    k, v = _aligned(k), _aligned(v)
    # q is read through its strides (the recipes' Transpose view)
    if q.stride(3) != 1:
        q = q.contiguous()
    if mode == "flash_pos":
        return flash_attention(q, k, v, scale, pos_bound=mask)
    if mode == "additive":
        return flash_attention(q, k, v, scale,
                               mask=shift_rows(mask.float()))
    Sq, Skv = q.shape[2], k.shape[2]
    if Sq <= Skv:
        return flash_attention(q, k, v, scale, causal=True)
    # the first Sq - Skv rows see no key: the oracle's -1e30 fill gives
    # them the mean of v; the rest are a causal call of Skv rows
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(
        Hq // Hkv, dim=1).to(q.dtype).expand(B, Hq, Sq - Skv, D)
    tail = flash_attention(q[:, :, Sq - Skv:], k, v, scale, causal=True)
    return torch.cat([mean, tail], dim=2)


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
        mode = pos_mode(op, q, k, v, pos, need_qk)
        # (a cache read in place is contiguous already: no copy)
        if mode == "decode":
            return finish(decode_attention(_aligned(q), _aligned(k),
                                           _aligned(v), pos, scale))
        if mode == "flash_pos":
            return finish(_flash(mode, q, k, v, pos, scale))
        mask = position_mask(pos, Sq, Skv)
    else:
        mode = flash_mode(op, q, k, v, mask, need_qk)
        if mode is not None:
            return finish(_flash(mode, q, k, v, mask, scale))

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
    shifted = None      # the softmax's input where the mask is shifted
    if mask is not None:
        m = mask.reshape((1,) * (4 - mask.ndim) + tuple(mask.shape))
        if rep > 1:
            # (b, Hq|1, Sq, Skv) against the grouped (B, Hkv, rep, ...)
            m = (m.reshape(m.shape[0], Hkv, rep, *m.shape[2:])
                 if m.shape[1] == Hq else m.unsqueeze(2))
        if m.dtype == torch.bool:
            scores = scores.masked_fill(~m, -1e30)
        elif op.softcap:
            scores = scores + m.float()    # a softcap is not shift-free
        else:
            shifted = scores + shift_rows(m.float())
            # the captured stages keep the unshifted bias
            scores = scores + m.float() if op.qk_mode >= 1 else shifted
    if op.is_causal:
        causal = torch.ones(Sq, Skv, dtype=torch.bool,
                            device=q.device).tril(Skv - Sq)
        scores = scores.masked_fill(~causal, -1e30)
        if shifted is not None:
            shifted = shifted.masked_fill(~causal, -1e30)
    if op.qk_mode >= 1:
        qk_out = scores
    if op.softcap > 0:
        scores = op.softcap * torch.tanh(scores / op.softcap)
    if op.qk_mode >= 2:
        qk_out = scores
    p = torch.softmax(scores if shifted is None else shifted, dim=-1)
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
