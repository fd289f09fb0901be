"""RMSNorm and LayerNorm lowerings (whisper_tensor_tpu/milli/ops/
norm.py:176 and :30).

Statistics in f32 (the ONNX stash_type=1 default), output rounded back
to the input type once.
"""

from __future__ import annotations

import torch

from ..registry import lowering


@lowering("RMSNorm")
def rms_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    ms = (xp * xp).mean(dim=dims, keepdim=True)
    y = xp * torch.rsqrt(ms + op.epsilon)
    return [(y * scale.to(xp.dtype)).to(x.dtype)]


@lowering("LayerNorm")
def layer_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    mean = xp.mean(dim=dims, keepdim=True)
    d = xp - mean
    inv = torch.rsqrt((d * d).mean(dim=dims, keepdim=True) + op.epsilon)
    y = d * inv * scale.to(xp.dtype)
    if bias is not None:
        y = y + bias.to(xp.dtype)
    stash = torch.float32 if op.stash_f32 else x.dtype
    return [y.to(x.dtype), mean.to(stash), inv.to(stash)][:op.n_out]
