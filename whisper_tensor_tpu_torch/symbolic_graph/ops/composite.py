"""Composite symbolic ops (fused attention, rotary embedding, the KV
cache write) -> milli lowerings.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/composite.py,
trimmed to the ONNX op types the llama and GPT-2 recipes emit:
Attention, RotaryEmbedding and the custom-domain CacheWrite. Any other
op type raises UnsupportedOnnxOp at import.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...milli.ops.attention import AttentionMilli, RotaryMilli
from ...milli.ops.misc import DynUpdateSliceMilli
from .base import Operation, register


@register("Attention")
@dataclass
class Attention(Operation):
    """Fused SDPA (full ONNX opset 23 Attention: 3-D/4-D Q/K/V, GQA,
    mask, past/present KV, softcap, qk_matmul_output capture)."""

    scale: Optional[float] = None
    is_causal: bool = False
    softcap: float = 0.0
    qk_matmul_output_mode: int = 0
    q_num_heads: int = 0
    kv_num_heads: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("scale", None), bool(attrs.i("is_causal", 0)),
                   attrs.f("softcap", 0.0),
                   attrs.i("qk_matmul_output_mode", 0),
                   attrs.i("q_num_heads", 0), attrs.i("kv_num_heads", 0))

    def lower(self, ctx, inputs, n_outputs):
        args = list(inputs)
        while args and args[-1] is None:  # trim trailing absent optionals
            args.pop()
        return ctx.emit(
            AttentionMilli(self.scale, self.is_causal, self.softcap,
                           qk_mode=self.qk_matmul_output_mode,
                           q_heads=self.q_num_heads,
                           kv_heads=self.kv_num_heads,
                           n_out=n_outputs),
            *args, n_outputs=n_outputs)


@register("RotaryEmbedding")
@dataclass
class RotaryEmbedding(Operation):
    interleaved: bool = False
    rotary_embedding_dim: int = 0
    num_heads: int = 0   # required for the 3-D (B,S,H*D) layout

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("interleaved", 0)),
                   attrs.i("rotary_embedding_dim", 0),
                   attrs.i("num_heads", 0))

    def lower(self, ctx, inputs, n_outputs):
        args = [i for i in inputs if i is not None]
        return [ctx.emit1(RotaryMilli(self.interleaved,
                                      self.rotary_embedding_dim,
                                      self.num_heads), *args)]


@register("CacheWrite")
@dataclass
class CacheWrite(Operation):
    """Custom-domain (wt) op: write `update` into `cache` at offset
    `start` along `axis`. Used by LLM recipes for fixed-shape KV caches
    (the TPU-native replacement for the reference's concat-grow KV pattern)."""

    axis: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(DynUpdateSliceMilli(self.axis),
                          inputs[0], inputs[1], inputs[2])]
