"""Composite symbolic ops: Attention, RotaryEmbedding, LSTM, STFT,
CacheWrite, GRU, RNN, Dropout, DepthToSpace/SpaceToDepth,
QuantizeLinear/DequantizeLinear.

Reference equivalents: RotaryEmbedding / Lstm / Stft / QuantMatMul in
src/symbolic_graph/ops/mod.rs:223-286.

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/composite.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


from ...dtype import DType, ONNX_TO_DTYPE
from ...milli.ops.attention import AttentionMilli, RotaryMilli
from ...milli.ops.quant import DequantizeLinearMilli, QuantizeLinearMilli
from ...milli.ops.rnn import GruMilli, LstmMilli, RnnMilli
from ...milli.ops.signal import StftMilli
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


@register("LSTM")
@dataclass
class LSTM(Operation):
    hidden_size: int = 0
    direction: str = "forward"
    layout: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        acts = attrs.strings("activations", None)
        if acts and [a.lower() for a in acts[:3]] != ["sigmoid", "tanh", "tanh"]:
            raise NotImplementedError(f"LSTM custom activations {acts}")
        return cls(attrs.i("hidden_size", 0), attrs.s("direction", "forward"),
                   attrs.i("layout", 0))

    def lower(self, ctx, inputs, n_outputs):
        outs = ctx.emit(LstmMilli(self.hidden_size, self.direction,
                                  self.layout), *inputs, n_outputs=3)
        return outs[:n_outputs] if n_outputs < 3 else outs


@register("STFT")
@dataclass
class STFT(Operation):
    onesided: bool = True

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("onesided", 1)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(StftMilli(self.onesided), *inputs)]


@register("Dropout")
@dataclass
class Dropout(Operation):
    """Inference: identity (+ all-true mask). Training (opset-13
    training_mode input true): the official seeded numpy draw, via
    DropoutMilli (oracle path). Opset<12 attr form is always
    inference per ONNX >= 7."""

    seed: Optional[int] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("seed", None))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.extra import DropoutMilli

        args = list(inputs)
        while args and args[-1] is None:
            args.pop()
        return ctx.emit(DropoutMilli(self.seed, n_out=n_outputs), *args,
                        n_outputs=n_outputs)


@register("DepthToSpace")
@dataclass
class DepthToSpace(Operation):
    blocksize: int = 1
    mode: str = "DCR"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("blocksize", 1), attrs.s("mode", "DCR"))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.misc import DepthToSpaceMilli

        return [ctx.emit1(DepthToSpaceMilli(self.blocksize, self.mode), inputs[0])]


@register("SpaceToDepth")
@dataclass
class SpaceToDepth(Operation):
    blocksize: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("blocksize", 1))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.misc import SpaceToDepthMilli

        return [ctx.emit1(SpaceToDepthMilli(self.blocksize), inputs[0])]


@register("QuantizeLinear")
@dataclass
class QuantizeLinear(Operation):
    axis: int = 1
    output_dtype: Optional[DType] = None
    block_size: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 1),
                   ONNX_TO_DTYPE.get(attrs.i("output_dtype", 0)),
                   attrs.i("block_size", 0))

    def lower(self, ctx, inputs, n_outputs):
        args = [i for i in inputs if i is not None]
        return [ctx.emit1(QuantizeLinearMilli(self.axis, self.output_dtype,
                                              self.block_size), *args)]


@register("DequantizeLinear")
@dataclass
class DequantizeLinear(Operation):
    axis: int = 1
    block_size: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 1), attrs.i("block_size", 0))

    def lower(self, ctx, inputs, n_outputs):
        args = [i for i in inputs if i is not None]
        return [ctx.emit1(DequantizeLinearMilli(self.axis,
                                                self.block_size), *args)]


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
        from ...milli.ops.misc import DynUpdateSliceMilli

        return [ctx.emit1(DynUpdateSliceMilli(self.axis),
                          inputs[0], inputs[1], inputs[2])]


@register("GRU")
@dataclass
class GRU(Operation):
    hidden_size: int = 0
    direction: str = "forward"
    linear_before_reset: bool = False
    layout: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        acts = attrs.strings("activations", None)
        if acts and [a.lower() for a in acts[:2]] != ["sigmoid", "tanh"]:
            raise NotImplementedError(f"GRU custom activations {acts}")
        return cls(attrs.i("hidden_size", 0), attrs.s("direction", "forward"),
                   bool(attrs.i("linear_before_reset", 0)),
                   attrs.i("layout", 0))

    def lower(self, ctx, inputs, n_outputs):
        outs = ctx.emit(GruMilli(self.hidden_size, self.direction,
                                 self.linear_before_reset, self.layout),
                        *inputs,
                        n_outputs=2)
        return outs[:n_outputs] if n_outputs < 2 else outs


@register("RNN")
@dataclass
class RNN(Operation):
    hidden_size: int = 0
    direction: str = "forward"
    activation: str = "tanh"
    layout: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        acts = attrs.strings("activations", None)
        act = (acts[0].lower() if acts else "tanh")
        if act not in ("tanh", "relu"):
            raise NotImplementedError(f"RNN activation {act}")
        return cls(attrs.i("hidden_size", 0), attrs.s("direction", "forward"),
                   act, attrs.i("layout", 0))

    def lower(self, ctx, inputs, n_outputs):
        outs = ctx.emit(RnnMilli(self.hidden_size, self.direction,
                                 self.activation, self.layout), *inputs,
                        n_outputs=2)
        return outs[:n_outputs] if n_outputs < 2 else outs
