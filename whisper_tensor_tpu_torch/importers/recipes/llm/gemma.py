"""Gemma / Gemma-2 import recipe.

Reference equivalents: crates/whisper-tensor-import/src/models/llm/
{gemma,gemma2}.rs. Differences from llama: sqrt(hidden)-scaled
embeddings, RMSNorm applies (1 + weight), GeGLU (tanh-gelu) MLP,
gemma-2 adds pre/post-feedforward norms and attn/final logit
softcapping.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/gemma.py,
unchanged: the same getter gives the reference's ONNX bytes. Gemma-2's
attention softcap keeps its Attention calls off flash_attention, as the
reference's gates keep them off the TPU kernel; its (1, 1, S, max_len)
additive mask sends Gemma's bf16 prefills to flash_attention's additive
mode at head dim 256 (milli/ops/attention.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from .llama import rope_tables


@dataclass
class GemmaConfig:
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    hidden_size: int = 2048
    intermediate_size: int = 16384
    vocab_size: int = 256000
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    head_dim: Optional[int] = 256
    query_pre_attn_scalar: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None     # gemma2
    final_logit_softcapping: Optional[float] = None    # gemma2
    gemma2: bool = False
    model_type: str = "gemma"

    @staticmethod
    def from_hf(cfg: dict) -> "GemmaConfig":
        mt = cfg.get("model_type", "gemma")
        return GemmaConfig(
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", 1),
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            vocab_size=cfg["vocab_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            rope_theta=cfg.get("rope_theta", 10000.0),
            head_dim=cfg.get("head_dim", 256),
            query_pre_attn_scalar=cfg.get("query_pre_attn_scalar"),
            attn_logit_softcapping=cfg.get("attn_logit_softcapping"),
            final_logit_softcapping=cfg.get("final_logit_softcapping"),
            gemma2=(mt == "gemma2"),
            model_type=mt,
        )

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def build_gemma_step(weights: Callable[[str], np.ndarray], cfg: GemmaConfig,
                     max_len: int, dtype: DType = DType.F32,
                     storage: Optional[WeightStorage] = None) -> bytes:
    E, Hq, Hkv, D = cfg.hidden_size, cfg.num_attention_heads, \
        cfg.num_key_value_heads, cfg.hd
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return np.ascontiguousarray(w(name).T)

    def gemma_norm_weight(name):
        # gemma RMSNorm multiplies by (1 + weight)
        return (np.asarray(weights(name)).astype(np.float32) + 1.0).astype(np_dt)

    b = OnnxBuilder(f"{cfg.model_type}_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, [])
    cache_ins = [(b.input(f"cache_k_{i}", dtype, ["batch", Hkv, max_len, D]),
                  b.input(f"cache_v_{i}", dtype, ["batch", Hkv, max_len, D]))
                 for i in range(L)]

    embed = b.initializer("embed_tokens", w("model.embed_tokens.weight"))
    x = b.gather(embed, ids)
    scale_emb = b.const(np.asarray(float(np.sqrt(E)), dtype=np.float32))
    x = b.mul(x, b.node("CastLike", [scale_emb, x]))

    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero, one = b.const_i64(0), b.const_i64(1)
    abs_pos = b.add(b.node("Range", [zero, s_scalar, one]),
                    b.node("Cast", [pos], to=7))
    mrange = b.node("Range", [zero, b.const_i64(max_len), one])
    vis = b.node("LessOrEqual",
                 [b.node("Unsqueeze", [mrange, b.const_i64([0])]),
                  b.node("Unsqueeze", [abs_pos, b.const_i64([1])])])
    mask = b.node("Where", [vis, b.const(np.asarray(0.0, dtype=np.float32)),
                            b.const(np.asarray(-1e30, dtype=np.float32))])
    mask = b.node("Unsqueeze", [mask, b.const_i64([0, 1])])
    if dtype is not DType.F32:
        mask = b.cast(mask, dtype)

    from .llama import LlamaConfig

    rope_cfg = LlamaConfig(rope_theta=cfg.rope_theta, head_dim=D,
                           hidden_size=E, num_attention_heads=Hq)
    cos_t, sin_t = rope_tables(rope_cfg, max_len)
    cos = b.initializer("rope_cos", cos_t.astype(np_dt))
    sin = b.initializer("rope_sin", sin_t.astype(np_dt))

    eps = cfg.rms_norm_eps
    q_scale = (1.0 / float(np.sqrt(cfg.query_pre_attn_scalar))
               if cfg.query_pre_attn_scalar else 1.0 / float(np.sqrt(D)))
    cache_outs = []
    for i in range(L):
        p = f"model.layers.{i}."
        h = b.rms_norm(x, b.initializer(f"in_norm_{i}",
                                        gemma_norm_weight(p + "input_layernorm.weight")),
                       epsilon=eps)
        q = b.matmul(h, b.initializer(f"wq_{i}", wT(p + "self_attn.q_proj.weight")))
        k = b.matmul(h, b.initializer(f"wk_{i}", wT(p + "self_attn.k_proj.weight")))
        v = b.matmul(h, b.initializer(f"wv_{i}", wT(p + "self_attn.v_proj.weight")))

        def heads(tns, nh):
            return b.transpose(b.reshape(tns, [0, 0, nh, D]), [0, 2, 1, 3])

        qh = b.rotary(heads(q, Hq), cos, sin, position_ids=abs_pos)
        kh = b.rotary(heads(k, Hkv), cos, sin, position_ids=abs_pos)
        vh = heads(v, Hkv)
        ck, cv = cache_ins[i]
        nk = b.node("CacheWrite", [ck, kh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_k_{i}"])
        nv = b.node("CacheWrite", [cv, vh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_v_{i}"])
        cache_outs.append((nk, nv))
        att = b.attention(qh, nk, nv, mask=mask, scale=q_scale,
                          softcap=(float(cfg.attn_logit_softcapping)
                                   if cfg.gemma2 and cfg.attn_logit_softcapping
                                   else None))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, Hq * D])
        att = b.matmul(att, b.initializer(f"wo_{i}", wT(p + "self_attn.o_proj.weight")))
        if cfg.gemma2:
            att = b.rms_norm(att, b.initializer(
                f"post_attn_norm_{i}",
                gemma_norm_weight(p + "post_attention_layernorm.weight")),
                epsilon=eps)
            x = b.add(x, att)
            h2 = b.rms_norm(x, b.initializer(
                f"pre_ffw_norm_{i}",
                gemma_norm_weight(p + "pre_feedforward_layernorm.weight")),
                epsilon=eps)
        else:
            x = b.add(x, att)
            h2 = b.rms_norm(x, b.initializer(
                f"post_norm_{i}",
                gemma_norm_weight(p + "post_attention_layernorm.weight")),
                epsilon=eps)
        gate = b.matmul(h2, b.initializer(f"w_gate_{i}", wT(p + "mlp.gate_proj.weight")))
        up = b.matmul(h2, b.initializer(f"w_up_{i}", wT(p + "mlp.up_proj.weight")))
        act = b.node("Gelu", [gate], approximate="tanh")
        mlp = b.matmul(b.mul(act, up),
                       b.initializer(f"w_down_{i}", wT(p + "mlp.down_proj.weight")))
        if cfg.gemma2:
            mlp = b.rms_norm(mlp, b.initializer(
                f"post_ffw_norm_{i}",
                gemma_norm_weight(p + "post_feedforward_layernorm.weight")),
                epsilon=eps)
        x = b.add(x, mlp)

    xf = b.rms_norm(x, b.initializer("final_norm",
                                     gemma_norm_weight("model.norm.weight")),
                    epsilon=eps)
    lm = b.initializer("lm_head", np.ascontiguousarray(
        w("model.embed_tokens.weight").T))
    logits = b.matmul(xf, lm)
    if cfg.gemma2 and cfg.final_logit_softcapping:
        c = b.const(np.asarray(cfg.final_logit_softcapping, dtype=np.float32))
        cl = b.node("CastLike", [c, logits])
        logits = b.mul(cl, b.node("Tanh", [b.node("Div", [logits, cl])]))
    b.node("Identity", [logits], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", Hkv, max_len, D])
        b.output(nv, dtype, ["batch", Hkv, max_len, D])
    return b.build(storage or WeightStorage.embed())
