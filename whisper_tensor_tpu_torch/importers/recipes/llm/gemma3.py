"""Gemma-3 (text) import recipe.

Reference equivalent: crates/whisper-tensor-import/src/models/llm/
gemma3.rs (gemma3_text). Deltas from gemma-2: per-head QK RMSNorm,
alternating sliding-window/global attention layers with separate rope
bases (rope_local_base_freq for local layers), no attention softcapping,
query scaling by query_pre_attn_scalar^-0.5.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/gemma3.py,
unchanged: the same getter gives the reference's ONNX bytes. Global and
sliding-window layers each take an additive (1, 1, S, max_len) mask,
which sends their bf16 prefills to flash_attention's additive mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from .gemma import GemmaConfig
from .llama import LlamaConfig, rope_tables


@dataclass
class Gemma3Config:
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    hidden_size: int = 2304
    intermediate_size: int = 9216
    vocab_size: int = 262144
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_local_base_freq: float = 10000.0
    head_dim: int = 256
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 512
    sliding_window_pattern: int = 6      # every Nth layer is global
    model_type: str = "gemma3_text"

    @staticmethod
    def from_hf(cfg: dict) -> "Gemma3Config":
        return Gemma3Config(
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", 1),
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            vocab_size=cfg["vocab_size"],
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            rope_theta=cfg.get("rope_theta", 1e6),
            rope_local_base_freq=cfg.get("rope_local_base_freq", 1e4),
            head_dim=cfg.get("head_dim", 256),
            query_pre_attn_scalar=cfg.get("query_pre_attn_scalar", 256.0),
            sliding_window=cfg.get("sliding_window", 512),
            sliding_window_pattern=cfg.get("sliding_window_pattern",
                                           cfg.get("layer_types") and 6 or 6),
            model_type=cfg.get("model_type", "gemma3_text"))

    def is_global_layer(self, i: int) -> bool:
        return (i + 1) % self.sliding_window_pattern == 0


def build_gemma3_step(weights: Callable[[str], np.ndarray], cfg: Gemma3Config,
                      max_len: int, dtype: DType = DType.F32,
                      storage: Optional[WeightStorage] = None) -> bytes:
    E, Hq, Hkv, D = cfg.hidden_size, cfg.num_attention_heads, \
        cfg.num_key_value_heads, cfg.head_dim
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return np.ascontiguousarray(w(name).T)

    def norm_w(name):
        return (np.asarray(weights(name)).astype(np.float32) + 1.0).astype(np_dt)

    b = OnnxBuilder("gemma3_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, [])
    cache_ins = [(b.input(f"cache_k_{i}", dtype, ["batch", Hkv, max_len, D]),
                  b.input(f"cache_v_{i}", dtype, ["batch", Hkv, max_len, D]))
                 for i in range(L)]

    embed = b.initializer("embed_tokens", w("model.embed_tokens.weight"))
    x = b.gather(embed, ids)
    sc = b.const(np.asarray(float(np.sqrt(E)), dtype=np.float32))
    x = b.mul(x, b.node("CastLike", [sc, x]))

    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero, one = b.const_i64(0), b.const_i64(1)
    abs_pos = b.add(b.node("Range", [zero, s_scalar, one]),
                    b.node("Cast", [pos], to=7))
    mrange = b.node("Range", [zero, b.const_i64(max_len), one])
    m2 = b.node("Unsqueeze", [mrange, b.const_i64([0])])
    q2 = b.node("Unsqueeze", [abs_pos, b.const_i64([1])])
    causal_vis = b.node("LessOrEqual", [m2, q2])
    zero_f = b.const(np.asarray(0.0, dtype=np.float32))
    neg_f = b.const(np.asarray(-1e30, dtype=np.float32))

    def to_mask(vis):
        m = b.node("Where", [vis, zero_f, neg_f])
        m = b.node("Unsqueeze", [m, b.const_i64([0, 1])])
        return b.cast(m, dtype) if dtype is not DType.F32 else m

    global_mask = to_mask(causal_vis)
    # sliding window: also require m > q_abs - window
    lo = b.node("Sub", [q2, b.const_i64(cfg.sliding_window)])
    win_vis = b.node("And", [causal_vis, b.node("Greater", [m2, lo])])
    local_mask = to_mask(win_vis)

    g_cfg = LlamaConfig(rope_theta=cfg.rope_theta, head_dim=D,
                        hidden_size=E, num_attention_heads=Hq)
    l_cfg = LlamaConfig(rope_theta=cfg.rope_local_base_freq, head_dim=D,
                        hidden_size=E, num_attention_heads=Hq)
    gcos_t, gsin_t = rope_tables(g_cfg, max_len)
    lcos_t, lsin_t = rope_tables(l_cfg, max_len)
    gcos = b.initializer("rope_cos_g", gcos_t.astype(np_dt))
    gsin = b.initializer("rope_sin_g", gsin_t.astype(np_dt))
    lcos = b.initializer("rope_cos_l", lcos_t.astype(np_dt))
    lsin = b.initializer("rope_sin_l", lsin_t.astype(np_dt))

    eps = cfg.rms_norm_eps
    q_scale = float(cfg.query_pre_attn_scalar) ** -0.5
    cache_outs = []
    for i in range(L):
        p = f"model.layers.{i}."
        is_global = cfg.is_global_layer(i)
        cos, sin = (gcos, gsin) if is_global else (lcos, lsin)
        mask = global_mask if is_global else local_mask

        h = b.rms_norm(x, b.initializer(f"in_norm_{i}",
                                        norm_w(p + "input_layernorm.weight")),
                       epsilon=eps)
        q = b.matmul(h, b.initializer(f"wq_{i}", wT(p + "self_attn.q_proj.weight")))
        k = b.matmul(h, b.initializer(f"wk_{i}", wT(p + "self_attn.k_proj.weight")))
        v = b.matmul(h, b.initializer(f"wv_{i}", wT(p + "self_attn.v_proj.weight")))

        def heads(t, nh):
            return b.transpose(b.reshape(t, [0, 0, nh, D]), [0, 2, 1, 3])

        qh = heads(q, Hq)
        kh = heads(k, Hkv)
        # per-head QK RMSNorm (gemma3)
        qh = b.rms_norm(qh, b.initializer(f"qn_{i}",
                                          norm_w(p + "self_attn.q_norm.weight")),
                        epsilon=eps)
        kh = b.rms_norm(kh, b.initializer(f"kn_{i}",
                                          norm_w(p + "self_attn.k_norm.weight")),
                        epsilon=eps)
        qh = b.rotary(qh, cos, sin, position_ids=abs_pos)
        kh = b.rotary(kh, cos, sin, position_ids=abs_pos)
        vh = heads(v, Hkv)
        ck, cv = cache_ins[i]
        nk = b.node("CacheWrite", [ck, kh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_k_{i}"])
        nv = b.node("CacheWrite", [cv, vh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_v_{i}"])
        cache_outs.append((nk, nv))
        att = b.attention(qh, nk, nv, mask=mask, scale=q_scale)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, Hq * D])
        att = b.matmul(att, b.initializer(f"wo_{i}", wT(p + "self_attn.o_proj.weight")))
        att = b.rms_norm(att, b.initializer(
            f"post_attn_norm_{i}", norm_w(p + "post_attention_layernorm.weight")),
            epsilon=eps)
        x = b.add(x, att)

        h2 = b.rms_norm(x, b.initializer(
            f"pre_ffw_norm_{i}", norm_w(p + "pre_feedforward_layernorm.weight")),
            epsilon=eps)
        gate = b.matmul(h2, b.initializer(f"w_gate_{i}", wT(p + "mlp.gate_proj.weight")))
        up = b.matmul(h2, b.initializer(f"w_up_{i}", wT(p + "mlp.up_proj.weight")))
        act = b.node("Gelu", [gate], approximate="tanh")
        mlp = b.matmul(b.mul(act, up),
                       b.initializer(f"w_down_{i}", wT(p + "mlp.down_proj.weight")))
        mlp = b.rms_norm(mlp, b.initializer(
            f"post_ffw_norm_{i}", norm_w(p + "post_feedforward_layernorm.weight")),
            epsilon=eps)
        x = b.add(x, mlp)

    xf = b.rms_norm(x, b.initializer("final_norm", norm_w("model.norm.weight")),
                    epsilon=eps)
    lm = b.initializer("lm_head", np.ascontiguousarray(
        w("model.embed_tokens.weight").T))
    b.node("MatMul", [xf, lm], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", Hkv, max_len, D])
        b.output(nv, dtype, ["batch", Hkv, max_len, D])
    return b.build(storage or WeightStorage.embed())
