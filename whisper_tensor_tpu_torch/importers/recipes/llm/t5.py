"""T5 import recipe (encoder-decoder, relative position bias).

BASELINE.json config #3. HF T5 layout. Design notes:
  * relative position bias is precomputed at import into dense tables
    (H, S, S) for the encoder and (H, MAX, MAX) for the decoder — the
    log-bucket function runs in numpy once, keeping the graphs static
    and additive-mask shaped (TPU-friendly; a few MB of table).
  * T5LayerNorm == RMSNorm (no bias, no mean subtraction); attention is
    UNscaled (scale=1.0); FF is relu (t5) or gated-gelu (t5-v1.1/flan).
  * decoder step graph uses the same fixed-cache design as the LLM
    recipes; cross K/V precomputed per utterance by the encoder graph.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/t5.py
(the same ONNX bytes by default), with one option of its own:
`pad_mask=True` gives the encoder an `attention_mask` input (B, L), 1
for a prompt token and 0 for a pad, which masks the pads out of its
self-attention and comes out as `cross_mask`, the additive (B, 1, 1, L)
mask the decoder step (built with `pad_mask=True` too) adds to its
cross-attention. A prompt shorter than the encoder's length then gives
the outputs of a graph built at the prompt's own length, as HF's T5
does under `attention_mask`. Every Attention of both graphs runs the
plain path: the relative-position bias is per head, (1 or B, H, Sq,
Skv), which no kernel mode takes, and the cross attention runs one
query row a step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from . import transposed


@dataclass
class T5Config:
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = False
    tie_word_embeddings: bool = True

    @staticmethod
    def from_hf(cfg: dict) -> "T5Config":
        return T5Config(
            num_layers=cfg["num_layers"],
            num_decoder_layers=cfg.get("num_decoder_layers", cfg["num_layers"]),
            num_heads=cfg["num_heads"], d_model=cfg["d_model"],
            d_kv=cfg["d_kv"], d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
            relative_attention_num_buckets=cfg.get(
                "relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get(
                "relative_attention_max_distance", 128),
            layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
            is_gated_act=("gated" in cfg.get("feed_forward_proj", "relu")),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True))


def _rel_bucket(rel: np.ndarray, bidirectional: bool, num_buckets: int,
                max_distance: int) -> np.ndarray:
    ret = np.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        ret += (rel > 0).astype(np.int64) * n
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact) * (n - max_exact)).astype(np.int64)
    large = np.minimum(large, n - 1)
    return ret + np.where(is_small, rel, large)


def rel_bias_table(emb: np.ndarray, q_len: int, k_len: int, bidirectional: bool,
                   num_buckets: int, max_distance: int) -> np.ndarray:
    """emb (num_buckets, H) -> bias (H, q_len, k_len)."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    buckets = _rel_bucket(mem - ctx, bidirectional, num_buckets, max_distance)
    return np.transpose(emb[buckets], (2, 0, 1)).astype(np.float32)


def build_t5_encoder(weights: Callable[[str], np.ndarray], cfg: T5Config,
                     seq_len: int, dtype: DType = DType.F32,
                     storage: Optional[WeightStorage] = None,
                     with_cross: bool = True,
                     pad_mask: bool = False) -> bytes:
    """with_cross=False: encoder-only (no decoder cross-K/V heads) — the
    form SD3/Flux use T5 in (pure text conditioning). pad_mask=True: an
    `attention_mask` input masks the pads (module docstring)."""
    E, H, DK = cfg.d_model, cfg.num_heads, cfg.d_kv
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(w(name))

    b = OnnxBuilder("t5_encoder", opset=23)
    ids = b.input("input_ids", DType.I64, ["batch", seq_len])
    x = b.gather(b.initializer("shared", w("shared.weight")), ids)

    bias = rel_bias_table(
        np.asarray(weights(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")),
        seq_len, seq_len, True, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    mask = b.initializer("enc_bias", bias[None].astype(np_dt))  # (1,H,S,S)
    if pad_mask:
        keep = b.input("attention_mask", DType.I64, ["batch", seq_len])
        pads = b.node("Unsqueeze", [b.node("Equal", [keep, b.const_i64(0)]),
                                    b.const_i64([1, 2])])
        cross_mask = _additive(b, pads, dtype)            # (B,1,1,S)
        mask = b.add(mask, cross_mask)                    # (B,H,S,S)

    def rms(xx, name):
        return b.rms_norm(xx, b.initializer(name + "_g", w(name + ".weight")),
                          epsilon=cfg.layer_norm_epsilon)

    def heads(t):
        return b.transpose(b.reshape(t, [0, 0, H, DK]), [0, 2, 1, 3])

    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}."
        h = rms(x, p + "layer.0.layer_norm")
        sp = p + "layer.0.SelfAttention."
        q = b.matmul(h, b.initializer(sp + "q_T", wT(sp + "q.weight")))
        k = b.matmul(h, b.initializer(sp + "k_T", wT(sp + "k.weight")))
        v = b.matmul(h, b.initializer(sp + "v_T", wT(sp + "v.weight")))
        att = b.attention(heads(q), heads(k), heads(v), mask=mask, scale=1.0)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, H * DK])
        x = b.add(x, b.matmul(att, b.initializer(sp + "o_T", wT(sp + "o.weight"))))
        h2 = rms(x, p + "layer.1.layer_norm")
        fp = p + "layer.1.DenseReluDense."
        if cfg.is_gated_act:
            g0 = b.matmul(h2, b.initializer(fp + "wi0_T", wT(fp + "wi_0.weight")))
            g1 = b.matmul(h2, b.initializer(fp + "wi1_T", wT(fp + "wi_1.weight")))
            hmid = b.mul(b.node("Gelu", [g0], approximate="tanh"), g1)
        else:
            hmid = b.node("Relu", [b.matmul(h2, b.initializer(
                fp + "wi_T", wT(fp + "wi.weight")))])
        x = b.add(x, b.matmul(hmid, b.initializer(fp + "wo_T", wT(fp + "wo.weight"))))

    x = rms(x, "encoder.final_layer_norm")
    b.node("Identity", [x], outputs=["encoder_states"])
    b.output("encoder_states", dtype, ["batch", seq_len, E])
    # cross K/V per decoder layer
    for i in range(cfg.num_decoder_layers if with_cross else 0):
        cp = f"decoder.block.{i}.layer.1.EncDecAttention."
        k = b.matmul(x, b.initializer(cp + "k_T", wT(cp + "k.weight")))
        v = b.matmul(x, b.initializer(cp + "v_T", wT(cp + "v.weight")))
        b.node("Identity", [heads(k)], outputs=[f"cross_k_{i}"])
        b.node("Identity", [heads(v)], outputs=[f"cross_v_{i}"])
        b.output(f"cross_k_{i}", dtype, ["batch", H, seq_len, DK])
        b.output(f"cross_v_{i}", dtype, ["batch", H, seq_len, DK])
    if pad_mask and with_cross:
        b.node("Identity", [cross_mask], outputs=["cross_mask"])
        b.output("cross_mask", dtype, ["batch", 1, 1, seq_len])
    return b.build(storage or WeightStorage.embed())


def _additive(b: OnnxBuilder, hidden: str, dtype: DType) -> str:
    """A bool tensor -> the additive mask in `dtype`: -1e30 where true,
    0 elsewhere."""
    add = b.node("Where", [hidden,
                           b.const(np.asarray(-1e30, dtype=np.float32)),
                           b.const(np.asarray(0.0, dtype=np.float32))])
    return add if dtype is DType.F32 else b.cast(add, dtype)


def build_t5_decoder_step(weights: Callable[[str], np.ndarray], cfg: T5Config,
                          max_len: int, enc_len: int,
                          dtype: DType = DType.F32,
                          storage: Optional[WeightStorage] = None,
                          pad_mask: bool = False) -> bytes:
    """pad_mask=True: a `cross_mask` input (the encoder's output of that
    name) is added to every cross-attention."""
    E, H, DK, V = cfg.d_model, cfg.num_heads, cfg.d_kv, cfg.vocab_size
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(w(name))

    b = OnnxBuilder("t5_decoder_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, [])
    caches, crosses = [], []
    for i in range(cfg.num_decoder_layers):
        caches.append((b.input(f"cache_k_{i}", dtype, ["batch", H, max_len, DK]),
                       b.input(f"cache_v_{i}", dtype, ["batch", H, max_len, DK])))
        crosses.append((b.input(f"cross_k_{i}", dtype, ["batch", H, enc_len, DK]),
                        b.input(f"cross_v_{i}", dtype, ["batch", H, enc_len, DK])))
    cross_mask = (b.input("cross_mask", dtype, ["batch", 1, 1, enc_len])
                  if pad_mask else None)

    x = b.gather(b.initializer("shared", w("shared.weight")), ids)

    # decoder self-attn bias: causal mask + precomputed relative bias,
    # rows gathered by absolute query position
    bias_full = rel_bias_table(
        np.asarray(weights(
            "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")),
        max_len, max_len, False, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)          # (H, MAX, MAX)
    causal = np.where(np.tril(np.ones((max_len, max_len), bool)),
                      0.0, -1e30).astype(np.float32)
    table = b.initializer("dec_bias", (bias_full + causal[None]).astype(np_dt))

    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero, one = b.const_i64(0), b.const_i64(1)
    abs_pos = b.add(b.node("Range", [zero, s_scalar, one]),
                    b.node("Cast", [pos], to=7))
    mask = b.gather(table, abs_pos, axis=1)            # (H, S, MAX)
    mask = b.node("Unsqueeze", [mask, b.const_i64([0])])

    def rms(xx, name):
        return b.rms_norm(xx, b.initializer(name + "_g", w(name + ".weight")),
                          epsilon=cfg.layer_norm_epsilon)

    def heads(t):
        return b.transpose(b.reshape(t, [0, 0, H, DK]), [0, 2, 1, 3])

    cache_outs = []
    for i in range(cfg.num_decoder_layers):
        p = f"decoder.block.{i}."
        h = rms(x, p + "layer.0.layer_norm")
        sp = p + "layer.0.SelfAttention."
        q = b.matmul(h, b.initializer(sp + "q_T", wT(sp + "q.weight")))
        k = b.matmul(h, b.initializer(sp + "k_T", wT(sp + "k.weight")))
        v = b.matmul(h, b.initializer(sp + "v_T", wT(sp + "v.weight")))
        ck, cv = caches[i]
        nk = b.node("CacheWrite", [ck, heads(k), pos], axis=2, domain="wt",
                    outputs=[f"new_cache_k_{i}"])
        nv = b.node("CacheWrite", [cv, heads(v), pos], axis=2, domain="wt",
                    outputs=[f"new_cache_v_{i}"])
        cache_outs.append((nk, nv))
        att = b.attention(heads(q), nk, nv, mask=mask, scale=1.0)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, H * DK])
        x = b.add(x, b.matmul(att, b.initializer(sp + "o_T", wT(sp + "o.weight"))))

        h = rms(x, p + "layer.1.layer_norm")
        cp = p + "layer.1.EncDecAttention."
        q = b.matmul(h, b.initializer(cp + "q_T", wT(cp + "q.weight")))
        xk, xv = crosses[i]
        att = b.attention(heads(q), xk, xv, mask=cross_mask, scale=1.0)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, H * DK])
        x = b.add(x, b.matmul(att, b.initializer(cp + "o_T", wT(cp + "o.weight"))))

        h2 = rms(x, p + "layer.2.layer_norm")
        fp = p + "layer.2.DenseReluDense."
        if cfg.is_gated_act:
            g0 = b.matmul(h2, b.initializer(fp + "wi0_T", wT(fp + "wi_0.weight")))
            g1 = b.matmul(h2, b.initializer(fp + "wi1_T", wT(fp + "wi_1.weight")))
            hmid = b.mul(b.node("Gelu", [g0], approximate="tanh"), g1)
        else:
            hmid = b.node("Relu", [b.matmul(h2, b.initializer(
                fp + "wi_T", wT(fp + "wi.weight")))])
        x = b.add(x, b.matmul(hmid, b.initializer(fp + "wo_T", wT(fp + "wo.weight"))))

    x = rms(x, "decoder.final_layer_norm")
    if cfg.tie_word_embeddings:
        # tied head scales hidden by d_model^-0.5
        sc = b.const(np.asarray(cfg.d_model ** -0.5, dtype=np.float32))
        x = b.mul(x, b.node("CastLike", [sc, x]))
        lm = transposed(w("shared.weight"))
    else:
        lm = wT("lm_head.weight")
    b.node("MatMul", [x, b.initializer("lm_head", lm)], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", H, max_len, DK])
        b.output(nv, dtype, ["batch", H, max_len, DK])
    return b.build(storage or WeightStorage.embed())
