"""Whisper import recipe (HF WhisperForConditionalGeneration layout).

Reference equivalent: crates/whisper-tensor-import/src/models/speech/
whisper.rs + the STT pipeline. Two graphs:

  encoder: mel (B, n_mels, frames) -> enc (B, T, E) plus per-decoder-
           layer cross K/V (B, H, T, D) (computed once per utterance)
  decoder step: input_ids (B,S), pos (), self caches (B,H,MAX,D),
           cross_k/v_{i} -> logits + updated self caches

Same fixed-cache design as the LLM recipes.

The port's copy of whisper_tensor_tpu/importers/recipes/speech/
whisper.py (the same ONNX bytes), with the matmul weights transposed
through `transposed`. Where its Attentions go on the card
(milli/ops/attention.py): the encoder's self-attention is unmasked and
takes flash_attention's "none" mode in bf16; the decoder's prefill of
the start sequence takes the "additive" mode for its self-attention
(the causal mask against the fixed cache) and "none" for its
cross-attention; a decode step's one query row runs both on the plain
path, as the reference's do (its decode kernel takes only a position).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from ..llm import transposed


@dataclass
class WhisperConfig:
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865

    @staticmethod
    def from_hf(cfg: dict) -> "WhisperConfig":
        return WhisperConfig(
            d_model=cfg["d_model"], encoder_layers=cfg["encoder_layers"],
            decoder_layers=cfg["decoder_layers"],
            encoder_attention_heads=cfg["encoder_attention_heads"],
            decoder_attention_heads=cfg["decoder_attention_heads"],
            encoder_ffn_dim=cfg["encoder_ffn_dim"],
            decoder_ffn_dim=cfg["decoder_ffn_dim"],
            num_mel_bins=cfg["num_mel_bins"],
            max_source_positions=cfg["max_source_positions"],
            max_target_positions=cfg["max_target_positions"],
            vocab_size=cfg["vocab_size"])


def _mha(b, prefix, x_q, kv, E, H, w, wT, causal_mask=None, q_bias=True):
    """Returns attention output; kv = (k_src, v_src) tensor names."""
    D = E // H

    def lin(x, name, bias=True):
        y = b.matmul(x, b.initializer(prefix + name + "_wT", wT(prefix + name + ".weight")))
        if bias:
            y = b.add(y, b.initializer(prefix + name + "_b", w(prefix + name + ".bias")))
        return y

    q = lin(x_q, "q_proj")
    k = lin(kv, "k_proj", bias=False)
    v = lin(kv, "v_proj")

    def heads(t):
        return b.transpose(b.reshape(t, [0, 0, H, D]), [0, 2, 1, 3])

    att = b.attention(heads(q), heads(k), heads(v),
                      scale=1.0 / float(np.sqrt(D)),
                      is_causal=causal_mask is None and False)
    att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
    return b.add(b.matmul(att, b.initializer(prefix + "out_proj_wT",
                                             wT(prefix + "out_proj.weight"))),
                 b.initializer(prefix + "out_proj_b", w(prefix + "out_proj.bias")))


def build_whisper_encoder(weights: Callable[[str], np.ndarray],
                          cfg: WhisperConfig, n_frames: int = 3000,
                          dtype: DType = DType.F32,
                          storage: Optional[WeightStorage] = None) -> bytes:
    """mel -> encoder states + per-decoder-layer cross K/V."""
    E, H = cfg.d_model, cfg.encoder_attention_heads
    Hd = cfg.decoder_attention_heads
    D = E // H
    T = n_frames // 2
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(w(name))

    b = OnnxBuilder("whisper_encoder", opset=23)
    mel = b.input("mel", dtype, ["batch", cfg.num_mel_bins, n_frames])

    ep = "model.encoder."
    x = b.node("Conv", [mel, b.initializer("conv1_w", w(ep + "conv1.weight")),
                        b.initializer("conv1_b", w(ep + "conv1.bias"))],
               pads=[1, 1])
    x = b.node("Gelu", [x])
    x = b.node("Conv", [x, b.initializer("conv2_w", w(ep + "conv2.weight")),
                        b.initializer("conv2_b", w(ep + "conv2.bias"))],
               strides=[2], pads=[1, 1])
    x = b.node("Gelu", [x])
    x = b.transpose(x, [0, 2, 1])  # (B, T, E)
    x = b.add(x, b.initializer("enc_pos", w(ep + "embed_positions.weight")[:T]))

    def ln(xx, name):
        return b.layer_norm(xx, b.initializer(name + "_g", w(name + ".weight")),
                            b.initializer(name + "_b", w(name + ".bias")))

    for i in range(cfg.encoder_layers):
        p = f"{ep}layers.{i}."
        h = _mha(b, p + "self_attn.", ln(x, p + "self_attn_layer_norm"),
                 ln(x, p + "self_attn_layer_norm"), E, H, w, wT)
        # note: reuse same ln output for q and kv
        x = b.add(x, h)
        h2 = ln(x, p + "final_layer_norm")
        h2 = b.add(b.matmul(h2, b.initializer(p + "fc1_wT", wT(p + "fc1.weight"))),
                   b.initializer(p + "fc1_b", w(p + "fc1.bias")))
        h2 = b.node("Gelu", [h2])
        h2 = b.add(b.matmul(h2, b.initializer(p + "fc2_wT", wT(p + "fc2.weight"))),
                   b.initializer(p + "fc2_b", w(p + "fc2.bias")))
        x = b.add(x, h2)
    x = ln(x, ep + "layer_norm")
    b.node("Identity", [x], outputs=["encoder_states"])
    b.output("encoder_states", dtype, ["batch", T, E])

    # cross K/V per decoder layer (decoder weights applied to encoder out)
    Dd = E // Hd
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}.encoder_attn."
        k = b.matmul(x, b.initializer(p + "k_wT", wT(p + "k_proj.weight")))
        v = b.add(b.matmul(x, b.initializer(p + "v_wT", wT(p + "v_proj.weight"))),
                  b.initializer(p + "v_b", w(p + "v_proj.bias")))

        def heads(t):
            return b.transpose(b.reshape(t, [0, 0, Hd, Dd]), [0, 2, 1, 3])

        b.node("Identity", [heads(k)], outputs=[f"cross_k_{i}"])
        b.node("Identity", [heads(v)], outputs=[f"cross_v_{i}"])
        b.output(f"cross_k_{i}", dtype, ["batch", Hd, T, Dd])
        b.output(f"cross_v_{i}", dtype, ["batch", Hd, T, Dd])
    return b.build(storage or WeightStorage.embed())


def build_whisper_decoder_step(weights: Callable[[str], np.ndarray],
                               cfg: WhisperConfig, max_len: int = 448,
                               n_frames: int = 3000,
                               dtype: DType = DType.F32,
                               storage: Optional[WeightStorage] = None) -> bytes:
    E, H = cfg.d_model, cfg.decoder_attention_heads
    D = E // H
    T = n_frames // 2
    V = cfg.vocab_size
    L = cfg.decoder_layers
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(w(name))

    b = OnnxBuilder("whisper_decoder_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, [])
    caches, crosses = [], []
    for i in range(L):
        caches.append((b.input(f"cache_k_{i}", dtype, ["batch", H, max_len, D]),
                       b.input(f"cache_v_{i}", dtype, ["batch", H, max_len, D])))
        crosses.append((b.input(f"cross_k_{i}", dtype, ["batch", H, T, D]),
                        b.input(f"cross_v_{i}", dtype, ["batch", H, T, D])))

    dp = "model.decoder."
    tok = b.gather(b.initializer("tok_emb", w(dp + "embed_tokens.weight")), ids)
    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero, one = b.const_i64(0), b.const_i64(1)
    abs_pos = b.add(b.node("Range", [zero, s_scalar, one]),
                    b.node("Cast", [pos], to=7))
    x = b.add(tok, b.gather(b.initializer("dec_pos", w(dp + "embed_positions.weight")),
                            abs_pos))
    # causal mask against fixed cache
    mrange = b.node("Range", [zero, b.const_i64(max_len), one])
    vis = b.node("LessOrEqual",
                 [b.node("Unsqueeze", [mrange, b.const_i64([0])]),
                  b.node("Unsqueeze", [abs_pos, b.const_i64([1])])])
    mask = b.node("Where", [vis, b.const(np.asarray(0.0, dtype=np.float32)),
                            b.const(np.asarray(-1e30, dtype=np.float32))])
    mask = b.node("Unsqueeze", [mask, b.const_i64([0, 1])])
    if dtype is not DType.F32:
        mask = b.cast(mask, dtype)

    def ln(xx, name):
        return b.layer_norm(xx, b.initializer(name + "_g", w(name + ".weight")),
                            b.initializer(name + "_b", w(name + ".bias")))

    def heads(t):
        return b.transpose(b.reshape(t, [0, 0, H, D]), [0, 2, 1, 3])

    cache_outs = []
    for i in range(L):
        p = f"{dp}layers.{i}."
        h = ln(x, p + "self_attn_layer_norm")
        sp = p + "self_attn."
        q = b.add(b.matmul(h, b.initializer(sp + "q_wT", wT(sp + "q_proj.weight"))),
                  b.initializer(sp + "q_b", w(sp + "q_proj.bias")))
        k = b.matmul(h, b.initializer(sp + "k_wT", wT(sp + "k_proj.weight")))
        v = b.add(b.matmul(h, b.initializer(sp + "v_wT", wT(sp + "v_proj.weight"))),
                  b.initializer(sp + "v_b", w(sp + "v_proj.bias")))
        ck, cv = caches[i]
        nk = b.node("CacheWrite", [ck, heads(k), pos], axis=2, domain="wt",
                    outputs=[f"new_cache_k_{i}"])
        nv = b.node("CacheWrite", [cv, heads(v), pos], axis=2, domain="wt",
                    outputs=[f"new_cache_v_{i}"])
        cache_outs.append((nk, nv))
        att = b.attention(heads(q), nk, nv, mask=mask,
                          scale=1.0 / float(np.sqrt(D)))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
        att = b.add(b.matmul(att, b.initializer(sp + "o_wT", wT(sp + "out_proj.weight"))),
                    b.initializer(sp + "o_b", w(sp + "out_proj.bias")))
        x = b.add(x, att)

        # cross attention over precomputed encoder K/V
        h = ln(x, p + "encoder_attn_layer_norm")
        cp = p + "encoder_attn."
        q = b.add(b.matmul(h, b.initializer(cp + "q_wT", wT(cp + "q_proj.weight"))),
                  b.initializer(cp + "q_b", w(cp + "q_proj.bias")))
        xk, xv = crosses[i]
        att = b.attention(heads(q), xk, xv, scale=1.0 / float(np.sqrt(D)))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
        att = b.add(b.matmul(att, b.initializer(cp + "o_wT", wT(cp + "out_proj.weight"))),
                    b.initializer(cp + "o_b", w(cp + "out_proj.bias")))
        x = b.add(x, att)

        h = ln(x, p + "final_layer_norm")
        h = b.add(b.matmul(h, b.initializer(p + "fc1_wT", wT(p + "fc1.weight"))),
                  b.initializer(p + "fc1_b", w(p + "fc1.bias")))
        h = b.node("Gelu", [h])
        h = b.add(b.matmul(h, b.initializer(p + "fc2_wT", wT(p + "fc2.weight"))),
                  b.initializer(p + "fc2_b", w(p + "fc2.bias")))
        x = b.add(x, h)

    x = ln(x, dp + "layer_norm")
    lm = b.initializer("lm_head_T", transposed(w(dp + "embed_tokens.weight")))
    b.node("MatMul", [x, lm], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", H, max_len, D])
        b.output(nv, dtype, ["batch", H, max_len, D])
    return b.build(storage or WeightStorage.embed())
