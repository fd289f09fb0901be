"""CLIP text encoder import recipe (HF CLIPTextModel layout).

Reference equivalent: crates/whisper-tensor-import/src/models/diffusion/
clip.rs (SD text encoders). Emits: input_ids (B, T) -> last_hidden_state
(B, T, E) and pooled (B, E) via the EOS-token position.

The port's copy of whisper_tensor_tpu/importers/recipes/diffusion/clip.py
(the same ONNX bytes for the same weights and config).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage


@dataclass
class ClipTextConfig:
    num_hidden_layers: int = 12
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"   # sd1.5; sd2/sdxl use gelu
    projection_dim: Optional[int] = None   # SDXL: pooled @ text_projection
    # pooled position: first `eos_token_id` occurrence when set, else the
    # highest-id token (HF legacy eos_token_id==2 behavior; equivalent for
    # real prompts where EOS is the max vocab id).
    eos_token_id: Optional[int] = None

    @staticmethod
    def from_hf(cfg: dict) -> "ClipTextConfig":
        return ClipTextConfig(
            num_hidden_layers=cfg["num_hidden_layers"],
            hidden_size=cfg["hidden_size"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            vocab_size=cfg["vocab_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 77),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            hidden_act=cfg.get("hidden_act", "quick_gelu"),
            projection_dim=cfg.get("projection_dim"),
            eos_token_id=(None if cfg.get("eos_token_id", 2) == 2
                          else cfg["eos_token_id"]))


def build_clip_text(weights: Callable[[str], np.ndarray], cfg: ClipTextConfig,
                    seq_len: int = 77, dtype: DType = DType.F32,
                    storage: Optional[WeightStorage] = None) -> bytes:
    E, Hd, L = cfg.hidden_size, cfg.num_attention_heads, cfg.num_hidden_layers
    D = E // Hd
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return np.ascontiguousarray(w(name).T)

    b = OnnxBuilder("clip_text", opset=23)
    ids = b.input("input_ids", DType.I64, ["batch", seq_len])

    tp = "text_model."
    tok = b.gather(b.initializer("tok_emb",
                                 w(tp + "embeddings.token_embedding.weight")), ids)
    pos = b.initializer("pos_emb",
                        w(tp + "embeddings.position_embedding.weight")[:seq_len])
    x = b.add(tok, pos)

    def lin(xx, name, cin, cout):
        return b.add(b.matmul(xx, b.initializer(name + "_wT", wT(name + ".weight"))),
                     b.initializer(name + "_b", w(name + ".bias")))

    penultimate = None
    for i in range(L):
        if i == L - 1:
            # HF hidden_states[-2]: input to the last encoder layer, no
            # final LN — the SDXL pipeline conditions the UNet on this.
            penultimate = x
        p = f"{tp}encoder.layers.{i}."
        h = b.layer_norm(x, b.initializer(f"ln1g_{i}", w(p + "layer_norm1.weight")),
                         b.initializer(f"ln1b_{i}", w(p + "layer_norm1.bias")),
                         epsilon=cfg.layer_norm_eps)
        q = lin(h, p + "self_attn.q_proj", E, E)
        k = lin(h, p + "self_attn.k_proj", E, E)
        v = lin(h, p + "self_attn.v_proj", E, E)

        def heads(t):
            return b.transpose(b.reshape(t, [0, 0, Hd, D]), [0, 2, 1, 3])

        att = b.attention(heads(q), heads(k), heads(v),
                          scale=1.0 / float(np.sqrt(D)), is_causal=True)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
        x = b.add(x, lin(att, p + "self_attn.out_proj", E, E))

        h2 = b.layer_norm(x, b.initializer(f"ln2g_{i}", w(p + "layer_norm2.weight")),
                          b.initializer(f"ln2b_{i}", w(p + "layer_norm2.bias")),
                          epsilon=cfg.layer_norm_eps)
        hmid = lin(h2, p + "mlp.fc1", E, cfg.intermediate_size)
        if cfg.hidden_act == "quick_gelu":
            scale = b.const(np.asarray(1.702, dtype=np.float32))
            hmid = b.mul(hmid, b.node("Sigmoid", [
                b.mul(b.node("CastLike", [scale, hmid]), hmid)]))
        else:
            hmid = b.node("Gelu", [hmid])
        x = b.add(x, lin(hmid, p + "mlp.fc2", cfg.intermediate_size, E))

    x = b.layer_norm(x, b.initializer("lnfg", w(tp + "final_layer_norm.weight")),
                     b.initializer("lnfb", w(tp + "final_layer_norm.bias")),
                     epsilon=cfg.layer_norm_eps)
    b.node("Identity", [x], outputs=["last_hidden_state"])
    b.output("last_hidden_state", dtype, ["batch", seq_len, E])
    # pooled: hidden state at the EOS token position
    if cfg.eos_token_id is not None:
        is_eos = b.node("Cast", [b.node("Equal", [
            ids, b.const(np.asarray(cfg.eos_token_id, dtype=np.int64))])],
            to=6)  # i32; ArgMax picks the FIRST max -> first EOS
        eos_pos = b.node("ArgMax", [is_eos], axis=1, keepdims=0)    # (B,)
    else:
        eos_pos = b.node("ArgMax", [ids], axis=1, keepdims=0)       # (B,)
    pooled = b.node("GatherElements",
                    [x, b.node("Expand",
                               [b.node("Unsqueeze",
                                       [b.node("Unsqueeze", [eos_pos,
                                                             b.const_i64([1])]),
                                        b.const_i64([2])]),
                                b.const_i64([1, 1, E])])], axis=1)
    pooled = b.node("Squeeze", [pooled, b.const_i64([1])])
    b.node("Identity", [pooled], outputs=["pooled"])
    b.output("pooled", dtype, ["batch", E])
    b.node("Identity", [penultimate], outputs=["penultimate_hidden_state"])
    b.output("penultimate_hidden_state", dtype, ["batch", seq_len, E])
    if cfg.projection_dim:
        te = b.matmul(pooled,
                      b.initializer("text_proj_wT", wT("text_projection.weight")))
        b.node("Identity", [te], outputs=["text_embeds"])
        b.output("text_embeds", dtype, ["batch", cfg.projection_dim])
    return b.build(storage or WeightStorage.embed())
