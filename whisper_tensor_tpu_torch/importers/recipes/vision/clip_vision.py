"""CLIP ViT vision tower import recipe (HF CLIPVisionModel layout),
with an optional LLaVA-style multimodal projector head.

Reference seam: the vision half of MultimodalLanguageInterface
(src/interfaces.rs:185-235) — images encode to LLM-embedding-space
token sequences. Emits:
  pixels (B, 3, H, W) -> last_hidden_state (B, N+1, E), pooled (B, E)
  and, when projector weights are given, embeddings (B, N, E_llm):
  hidden_states[select_layer], CLS dropped, through
  linear -> GELU -> linear (the LLaVA multi_modal_projector).

The port's copy of whisper_tensor_tpu/importers/recipes/vision/clip_vision.py,
unchanged (the same ONNX bytes). Its unmasked self-attention takes
flash_attention's unmasked mode in bf16 (D = 64).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from ..llm import transposed


@dataclass
class ClipVisionConfig:
    num_hidden_layers: int = 12
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # LLaVA: which encoder hidden state feeds the projector
    # (-2 = input of the last layer, HF hidden_states[-2])
    select_layer: int = -2

    @staticmethod
    def from_hf(cfg: dict) -> "ClipVisionConfig":
        return ClipVisionConfig(
            num_hidden_layers=cfg["num_hidden_layers"],
            hidden_size=cfg["hidden_size"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            image_size=cfg.get("image_size", 224),
            patch_size=cfg.get("patch_size", 32),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            hidden_act=cfg.get("hidden_act", "quick_gelu"))


def build_clip_vision(weights: Callable[[str], np.ndarray],
                      cfg: ClipVisionConfig,
                      dtype: DType = DType.F32,
                      projector: Optional[Callable[[str], np.ndarray]] = None,
                      storage: Optional[WeightStorage] = None) -> bytes:
    """weights(name): HF CLIPVisionModel state dict (vision_model.*).
    projector(name): LLaVA multi_modal_projector state dict
    (linear_1.weight/bias, linear_2.weight/bias) or None."""
    E, Hd, L = cfg.hidden_size, cfg.num_attention_heads, cfg.num_hidden_layers
    D = E // Hd
    P = cfg.patch_size
    G = cfg.image_size // P          # patch grid side
    N = G * G                        # patch tokens
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(w(name))

    b = OnnxBuilder("clip_vision", opset=23)
    px = b.input("pixels", dtype, ["batch", 3, cfg.image_size, cfg.image_size])

    vp = "vision_model."
    # patch embedding: conv(P-stride, no bias) -> (B, E, G, G)
    patches = b.node("Conv", [px, b.initializer(
        "patch_w", w(vp + "embeddings.patch_embedding.weight"))],
        strides=[P, P])
    flat = b.reshape(patches, [0, E, N])                    # (B, E, N)
    seq = b.transpose(flat, [0, 2, 1])                      # (B, N, E)
    # prepend CLS
    cls = b.initializer(
        "cls_emb", w(vp + "embeddings.class_embedding").reshape(1, 1, E))
    shp = b.node("Shape", [px], start=0, end=1)             # [B]
    cshape = b.node("Concat", [shp, b.const_i64([1]), b.const_i64([E])],
                    axis=0)
    cls_b = b.node("Expand", [cls, cshape])                 # (B, 1, E)
    x = b.node("Concat", [cls_b, seq], axis=1)              # (B, N+1, E)
    x = b.add(x, b.initializer(
        "pos_emb", w(vp + "embeddings.position_embedding.weight")[:N + 1]))
    # NB: HF attribute name is the (stable) typo "pre_layrnorm"
    x = b.layer_norm(x, b.initializer("preg", w(vp + "pre_layrnorm.weight")),
                     b.initializer("preb", w(vp + "pre_layrnorm.bias")),
                     epsilon=cfg.layer_norm_eps)

    def lin(xx, name):
        return b.add(b.matmul(xx, b.initializer(name + "_wT",
                                                wT(name + ".weight"))),
                     b.initializer(name + "_b", w(name + ".bias")))

    selected = None
    sel = cfg.select_layer % (L + 1)   # hidden_states index (0 = embeddings)
    for i in range(L):
        if i == sel:
            selected = x               # hidden_states[i] = input to layer i
        p = f"{vp}encoder.layers.{i}."
        h = b.layer_norm(x, b.initializer(f"ln1g_{i}",
                                          w(p + "layer_norm1.weight")),
                         b.initializer(f"ln1b_{i}",
                                       w(p + "layer_norm1.bias")),
                         epsilon=cfg.layer_norm_eps)
        q = lin(h, p + "self_attn.q_proj")
        k = lin(h, p + "self_attn.k_proj")
        v = lin(h, p + "self_attn.v_proj")

        def heads(t):
            return b.transpose(b.reshape(t, [0, 0, Hd, D]), [0, 2, 1, 3])

        att = b.attention(heads(q), heads(k), heads(v),
                          scale=1.0 / float(np.sqrt(D)))   # bidirectional
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, E])
        x = b.add(x, lin(att, p + "self_attn.out_proj"))

        h2 = b.layer_norm(x, b.initializer(f"ln2g_{i}",
                                           w(p + "layer_norm2.weight")),
                          b.initializer(f"ln2b_{i}",
                                        w(p + "layer_norm2.bias")),
                          epsilon=cfg.layer_norm_eps)
        hmid = lin(h2, p + "mlp.fc1")
        if cfg.hidden_act == "quick_gelu":
            scale = b.const(np.asarray(1.702, dtype=np.float32))
            hmid = b.mul(hmid, b.node("Sigmoid", [
                b.mul(b.node("CastLike", [scale, hmid]), hmid)]))
        else:
            hmid = b.node("Gelu", [hmid])
        x = b.add(x, lin(hmid, p + "mlp.fc2"))
    if selected is None:
        selected = x                   # select_layer == L: final output

    b.node("Identity", [x], outputs=["last_hidden_state"])
    b.output("last_hidden_state", dtype, ["batch", N + 1, E])
    cls_out = b.node("Gather", [x, b.const(np.asarray(0, dtype=np.int64))],
                     axis=1)
    pooled = b.layer_norm(cls_out,
                          b.initializer("postg",
                                        w(vp + "post_layernorm.weight")),
                          b.initializer("postb",
                                        w(vp + "post_layernorm.bias")),
                          epsilon=cfg.layer_norm_eps)
    b.node("Identity", [pooled], outputs=["pooled"])
    b.output("pooled", dtype, ["batch", E])

    if projector is not None:
        def pw(name):
            return np.asarray(projector(name)).astype(np_dt)

        # drop CLS from the selected features, then linear-GELU-linear
        feats = b.node("Slice", [selected, b.const_i64([1]),
                                 b.const_i64([N + 1]), b.const_i64([1])])
        h = b.add(b.matmul(feats, b.initializer(
            "proj1_wT", np.ascontiguousarray(pw("linear_1.weight").T))),
            b.initializer("proj1_b", pw("linear_1.bias")))
        h = b.node("Gelu", [h])
        emb = b.add(b.matmul(h, b.initializer(
            "proj2_wT", np.ascontiguousarray(pw("linear_2.weight").T))),
            b.initializer("proj2_b", pw("linear_2.bias")))
        b.node("Identity", [emb], outputs=["embeddings"])
        b.output("embeddings", dtype,
                 ["batch", N, pw("linear_2.weight").shape[0]])
    return b.build(storage or WeightStorage.embed())
