"""Flux (dev/schnell) transformer import recipe.

Reference equivalent: crates/whisper-tensor-import/src/models/diffusion/
flux.rs (double-stream + single-stream blocks, 3-axis rope, guidance
embedding). Weight names follow the diffusers FluxTransformer2DModel
layout so real Flux safetensors load directly.

Differences from SD3's MMDiT: text comes FIRST in the joint sequence,
q/k get 3-axis rotary position embeddings (axes_dims (16,56,56) over
(batch-id, row, col); text tokens sit at position 0 -> identity
rotation), both streams stay live through all double blocks, then the
concatenated stream runs through single blocks with a fused
attention+MLP projection. Optional guidance embedding (flux-dev).

Latents are packed 2x2 inside the graph (one reshape chain), the rope
cos/sin tables are built in f32 for the graph's latent grid and cast to
its type. The port's copy of whisper_tensor_tpu/importers/recipes/
diffusion/flux.py (the same ONNX bytes for the same weights and
config); its q/k rotation is the Rotary op (interleaved), its attention
one unmasked Attention call a block, which the lowering sends to
flash_attention (milli/ops/attention.py, flash_mode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from ..llm import transposed
from .unet import timestep_embedding_table


@dataclass
class FluxConfig:
    num_layers: int = 19                 # double-stream blocks
    num_single_layers: int = 38
    num_heads: int = 24
    head_dim: int = 128
    in_channels: int = 64                # packed (16 ch x 2x2 patch)
    joint_attention_dim: int = 4096      # T5 width
    pooled_projection_dim: int = 768     # CLIP-L pooled
    guidance_embeds: bool = True         # dev: True, schnell: False
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    time_embed_dim: int = 256

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def from_hf(cfg: dict) -> "FluxConfig":
        return FluxConfig(
            num_layers=cfg["num_layers"],
            num_single_layers=cfg["num_single_layers"],
            num_heads=cfg["num_attention_heads"],
            head_dim=cfg["attention_head_dim"],
            in_channels=cfg.get("in_channels", 64),
            joint_attention_dim=cfg.get("joint_attention_dim", 4096),
            pooled_projection_dim=cfg.get("pooled_projection_dim", 768),
            guidance_embeds=cfg.get("guidance_embeds", True),
            axes_dims_rope=tuple(cfg.get("axes_dims_rope", (16, 56, 56))))


def flux_rope_tables(cfg: FluxConfig, context_len: int,
                     grid_hw: Tuple[int, int]):
    """cos/sin (L+S, head_dim/2) for [txt ; img] — txt ids are all-zero
    (identity rotation), img ids are (0, row, col) over the packed grid."""
    gh, gw = grid_hw
    img_ids = np.zeros((gh * gw, 3), dtype=np.float64)
    img_ids[:, 1] = np.repeat(np.arange(gh), gw)
    img_ids[:, 2] = np.tile(np.arange(gw), gh)
    ids = np.concatenate([np.zeros((context_len, 3)), img_ids], axis=0)
    angs = []
    for a, d in enumerate(cfg.axes_dims_rope):
        freqs = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2,
                                                   dtype=np.float64) / d)
        angs.append(ids[:, a:a + 1] * freqs[None])
    ang = np.concatenate(angs, axis=-1)          # (L+S, head_dim/2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def build_flux(weights: Callable[[str], np.ndarray], cfg: FluxConfig,
               batch: int = 1, context_len: int = 512,
               latent_hw: Tuple[int, int] = (128, 128),
               dtype: DType = DType.F32,
               storage: Optional[WeightStorage] = None) -> bytes:
    """hidden_states (B,16,H,W), timestep (B,) in [0,1], pooled_projections
    (B,768), encoder_hidden_states (B,L,4096)[, guidance (B,)] -> out
    (B,16,H,W)."""
    D, H_, Dh = cfg.hidden, cfg.num_heads, cfg.head_dim
    h, w = latent_hw
    gh, gw = h // 2, w // 2
    S = gh * gw
    Lc = context_len
    B = batch
    C = cfg.in_channels // 4             # unpacked latent channels (16)
    np_dt = dtype.to_numpy()

    def wt(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(wt(name))

    b = OnnxBuilder("flux", opset=23)
    x = b.input("hidden_states", dtype, [B, C, h, w])
    tstep = b.input("timestep", DType.F32, [B])
    pooled = b.input("pooled_projections", dtype,
                     [B, cfg.pooled_projection_dim])
    ehs = b.input("encoder_hidden_states", dtype,
                  [B, Lc, cfg.joint_attention_dim])
    if cfg.guidance_embeds:
        guidance = b.input("guidance", DType.F32, [B])

    def lin(xx, name, bias=True):
        y = b.matmul(xx, b.initializer(name + "_wT", wT(name + ".weight")))
        if bias:
            y = b.add(y, b.initializer(name + "_b", wt(name + ".bias")))
        return y

    def silu(xx):
        return b.mul(xx, b.node("Sigmoid", [xx]))

    def gelu_tanh(xx):
        return b.node("Gelu", [xx], approximate="tanh")

    ones_D = b.initializer("ones_D", np.ones(D, dtype=np_dt))

    def ln_bare(xx):
        return b.layer_norm(xx, ones_D, None, epsilon=1e-6)

    def mlp_embed(xx, prefix):
        return lin(silu(lin(xx, prefix + ".linear_1")), prefix + ".linear_2")

    # ---- pack 2x2 latent patches: (B,C,h,w) -> (B, S, 4C) --------------
    xp = b.reshape(x, [B, C, gh, 2, gw, 2])
    xp = b.transpose(xp, [0, 2, 4, 1, 3, 5])       # (B,gh,gw,C,2,2)
    xp = b.reshape(xp, [B, S, C * 4])
    hseq = lin(xp, "x_embedder")                   # (B, S, D)

    # ---- conditioning embedding ---------------------------------------
    freqs = b.initializer("t_freqs", timestep_embedding_table(
        cfg.time_embed_dim).astype(np.float32))
    k1000 = b.const(np.asarray(1000.0, dtype=np.float32))
    ang = b.mul(b.node("Unsqueeze", [b.mul(tstep, k1000),
                                     b.const_i64([1])]), freqs)
    temb = b.node("Concat", [b.node("Cos", [ang]), b.node("Sin", [ang])],
                  axis=-1)
    if dtype is not DType.F32:
        temb = b.cast(temb, dtype)
    temb = mlp_embed(temb, "time_text_embed.timestep_embedder")
    if cfg.guidance_embeds:
        gang = b.mul(b.node("Unsqueeze", [b.mul(guidance, k1000),
                                          b.const_i64([1])]), freqs)
        gemb = b.node("Concat", [b.node("Cos", [gang]),
                                 b.node("Sin", [gang])], axis=-1)
        if dtype is not DType.F32:
            gemb = b.cast(gemb, dtype)
        temb = b.add(temb, mlp_embed(gemb,
                                     "time_text_embed.guidance_embedder"))
    temb = b.add(temb, mlp_embed(pooled, "time_text_embed.text_embedder"))
    stemb = silu(temb)

    ctx = lin(ehs, "context_embedder")             # (B, Lc, D)

    cos_np, sin_np = flux_rope_tables(cfg, Lc, (gh, gw))
    cos = b.initializer("rope_cos", cos_np)
    sin = b.initializer("rope_sin", sin_np)

    def heads(t, S_):
        return b.transpose(b.reshape(t, [B, S_, H_, Dh]), [0, 2, 1, 3])

    def unheads(t, S_):
        return b.reshape(b.transpose(t, [0, 2, 1, 3]), [B, S_, D])

    def qk_rms(t, name):
        return b.rms_norm(t, b.initializer(name, wt(name + ".weight")),
                          epsilon=1e-6)

    def chunks_of(prefix, n):
        mod = lin(stemb, prefix)
        return [b.node("Unsqueeze",
                       [b.slice_(mod, [i * D], [(i + 1) * D], axes=[1]),
                        b.const_i64([1])]) for i in range(n)]

    def modulate(xx, shift, scale):
        return b.add(b.mul(ln_bare(xx),
                           b.add(scale, b.const(np.asarray(1.0, np_dt)))),
                     shift)

    scale_attn = 1.0 / float(np.sqrt(Dh))

    # ---- double-stream blocks ------------------------------------------
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}."
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = \
            chunks_of(p + "norm1.linear", 6)
        csh_msa, csc_msa, cg_msa, csh_mlp, csc_mlp, cg_mlp = \
            chunks_of(p + "norm1_context.linear", 6)

        hmod = modulate(hseq, sh_msa, sc_msa)
        cmod = modulate(ctx, csh_msa, csc_msa)
        q = qk_rms(heads(lin(hmod, p + "attn.to_q"), S), p + "attn.norm_q")
        k = qk_rms(heads(lin(hmod, p + "attn.to_k"), S), p + "attn.norm_k")
        v = heads(lin(hmod, p + "attn.to_v"), S)
        cq = qk_rms(heads(lin(cmod, p + "attn.add_q_proj"), Lc),
                    p + "attn.norm_added_q")
        ck = qk_rms(heads(lin(cmod, p + "attn.add_k_proj"), Lc),
                    p + "attn.norm_added_k")
        cv = heads(lin(cmod, p + "attn.add_v_proj"), Lc)
        # flux order: text first
        jq = b.rotary(b.node("Concat", [cq, q], axis=2), cos, sin,
                      interleaved=True)
        jk = b.rotary(b.node("Concat", [ck, k], axis=2), cos, sin,
                      interleaved=True)
        jv = b.node("Concat", [cv, v], axis=2)
        att = unheads(b.attention(jq, jk, jv, scale=scale_attn), Lc + S)
        c_att = b.slice_(att, [0], [Lc], axes=[1])
        h_att = b.slice_(att, [Lc], [Lc + S], axes=[1])
        hseq = b.add(hseq, b.mul(g_msa, lin(h_att, p + "attn.to_out.0")))
        hseq = b.add(hseq, b.mul(g_mlp,
                                 lin(gelu_tanh(lin(
                                     modulate(hseq, sh_mlp, sc_mlp),
                                     p + "ff.net.0.proj")), p + "ff.net.2")))
        ctx = b.add(ctx, b.mul(cg_msa, lin(c_att, p + "attn.to_add_out")))
        ctx = b.add(ctx, b.mul(cg_mlp,
                               lin(gelu_tanh(lin(
                                   modulate(ctx, csh_mlp, csc_mlp),
                                   p + "ff_context.net.0.proj")),
                                   p + "ff_context.net.2")))

    # ---- single-stream blocks over [txt ; img] --------------------------
    hcat = b.node("Concat", [ctx, hseq], axis=1)    # (B, Lc+S, D)
    Sall = Lc + S
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}."
        sh, sc, g = chunks_of(p + "norm.linear", 3)
        mod = modulate(hcat, sh, sc)
        q = qk_rms(heads(lin(mod, p + "attn.to_q"), Sall), p + "attn.norm_q")
        k = qk_rms(heads(lin(mod, p + "attn.to_k"), Sall), p + "attn.norm_k")
        v = heads(lin(mod, p + "attn.to_v"), Sall)
        q = b.rotary(q, cos, sin, interleaved=True)
        k = b.rotary(k, cos, sin, interleaved=True)
        att = unheads(b.attention(q, k, v, scale=scale_attn), Sall)
        mlp = gelu_tanh(lin(mod, p + "proj_mlp"))
        fused = b.node("Concat", [att, mlp], axis=-1)   # (B, Sall, 5D)
        hcat = b.add(hcat, b.mul(g, lin(fused, p + "proj_out")))

    # ---- output head: img part only, AdaLN-continuous + unpack ---------
    img = b.slice_(hcat, [Lc], [Sall], axes=[1])
    fmod = lin(stemb, "norm_out.linear")            # (B, 2D): scale, shift
    f_sc = b.node("Unsqueeze", [b.slice_(fmod, [0], [D], axes=[1]),
                                b.const_i64([1])])
    f_sh = b.node("Unsqueeze", [b.slice_(fmod, [D], [2 * D], axes=[1]),
                                b.const_i64([1])])
    img = modulate(img, f_sh, f_sc)
    out = lin(img, "proj_out")                      # (B, S, 4C)
    out = b.reshape(out, [B, gh, gw, C, 2, 2])
    out = b.transpose(out, [0, 3, 1, 4, 2, 5])
    out = b.reshape(out, [B, C, h, w])
    b.node("Identity", [out], outputs=["out"])
    b.output("out", dtype, [B, C, h, w])
    return b.build(storage or WeightStorage.embed())


def flux_weight_shape(cfg: FluxConfig, name: str) -> tuple:
    """The shape of the weight `name` at `cfg` (the random getter's rule;
    a seeded writer at published widths asks it too)."""
    D = cfg.hidden

    def shape_of(name: str):
        if name.endswith(".bias"):
            return (shape_of(name[:-5] + ".weight")[0],)
        if name == "x_embedder.weight":
            return (D, cfg.in_channels)
        if name == "context_embedder.weight":
            return (D, cfg.joint_attention_dim)
        if "timestep_embedder.linear_1" in name or \
                "guidance_embedder.linear_1" in name:
            return (D, cfg.time_embed_dim)
        if "text_embedder.linear_1" in name:
            return (D, cfg.pooled_projection_dim)
        if ".norm1.linear.weight" in name or \
                ".norm1_context.linear.weight" in name:
            return (6 * D, D)
        if ".norm.linear.weight" in name:
            return (3 * D, D)
        if name == "norm_out.linear.weight":
            return (2 * D, D)
        if name == "proj_out.weight":
            return (cfg.in_channels, D)
        if ".proj_mlp.weight" in name:
            return (4 * D, D)
        if ".proj_out.weight" in name:       # single-block fused out
            return (D, 5 * D)
        if ".net.0.proj.weight" in name:
            return (4 * D, D)
        if ".net.2.weight" in name:
            return (D, 4 * D)
        if name.endswith(("norm_q.weight", "norm_k.weight",
                          "norm_added_q.weight", "norm_added_k.weight")):
            return (cfg.head_dim,)
        if name.endswith(".weight"):
            return (D, D)
        return (shape_of(name[:-5] + ".weight")[0],)

    return shape_of(name)


def random_flux_weights(seed: int = 0):
    """Shape-inferring random weight getter (tests)."""
    rng = np.random.default_rng(seed)
    cache = {}

    def getter_factory(cfg: FluxConfig):
        def get(name: str):
            if name not in cache:
                shp = flux_weight_shape(cfg, name)
                if name.endswith(("norm_q.weight", "norm_k.weight",
                                  "norm_added_q.weight",
                                  "norm_added_k.weight")):
                    cache[name] = np.ones(shp, dtype=np.float32) \
                        + 0.05 * rng.standard_normal(shp).astype(np.float32)
                elif name.endswith(".bias"):
                    cache[name] = (0.02 * rng.standard_normal(shp)
                                   ).astype(np.float32)
                else:
                    fan_in = shp[-1] if len(shp) > 1 else shp[0]
                    cache[name] = (rng.standard_normal(shp)
                                   / np.sqrt(fan_in)).astype(np.float32)
            return cache[name]

        return get

    return getter_factory
