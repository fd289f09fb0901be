"""SD3 MMDiT (multimodal diffusion transformer) import recipe.

Reference equivalent: crates/whisper-tensor-import/src/models/diffusion/
sd3.rs (Sd3TransformerConfig :27, joint blocks, AdaLN modulation :104,
load_sd3_transformer :469). Weight names follow the diffusers
SD3Transformer2DModel layout so real SD3/SD3.5 safetensors load directly.

Structure per joint block: AdaLN-Zero modulation of both streams from
silu(temb), joint attention over [latent ; context] with per-head QK
RMS norm, gated residuals, GELU-tanh FFNs. The final block is
context_pre_only (context stream ends). SD3.5's dual-attention layers
add a second self-attention branch on the latent stream (9-chunk AdaLN).

The port's copy of whisper_tensor_tpu/importers/recipes/diffusion/
mmdit.py (the same ONNX bytes for the same weights and config). Its
joint attention is one unmasked Attention call a block, which the
lowering sends to flash_attention (milli/ops/attention.py, flash_mode).
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
class SD3Config:
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    sample_size: int = 128               # latent H=W
    pos_embed_max_size: int = 192
    joint_attention_dim: int = 4096      # context width before embedding
    pooled_projection_dim: int = 2048
    dual_attention_layers: Tuple[int, ...] = ()
    time_embed_dim: int = 256

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def from_hf(cfg: dict) -> "SD3Config":
        return SD3Config(
            num_layers=cfg["num_layers"],
            num_heads=cfg["num_attention_heads"],
            head_dim=cfg["attention_head_dim"],
            in_channels=cfg.get("in_channels", 16),
            out_channels=cfg.get("out_channels", 16),
            patch_size=cfg.get("patch_size", 2),
            sample_size=cfg.get("sample_size", 128),
            pos_embed_max_size=cfg.get("pos_embed_max_size", 192),
            joint_attention_dim=cfg.get("joint_attention_dim", 4096),
            pooled_projection_dim=cfg.get("pooled_projection_dim", 2048),
            dual_attention_layers=tuple(cfg.get("dual_attention_layers", ())))


def build_sd3_mmdit(weights: Callable[[str], np.ndarray], cfg: SD3Config,
                    batch: int = 2, context_len: int = 77,
                    latent_hw: Optional[Tuple[int, int]] = None,
                    dtype: DType = DType.F32,
                    storage: Optional[WeightStorage] = None) -> bytes:
    """hidden_states (B,C,H,W), timestep (B,), encoder_hidden_states
    (B,L,joint_dim), pooled_projections (B,pooled_dim) -> out (B,C,H,W)."""
    D, H_, Dh = cfg.hidden, cfg.num_heads, cfg.head_dim
    P = cfg.patch_size
    h, w = latent_hw or (cfg.sample_size, cfg.sample_size)
    ph, pw = h // P, w // P
    S = ph * pw
    B = batch
    np_dt = dtype.to_numpy()

    def wt(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(wt(name))

    b = OnnxBuilder("sd3_mmdit", opset=23)
    x = b.input("hidden_states", dtype, [B, cfg.in_channels, h, w])
    tstep = b.input("timestep", DType.F32, [B])
    ehs = b.input("encoder_hidden_states", dtype,
                  [B, context_len, cfg.joint_attention_dim])
    pooled = b.input("pooled_projections", dtype,
                     [B, cfg.pooled_projection_dim])

    def lin(xx, name, transpose=True, bias=True):
        y = b.matmul(xx, b.initializer(name + "_wT", wT(name + ".weight")))
        if bias:
            y = b.add(y, b.initializer(name + "_b", wt(name + ".bias")))
        return y

    def silu(xx):
        return b.mul(xx, b.node("Sigmoid", [xx]))

    def gelu_tanh(xx):
        return b.node("Gelu", [xx], approximate="tanh")

    def ff(xx, prefix):
        return lin(gelu_tanh(lin(xx, prefix + ".net.0.proj")),
                   prefix + ".net.2")

    ones_D = b.initializer("ones_D", np.ones(D, dtype=np_dt))

    def ln_bare(xx):
        # elementwise_affine=False LayerNorm
        return b.layer_norm(xx, ones_D, None, epsilon=1e-6)

    # ---- patch + position embedding -----------------------------------
    hpatch = b.node("Conv", [x, b.initializer("pe_w",
                                              wt("pos_embed.proj.weight")),
                             b.initializer("pe_b", wt("pos_embed.proj.bias"))],
                    strides=[P, P], kernel_shape=[P, P], pads=[0, 0, 0, 0])
    hseq = b.transpose(b.reshape(hpatch, [B, D, S]), [0, 2, 1])   # (B,S,D)
    # crop the stored pos table (pos_max, pos_max) to the centered (ph, pw)
    pos = np.asarray(weights("pos_embed.pos_embed"))
    m = cfg.pos_embed_max_size
    pos2 = pos.reshape(m, m, -1)
    top, left = (m - ph) // 2, (m - pw) // 2
    pos_crop = pos2[top:top + ph, left:left + pw].reshape(1, S, -1)
    hseq = b.add(hseq, b.initializer("pos_embed_crop",
                                     pos_crop.astype(np_dt)))

    # ---- combined timestep + pooled-text embedding --------------------
    freqs = b.initializer("t_freqs", timestep_embedding_table(
        cfg.time_embed_dim).astype(np.float32))
    ang = b.mul(b.node("Unsqueeze", [tstep, b.const_i64([1])]), freqs)
    temb = b.node("Concat", [b.node("Cos", [ang]), b.node("Sin", [ang])],
                  axis=-1)                                        # (B, 256)
    if dtype is not DType.F32:
        temb = b.cast(temb, dtype)
    temb = lin(temb, "time_text_embed.timestep_embedder.linear_1")
    temb = lin(silu(temb), "time_text_embed.timestep_embedder.linear_2")
    ptxt = lin(pooled, "time_text_embed.text_embedder.linear_1")
    ptxt = lin(silu(ptxt), "time_text_embed.text_embedder.linear_2")
    temb = b.add(temb, ptxt)                                       # (B, D)
    stemb = silu(temb)

    ctx = lin(ehs, "context_embedder")                             # (B,L,D)
    Lc = context_len

    def heads(t, S_):
        return b.transpose(b.reshape(t, [B, S_, H_, Dh]), [0, 2, 1, 3])

    def unheads(t, S_):
        return b.reshape(b.transpose(t, [0, 2, 1, 3]), [B, S_, D])

    def qk_rms(t, name):
        # per-head RMS norm over Dh with learned weight
        return b.rms_norm(t, b.initializer(name, wt(name + ".weight")),
                          epsilon=1e-6)

    def adaln_chunks(prefix, n):
        """silu(temb) @ linear -> n chunks of (B,1,D)."""
        mod = lin(stemb, prefix)                                   # (B, n*D)
        outs = []
        for i in range(n):
            c = b.slice_(mod, [i * D], [(i + 1) * D], axes=[1])
            outs.append(b.node("Unsqueeze", [c, b.const_i64([1])]))
        return outs

    def modulate(xx, shift, scale):
        return b.add(b.mul(ln_bare(xx),
                           b.add(scale, b.const(np.asarray(1.0, np_dt)))),
                     shift)

    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}."
        pre_only = (i == cfg.num_layers - 1)
        dual = i in cfg.dual_attention_layers

        n_chunks = 9 if dual else 6
        ch = adaln_chunks(p + "norm1.linear", n_chunks)
        (sh_msa, sc_msa, g_msa), rest = ch[:3], ch[3:]
        if dual:
            sh2, sc2, g2 = rest[:3]
            sh_mlp, sc_mlp, g_mlp = rest[3:]
        else:
            sh_mlp, sc_mlp, g_mlp = rest

        if pre_only:
            # AdaLayerNormContinuous on the context: LN * (1+scale) + shift
            cmod = lin(stemb, p + "norm1_context.linear")          # (B, 2D)
            c_sc = b.node("Unsqueeze", [b.slice_(cmod, [0], [D], axes=[1]),
                                        b.const_i64([1])])
            c_sh = b.node("Unsqueeze", [b.slice_(cmod, [D], [2 * D], axes=[1]),
                                        b.const_i64([1])])
            ctx_mod = modulate(ctx, c_sh, c_sc)
        else:
            csh_msa, csc_msa, cg_msa, csh_mlp, csc_mlp, cg_mlp = \
                adaln_chunks(p + "norm1_context.linear", 6)
            ctx_mod = modulate(ctx, csh_msa, csc_msa)

        hmod = modulate(hseq, sh_msa, sc_msa)

        # joint attention over [latent ; context]
        q = heads(lin(hmod, p + "attn.to_q"), S)
        k = heads(lin(hmod, p + "attn.to_k"), S)
        v = heads(lin(hmod, p + "attn.to_v"), S)
        cq = heads(lin(ctx_mod, p + "attn.add_q_proj"), Lc)
        ck = heads(lin(ctx_mod, p + "attn.add_k_proj"), Lc)
        cv = heads(lin(ctx_mod, p + "attn.add_v_proj"), Lc)
        q = qk_rms(q, p + "attn.norm_q")
        k = qk_rms(k, p + "attn.norm_k")
        cq = qk_rms(cq, p + "attn.norm_added_q")
        ck = qk_rms(ck, p + "attn.norm_added_k")
        jq = b.node("Concat", [q, cq], axis=2)
        jk = b.node("Concat", [k, ck], axis=2)
        jv = b.node("Concat", [v, cv], axis=2)
        att = b.attention(jq, jk, jv, scale=1.0 / float(np.sqrt(Dh)))
        att = unheads(att, S + Lc)
        h_att = b.slice_(att, [0], [S], axes=[1])
        c_att = b.slice_(att, [S], [S + Lc], axes=[1])
        h_att = lin(h_att, p + "attn.to_out.0")
        hseq = b.add(hseq, b.mul(g_msa, h_att))

        if dual:
            # second, latent-only self-attention branch (SD3.5)
            hmod2 = modulate(hseq, sh2, sc2)
            q2 = qk_rms(heads(lin(hmod2, p + "attn2.to_q"), S),
                        p + "attn2.norm_q")
            k2 = qk_rms(heads(lin(hmod2, p + "attn2.to_k"), S),
                        p + "attn2.norm_k")
            v2 = heads(lin(hmod2, p + "attn2.to_v"), S)
            att2 = b.attention(q2, k2, v2, scale=1.0 / float(np.sqrt(Dh)))
            att2 = lin(unheads(att2, S), p + "attn2.to_out.0")
            hseq = b.add(hseq, b.mul(g2, att2))

        hseq = b.add(hseq, b.mul(g_mlp, ff(modulate(hseq, sh_mlp, sc_mlp),
                                           p + "ff")))

        if not pre_only:
            c_att = lin(c_att, p + "attn.to_add_out")
            ctx = b.add(ctx, b.mul(cg_msa, c_att))
            ctx = b.add(ctx, b.mul(cg_mlp,
                                   ff(modulate(ctx, csh_mlp, csc_mlp),
                                      p + "ff_context")))

    # ---- final AdaLN + projection + unpatchify -------------------------
    fmod = lin(stemb, "norm_out.linear")                           # (B, 2D)
    f_sc = b.node("Unsqueeze", [b.slice_(fmod, [0], [D], axes=[1]),
                                b.const_i64([1])])
    f_sh = b.node("Unsqueeze", [b.slice_(fmod, [D], [2 * D], axes=[1]),
                                b.const_i64([1])])
    hseq = modulate(hseq, f_sh, f_sc)
    out = lin(hseq, "proj_out")           # (B, S, P*P*out_c)
    out = b.reshape(out, [B, ph, pw, P, P, cfg.out_channels])
    out = b.transpose(out, [0, 5, 1, 3, 2, 4])
    out = b.reshape(out, [B, cfg.out_channels, h, w])
    b.node("Identity", [out], outputs=["out"])
    b.output("out", dtype, [B, cfg.out_channels, h, w])
    return b.build(storage or WeightStorage.embed())


def sd3_weight_shape(cfg: SD3Config, name: str) -> tuple:
    """The shape of the weight `name` at `cfg` (the random getter's rule;
    a seeded writer at published widths asks it too)."""
    D = cfg.hidden

    def shape_of(name: str):
        if name == "pos_embed.proj.weight":
            return (D, cfg.in_channels, cfg.patch_size, cfg.patch_size)
        if name == "pos_embed.pos_embed":
            return (1, cfg.pos_embed_max_size ** 2, D)
        if name == "context_embedder.weight":
            return (D, cfg.joint_attention_dim)
        if name == "time_text_embed.timestep_embedder.linear_1.weight":
            return (D, cfg.time_embed_dim)   # table yields dim after concat
        if name == "time_text_embed.text_embedder.linear_1.weight":
            return (D, cfg.pooled_projection_dim)
        if ".norm1.linear.weight" in name:
            i = int(name.split(".")[1])
            n = 9 if i in cfg.dual_attention_layers else 6
            return (n * D, D)
        if ".norm1_context.linear.weight" in name:
            i = int(name.split(".")[1])
            n = 2 if i == cfg.num_layers - 1 else 6
            return (n * D, D)
        if name == "norm_out.linear.weight":
            return (2 * D, D)
        if name == "proj_out.weight":
            return (cfg.patch_size ** 2 * cfg.out_channels, D)
        if ".net.0.proj.weight" in name:
            return (4 * D, D)
        if ".net.2.weight" in name:
            return (D, 4 * D)
        if name.endswith(("norm_q.weight", "norm_k.weight",
                          "norm_added_q.weight", "norm_added_k.weight")):
            return (cfg.head_dim,)
        if name.endswith(".weight"):
            return (D, D)
        # biases
        base = name[:-5] + ".weight"
        return (shape_of(base)[0],)

    return shape_of(name)


def random_sd3_weights(seed: int = 0):
    """Shape-inferring random weight getter for tests (same protocol as
    unet.random_unet_weights): consults the requested name."""
    rng = np.random.default_rng(seed)
    cache = {}

    def getter_factory(cfg: SD3Config):
        def get(name: str):
            if name not in cache:
                shp = sd3_weight_shape(cfg, name)
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
