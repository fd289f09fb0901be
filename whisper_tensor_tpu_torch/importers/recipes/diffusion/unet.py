"""SD-1.5-family UNet2DCondition import recipe (diffusers weight layout).

Reference equivalent: crates/whisper-tensor-import/src/models/diffusion/
{sd1_5.rs, shared UNet blocks}. Emits one ONNX graph:
  inputs : sample (B, 4, H, W), timestep (), encoder_hidden_states
           (B, T, ctx_dim)
  outputs: out (B, 4, H, W)
Weight getter signature: w(name, shape) -> np.ndarray — shape is what
the architecture requires, so random-weight generators need no shape
table and real checkpoints are verified against it.

The port's copy of whisper_tensor_tpu/importers/recipes/diffusion/unet.py
(the same ONNX bytes for the same weights and config), with
`UNetConfig.sd15()`/`sd21()` and `random_unet_weights`; `UNetConfig.sdxl()`
and the SDXL addition embeddings are copied too, though the port's loader
builds only the `sd` pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8          # heads count (int) or per-block tuple
    head_dim: Optional[int] = None       # SDXL style: fixed per-head width
    norm_groups: int = 32
    down_has_attn: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    sample_size: int = 64
    # SDXL addition embeddings (pooled text + time ids)
    addition_embed: bool = False
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    time_embed_dim: int = 1280

    def heads_for(self, c: int, block_idx: int) -> int:
        if self.head_dim:
            return max(c // self.head_dim, 1)
        if isinstance(self.attention_head_dim, (tuple, list)):
            return int(self.attention_head_dim[block_idx])
        return int(self.attention_head_dim)

    def tf_layers(self, block_idx: int) -> int:
        t = self.transformer_layers_per_block
        return int(t[block_idx]) if isinstance(t, (tuple, list)) else int(t)

    @staticmethod
    def from_hf(cfg: dict) -> "UNetConfig":
        """Adapter for a diffusers UNet2DConditionModel config.json.
        Note the upstream naming bug: `attention_head_dim` in those
        configs is actually the per-block HEAD COUNT."""
        down = tuple(cfg.get("down_block_types",
                             ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)))
        ahd = cfg.get("attention_head_dim", 8)
        boc = tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280)))
        return UNetConfig(
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            block_out_channels=boc,
            layers_per_block=cfg.get("layers_per_block", 2),
            cross_attention_dim=cfg.get("cross_attention_dim", 768),
            attention_head_dim=(tuple(ahd) if isinstance(ahd, (list, tuple))
                                else int(ahd)),
            norm_groups=cfg.get("norm_num_groups", 32),
            down_has_attn=tuple("CrossAttn" in t for t in down),
            transformer_layers_per_block=tuple(
                t if isinstance(t, int) else int(t) for t in
                (cfg["transformer_layers_per_block"]
                 if isinstance(cfg.get("transformer_layers_per_block"),
                               (list, tuple))
                 else [cfg.get("transformer_layers_per_block", 1)] * len(boc))),
            sample_size=cfg.get("sample_size", 64),
            addition_embed=cfg.get("addition_embed_type") == "text_time",
            addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
            projection_class_embeddings_input_dim=cfg.get(
                "projection_class_embeddings_input_dim", 2816),
            time_embed_dim=boc[0] * 4)

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        return UNetConfig(cross_attention_dim=1024, head_dim=64)

    @staticmethod
    def sdxl() -> "UNetConfig":
        return UNetConfig(block_out_channels=(320, 640, 1280),
                          down_has_attn=(False, True, True),
                          transformer_layers_per_block=(0, 2, 10),
                          cross_attention_dim=2048, head_dim=64,
                          addition_embed=True, time_embed_dim=1280)


def timestep_embedding_table(dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = np.exp(-np.log(max_period) * np.arange(half, dtype=np.float64) / half)
    return freqs.astype(np.float32)


class _UNetBuilder:
    def __init__(self, w: Callable[[str, Tuple[int, ...]], np.ndarray],
                 cfg: UNetConfig, dtype: DType):
        self.w = w
        self.cfg = cfg
        self.np_dt = dtype.to_numpy()
        self.dtype = dtype
        self.b = OnnxBuilder("sd_unet", opset=23)

    def init(self, name: str, shape: Tuple[int, ...]) -> str:
        arr = np.asarray(self.w(name, shape)).astype(self.np_dt)
        assert arr.shape == tuple(shape), (name, arr.shape, shape)
        return self.b.initializer(name.replace("/", "_"), arr)

    # -- primitives -----------------------------------------------------
    def conv(self, x, name, cin, cout, k=3, stride=1, pad=1):
        b = self.b
        wgt = self.init(name + ".weight", (cout, cin, k, k))
        bias = self.init(name + ".bias", (cout,))
        return b.node("Conv", [x, wgt, bias], strides=[stride, stride],
                      pads=[pad, pad, pad, pad])

    def linear(self, x, name, cin, cout, transpose=True):
        b = self.b
        wgt = np.asarray(self.w(name + ".weight", (cout, cin))).astype(self.np_dt)
        wi = b.initializer(name.replace("/", "_") + ".weight_T",
                           np.ascontiguousarray(wgt.T))
        bias = self.init(name + ".bias", (cout,))
        return b.add(b.matmul(x, wi), bias)

    def group_norm(self, x, name, c):
        b = self.b
        g = self.init(name + ".weight", (c,))
        bi = self.init(name + ".bias", (c,))
        return b.node("GroupNormalization", [x, g, bi],
                      num_groups=self.cfg.norm_groups, epsilon=1e-5)

    def silu(self, x):
        b = self.b
        return b.mul(x, b.node("Sigmoid", [x]))

    # -- blocks ------------------------------------------------------------
    def resnet(self, x, temb, name, cin, cout):
        b = self.b
        h = self.group_norm(x, name + ".norm1", cin)
        h = self.conv(self.silu(h), name + ".conv1", cin, cout)
        t = self.linear(self.silu(temb), name + ".time_emb_proj",
                        self.cfg.time_embed_dim, cout)
        # temb (B, cout) -> (B, cout, 1, 1)
        t = b.reshape(t, [0, cout, 1, 1])
        h = b.add(h, t)
        h = self.group_norm(h, name + ".norm2", cout)
        h = self.conv(self.silu(h), name + ".conv2", cout, cout)
        if cin != cout:
            x = self.conv(x, name + ".conv_shortcut", cin, cout, k=1, pad=0)
        return b.add(x, h)

    def _attn(self, x_seq, ctx_seq, name, c, ctx_dim, heads):
        """x_seq (B, N, c); ctx_seq (B, T, ctx_dim) or None for self-attn."""
        b = self.b
        d = c // heads
        kv_src = ctx_seq if ctx_seq is not None else x_seq
        kv_dim = ctx_dim if ctx_seq is not None else c
        q = self._proj_nobias(x_seq, name + ".to_q", c, c)
        k = self._proj_nobias(kv_src, name + ".to_k", kv_dim, c)
        v = self._proj_nobias(kv_src, name + ".to_v", kv_dim, c)

        def heads_split(t):
            t = b.reshape(t, [0, 0, heads, d])
            return b.transpose(t, [0, 2, 1, 3])

        att = b.attention(heads_split(q), heads_split(k), heads_split(v),
                          scale=1.0 / float(np.sqrt(d)))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, c])
        return self.linear(att, name + ".to_out.0", c, c)

    def _proj_nobias(self, x, name, cin, cout):
        b = self.b
        wgt = np.asarray(self.w(name + ".weight", (cout, cin))).astype(self.np_dt)
        wi = b.initializer(name.replace("/", "_") + ".weight_T",
                           np.ascontiguousarray(wgt.T))
        return b.matmul(x, wi)

    def layer_norm(self, x, name, c):
        b = self.b
        g = self.init(name + ".weight", (c,))
        bi = self.init(name + ".bias", (c,))
        return b.layer_norm(x, g, bi, epsilon=1e-5)

    def transformer_block(self, x_seq, ctx, name, c, heads):
        b = self.b
        cfg = self.cfg
        h = self._attn(self.layer_norm(x_seq, name + ".norm1", c), None,
                       name + ".attn1", c, c, heads)
        x_seq = b.add(x_seq, h)
        h = self._attn(self.layer_norm(x_seq, name + ".norm2", c), ctx,
                       name + ".attn2", c, cfg.cross_attention_dim, heads)
        x_seq = b.add(x_seq, h)
        h = self.layer_norm(x_seq, name + ".norm3", c)
        # GEGLU: proj to 8c, split, gelu gate
        proj = self.linear(h, name + ".ff.net.0.proj", c, 8 * c)
        a, gate = b.node("Split", [proj], n_outputs=2, axis=-1, num_outputs=2)
        h = b.mul(a, b.node("Gelu", [gate]))
        h = self.linear(h, name + ".ff.net.2", 4 * c, c)
        return b.add(x_seq, h)

    def spatial_transformer(self, x, ctx, name, c, hw, heads, n_blocks=1):
        """Transformer2DModel: GN -> 1x1 conv proj_in -> blocks -> proj_out."""
        b = self.b
        resid = x
        h = self.group_norm(x, name + ".norm", c)
        h = self.conv(h, name + ".proj_in", c, c, k=1, pad=0)
        # (B, c, H, W) -> (B, HW, c)
        h = b.transpose(b.reshape(h, [0, c, -1]), [0, 2, 1])
        for j in range(n_blocks):
            h = self.transformer_block(h, ctx,
                                       name + f".transformer_blocks.{j}",
                                       c, heads)
        h = b.reshape(b.transpose(h, [0, 2, 1]), [0, c, hw[0], hw[1]])
        h = self.conv(h, name + ".proj_out", c, c, k=1, pad=0)
        return b.add(h, resid)


def build_sd_unet(weights: Callable[[str, Tuple[int, ...]], np.ndarray],
                  cfg: UNetConfig, batch: Optional[int] = None,
                  latent_hw: Tuple[int, int] = (64, 64),
                  dtype: DType = DType.F32,
                  storage: Optional[WeightStorage] = None) -> bytes:
    ub = _UNetBuilder(weights, cfg, dtype)
    b = ub.b
    H, W = latent_hw
    ch = cfg.block_out_channels
    B = batch if batch is not None else "batch"

    sample = b.input("sample", dtype, [B, cfg.in_channels, H, W])
    tstep = b.input("timestep", DType.F32, [])
    ctx = b.input("encoder_hidden_states", dtype,
                  [B, "tokens", cfg.cross_attention_dim])

    # time embedding: sinusoidal(ch0) -> linear -> silu -> linear
    TED = cfg.time_embed_dim
    freqs = b.initializer("time_freqs", timestep_embedding_table(ch[0]).astype(np.float32))
    targ = b.mul(b.node("Unsqueeze", [tstep, b.const_i64([0])]), freqs)
    emb = b.node("Concat", [b.node("Cos", [targ]), b.node("Sin", [targ])], axis=-1)
    emb = b.node("Unsqueeze", [emb, b.const_i64([0])])  # (1, ch0)
    if dtype is not DType.F32:
        emb = b.cast(emb, dtype)
    temb = ub.linear(emb, "time_embedding.linear_1", ch[0], TED)
    temb = ub.linear(ub.silu(temb), "time_embedding.linear_2", TED, TED)
    if cfg.addition_embed:
        # SDXL: pooled text embeds (B, Ctx_pooled) + time_ids (B, 6)
        pooled_dim = (cfg.projection_class_embeddings_input_dim
                      - 6 * cfg.addition_time_embed_dim)
        text_embeds = b.input("text_embeds", dtype, [B, pooled_dim])
        time_ids = b.input("time_ids", DType.F32, [B, 6])
        afreqs = b.initializer(
            "add_time_freqs",
            timestep_embedding_table(cfg.addition_time_embed_dim).astype(np.float32))
        tia = b.node("Unsqueeze", [time_ids, b.const_i64([2])])   # (B,6,1)
        ang = b.mul(tia, afreqs)                                   # (B,6,half)
        sins = b.node("Concat", [b.node("Cos", [ang]), b.node("Sin", [ang])],
                      axis=-1)                                     # (B,6,dim)
        sins = b.reshape(sins, [0, 6 * cfg.addition_time_embed_dim])
        if dtype is not DType.F32:
            sins = b.cast(sins, dtype)
        add_in = b.node("Concat", [text_embeds, sins], axis=-1)
        aemb = ub.linear(add_in, "add_embedding.linear_1",
                         cfg.projection_class_embeddings_input_dim, TED)
        aemb = ub.linear(ub.silu(aemb), "add_embedding.linear_2", TED, TED)
        temb = b.add(temb, aemb)

    x = ub.conv(sample, "conv_in", cfg.in_channels, ch[0])

    skips = [(x, ch[0])]
    hw = [H, W]
    # down blocks
    for bi, cout in enumerate(ch):
        cin = ch[bi - 1] if bi > 0 else ch[0]
        for li in range(cfg.layers_per_block):
            name = f"down_blocks.{bi}.resnets.{li}"
            x = ub.resnet(x, temb, name, cin if li == 0 else cout, cout)
            if cfg.down_has_attn[bi]:
                x = ub.spatial_transformer(
                    x, ctx, f"down_blocks.{bi}.attentions.{li}", cout, hw,
                    cfg.heads_for(cout, bi), cfg.tf_layers(bi))
            skips.append((x, cout))
        if bi < len(ch) - 1:
            x = ub.conv(x, f"down_blocks.{bi}.downsamplers.0.conv",
                        cout, cout, k=3, stride=2, pad=1)
            hw = [hw[0] // 2, hw[1] // 2]
            skips.append((x, cout))

    # mid
    x = ub.resnet(x, temb, "mid_block.resnets.0", ch[-1], ch[-1])
    x = ub.spatial_transformer(x, ctx, "mid_block.attentions.0", ch[-1], hw,
                               cfg.heads_for(ch[-1], len(ch) - 1),
                               max(cfg.tf_layers(len(ch) - 1), 1))
    x = ub.resnet(x, temb, "mid_block.resnets.1", ch[-1], ch[-1])

    # up blocks (reverse channels, layers_per_block+1 resnets, skip concats)
    rev = list(reversed(ch))
    cur_c = ch[-1]
    for bi, cout in enumerate(rev):
        for li in range(cfg.layers_per_block + 1):
            skip, skip_c = skips.pop()
            x = b.node("Concat", [x, skip], axis=1)
            name = f"up_blocks.{bi}.resnets.{li}"
            x = ub.resnet(x, temb, name, cur_c + skip_c, cout)
            cur_c = cout
            down_bi = len(ch) - 1 - bi
            if cfg.down_has_attn[down_bi]:
                x = ub.spatial_transformer(
                    x, ctx, f"up_blocks.{bi}.attentions.{li}", cout, hw,
                    cfg.heads_for(cout, down_bi), cfg.tf_layers(down_bi))
        if bi < len(rev) - 1:
            # upsample: nearest x2 + conv
            x = b.node("Resize",
                       [x, b.const(np.zeros(0, dtype=np.float32)),
                        b.const(np.asarray([1, 1, 2, 2], dtype=np.float32))],
                       mode="nearest",
                       coordinate_transformation_mode="asymmetric",
                       nearest_mode="floor")
            hw = [hw[0] * 2, hw[1] * 2]
            x = ub.conv(x, f"up_blocks.{bi}.upsamplers.0.conv", cout, cout)

    x = ub.group_norm(x, "conv_norm_out", ch[0])
    x = ub.conv(ub.silu(x), "conv_out", ch[0], cfg.out_channels)
    b.node("Identity", [x], outputs=["out"])
    b.output("out", dtype, [B, cfg.out_channels, H, W])
    return b.build(storage or WeightStorage.embed())


def random_unet_weights(seed: int = 0) -> Callable:
    rng = np.random.default_rng(seed)
    cache = {}

    def get(name: str, shape: Tuple[int, ...]) -> np.ndarray:
        if name not in cache:
            if name.endswith("norm1.weight") or name.endswith("norm2.weight") \
                    or name.endswith("norm.weight") or name.endswith(".bias") \
                    or "norm" in name and name.endswith("weight"):
                base = (np.ones(shape) if name.endswith("weight")
                        else np.zeros(shape))
                cache[name] = base.astype(np.float32)
            else:
                fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
                std = 1.0 / np.sqrt(max(fan_in, 1))
                cache[name] = (rng.standard_normal(shape) * std).astype(np.float32)
        return cache[name]

    return get
