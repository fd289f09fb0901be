"""VAE decoder import recipe (diffusers AutoencoderKL decoder layout).

Reference equivalent: the shared VAE blocks in
crates/whisper-tensor-import/src/models/diffusion/. latents (B,4,h,w)
-> image tensor (B,3,8h,8w) in [-1,1].

The port's copy of whisper_tensor_tpu/importers/recipes/diffusion/vae.py
(decoder and encoder; the same ONNX bytes for the same weights and
config).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage


@dataclass
class VAEConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0            # SD3/Flux VAEs

    @staticmethod
    def from_hf(cfg: dict) -> "VAEConfig":
        """Adapter for a diffusers AutoencoderKL config.json."""
        return VAEConfig(
            latent_channels=cfg.get("latent_channels", 4),
            out_channels=cfg.get("out_channels", 3),
            block_out_channels=tuple(cfg.get("block_out_channels",
                                             (128, 256, 512, 512))),
            layers_per_block=cfg.get("layers_per_block", 2),
            norm_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.18215),
            shift_factor=cfg.get("shift_factor") or 0.0)


def build_vae_decoder(weights: Callable[[str, Tuple[int, ...]], np.ndarray],
                      cfg: VAEConfig, latent_hw: Tuple[int, int] = (64, 64),
                      dtype: DType = DType.F32,
                      storage: Optional[WeightStorage] = None) -> bytes:
    b = OnnxBuilder("vae_decoder", opset=23)
    np_dt = dtype.to_numpy()

    def init(name, shape):
        arr = np.asarray(weights(name, shape)).astype(np_dt)
        assert arr.shape == tuple(shape), (name, arr.shape, shape)
        return b.initializer(name.replace("/", "_"), arr)

    def conv(x, name, cin, cout, k=3, stride=1, pad=1):
        return b.node("Conv", [x, init(name + ".weight", (cout, cin, k, k)),
                               init(name + ".bias", (cout,))],
                      strides=[stride, stride], pads=[pad] * 4)

    def gn(x, name, c):
        return b.node("GroupNormalization",
                      [x, init(name + ".weight", (c,)), init(name + ".bias", (c,))],
                      num_groups=cfg.norm_groups, epsilon=1e-6)

    def silu(x):
        return b.mul(x, b.node("Sigmoid", [x]))

    def resnet(x, name, cin, cout):
        h = conv(silu(gn(x, name + ".norm1", cin)), name + ".conv1", cin, cout)
        h = conv(silu(gn(h, name + ".norm2", cout)), name + ".conv2", cout, cout)
        if cin != cout:
            x = conv(x, name + ".conv_shortcut", cin, cout, k=1, pad=0)
        return b.add(x, h)

    def mid_attn(x, name, c, hw):
        h = gn(x, name + ".group_norm", c)
        seq = b.transpose(b.reshape(h, [0, c, -1]), [0, 2, 1])

        def lin(xx, nm):
            wgt = np.asarray(weights(nm + ".weight", (c, c))).astype(np_dt)
            return b.add(b.matmul(xx, b.initializer(nm + "_T",
                                                    np.ascontiguousarray(wgt.T))),
                         init(nm + ".bias", (c,)))

        q = lin(seq, name + ".to_q")
        k = lin(seq, name + ".to_k")
        v = lin(seq, name + ".to_v")

        def one_head(t):
            return b.node("Unsqueeze", [t, b.const_i64([1])])

        att = b.attention(one_head(q), one_head(k), one_head(v),
                          scale=1.0 / float(np.sqrt(c)))
        att = b.node("Squeeze", [att, b.const_i64([1])])
        att = lin(att, name + ".to_out.0")
        att = b.reshape(b.transpose(att, [0, 2, 1]), [0, c, hw[0], hw[1]])
        return b.add(x, att)

    H, W = latent_hw
    z = b.input("latents", dtype, ["batch", cfg.latent_channels, H, W])
    scale = b.const(np.asarray(1.0 / cfg.scaling_factor, dtype=np.float32))
    x = b.mul(z, b.node("CastLike", [scale, z]))
    x = conv(x, "post_quant_conv", cfg.latent_channels, cfg.latent_channels,
             k=1, pad=0)
    ch = list(reversed(cfg.block_out_channels))     # decoder: 512,512,256,128
    x = conv(x, "decoder.conv_in", cfg.latent_channels, ch[0])
    hw = [H, W]
    x = resnet(x, "decoder.mid_block.resnets.0", ch[0], ch[0])
    x = mid_attn(x, "decoder.mid_block.attentions.0", ch[0], hw)
    x = resnet(x, "decoder.mid_block.resnets.1", ch[0], ch[0])
    cur = ch[0]
    for bi, cout in enumerate(ch):
        for li in range(cfg.layers_per_block + 1):
            x = resnet(x, f"decoder.up_blocks.{bi}.resnets.{li}", cur, cout)
            cur = cout
        if bi < len(ch) - 1:
            x = b.node("Resize",
                       [x, b.const(np.zeros(0, dtype=np.float32)),
                        b.const(np.asarray([1, 1, 2, 2], dtype=np.float32))],
                       mode="nearest",
                       coordinate_transformation_mode="asymmetric",
                       nearest_mode="floor")
            hw = [hw[0] * 2, hw[1] * 2]
            x = conv(x, f"decoder.up_blocks.{bi}.upsamplers.0.conv", cout, cout)
    x = conv(silu(gn(x, "decoder.conv_norm_out", ch[-1])),
             "decoder.conv_out", ch[-1], cfg.out_channels)
    b.node("Identity", [x], outputs=["image"])
    b.output("image", dtype, ["batch", cfg.out_channels, H * 8, W * 8])
    return b.build(storage or WeightStorage.embed())


def build_vae_encoder(weights: Callable[[str, Tuple[int, ...]], np.ndarray],
                      cfg: VAEConfig, image_hw: Tuple[int, int] = (512, 512),
                      in_channels: int = 3, dtype: DType = DType.F32,
                      storage: Optional[WeightStorage] = None) -> bytes:
    """image (B,C,H,W) in [-1,1] -> posterior moments (B, 2*lc, H/8, W/8)
    (mean ++ logvar along channels; the interface samples + scales).
    diffusers AutoencoderKL encoder layout — enables img2img, which the
    reference does not have."""
    b = OnnxBuilder("vae_encoder", opset=23)
    np_dt = dtype.to_numpy()

    def init(name, shape):
        arr = np.asarray(weights(name, shape)).astype(np_dt)
        assert arr.shape == tuple(shape), (name, arr.shape, shape)
        return b.initializer(name.replace("/", "_"), arr)

    def conv(x, name, cin, cout, k=3, stride=1, pads=(1, 1, 1, 1)):
        return b.node("Conv", [x, init(name + ".weight", (cout, cin, k, k)),
                               init(name + ".bias", (cout,))],
                      strides=[stride, stride], pads=list(pads))

    def gn(x, name, c):
        return b.node("GroupNormalization",
                      [x, init(name + ".weight", (c,)),
                       init(name + ".bias", (c,))],
                      num_groups=cfg.norm_groups, epsilon=1e-6)

    def silu(x):
        return b.mul(x, b.node("Sigmoid", [x]))

    def resnet(x, name, cin, cout):
        h = conv(silu(gn(x, name + ".norm1", cin)), name + ".conv1", cin, cout)
        h = conv(silu(gn(h, name + ".norm2", cout)), name + ".conv2", cout,
                 cout)
        if cin != cout:
            x = conv(x, name + ".conv_shortcut", cin, cout, k=1,
                     pads=(0, 0, 0, 0))
        return b.add(x, h)

    def mid_attn(x, name, c, hw):
        h = gn(x, name + ".group_norm", c)
        seq = b.transpose(b.reshape(h, [0, c, -1]), [0, 2, 1])

        def lin(xx, nm):
            wgt = np.asarray(weights(nm + ".weight", (c, c))).astype(np_dt)
            return b.add(b.matmul(xx, b.initializer(
                nm + "_T", np.ascontiguousarray(wgt.T))),
                init(nm + ".bias", (c,)))

        q = lin(seq, name + ".to_q")
        k = lin(seq, name + ".to_k")
        v = lin(seq, name + ".to_v")

        def one_head(t):
            return b.node("Unsqueeze", [t, b.const_i64([1])])

        att = b.attention(one_head(q), one_head(k), one_head(v),
                          scale=1.0 / float(np.sqrt(c)))
        att = b.node("Squeeze", [att, b.const_i64([1])])
        att = lin(att, name + ".to_out.0")
        att = b.reshape(b.transpose(att, [0, 2, 1]), [0, c, hw[0], hw[1]])
        return b.add(x, att)

    H, W = image_hw
    x = b.input("image", dtype, ["batch", in_channels, H, W])
    ch = list(cfg.block_out_channels)
    x = conv(x, "encoder.conv_in", in_channels, ch[0])
    cur = ch[0]
    hw = [H, W]
    for bi, cout in enumerate(ch):
        for li in range(cfg.layers_per_block):
            x = resnet(x, f"encoder.down_blocks.{bi}.resnets.{li}", cur, cout)
            cur = cout
        if bi < len(ch) - 1:
            # diffusers Downsample2D: F.pad (0,1,0,1) then stride-2 conv
            # with pad 0 -> asymmetric ONNX pads (bottom/right only)
            x = conv(x, f"encoder.down_blocks.{bi}.downsamplers.0.conv",
                     cout, cout, stride=2, pads=(0, 0, 1, 1))
            hw = [hw[0] // 2, hw[1] // 2]
    x = resnet(x, "encoder.mid_block.resnets.0", cur, cur)
    x = mid_attn(x, "encoder.mid_block.attentions.0", cur, hw)
    x = resnet(x, "encoder.mid_block.resnets.1", cur, cur)
    lc2 = 2 * cfg.latent_channels
    x = conv(silu(gn(x, "encoder.conv_norm_out", cur)),
             "encoder.conv_out", cur, lc2)
    x = conv(x, "quant_conv", lc2, lc2, k=1, pads=(0, 0, 0, 0))
    b.node("Identity", [x], outputs=["moments"])
    b.output("moments", dtype, ["batch", lc2, H // 8, W // 8])
    return b.build(storage or WeightStorage.embed())
