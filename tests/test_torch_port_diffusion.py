"""The image slice of the PyTorch port against the JAX package, on the CPU.

* The convolution family and Resize (milli/ops/conv.py): Conv 1-D, 2-D
  and 3-D (groups, dilations, strides, explicit pads, auto_pad),
  ConvTranspose, the pools, ConvInteger, QLinearConv and Resize's modes,
  one ONNX node each, through the port's lowering and the JAX package's
  (XLA on the CPU; its oracle where XLA has no lowering) on the same
  seeded inputs. f32 within 1e-5 of the output's scale, bf16 within one
  bf16 ulp of it (2^-7: both round an f32 sum once), integers exact.
* The Attention lowering's unmasked flash route (`flash_mode`): the
  unmasked mode, the padded head dims, None where the kernel does not
  take a call, and the padded computation equal to the unpadded one.
* The diffusion recipes: the port's CLIP, UNet and VAE (decoder and
  encoder) give the JAX package's ONNX bytes for one seeded getter, and
  their graphs the JAX package's outputs, in f32 and bf16.
* The `sd` pipeline: a tiny diffusers directory (the JAX package's
  tests/test_diffusers_loader.py writes it) through both loaders and
  interfaces, 2 steps at 128 x 128: text-to-image (epsilon and
  v-prediction), img2img and inpaint give the JAX package's image (its
  per-step oracle loop) within 2 of 255 per pixel and 0.05 on average;
  `/v1/images/generations` and `cli image` on device="cpu" give the
  interface's own image. (The sdxl, sd3 and flux kinds and the ldm
  loader are held in tests/test_torch_port_dit.py and
  tests/test_torch_port_ldm.py.)

Torch runs on one thread here: the sandbox's multi-threaded CPU
convolutions are 10-50x slower than one thread's at these sizes.
"""

from __future__ import annotations

import base64
import http.client
import json
import math
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from test_diffusers_loader import _write_sd_pipeline
from whisper_tensor_tpu.importers.loaders import \
    identify_and_load as jax_load
from whisper_tensor_tpu.importers.recipes.diffusion import clip as jclip
from whisper_tensor_tpu.importers.recipes.diffusion import unet as junet
from whisper_tensor_tpu.importers.recipes.diffusion import vae as jvae
from whisper_tensor_tpu.interfaces.image_gen import \
    ImageGenConfig as JaxImageGenConfig
from whisper_tensor_tpu.interfaces.image_gen import \
    image_interface_from_bundle as jax_image_iface
from whisper_tensor_tpu.model import Model as JaxModel
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
from whisper_tensor_tpu_torch.importers.onnx_builder import OnnxBuilder
from whisper_tensor_tpu_torch.importers.recipes.diffusion import clip, unet, vae
from whisper_tensor_tpu_torch.interfaces.image_gen import (
    ImageGenConfig, ImageGenerationInterface, image_interface_from_bundle)
from whisper_tensor_tpu_torch.milli.ops.attention import (
    AttentionMilli, _flash, flash_head_dim, flash_mode)
from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
    HEAD_DIMS, flash_agreement_bound, flash_attention_plain)
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.utils.image import png_to_array, read_image
from whisper_tensor_tpu_torch.weights import carry_arrays

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the convolution family and Resize, one node each ------------------------

def _node_model(op_type, inputs, consts, attrs, out_types=None):
    """ONNX bytes of one `op_type` node: `inputs` (name -> array) are
    graph inputs, `consts` initializers; None leaves a slot empty. One
    output of x's type unless `out_types` lists them."""
    b = OnnxBuilder(op_type, opset=22)
    names = []
    for n, v in list(inputs.items()) + list(consts.items()):
        if v is None:
            names.append("")
        elif n in consts:
            names.append(b.initializer(n, np.asarray(v)))
        else:
            b.input(n, DType.from_numpy(v.dtype), list(v.shape))
            names.append(n)
    if out_types is None:
        out_types = [DType.from_numpy(inputs["x"].dtype)]
    outs = [f"y{i}" for i in range(len(out_types))]
    b.node(op_type, names, outputs=outs, **attrs)
    rank = inputs["x"].ndim
    for o, t in zip(outs, out_types):
        b.output(o, t, [f"d{i}" for i in range(rank)])
    return b.build()


def _rand(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def _conv_cases():
    r = np.random.default_rng(7)
    c = []
    # (id, op, {graph inputs}, {initializers}, attrs)
    c.append(("conv1d_groups_dil_stride_pads", "Conv",
              {"x": _rand(r, (2, 4, 11))},
              {"w": _rand(r, (6, 2, 3))},
              dict(group=2, dilations=[2], strides=[2], pads=[1, 2])))
    c.append(("conv2d_bias_asym_pads", "Conv",
              {"x": _rand(r, (1, 4, 9, 10))},
              {"w": _rand(r, (8, 4, 3, 3)), "b": _rand(r, (8,))},
              dict(strides=[2, 1], pads=[1, 0, 2, 1], dilations=[1, 2])))
    for ap in ("SAME_UPPER", "SAME_LOWER", "VALID"):
        c.append((f"conv2d_auto_pad_{ap}", "Conv",
                  {"x": _rand(r, (1, 3, 8, 7))},
                  {"w": _rand(r, (4, 3, 3, 2))},
                  dict(auto_pad=ap, strides=[2, 2])))
    c.append(("conv2d_depthwise", "Conv", {"x": _rand(r, (2, 4, 6, 6))},
              {"w": _rand(r, (4, 1, 3, 3))}, dict(group=4, pads=[1] * 4)))
    c.append(("conv3d_groups", "Conv", {"x": _rand(r, (1, 2, 5, 6, 7))},
              {"w": _rand(r, (4, 1, 2, 3, 3)), "b": _rand(r, (4,))},
              dict(group=2, pads=[1] * 6, strides=[1, 2, 1])))
    c.append(("convtranspose2d_pads_output_padding", "ConvTranspose",
              {"x": _rand(r, (1, 4, 5, 6))},
              {"w": _rand(r, (4, 3, 3, 3)), "b": _rand(r, (3,))},
              dict(strides=[2, 2], pads=[1, 0, 1, 1],
                   output_padding=[1, 1])))
    c.append(("convtranspose2d_groups_dil", "ConvTranspose",
              {"x": _rand(r, (2, 4, 4, 5))}, {"w": _rand(r, (4, 2, 2, 3))},
              dict(group=2, dilations=[2, 1], strides=[1, 3])))
    c.append(("convtranspose1d", "ConvTranspose", {"x": _rand(r, (1, 3, 7))},
              {"w": _rand(r, (3, 2, 4))}, dict(strides=[3], pads=[2, 1])))
    x = _rand(r, (2, 3, 9, 8))
    c.append(("maxpool_ceil_pads", "MaxPool", {"x": x}, {},
              dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
                   ceil_mode=1)))
    c.append(("maxpool_dilations", "MaxPool", {"x": x}, {},
              dict(kernel_shape=[2, 2], dilations=[2, 2])))
    c.append(("avgpool_count_include_pad", "AveragePool", {"x": x}, {},
              dict(kernel_shape=[3, 2], pads=[1, 1, 1, 0],
                   count_include_pad=1)))
    c.append(("avgpool_same_upper_ceil", "AveragePool", {"x": x}, {},
              dict(kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER",
                   ceil_mode=1)))
    c.append(("avgpool3d", "AveragePool",
              {"x": _rand(r, (1, 2, 5, 6, 4))}, {},
              dict(kernel_shape=[2, 3, 2], strides=[2, 1, 2])))
    c.append(("lppool_p3", "LpPool", {"x": x}, {},
              dict(kernel_shape=[2, 2], p=3, strides=[2, 2])))
    c.append(("lppool_p2", "LpPool", {"x": x}, {},
              dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])))
    c.append(("globalmaxpool", "GlobalMaxPool", {"x": x}, {}, {}))
    c.append(("globalaveragepool", "GlobalAveragePool", {"x": x}, {}, {}))
    img = _rand(r, (1, 2, 5, 6))

    def resize(name, scales=None, sizes=None, roi=None, **attrs):
        consts = {"roi": roi, "scales": scales}
        if sizes is not None:
            consts["sizes"] = np.asarray(sizes, np.int64)
        c.append((f"resize_{name}", "Resize", {"x": img}, consts, attrs))

    up = np.asarray([1, 1, 2.5, 1.5], np.float32)
    down = np.asarray([1, 1, 0.6, 0.5], np.float32)
    for nm in ("round_prefer_floor", "round_prefer_ceil", "floor", "ceil"):
        resize(f"nearest_{nm}", up, mode="nearest", nearest_mode=nm,
               coordinate_transformation_mode="half_pixel")
    resize("nearest_asymmetric_x2", np.asarray([1, 1, 2, 2], np.float32),
           mode="nearest", coordinate_transformation_mode="asymmetric",
           nearest_mode="floor")
    for cm in ("half_pixel", "align_corners", "pytorch_half_pixel",
               "half_pixel_symmetric", "asymmetric"):
        resize(f"linear_{cm}", up, mode="linear",
               coordinate_transformation_mode=cm)
    resize("cubic_exclude_outside", up, mode="cubic", exclude_outside=1,
           cubic_coeff_a=-0.5)
    resize("linear_antialias_down", down, mode="linear", antialias=1)
    resize("cubic_antialias_down", down, mode="cubic", antialias=1)
    resize("tf_crop_and_resize", None, sizes=[1, 2, 4, 5],
           roi=np.asarray([0, 0, 0.2, 0.1, 1, 1, 0.9, 1.2], np.float32),
           mode="linear", coordinate_transformation_mode="tf_crop_and_resize",
           extrapolation_value=10.0)
    resize("sizes_not_larger", None, sizes=[4, 9], axes=[2, 3],
           mode="linear", keep_aspect_ratio_policy="not_larger")
    return c


CONV_CASES = _conv_cases()


def _held_to_jax(data, feeds, jax_mode="xla"):
    got = Model.new_from_onnx(data).eval(dict(feeds), device="cpu")
    want = JaxModel.new_from_onnx(data).eval(dict(feeds), mode=jax_mode)
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        scale = max(float(np.abs(w64).max()), 1e-30)
        tol = 2.0 ** -7 if g.dtype == BF16 else 1e-5
        assert float(np.abs(g64 - w64).max()) <= tol * scale, name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: c[0])
def test_conv_family_op_matches_the_jax_lowering(case, dtype):
    _, op, inputs, consts, attrs = case
    if dtype == "bf16":
        inputs = {k: v.astype(BF16) for k, v in inputs.items()}
        consts = {k: (v.astype(BF16) if k in ("w", "b") else v)
                  for k, v in consts.items()}
    # the reference's XLA MaxPool fails on bf16 (it takes jnp.iinfo of
    # ml_dtypes' bfloat16, whose kind is "V"): its oracle referees those
    mode = "oracle" if dtype == "bf16" and "MaxPool" in op else "xla"
    _held_to_jax(_node_model(op, inputs, consts, attrs), inputs, mode)


def test_maxpool_indices_match_the_jax_oracle():
    """The Indices output (the reference's XLA path leaves it to its
    oracle): row-major and storage_order 1, ceil mode, dilations."""
    x = _rand(np.random.default_rng(3), (2, 3, 7, 8))
    for attrs in (dict(kernel_shape=[3, 3], strides=[2, 2],
                       pads=[1, 1, 1, 1], ceil_mode=1),
                  dict(kernel_shape=[2, 3], dilations=[2, 1],
                       storage_order=1)):
        _held_to_jax(_node_model("MaxPool", {"x": x}, {}, attrs,
                                 [DType.F32, DType.I64]),
                     {"x": x}, jax_mode="oracle")


def test_conv_integer_and_qlinear_conv_are_exact():
    """ConvInteger sums exactly (here past 2^24, where the reference's
    f32 graph would round), QLinearConv as the reference."""
    r = np.random.default_rng(5)
    x = r.integers(0, 256, (1, 64, 9, 9)).astype(np.uint8)
    w = r.integers(-128, 128, (4, 64, 3, 3)).astype(np.int8)
    data = _node_model("ConvInteger", {"x": x}, {
        "w": w, "xz": np.uint8(3), "wz": np.int8(-2)}, dict(pads=[1] * 4),
        [DType.I32])
    got = Model.new_from_onnx(data).eval({"x": x}, device="cpu")["y0"]
    xi = (x.astype(np.int64) - 3)
    wi = (w.astype(np.int64) + 2)
    want = torch.nn.functional.conv2d(torch.from_numpy(xi).double(),
                                      torch.from_numpy(wi).double(),
                                      padding=1).numpy().astype(np.int64)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 2 ** 24 / 64
    xq = r.integers(0, 256, (1, 3, 6, 6)).astype(np.uint8)
    wq = r.integers(0, 256, (2, 3, 3, 3)).astype(np.uint8)
    data = _node_model("QLinearConv", {"x": xq}, {
        "xs": np.float32(0.02), "xz": np.uint8(100), "w": wq,
        "ws": np.float32(0.01), "wz": np.uint8(120),
        "ys": np.float32(0.05), "yz": np.uint8(90),
        "b": r.integers(-50, 50, (2,)).astype(np.int32)}, {})
    _held_to_jax(data, {"x": xq})


# -- the unmasked flash route -------------------------------------------------

def _qkv(B, H, Sq, Skv, D, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, s, D, generator=g).to(dtype)
            for s in (Sq, Skv, Skv)]


@pytest.mark.parametrize("D,Skv,want", [
    (40, 64, "none"), (80, 64, "none"), (160, 64, "none"), (64, 64, "none"),
    (256, 64, "none"), (40, 77, "none"), (96, 77, "none"), (512, 64, None),
    (257, 64, None)])
def test_flash_mode_takes_unmasked_calls_at_padded_head_dims(D, Skv, want):
    q, k, v = _qkv(1, 2, 64, Skv, D)
    assert flash_mode(AttentionMilli(), q, k, v, None, False) == want
    if want is not None:
        assert flash_head_dim(D) in HEAD_DIMS and flash_head_dim(D) >= D


def test_flash_mode_leaves_other_unmasked_calls_to_the_plain_path():
    q, k, v = _qkv(1, 2, 64, 64, 40)
    f32 = [t.float() for t in (q, k, v)]
    assert flash_mode(AttentionMilli(), *f32, None, False) is None
    assert flash_mode(AttentionMilli(), q, k, v, None, True) is None
    assert flash_mode(AttentionMilli(softcap=5.0), q, k, v, None,
                      False) is None
    # the causal and additive modes keep the kernel's own head dims
    assert flash_mode(AttentionMilli(is_causal=True), q, k, v, None,
                      False) is None
    q1, k1, v1 = _qkv(1, 2, 1, 64, 40)
    assert flash_mode(AttentionMilli(), q1, k1, v1, None, False) is None


@pytest.mark.parametrize("D,Sq,Skv", [(40, 96, 96), (40, 70, 77),
                                      (96, 33, 65)])
def test_padded_flash_equals_the_unpadded_computation(D, Sq, Skv):
    q, k, v = _qkv(2, 3, Sq, Skv, D, seed=D)
    scale = 1.0 / math.sqrt(D)
    got = _flash("none", q.transpose(1, 2).contiguous().transpose(1, 2),
                 k, v, None, scale)
    assert got.shape == (2, 3, Sq, D)
    ref = flash_attention_plain(q, k, v, scale)
    mag = flash_attention_plain(q, k, v.abs(), scale)
    assert bool((got.float() - ref.float()).abs().le(
        flash_agreement_bound(ref, mag)).all())


# -- the recipes' graphs --------------------------------------------------------

CLIP_CFG = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
                intermediate_size=64, vocab_size=100,
                max_position_embeddings=16)
UNET_CFG = dict(block_out_channels=(8, 16), layers_per_block=1,
                cross_attention_dim=12, attention_head_dim=2, norm_groups=4,
                down_has_attn=(True, False),
                transformer_layers_per_block=(1, 1), time_embed_dim=32)
VAE_CFG = dict(block_out_channels=(8, 16), layers_per_block=1, norm_groups=4)


def _recipe_pair(name, dtype):
    """(port ONNX bytes, JAX ONNX bytes, feeds) of one recipe."""
    r = np.random.default_rng(11)
    np_dt = np.float32 if dtype == "f32" else BF16
    pd = DType.F32 if dtype == "f32" else DType.BF16
    import whisper_tensor_tpu.dtype as jd
    jdt = jd.DType[pd.name]
    if name == "clip":
        base = junet.random_unet_weights(1)
        pcfg, jcfg = clip.ClipTextConfig(**CLIP_CFG), jclip.ClipTextConfig(**CLIP_CFG)
        shapes = {}

        def get(n, shape=None):
            # CLIP's getter takes names only: shapes from the HF layout
            if n not in shapes:
                E, F = 32, 64
                if "embeddings.token" in n:
                    s = (100, E)
                elif "embeddings.position" in n:
                    s = (16, E)
                elif "fc1.weight" in n:
                    s = (F, E)
                elif "fc1.bias" in n:
                    s = (F,)
                elif "fc2.weight" in n:
                    s = (E, F)
                elif n.endswith("weight") and "proj" in n:
                    s = (E, E)
                else:
                    s = (E,)
                shapes[n] = s
            return base(n, shapes[n])

        pb = clip.build_clip_text(get, pcfg, seq_len=16, dtype=pd)
        jb = jclip.build_clip_text(get, jcfg, seq_len=16, dtype=jdt)
        ids = r.integers(0, 99, (2, 16)).astype(np.int64)
        return pb, jb, {"input_ids": ids}
    if name == "unet":
        get = junet.random_unet_weights(2)
        pb = unet.build_sd_unet(get, unet.UNetConfig(**UNET_CFG), batch=2,
                                latent_hw=(8, 8), dtype=pd)
        jb = junet.build_sd_unet(get, junet.UNetConfig(**UNET_CFG), batch=2,
                                 latent_hw=(8, 8), dtype=jdt)
        return pb, jb, {
            "sample": _rand(r, (2, 4, 8, 8), np_dt),
            "timestep": np.float32(500.0),
            "encoder_hidden_states": _rand(r, (2, 5, 12), np_dt)}
    get = junet.random_unet_weights(3)
    if name == "vae_decoder":
        pb = vae.build_vae_decoder(get, vae.VAEConfig(**VAE_CFG),
                                   latent_hw=(4, 4), dtype=pd)
        jb = jvae.build_vae_decoder(get, jvae.VAEConfig(**VAE_CFG),
                                    latent_hw=(4, 4), dtype=jdt)
        return pb, jb, {"latents": _rand(r, (1, 4, 4, 4), np_dt)}
    pb = vae.build_vae_encoder(get, vae.VAEConfig(**VAE_CFG),
                               image_hw=(16, 16), dtype=pd)
    jb = jvae.build_vae_encoder(get, jvae.VAEConfig(**VAE_CFG),
                                image_hw=(16, 16), dtype=jdt)
    return pb, jb, {"image": _rand(r, (1, 3, 16, 16), np_dt)}


# share of each output's scale the port may differ by: f32 summation
# order; bf16 rounds every op's output, and the two packages round in
# places that differ (flash's plain version rounds the unnormalized
# probabilities, XLA fuses elementwise chains), so a few ulps of 2^-8
# compound through the layers
RECIPE_TOL = {"f32": 1e-4, "bf16": 0.03}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["clip", "unet", "vae_decoder",
                                  "vae_encoder"])
def test_recipe_graph_matches_the_jax_package(name, dtype):
    pb, jb, feeds = _recipe_pair(name, dtype)
    assert pb == jb                    # the same ONNX bytes
    got = Model.new_from_onnx(pb).eval(dict(feeds), device="cpu")
    want = JaxModel.new_from_onnx(jb).eval(dict(feeds), mode="xla")
    for out, w in want.items():
        g = np.asarray(got[out]).astype(np.float64)
        w = np.asarray(w).astype(np.float64)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= RECIPE_TOL[dtype] * scale, out


def test_carry_arrays_gives_the_loaded_weights():
    """A getter's arrays on the device at the model's type equal the
    weights the recipe embedded (conv kernels keep their names)."""
    get = junet.random_unet_weights(2)
    data = unet.build_sd_unet(get, unet.UNetConfig(**UNET_CFG), batch=2,
                              latent_hw=(8, 8), dtype=DType.BF16)
    store = Model.new_from_onnx(data).graph.store
    names = ["conv_in.weight", "down_blocks.0.resnets.0.conv1.weight",
             "conv_out.bias"]
    dev = carry_arrays({n: get(n, None) for n in names}, DType.BF16,
                       torch.device("cpu"))
    for n in names:
        assert dev[n].dtype == torch.bfloat16
        want = store.get_numeric(n).numpy()
        assert dev[n].view(torch.int16).numpy().tobytes() == \
            want.view(np.int16).tobytes()


def test_the_image_path_keeps_tf32_off():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


# -- the sd pipeline --------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_dir(tmp_path_factory):
    return _write_sd_pipeline(str(tmp_path_factory.mktemp("sd")))


@pytest.fixture(scope="module")
def pipelines(sd_dir):
    """The f32 pipeline with its VAE encoder through both packages: the
    JAX package's per-step oracle loop and the port on the CPU."""
    kw = dict(dtype="f32", img2img="1", height=128, width=128)
    jax_iface = jax_image_iface(jax_load(sd_dir, **kw), mode="oracle")
    port = image_interface_from_bundle(identify_and_load(sd_dir, **kw),
                                       device="cpu")
    return jax_iface, port


def _close_images(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.shape == b.shape == (128, 128, 3)
    assert d.max() <= 2 and d.mean() <= 0.05, (d.max(), d.mean())
    assert a.std() > 1.0                 # not a constant image


INIT = np.random.default_rng(0).integers(0, 255, (128, 128, 3)).astype(
    np.uint8)
MASK = np.zeros((128, 128), np.float32)
MASK[:, 64:] = 1.0


@pytest.mark.parametrize("run", ["txt2img", "v_prediction", "img2img",
                                 "inpaint"])
def test_sd_pipeline_gives_the_jax_packages_image(pipelines, run):
    jax_iface, port = pipelines
    jc = JaxImageGenConfig(steps=2, height=128, width=128, seed=1)
    pc = ImageGenConfig(steps=2, height=128, width=128, seed=1)
    pred = "v_prediction" if run == "v_prediction" else "epsilon"
    jax_iface.prediction_type = port.prediction_type = pred
    if run in ("txt2img", "v_prediction"):
        a = jax_iface.run("a tpu", cfg=jc).pixels
        b = port.run("a tpu", cfg=pc).pixels
    elif run == "img2img":
        a = jax_iface.run_img2img("a tpu", INIT, strength=0.5, cfg=jc).pixels
        b = port.run_img2img("a tpu", INIT, strength=0.5, cfg=pc).pixels
    else:
        a = jax_iface.run_inpaint("a tpu", INIT, MASK, cfg=jc).pixels
        b = port.run_inpaint("a tpu", INIT, MASK, cfg=pc).pixels
    _close_images(a, b)


def test_loader_reads_v_prediction_and_the_bf16_pipeline_runs(sd_dir,
                                                              tmp_path):
    """The scheduler's prediction_type reaches the interface; a bf16
    pipeline (feeds cast to the graphs' types) gives the f32 one's image
    within bf16's drift."""
    d = str(tmp_path / "v")
    os.makedirs(os.path.join(d, "scheduler"))
    for sub in ("text_encoder", "unet", "vae", "model_index.json"):
        os.symlink(os.path.join(sd_dir, sub), os.path.join(d, sub))
    with open(os.path.join(d, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump({"prediction_type": "v_prediction"}, f)
    imgs = {}
    for dt in ("f32", "bf16"):
        iface = image_interface_from_bundle(identify_and_load(
            d, dtype=dt, height=128, width=128), device="cpu")
        assert iface.prediction_type == "v_prediction"
        imgs[dt] = iface.run("x", cfg=ImageGenConfig(
            steps=2, height=128, width=128, seed=4)).pixels.astype(np.int64)
    diff = np.abs(imgs["f32"] - imgs["bf16"])
    assert diff.mean() <= 2.0 and imgs["bf16"].std() > 1.0


def test_images_route_and_cli_image_on_the_cpu(sd_dir, pipelines, tmp_path):
    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    _, port = pipelines
    port.prediction_type = "epsilon"
    want = port.run("a tpu", cfg=ImageGenConfig(
        steps=2, height=128, width=128, seed=3)).pixels
    srv = Server(device="cpu")
    srv.models.run_loader("diffusers", {"path": sd_dir, "dtype": "f32",
                                        "height": 128, "width": 128})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
        c.request("POST", "/v1/images/generations", json.dumps(
            {"prompt": "a tpu", "steps": 2, "seed": 3, "n": 2}),
            {"Content-Type": "application/json"})
        r = c.getresponse()
        body = json.loads(r.read())
        assert r.status == 200, body
        imgs = [png_to_array(base64.b64decode(d["b64_json"]))
                for d in body["data"]]
        np.testing.assert_array_equal(imgs[0], want)
        assert not np.array_equal(imgs[0], imgs[1])     # seed + 1
        c.request("POST", "/v1/images/generations", json.dumps(
            {"prompt": "a tpu", "size": "256x256"}),
            {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 400 and b"loaded at 128x128" in r.read()
        c.request("POST", "/v1/audio/speech", json.dumps({"input": "x"}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 404 and b"'tts' interface" in r.read()
        c.close()
    finally:
        api.stop()
    out = str(tmp_path / "o.png")
    cli.main(["image", "--model", sd_dir, "--prompt", "a tpu", "--steps",
              "2", "--height", "128", "--width", "128", "--seed", "3",
              "--output", out, "--device", "cpu", "-c", "dtype=f32"])
    np.testing.assert_array_equal(read_image(out), want)
    mask = np.repeat((MASK * 255).astype(np.uint8)[..., None], 3, axis=2)
    from whisper_tensor_tpu_torch.utils.image import write_ppm
    write_ppm(str(tmp_path / "init.ppm"), INIT)
    write_ppm(str(tmp_path / "mask.ppm"), mask)
    inpaint = str(tmp_path / "i.ppm")
    cli.main(["image", "--model", sd_dir, "--prompt", "a tpu", "--steps",
              "2", "--height", "128", "--width", "128", "--seed", "3",
              "--output", inpaint, "--device", "cpu", "-c", "dtype=f32",
              "--init-image", str(tmp_path / "init.ppm"),
              "--mask-image", str(tmp_path / "mask.ppm")])
    np.testing.assert_array_equal(read_image(inpaint), port.run_inpaint(
        "a tpu", INIT, MASK, cfg=ImageGenConfig(
            steps=2, height=128, width=128, seed=3)).pixels)


def test_interface_refuses_img2img_without_an_encoder(sd_dir):
    iface = image_interface_from_bundle(identify_and_load(
        sd_dir, dtype="f32", height=128, width=128), device="cpu")
    assert isinstance(iface, ImageGenerationInterface)
    with pytest.raises(ValueError, match="vae_encoder"):
        iface.run_img2img("x", INIT, cfg=ImageGenConfig(
            steps=1, height=128, width=128))
