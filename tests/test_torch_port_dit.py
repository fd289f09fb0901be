"""SDXL, SD3 and Flux in the PyTorch port against the JAX package, on
the CPU.

* The recipes: the port's SD3 MMDiT (with an SD3.5 dual-attention layer
  and the `pos_embed_max_size` crop), Flux transformer (3-axis
  interleaved rope), SDXL UNet (the addition embeddings), the projected
  OpenCLIP-bigG-style CLIP tower and the T5 encoder without cross
  outputs give the JAX package's ONNX bytes for one seeded getter, and
  their graphs the JAX package's outputs (XLA on the CPU): f32 within
  1e-5 of the output's scale; bf16 no further from the f32 graph than
  the JAX package's bf16 output, plus 2^-7 of the scale (the test says
  why).
* The pipelines: tiny `sdxl`, `sd3` and `flux` diffusers directories
  (the JAX package's tests/test_diffusers_loader.py writes them)
  through both loaders and interfaces, 2 steps at 128 x 128: each image
  (SDXL's img2img too) within 2 of 255 per pixel and 0.05 on average of
  the JAX package's (its per-step oracle loop); `/v1/images/generations`
  and `cli image` on device="cpu" give the SD3 interface's own
  rectified-flow image; Flux refuses img2img, as the JAX package does.

Torch runs on one thread here, as in tests/test_torch_port_diffusion.py.
"""

from __future__ import annotations

import base64
import http.client
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from test_diffusers_loader import (FLUX_CFG, MMDIT_CFG, UNET_XL,
                                   _write_flux_pipeline, _write_sd3_pipeline,
                                   _write_sd_pipeline)
from whisper_tensor_tpu.importers.loaders import \
    identify_and_load as jax_load
from whisper_tensor_tpu.importers.recipes.diffusion import clip as jclip
from whisper_tensor_tpu.importers.recipes.diffusion import flux as jflux
from whisper_tensor_tpu.importers.recipes.diffusion import mmdit as jmmdit
from whisper_tensor_tpu.importers.recipes.diffusion import unet as junet
from whisper_tensor_tpu.importers.recipes.llm import t5 as jt5
from whisper_tensor_tpu.interfaces.image_gen import \
    ImageGenConfig as JaxImageGenConfig
from whisper_tensor_tpu.interfaces.image_gen import \
    image_interface_from_bundle as jax_image_iface
from whisper_tensor_tpu.model import Model as JaxModel
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
from whisper_tensor_tpu_torch.importers.recipes.diffusion import (clip, flux,
                                                                  mmdit, unet)
from whisper_tensor_tpu_torch.importers.recipes.llm import t5
from whisper_tensor_tpu_torch.interfaces.image_gen import (
    FluxImageGenerationInterface, ImageGenConfig,
    SD3ImageGenerationInterface, SDXLImageGenerationInterface,
    image_interface_from_bundle)
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


# -- the recipes ------------------------------------------------------------

# SD3.5-style: one dual-attention layer, a position table larger than the
# latent grid (the crop)
SD35_CFG = dict(MMDIT_CFG, dual_attention_layers=[0], pos_embed_max_size=24)


def _hf_weights(model):
    return {k: v.float().numpy() for k, v in model.state_dict().items()}


def _bigg_getter():
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    torch.manual_seed(5)
    hf = CLIPTextModelWithProjection(CLIPTextConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, vocab_size=100, max_position_embeddings=16,
        projection_dim=32, hidden_act="gelu"))
    sd = _hf_weights(hf)
    return lambda name, shape=None: sd[name]


def _t5_getter():
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(6)
    hf = T5EncoderModel(T5Config(vocab_size=64, d_model=32, d_kv=8,
                                 d_ff=48, num_layers=2, num_heads=4,
                                 feed_forward_proj="gated-gelu"))
    sd = _hf_weights(hf)
    return lambda name, shape=None: sd[name]


def _recipe_pair(name, dtype):
    """(port ONNX bytes, JAX ONNX bytes, feeds) of one recipe."""
    r = np.random.default_rng(23)
    np_dt = np.float32 if dtype == "f32" else BF16
    pd = DType.F32 if dtype == "f32" else DType.BF16
    import whisper_tensor_tpu.dtype as jd
    jdt = jd.DType[pd.name]

    def rand(*shape):
        return r.standard_normal(shape).astype(np_dt)

    if name == "sd3_mmdit":
        jcfg = jmmdit.SD3Config.from_hf(SD35_CFG)
        get = jmmdit.random_sd3_weights(1)(jcfg)
        kw = dict(batch=2, context_len=9, latent_hw=(16, 16))
        pb = mmdit.build_sd3_mmdit(get, mmdit.SD3Config.from_hf(SD35_CFG),
                                   dtype=pd, **kw)
        jb = jmmdit.build_sd3_mmdit(get, jcfg, dtype=jdt, **kw)
        return pb, jb, {"hidden_states": rand(2, 4, 16, 16),
                        "timestep": np.asarray([700.0, 700.0], np.float32),
                        "encoder_hidden_states": rand(2, 9, 32),
                        "pooled_projections": rand(2, 28)}
    if name == "flux":
        jcfg = jflux.FluxConfig.from_hf(FLUX_CFG)
        get = jflux.random_flux_weights(2)(jcfg)
        kw = dict(batch=1, context_len=6, latent_hw=(16, 16))
        pb = flux.build_flux(get, flux.FluxConfig.from_hf(FLUX_CFG),
                             dtype=pd, **kw)
        jb = jflux.build_flux(get, jcfg, dtype=jdt, **kw)
        return pb, jb, {"hidden_states": rand(1, 4, 16, 16),
                        "timestep": np.asarray([0.75], np.float32),
                        "pooled_projections": rand(1, 12),
                        "encoder_hidden_states": rand(1, 6, 16),
                        "guidance": np.asarray([3.5], np.float32)}
    if name == "sdxl_unet":
        get = junet.random_unet_weights(3)
        kw = dict(batch=2, latent_hw=(8, 8))
        pb = unet.build_sd_unet(get, unet.UNetConfig.from_hf(UNET_XL),
                                dtype=pd, **kw)
        jb = junet.build_sd_unet(get, junet.UNetConfig.from_hf(UNET_XL),
                                 dtype=jdt, **kw)
        return pb, jb, {
            "sample": rand(2, 4, 8, 8), "timestep": np.float32(500.0),
            "encoder_hidden_states": rand(2, 5, 28),
            "text_embeds": rand(2, 16),
            "time_ids": np.asarray([[64, 64, 0, 0, 64, 64]] * 2,
                                   np.float32)}
    if name == "clip_bigg":
        get = _bigg_getter()
        ccfg = dict(num_hidden_layers=2, hidden_size=32,
                    num_attention_heads=2, intermediate_size=64,
                    vocab_size=100, max_position_embeddings=16,
                    projection_dim=32, hidden_act="gelu")
        pb = clip.build_clip_text(get, clip.ClipTextConfig(**ccfg),
                                  seq_len=16, dtype=pd)
        jb = jclip.build_clip_text(get, jclip.ClipTextConfig(**ccfg),
                                   seq_len=16, dtype=jdt)
        return pb, jb, {"input_ids": r.integers(0, 99, (2, 16))}
    get = _t5_getter()
    tcfg = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                num_heads=4, feed_forward_proj="gated-gelu")
    pb = t5.build_t5_encoder(get, t5.T5Config.from_hf(tcfg), seq_len=7,
                             dtype=pd, with_cross=False)
    jb = jt5.build_t5_encoder(get, jt5.T5Config.from_hf(tcfg), seq_len=7,
                              dtype=jdt, with_cross=False)
    return pb, jb, {"input_ids": r.integers(0, 63, (1, 7))}


def _f32_feeds(feeds):
    return {k: (np.asarray(v).astype(np.float32)
                if np.asarray(v).dtype == BF16 else v)
            for k, v in feeds.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["sd3_mmdit", "flux", "sdxl_unet",
                                  "clip_bigg", "t5_encoder"])
def test_recipe_graph_matches_the_jax_package(name, dtype):
    """f32: within 1e-5 of the output's scale. bf16: each op rounds its
    output, and the packages round in places that differ (XLA fuses
    elementwise chains); either package's bf16 graph lies 0.65-1.75% of
    the scale from the f32 graph on these configs, so the port's bf16
    output is held to be no further from the f32 graph on the same
    inputs than the JAX package's bf16 output, plus 2^-7 of the scale."""
    pb, jb, feeds = _recipe_pair(name, dtype)
    assert pb == jb                    # the same ONNX bytes
    got = Model.new_from_onnx(pb).eval(dict(feeds), device="cpu")
    want = JaxModel.new_from_onnx(jb).eval(dict(feeds), mode="xla")
    exact = None
    if dtype == "bf16":
        pf, jf, _ = _recipe_pair(name, "f32")
        exact = JaxModel.new_from_onnx(jf).eval(_f32_feeds(feeds),
                                                mode="xla")
    assert set(got) == set(want)
    for out, w in want.items():
        g = np.asarray(got[out]).astype(np.float64)
        w = np.asarray(w).astype(np.float64)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        if exact is None:
            assert float(np.abs(g - w).max()) <= 1e-5 * scale, out
        else:
            e = np.asarray(exact[out]).astype(np.float64)
            assert float(np.abs(g - e).max()) <= \
                float(np.abs(w - e).max()) + 2.0 ** -7 * scale, out


def test_flux_rope_tables_and_the_carried_weights():
    """The rope tables are the JAX package's; a getter's MMDiT and Flux
    arrays on the device at bf16 are the weights their recipes embed."""
    jcfg = jflux.FluxConfig.from_hf(FLUX_CFG)
    for a, b in zip(flux.flux_rope_tables(flux.FluxConfig.from_hf(FLUX_CFG),
                                          6, (8, 8)),
                    jflux.flux_rope_tables(jcfg, 6, (8, 8))):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
    for build, cfg, get, kw in (
            (flux.build_flux, flux.FluxConfig.from_hf(FLUX_CFG),
             jflux.random_flux_weights(2)(jcfg),
             dict(context_len=6, latent_hw=(16, 16))),
            (mmdit.build_sd3_mmdit, mmdit.SD3Config.from_hf(SD35_CFG),
             jmmdit.random_sd3_weights(1)(jmmdit.SD3Config.from_hf(SD35_CFG)),
             dict(context_len=9, latent_hw=(16, 16)))):
        store = Model.new_from_onnx(build(get, cfg, dtype=DType.BF16,
                                          **kw)).graph.store
        # the recipes embed a Linear's bias as <name>_b and its weight
        # transposed as <name>_wT
        arrays = {}
        for lin in ("proj_out", "context_embedder", "norm_out.linear"):
            arrays[lin + "_b"] = get(lin + ".bias")
            arrays[lin + "_wT"] = np.ascontiguousarray(get(lin + ".weight").T)
        dev = carry_arrays(arrays, DType.BF16, torch.device("cpu"))
        for n in arrays:
            want = store.get_numeric(n).numpy()
            assert dev[n].view(torch.int16).numpy().tobytes() == \
                want.view(np.int16).tobytes(), n


# -- the pipelines ------------------------------------------------------------

KW = dict(dtype="f32", height=128, width=128)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"sdxl": _write_sd_pipeline(str(tmp_path_factory.mktemp("sdxl")),
                                       xl=True),
            "sd3": _write_sd3_pipeline(str(tmp_path_factory.mktemp("sd3"))),
            "flux": _write_flux_pipeline(str(tmp_path_factory.mktemp("fx")))}


def _close_images(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.shape == b.shape == (128, 128, 3)
    assert d.max() <= 2 and d.mean() <= 0.05, (d.max(), d.mean())
    assert a.std() > 1.0                 # not a constant image


INIT = np.random.default_rng(0).integers(0, 255, (128, 128, 3)).astype(
    np.uint8)


@pytest.mark.parametrize("kind,run", [("sdxl", "txt2img"),
                                      ("sdxl", "img2img"),
                                      ("sd3", "txt2img"),
                                      ("flux", "txt2img")])
def test_pipeline_gives_the_jax_packages_image(dirs, kind, run):
    kw = dict(KW)
    if kind in ("sd3", "flux"):
        kw["t5_seq_len"] = 6
    if run == "img2img":
        kw["img2img"] = "1"
    jax_iface = jax_image_iface(jax_load(dirs[kind], **kw), mode="oracle")
    port = image_interface_from_bundle(identify_and_load(dirs[kind], **kw),
                                       device="cpu")
    cls = {"sdxl": SDXLImageGenerationInterface,
           "sd3": SD3ImageGenerationInterface,
           "flux": FluxImageGenerationInterface}[kind]
    assert type(port) is cls
    c = dict(steps=2, height=128, width=128, seed=3,
             schedule="euler" if kind == "sdxl" else "rectified_flow",
             guidance_scale=3.5 if kind == "flux" else 7.5)
    if run == "img2img":
        a = jax_iface.run_img2img("a tpu", INIT, strength=0.5,
                                  cfg=JaxImageGenConfig(**c)).pixels
        b = port.run_img2img("a tpu", INIT, strength=0.5,
                             cfg=ImageGenConfig(**c)).pixels
    else:
        a = jax_iface.run("a tpu", cfg=JaxImageGenConfig(**c)).pixels
        b = port.run("a tpu", cfg=ImageGenConfig(**c)).pixels
    _close_images(a, b)


def test_sd3_route_and_cli_image_take_rectified_flow(dirs, tmp_path):
    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    d = dirs["sd3"]
    port = image_interface_from_bundle(identify_and_load(
        d, t5_seq_len=6, **KW), device="cpu")
    want = port.run("a tpu", cfg=ImageGenConfig(
        steps=2, height=128, width=128, seed=3,
        schedule="rectified_flow")).pixels
    euler = port.run("a tpu", cfg=ImageGenConfig(
        steps=2, height=128, width=128, seed=3)).pixels
    assert not np.array_equal(want, euler)
    srv = Server(device="cpu")
    srv.models.run_loader("diffusers", {"path": d, "t5_seq_len": 6, **KW})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
        c.request("POST", "/v1/images/generations", json.dumps(
            {"prompt": "a tpu", "steps": 2, "seed": 3}),
            {"Content-Type": "application/json"})
        r = c.getresponse()
        body = json.loads(r.read())
        assert r.status == 200, body
        np.testing.assert_array_equal(
            png_to_array(base64.b64decode(body["data"][0]["b64_json"])),
            want)
        c.close()
    finally:
        api.stop()
    out = str(tmp_path / "o.png")
    cli.main(["image", "--model", d, "--prompt", "a tpu", "--steps", "2",
              "--height", "128", "--width", "128", "--seed", "3",
              "--output", out, "--device", "cpu", "-c", "dtype=f32",
              "-c", "t5_seq_len=6"])
    np.testing.assert_array_equal(read_image(out), want)


def test_flux_refuses_img2img(dirs):
    iface = image_interface_from_bundle(identify_and_load(
        dirs["flux"], t5_seq_len=6, **KW), device="cpu")
    for call in (lambda: iface.run_img2img("x", INIT),
                 lambda: iface.run_inpaint("x", INIT, INIT[..., 0] > 9)):
        with pytest.raises(NotImplementedError, match="flux"):
            call()
