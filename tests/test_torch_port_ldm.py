"""The single-file LDM loader of the PyTorch port against the JAX
package, on the CPU.

* importers/ldm.py: the diffusers -> LDM name maps of the UNet (SD-1.x
  and SDXL geometries), the VAE decoder and encoder give the JAX
  package's names for every weight the recipes ask for; the shape-probed
  UNet and OpenCLIP configs and the OpenCLIP getter's arrays (the fused
  q/k/v split, the transposed projection) are the JAX package's.
* The `ldm` loader: tiny SD-1.x and SDXL single files (the JAX package's
  tests/test_ldm_loader.py writes them) through both loaders and
  interfaces, 2 steps at 128 x 128: SDXL's text-to-image and SD-1.x's
  img2img within 2 of 255 per pixel and 0.05 on average of the JAX
  package's image (its per-step oracle loop); and the SD-1.x file's
  text-to-image equal, bit for bit, to the image of the same weights
  built in the diffusers layout (the check phase 18 (d) of chip_smoke.py
  makes on the card), whose parity with the JAX package
  tests/test_torch_port_diffusion.py holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_ldm_loader import (SD15_ATTN, _write_ldm_checkpoint,
                             _write_sdxl_ldm_checkpoint)
from whisper_tensor_tpu.importers import ldm as jldm
from whisper_tensor_tpu.importers.loaders import \
    identify_and_load as jax_load
from whisper_tensor_tpu.importers.recipes.diffusion.unet import \
    random_unet_weights
from whisper_tensor_tpu.importers.safetensors_io import \
    SafetensorsStore as JaxStore
from whisper_tensor_tpu.interfaces.image_gen import \
    ImageGenConfig as JaxImageGenConfig
from whisper_tensor_tpu.interfaces.image_gen import \
    image_interface_from_bundle as jax_image_iface
from whisper_tensor_tpu_torch.importers import ldm
from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
from whisper_tensor_tpu_torch.importers.recipes.diffusion import (clip, unet,
                                                                  vae)
from whisper_tensor_tpu_torch.importers.safetensors_io import \
    SafetensorsStore
from whisper_tensor_tpu_torch.interfaces.image_gen import (
    ImageGenConfig, ImageGenerationInterface, SDXLImageGenerationInterface,
    image_interface_from_bundle)
from whisper_tensor_tpu_torch.model import Model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ldm")
    sd, xl = str(d / "sd-tiny.safetensors"), str(d / "sdxl-tiny.safetensors")
    return {"sd": (sd, _write_ldm_checkpoint(sd)),
            "sdxl": (xl, _write_sdxl_ldm_checkpoint(xl))}


def _recipe_names(build, cfg, **kw):
    names = []
    base = random_unet_weights(0)

    def get(name, shape=None):
        names.append(name)
        return base(name, shape)

    build(get, cfg, **kw)
    return names


@pytest.mark.parametrize("geometry", ["sd15", "sdxl"])
def test_name_maps_give_the_jax_packages_names(geometry):
    if geometry == "sd15":
        cfg = unet.UNetConfig(block_out_channels=(8, 16, 16, 16),
                              layers_per_block=2, cross_attention_dim=12,
                              attention_head_dim=2, norm_groups=4)
    else:
        cfg = unet.UNetConfig(
            block_out_channels=(8, 16, 16), down_has_attn=(False, True, True),
            transformer_layers_per_block=(0, 1, 2), cross_attention_dim=12,
            attention_head_dim=2, norm_groups=4, layers_per_block=2,
            addition_embed=True, addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=64)
    names = _recipe_names(unet.build_sd_unet, cfg, batch=2, latent_hw=(8, 8))
    assert len(names) > 100
    for n in names:
        assert ldm.unet_diffusers_to_ldm(n, 2, cfg.down_has_attn) == \
            jldm.unet_diffusers_to_ldm(n, 2, cfg.down_has_attn), n
    vcfg = vae.VAEConfig(block_out_channels=(8, 8, 16, 16),
                         layers_per_block=1, norm_groups=4)
    for n in _recipe_names(vae.build_vae_decoder, vcfg, latent_hw=(4, 4)):
        assert ldm.vae_decoder_diffusers_to_ldm(n, 4) == \
            jldm.vae_decoder_diffusers_to_ldm(n, 4), n
    for n in _recipe_names(vae.build_vae_encoder, vcfg, image_hw=(32, 32)):
        assert ldm.vae_encoder_diffusers_to_ldm(n) == \
            jldm.vae_encoder_diffusers_to_ldm(n), n
    assert ldm.unet_diffusers_to_ldm(
        "up_blocks.2.upsamplers.0.conv.weight", 2, SD15_ATTN) == \
        "output_blocks.8.2.conv.weight"


def test_probed_configs_and_the_openclip_getter(files):
    for kind, prefix in (("sd", None), ("sdxl", "conditioner.embedders.1."
                                               "model.")):
        path = files[kind][0]
        ps, js = SafetensorsStore([path]), JaxStore([path])
        got = ldm.detect_unet_config(
            lambda k: (ldm.UNET_PREFIX + k) in ps,
            lambda k: ps.load(ldm.UNET_PREFIX + k).shape)
        want = jldm.detect_unet_config(
            lambda k: (jldm.UNET_PREFIX + k) in js,
            lambda k: js.load(jldm.UNET_PREFIX + k).shape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if prefix is None:
            continue
        pc = ldm.detect_openclip_config(ps.load, lambda k: k in ps, prefix)
        jc = jldm.detect_openclip_config(js.load, lambda k: k in js, prefix)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        pg = ldm.openclip_getter(ps.load, prefix)
        jg = jldm.openclip_getter(js.load, prefix)
        for n in ("text_model.encoder.layers.1.self_attn.k_proj.weight",
                  "text_model.encoder.layers.0.self_attn.v_proj.bias",
                  "text_model.final_layer_norm.weight",
                  "text_projection.weight"):
            a, b = np.asarray(pg(n)), np.asarray(jg(n))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n


def _close_images(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.shape == b.shape == (128, 128, 3)
    assert d.max() <= 2 and d.mean() <= 0.05, (d.max(), d.mean())
    assert a.std() > 1.0                 # not a constant image


INIT = np.random.default_rng(0).integers(0, 255, (128, 128, 3)).astype(
    np.uint8)


@pytest.mark.parametrize("kind,run", [("sd", "img2img"), ("sdxl", "txt2img")])
def test_ldm_file_gives_the_jax_packages_image(files, kind, run):
    kw = dict(dtype="f32", height=128, width=128)
    if run == "img2img":
        kw["img2img"] = "1"
    path = files[kind][0]
    jb, pb = jax_load(path, **kw), identify_and_load(path, **kw)
    assert pb.meta == jb.meta == {"architecture": f"ldm-{kind}"}
    assert {k: v for k, v in pb.interfaces["image"].items()} == \
        jb.interfaces["image"]
    jax_iface = jax_image_iface(jb, mode="oracle")
    port = image_interface_from_bundle(pb, device="cpu")
    assert type(port) is (SDXLImageGenerationInterface if kind == "sdxl"
                          else ImageGenerationInterface)
    c = dict(steps=2, height=128, width=128, seed=6)
    if run == "img2img":
        a = jax_iface.run_img2img("a tpu", INIT, strength=0.5,
                                  cfg=JaxImageGenConfig(**c)).pixels
        b = port.run_img2img("a tpu", INIT, strength=0.5,
                             cfg=ImageGenConfig(**c)).pixels
    else:
        a = jax_iface.run("a tpu", cfg=JaxImageGenConfig(**c)).pixels
        b = port.run("a tpu", cfg=ImageGenConfig(**c)).pixels
    _close_images(a, b)


def test_ldm_file_equals_its_diffusers_layout_build(files):
    """The file's image is the image of the same weights built in the
    diffusers layout, bit for bit (the name maps move no value)."""
    path, (ucfg, vcfg, base, hf) = files["sd"]
    kw = dict(dtype="f32", height=128, width=128)
    cfg = ImageGenConfig(steps=2, height=128, width=128, seed=6)
    img = image_interface_from_bundle(identify_and_load(path, **kw),
                                      device="cpu").run("a tpu", cfg=cfg)
    hsd = {k: v.float().numpy() for k, v in hf.state_dict().items()}
    te = Model.new_from_onnx(clip.build_clip_text(
        lambda n: hsd[n],
        clip.ClipTextConfig(num_hidden_layers=1, hidden_size=64,
                            num_attention_heads=1, intermediate_size=128,
                            vocab_size=100, max_position_embeddings=8),
        seq_len=8))
    un = Model.new_from_onnx(unet.build_sd_unet(
        base, unet.UNetConfig(**dataclasses.asdict(ucfg)), batch=2,
        latent_hw=(16, 16)))
    va = Model.new_from_onnx(vae.build_vae_decoder(
        lambda n, s=None: base("V" + n, s),
        vae.VAEConfig(**dataclasses.asdict(vcfg)), latent_hw=(16, 16)))
    ref = ImageGenerationInterface(te, un, va, tokenizer=None,
                                   bos_token_id=98, uncond_token_id=99,
                                   seq_len=8, device="cpu")
    np.testing.assert_array_equal(img.pixels, ref.run("a tpu",
                                                      cfg=cfg).pixels)
