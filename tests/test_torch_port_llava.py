"""LLaVA on the port: the CLIP vision tower with its projector, graph
surgery's inputs_embeds entry, the multimodal interface and its server
routes, against the JAX package, on the CPU.

A tiny LlavaForConditionalGeneration (seeded torch init; the JAX
package's tests/test_multimodal.py sizes: a CLIP tower of 2 layers,
hidden 32, 2 heads, 16 x 16 images in 8 x 8 patches, quick_gelu,
vision_feature_layer -2; a llama text model of 2 layers, hidden 128, 2
heads of 64, FFN 256 and a vocabulary of 512: large enough for the
int8 pass to quantize the fused gate/up and the head, and for the byte
tokenizer's ids),
written in the classic layout (language_model.model.*, vision_tower.*)
and in the transformers 4.52+ one (model.language_model.*, lm_head.*).

* The port's CLIP recipe writes the JAX recipe's ONNX bytes (with the
  projector, f32 and bf16), and its tower's embeddings equal the JAX
  package's (oracle) within 1e-4 of the largest |value|.
* Both packages' loaders read both layouts to the same specs; fused
  image and text embeddings (`embed_items`) equal, and
  `generate_from_embeds` and `run_items_in_string_out` give the same
  tokens at f32.
* int8 in bf16: the inputs_embeds prefill of token embeddings gives the
  token prefill's logits bit for bit and takes the same attention
  routes (flash_attention's pos-bound mode at head dim 64).
* `resize_bilinear` equals the JAX package's.
* Serving: WebSocket generate_multimodal and /v1/chat/completions with
  an image data URL answer the JAX package's server's text; a non-data
  URL is refused with a 400.
"""

import base64
import http.client
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.recipes.vision import (  # noqa: E402
    clip_vision as jax_clip)
from whisper_tensor_tpu.interfaces.multimodal import (  # noqa: E402
    MultimodalLanguageInterface as JaxMM)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxText)
from whisper_tensor_tpu.server.main import Server as JaxServer  # noqa: E402
from whisper_tensor_tpu.server.openai_api import (  # noqa: E402
    OpenAIApi as JaxApi)
from whisper_tensor_tpu.super_graph.links import (  # noqa: E402
    Image as JaxImage, MultimodalItem as JaxItem)
from whisper_tensor_tpu.utils.image import (  # noqa: E402
    resize_bilinear as jax_resize)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.recipes.vision import (  # noqa: E402
    clip_vision)
from whisper_tensor_tpu_torch.interfaces.multimodal import (  # noqa: E402
    MultimodalLanguageInterface)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.milli.ops import attention  # noqa: E402
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi  # noqa: E402
from whisper_tensor_tpu_torch.super_graph.links import (  # noqa: E402
    Image, MultimodalItem)
from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402
from whisper_tensor_tpu_torch.utils.image import (  # noqa: E402
    png_bytes, resize_bilinear)

MAX_LEN, V = 128, 512
RNG = np.random.default_rng(11)
PIXELS = RNG.integers(0, 255, (16, 16, 3)).astype(np.uint8)
ODD = RNG.integers(0, 255, (20, 14, 3)).astype(np.uint8)


def _hf_state():
    from transformers import LlavaConfig, LlavaForConditionalGeneration

    torch.manual_seed(3)
    hf = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=dict(model_type="clip_vision_model",
                           num_hidden_layers=2, hidden_size=32,
                           num_attention_heads=2, intermediate_size=64,
                           image_size=16, patch_size=8,
                           hidden_act="quick_gelu"),
        text_config=dict(model_type="llama", num_hidden_layers=2,
                         hidden_size=128, num_attention_heads=2,
                         num_key_value_heads=2, intermediate_size=256,
                         vocab_size=V, max_position_embeddings=MAX_LEN,
                         rope_theta=10000.0)))
    cfg = hf.config.to_dict()
    sd = {k: v.detach().float().numpy().copy()
          for k, v in hf.state_dict().items()}
    # the classic layout's names, whichever transformers wrote
    classic = {}
    for k, v in sd.items():
        for new, old in (("model.language_model.", "language_model.model."),
                         ("model.vision_tower.", "vision_tower."),
                         ("model.multi_modal_projector.",
                          "multi_modal_projector."),
                         ("lm_head.", "language_model.lm_head.")):
            if k.startswith(new):
                k = old + k[len(new):]
                break
        classic[k] = v
    return cfg, classic


CFG, CLASSIC = _hf_state()


def _layout(kind):
    if kind == "classic":
        return CLASSIC
    out = {}
    for k, v in CLASSIC.items():
        for old, new in (("language_model.model.", "model.language_model."),
                         ("language_model.lm_head.", "lm_head."),
                         ("vision_tower.", "model.vision_tower."),
                         ("multi_modal_projector.",
                          "model.multi_modal_projector.")):
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from safetensors.numpy import save_file

    out = {}
    for kind in ("classic", "new"):
        d = tmp_path_factory.mktemp(kind)
        (d / "config.json").write_text(json.dumps(CFG))
        save_file(_layout(kind), str(d / "model.safetensors"))
        out[kind] = str(d)
    return out


def _vcfg(pkg):
    return pkg.ClipVisionConfig(num_hidden_layers=2, hidden_size=32,
                                num_attention_heads=2, intermediate_size=64,
                                image_size=16, patch_size=8, select_layer=-2)


def _get(prefix):
    return lambda n: CLASSIC[f"{prefix}.{n}"]


@pytest.mark.parametrize("dt", ["F32", "BF16"])
def test_clip_recipe_writes_the_references_onnx_bytes(dt):
    got = clip_vision.build_clip_vision(
        _get("vision_tower"), _vcfg(clip_vision), dtype=DType[dt],
        projector=_get("multi_modal_projector"))
    want = jax_clip.build_clip_vision(
        _get("vision_tower"), _vcfg(jax_clip), dtype=JaxDType[dt],
        projector=_get("multi_modal_projector"))
    assert got == want


def _load(pkg, path, **cfg):
    reg = loader_registry() if pkg == "port" else jax_loaders()
    return reg["transformers"].load({"path": path, "max_len": MAX_LEN,
                                     "dtype": "f32", **cfg})


def _mms(path, **kw):
    """(port, JAX) multimodal interfaces at f32 over the two loaders'
    bundles, with the byte tokenizer."""
    pb, jb = _load("port", path, **kw), _load("jax", path)
    ps, js = pb.interfaces["multimodal"], jb.interfaces["multimodal"]
    assert ps == js
    assert {k: v for k, v in pb.interfaces["text"].items()
            if k != "quantize"} == jb.interfaces["text"]
    port = MultimodalLanguageInterface(
        TextInferenceInterface(pb.models[ps["model"]], max_len=MAX_LEN,
                               prompt_buckets=(16, 32), device="cpu",
                               cache_dtype=DType.F32,
                               quantize=pb.interfaces["text"]["quantize"]
                               or None),
        embed_weight_name=ps["embed_weight"],
        vision_encoder=pb.models[ps["vision"]])
    ref = JaxMM(JaxText(jb.models[js["model"]], max_len=MAX_LEN,
                        prompt_buckets=(16, 32), cache_dtype=JaxDType.F32,
                        weight_dtype=JaxDType.F32),
                embed_weight_name=js["embed_weight"],
                vision_encoder=jb.models[js["vision"]])
    port.text.tokenizer = ref.text.tokenizer = ByteTokenizer()
    return port, ref


def _items(pkg_item, pkg_image):
    return [pkg_item(text="describe "), pkg_item(image=pkg_image(PIXELS)),
            pkg_item(text=" now:")]


def test_the_tower_and_projector_match_the_jax_package(checkpoints):
    port, ref = _mms(checkpoints["classic"])
    got = port.encode_image(PIXELS).numpy()
    px = (PIXELS.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)[None]
    want = ref.vision_encoder.eval({"pixels": px})["embeddings"][0]
    assert got.shape == (4, 128)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("layout", ["classic", "new"])
def test_items_and_embeds_give_the_jax_packages_tokens(checkpoints, layout):
    port, ref = _mms(checkpoints[layout])
    got = port.embed_items(_items(MultimodalItem, Image)).numpy()
    want = ref.embed_items(_items(JaxItem, JaxImage))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(port.generate_from_embeds(want, 8),
                                  ref.generate_from_embeds(want, 8))
    assert port.run_items_in_string_out(_items(MultimodalItem, Image), 6) \
        == ref.run_items_in_string_out(_items(JaxItem, JaxImage), 6)


def test_int8_embeds_prefill_takes_the_token_paths_route(checkpoints,
                                                         monkeypatch):
    routes = []
    for name in ("flash_mode", "pos_mode"):
        real = getattr(attention, name)

        def spy(*a, _real=real, **kw):
            routes.append(_real(*a, **kw))
            return routes[-1]

        monkeypatch.setattr(attention, name, spy)
    pb = _load("port", checkpoints["classic"], quantize="int8",
               dtype="bf16")
    spec = pb.interfaces["multimodal"]
    text = TextInferenceInterface(pb.models[spec["model"]], max_len=MAX_LEN,
                                  prompt_buckets=(16,), device="cpu",
                                  cache_dtype=DType.BF16, quantize="int8")
    assert text._quantized
    mm = MultimodalLanguageInterface(text, "embed_tokens",
                                     pb.models[spec["vision"]])
    ids = np.random.default_rng(2).integers(3, V, (1, 16)).astype(np.int64)
    want = text.logits(ids)
    token_routes, routes[:] = list(routes), []
    got = mm.prefill_embeds(mm._wte()[torch.from_numpy(ids)],
                            text.fresh_cache(1))
    assert routes == token_routes == ["flash_pos"] * 2
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_resize_bilinear_equals_the_jax_packages():
    for h, w in ((16, 16), (7, 30), (33, 9)):
        np.testing.assert_array_equal(resize_bilinear(ODD, h, w),
                                      jax_resize(ODD, h, w))


def _serve(srv_cls, api_cls, path):
    """A Server of either package with the tiny LLaVA loaded at f32. Its
    text interface is put in place at an f32 cache (each server's own
    keeps a bf16 cache, which rounds in other places in the two
    packages: ROADMAP C10), so the two answer token for token."""
    port = srv_cls is Server
    srv = srv_cls(device="cpu") if port else srv_cls()
    for e in srv.models.run_loader("transformers", {
            "path": path, "dtype": "f32", "max_len": MAX_LEN}):
        if "vision" not in e.name:
            srv._text_ifaces[e.id] = (
                TextInferenceInterface(e.model, MAX_LEN, DType.F32,
                                       device="cpu") if port
                else JaxText(e.model, MAX_LEN, JaxDType.F32,
                             weight_dtype=JaxDType.F32))
    return srv, api_cls(srv, "127.0.0.1", 0).start()


def _post(port, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", "/v1/chat/completions", body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def test_llava_served_over_the_websocket_and_openai(checkpoints):
    png64 = base64.b64encode(png_bytes(ODD)).decode()
    wire = [{"text": "hi "}, {"image_b64": png64}, {"text": " desc:"}]
    chat = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is this? "},
        {"type": "image_url", "image_url": {
            "url": "data:image/png;base64," + png64}}]}],
        "max_tokens": 5, "temperature": 0}
    answers = []
    for srv_cls, api_cls in ((Server, OpenAIApi), (JaxServer, JaxApi)):
        srv, api = _serve(srv_cls, api_cls, checkpoints["classic"])
        try:
            entry = next(e for e in srv.models._models.values()
                         if "vision" not in e.name)
            if srv_cls is Server:
                assert srv._dispatch({"type": "generate_multimodal",
                                      "model_id": entry.id, "items": wire,
                                      "max_new_tokens": 5}) is None
                while True:
                    r = srv.scheduler.reports.get(timeout=300)
                    if r["type"] in ("job_result", "job_error"):
                        break
                assert r["type"] == "job_result", r
                ws = r["result"]["text"]
            else:
                # the reference's WebSocket job, run here in place
                mm, spec = srv._mm_iface(entry)
                mm.text.tokenizer = ByteTokenizer()
                ws = mm.run_items_in_string_out(
                    srv._mm_items(spec, wire), 5)
            status, out = _post(api.port, chat)
            assert status == 200, out
            bad = {"messages": [{"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": "https://x/img.png"}}]}]}
            assert _post(api.port, bad)[0] == 400
            answers.append((ws, out["choices"][0]["message"]["content"],
                            out["usage"]))
        finally:
            api.stop()
    assert answers[0] == answers[1]
