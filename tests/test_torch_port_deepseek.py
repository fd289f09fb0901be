"""DeepSeek-V2 and V3 (MLA attention, MoE) on the port, against the JAX
package, on the CPU.

Tiny checkpoints written by transformers (seeded torch init, V3's
e_score_correction_bias drawn from a numpy seed so that the correction
moves the group choice): hidden 128, 2 heads, nope/rope/v head dims
16/8/16, kv_lora_rank 32, 3 layers (one dense, two MoE), 4 routed
experts of 128 (2 a token) and 1 shared. V2 has no q_lora_rank and
softmax greedy routing; V3 a q_lora_rank of 48, sigmoid scores,
noaux_tc group routing (4 groups, 2 kept), norm_topk_prob and a scaling
factor of 2.5.

* The port's recipe writes the JAX recipe's ONNX bytes, both MLA builds,
  f32 and bf16.
* Both packages' loaders read each directory at f32: prefill logits
  within 1e-4 of the largest |logit| and 6 greedy tokens equal, both
  builds; at bf16 the C10 rule (each row within 1/16 of its largest
  |logit|).
* The caches: the latent (B, 1, L, 32) and the rope key (B, 1, L, 8).
* quantize=int8 and q4_0 (the reference's numpy int8 quantizer): the
  same tokens and logits as the JAX package's quantized interface.
* Attention: every call of both builds takes the plain path (flash_mode
  and pos_mode give None, no kernel wrapper is called).
* ragged_decode: the reference's batcher fails at the first request;
  the port refuses it at load (ROADMAP C25).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    deepseek as jax_deepseek)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxText)
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    deepseek)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.milli.ops import attention  # noqa: E402

MAX_LEN = 32
COMMON = dict(num_hidden_layers=3, num_attention_heads=2, hidden_size=128,
              intermediate_size=256, moe_intermediate_size=128,
              vocab_size=512, kv_lora_rank=32, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4,
              num_experts_per_tok=2, n_shared_experts=1,
              first_k_dense_replace=1, moe_layer_freq=1, rms_norm_eps=1e-6,
              rope_theta=10000.0)
CONFIGS = {
    "v2": dict(COMMON, model_type="deepseek_v2", q_lora_rank=None,
               routed_scaling_factor=1.0, norm_topk_prob=False),
    "v3": dict(COMMON, model_type="deepseek_v3", q_lora_rank=48,
               n_routed_experts=8, num_experts_per_tok=3,
               routed_scaling_factor=2.5, norm_topk_prob=True, n_group=4,
               topk_group=2),
}
PROMPT = np.random.default_rng(5).integers(3, 512, (2, 7)).astype(np.int64)


def _hf_state(kind):
    """{HF name: f32 array} of a seeded transformers model."""
    from transformers import (DeepseekV2Config, DeepseekV2ForCausalLM,
                              DeepseekV3Config, DeepseekV3ForCausalLM)

    torch.manual_seed(0 if kind == "v2" else 1)
    c = {k: v for k, v in CONFIGS[kind].items() if k != "model_type"}
    if kind == "v2":
        hf = DeepseekV2ForCausalLM(DeepseekV2Config(
            attention_dropout=0.0, max_position_embeddings=MAX_LEN,
            attention_bias=False, **c))
    else:
        hf = DeepseekV3ForCausalLM(DeepseekV3Config(
            attention_dropout=0.0, max_position_embeddings=MAX_LEN,
            attention_bias=False, rope_scaling=None, **c))
    sd = {k: v.detach().float().numpy().copy()
          for k, v in hf.state_dict().items()}
    rng = np.random.default_rng(7)
    for k in sd:
        if k.endswith("e_score_correction_bias"):
            sd[k] = (0.2 * rng.standard_normal(sd[k].shape)).astype(
                np.float32)
    return sd


STATES = {k: _hf_state(k) for k in CONFIGS}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from safetensors.numpy import save_file

    out = {}
    for kind, cfg in CONFIGS.items():
        d = tmp_path_factory.mktemp(kind)
        (d / "config.json").write_text(json.dumps(cfg))
        save_file(STATES[kind], str(d / "model.safetensors"))
        out[kind] = str(d)
    return out


@pytest.fixture(autouse=True)
def _numpy_quantize(monkeypatch):
    """The reference's quantize_int8 on its numpy path (the port copies
    that path; the native one's scales can differ in the last bit)."""
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)


def _cfg(pkg, kind):
    cfg = pkg.DeepseekConfig.from_hf(CONFIGS[kind])
    if kind == "v3":
        cfg.scoring_func, cfg.topk_method = "sigmoid", "noaux_tc"
    return cfg


@pytest.mark.parametrize("dt", ["F32", "BF16"])
@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_recipe_writes_the_references_onnx_bytes(kind, absorb, dt):
    get = STATES[kind].__getitem__
    got = deepseek.build_deepseek_step(get, _cfg(deepseek, kind),
                                       max_len=MAX_LEN, dtype=DType[dt],
                                       absorb=absorb)
    want = jax_deepseek.build_deepseek_step(
        get, _cfg(jax_deepseek, kind), max_len=MAX_LEN,
        dtype=JaxDType[dt], absorb=absorb)
    assert got == want


def _load(pkg, path, **cfg):
    reg = loader_registry() if pkg == "port" else jax_loaders()
    bundle = reg["transformers"].load({"path": path, "max_len": MAX_LEN,
                                       "dtype": "f32", **cfg})
    (model,) = bundle.models.values()
    return model, bundle.interfaces["text"]


def _pair(checkpoints, kind, absorb, dtype="f32", **kw):
    (pm, pspec), (jm, jspec) = (
        _load(p, checkpoints[kind], absorb_mla=absorb, dtype=dtype)
        for p in ("port", "jax"))
    geo = ("n_layers", "n_kv_heads", "head_dim", "eos_token_id", "ragged")
    assert {k: pspec[k] for k in geo} == {k: jspec[k] for k in geo}
    port = TextInferenceInterface(pm, max_len=MAX_LEN, prompt_buckets=(16,),
                                  device="cpu", cache_dtype=DType.F32, **kw)
    ref = JaxText(jm, max_len=MAX_LEN, prompt_buckets=(16,),
                  cache_dtype=JaxDType.F32, weight_dtype=JaxDType.F32, **kw)
    return port, ref


def _assert_close(got, want, frac):
    """Each logit row within `frac` of its largest |logit|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = frac * np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= bound), \
        float((np.abs(got - want) / bound).max())


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_loaders_give_the_jax_packages_tokens_and_logits(checkpoints, kind,
                                                         absorb):
    port, ref = _pair(checkpoints, kind, absorb)
    _assert_close(port.logits(PROMPT), ref.logits(PROMPT), 1e-4)
    np.testing.assert_array_equal(port.generate_tokens(PROMPT, 6),
                                  ref.generate_tokens(PROMPT, 6))


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_bf16_logits_hold_the_c10_rule(checkpoints, kind):
    """bf16 weights and activations: the same math, rounded in other
    places by the two packages (ROADMAP C10)."""
    (pm, _), (jm, _) = (_load(p, checkpoints[kind], dtype="bf16")
                        for p in ("port", "jax"))
    port = TextInferenceInterface(pm, max_len=MAX_LEN, prompt_buckets=(16,),
                                  device="cpu", cache_dtype=DType.BF16)
    ref = JaxText(jm, max_len=MAX_LEN, prompt_buckets=(16,),
                  cache_dtype=JaxDType.BF16)
    _assert_close(port.logits(PROMPT), ref.logits(PROMPT), 1 / 16)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
def test_the_caches_hold_the_latent_and_the_rope_key(checkpoints, absorb):
    port, _ = _pair(checkpoints, "v2", absorb)
    c = CONFIGS["v2"]
    assert [tuple(t.shape) for t in port.fresh_cache(3)[:2]] == [
        (3, 1, MAX_LEN, c["kv_lora_rank"]),
        (3, 1, MAX_LEN, c["qk_rope_head_dim"])]
    assert port.head_dim == c["kv_lora_rank"] and port.n_heads == 1


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_quantized_graphs_match_the_jax_package(checkpoints, kind, quantize):
    port, ref = _pair(checkpoints, kind, True, quantize=quantize)
    kinds = [n.op.KIND for n in port.milli.nodes]
    assert kinds.count("QuantMatMul" if quantize == "int8"
                       else "PackedMatMul") > 0
    _assert_close(port.logits(PROMPT), ref.logits(PROMPT), 1e-4)
    np.testing.assert_array_equal(port.generate_tokens(PROMPT, 6),
                                  ref.generate_tokens(PROMPT, 6))


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
def test_mla_attention_takes_the_plain_path(checkpoints, absorb,
                                            monkeypatch):
    """Neither build's Attention fits a kernel (v narrower than k, head
    dims 40 and 24 here, 576 and 192 at published widths): flash_mode
    and pos_mode send every call to the plain path in bf16 too."""
    routes = []
    for name in ("flash_mode", "pos_mode"):
        real = getattr(attention, name)

        def spy(*a, _real=real, **kw):
            routes.append(_real(*a, **kw))
            return routes[-1]

        monkeypatch.setattr(attention, name, spy)
    for name in ("flash_attention", "decode_attention"):
        monkeypatch.setattr(attention, name, lambda *a, **k: pytest.fail(
            "an attention kernel wrapper was called"))
    pm, _ = _load("port", checkpoints["v3"], absorb_mla=absorb,
                  dtype="bf16")
    port = TextInferenceInterface(pm, max_len=MAX_LEN, prompt_buckets=(16,),
                                  device="cpu", cache_dtype=DType.BF16)
    port.generate_tokens(PROMPT, 3)
    # 3 layers x (prefill + 2 decode steps)
    assert len(routes) == 9 and routes == [None] * 9


def test_ragged_decode_is_refused_where_the_reference_fails(checkpoints):
    """The reference builds DeepSeek's scalar-position graph under
    ragged_decode and its batcher fails at the first request; the port
    refuses the option at load (ROADMAP C25)."""
    for kind in CONFIGS:
        with pytest.raises(ValueError, match="ragged_decode"):
            _load("port", checkpoints[kind], ragged_decode=True)
    model, spec = _load("jax", checkpoints["v2"], ragged_decode=True)
    assert spec["ragged"]
    bat = JaxBatcher(model, max_len=MAX_LEN, max_batch=4).start()
    try:
        with pytest.raises(TypeError, match="broadcasting"):
            futs = [bat.submit(p, 4) for p in (PROMPT[0], PROMPT[1, :3])]
            [f.result(timeout=120) for f in futs]
    finally:
        bat.stop()
