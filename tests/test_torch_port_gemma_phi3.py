"""Gemma, Gemma-2, Gemma-3 and Phi-3 on the port, against the JAX package,
on the CPU; and the routing and f16 fixes these models need on the card.

Tiny checkpoints (2 layers, seeded numpy weights, written as one
safetensors directory each): Gemma (hidden 256, 2 query heads and 1 KV
head of 128), Gemma-2 (the same, query_pre_attn_scalar 64, attention and
final softcaps 5 and 3, small enough to bite), Gemma-3 (the same, q/k
norms, sliding_window_pattern 2 so layer 0 is local and layer 1 global,
a window of 4 under the 7-token prompt) and Phi-3 (hidden 192, 2 heads
of 96 each way, fused qkv_proj and gate_up_proj).

* The port's recipes write the JAX recipes' ONNX bytes for one getter,
  at f32 and bf16.
* Each package's transformers loader reads the same directory at f32:
  8 greedy tokens equal, prefill logits within rtol 1e-5 and atol 1e-5
  (the llama GGUF parity tests' bound, test_torch_port_packed.py:
  _assert_same_run; both sum in f32, in other orders).
* The GGUF adapters (arch gemma, gemma2, phi3; Q8_0 matmul weights, the
  norms baked +1 as llama.cpp's converter bakes Gemma's): a file from
  the port's writer (the reference writer's bytes) loads through both
  packages' GGUF loaders to the same tokens and logits; ragged_decode
  raises the reference's error.
* quantize=int8 and q4_0 on the tiny Gemma-2 (the reference's numpy
  int8 quantizer, as test_torch_port_frontend.py holds it): the same
  tokens and logits; the hidden-state tap walks back through the final
  softcap to the lm_head's input at f32 (the JAX package's hidden
  states) and int8 (the port's own MilliGraph.eval: the JAX package
  raises there, ROADMAP C12).
* ragged_decode on these model types: the reference accepts it and its
  batcher fails at the first request; the port refuses at load (C18).
* C16: `pos_mode` and `flash_mode` send head dims 32 and 96, Dv != D,
  f32 caches and softcaps to the plain path, and 64, 128 and 256 to the
  kernels' wrappers.
* C17: the plain versions of the f16 paths (an f16 model over the
  server's bf16 cache) against the reference's casts.
* The text front end serves the tiny Gemma-3 over HTTP (completions,
  chat, embeddings) and `cli generate` the tiny Phi-3.
"""

import http.client
import json
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from whisper_tensor_tpu.backends.pallas import (  # noqa: E402
    packed_matmul as jax_pm, quant_matmul as jax_qm)
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers import gguf as jax_gguf  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gemma as jax_gemma, gemma3 as jax_gemma3, phi3 as jax_phi3)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxText)
from whisper_tensor_tpu.milli.ops.attention import (  # noqa: E402
    AttentionMilli as JaxAttention)
from whisper_tensor_tpu.packed_format import (  # noqa: E402
    PackedFormat as JaxFormat)
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu.tensor import PackedTensor as JaxPacked  # noqa: E402
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch.backends.cpu import dequant  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (  # noqa: E402
    decode_attention_plain)
from whisper_tensor_tpu_torch.backends.cuda.kv_write import (  # noqa: E402
    kv_write_pair_plain)
from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (  # noqa: E402
    packed_matmul_plain, repack_packed_tensor)
from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (  # noqa: E402
    int8_matmul_plain)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers import gguf  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    gemma, gemma3, phi3)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.milli.ops import attention  # noqa: E402
from whisper_tensor_tpu_torch.packed_format import PackedFormat as F  # noqa: E402
from whisper_tensor_tpu_torch.tensor import PackedTensor  # noqa: E402
from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

E, I, V, HD, MAX_LEN = 256, 512, 512, 128, 64
COMMON = dict(num_hidden_layers=2, hidden_size=E, intermediate_size=I,
              vocab_size=V, rms_norm_eps=1e-6, rope_theta=10000.0,
              max_position_embeddings=MAX_LEN, num_attention_heads=2,
              num_key_value_heads=1, head_dim=HD)
CONFIGS = {
    "gemma": dict(COMMON, model_type="gemma"),
    "gemma2": dict(COMMON, model_type="gemma2", query_pre_attn_scalar=64,
                   attn_logit_softcapping=5.0, final_logit_softcapping=3.0),
    "gemma3_text": dict(COMMON, model_type="gemma3_text", rope_theta=1e6,
                        rope_local_base_freq=10000.0,
                        query_pre_attn_scalar=128, sliding_window=4,
                        sliding_window_pattern=2),
    "phi3": dict(COMMON, model_type="phi3", hidden_size=192,
                 num_key_value_heads=2, head_dim=None),
}
FAMILIES = list(CONFIGS)
PROMPT = np.random.default_rng(5).integers(3, 259, (2, 7)).astype(np.int64)


def _shapes(family):
    """{HF name: shape} of a tiny checkpoint."""
    c = CONFIGS[family]
    e, hq, hkv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    d = c["head_dim"] or e // hq
    out = {"model.embed_tokens.weight": (V, e), "model.norm.weight": (e,)}
    layer = {"input_layernorm.weight": (e,),
             "post_attention_layernorm.weight": (e,),
             "self_attn.o_proj.weight": (e, hq * d),
             "mlp.down_proj.weight": (e, I)}
    if family == "phi3":
        out["lm_head.weight"] = (V, e)
        layer.update({"self_attn.qkv_proj.weight": ((hq + 2 * hkv) * d, e),
                      "mlp.gate_up_proj.weight": (2 * I, e)})
    else:
        layer.update({"self_attn.q_proj.weight": (hq * d, e),
                      "self_attn.k_proj.weight": (hkv * d, e),
                      "self_attn.v_proj.weight": (hkv * d, e),
                      "mlp.gate_proj.weight": (I, e),
                      "mlp.up_proj.weight": (I, e)})
    if family in ("gemma2", "gemma3_text"):
        layer.update({"pre_feedforward_layernorm.weight": (e,),
                      "post_feedforward_layernorm.weight": (e,)})
    if family == "gemma3_text":
        layer.update({"self_attn.q_norm.weight": (d,),
                      "self_attn.k_norm.weight": (d,)})
    for i in range(c["num_hidden_layers"]):
        out.update({f"model.layers.{i}.{k}": s for k, s in layer.items()})
    return out


def _weights(family):
    """HF-named weights seeded by name: norms near 0 for Gemma (its RMSNorm
    multiplies by 1 + w) and near 1 for Phi-3, matrices N(0, 0.08^2)."""
    out = {}
    for name, shape in _shapes(family).items():
        rng = np.random.default_rng(zlib.crc32(f"{family}/{name}".encode()))
        w = rng.standard_normal(shape)
        if len(shape) == 1:
            w = 0.1 * w + (1.0 if family == "phi3" else 0.0)
        else:
            w = 0.08 * w
        out[name] = w.astype(np.float32)
    return out


WEIGHTS = {f: _weights(f) for f in FAMILIES}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{family: a tiny HF checkpoint dir (config.json + safetensors)}."""
    from safetensors.numpy import save_file

    out = {}
    for family in FAMILIES:
        d = tmp_path_factory.mktemp(family)
        cfg = {k: v for k, v in CONFIGS[family].items() if v is not None}
        (d / "config.json").write_text(json.dumps(cfg))
        save_file(WEIGHTS[family], str(d / "model.safetensors"))
        out[family] = str(d)
    return out


@pytest.fixture(autouse=True)
def _numpy_quantize(monkeypatch):
    """The reference's quantize_int8 on its numpy path (the port copies
    that path; the native one's scales can differ in the last bit)."""
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)


def _recipe(pkg_recipes, family, dt):
    """One family's step graph from `pkg_recipes` (the JAX package's or
    the port's three modules) with the tiny weights."""
    gem, gem3, ph3 = pkg_recipes
    get, cfg = WEIGHTS[family].__getitem__, CONFIGS[family]
    if family == "phi3":
        return ph3.build_phi3_step(get, ph3.Phi3Config.from_hf(cfg),
                                   max_len=MAX_LEN, dtype=dt)
    if family == "gemma3_text":
        return gem3.build_gemma3_step(get, gem3.Gemma3Config.from_hf(cfg),
                                      max_len=MAX_LEN, dtype=dt)
    return gem.build_gemma_step(get, gem.GemmaConfig.from_hf(cfg),
                                max_len=MAX_LEN, dtype=dt)


@pytest.mark.parametrize("dt", ["F32", "BF16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_recipes_write_the_references_onnx_bytes(family, dt):
    got = _recipe((gemma, gemma3, phi3), family, DType[dt])
    want = _recipe((jax_gemma, jax_gemma3, jax_phi3), family, JaxDType[dt])
    assert got == want


def _load(pkg, loader, path, **cfg):
    reg = loader_registry() if pkg == "port" else jax_loaders()
    bundle = reg[loader].load({"path": path, "max_len": MAX_LEN,
                               "dtype": "f32", **cfg})
    (model,) = bundle.models.values()
    return model, bundle.interfaces["text"]


def _pair(port_model, jax_model, **kw):
    """(port, reference) interfaces at an f32 cache, bucket 16."""
    port = TextInferenceInterface(port_model, max_len=MAX_LEN,
                                  prompt_buckets=(16,), device="cpu",
                                  cache_dtype=DType.F32, **kw)
    ref = JaxText(jax_model, max_len=MAX_LEN, prompt_buckets=(16,),
                  cache_dtype=JaxDType.F32, weight_dtype=JaxDType.F32, **kw)
    return port, ref


def _assert_same_run(port, ref):
    """The llama parity tests' bound (test_torch_port_packed.py)."""
    np.testing.assert_allclose(port.logits(PROMPT),
                               np.asarray(ref.logits(PROMPT)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.generate_tokens(PROMPT, 8),
                                  ref.generate_tokens(PROMPT, 8))


@pytest.mark.parametrize("family", FAMILIES)
def test_loaders_give_the_jax_packages_tokens_and_logits(checkpoints,
                                                         family):
    (pm, pspec), (jm, jspec) = (_load(p, "transformers", checkpoints[family])
                                for p in ("port", "jax"))
    geo = ("n_layers", "n_kv_heads", "head_dim", "eos_token_id", "ragged")
    assert {k: pspec[k] for k in geo} == {k: jspec[k] for k in geo}
    _assert_same_run(*_pair(pm, jm))


# -- GGUF -----------------------------------------------------------------------

_GEMMA_GGUF = {"input_layernorm.weight": "attn_norm.weight",
               "self_attn.q_proj.weight": "attn_q.weight",
               "self_attn.k_proj.weight": "attn_k.weight",
               "self_attn.v_proj.weight": "attn_v.weight",
               "self_attn.o_proj.weight": "attn_output.weight",
               "mlp.gate_proj.weight": "ffn_gate.weight",
               "mlp.up_proj.weight": "ffn_up.weight",
               "mlp.down_proj.weight": "ffn_down.weight"}
GGUF_NAMES = {
    "gemma": {**_GEMMA_GGUF,
              "post_attention_layernorm.weight": "ffn_norm.weight"},
    "gemma2": {**_GEMMA_GGUF,
               "post_attention_layernorm.weight": "post_attention_norm.weight",
               "pre_feedforward_layernorm.weight": "ffn_norm.weight",
               "post_feedforward_layernorm.weight": "post_ffw_norm.weight"},
    "phi3": {"input_layernorm.weight": "attn_norm.weight",
             "post_attention_layernorm.weight": "ffn_norm.weight",
             "self_attn.qkv_proj.weight": "attn_qkv.weight",
             "self_attn.o_proj.weight": "attn_output.weight",
             "mlp.gate_up_proj.weight": "ffn_up.weight",
             "mlp.down_proj.weight": "ffn_down.weight"},
}


def _write_gguf(path, arch):
    """A GGUF of the tiny HF weights the llama.cpp way: matrices in Q8_0
    by rows, norms in f32 (Gemma's baked + 1), the token table in f32.
    Written by the port's writer; the reference's gives the same bytes."""
    family = "gemma2" if arch == "gemma2" else arch
    src = WEIGHTS[family] if arch != "gemma" else WEIGHTS["gemma"]
    c = CONFIGS[family]
    bake = 1.0 if arch != "phi3" else 0.0

    def put(w):
        if w.ndim == 1:
            return (w + bake).astype(np.float32)
        return PackedTensor(dequant.quantize_blocks(w, F.Q8_0), F.Q8_0,
                            w.shape)

    t = {"token_embd.weight": src["model.embed_tokens.weight"],
         "output_norm.weight": put(src["model.norm.weight"])}
    if arch == "phi3":
        t["output.weight"] = put(src["lm_head.weight"])
    for i in range(c["num_hidden_layers"]):
        for hf, gg in GGUF_NAMES[arch].items():
            t[f"blk.{i}.{gg}"] = put(src[f"model.layers.{i}.{hf}"])
    p = arch + "."
    e = c["hidden_size"]
    meta = {"general.architecture": arch, "general.name": f"tiny-{arch}",
            p + "block_count": c["num_hidden_layers"],
            p + "embedding_length": e,
            p + "attention.head_count": c["num_attention_heads"],
            p + "attention.head_count_kv": c["num_key_value_heads"],
            p + "feed_forward_length": I, p + "context_length": MAX_LEN,
            p + "vocab_size": V, p + "attention.layer_norm_rms_epsilon": 1e-6,
            p + "rope.freq_base": 10000.0,
            "tokenizer.ggml.eos_token_id": 1}
    if arch != "phi3":
        meta[p + "attention.key_length"] = HD
    if arch == "gemma2":
        meta[p + "attn_logit_softcapping"] = 5.0
        meta[p + "final_logit_softcapping"] = 3.0
    gguf.write_gguf(str(path), meta, t)
    jax_gguf.write_gguf(str(path) + ".ref", meta, {
        k: (JaxPacked(v.data, JaxFormat[v.fmt.name], v.shape)
            if isinstance(v, PackedTensor) else v) for k, v in t.items()})
    assert path.read_bytes() == (path.parent / (path.name + ".ref")).read_bytes()
    return str(path)


@pytest.mark.parametrize("arch", ["gemma", "gemma2", "phi3"])
def test_gguf_adapters_match_the_jax_package(tmp_path, arch):
    path = _write_gguf(tmp_path / f"{arch}.gguf", arch)
    (pm, pspec), (jm, jspec) = (_load(p, "gguf", path) for p in ("port",
                                                                 "jax"))
    assert not pm.graph.store.packed_sources        # dequantized on the host
    geo = ("n_layers", "n_kv_heads", "head_dim", "eos_token_id")
    assert {k: pspec[k] for k in geo} == {k: jspec[k] for k in geo}
    _assert_same_run(*_pair(pm, jm))
    # the reference's error for a per-row position, in both packages
    for reg in (loader_registry(), jax_loaders()):
        with pytest.raises(ValueError, match="ragged decode not supported"):
            reg["gguf"].load({"path": path, "max_len": MAX_LEN,
                              "ragged_decode": True})


# -- quantized Gemma-2 and its hidden-state tap ---------------------------------

@pytest.fixture(scope="module")
def gemma2_models(checkpoints):
    return tuple(_load(p, "transformers", checkpoints["gemma2"])[0]
                 for p in ("port", "jax"))


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_quantized_gemma2_matches_the_jax_package(gemma2_models, quantize):
    port, ref = _pair(*gemma2_models, quantize=quantize)
    kind = {"int8": "QuantMatMul", "q4_0": "PackedMatMul"}[quantize]
    kinds = [n.op.KIND for n in port._exec.graph.nodes]
    # fused q/k/v, fused gate/up, o, down a layer, and the lm_head
    assert kinds.count(kind) == 2 * 4 + 1
    assert [n.op.KIND for n in port.milli.nodes] == \
        [n.op.KIND for n in ref.milli.nodes]
    _assert_same_run(port, ref)


def test_the_hidden_state_tap_walks_back_through_the_softcap(gemma2_models):
    run_f32, ref = _pair(*gemma2_models)
    tail = [n.op.KIND for n in run_f32._exec.graph.nodes][-4:]
    assert "SimpleUnary" in tail                    # the final Tanh
    got = run_f32.hidden_states(PROMPT)
    want = np.asarray(ref.hidden_states(PROMPT), np.float32)
    assert got.shape == (2, 7, E)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    port = TextInferenceInterface(gemma2_models[0], max_len=MAX_LEN,
                                  prompt_buckets=(16,), device="cpu",
                                  cache_dtype=DType.F32, quantize="int8")
    run = port._exec.graph
    tap = port._hidden_tid()
    heads = [n for n in run.nodes if n.op.KIND == "QuantMatMul"]
    head = heads[-1]                                # the lm_head
    assert head.inputs[0] == tap
    assert run.outputs["logits"] not in head.outputs   # the softcap tail
    hidden = port.hidden_states(PROMPT)
    captured = {}
    run.eval(_host_feeds(port),
             capture=lambda tid, a: captured.setdefault(tid, a))
    want = captured[head.inputs[0]][:, :7]
    np.testing.assert_allclose(hidden, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _host_feeds(port):
    """The feeds of the port's step graph for a prefill of PROMPT in its
    bucket (tests/test_torch_port_hidden_beam.py's)."""
    from tests.test_torch_port_hidden_beam import _host_feeds as feeds

    return feeds(port, PROMPT)


def test_ragged_decode_is_refused_where_the_reference_fails(checkpoints):
    """The reference builds these recipes' scalar-position graph under
    ragged_decode and its batcher fails at the first request; the port
    refuses the option at load (ROADMAP C18)."""
    path = checkpoints["gemma"]
    for family in FAMILIES:
        with pytest.raises(ValueError, match="ragged_decode"):
            _load("port", "transformers", checkpoints[family],
                  ragged_decode=True)
    model, spec = _load("jax", "transformers", path, ragged_decode=True)
    assert spec["ragged"]
    bat = JaxBatcher(model, max_len=MAX_LEN, max_batch=4).start()
    try:
        with pytest.raises(TypeError, match="broadcasting"):
            futs = [bat.submit(p, 4) for p in (PROMPT[0], PROMPT[1, :3])]
            [f.result(timeout=120) for f in futs]
    finally:
        bat.stop()


# -- C16: the attention routes follow the kernels' domain -----------------------

def _op(**kw):
    return attention.AttentionMilli(**kw)


def _qkv(B, Hq, Hkv, Sq, L, D, Dv=None, qdt=torch.bfloat16,
         kdt=torch.bfloat16):
    q = torch.zeros(B, Hq, Sq, D, dtype=qdt)
    k = torch.zeros(B, Hkv, L, D, dtype=kdt)
    v = torch.zeros(B, Hkv, L, Dv or D, dtype=kdt)
    return q, k, v


POS_CASES = [
    # (B, Hq, Hkv, Sq, D, Dv, q type, cache type, op kwargs) -> route
    ((1, 8, 1, 1, 32, None, "bf16", "bf16", {}), None),
    ((1, 32, 32, 1, 96, None, "bf16", "bf16", {}), None),
    ((1, 32, 32, 24, 96, None, "bf16", "bf16", {}), None),
    ((2, 4, 2, 1, 128, 64, "bf16", "bf16", {}), None),
    ((2, 4, 2, 6, 128, 64, "bf16", "bf16", {}), None),
    ((2, 8, 4, 1, 384, None, "bf16", "bf16", {}), None),
    ((1, 8, 4, 1, 256, None, "bf16", "bf16", {"softcap": 50.0}), None),
    ((1, 8, 4, 1, 128, None, "f32", "f32", {}), None),
    ((1, 6, 4, 1, 128, None, "bf16", "bf16", {}), None),
    ((1, 8, 4, 5, 128, None, "f16", "bf16", {}), None),
    ((1, 12, 12, 1, 64, None, "bf16", "bf16", {}), "decode"),
    ((3, 32, 8, 1, 128, None, "bf16", "bf16", {}), "decode"),
    ((1, 8, 4, 1, 256, None, "bf16", "bf16", {}), "decode"),
    ((16, 8, 1, 1, 256, None, "f32", "bf16", {}), "decode"),
    ((2, 8, 4, 1, 256, None, "f16", "bf16", {}), "decode"),
    ((1, 12, 12, 9, 64, None, "bf16", "bf16", {}), "flash_pos"),
    ((2, 32, 8, 16, 128, None, "bf16", "bf16", {}), "flash_pos"),
    ((1, 4, 1, 128, 256, None, "bf16", "bf16", {}), "flash_pos"),
]
_DT = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}


@pytest.mark.parametrize("case,route", POS_CASES,
                         ids=[f"{c[4]}-{c[3]}-{r}" for c, r in POS_CASES])
def test_pos_mode_routes_by_the_kernels_domain(case, route):
    B, Hq, Hkv, Sq, D, Dv, qdt, kdt, kw = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, 32, D, Dv, _DT[qdt], _DT[kdt])
    pos = torch.zeros(B, dtype=torch.int64)
    assert attention.pos_mode(_op(**kw), q, k, v, pos, False) == route
    if route is not None:
        assert attention.pos_mode(_op(**kw), q, k, v, pos, True) is None


@pytest.mark.parametrize("D,mode", [(32, None), (96, None), (64, "additive"),
                                    (128, "additive"), (256, "additive"),
                                    (384, None)])
def test_flash_mode_takes_head_dims_64_128_and_256(D, mode):
    q, k, v = _qkv(1, 4, 1, 16, 2048, D)
    mask = torch.zeros(1, 1, 16, 2048)
    assert attention.flash_mode(_op(), q, k, v, mask, False) == mode
    assert attention.flash_mode(_op(softcap=50.0), q, k, v, mask,
                                False) is None


def test_the_plain_path_serves_what_no_kernel_takes():
    """Phi-3's head dim through the lowering on the CPU: the plain path,
    against the oracle (AttentionMilli.eval)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 4, 3, 96)).astype(ml_dtypes.bfloat16)
    k = rng.standard_normal((1, 4, 16, 96)).astype(ml_dtypes.bfloat16)
    v = rng.standard_normal((1, 4, 16, 96)).astype(ml_dtypes.bfloat16)
    pos = np.asarray(5, np.int64)
    op = _op(scale=96 ** -0.5)
    (want,) = op.eval([q, k, v, pos])
    (got,) = attention.attention(op, [torch.from_numpy(a.view(np.uint16))
                                      .view(torch.bfloat16) for a in (q, k, v)]
                                 + [torch.tensor(5)], {}, "cpu")
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


# -- C17: the f16 paths' plain versions against the reference's casts ------------

def _f16(a):
    return torch.from_numpy(np.asarray(a, np.float16))


def test_f16_cache_write_rounds_as_the_reference_casts():
    """kv_write_pair_plain writes an f16 update into a bf16 cache as
    XLA's convert does (round to nearest even through f32): the bits of
    jax.lax.dynamic_update_slice of the update cast to bf16."""
    rng = np.random.default_rng(1)
    cache = (rng.standard_normal((2, 2, 16, 256)) * 3).astype(
        ml_dtypes.bfloat16)
    upd = [(rng.standard_normal((2, 2, 4, 256)) * 3).astype(np.float16)
           for _ in range(2)]
    upd[0][0, 0, 0, :4] = [65504.0, -6.1e-5, 1e-7, 0.333]  # f16 edges
    for pos in (np.asarray(5), np.asarray([3, 12])):
        caches = [torch.from_numpy(cache.view(np.uint16).copy()).view(
            torch.bfloat16) for _ in range(2)]
        got = kv_write_pair_plain(caches[0], _f16(upd[0]), caches[1],
                                  _f16(upd[1]), torch.from_numpy(pos))
        for g, u in zip(got, upd):
            want = np.asarray(cache).copy()
            for b in range(2):
                p = int(pos.reshape(-1)[b % pos.size])
                want[b] = np.asarray(jax.lax.dynamic_update_slice(
                    jnp.asarray(cache[b]),
                    jnp.asarray(u[b]).astype(jnp.bfloat16), (0, p, 0)))
            assert g.view(torch.int16).numpy().tobytes() == \
                want.view(np.int16).tobytes()


@pytest.mark.parametrize("M", [1, 5])
def test_f16_quantized_products_match_the_reference(M):
    """int8_matmul_plain and packed_matmul_plain on f16 x against the JAX
    functions (their jnp paths on the CPU) on the same f16 x: f32 sums
    in other orders, rounded once to f16, so one f16 ulp apart at most."""
    rng = np.random.default_rng(M)
    K, N = 256, 96
    x = rng.standard_normal((M, K)).astype(np.float16)
    w8 = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = (rng.random(N) * 0.01).astype(np.float32)
    got = int8_matmul_plain(_f16(x), torch.from_numpy(w8),
                            torch.from_numpy(scale)).numpy()
    want = np.asarray(jax_qm.int8_matmul(jnp.asarray(x), jnp.asarray(w8),
                                         jnp.asarray(scale)))
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=2 ** -10,
                               atol=1e-6)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    rp = repack_packed_tensor(PackedTensor(
        dequant.quantize_blocks(w, F.Q4_0), F.Q4_0, w.shape))
    got = packed_matmul_plain(_f16(x), *(torch.from_numpy(np.asarray(
        rp[k])) for k in ("q", "scales", "offsets")), rp["bits"],
        rp.get("has_off", True)).numpy()
    want = np.asarray(jax_pm.packed_matmul(
        jnp.asarray(x), jnp.asarray(rp["q"]), jnp.asarray(rp["scales"]),
        jnp.asarray(rp["offsets"]), bits=rp["bits"]))
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=2 ** -10,
                               atol=1e-6)


def test_f16_decode_step_matches_the_reference():
    """An f16 query over a bf16 cache: the Attention lowering sends it to
    decode_attention (its plain version on the CPU), which stands the
    JAX AttentionMilli's XLA path within one f16 ulp and f32 noise."""
    rng = np.random.default_rng(2)
    B, Hq, Hkv, L, D = 2, 8, 4, 32, 256
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float16)
    k = rng.standard_normal((B, Hkv, L, D)).astype(ml_dtypes.bfloat16)
    v = rng.standard_normal((B, Hkv, L, D)).astype(ml_dtypes.bfloat16)
    pos = np.asarray([9, 31], np.int64)
    scale = D ** -0.5
    (want,) = JaxAttention(scale=scale).to_jax(
        [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)])
    kt, vt = (torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
              for a in (k, v))
    assert attention.pos_mode(_op(), _f16(q), kt, vt, torch.from_numpy(pos),
                              False) == "decode"
    got = decode_attention_plain(_f16(q), kt, vt, torch.from_numpy(pos),
                                 scale)
    want = np.asarray(want)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2 ** -10, atol=1e-4)


# -- the text front end --------------------------------------------------------

def _post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request("POST", path, body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def test_gemma3_is_served_over_http(checkpoints):
    """/v1/completions, /v1/chat/completions and /v1/embeddings on the
    direct path of the port's Server answer with its interface's own
    greedy tokens and hidden states."""
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("transformers", {
        "path": checkpoints["gemma3_text"], "dtype": "f32",
        "max_len": MAX_LEN})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        tok = ByteTokenizer()
        iface = srv._text_iface(entry)
        ids = np.asarray(tok.encode("hello there"), np.int64)[None]
        status, r = _post(api.port, "/v1/completions", {
            "model": str(entry.id), "prompt": "hello there",
            "max_tokens": 6, "temperature": 0})
        assert status == 200, r
        assert r["choices"][0]["text"] == tok.decode(
            list(iface.generate_tokens(ids, 6)[0]))
        status, r = _post(api.port, "/v1/chat/completions", {
            "model": str(entry.id), "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        assert status == 200 and r["usage"]["completion_tokens"] == 4, r
        status, r = _post(api.port, "/v1/embeddings", {
            "model": str(entry.id), "input": ["hello there"]})
        assert status == 200, r
        vec = np.asarray(r["data"][0]["embedding"])
        want = iface.embed([ids[0]])[0]
        np.testing.assert_allclose(vec, want, rtol=0, atol=1e-6)
    finally:
        api.stop()


def test_cli_generate_serves_phi3(checkpoints, capsys):
    """`cli generate` on the tiny Phi-3 prints its interface's greedy
    text."""
    from whisper_tensor_tpu_torch.cli import main

    main(["generate", "--model", checkpoints["phi3"], "--max-len",
          str(MAX_LEN), "-c", "dtype=f32", "--device", "cpu",
          "--max-new-tokens", "5", "--prompt", "hello"])
    out = capsys.readouterr().out
    model, _ = _load("port", "transformers", checkpoints["phi3"])
    iface = TextInferenceInterface(model, max_len=MAX_LEN, device="cpu")
    tok = ByteTokenizer()
    want = tok.decode(list(iface.generate_tokens(
        np.asarray(tok.encode("hello"), np.int64)[None], 5)[0]))
    assert want in out
