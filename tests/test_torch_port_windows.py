"""Windowed decode on the port, against the JAX package.

Windowed decode runs a prompt's prefill and early decode steps in step
graphs built at smaller max_len values (`window_models`), growing the
caches to the next window when the position reaches it. On the CPU,
each package's Models are built from the same ONNX bytes (the JAX
package's recipes; a window's graph structure-only under
WeightStorage.none(), sharing the main model's TensorStore), at an f32
cache:

* a tiny GPT-2 (2 layers, n_embd 128, vocab 512) and the slice tests'
  tiny llama (2 layers, hidden 256, vocab 512), max_len 64, windows 16
  and 32, prompt buckets 8 and 16, weights and prompts from numpy with
  fixed seeds: the windowed greedy and DFA-constrained tokens equal the
  JAX package's windowed tokens and the port's flat ones, dense, int8
  and q4_0 (as tests/test_gpt2_e2e.py:234, test_compiler_quant.py:123,
  test_packed_matmul.py:241 hold the JAX package's); seeded sampling
  gives the flat run's tokens (the port's stream, which jax.random's
  does not match);
* the schedule: the prefill in the first window above the bucket, each
  decode step in the smallest window above its position, the caches
  grown with a zero tail;
* the upload: one weight upload, of the flat interface's bytes; a
  window's executor holds only its graph's constants;
* the refusals: logit_bias and adapters with windows, as in JAX;
* the stores' meta and zeros_getter (GPTQ, AWQ, a merged adapter) and
  build_from_gguf(zeros=True) against the JAX package's;
* both loaders' `decode_windows` (as tests/test_gpt2_e2e.py:273,
  test_llama_e2e.py:258, test_recipes_loaders.py:268): the JAX package's
  spec, its windowed tokens; none under ragged_decode, none for phi3;
* the batcher's window admission (tests/test_batching.py:990): k x
  bucket admission caches, tokens equal to sequential decoding, and to
  the JAX batcher's;
* `cli generate` and the Server's text interface on a windowed bundle.
"""

import json
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tests.test_torch_port_slice import CFG, _weights  # noqa: E402
from whisper_tensor_tpu import tokenizer as jax_tok  # noqa: E402
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers import gguf as jax_gguf  # noqa: E402
from whisper_tensor_tpu.importers import lora as jax_lora  # noqa: E402
from whisper_tensor_tpu.importers import quantized as jax_quantized  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.onnx_builder import (  # noqa: E402
    WeightStorage as JaxStorage)
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gguf_llama as jax_gguf_llama, gpt2 as jax_gpt2, llama as jax_llama)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    SamplingParams as JaxSamplingParams,
    TextInferenceInterface as JaxTextInterface)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch import tokenizer as port_tok  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers import gguf  # noqa: E402
from whisper_tensor_tpu_torch.importers import lora, quantized  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.onnx_builder import (  # noqa: E402
    WeightStorage)
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    gguf_llama)
from whisper_tensor_tpu_torch.importers.safetensors_io import (  # noqa: E402
    SafetensorsStore)
from whisper_tensor_tpu_torch.interfaces import text as text_mod  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    SamplingParams, TextInferenceInterface)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)
from whisper_tensor_tpu_torch.symbolic_graph.ir import (  # noqa: E402
    CONST_BAKE_MAX_ELEMENTS)

MAX_LEN, WINDOWS, BUCKETS = 64, (16, 32), (8, 16)
GPT2 = jax_gpt2.GPT2Config(n_layer=2, n_head=2, n_embd=128, vocab_size=512,
                           n_positions=MAX_LEN)
GPT2_W = jax_gpt2.random_gpt2_weights(GPT2, seed=3)
PROMPT = np.random.default_rng(6).integers(3, 259, (3, 6)).astype(np.int64)
N_NEW = 40                  # positions 6..44: windows 16, 32 and max_len
REGEX = r"[0-9]{2,5}(ab)*c"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the tiny graphs' ops are too small to split,
    and the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _numpy_quantize(monkeypatch):
    """The reference's quantize_int8 on its numpy path (the port copies
    that path; the native one's scales can differ in the last bit)."""
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)


def _recipe(model: str, max_len: int, per_row: bool = False,
            none: bool = False) -> bytes:
    """The JAX recipe's f32 ONNX bytes; `none`: structure only."""
    storage = JaxStorage.none() if none else None
    if model == "gpt2":
        return jax_gpt2.build_gpt2_step(GPT2_W, GPT2, max_len=max_len,
                                        pos_per_row=per_row, storage=storage)
    return jax_llama.build_llama_step(_weights, CFG, max_len=max_len,
                                      pos_per_row=per_row, storage=storage)


@pytest.fixture(scope="module")
def onnx():
    """{(model, max_len): ONNX bytes}: the main graph and its windows."""
    out = {}
    for m in ("gpt2", "llama"):
        out[m, MAX_LEN] = _recipe(m, MAX_LEN)
        for w in WINDOWS:
            out[m, w] = _recipe(m, w, none=True)
    return out


def _models(pkg_model, data: dict, model: str):
    """(main Model, {window: Model sharing its store}) of one package."""
    main = pkg_model.new_from_onnx(data[model, MAX_LEN])
    wins = {}
    for w in WINDOWS:
        wins[w] = pkg_model.new_from_onnx(data[model, w])
        wins[w].graph.store = main.graph.store
    return main, wins


def _ifaces(data, model: str, quantize=None):
    """(port windowed, port flat, JAX windowed) over one ONNX set."""
    pm, pw = _models(Model, data, model)
    jm, jw = _models(JaxModel, data, model)
    kw = dict(max_len=MAX_LEN, prompt_buckets=BUCKETS, quantize=quantize)
    return (TextInferenceInterface(pm, window_models=pw, device="cpu", **kw),
            TextInferenceInterface(pm, device="cpu", **kw),
            JaxTextInterface(jm, window_models=jw, **kw))


# -- tokens ------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8", "q4_0"])
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_windowed_tokens_equal_the_jax_packages_and_flat(onnx, model,
                                                         quantize):
    """Greedy, then under a DFA constraint: the port's windowed tokens
    equal its flat tokens and the JAX package's windowed tokens."""
    port, flat, ref = _ifaces(onnx, model, quantize)
    assert sorted(port._window_millis) == list(WINDOWS)
    assert bool(port._quantized) == (quantize == "int8")
    assert bool(port._packed) == (quantize == "q4_0")
    got = port.generate_tokens(PROMPT, N_NEW)
    np.testing.assert_array_equal(got, flat.generate_tokens(PROMPT, N_NEW))
    np.testing.assert_array_equal(got, ref.generate_tokens(PROMPT, N_NEW))
    port.tokenizer = flat.tokenizer = port_tok.ByteTokenizer()
    ref.tokenizer = jax_tok.ByteTokenizer()
    port.eos_token_id = flat.eos_token_id = ref.eos_token_id = 2
    dfa = port.compile_constraint(regex=REGEX)
    got = port.generate_tokens(PROMPT, N_NEW, constraint=dfa)
    np.testing.assert_array_equal(
        got, flat.generate_tokens(PROMPT, N_NEW, constraint=dfa))
    np.testing.assert_array_equal(got, ref.generate_tokens(
        PROMPT, N_NEW, constraint=ref.compile_constraint(regex=REGEX)))


@pytest.mark.parametrize("model,quantize", [
    ("gpt2", None), ("gpt2", "int8"), ("gpt2", "q4_0"), ("llama", None)])
def test_seeded_sampling_gives_the_flat_runs_tokens(onnx, model, quantize):
    """The windowed loop draws the flat loop's stream (the reference's
    windowed program folds the flat program's keys, :1013-1014)."""
    port, flat, _ = _ifaces(onnx, model, quantize)
    for sp in (SamplingParams(temperature=0.9, top_k=20, seed=3),
               SamplingParams(temperature=1.1, top_p=0.9, seed=5,
                              repetition_penalty=1.2)):
        np.testing.assert_array_equal(
            port.generate_tokens(PROMPT, N_NEW, sampling=sp),
            flat.generate_tokens(PROMPT, N_NEW, sampling=sp))


def test_the_jax_packages_windowed_sampling_equals_its_flat(onnx):
    """The property the port keeps, on the JAX package itself."""
    _, _, ref = _ifaces(onnx, "gpt2")
    jm = JaxModel.new_from_onnx(onnx["gpt2", MAX_LEN])
    flat = JaxTextInterface(jm, max_len=MAX_LEN, prompt_buckets=BUCKETS)
    sp = JaxSamplingParams(temperature=0.9, top_k=20, seed=3)
    np.testing.assert_array_equal(
        ref.generate_tokens(PROMPT, 30, sampling=sp),
        flat.generate_tokens(PROMPT, 30, sampling=sp))


@pytest.mark.parametrize("L,n_new", [(6, 40), (6, 1), (6, 10), (12, 25),
                                     (16, 30)])
def test_the_schedule_and_the_grown_caches(onnx, L, n_new):
    """The prefill runs in the first window above max(bucket, L); each
    decode step in the smallest window above its position; the caches
    grow with a zero tail; the tokens are the flat run's."""
    port, flat, _ = _ifaces(onnx, "gpt2")
    prompt = np.random.default_rng(L).integers(3, 500, (2, L)).astype(
        np.int64)
    calls = []
    inner = port.step

    def spy(ids, pos, caches, lora_idx=None, window=None):
        p, s = int(pos.reshape(-1)[0]), ids.shape[1]
        # the slots past those the prefill's bucket and the steps wrote
        # are zero
        written = max(p + s, calls[0][0] if calls else 0)
        calls.append((s, p, window, caches[0].shape[2],
                      bool(caches[0][:, :, written:].eq(0).all())))
        return inner(ids, pos, caches, lora_idx, window)

    port.step = spy
    got = port.generate_tokens(prompt, n_new)
    np.testing.assert_array_equal(got, flat.generate_tokens(prompt, n_new))
    S = 8 if L <= 8 else 16
    wins = [w for w in WINDOWS if w > S] + [MAX_LEN]
    assert calls[0][:4] == (S, 0, wins[0], wins[0])
    for s, p, w, length, tail in calls[1:]:
        assert s == 1 and w == min(x for x in wins if x > p) == length
        assert tail
    assert [c[1] for c in calls[1:]] == list(range(L, L + n_new - 1))


def test_one_upload_of_the_flat_interfaces_weights(onnx, monkeypatch):
    """The windowed interface uploads its weights once, the flat
    interface's set, bytes for bytes (no window graph's initializers),
    and its window executors hold only their graphs' constants (the bake
    limit's small ones, as the main graph's), never a weight."""
    uploads = {}
    real = text_mod.carry_weights

    def spy(arrays, dtypes, device):
        uploads.setdefault(spy.who, []).append(
            sum(np.asarray(a).nbytes for a in arrays.values()))
        return real(arrays, dtypes, device)

    monkeypatch.setattr(text_mod, "carry_weights", spy)
    port, flat, _ = _ifaces(onnx, "llama", "int8")
    for spy.who, iface in (("windowed", port), ("flat", flat)):
        iface.generate_tokens(PROMPT, N_NEW)
    assert len(uploads["windowed"]) == len(uploads["flat"]) == 1
    assert uploads["windowed"] == uploads["flat"]
    mine, theirs = port._weights(), flat._weights()
    assert sorted(mine) == sorted(theirs)
    big = min(t.numel() for t in mine.values() if t.dim() == 2)
    assert big > CONST_BAKE_MAX_ELEMENTS
    seen = 0
    for ex in port._window_exec.values():
        for plan in ex._plans.values():
            seen += 1
            assert all(c.numel() <= CONST_BAKE_MAX_ELEMENTS
                       for c in plan.consts.values())
    assert seen >= 3          # the 16 prefill and decode, the 32 decode


def test_share_weights_takes_a_dense_fused_weight(onnx):
    """share_weights between two dense interfaces with fused q/k/v and
    gate/up weights (as a windowed interface and a flat one share their
    device weights): every weight is the first's device tensor. A dense
    fused weight's shape was looked up in the model's graph, which has
    only its members, and raised a KeyError."""
    model = Model.new_from_onnx(onnx["llama", MAX_LEN])
    port, flat = (TextInferenceInterface(model, max_len=MAX_LEN,
                                         prompt_buckets=BUCKETS,
                                         device="cpu") for _ in range(2))
    assert any(n in port._fused for n in port.weight_names)
    flat.share_weights(port)
    mine, theirs = port._weights(), flat._weights()
    assert all(mine[n].data_ptr() == theirs[n].data_ptr() for n in mine)
    np.testing.assert_array_equal(flat.generate_tokens(PROMPT, 12),
                                  port.generate_tokens(PROMPT, 12))


def test_window_cache_dims_are_the_jax_packages(onnx):
    port, _, ref = _ifaces(onnx, "llama")
    for w in WINDOWS:
        assert port.window_cache_dims(3, w) == ref.window_cache_dims(3, w)
        assert all(d[2] == w for d in port.window_cache_dims(3, w))


# -- refusals ----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_logit_bias_and_adapters_are_refused_with_windows(onnx, pkg):
    port, _, ref = _ifaces(onnx, "gpt2")
    iface = port if pkg == "port" else ref
    with pytest.raises(ValueError, match="logit_bias is not supported with "
                                         "windowed decode"):
        iface.generate_tokens(PROMPT, 4, logit_bias=np.zeros(512, np.float32))
    with pytest.raises(ValueError, match="adapters \\+ windowed decode"):
        iface.install_adapters({})
    # given caches, the decode is flat, and a bias is taken
    caches = iface.fresh_cache(PROMPT.shape[0])
    bias = np.zeros(512, np.float32)
    bias[7] = 100.0
    assert (np.asarray(iface.generate_tokens(PROMPT, 3, caches=caches,
                                             logit_bias=bias)) == 7).all()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_window_of_another_recipe_is_refused(onnx, pkg):
    mod, kw = ((Model, {"device": "cpu"}) if pkg == "port"
               else (JaxModel, {}))
    iface = TextInferenceInterface if pkg == "port" else JaxTextInterface
    main = mod.new_from_onnx(onnx["gpt2", MAX_LEN])
    other = mod.new_from_onnx(onnx["llama", 32])
    other.graph.store = main.graph.store
    with pytest.raises((ValueError, KeyError)):
        iface(main, max_len=MAX_LEN, window_models={32: other}, **kw)


# -- the stores and the GGUF recipe -----------------------------------------------

def _quantized_dir(tmp_path, method):
    from tests.test_gptq_awq import _write_quantized_llama

    d, _ = _write_quantized_llama(tmp_path, method)
    return d


@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_quantized_store_meta_and_zeros_are_the_jax_packages(tmp_path,
                                                             method):
    from whisper_tensor_tpu.importers.safetensors_io import (
        SafetensorsStore as JaxStore)

    d = _quantized_dir(tmp_path, method)
    cfg = json.loads((d / "config.json").read_text())
    spec = quantized.parse_quantization_config(cfg)
    port = quantized.QuantizedStore(SafetensorsStore.from_dir(str(d)), spec)
    ref = jax_quantized.QuantizedStore(
        JaxStore.from_dir(str(d)), jax_quantized.parse_quantization_config(
            cfg))
    pz, rz = port.zeros_getter(), ref.zeros_getter()
    names = list(ref.names())
    assert names == list(port.names()) and any(
        n.endswith("q_proj.weight") for n in names)
    for n in names:
        assert port.meta(n) == ref.meta(n)
        a, b = pz(n), rz(n)
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()
        assert a.shape == port.load(n).shape
    # linear=False (GPT-2's Conv1D layout): the transposed shape
    flat = quantized.QuantizedStore(SafetensorsStore.from_dir(str(d)), spec,
                                    linear=False)
    n = next(n for n in names if n.endswith("q_proj.weight"))
    assert flat.meta(n)[0] == port.meta(n)[0][::-1] == flat.load(n).shape


def test_lora_store_meta_and_zeros_are_the_jax_packages(tmp_path):
    from whisper_tensor_tpu.importers.safetensors_io import (
        SafetensorsStore as JaxStore)
    from tests.test_torch_port_routes import _write_tiny_gpt2

    d = _write_tiny_gpt2(tmp_path / "gpt2", n_positions=64)
    rng = np.random.default_rng(4)
    ad = lora.save_peft_adapter(
        {"h0_attn_qkv_w::lora_a": rng.standard_normal((16, 4)).astype(
            np.float32),
         "h0_attn_qkv_w::lora_b": rng.standard_normal((4, 48)).astype(
             np.float32)},
        {"h0_attn_qkv_w": "h.0.attn.c_attn.weight"}, 4,
        str(tmp_path / "adapter"))
    port = lora.LoraMergedStore(SafetensorsStore.from_dir(d), ad)
    ref = jax_lora.LoraMergedStore(JaxStore.from_dir(d), ad)
    assert port.merged_modules == ref.merged_modules != []
    pz, rz = port.zeros_getter(), ref.zeros_getter()
    for n in ref.names():
        assert port.meta(n) == ref.meta(n)
        assert pz(n).shape == rz(n).shape == port.load(n).shape
        assert pz(n).dtype == rz(n).dtype and not pz(n).any()


def _llama_gguf(tmp_path, fmt="Q4_0"):
    """The packed tests' tiny qwen2 GGUF (llama family, rows as the
    recipe reads them in both packages)."""
    from tests.test_torch_port_packed import _write_gguf
    from whisper_tensor_tpu_torch.packed_format import PackedFormat

    return _write_gguf(tmp_path / "tiny.gguf", "qwen2",
                       lambda n: PackedFormat[fmt])


def _gemma_gguf(tmp_path, arch):
    from tests.test_torch_port_gemma_phi3 import _write_gguf

    return _write_gguf(tmp_path / f"{arch}.gguf", arch)


@pytest.mark.parametrize("arch", ["qwen2", "gemma2"])
def test_build_from_gguf_zeros_writes_the_jax_packages_bytes(tmp_path, arch):
    path = (_llama_gguf(tmp_path) if arch == "qwen2"
            else _gemma_gguf(tmp_path, arch))
    got, geo = gguf_llama.build_from_gguf(
        gguf.GGUFFile(path), max_len=16, dtype=DType.F32, zeros=True,
        storage=WeightStorage.none())
    want, jgeo = jax_gguf_llama.build_from_gguf(
        jax_gguf.GGUFFile(path), max_len=16, dtype=JaxDType.F32, zeros=True,
        storage=JaxStorage.none())
    assert got == want and geo == jgeo
    # structure only: smaller than the embedded build by the weights
    full, _ = gguf_llama.build_from_gguf(gguf.GGUFFile(path), max_len=16,
                                         dtype=DType.F32)
    assert len(got) < len(full) // 4


# -- the loaders -------------------------------------------------------------------

def _hf_llama(tmp_path):
    """A tiny HF llama dir (the reference's tests/test_llama_e2e.py
    make_tiny widths), written by transformers."""
    from tests.test_llama_e2e import make_tiny

    hf, _, _ = make_tiny("llama")
    d = tmp_path / "tiny-llama-w"
    hf.save_pretrained(str(d), safe_serialization=True)
    return str(d)


def _loaded(pkg, loader, path, **cfg):
    reg = loader_registry() if pkg == "port" else jax_loaders()
    return reg[loader].load({"path": path, "dtype": "f32",
                             "max_len": MAX_LEN, **cfg})


def _from_bundle(pkg, bundle, **kw):
    spec = bundle.interfaces["text"]
    wins = {int(w): bundle.models[m]
            for w, m in (spec.get("windows") or {}).items()}
    if pkg == "port":
        return TextInferenceInterface(
            bundle.models[spec["model"]], max_len=MAX_LEN,
            prompt_buckets=BUCKETS, window_models=wins or None,
            device="cpu", **kw)
    return JaxTextInterface(bundle.models[spec["model"]], max_len=MAX_LEN,
                            prompt_buckets=BUCKETS,
                            window_models=wins or None, **kw)


def _check_loader(pkg_bundles, quantize=None, vocab=None):
    """The port's spec names the JAX package's windows; windowed tokens
    equal the JAX package's windowed tokens and the port's flat ones."""
    (pw, pf), (jw, _) = pkg_bundles
    spec, jspec = pw.interfaces["text"], jw.interfaces["text"]
    assert spec["windows"] == jspec["windows"] != {}
    assert sorted(pw.models) == sorted(jw.models)
    assert pf.interfaces["text"]["windows"] == {}
    kw = dict(quantize=quantize)
    port = _from_bundle("port", pw, **kw)
    assert sorted(port._window_millis) == sorted(map(int, spec["windows"]))
    prompt = PROMPT % (vocab or 259)
    got = port.generate_tokens(prompt, N_NEW)
    np.testing.assert_array_equal(
        got, _from_bundle("port", pf, **kw).generate_tokens(prompt, N_NEW))
    np.testing.assert_array_equal(
        got, _from_bundle("jax", jw, **kw).generate_tokens(prompt, N_NEW))


def _bundles(loader, path, **cfg):
    return [(_loaded(p, loader, path, decode_windows="16,32", **cfg),
             _loaded(p, loader, path, **cfg)) for p in ("port", "jax")]


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_transformers_decode_windows(tmp_path, model, quantize):
    from tests.test_torch_port_routes import _write_tiny_gpt2

    path = (_write_tiny_gpt2(tmp_path / "gpt2", n_positions=MAX_LEN)
            if model == "gpt2" else _hf_llama(tmp_path))
    _check_loader(_bundles("transformers", path), quantize,
                  vocab=300 if model == "gpt2" else 101)


def test_transformers_decode_windows_over_gptq_and_a_merged_adapter(
        tmp_path):
    """The QuantizedStore's and the LoraMergedStore's zeros_getter build
    the windows; the windowed tokens are the flat ones and the JAX
    package's (packed GPTQ weights)."""
    d = _quantized_dir(tmp_path, "gptq")
    _check_loader(_bundles("transformers", str(d)), vocab=130)
    from tests.test_torch_port_routes import _write_tiny_gpt2

    g = _write_tiny_gpt2(tmp_path / "gpt2", n_positions=MAX_LEN)
    rng = np.random.default_rng(9)
    ad = lora.save_peft_adapter(
        {"h0_attn_qkv_w::lora_a": rng.standard_normal((16, 4)).astype(
            np.float32),
         "h0_attn_qkv_w::lora_b": rng.standard_normal((4, 48)).astype(
             np.float32)},
        {"h0_attn_qkv_w": "h.0.attn.c_attn.weight"}, 4,
        str(tmp_path / "adapter"))
    _check_loader(_bundles("transformers", g, lora=ad), vocab=300)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_gguf_decode_windows(tmp_path, packed):
    path = _llama_gguf(tmp_path)
    _check_loader(_bundles("gguf", path, packed_weights=packed), vocab=259)


def test_gguf_gemma2_decode_windows(tmp_path):
    _check_loader(_bundles("gguf", _gemma_gguf(tmp_path, "gemma2")),
                  vocab=259)


@pytest.mark.parametrize("case", ["transformers-ragged", "gguf-ragged",
                                  "gguf-phi3", "transformers-phi3",
                                  "above-max_len"])
def test_where_the_loaders_build_no_windows(tmp_path, case):
    """No windows under ragged_decode, for phi3, or at sizes outside
    (0, max_len), in both packages alike."""
    from tests.test_torch_port_gemma_phi3 import CONFIGS, WEIGHTS
    from tests.test_torch_port_routes import _write_tiny_gpt2
    from safetensors.numpy import save_file

    cfg = {"decode_windows": "16,32"}
    if case == "transformers-ragged":
        loader, path = "transformers", _write_tiny_gpt2(tmp_path / "g", 64)
        cfg["ragged_decode"] = True
    elif case == "gguf-ragged":
        loader, path = "gguf", _llama_gguf(tmp_path)
        cfg["ragged_decode"] = True
    elif case == "gguf-phi3":
        loader, path = "gguf", _gemma_gguf(tmp_path, "phi3")
    elif case == "transformers-phi3":
        loader, path = "transformers", str(tmp_path / "phi3")
        (tmp_path / "phi3").mkdir()
        (tmp_path / "phi3" / "config.json").write_text(json.dumps(
            {k: v for k, v in CONFIGS["phi3"].items() if v is not None}))
        save_file(WEIGHTS["phi3"], str(tmp_path / "phi3" /
                                       "model.safetensors"))
    else:
        loader, path = "transformers", _write_tiny_gpt2(tmp_path / "g", 64)
        cfg["decode_windows"] = "0,64,100"
    for pkg in ("port", "jax"):
        b = _loaded(pkg, loader, path, **cfg)
        assert b.interfaces["text"].get("windows") == {}
        assert len(b.models) == 1


# -- the batcher -------------------------------------------------------------------

def _batcher_models(pkg_model):
    data = {n: _recipe("gpt2", n, per_row=True, none=n != MAX_LEN)
            for n in (MAX_LEN, 16)}
    ragged = pkg_model.new_from_onnx(data[MAX_LEN])
    w16 = pkg_model.new_from_onnx(data[16], name="w16")
    w16.graph.store = ragged.graph.store
    return ragged, {16: w16}


def test_window_admission_matches_sequential_and_the_jax_batcher():
    """Bucket-16 admissions prefill into k x 16 caches (window_cache_dims)
    and write them into the slots' first 16 positions; positions past
    the bucket keep the previous tenant's keys and values behind the
    position mask. Two rounds, so slots are reused across the stale
    region: every request's tokens equal sequential decoding, and the
    JAX batcher's."""
    ragged, wins = _batcher_models(Model)
    iface = TextInferenceInterface(ragged, max_len=MAX_LEN,
                                   prompt_buckets=(16, 32),
                                   window_models=wins, device="cpu")
    ref = TextInferenceInterface(
        Model.new_from_onnx(_recipe("gpt2", MAX_LEN)), max_len=MAX_LEN,
        prompt_buckets=(16, 32), device="cpu")
    jragged, jwins = _batcher_models(JaxModel)
    jiface = JaxTextInterface(jragged, max_len=MAX_LEN,
                              cache_dtype=JaxDType.F32,
                              prompt_buckets=(16, 32), window_models=jwins)
    admitted = []
    inner = iface.step

    def spy(ids, pos, caches, lora_idx=None, window=None):
        if ids.shape[1] > 1:
            admitted.append((ids.shape[1], window,
                             tuple(tuple(c.shape) for c in caches)))
        return inner(ids, pos, caches, lora_idx, window)

    iface.step = spy
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int64)
               for n in (3, 7, 12, 5, 9, 14, 20)]
    outs = {}
    for key, b in (("port", ContinuousBatcher(None, max_len=MAX_LEN,
                                              max_batch=4, chunk=4,
                                              iface=iface, max_admit=2)),
                   ("jax", JaxBatcher(None, max_len=MAX_LEN, max_batch=4,
                                      chunk=4, iface=jiface, max_admit=2))):
        b.start()
        try:
            outs[key] = []
            for _ in range(2):
                futs = [b.submit(p, 9) for p in prompts]
                outs[key] += [f.result(timeout=120) for f in futs]
        finally:
            b.stop()
    for p, got, want in zip(prompts * 2, outs["port"], outs["jax"]):
        np.testing.assert_array_equal(got, ref.generate_tokens(p[None],
                                                               9)[0])
        np.testing.assert_array_equal(got, want)
    # the bucket-16 admissions ran the window graph over k x 16 caches;
    # the bucket-32 one (20 tokens) the main graph over k x max_len
    assert {(s, w) for s, w, _ in admitted} == {(16, 16), (32, None)}
    for s, w, shapes in admitted:
        length = 16 if w == 16 else MAX_LEN
        assert all(sh[0] <= 2 and sh[2] == length for sh in shapes)
        if w == 16:
            assert list(shapes) == iface.window_cache_dims(shapes[0][0], 16)


def test_no_window_admission_with_a_prefix():
    """A configured prefix (plen > 0) admits at full length, as the
    reference's window branch needs plen == 0."""
    ragged, wins = _batcher_models(Model)
    iface = TextInferenceInterface(ragged, max_len=MAX_LEN,
                                   prompt_buckets=(16, 32),
                                   window_models=wins, device="cpu")
    prefix = np.arange(3, 8, dtype=np.int64)
    ref = TextInferenceInterface(
        Model.new_from_onnx(_recipe("gpt2", MAX_LEN)), max_len=MAX_LEN,
        prompt_buckets=(16, 32), device="cpu")
    seen = []
    inner = iface.step

    def spy(ids, pos, caches, lora_idx=None, window=None):
        seen.append(window)
        return inner(ids, pos, caches, lora_idx, window)

    iface.step = spy
    b = ContinuousBatcher(None, max_len=MAX_LEN, max_batch=2, chunk=4,
                          iface=iface, prefix_ids=prefix).start()
    try:
        p = np.arange(20, 26, dtype=np.int64)
        got = b.submit(p, 6).result(timeout=120)
    finally:
        b.stop()
    np.testing.assert_array_equal(got, ref.generate_tokens(
        np.concatenate([prefix, p])[None], 6)[0])
    assert set(seen) == {None}


# -- the CLI and the Server ----------------------------------------------------------

def test_cli_generate_serves_a_windowed_bundle(tmp_path, capsys):
    """`generate -c decode_windows=16,32` prints the JAX package's CLI's
    text and the port's flat text (greedy, f32)."""
    from tests.test_torch_port_routes import _write_tiny_gpt2
    from whisper_tensor_tpu.cli import main as jax_main
    from whisper_tensor_tpu_torch.cli import main

    d = _write_tiny_gpt2(tmp_path / "gpt2", n_positions=MAX_LEN, seed=0)
    args = ["generate", "--model", d, "--prompt", "hi there", "--max-len",
            str(MAX_LEN), "--max-new-tokens", "40", "-c", "dtype=f32"]
    main(args + ["--device", "cpu"])
    flat = capsys.readouterr().out
    main(args + ["-c", "decode_windows=16,32", "--device", "cpu"])
    got = capsys.readouterr().out
    jax_main(args + ["-c", "decode_windows=16,32"])
    want = capsys.readouterr().out
    assert got == want == flat and got.strip()


def test_the_servers_text_interface_serves_a_windowed_bundle(tmp_path):
    """The Server builds the text interface with the bundle's windows
    (its own bundle's, by name) and answers as the JAX server does."""
    from tests.test_torch_port_routes import _write_tiny_gpt2
    from whisper_tensor_tpu.server.main import Server as JaxServer
    from whisper_tensor_tpu_torch.server.main import Server

    d = _write_tiny_gpt2(tmp_path / "gpt2", n_positions=MAX_LEN, seed=0)
    cfg = {"path": d, "dtype": "f32", "max_len": MAX_LEN,
           "decode_windows": "16,32"}
    texts = {}
    for key, srv in (("port", Server(device="cpu")), ("jax", JaxServer())):
        # a second load of the same dir: its windows have the same names
        srv.models.run_loader("transformers", dict(cfg))
        entries = srv.models.run_loader("transformers", dict(cfg))
        main = next(e for e in entries if e.name == entries[0].interfaces[
            "text"]["model"])
        iface = srv._text_iface(main)
        assert sorted(iface._window_millis) == [16, 32]
        if key == "port":
            mine = {e.model for e in entries}
            assert all(m in mine for m in iface.window_models.values())
        texts[key] = np.asarray(iface.generate_tokens(
            np.asarray([list(b"hi there")], np.int64) + 3, 40))
    np.testing.assert_array_equal(texts["port"], texts["jax"])
