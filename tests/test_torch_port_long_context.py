"""The port's long-context path against the JAX package.

A tiny llama (the slice tests' widths: 2 layers, hidden 256, 2 query
heads and 1 KV head of 128, vocab 512; weights and prompts from numpy
with fixed seeds) runs through both packages' TextInferenceInterface:

* `build_llama_step(logits_last_only=True)` writes the same ONNX bytes in
  both packages; where the prompt fills its bucket the port's last-only
  graph gives the JAX package's greedy tokens and logits, and its logits
  equal its full graph's last row (as tests/test_llama_e2e.py:288 holds
  the JAX package's). Where the prompt is shorter than its bucket, the
  JAX package clamps the index and answers from the bucket's last
  position, which differs from its full graph's answer; the port raises
  a ValueError naming logits_last_only there and on every route that
  reads another position (logits(), scoring, the speculative verify, the
  batcher's admission, with and without prefill_chunk).
* `quantize_precomputed`: a sibling at another max_len takes the first
  interface's int8 weights (after its upload, its very device tensors)
  and gives a fresh int8 build's logits exactly (as
  tests/test_compiler_quant.py:159 holds the JAX package's).
* `fuse_matmuls=False` keeps the JAX package's unfused graph, node kind
  for node kind, and its tokens (as tests/test_fuse_matmuls.py).
* `mode="oracle"` of the TTS and image interfaces gives the JAX
  package's oracle outputs; `QuantizedStore.getter(transform)` and
  `Seq2SeqInterface.encode(input_ids=)` take the JAX package's
  parameters.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tests.test_torch_port_slice import CFG, _weights  # noqa: E402
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    llama as jax_llama)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxTextInterface)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    llama)
from whisper_tensor_tpu_torch.interfaces.speculative import (  # noqa: E402
    SpeculativeDecoder)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)

MAX_LEN, BUCKET = 64, 16
# a prompt that fills its bucket, and one that does not
FULL = np.random.default_rng(21).integers(3, 500, (2, BUCKET)).astype(
    np.int64)
SHORT = FULL[:, :11]


def _close(got, want, frac=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.fixture(scope="module")
def onnx():
    """{(last_only, max_len): the JAX recipe's f32 ONNX bytes}."""
    return {(last, n): jax_llama.build_llama_step(
        _weights, CFG, max_len=n, logits_last_only=last)
        for last in (False, True) for n in (MAX_LEN, 48)}


def _port(data, max_len=MAX_LEN, **kw):
    return TextInferenceInterface(Model.new_from_onnx(data), max_len=max_len,
                                  prompt_buckets=(BUCKET,), device="cpu",
                                  **kw)


def _jax(data, max_len=MAX_LEN, **kw):
    return JaxTextInterface(JaxModel.new_from_onnx(data), max_len=max_len,
                            prompt_buckets=(BUCKET,), **kw)


# -- the recipe ------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dt", ["F32", "BF16"])
def test_last_only_recipe_writes_the_jax_recipes_bytes(dt, per_row):
    kw = dict(max_len=MAX_LEN, pos_per_row=per_row, logits_last_only=True)
    got = llama.build_llama_step(_weights, CFG, dtype=DType[dt], **kw)
    want = jax_llama.build_llama_step(_weights, CFG, dtype=JaxDType[dt],
                                      **kw)
    assert got == want
    # and the option changes the graph
    assert got != llama.build_llama_step(
        _weights, CFG, dtype=DType[dt], max_len=MAX_LEN,
        pos_per_row=per_row)


def test_the_interface_reads_the_declared_logits(onnx):
    assert _port(onnx[True, MAX_LEN]).logits_last_only
    assert not _port(onnx[False, MAX_LEN]).logits_last_only


# -- reading a last-only graph ---------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_a_full_bucket_gives_the_jax_packages_tokens(onnx, quantize):
    port = _port(onnx[True, MAX_LEN], quantize=quantize)
    ref = _jax(onnx[True, MAX_LEN], quantize=quantize)
    want = ref.generate_tokens(FULL, 10)
    np.testing.assert_array_equal(port.generate_tokens(FULL, 10), want)
    np.testing.assert_array_equal(
        _port(onnx[False, MAX_LEN], quantize=quantize).generate_tokens(
            FULL, 10), want)
    # the logits each token was picked from: the first from the
    # last-only prefill, against the JAX package's full graph
    _, logits = port.generate_with_logits(FULL, 3)
    full = _jax(onnx[False, MAX_LEN], quantize=quantize).logits(FULL)
    _close(logits[:, 0], np.asarray(full)[:, -1])


def test_last_only_logits_equal_the_full_graphs_last_row(onnx):
    """The mirror of tests/test_llama_e2e.py:288 on the port's step."""
    rows = {}
    for last in (False, True):
        iface = _port(onnx[last, MAX_LEN])
        pos = torch.zeros((), dtype=torch.int64)
        rows[last] = iface.step(torch.from_numpy(FULL), pos,
                                iface.fresh_cache(2)).numpy()
    assert rows[True].shape == (2, 1, CFG.vocab_size)
    np.testing.assert_allclose(rows[True][:, 0], rows[False][:, -1],
                               rtol=1e-5, atol=1e-5)


def test_the_beam_prefill_reads_a_full_bucket(onnx):
    got = _port(onnx[True, MAX_LEN]).beam_search_tokens(FULL, 5, beam=3)
    want = _port(onnx[False, MAX_LEN]).beam_search_tokens(FULL, 5, beam=3)
    np.testing.assert_array_equal(got, want)


def test_decode_tokens_continue_a_last_only_model(onnx):
    """decode_tokens runs one-token steps only, whose one position is the
    last: the same tokens on either graph."""
    out = []
    for last in (False, True):
        iface = _port(onnx[last, MAX_LEN])
        caches = iface.fresh_cache(2)
        iface.generate_tokens(FULL, 1, caches=caches)
        out.append(iface.decode_tokens(FULL[:, -1], BUCKET, caches, 6))
    np.testing.assert_array_equal(out[0], out[1])


def test_a_shorter_prompt_raises_where_the_jax_package_answers_wrong(onnx):
    with pytest.raises(ValueError, match="logits_last_only"):
        _port(onnx[True, MAX_LEN]).generate_tokens(SHORT, 4)
    with pytest.raises(ValueError, match="logits_last_only"):
        _port(onnx[True, MAX_LEN]).beam_search_tokens(SHORT, 4, beam=2)
    # the JAX package reads the bucket's last position, not the prompt's
    last = _jax(onnx[True, MAX_LEN])
    full = _jax(onnx[False, MAX_LEN])
    right = np.asarray(full.logits(SHORT))[:, -1]
    padded = np.pad(SHORT, ((0, 0), (0, BUCKET - SHORT.shape[1])))
    wrong = np.asarray(full.logits(padded))[:, -1]
    assert not np.allclose(right, wrong, atol=1e-3)
    np.testing.assert_array_equal(last.generate_tokens(SHORT, 1)[:, 0],
                                  wrong.argmax(-1))
    # the port's full graph answers from the prompt's own last position
    np.testing.assert_array_equal(
        _port(onnx[False, MAX_LEN]).generate_tokens(SHORT, 1)[:, 0],
        right.argmax(-1))


def _route(name, iface, onnx):
    if name == "logits":
        return iface.logits(FULL)
    if name == "scoring":
        return iface.sequence_scores(FULL, [1, 1], [BUCKET, BUCKET])
    if name == "speculative":
        return SpeculativeDecoder(iface, _port(onnx[False, MAX_LEN]), k=2)
    kw = {"prefill_chunk": 4} if name == "prefill_chunk" else {}
    return ContinuousBatcher(None, max_len=MAX_LEN, iface=iface,
                             prompt_buckets=(BUCKET,), **kw)


@pytest.mark.parametrize("route", ["logits", "scoring", "speculative",
                                   "batcher", "prefill_chunk"])
def test_each_route_that_reads_another_position_raises(onnx, route):
    with pytest.raises(ValueError, match="logits_last_only"):
        _route(route, _port(onnx[True, MAX_LEN]), onnx)
    # the same route takes the full graph
    _route(route, _port(onnx[False, MAX_LEN]), onnx)


# -- int8 weights shared between siblings ------------------------------------------

def test_quantize_precomputed_shares_the_first_interfaces_tensors(onnx):
    first = _port(onnx[False, MAX_LEN], quantize="int8")
    before = _port(onnx[False, 48], quantize="int8",
                   quantize_precomputed=first._quantized)
    l_first = first.logits(FULL)
    # after the upload the dict holds the first's device tensors
    dev = first._weights()
    assert all(p[0] is dev[n] and p[1] is dev[n + "::scale"]
               for n, p in first._quantized.items())
    shared = _port(onnx[False, 48], quantize="int8",
                   quantize_precomputed=first._quantized)
    fresh = _port(onnx[False, 48], quantize="int8")
    assert set(shared._quantized) == set(fresh._quantized) == set(dev) & set(
        first._quantized)
    np.testing.assert_array_equal(shared.logits(FULL), fresh.logits(FULL))
    _close(shared.logits(FULL), l_first, 1e-4)
    mine = shared._weights()
    for n in first._quantized:
        for k in (n, n + "::scale"):
            assert mine[k].data_ptr() == dev[k].data_ptr(), k
    # the rope tables differ with max_len: the sibling's own
    assert mine["rope_cos"].shape[0] == 48
    # a sibling built before the upload took host arrays: its own copy
    np.testing.assert_array_equal(before.logits(FULL), fresh.logits(FULL))
    n = next(iter(first._quantized))
    assert before._weights()[n].data_ptr() != dev[n].data_ptr()
    # the JAX package's sibling, built the same way
    ref_first = _jax(onnx[False, MAX_LEN], quantize="int8")
    ref_first.logits(FULL)
    ref = _jax(onnx[False, 48], quantize="int8",
               quantize_precomputed=ref_first._quantized)
    _close(shared.logits(FULL), ref.logits(FULL), 1e-4)
    np.testing.assert_array_equal(shared.generate_tokens(FULL, 6),
                                  ref.generate_tokens(FULL, 6))


def test_share_weights_keeps_a_siblings_own_shapes(onnx):
    first = _port(onnx[False, MAX_LEN], quantize="int8")
    sib = _port(onnx[False, 48], quantize="int8")
    sib.share_weights(first)
    dev, mine = first._weights(), sib._weights()
    assert mine["embed_tokens"].data_ptr() == dev["embed_tokens"].data_ptr()
    assert mine["rope_cos"].shape[0] == 48
    np.testing.assert_array_equal(
        sib.logits(FULL), _port(onnx[False, 48], quantize="int8").logits(
            FULL))


# -- fuse_matmuls ----------------------------------------------------------------

def _kinds(milli):
    return [n.op.KIND for n in milli.nodes]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_fuse_matmuls_off_is_the_jax_packages_unfused_graph(onnx, quantize):
    data = onnx[False, MAX_LEN]
    port = _port(data, quantize=quantize, fuse_matmuls=False)
    ref = _jax(data, quantize=quantize, fuse_matmuls=False)
    assert not port._fused and not ref._fused
    assert _kinds(port.milli) == _kinds(ref.milli)
    assert list(port.milli.inputs) == list(ref.milli.inputs)
    per_layer = 7 if quantize is None else 5    # int8 skips small k, v
    kind = "MatMul" if quantize is None else "QuantMatMul"
    assert _kinds(port.milli).count(kind) >= per_layer * 2
    fused = _port(data, quantize=quantize)
    assert fused._fused and _kinds(fused.milli).count("Split") >= 4
    assert _kinds(fused.milli) == _kinds(_jax(data, quantize=quantize,
                                              fuse_matmuls=True).milli)
    want = ref.generate_tokens(FULL, 8)
    np.testing.assert_array_equal(port.generate_tokens(FULL, 8), want)
    if quantize is None:
        # exact math either way (int8 quantizes the small k, v only
        # once they ride a fused matrix)
        np.testing.assert_array_equal(fused.generate_tokens(FULL, 8), want)
        _close(fused.logits(FULL), port.logits(FULL))


# -- the other parameters ----------------------------------------------------------

@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    from tests import torch_tts_sets as sets

    root = tmp_path_factory.mktemp("tts")
    out = {}
    for name, write in (("piper", sets.write_piper_voice),
                        ("kokoro", sets.write_kokoro_dir),
                        ("f5", sets.write_f5_dir)):
        d = root / name
        d.mkdir()
        write(str(d))
        out[name] = str(d)
    return out


@pytest.mark.parametrize("engine", ["piper", "kokoro", "f5"])
def test_tts_oracle_mode_gives_the_jax_packages_oracle(voices, engine):
    from whisper_tensor_tpu.importers.loaders import (
        identify_and_load as jax_load)
    from whisper_tensor_tpu.interfaces import tts as jax_tts
    from whisper_tensor_tpu.super_graph.links import AudioClip as JaxClip
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces import tts
    from whisper_tensor_tpu_torch.super_graph.links import AudioClip

    port = tts.TextToSpeechInterface.from_bundle(
        identify_and_load(voices[engine]), mode="oracle")
    ref = jax_tts.TextToSpeechInterface.from_bundle(
        jax_load(voices[engine]), mode="oracle")
    ref_audio = np.sin(np.linspace(0, 20, 400)).astype(np.float32)
    if engine == "f5":
        assert port.device.type == "cpu" and port.mode == "oracle"
        got = port.run_text_to_audio("tab up", AudioClip(ref_audio, 24000))
        want = ref.run_text_to_audio("tab up", JaxClip(ref_audio, 24000))
    else:
        assert port._backend.mode == "oracle"
        got = port.run_text_to_audio("tab up at a pub")
        want = ref.run_text_to_audio("tab up at a pub")
    assert got.samples.shape == want.samples.shape and got.samples.size
    np.testing.assert_allclose(got.samples, want.samples, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        tts.TextToSpeechInterface.from_bundle(
            identify_and_load(voices[engine]), mode="xla")


def test_image_oracle_mode_gives_the_jax_packages_oracle(tmp_path):
    from test_diffusers_loader import _write_sd_pipeline
    from whisper_tensor_tpu.importers.loaders import (
        identify_and_load as jax_load)
    from whisper_tensor_tpu.interfaces.image_gen import (
        ImageGenConfig as JaxConfig, image_interface_from_bundle as jax_iface)
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.image_gen import (
        ImageGenConfig, image_interface_from_bundle)

    d = _write_sd_pipeline(str(tmp_path))
    kw = dict(dtype="f32", height=64, width=64)
    port = image_interface_from_bundle(identify_and_load(d, **kw),
                                       mode="oracle")
    assert port.device.type == "cpu" and port.mode == "oracle"
    got = port.run("a tpu", cfg=ImageGenConfig(steps=2, height=64, width=64,
                                               seed=1)).pixels
    want = jax_iface(jax_load(d, **kw), mode="oracle").run(
        "a tpu", cfg=JaxConfig(steps=2, height=64, width=64, seed=1)).pixels
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert got.shape == want.shape == (64, 64, 3) and want.std() > 1.0
    assert diff.max() <= 1, diff.max()
    assert image_interface_from_bundle(identify_and_load(d, **kw),
                                       device="cpu").mode == "torch"
    with pytest.raises(ValueError, match="mode"):
        image_interface_from_bundle(identify_and_load(d, **kw), mode="xla")


def test_quantized_store_getter_applies_its_transform(tmp_path):
    from safetensors.numpy import save_file

    from whisper_tensor_tpu.importers import quantized as ref_q
    from whisper_tensor_tpu.importers.safetensors_io import (
        SafetensorsStore as RefStore)
    from whisper_tensor_tpu_torch.importers import quantized as port_q
    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)

    rng = np.random.default_rng(4)
    K, N, g = 128, 64, 64
    q = rng.integers(0, 16, (K, N)).astype(np.int32)
    zeros = rng.integers(0, 16, (K // g, N)).astype(np.int32)
    scales = (rng.random((K // g, N)) * 0.02 + 0.01).astype(np.float16)
    spec = port_q.QuantSpec("gptq", 4, g)
    qw, qz, sc = port_q.pack_gptq(q, zeros, scales, spec)
    path = str(tmp_path / "model.safetensors")
    save_file({"m.qweight": qw, "m.qzeros": qz, "m.scales": sc,
               "m.bias": np.arange(N, dtype=np.float32)}, path)
    port = port_q.QuantizedStore(SafetensorsStore([path]), spec)
    ref = ref_q.QuantizedStore(RefStore([path]),
                               ref_q.QuantSpec("gptq", 4, g))
    seen = []

    def transform(name, arr):
        seen.append(name)
        return arr * 2.0 + 1.0

    for name in ("m.weight", "m.bias"):
        got = port.getter(transform)(name)
        want = ref.getter(transform)(name)
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(got, port.load(name) * 2.0 + 1.0)
        assert port.getter()(name).tobytes() == ref.getter()(name).tobytes()
    assert seen == ["m.weight", "m.weight", "m.bias", "m.bias"]


def test_seq2seq_encode_takes_input_ids_by_name(tmp_path):
    from tests.test_torch_port_t5 import IDS, _hf, _ifaces

    d = str(tmp_path)
    _hf("relu").save_pretrained(d, safe_serialization=True)
    port, ref = _ifaces(d)
    got = port.encode(input_ids=IDS)
    want = ref.encode(input_ids=IDS)
    for n in ["encoder_states"] + ref.cross_in:
        _close(got[n], want[n], 1e-4)
