"""The PyTorch port's text slice against the JAX package.

The same tiny llama (2 layers, hidden 256, 2 query heads and 1 KV head
of 128, vocab 512, max_len 64; weights and prompts from numpy with fixed
seeds) runs through the JAX TextInferenceInterface and the port's, and
through the port's OpenAI HTTP API on its Server; each package's Model
is built from the same ONNX bytes (the JAX package's recipe). Greedy
decoding is token-exact at an f32 cache; sampling, whose random streams
differ between jax.random and torch.Generator, is held to the same
filtered distribution and to its greedy limits.
"""

import http.client
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm.llama import (  # noqa: E402
    LlamaConfig, build_llama_step)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    SamplingParams as JaxSamplingParams,
    TextInferenceInterface as JaxTextInterface,
    _filtered_logits as jax_filtered_logits)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType, to_host  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    SamplingParams, TextInferenceInterface, _filtered_logits, _pick_token)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, I, V, D, MAX_LEN = 256, 384, 512, 128, 64
CFG = LlamaConfig(num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=1, hidden_size=E, intermediate_size=I,
                  vocab_size=V, head_dim=D)
HF_SHAPES = {"model.embed_tokens.weight": (V, E), "lm_head.weight": (V, E),
             "model.norm.weight": (E,)}
for _i in range(2):
    _p = f"model.layers.{_i}."
    HF_SHAPES.update({
        _p + "input_layernorm.weight": (E,),
        _p + "post_attention_layernorm.weight": (E,),
        _p + "self_attn.q_proj.weight": (E, E),
        _p + "self_attn.k_proj.weight": (D, E),
        _p + "self_attn.v_proj.weight": (D, E),
        _p + "self_attn.o_proj.weight": (E, E),
        _p + "mlp.gate_proj.weight": (I, E),
        _p + "mlp.up_proj.weight": (I, E),
        _p + "mlp.down_proj.weight": (E, I)})


def _weights(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = HF_SHAPES[name]
    if len(shape) == 1:
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (rng.standard_normal(shape) * 0.08).astype(np.float32)


PROMPT = np.random.default_rng(11).integers(3, 259, (2, 7)).astype(np.int64)


@pytest.fixture(scope="module")
def models():
    """{DType: the port's Model, ("jax", DType): the JAX package's}, each
    pair built from one set of ONNX bytes."""
    out = {}
    for dt in (DType.F32, DType.BF16):
        data = build_llama_step(_weights, CFG, max_len=MAX_LEN,
                                dtype=JaxDType[dt.name])
        out[dt] = Model.new_from_onnx(data)
        out["jax", dt] = JaxModel.new_from_onnx(data)
    return out


def _jax_sp(sp):
    """The JAX package's SamplingParams with the same fields."""
    return None if sp is None else JaxSamplingParams(**vars(sp))


def _pair(models, dt, quantize):
    kw = dict(max_len=MAX_LEN, quantize=quantize)
    return (JaxTextInterface(models["jax", dt], cache_dtype=JaxDType[dt.name],
                             **kw),
            TextInferenceInterface(models[dt], cache_dtype=dt, device="cpu",
                                   **kw))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_greedy_token_exact_at_f32(models, quantize):
    ref, port = _pair(models, DType.F32, quantize)
    want = ref.generate_tokens(PROMPT, 12)
    got = port.generate_tokens(PROMPT, 12)
    assert got.dtype == np.int64 and got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_bf16_logits_close(models, quantize):
    """bf16 rounds at 2^-8 relative, and the two frameworks round at
    different places (attention probabilities, matmul reductions)
    through both layers: 3% of the logits' scale, compared in f32."""
    ref, port = _pair(models, DType.BF16, quantize)
    want = np.asarray(ref.logits(PROMPT), np.float32)
    got = port.logits(PROMPT).astype(np.float32)
    assert got.shape == want.shape == (2, 7, V)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.03 * np.abs(want).max())


@pytest.mark.parametrize("dt", [DType.F32, DType.BF16])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_weights_carried_across_from_the_jax_interface(models, dt, quantize):
    """The JAX interface's own device weights, read back to the host,
    load into the port bit for bit (weights.carry_weights), and at f32
    the port then decodes the JAX package's greedy tokens."""
    ref, port = _pair(models, dt, quantize)
    arrays = {n: np.asarray(a) for n, a in zip(ref.weight_names,
                                              ref._weights())}
    assert set(arrays) == set(port.weight_names)
    port.load_weights(arrays)
    for n, a in arrays.items():
        got = to_host(port._weights()[n])
        assert got.dtype == a.dtype and got.tobytes() == a.tobytes(), n
    if dt is DType.F32:
        np.testing.assert_array_equal(port.generate_tokens(PROMPT, 6),
                                      ref.generate_tokens(PROMPT, 6))


def test_decode_logits_match_teacher_forced_prefill(models):
    """Per-token logits of a greedy run (decode steps on the cache)
    against one prefill over prompt + output: f32, 1e-4 of the scale
    (summation order only)."""
    port = TextInferenceInterface(models[DType.F32], max_len=MAX_LEN,
                                  device="cpu")
    toks, step_logits = port.generate_with_logits(PROMPT, 9)
    full = np.concatenate([PROMPT, toks[:, :-1]], axis=1)
    forced = port.logits(full)[:, PROMPT.shape[1] - 1:, :]
    np.testing.assert_allclose(step_logits, forced, rtol=0,
                               atol=1e-4 * np.abs(forced).max())
    np.testing.assert_array_equal(step_logits.argmax(-1), toks)


SAMPLERS = [SamplingParams(temperature=0.7),
            SamplingParams(temperature=1.3, top_k=17),
            SamplingParams(temperature=1.0, top_p=0.6),
            SamplingParams(temperature=0.9, min_p=0.05),
            SamplingParams(temperature=0.8, top_k=40, top_p=0.8, min_p=0.02)]


@pytest.mark.parametrize("sp", SAMPLERS)
def test_sampling_filters_match_reference(sp):
    """Same logits -> the same candidate set as the reference's
    _filtered_logits, and the same f32 values on it (1e-6)."""
    lg = np.random.default_rng(3).standard_normal((4, V)).astype(np.float32)
    want = np.asarray(jax_filtered_logits(jnp.asarray(lg), _jax_sp(sp)))
    got = _filtered_logits(torch.from_numpy(lg), sp).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


def test_sampling_draws_follow_the_filtered_distribution():
    """40,000 draws from one row: each token's frequency within 0.01 of
    softmax(reference-filtered logits) (4 standard deviations: the
    largest binomial sd at this count is 0.0025)."""
    sp = SamplingParams(temperature=0.8, top_k=6, seed=5)
    lg = np.random.default_rng(4).standard_normal(12).astype(np.float32)
    p = np.asarray(jax.nn.softmax(jax_filtered_logits(jnp.asarray(lg[None]),
                                                      _jax_sp(sp))))[0]
    gen = torch.Generator().manual_seed(sp.seed)
    rows = torch.from_numpy(np.tile(lg, (40000, 1)))
    draws = _pick_token(rows, gen, sp, None).numpy()
    freq = np.bincount(draws, minlength=12) / draws.size
    np.testing.assert_allclose(freq, p, atol=0.01, rtol=0)


@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.9, top_k=1, seed=3),
    SamplingParams(temperature=1.0, min_p=1.0, seed=4),
    SamplingParams(temperature=1.2, top_p=1e-6, seed=5)])
def test_sampling_greedy_limits_equal_greedy(models, sp):
    port = TextInferenceInterface(models[DType.F32], max_len=MAX_LEN,
                                  device="cpu")
    np.testing.assert_array_equal(port.generate_tokens(PROMPT, 8, sampling=sp),
                                  port.generate_tokens(PROMPT, 8))


def test_seeded_sampling_is_reproducible(models):
    port = TextInferenceInterface(models[DType.F32], max_len=MAX_LEN,
                                  device="cpu")
    sp = SamplingParams(temperature=1.0, top_p=0.95, seed=123)
    a = port.generate_tokens(PROMPT, 10, sampling=sp)
    np.testing.assert_array_equal(a, port.generate_tokens(PROMPT, 10,
                                                          sampling=sp))
    other = SamplingParams(temperature=1.0, top_p=0.95, seed=124)
    assert not np.array_equal(a, port.generate_tokens(PROMPT, 10,
                                                      sampling=other))


def test_penalties_and_logit_bias_token_exact(models):
    """temperature 0 with repetition / presence / frequency penalties,
    and an OpenAI logit_bias vector: token-exact against the JAX
    package at f32."""
    ref, port = _pair(models, DType.F32, None)
    sp = SamplingParams(temperature=0.0, repetition_penalty=1.3,
                        presence_penalty=0.5, frequency_penalty=0.2)
    np.testing.assert_array_equal(
        port.generate_tokens(PROMPT, 10, sampling=sp),
        ref.generate_tokens(PROMPT, 10, sampling=_jax_sp(sp)))
    bias = np.zeros(V, np.float32)
    bias[ref.generate_tokens(PROMPT, 1)[:, 0]] = -100.0
    bias[[40, 41]] = 3.0
    np.testing.assert_array_equal(
        port.generate_tokens(PROMPT, 10, logit_bias=bias),
        ref.generate_tokens(PROMPT, 10, logit_bias=bias))


def test_unported_modes_raise(models):
    """(Named when window_models raised "not ported": windowed decode is
    served since; tests/test_torch_port_windows.py holds it.) A window
    graph whose weight inputs are not the main graph's is refused, with
    the JAX package's ValueError; so are an unknown quantize mode, a
    mesh that is not a parallel.mesh.Mesh and adapters over int8."""
    m = models[DType.F32]
    other = build_llama_step(_weights, LlamaConfig(
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        hidden_size=E, intermediate_size=I, vocab_size=V, head_dim=D),
        max_len=32)
    for pkg, iface, model in (("jax", JaxTextInterface, JaxModel),
                              ("port", TextInferenceInterface, Model)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        main = models[DType.F32] if pkg == "port" else models["jax",
                                                              DType.F32]
        with pytest.raises(ValueError, match="build all windows from one "
                                             "recipe"):
            iface(main, max_len=MAX_LEN, window_models={
                32: model.new_from_onnx(other)}, **kw)
    with pytest.raises(ValueError, match="unknown quantize mode 'q2_k'"):
        TextInferenceInterface(m, max_len=MAX_LEN, device="cpu",
                               quantize="q2_k")
    with pytest.raises(TypeError, match="mesh must be a parallel.mesh.Mesh"):
        TextInferenceInterface(m, max_len=MAX_LEN, device="cpu", mesh=object())
    # adapters need dense weights, as in the JAX package
    port = TextInferenceInterface(m, max_len=MAX_LEN, device="cpu",
                                  quantize="int8")
    with pytest.raises(ValueError, match="quantized"):
        port.install_adapters({})


# -- the serving front end on the port ------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny HF llama checkpoint dir: config.json + model.safetensors."""
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("port") / "tiny-llama"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "num_hidden_layers": 2, "hidden_size": E,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": D,
        "intermediate_size": I, "vocab_size": V, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "max_position_embeddings": MAX_LEN}))
    save_file({n: _weights(n) for n in HF_SHAPES},
              str(d / "model.safetensors"))
    return str(d)


def _post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request("POST", path, body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def test_openai_request_on_the_port_server(checkpoint):
    """/v1/completions and a streamed /v1/chat/completions through the
    port's OpenAIApi on its Server return the port
    interface's own tokens; a ragged_decode model is served by the
    port's ContinuousBatcher, with its interface's own tokens."""
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import apply_chat_template

    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("transformers", {
        "path": checkpoint, "dtype": "f32", "quantize": "int8",
        "max_len": MAX_LEN})
    (ragged,) = srv.models.run_loader("transformers", {
        "path": checkpoint, "dtype": "f32", "max_len": MAX_LEN,
        "ragged_decode": True})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        tok = ByteTokenizer()
        iface = srv._text_iface(entry)
        assert isinstance(iface, TextInferenceInterface)
        status, data = _post(api.port, "/v1/completions", {
            "model": str(entry.id), "prompt": "hello there",
            "max_tokens": 8, "temperature": 0})
        assert status == 200, data
        r = json.loads(data)
        own = iface.generate_tokens(
            np.asarray(tok.encode("hello there"), np.int64)[None], 8)[0]
        assert r["usage"]["completion_tokens"] == 8
        assert r["choices"][0]["text"] == tok.decode(list(own))

        # logprobs: rescored by one teacher-forced prefill (port logits)
        status, data = _post(api.port, "/v1/completions", {
            "model": str(entry.id), "prompt": "hello there",
            "max_tokens": 4, "temperature": 0, "logprobs": 2})
        assert status == 200, data
        lp = json.loads(data)["choices"][0]["logprobs"]
        assert len(lp["token_logprobs"]) == 4
        for chosen, top in zip(lp["token_logprobs"], lp["top_logprobs"]):
            # greedy picked the argmax, so it is the best rescored token
            assert chosen <= 0 and abs(max(top.values()) - chosen) < 1e-4

        msgs = [{"role": "user", "content": "hi"}]
        status, raw = _post(api.port, "/v1/chat/completions", {
            "model": str(entry.id), "messages": msgs, "max_tokens": 6,
            "temperature": 0, "stream": True})
        assert status == 200
        events = [ln[6:] for ln in raw.split(b"\n")
                  if ln.startswith(b"data: ")]
        assert events[-1] == b"[DONE]"
        text = "".join(json.loads(e)["choices"][0].get("delta", {})
                       .get("content") or "" for e in events[:-1])
        ids = tok.encode(apply_chat_template(tok, msgs))
        own = iface.generate_tokens(np.asarray(ids, np.int64)[None], 6)[0]
        assert text == tok.decode(list(own))

        status, data = _post(api.port, "/v1/completions", {
            "model": str(ragged.id), "prompt": "hi", "max_tokens": 2,
            "temperature": 0})
        assert status == 200, data
        bat = srv._batchers[ragged.id]
        assert isinstance(bat, ContinuousBatcher)
        own = bat.iface.generate_tokens(
            np.asarray(tok.encode("hi"), np.int64)[None], 2)[0]
        assert json.loads(data)["choices"][0]["text"] == tok.decode(list(own))
        assert bat.stats()["tokens_emitted"] == 2
    finally:
        api.stop()
        for bat in srv._batchers.values():
            bat.stop()


def test_port_server_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: Server(device='cuda') is valid here")
    from whisper_tensor_tpu_torch.server.main import Server

    with pytest.raises(RuntimeError, match="CUDA"):
        Server(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server()


_NO_JAX_SCRIPT = r"""
import http.client, json, sys
from whisper_tensor_tpu_torch.cli import main
main(["generate", "--model", sys.argv[1], "--prompt", "hi",
      "--max-new-tokens", "4", "--device", "cpu", "-c", "quantize=int8"])
from whisper_tensor_tpu_torch.server.main import Server
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
srv = Server(device="cpu")
srv.models.run_loader("transformers", {"path": sys.argv[1], "dtype": "bf16",
                                       "quantize": "int8", "max_len": 64})
(ragged,) = srv.models.run_loader("transformers", {
    "path": sys.argv[1], "dtype": "bf16", "quantize": "int8", "max_len": 64,
    "ragged_decode": True, "serve_batch": 2, "prefill_chunk": 16})
api = OpenAIApi(srv, "127.0.0.1", 0).start()
for model in ("1", str(ragged.id)):
    c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
    c.request("POST", "/v1/completions", body=json.dumps(
        {"model": model, "prompt": "hi", "max_tokens": 3,
         "temperature": 0}), headers={"Content-Type": "application/json"})
    r = c.getresponse()
    print("STATUS", r.status,
          json.loads(r.read())["usage"]["completion_tokens"])
print("BATCHED", srv._batchers[ragged.id].stats()["tokens_emitted"])
api.stop()
srv._batchers[ragged.id].stop()
print("JAX_IMPORTED", "jax" in sys.modules)
"""


def test_slice_runs_without_importing_jax(checkpoint):
    """`cli generate` and HTTP requests on the port's Server, to a
    direct model and to a ragged_decode model served by the batcher, in
    a fresh interpreter: the slice never imports jax."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT, checkpoint],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("STATUS 200 3") == 2, proc.stdout
    assert "BATCHED 3" in proc.stdout, proc.stdout
    assert "JAX_IMPORTED False" in proc.stdout, proc.stdout
    assert "tok/s" in proc.stderr and "on cpu" in proc.stderr
