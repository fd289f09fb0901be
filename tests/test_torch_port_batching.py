"""The PyTorch port's ContinuousBatcher against the port's direct path and
the JAX package, on the CPU.

Mirrors tests/test_batching.py on its fixtures: a tiny GPT-2 (2 layers,
n_embd 32, 2 heads, vocab 211, max_len 64, weights from
random_gpt2_weights with the matrices scaled 10x, see
sharp_gpt2_weights) built with a per-row position for the batcher and a
scalar one for the direct path, and a tiny HF llama. Every cache is f32,
so batched and sequential decoding are token-exact: each request's
tokens must equal the port's TextInferenceInterface.generate_tokens on
the scalar graph (tolerance zero). One case also holds the batcher
against the JAX ContinuousBatcher. Each package's Model is built from
the same ONNX bytes (the JAX package's recipe).

Not mirrored here: the four multi-LoRA tests (test_batching.py:697-890;
tests/test_torch_port_lora.py holds the port's adapters against the JAX
package), window admission (:990; windowed decode is not ported)
and the power-of-two cliff guard (:359; the port keeps max_batch as
configured).
"""

import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (  # noqa: E402
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxTextInterface)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)

rng = np.random.default_rng(5)
V = 211


def sharp_gpt2_weights(cfg):
    """random_gpt2_weights with its matrices scaled 10x. At their 0.02
    scale the tiny model's greedy tokens hardly depend on the context
    (one token repeats), so a batcher that lost a row's prefix would
    still pass; scaled, each token depends on the whole prompt."""
    base, memo = random_gpt2_weights(cfg), {}

    def get(name):
        if name not in memo:
            w = base(name)
            memo[name] = w * 10.0 if w.ndim == 2 else w
        return memo[name]
    return get


def _onnx(max_len=64):
    """The scalar- and per-row-position GPT-2 step graphs, as ONNX bytes."""
    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=V,
                     n_positions=max_len)
    wg = sharp_gpt2_weights(cfg)
    return [build_gpt2_step(wg, cfg, max_len=max_len, dtype=JaxDType.F32,
                            pos_per_row=ppr) for ppr in (False, True)]


def _models(max_len=64, cls=Model):
    """(scalar, ragged) Models of `cls`, the port's or the JAX package's."""
    return tuple(cls.new_from_onnx(data) for data in _onnx(max_len))


def _direct(model, buckets=(16,), max_len=64):
    """The port's single-request path: the sequential reference."""
    return TextInferenceInterface(model, max_len=max_len,
                                  prompt_buckets=buckets, device="cpu")


def _batcher(model, max_len=64, **kw):
    kw.setdefault("prompt_buckets", (16,))
    return ContinuousBatcher(model, max_len=max_len, cache_dtype=DType.F32,
                             device="cpu", **kw)


def _prompts(lengths, r=rng):
    return [r.integers(0, V, (n,)).astype(np.int64) for n in lengths]


def _assert_sequential(ref, jobs, timeout=120):
    for p, n, f in jobs:
        out = f.result(timeout=timeout)
        np.testing.assert_array_equal(out, ref.generate_tokens(p[None], n)[0],
                                      err_msg=f"L={len(p)} n={n}")


def test_gpt2_greedy_token_exact_against_the_jax_interface():
    """Both GPT-2 step graphs through the port's interface: the JAX
    package's greedy tokens at f32 (tolerance zero)."""
    prompts = np.stack(_prompts([7, 7]))
    for m, jm in zip(_models(), _models(cls=JaxModel)):
        want = JaxTextInterface(jm, max_len=64, prompt_buckets=(16,)
                                ).generate_tokens(prompts, 9)
        np.testing.assert_array_equal(_direct(m).generate_tokens(prompts, 9),
                                      want)


def test_concurrent_requests_match_sequential():
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar, (16, 32))
    b = _batcher(m_ragged, max_batch=4, chunk=4,
                 prompt_buckets=(16, 32)).start()
    try:
        prompts = _prompts((3, 7, 12, 5, 9, 2))
        n_news = [6, 11, 4, 9, 7, 13]
        jobs = [(p, n, b.submit(p, n)) for p, n in zip(prompts, n_news)]
        _assert_sequential(ref, jobs)
        for _, n, f in jobs:
            assert f.result().shape == (n,)
    finally:
        b.stop()


def test_matches_the_jax_continuous_batcher():
    """The same requests through the JAX package's ContinuousBatcher and
    the port's, on the same ragged graph: the same tokens."""
    prompts = _prompts((3, 9, 5))
    n_news = [6, 4, 8]
    outs = []
    for cls, model, dt, kw in (
            (JaxBatcher, _models(cls=JaxModel)[1], JaxDType, {}),
            (ContinuousBatcher, _models()[1], DType, {"device": "cpu"})):
        b = cls(model, max_len=64, max_batch=2, chunk=4,
                cache_dtype=dt.F32, prompt_buckets=(16,), **kw).start()
        try:
            futs = [b.submit(p, n) for p, n in zip(prompts, n_news)]
            outs.append([f.result(timeout=300) for f in futs])
        finally:
            b.stop()
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_streaming_callback_and_slot_reuse():
    _, m_ragged = _models()
    b = _batcher(m_ragged, max_batch=2, chunk=3).start()
    try:
        streamed = {}

        def make_cb(k):
            streamed[k] = []
            return lambda t: streamed[k].append(t)

        futs = []
        # 5 requests through 2 slots forces reuse
        for k in range(5):
            p = rng.integers(0, V, (4 + k,)).astype(np.int64)
            futs.append((k, b.submit(p, 5, on_token=make_cb(k))))
        for k, f in futs:
            out = f.result(timeout=120)
            assert out.shape == (5,)
            assert streamed[k][:5] == list(out)
    finally:
        b.stop()


@pytest.mark.parametrize("eos_list", [False, True])
def test_eos_terminates_early(eos_list):
    """One eos id, or a list of them (Llama-3 style) with a dud: the row
    deactivates at the first one, after emitting it."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    p = rng.integers(0, V, (6,)).astype(np.int64)
    want = ref.generate_tokens(p[None], 20)[0]
    eos = [int(want[3]), V - 1] if eos_list else int(want[4])
    b = _batcher(m_ragged, max_batch=2, chunk=4, eos_token_id=eos).start()
    try:
        first = eos[0] if eos_list else eos
        if eos_list:
            assert b.eos_token_ids == tuple(eos) and b.eos_token_id == eos[0]
        out = b.submit(p, 20).result(timeout=120)
        assert len(out) <= 20 and first in list(out)
        idx = list(out).index(first)
        np.testing.assert_array_equal(out[:idx + 1], want[:idx + 1])
    finally:
        b.stop()


def _llama_models(max_len):
    import torch
    from transformers import LlamaConfig as HFCfg, LlamaForCausalLM

    from whisper_tensor_tpu.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step, hf_weight_getter)

    torch.manual_seed(7)
    common = dict(num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, hidden_size=32,
                  intermediate_size=48, vocab_size=131,
                  max_position_embeddings=64, attention_dropout=0.0)
    hf = LlamaForCausalLM(HFCfg(rope_theta=10000.0, **common))
    hf.eval()
    cfg = LlamaConfig.from_hf({**common, "model_type": "llama",
                               "rope_theta": 10000.0, "rms_norm_eps": 1e-6})
    wg = hf_weight_getter(hf)
    return [Model.new_from_onnx(build_llama_step(
        wg, cfg, max_len=max_len, dtype=JaxDType.F32, pos_per_row=ppr))
        for ppr in (False, True)]


def test_llama_continuous_batching():
    m0, mr = _llama_models(64)
    ref = _direct(m0)
    b = _batcher(mr, max_batch=3, chunk=4).start()
    try:
        prompts = [rng.integers(0, 131, (n,)).astype(np.int64)
                   for n in (3, 8, 5)]
        _assert_sequential(ref, [(p, 7, b.submit(p, 7)) for p in prompts])
    finally:
        b.stop()


def test_cancel_mid_generation_and_queued():
    """A cancelled running request resolves with the tokens emitted so
    far (a prefix of the sequential reference) and frees its slot; a
    cancelled queued request resolves empty; serving goes on."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=1, chunk=2).start()
    try:
        p = rng.integers(0, V, (5,)).astype(np.int64)
        got = []
        fut = b.submit(p, 40, on_token=lambda t: got.append(t))
        fq = b.submit(p, 10)                 # queued behind it, cancelled
        assert b.cancel(fq)
        while len(got) < 4:
            time.sleep(0.01)
        assert b.cancel(fut)
        out = fut.result(timeout=60)
        assert 0 < len(out) < 40
        want = ref.generate_tokens(p[None], 40)[0]
        np.testing.assert_array_equal(out, want[:len(out)])
        assert fq.result(timeout=60).shape == (0,)
        assert not b.cancel(fut)             # already finished
        np.testing.assert_array_equal(b.submit(p, 6).result(timeout=60),
                                      want[:6])
    finally:
        b.stop()


def test_tick_failure_fails_futures_and_recovers():
    """A failure inside a tick fails every outstanding future with the
    cause, and the batcher then serves later requests exactly."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=2, chunk=4)
    real = b._run_chunk
    state = {"boom": 1}

    def poisoned(*args):
        if state["boom"]:
            state["boom"] -= 1
            raise RuntimeError("injected device failure")
        return real(*args)

    b._run_chunk = poisoned
    b.start()
    try:
        fut = b.submit(rng.integers(0, V, (5,)).astype(np.int64), 6)
        with pytest.raises(RuntimeError, match="injected device failure"):
            fut.result(timeout=120)
        p2 = rng.integers(0, V, (7,)).astype(np.int64)
        _assert_sequential(ref, [(p2, 5, b.submit(p2, 5))])
    finally:
        b.stop()


def test_a_request_submitted_as_a_tick_fails_is_served():
    """A caller woken by its failed future submits again at once (here
    from the future's done callback, which runs in the batcher's thread
    while it fails the tick's requests): the new request is not the
    failed tick's, and is served exactly."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=2, chunk=4)
    real = b._run_chunk
    state = {"boom": 1}

    def poisoned(*args):
        if state["boom"]:
            state["boom"] -= 1
            raise RuntimeError("injected device failure")
        return real(*args)

    b._run_chunk = poisoned
    p2 = np.random.default_rng(8).integers(0, V, (7,)).astype(np.int64)
    again = []
    b.start()
    try:
        fut = b.submit(np.random.default_rng(7).integers(0, V, (5,)), 6)
        fut.add_done_callback(lambda f: again.append(b.submit(p2, 5)))
        with pytest.raises(RuntimeError, match="injected device failure"):
            fut.result(timeout=120)
        assert len(again) == 1
        _assert_sequential(ref, [(p2, 5, again[0])])
    finally:
        b.stop()


def test_pipelined_slot_churn_matches_sequential():
    """Many short requests churn through two slots: admissions land while
    a chunk is in flight, finished rows decode on until their park
    lands; every request is still exact."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=2, chunk=5).start()
    try:
        r = np.random.default_rng(11)
        jobs = []
        for _ in range(9):
            p = r.integers(0, V, (int(r.integers(2, 14)),)).astype(np.int64)
            n = int(r.integers(1, 12))
            jobs.append((p, n, b.submit(p, n)))
        _assert_sequential(ref, jobs)
    finally:
        b.stop()


def test_many_submitting_threads_under_a_short_switch_interval():
    """16 client threads (more than this machine's cores) submit at once
    while the loop runs, the interpreter switching threads every
    microsecond: every request is exact, and the emitted-token counter
    equals the tokens returned (a lost update in the shared queue,
    request registry or counters breaks one or the other)."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=4, chunk=3).start()
    r = np.random.default_rng(29)
    prompts = _prompts([int(n) for n in r.integers(2, 14, 16)], r)
    n_news = [int(n) for n in r.integers(1, 8, 16)]
    futs = [None] * 16
    barrier = threading.Barrier(16)

    def client(i):
        barrier.wait(timeout=60)
        futs[i] = b.submit(prompts[i], n_news[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        outs = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
        b.stop()
    for p, n, out in zip(prompts, n_news, outs):
        np.testing.assert_array_equal(out, ref.generate_tokens(p[None], n)[0])
    assert b.stats()["tokens_emitted"] == sum(n_news)


def test_admission_coalescing_matches_sequential():
    """An idle device admits at once despite a 30 s coalescing deadline;
    staggered arrivals under it stay exact."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=4, chunk=3,
                 admit_coalesce_s=30.0).start()
    try:
        r = np.random.default_rng(7)
        p0 = r.integers(0, V, (5,)).astype(np.int64)
        t0 = time.time()
        out0 = b.submit(p0, 4).result(timeout=120)
        assert time.time() - t0 < 25, "idle admission waited on coalesce"
        np.testing.assert_array_equal(out0, ref.generate_tokens(p0[None],
                                                                4)[0])
        jobs = []
        for _ in range(8):
            p = r.integers(0, V, (int(r.integers(2, 12)),)).astype(np.int64)
            n = int(r.integers(4, 14))
            jobs.append((p, n, b.submit(p, n)))
            time.sleep(0.02)
        _assert_sequential(ref, jobs)
    finally:
        b.stop()


def test_adaptive_chunk_max_matches_sequential():
    """chunk_max: long chunks only when every live row needs them; rows
    admitted mid-stream and short tails stay exact, and long chunks
    really ran."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=2, chunk=2, chunk_max=8).start()
    try:
        r = np.random.default_rng(23)
        jobs = []
        for n in (30, 27, 3, 25, 5, 18):
            p = r.integers(0, V, (int(r.integers(2, 12)),)).astype(np.int64)
            jobs.append((p, n, b.submit(p, n)))
        _assert_sequential(ref, jobs)
        st = b.stats()
        assert st["chunk_max"] == 8
        assert st["steps_dispatched"] > 2 * st["chunks_dispatched"]
    finally:
        b.stop()


def test_shared_iface_across_batchers():
    """Two sequential batchers over ONE interface (weights and plans
    shared) each reproduce the sequential generations; a max_len other
    than the interface's is refused."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar, (16, 32))
    shared = TextInferenceInterface(m_ragged, max_len=64,
                                    cache_dtype=DType.F32,
                                    prompt_buckets=(16, 32), device="cpu")
    prompts = _prompts((3, 7, 12, 5))
    for max_batch in (2, 4):
        b = ContinuousBatcher(None, max_len=64, max_batch=max_batch,
                              chunk=4, iface=shared).start()
        try:
            _assert_sequential(ref, [(p, 8, b.submit(p, 8)) for p in prompts])
        finally:
            b.stop()
    with pytest.raises(ValueError):
        ContinuousBatcher(None, max_len=32, iface=shared)


def test_unported_options_raise_and_unknown_adapters_are_refused():
    """An adapter on a weight the graph does not take at run time fails
    at construction (test_batching.py test_multi_lora_validation); an
    adapter name the batcher does not serve fails at submit."""
    _, m_ragged = _models()
    with pytest.raises(ValueError, match="not runtime weight inputs"):
        _batcher(m_ragged, adapters={"fr": {"no_such_weight": (
            np.zeros((4, 2), np.float32), np.zeros((2, 4), np.float32),
            1.0)}})
    b = _batcher(m_ragged, max_batch=2)
    with pytest.raises(ValueError, match="unknown adapter"):
        b.submit(np.arange(3), 2, adapter="fr")
    assert b.stats()["slots"] == 2 and b.max_batch == 2


def test_drain_finishes_accepted_work_then_stops():
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar)
    b = _batcher(m_ragged, max_batch=2, chunk=3).start()
    prompts = _prompts((4, 9, 6))
    jobs = [(p, 7, b.submit(p, 7)) for p in prompts]
    assert b.drain(timeout=120)
    _assert_sequential(ref, jobs, timeout=1)
    assert b._thread is None


def test_int8_gpt2_of_head_dim_64_at_a_bf16_cache_matches_the_jax_batcher():
    """GPT-2's shape on the card's path, at a tiny size: head dim 64
    (n_embd 128, 2 heads), quantize="int8" (the 128 x 512 MLP matrices and
    the tied head, 128 x 521: an odd N), a bf16 cache and 16-token prefill
    pieces, through the JAX package's batcher and the port's on the same
    ONNX bytes. (On the card the same graph runs decode_attention and
    flash_attention at D = 64 and int8_matmul on the odd head; here the
    wrappers take their plain versions.)

    At bf16 the two packages round in different places that the contract
    (bf16 elementwise math in f32, rounded back; f32 accumulation in
    matmuls) leaves open: XLA's CPU compiler keeps f32 across fused
    elementwise chains (the first node to part is the first LayerNorm,
    fed the embedding sum unrounded), the reference's CPU attention
    rounds normalized probabilities where the port's kernels round
    unnormalized ones (prefill) or none (decode), and the reference's
    native int8 quantizer (built with -ffast-math) may differ from its
    numpy path, which the port copies, in the last bit of a scale. So:
      * each row's prompt plus the JAX batcher's tokens, teacher-forced
        through both direct paths, gives every step's logits within
        TOL of the step's largest |logit|. One rounding is 2^-8
        relative; the reference against itself, compiled with and
        without XLA's excess precision, parts by up to 4.3% on these
        prompts, the port from it by up to 3.8%
        (tests/test_torch_port_bf16_parity.py prints both); TOL is
        1/16;
      * the batchers' tokens agree exactly up to the first step where
        the JAX logits' top two lie within that tolerance;
      * at that step the port's token is one of the JAX candidates
        within the tolerance of the top."""
    TOL = 1 / 16
    vocab = 521
    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=128, vocab_size=vocab,
                     n_positions=128)
    data = build_gpt2_step(sharp_gpt2_weights(cfg), cfg, max_len=128,
                           dtype=JaxDType.BF16, pos_per_row=True)
    gen = np.random.default_rng(31)
    prompts = [gen.integers(0, vocab, (n,)).astype(np.int64)
               for n in (5, 23, 40)]
    outs = []
    for cls, model, dt, kw in (
            (JaxBatcher, JaxModel.new_from_onnx(data), JaxDType, {}),
            (ContinuousBatcher, Model.new_from_onnx(data), DType,
             {"device": "cpu"})):
        b = cls(model, max_len=128, max_batch=3, chunk=4, quantize="int8",
                cache_dtype=dt.BF16, prompt_buckets=(16, 32, 64),
                prefill_chunk=16, **kw).start()
        try:
            outs.append([f.result(timeout=300)
                         for f in [b.submit(p, 6) for p in prompts]])
        finally:
            b.stop()
    direct = dict(max_len=128, quantize="int8", prompt_buckets=(16, 32, 64))
    ref = JaxTextInterface(JaxModel.new_from_onnx(data),
                           cache_dtype=JaxDType.BF16, **direct)
    port = TextInferenceInterface(Model.new_from_onnx(data),
                                  cache_dtype=DType.BF16, device="cpu",
                                  **direct)
    for p, want, got in zip(prompts, *outs):
        assert got.shape == want.shape == (6,)
        seq = np.concatenate([p, want[:-1]])[None]
        lj = np.asarray(ref.logits(seq), np.float32)[0, len(p) - 1:]
        lp = port.logits(seq).astype(np.float32)[0, len(p) - 1:]
        tol = TOL * np.abs(lj).max(axis=-1)
        np.testing.assert_array_less(np.abs(lp - lj).max(axis=-1), tol,
                                     err_msg=f"L={len(p)}")
        for i, (a, b) in enumerate(zip(want, got)):
            top2 = np.sort(lj[i])[-2:]
            if top2[1] - top2[0] < tol[i]:
                assert lj[i][b] > lj[i].max() - tol[i], (len(p), i, a, b)
                break
            assert a == b, (len(p), i, want, got)
