"""The PyTorch port's SpeculativeDecoder against plain greedy decoding and
the JAX package's SpeculativeDecoder, on the CPU.

Mirrors tests/test_speculative.py on its shapes: a tiny GPT-2 target (2
layers, n_embd 32, 2 heads, vocab 127, max_len 96) and a 1-layer draft
(n_embd 16), every cache f32, each package's Model built from the same
ONNX bytes (the JAX package's recipe). The weight matrices are scaled
10x (see sharp), so greedy tokens depend on the whole context and the
draft disagrees with the target often: acceptance is partial, and rows
of a batch accept different amounts. Greedy speculative tokens must
equal plain greedy decoding exactly (tolerance zero). The sampled path
cannot reproduce jax.random's draws, so it is held to the analytic
two-token joint distribution by total variation, with the bound of the
reference's test. The server's draft_model_id and `cli generate
--draft-model` close the file."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (  # noqa: E402
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu.interfaces.speculative import (  # noqa: E402
    SpeculativeDecoder as JaxSpeculativeDecoder)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxTextInterface)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.speculative import (  # noqa: E402
    SpeculativeDecoder)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    SamplingParams, TextInferenceInterface, _filtered_logits)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402

MAX_LEN = 96
VOCAB = 127
TARGET_CFG = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=VOCAB,
                        n_positions=MAX_LEN)
DRAFT_CFG = GPT2Config(n_layer=1, n_head=2, n_embd=16, vocab_size=VOCAB,
                       n_positions=MAX_LEN)


def sharp(cfg, seed):
    """random_gpt2_weights with the matrices scaled 10x."""
    base = random_gpt2_weights(cfg, seed=seed)

    def get(name):
        w = base(name)
        return w * 10.0 if w.ndim == 2 else w
    return get


def _onnx(cfg, seed, pos_per_row=False, max_len=MAX_LEN, scale=True):
    wg = sharp(cfg, seed) if scale else random_gpt2_weights(cfg, seed=seed)
    return build_gpt2_step(wg, cfg, max_len=max_len, dtype=JaxDType.F32,
                           pos_per_row=pos_per_row)


def _iface(cfg, seed, pos_per_row=False, max_len=MAX_LEN, buckets=(16, 32),
           jax_pkg=False, scale=True):
    data = _onnx(cfg, seed, pos_per_row, max_len, scale)
    if jax_pkg:
        return JaxTextInterface(JaxModel.new_from_onnx(data), max_len=max_len,
                                prompt_buckets=buckets)
    return TextInferenceInterface(Model.new_from_onnx(data), max_len=max_len,
                                  prompt_buckets=buckets, device="cpu")


@pytest.mark.parametrize("L,n,k", [(5, 12, 4), (11, 7, 4), (9, 20, 5)])
def test_greedy_b1_matches_plain_greedy_and_the_jax_decoder(L, n, k):
    target, draft = _iface(TARGET_CFG, 0), _iface(DRAFT_CFG, 1)
    dec = SpeculativeDecoder(target, draft, k=k)
    p = np.random.default_rng(L).integers(0, VOCAB, (L,)).astype(np.int64)
    out = dec.generate_tokens(p, n)
    np.testing.assert_array_equal(out, target.generate_tokens(p[None], n))
    jdec = JaxSpeculativeDecoder(_iface(TARGET_CFG, 0, jax_pkg=True),
                                 _iface(DRAFT_CFG, 1, jax_pkg=True), k=k)
    np.testing.assert_array_equal(out, jdec.generate_tokens(p, n))
    # the draft disagrees: more rounds than full acceptance needs
    assert dec.last_rounds > -(-(n - 1) // k)


def test_greedy_ragged_b3_matches_plain_greedy_and_the_jax_decoder():
    """Three rows accept different amounts, so their positions part."""
    target = _iface(TARGET_CFG, 0, pos_per_row=True)
    draft = _iface(DRAFT_CFG, 1, pos_per_row=True)
    dec = SpeculativeDecoder(target, draft, k=3)
    prompts = np.random.default_rng(3).integers(0, VOCAB, (3, 9))
    out = dec.generate_tokens(prompts, 10)
    np.testing.assert_array_equal(
        out, _iface(TARGET_CFG, 0).generate_tokens(prompts, 10))
    jdec = JaxSpeculativeDecoder(
        _iface(TARGET_CFG, 0, pos_per_row=True, jax_pkg=True),
        _iface(DRAFT_CFG, 1, pos_per_row=True, jax_pkg=True), k=3)
    np.testing.assert_array_equal(out, jdec.generate_tokens(prompts, 10))


def test_self_draft_accepts_every_proposal():
    """Draft == target: one verify per k-1 emitted tokens after the
    first (`last_rounds`), still exact; exercises the k-th draft step
    that keeps the draft's cache whole when all is accepted."""
    target, draft = _iface(TARGET_CFG, 0), _iface(TARGET_CFG, 0)
    dec = SpeculativeDecoder(target, draft, k=5)
    p = np.random.default_rng(7).integers(0, VOCAB, (7,)).astype(np.int64)
    out = dec.generate_tokens(p, 15)
    np.testing.assert_array_equal(out, target.generate_tokens(p[None], 15))
    # each round emits k = 5 tokens: 14 after the first take 3 rounds
    assert dec.last_rounds == -(-(15 - 1) // 5)


def test_sampled_matches_the_target_distribution():
    """temperature > 0 (modified rejection sampling) emits tokens
    distributed as target-only sampling: the empirical two-token joint
    of 4096 rows against the analytic one from the target's logits, by
    total variation, under the reference test's bound: below 1.35x the
    distance plain target-only sampling of as many rows reaches (the
    sampling-noise floor, about 0.1 for 256 cells), or 0.12. The
    weights are the reference test's (unscaled), whose draft is a poor
    match for the target."""
    V = 16
    tcfg = GPT2Config(n_layer=1, n_head=2, n_embd=16, vocab_size=V,
                      n_positions=64)
    dcfg = GPT2Config(n_layer=1, n_head=1, n_embd=8, vocab_size=V,
                      n_positions=64)
    target = _iface(tcfg, 3, True, 64, (16,), scale=False)
    draft = _iface(dcfg, 4, True, 64, (16,), scale=False)
    ref = _iface(tcfg, 3, False, 64, (16,), scale=False)
    sp = SamplingParams(temperature=0.8, seed=5)
    B = 4096
    prompt = np.asarray([3, 9, 1, 14], np.int64)
    dec = SpeculativeDecoder(target, draft, k=3)
    toks = dec.generate_tokens(np.tile(prompt, (B, 1)), 2, sampling=sp)

    def probs_after(ids_batch):      # (N, L) -> (N, V) next-token dist
        lg = torch.from_numpy(np.stack([ref.logits(r[None])[0, -1]
                                        for r in ids_batch]))
        return torch.softmax(_filtered_logits(lg, sp), -1).double().numpy()

    p1 = probs_after(prompt[None])[0]
    p2 = probs_after(np.stack([np.concatenate([prompt, [t]])
                               for t in range(V)]))
    joint = p1[:, None] * p2
    emp = np.zeros((V, V))
    np.add.at(emp, (toks[:, 0], toks[:, 1]), 1.0 / B)
    tv = 0.5 * np.abs(emp - joint).sum()
    toks_p = ref.generate_tokens(np.tile(prompt, (B, 1)), 2, sampling=sp)
    emp_p = np.zeros((V, V))
    np.add.at(emp_p, (toks_p[:, 0], toks_p[:, 1]), 1.0 / B)
    tv_p = 0.5 * np.abs(emp_p - joint).sum()
    assert tv < max(1.35 * tv_p, 0.12), (tv, tv_p)

    # top-k: every emitted token lies in the target's top-k set (top-3
    # by logit does not depend on the temperature)
    spk = SamplingParams(temperature=0.9, top_k=3, seed=6)
    toks_k = dec.generate_tokens(np.tile(prompt, (256, 1)), 1, sampling=spk)
    assert set(np.unique(toks_k)) <= set(np.argsort(p1)[-3:])


def test_sampling_temperature_zero_is_greedy():
    target, draft = _iface(TARGET_CFG, 0), _iface(DRAFT_CFG, 1)
    dec = SpeculativeDecoder(target, draft, k=3)
    p = np.random.default_rng(6).integers(0, VOCAB, (6,)).astype(np.int64)
    out = dec.generate_tokens(p, 8, sampling=SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(out, target.generate_tokens(p[None], 8))


@pytest.mark.parametrize("penalty", [dict(repetition_penalty=1.2),
                                     dict(presence_penalty=0.5),
                                     dict(frequency_penalty=0.5)])
def test_history_penalties_are_refused(penalty):
    dec = SpeculativeDecoder(_iface(TARGET_CFG, 0), _iface(DRAFT_CFG, 1), k=3)
    with pytest.raises(ValueError, match="penalties"):
        dec.generate_tokens(np.arange(5), 4, sampling=SamplingParams(
            temperature=0.7, **penalty))


def test_guards():
    target, draft = _iface(TARGET_CFG, 0), _iface(DRAFT_CFG, 1)
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeDecoder(target, draft, k=1)
    small = GPT2Config(n_layer=1, n_head=2, n_embd=16, vocab_size=50,
                       n_positions=MAX_LEN)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeDecoder(target, _iface(small, 2))
    dec = SpeculativeDecoder(target, draft, k=4)
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="pos_per_row"):
        dec.generate_tokens(rng.integers(0, VOCAB, (2, 5)), 4)
    with pytest.raises(ValueError, match="max_len"):
        dec.generate_tokens(rng.integers(0, VOCAB, (5,)), MAX_LEN)


# -- the server's draft_model_id and `cli generate --draft-model` ----------


from tests.test_torch_port_slice import checkpoint as ckpt  # noqa: E402,F401


def _job(srv, msg, timeout=120):
    """Dispatch a generate_text message and wait for its job's end."""
    assert srv._dispatch(msg) is None
    while True:
        r = srv.scheduler.reports.get(timeout=timeout)
        if r["type"] in ("job_result", "job_error"):
            return r


def test_server_draft_model_id(ckpt):
    """generate_text with draft_model_id on the port's Server: the
    checkpoint drafts for itself (a second, ragged_decode copy), the
    text is the target's own greedy text, the decoder is cached per
    (target, draft, k), and penalties and constraints are refused."""
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    srv = Server(device="cpu")
    ids = [srv.models.run_loader("transformers", {
        "path": ckpt, "dtype": "f32", "max_len": 64,
        "ragged_decode": ragged})[0].id for ragged in (False, True)]
    base = {"type": "generate_text", "model_id": ids[0], "prompt": "hello",
            "max_new_tokens": 12, "tokenizer": "bytes",
            "draft_model_id": ids[1], "draft_k": 3}
    r = _job(srv, base)
    assert r["type"] == "job_result", r
    target = srv._score_iface(srv.models.get(ids[0]))
    want = target.generate_tokens(
        np.asarray(ByteTokenizer().encode("hello"), np.int64)[None], 12)[0]
    assert r["result"]["text"] == ByteTokenizer().decode(
        [int(t) for t in want])
    assert r["result"]["rounds"] == -(-(12 - 1) // 3)   # all accepted
    assert list(srv._spec_decoders) == [(ids[0], ids[1], 3)]
    r = _job(srv, dict(base, temperature=0.7, repetition_penalty=1.2))
    assert r["type"] == "job_error" and "penalties" in r["error"], r
    with pytest.raises(ValueError, match="draft_model_id"):
        srv._dispatch(dict(base, regex="a+"))
    srv._dispatch({"type": "unload_model", "model_id": ids[1]})
    assert not srv._spec_decoders
    for bat in srv._batchers.values():
        bat.stop()


def test_cli_generate_draft_model(ckpt, capsys):
    """`generate --draft-model` (the checkpoint drafting for itself)
    prints the plain `generate` text and the JAX package's CLI's
    (greedy, f32 cache in both)."""
    from whisper_tensor_tpu.cli import main as jax_main
    from whisper_tensor_tpu_torch.cli import main

    args = ["generate", "--model", ckpt, "--prompt", "hi", "--max-len", "64",
            "--max-new-tokens", "16", "-c", "dtype=f32"]
    main(args + ["--device", "cpu"])
    plain = capsys.readouterr().out
    spec = args + ["--draft-model", ckpt, "--draft-k", "3"]
    main(spec + ["--device", "cpu"])
    got = capsys.readouterr()
    assert got.out == plain and "speculative:" in got.err
    jax_main(spec)
    assert capsys.readouterr().out == got.out
    with pytest.raises(SystemExit, match="draft-model"):
        main(spec + ["--regex", "a+", "--device", "cpu"])
