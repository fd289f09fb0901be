"""The PyTorch port's ContinuousBatcher: prefixes, chunked prefill and
per-request sampling, on the CPU.

Mirrors the rest of tests/test_batching.py on its tiny GPT-2 fixture
(see tests/test_torch_port_batching.py): every cache is f32, and each
request's tokens must equal the port's direct path
(TextInferenceInterface.generate_tokens on the scalar graph) exactly.
Sampled draws, whose random streams differ from jax.random, are held to
their greedy limits and to the filtered distribution instead.
"""

import numpy as np
import pytest
import torch

from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.interfaces.text import (
    SamplingParams, TextInferenceInterface, _filtered_logits,
    _pick_token_rows, _rows_flags, rows_tensors)
from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

from tests.test_torch_port_batching import V, _models

rng = np.random.default_rng(6)
CPU = torch.device("cpu")


def _direct(model, buckets, max_len=64):
    return TextInferenceInterface(model, max_len=max_len,
                                  prompt_buckets=buckets, device="cpu")


def _batcher(model, buckets, max_len=64, **kw):
    return ContinuousBatcher(model, max_len=max_len, cache_dtype=DType.F32,
                             prompt_buckets=buckets, device="cpu", **kw)


def _assert_sequential(ref, jobs, prefix=None):
    for p, n, f in jobs:
        full = p if prefix is None else np.concatenate([prefix, p])
        np.testing.assert_array_equal(
            f.result(timeout=180), ref.generate_tokens(full[None], n)[0],
            err_msg=f"L={len(p)} n={n}")


@pytest.mark.parametrize("pchunk", [None, 8])
def test_shared_prefix_kv_caching(pchunk):
    """prefix_ids: prefilled once and copied into every admission (two
    rows per admission group, slots reused); outputs equal the direct
    path fed prefix + prompt, whole-bucket and chunked."""
    m_scalar, m_ragged = _models()
    buckets = (8, 16, 32)
    ref = _direct(m_scalar, buckets)
    r = np.random.default_rng(17)
    prefix = r.integers(0, V, (11,)).astype(np.int64)
    b = _batcher(m_ragged, buckets, max_batch=2, chunk=3,
                 prefill_chunk=pchunk, prefix_ids=prefix)
    try:
        jobs = []
        for L, n in ((3, 7), (9, 5), (6, 8), (13, 4)):
            s = r.integers(0, V, (L,)).astype(np.int64)
            jobs.append((s, n, b.submit(s, n)))
        b.start()        # all queued: the first admission takes two rows
        _assert_sequential(ref, jobs, prefix)
        assert b.stats()["prefix_len"] == 11
    finally:
        b.stop()


def test_chunked_prefill_matches_sequential():
    """prefill_chunk: long prompts admit in pieces, one per tick, with
    lengths straddling piece boundaries, and short prompts take the
    whole-bucket path; all exact, and pieces really ran."""
    m_scalar, m_ragged = _models()
    buckets = (8, 16, 32)
    ref = _direct(m_scalar, buckets)
    b = _batcher(m_ragged, buckets, max_batch=4, chunk=3,
                 prefill_chunk=8).start()
    try:
        r = np.random.default_rng(13)
        jobs = []
        for L, n in ((3, 6), (9, 8), (16, 5), (23, 7), (14, 9), (5, 4)):
            p = r.integers(0, V, (L,)).astype(np.int64)
            jobs.append((p, n, b.submit(p, n)))
        _assert_sequential(ref, jobs)
        assert b._pieces_run > 0
    finally:
        b.stop()


def test_chunked_prefill_takes_prompts_beyond_the_largest_bucket():
    """A fault of the reference repaired in the port: with prefill_chunk,
    a prompt longer than the largest prompt bucket is prefilled in
    pieces (the reference buckets it first, batching.py:989-990, and the
    ValueError fails the whole tick). The direct path is given a bucket
    that fits it."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar, (16, 64))
    b = _batcher(m_ragged, (16,), max_batch=2, chunk=3,
                 prefill_chunk=8).start()
    try:
        r = np.random.default_rng(19)
        jobs = [(p, 6, b.submit(p, 6)) for p in
                (r.integers(0, V, (L,)).astype(np.int64) for L in (37, 5))]
        _assert_sequential(ref, jobs)
    finally:
        b.stop()


def test_chunked_admission_after_the_batcher_went_idle():
    """A fault of the reference repaired in the port: requests one after
    another under prefill_chunk. The first frees its slot while the
    batcher has no other work, so the slot's park is still queued when
    the second request's chunked admission reserves it; the reference
    (batching.py:1276-1280) counts that park as the new tenant's first
    dispatch and answers with the parked row's one token. Each answer
    must equal the direct path's."""
    m_scalar, m_ragged = _models()
    buckets = (8, 16, 32)
    ref = _direct(m_scalar, buckets)
    b = _batcher(m_ragged, buckets, max_batch=2, chunk=3,
                 prefill_chunk=8).start()
    try:
        r = np.random.default_rng(3)
        for L in (20, 20, 5, 17):
            p = r.integers(0, V, (L,)).astype(np.int64)
            _assert_sequential(ref, [(p, 6, b.submit(p, 6))])
    finally:
        b.stop()


@pytest.mark.parametrize("pchunk", [None, 8])
def test_per_request_sampling(pchunk):
    """Greedy, top_k=1 sampled and near-zero temperature rows equal the
    greedy reference while batched with a hot-temperature row; a huge
    presence penalty never repeats a token (prompt or generated); a
    greedy tenant after a penalty tenant is unaffected by stale counts.
    With prefill_chunk, the admission's first token honours the
    request's own params."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar, (16, 32))
    b = _batcher(m_ragged, (16, 32), max_batch=4, chunk=4,
                 prefill_chunk=pchunk).start()
    try:
        prompts = [rng.integers(0, V, (n,)).astype(np.int64)
                   for n in (5, 20, 3, 6)]
        sps = [None,
               SamplingParams(temperature=0.7, top_k=1, seed=3),
               SamplingParams(temperature=1e-5, seed=9),
               SamplingParams(temperature=1.3, top_p=0.9, seed=11)]
        futs = [b.submit(p, 10, sampling=sp) for p, sp in zip(prompts, sps)]
        _assert_sequential(ref, [(p, 10, f) for p, f in
                                 zip(prompts[:3], futs[:3])])
        hot = futs[3].result(timeout=180)
        assert hot.shape == (10,) and ((hot >= 0) & (hot < V)).all()

        p = np.unique(rng.integers(0, V, (6,)).astype(np.int64))
        sp = SamplingParams(temperature=1e-5, presence_penalty=1e9, seed=2)
        out = b.submit(p, 12, sampling=sp).result(timeout=180)
        emitted = list(p) + list(out)
        assert len(set(emitted)) == len(emitted), emitted

        q = rng.integers(0, V, (5,)).astype(np.int64)
        _assert_sequential(ref, [(q, 8, b.submit(q, 8))])
    finally:
        b.stop()


def test_greedy_penalties_match_the_direct_path():
    """temperature 0 with the three penalties: the batcher's per-row
    counts (seeded at admission, advanced in every chunk step) give the
    direct path's tokens."""
    m_scalar, m_ragged = _models()
    ref = _direct(m_scalar, (16,))
    sp = SamplingParams(temperature=0.0, repetition_penalty=1.3,
                        presence_penalty=0.5, frequency_penalty=0.2)
    b = _batcher(m_ragged, (16,), max_batch=2, chunk=3).start()
    try:
        prompts = [rng.integers(0, V, (n,)).astype(np.int64) for n in (6, 9)]
        futs = [b.submit(p, 9, sampling=sp) for p in prompts]
        for p, f in zip(prompts, futs):
            np.testing.assert_array_equal(
                f.result(timeout=180),
                ref.generate_tokens(p[None], 9, sampling=sp)[0])
    finally:
        b.stop()


def test_auto_prefix_caching_matches_sequential():
    """auto_prefix: prompts sharing a >= 32-token prefix reuse the pool
    entry (prefilling only the remainder); exact, hits counted, LRU cap
    kept; an unrelated prompt neither hits nor poisons the pool."""
    m_scalar, m_ragged = _models(96)
    buckets = (16, 32, 64)
    ref = _direct(m_scalar, buckets, 96)
    b = _batcher(m_ragged, buckets, max_len=96, max_batch=2, chunk=4,
                 auto_prefix=2).start()
    try:
        r = np.random.default_rng(31)
        base = r.integers(0, V, (40,)).astype(np.int64)
        jobs = []
        for tail_len in (3, 7, 2, 11):
            p = np.concatenate([base, r.integers(0, V, (tail_len,))
                                .astype(np.int64)])
            f = b.submit(p, 6)
            f.result(timeout=180)      # serialize so reuse is observable
            jobs.append((p, 6, f))
        _assert_sequential(ref, jobs)
        st = b.stats()["auto_prefix"]
        assert st["hits"] >= 3 and st["pool"] <= 2, st
        q = r.integers(0, V, (9,)).astype(np.int64)
        _assert_sequential(ref, [(q, 5, b.submit(q, 5))])
    finally:
        b.stop()


def test_auto_prefix_entry_survives_slot_reuse():
    """The pool keeps a COPY of the slot's rows: one slot, an unrelated
    tenant between the deposit and the hit overwrites that slot, and the
    hit is still exact."""
    m_scalar, m_ragged = _models(96)
    buckets = (16, 32, 64)
    ref = _direct(m_scalar, buckets, 96)
    b = _batcher(m_ragged, buckets, max_len=96, max_batch=1, chunk=4,
                 auto_prefix=2).start()
    try:
        r = np.random.default_rng(43)
        base = r.integers(0, V, (35,)).astype(np.int64)
        first = np.concatenate([base, r.integers(0, V, (4,))])
        other = r.integers(0, V, (60,)).astype(np.int64)   # no shared prefix
        hit = np.concatenate([base, r.integers(0, V, (9,))])
        jobs = []
        for p in (first, other, hit):
            f = b.submit(p, 7)
            f.result(timeout=180)
            jobs.append((p, 7, f))
        _assert_sequential(ref, jobs)
        assert b.stats()["auto_prefix"]["hits"] == 1
    finally:
        b.stop()


def test_auto_prefix_mixed_group_partitions():
    """One admission wave mixing hit and miss rows splits into per-plen
    prefill groups; every output stays exact."""
    m_scalar, m_ragged = _models(96)
    buckets = (16, 32, 64)
    ref = _direct(m_scalar, buckets, 96)
    b = _batcher(m_ragged, buckets, max_len=96, max_batch=4, chunk=3,
                 auto_prefix=4).start()
    try:
        r = np.random.default_rng(37)
        base = r.integers(0, V, (33,)).astype(np.int64)
        b.submit(base, 4).result(timeout=180)
        prompts = [np.concatenate([base, r.integers(0, V, (5,))]),
                   np.concatenate([base, r.integers(0, V, (2,))]),
                   r.integers(0, V, (12,)), r.integers(0, V, (6,))]
        _assert_sequential(ref, [(p.astype(np.int64), 5, b.submit(p, 5))
                                 for p in prompts])
        assert b.stats()["auto_prefix"]["hits"] >= 2
    finally:
        b.stop()


# -- the batched sampler ------------------------------------------------------
def _rows(sps):
    return rows_tensors(sps, CPU), _rows_flags(sps)


def test_sampled_rows_follow_the_filtered_distribution():
    """20,000 rows of the same logits with distinct seeds, one key: each
    token's frequency within 0.012 of softmax of the reference-filtered
    logits (4 binomial standard deviations at most 0.0035)."""
    sp = SamplingParams(temperature=0.8, top_k=6, top_p=0.95, min_p=0.02)
    lg = torch.from_numpy(np.random.default_rng(4).standard_normal(12)
                          .astype(np.float32))
    n = 20000
    sps = [SamplingParams(**{**sp.__dict__, "seed": s}) for s in range(n)]
    rows, flags = _rows(sps)
    draws = _pick_token_rows(lg.expand(n, 12), 12345, rows, flags).numpy()
    p = torch.softmax(_filtered_logits(lg[None], sp), -1)[0].numpy()
    freq = np.bincount(draws, minlength=12) / n
    np.testing.assert_allclose(freq, p, atol=0.012, rtol=0)
    assert (freq[p == 0] == 0).all()


def test_a_rows_draws_do_not_depend_on_its_neighbours():
    """Row 1's draw depends on its logits, its seed and the key only:
    changing the other rows' logits or params leaves it alone; another
    seed or key moves it."""
    lg = torch.from_numpy(np.random.default_rng(8).standard_normal((3, V))
                          .astype(np.float32))
    sps = [SamplingParams(temperature=1.0, seed=s) for s in (1, 2, 3)]
    rows, flags = _rows(sps)
    base = _pick_token_rows(lg, 77, rows, flags)
    lg2 = lg.clone()
    lg2[[0, 2]] = torch.randn(2, V)
    sps2 = [None, sps[1], SamplingParams(temperature=0.3, top_k=5, seed=9)]
    rows2, flags2 = _rows(sps2)
    assert _pick_token_rows(lg2, 77, rows2, flags2)[1] == base[1]
    draws = {int(_pick_token_rows(lg, key, rows, flags)[1])
             for key in range(40)}
    assert len(draws) > 5


@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.9, top_k=1, seed=3),
    SamplingParams(temperature=1.0, min_p=1.0, seed=4),
    SamplingParams(temperature=1.2, top_p=1e-6, seed=5),
    SamplingParams(temperature=0.0, seed=6)])
def test_sampled_rows_greedy_limits_equal_argmax(sp):
    lg = torch.from_numpy(np.random.default_rng(9).standard_normal((4, V))
                          .astype(np.float32))
    rows, flags = _rows([sp, None, sp, sp])
    np.testing.assert_array_equal(
        _pick_token_rows(lg, 3, rows, flags).numpy(),
        lg.argmax(-1).numpy())
