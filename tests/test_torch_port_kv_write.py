"""The ragged KV-cache write of the PyTorch port against the JAX package.

`ragged_kv_write_plain` (the plain version of the CUDA kernel in
whisper_tensor_tpu_torch/csrc/kv_write.cu) must equal, bit for bit, the
numpy oracle `DynUpdateSliceMilli.eval` and the JAX package's
`DynUpdateSliceMilli.to_jax`, which on the CPU takes its vmapped
dynamic_update_slice (the Pallas kernel's gate needs a TPU). It is a
copy, so the tolerance is zero. The same holds for the pair, a layer's
K and V writes in one call (kv_write_pair, the KVWrite op's lowering):
two of the reference's writes, bit for bit. The kernel's launch plan is
held at its CPU defaults (the H100's). Inputs come from numpy with fixed
seeds."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from whisper_tensor_tpu.milli.ops.misc import DynUpdateSliceMilli  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.kv_write import (  # noqa: E402
    kv_write_limits, kv_write_pair, kv_write_pair_plain, kv_write_plan,
    ragged_kv_write, ragged_kv_write_plain)
from whisper_tensor_tpu_torch.dtype import to_device, to_host  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import (  # noqa: E402
    LOWERINGS, KVWriteMilli)

CPU = torch.device("cpu")
B, H, L, D = 3, 2, 16, 8
_NP = {"f32": np.float32, "bf16": jnp.bfloat16}


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _inputs(S, cache_dt, upd_dt, seed):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((B, H, L, D)).astype(np.float32).astype(
        _NP[cache_dt])
    upd = rng.standard_normal((B, H, S, D)).astype(np.float32).astype(
        _NP[upd_dt])
    return cache, upd


# (S, positions): in range, the ends; then beyond L - S (clamped) and
# negative (counted from the end, then clamped), as jax.lax does
IN_RANGE = [(1, [0, L - 1, 7]), (4, [0, L - 4, 5])]
CLAMPED = [(1, [L + 3, -2, 9]), (4, [L - 1, 100, -7])]
DTYPES = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")]


@pytest.mark.parametrize("S,pos", IN_RANGE + CLAMPED)
@pytest.mark.parametrize("cache_dt,upd_dt", DTYPES)
def test_plain_version_equals_the_jax_package(S, pos, cache_dt, upd_dt):
    """Against to_jax (a negative start counts from the end, then the
    start is clamped) and, for starts in range, the numpy oracle; an f32
    update into a bf16 cache rounds to nearest even in all three. The
    result is the cache passed in."""
    cache, upd = _inputs(S, cache_dt, upd_dt, S * 31 + len(cache_dt))
    start = np.asarray(pos, np.int64)
    op = DynUpdateSliceMilli(axis=2)
    want = op.to_jax([jnp.asarray(cache), jnp.asarray(upd),
                      jnp.asarray(start)])[0]
    t = to_device(cache, CPU)
    got = ragged_kv_write_plain(t, to_device(upd, CPU),
                                torch.from_numpy(start))
    assert got is t
    assert _bits(to_host(got)) == _bits(want)
    if (S, pos) in IN_RANGE:
        assert _bits(to_host(got)) == _bits(op.eval([cache, upd, start])[0])


@pytest.mark.parametrize("cache_dt,upd_dt", DTYPES)
def test_plain_version_reads_a_transposed_update(cache_dt, upd_dt):
    """The llama recipe hands V to the write as the Transpose view of a
    Reshape: (B, S, H, D) seen as (B, H, S, D). Same bits as the
    contiguous update."""
    cache, upd = _inputs(4, cache_dt, upd_dt, 5)
    start = torch.tensor([2, 0, L - 4])
    view = to_device(np.ascontiguousarray(upd.transpose(0, 2, 1, 3)),
                     CPU).transpose(1, 2)
    assert not view.is_contiguous()
    got = ragged_kv_write_plain(to_device(cache, CPU), view, start)
    want = ragged_kv_write_plain(to_device(cache, CPU), to_device(upd, CPU),
                                 start)
    assert _bits(to_host(got)) == _bits(to_host(want))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    cache, upd = _inputs(1, "bf16", "bf16", 9)
    start = torch.tensor([3, 15, 0], dtype=torch.int32)
    n0 = ragged_kv_write.launches
    got = ragged_kv_write(to_device(cache, CPU), to_device(upd, CPU), start)
    want = ragged_kv_write_plain(to_device(cache, CPU), to_device(upd, CPU),
                                 start)
    assert _bits(to_host(got)) == _bits(to_host(want))
    assert ragged_kv_write.launches == n0      # no kernel launched


@pytest.mark.parametrize("shape,start_shape,axis,routed", [
    ((B, H, L, D), (B,), 2, True),        # the batcher's per-row write
    ((B, H, L, D), (), 2, False),         # scalar start: index_copy_
    ((B, L, H * D), (B,), 1, False),      # per-row start, 3-D: indexed
    ((B, H, L, D), (B,), 3, False),       # per-row start on another axis
])
def test_lowering_routes_per_row_cache_writes_to_the_kernel_wrapper(
        monkeypatch, shape, start_shape, axis, routed):
    """Only a per-row start on axis 2 of a 4-D cache goes to
    ragged_kv_write (on a CUDA device it then launches the kernel or
    raises); every form writes in place and equals to_jax."""
    from whisper_tensor_tpu_torch.milli.ops import misc

    calls = []

    def spy(*args):
        calls.append(args)
        return ragged_kv_write(*args)

    monkeypatch.setattr(misc, "ragged_kv_write", spy)
    rng = np.random.default_rng(len(shape) + axis)
    data = rng.standard_normal(shape).astype(np.float32)
    ushape = list(shape)
    ushape[axis] = 2
    upd = rng.standard_normal(ushape).astype(np.float32)
    start = (np.asarray([1, 4, 0][:B], np.int64) if start_shape
             else np.asarray(3, np.int64))
    op = DynUpdateSliceMilli(axis=axis)
    t = to_device(data, CPU)
    out = LOWERINGS["DynUpdateSlice"](op, [t, to_device(upd, CPU),
                                           torch.from_numpy(start)],
                                      [None] * 3, CPU)[0]
    assert out is t
    assert len(calls) == int(routed)
    want = op.to_jax([jnp.asarray(data), jnp.asarray(upd),
                      jnp.asarray(start)])[0]
    assert _bits(to_host(out)) == _bits(want)


# -- the pair: a layer's K and V writes in one call (KVWrite) ---------------

# (S, start): per-row starts in range, negative ones the numpy oracle
# counts from the end as jax.lax does, and ones beyond L - S that clamp;
# then the same three for a scalar start, the direct path's
PAIR_STARTS = [(1, [0, L - 1, 7]), (4, [0, L - 4, 5]), (1, [-3, -2, -16]),
               (4, [-5, -9, -16]), (1, [L + 3, -20, 9]), (4, [L - 1, 100, -2]),
               (1, 5), (4, L - 4), (1, -2), (4, -6), (1, L), (4, -30)]


def _in_oracle_range(S, start):
    """numpy slicing agrees with jax.lax's clamp: 0 <= s <= L - S, or a
    negative s whose slice ends before the end (s + S < 0)."""
    return all((0 <= s <= L - S) or (-L <= s and s + S < 0)
               for s in np.atleast_1d(start))


@pytest.mark.parametrize("S,start", PAIR_STARTS)
@pytest.mark.parametrize("cache_dt,upd_dt", DTYPES)
def test_pair_plain_version_is_two_reference_writes(S, start, cache_dt,
                                                    upd_dt):
    """KVWriteMilli.eval and kv_write_pair_plain (what the KVWrite
    lowering takes on the CPU), bit for bit: two of the JAX package's
    DynUpdateSliceMilli.to_jax writes and, where numpy slicing defines
    the start, two of its numpy evals. V's update is the llama recipe's
    transposed view."""
    ck, uk = _inputs(S, cache_dt, upd_dt, S * 7 + len(cache_dt))
    cv, uv = _inputs(S, cache_dt, upd_dt, S * 7 + len(cache_dt) + 1)
    start = np.asarray(start, np.int64)
    ref = DynUpdateSliceMilli(axis=2)
    want = [ref.to_jax([jnp.asarray(c), jnp.asarray(u),
                        jnp.asarray(start)])[0]
            for c, u in ((ck, uk), (cv, uv))]
    v_view = to_device(np.ascontiguousarray(uv.transpose(0, 2, 1, 3)),
                       CPU).transpose(1, 2)
    tk, tv = to_device(ck, CPU), to_device(cv, CPU)
    got = kv_write_pair_plain(tk, to_device(uk, CPU), tv, v_view,
                              torch.from_numpy(start))
    assert got[0] is tk and got[1] is tv
    assert [_bits(to_host(g)) for g in got] == [_bits(w) for w in want]
    if _in_oracle_range(S, start):
        evals = KVWriteMilli(axis=2).eval([ck, uk, cv, uv, start])
        assert [_bits(e) for e in evals] == [_bits(w) for w in want]
        assert [_bits(e) for e in evals] == [
            _bits(ref.eval([c, u, start])[0]) for c, u in ((ck, uk), (cv, uv))]


@pytest.mark.parametrize("start_shape", [(B,), ()])
def test_kv_write_lowering_calls_the_pair_wrapper(monkeypatch, start_shape):
    """The KVWrite lowering is one kv_write_pair call for a per-row and a
    scalar start (on a CUDA device one launch, or a raise), in place,
    equal to the reference's two writes."""
    from whisper_tensor_tpu_torch.milli.ops import misc

    calls = []

    def spy(*args):
        calls.append(args)
        return kv_write_pair(*args)

    monkeypatch.setattr(misc, "kv_write_pair", spy)
    ck, uk = _inputs(2, "bf16", "bf16", 11)
    cv, uv = _inputs(2, "bf16", "bf16", 12)
    start = (np.asarray([1, 14, -3], np.int64) if start_shape
             else np.asarray(-2, np.int64))
    tk, tv = to_device(ck, CPU), to_device(cv, CPU)
    n0 = ragged_kv_write.launches, kv_write_pair.launches
    out = LOWERINGS["KVWrite"](KVWriteMilli(axis=2),
                               [tk, to_device(uk, CPU), tv,
                                to_device(uv, CPU), torch.from_numpy(start)],
                               [None] * 5, CPU)
    assert len(calls) == 1 and out[0] is tk and out[1] is tv
    assert (ragged_kv_write.launches, kv_write_pair.launches) == n0
    ref = DynUpdateSliceMilli(axis=2)
    for got, (c, u) in zip(out, ((ck, uk), (cv, uv))):
        want = ref.to_jax([jnp.asarray(c), jnp.asarray(u),
                           jnp.asarray(start)])[0]
        assert _bits(to_host(got)) == _bits(want)


# (caches, B, H, S, D, cache bytes, update bytes) -> (units a slab, units,
# blocks) at the CPU defaults (128 threads a block, 16 blocks a
# multiprocessor, 132 multiprocessors): a decode pair of 16 slots (one
# 16-byte vector a thread), a 128-row piece of 4 rows (1,024 blocks over
# the card), GPT-2's decode pair at 64 slots, the direct path's scalar
# start, an f32 cache, f32 into bf16, a head dim that is no multiple of a
# unit, one cache, and a prefill larger than a wave
PLANS = [((2, 16, 8, 1, 128, 2, 2), (16, 4096, 32)),
         ((2, 4, 8, 128, 128, 2, 2), (2048, 131072, 1024)),
         ((2, 64, 12, 1, 64, 2, 2), (8, 12288, 96)),
         ((2, 1, 8, 1, 128, 2, 2), (16, 256, 2)),
         ((2, 1, 8, 32, 128, 2, 2), (512, 8192, 64)),
         ((2, 16, 8, 1, 128, 4, 4), (32, 8192, 64)),
         ((2, 16, 8, 1, 128, 2, 4), (16, 4096, 32)),
         ((2, 3, 2, 3, 5, 2, 2), (2, 24, 1)),
         ((1, 16, 8, 1, 128, 2, 2), (16, 2048, 16)),
         ((2, 16, 8, 2048, 128, 2, 2), (32768, 8388608, 2112))]


@pytest.mark.parametrize("args,want", PLANS)
def test_kv_write_plan_at_the_cpu_defaults(args, want):
    """One 16-byte unit of the cache a thread while one wave holds them
    all, else one wave of 16 blocks a multiprocessor whose threads stride
    over the rest."""
    plan = kv_write_plan(*args)
    assert (plan.units_per_slab, plan.units, plan.blocks) == want
    threads, per_sm, sms = kv_write_limits(*args[5:])
    assert (threads, per_sm, sms) == (128, 16, 132)
    assert plan.blocks == min(-(-plan.units // threads), per_sm * sms)


def test_pair_wrapper_takes_the_plain_version_on_the_cpu():
    ck, uk = _inputs(1, "bf16", "f32", 13)
    cv, uv = _inputs(1, "bf16", "f32", 14)
    start = torch.tensor(4)
    n0 = ragged_kv_write.launches, kv_write_pair.launches
    got = kv_write_pair(to_device(ck, CPU), to_device(uk, CPU),
                        to_device(cv, CPU), to_device(uv, CPU), start)
    want = kv_write_pair_plain(to_device(ck, CPU), to_device(uk, CPU),
                               to_device(cv, CPU), to_device(uv, CPU), start)
    assert [_bits(to_host(g)) for g in got] == [
        _bits(to_host(w)) for w in want]
    assert (ragged_kv_write.launches, kv_write_pair.launches) == n0
