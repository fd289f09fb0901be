"""The ragged KV-cache write of the PyTorch port against the JAX package.

`ragged_kv_write_plain` (the plain version of the CUDA kernel in
whisper_tensor_tpu_torch/csrc/kv_write.cu) must equal, bit for bit, the
numpy oracle `DynUpdateSliceMilli.eval` and the JAX package's
`DynUpdateSliceMilli.to_jax`, which on the CPU takes its vmapped
dynamic_update_slice (the Pallas kernel's gate needs a TPU). It is a
copy, so the tolerance is zero. Inputs come from numpy with fixed
seeds."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from whisper_tensor_tpu.milli.ops.misc import DynUpdateSliceMilli  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.kv_write import (  # noqa: E402
    ragged_kv_write, ragged_kv_write_plain)
from whisper_tensor_tpu_torch.dtype import to_device, to_host  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS  # noqa: E402

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
