"""int8_matmul_dx, the backward of int8_matmul for x, on the CPU: its
launch plan (dx_plan), the numerics of its kernels' hi/lo split, and the
plain version against the JAX package's jax.vjp of int8_matmul.

The kernels themselves (csrc/int8_matmul_dx.cu) run only on the card
(tests/test_torch_port_cuda.py). Here dx_plan runs with the CPU
defaults of what it reads of each path's kernel (DX_LIMITS, an H100's
132 multiprocessors).

Tolerances, and why:
  * the split: every kernel takes v = dy * scale in f32 and sums hi @ W
    + lo @ W, hi = bf16(v), lo = bf16(v - hi). Emulated in float64 (the
    products exact, the sums off by far less than the bound), the split
    moves each output by at most 2^-17 of the sum of |v * W| over the
    reduction: half of agreement_bound's 2^-16 * magnitude term, which
    alone bounds a row whose sum cancels;
  * jax.vjp: 1e-5 relative (both sum the same f32 products, in other
    orders).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.backends.pallas.quant_matmul import (  # noqa: E402
    int8_matmul as jax_int8_matmul)
from whisper_tensor_tpu_torch.backends.cuda import (  # noqa: E402
    quant_matmul as qm)
from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (  # noqa: E402
    DxLimits, DxPlan, Int8MatMul, dx_limits, dx_plan, int8_matmul_dx,
    int8_matmul_plain)

# Llama-3-8B's int8 weights as QLoRA trains them, (K, N) of W
QLORA_SHAPES = {"q/o": (4096, 4096), "k/v": (4096, 1024),
                "gate/up": (4096, 14336), "down": (14336, 4096),
                "lm_head": (4096, 128256)}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("bf16", [True, False])
def test_the_cpu_defaults_are_the_kernels_limits_on_an_h100(bf16):
    assert dx_limits("tma", bf16) == DxLimits(64, 128, 256, 1, 132)
    assert dx_limits("cp.async", bf16) == DxLimits(32, 128, 128, 2, 132)


@pytest.mark.parametrize("name", sorted(QLORA_SHAPES))
@pytest.mark.parametrize("dt", DTYPES)
def test_dx_plan_routes_the_qlora_shapes_to_the_tma_path(name, dt):
    K, N = QLORA_SHAPES[name]
    plan = dx_plan(1024, K, N, dt)
    # 8 x 16 blocks or more: a wave, so the reduction is not split
    assert plan == DxPlan("tma", 1, -(-N // 64) * 64)


@pytest.mark.parametrize("K,N,dt", [
    (1000, 771, torch.bfloat16),      # N odd
    (4096, 129, torch.bfloat16),
    (257, 4096, torch.bfloat16),      # K odd
    (257, 4096, torch.float32),
    (4096, 4104, torch.bfloat16),     # W's rows not whole 16-byte units
    (4096, 4104, torch.float32),
    (4100, 4096, torch.bfloat16),     # bf16 dx rows not whole 16 bytes
    (4098, 4096, torch.float32),      # f32 dx rows not whole 16 bytes
    (4098, 4096, torch.float16),      # f16 runs as f32
])
def test_dx_plan_routes_what_tma_cannot_describe_to_cp_async(K, N, dt):
    plan = dx_plan(1024, K, N, dt)
    assert plan.path == "cp.async"
    assert plan.split_cols % 32 == 0
    assert (plan.splits - 1) * plan.split_cols < N <= \
        plan.splits * plan.split_cols
    assert not qm.dx_tma_takes(K, N, dt == torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (5, 4096, 1024),
                                   (1000, 1000, 4096), (1, 14336, 4096),
                                   (2048, 4096, 1024), (1, 264, 48),
                                   (1, 4096, 128256)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32,
                                torch.float16])
def test_dx_plan_splits_the_reduction_on_whole_stages(M, K, N, dt):
    plan = dx_plan(M, K, N, dt)
    assert plan.path == "tma"
    assert plan.split_cols % 64 == 0
    assert (plan.splits - 1) * plan.split_cols < N <= \
        plan.splits * plan.split_cols
    blocks = -(-M // 128) * -(-K // 256)
    if blocks >= 132:
        assert plan.splits == 1
    else:
        # never past two waves, and a grid under a wave is cut when the
        # reduction has stages to cut
        assert blocks * plan.splits <= 2 * 132
        assert plan.splits > 1 or N <= 64


def test_dx_plan_splits_small_grids_and_leaves_waves_whole():
    assert dx_plan(1, 4096, 4096) == DxPlan("tma", 8, 512)
    # the odd shape: 8 x 8 blocks of a wave of 264 (two a multiprocessor)
    assert dx_plan(1024, 1000, 771) == DxPlan("cp.async", 4, 224)
    assert dx_plan(1024, 14336, 4100) == DxPlan("cp.async", 1, 4128)
    assert dx_plan(1000, 1000, 4096) == DxPlan("tma", 4, 1024)
    assert dx_plan(1024, 14336, 4096) == DxPlan("tma", 1, 4096)
    assert dx_plan(1, 264, 48) == DxPlan("tma", 1, 64)
    assert dx_plan(2048, 4096, 1024).splits == 1


def test_the_wrapper_counts_launches_by_path():
    assert set(int8_matmul_dx.path_launches) == {"tma", "cp.async"}
    n, paths = int8_matmul_dx.launches, dict(int8_matmul_dx.path_launches)
    dy = torch.randn(3, 32)
    int8_matmul_dx(dy, torch.ones(16, 32, dtype=torch.int8), torch.ones(32))
    # the CPU takes the plain version: no kernel, no count
    assert int8_matmul_dx.launches == n
    assert int8_matmul_dx.path_launches == paths


@pytest.mark.parametrize("N", [4096, 128256])
def test_the_hi_lo_split_stays_within_the_magnitude_term(N):
    rng = np.random.default_rng(N)
    K = 4
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    w[3] = w[3].abs().clamp_min(1)         # a row whose errors add up
    scale = torch.from_numpy((rng.random(N) * 0.01 + 1e-3).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal((4, N)).astype(np.float32))
    dy = dy.bfloat16().float()
    # row 1: planted cancellation against W's row 0. Pairs of columns
    # (n, n + N/2) get W[0, n + N/2] = -W[0, n] and nearly equal dy * scale,
    # so the exact sum is a small remainder of a large magnitude
    h = N // 2
    w[0, h:] = -w[0, :h]
    scale[h:] = scale[:h]
    dy[1, h:] = (dy[1, :h] * (1 + 2.0 ** -7)).bfloat16().float()
    # row 2: values whose split falls on the tie of its second rounding
    # (v = 1 + 2^-9 + 2^-17 gives hi = 1, lo = 2^-9, an error of 2^-17),
    # summed against W's positive row 3
    dy[2] = 1.0
    scale_tie = torch.full((N,), 1 + 2.0 ** -9 + 2.0 ** -17)
    v = dy.float() * scale                                # f32, as the kernels
    v[2] = dy[2] * scale_tie
    hi = v.bfloat16().float()
    lo = (v - hi).bfloat16().float()
    wd = w.double()
    exact = v.double() @ wd.t()
    split = (hi.double() + lo.double()) @ wd.t()
    magnitude = v.double().abs() @ wd.abs().t()
    err = (split - exact).abs()
    assert bool((err <= 2.0 ** -17 * magnitude).all()), \
        (err / magnitude).max().item()
    # the planted row cancels: its result is far below its magnitude, so
    # the bound's ulp term gives no room and the magnitude term holds it
    assert exact[1, 0].abs() < 0.01 * magnitude[1, 0]
    # the tie row's error is the whole 2^-17 of each term
    assert float(err[2, 3] / magnitude[2, 3]) > 2.0 ** -18


@pytest.mark.parametrize("M,K", [(4, 64), (3, 40)])
def test_f32_dy_at_n_4096_matches_the_jax_vjp(M, K):
    N = 4096
    rng = np.random.default_rng(M * K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    wt, st, dyt = torch.from_numpy(w), torch.from_numpy(s), \
        torch.from_numpy(dy)
    got = int8_matmul_dx(dyt, wt, st).numpy()
    xt = torch.from_numpy(x).requires_grad_(True)
    Int8MatMul.apply(xt, wt, st).backward(dyt)
    np.testing.assert_array_equal(xt.grad.numpy(), got)
    xr = torch.from_numpy(x).requires_grad_(True)
    int8_matmul_plain(xr, wt, st).backward(dyt)
    np.testing.assert_array_equal(xr.grad.numpy(), got)
    jnp = jax.numpy
    _, vjp = jax.vjp(lambda a: jax_int8_matmul(a, jnp.asarray(w),
                                               jnp.asarray(s)),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
