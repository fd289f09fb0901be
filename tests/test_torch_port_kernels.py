"""The PyTorch port's kernels: plain versions against the JAX package.

Each CUDA kernel of whisper_tensor_tpu_torch has a plain PyTorch
version beside its wrapper; on the CPU the wrapper runs it. Here those
plain versions are held against the TPU kernels they replace, run the
way the JAX package's own tests run them on the CPU (Pallas interpret
mode, or the jnp form), and against the milli oracle. Inputs come from
numpy with fixed seeds. The kernels themselves are compared with their
plain versions on a GPU by tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from whisper_tensor_tpu.backends.pallas.decode_attention import (  # noqa: E402
    ragged_decode_attention)
from whisper_tensor_tpu.backends.pallas.quant_matmul import (  # noqa: E402
    int8_matmul as jax_int8_matmul, quantize_int8)
from whisper_tensor_tpu.milli.ops.attention import AttentionMilli  # noqa: E402
from whisper_tensor_tpu.milli.transforms import QuantMatMulMilli  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (  # noqa: E402
    int8_matmul, int8_matmul_plain)
from whisper_tensor_tpu_torch.dtype import to_device, to_host  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS  # noqa: E402

CPU = torch.device("cpu")


def _bf16(x):
    """numpy f32 -> bf16-representable f32 (rounded like the device)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _attn_inputs(B, Hq, Hkv, L, D, seed):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((B, Hq, 1, D)))
    k = _bf16(rng.standard_normal((B, Hkv, L, D)))
    v = _bf16(rng.standard_normal((B, Hkv, L, D)))
    return q, k, v


DECODE_SHAPES = [(4, 8, 2, 192, 128), (2, 4, 4, 256, 128),
                 (3, 16, 2, 512, 128), (1, 32, 8, 64, 128)]


@pytest.mark.parametrize("B,Hq,Hkv,L,D", DECODE_SHAPES)
def test_decode_attention_plain_matches_pallas_interpret(B, Hq, Hkv, L, D):
    """bf16 in and out on both sides. Tolerance 2e-2 absolute (outputs
    are O(1)): the Pallas kernel rounds its probabilities to bf16 before
    the value product (2^-8 relative each) and both round the output to
    bf16; the plain version keeps the probabilities in f32."""
    q, k, v = _attn_inputs(B, Hq, Hkv, L, D, seed=B + L)
    pos = np.asarray([0, L - 1, L // 2, 7][:B], np.int32)
    scale = 1.0 / np.sqrt(D)
    want = ragged_decode_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(pos), scale, interpret=True)
    got = decode_attention_plain(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(pos), scale)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("B,Hq,Hkv,L,D", DECODE_SHAPES)
def test_decode_attention_plain_matches_oracle_f32(B, Hq, Hkv, L, D):
    """The algorithm in f32 against AttentionMilli.eval's rank-1
    position mask: the same f32 arithmetic in another summation order,
    so 1e-5."""
    q, k, v = _attn_inputs(B, Hq, Hkv, L, D, seed=2 * B + L)
    pos = np.asarray([3, L - 1, 0, L // 3][:B], np.int64)
    scale = 1.0 / np.sqrt(D)
    want = AttentionMilli(scale=scale).eval([q, k, v, pos])[0]
    got = decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(pos), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_decode_attention_pos_forms_and_clamp():
    """pos as () or (B,), int64 or int32; a position beyond the cache
    attends every key, as the TPU kernel's clamp to L-1 does."""
    B, Hq, Hkv, L, D = 2, 4, 2, 32, 128
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _attn_inputs(B, Hq, Hkv, L, D, seed=5))
    scale = 0.1
    full = decode_attention(q, k, v, torch.tensor([L - 1, L - 1]), scale)
    for pos in (torch.tensor(L - 1), torch.tensor(L + 100, dtype=torch.int32),
                torch.tensor([L - 1, 10 * L], dtype=torch.int32)):
        torch.testing.assert_close(decode_attention(q, k, v, pos, scale),
                                   full, atol=0, rtol=0)


def _attention_lowering(q, k, v, mask, scale):
    op = AttentionMilli(scale=scale)
    return LOWERINGS["Attention"](op, [q, k, v, mask], [None] * 4, CPU)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 4])
def test_attention_rank0_equals_rank1_equals_dense(dtype, Sq):
    """A rank-0 position mask is broadcast to (B,) (not read as an
    additive mask): rank 0 == rank 1 == the dense additive mask built
    from the same positions. f32 exact up to 1e-6; bf16 within 2e-2
    (the bf16 single-query path is the decode kernel's plain version,
    the dense path rounds its probabilities to bf16)."""
    rng = np.random.default_rng(Sq)
    B, Hq, Hkv, L, D = 3, 4, 2, 32, 128
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D),
                                             dtype=np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, L, D),
                                             dtype=np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((B, Hkv, L, D),
                                             dtype=np.float32)).to(dtype)
    p = 9
    y0 = _attention_lowering(q, k, v, torch.tensor(p), 0.1)
    y1 = _attention_lowering(q, k, v, torch.full((B,), p), 0.1)
    j = torch.arange(L).view(1, 1, 1, L)
    s = torch.arange(Sq).view(1, 1, Sq, 1)
    dense = torch.where(j <= p + s, 0.0, -1e30).expand(B, 1, Sq, L)
    yd = _attention_lowering(q, k, v, dense.float(), 0.1)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y0, y1, atol=0, rtol=0)
    torch.testing.assert_close(y0.float(), yd.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("Hq,Hkv,D,qdt,kvdt,Sq,routed", [
    (2, 1, 128, torch.bfloat16, torch.bfloat16, 1, True),
    (32, 2, 128, torch.bfloat16, torch.bfloat16, 1, True),  # 16 per group
    (4, 2, 64, torch.bfloat16, torch.bfloat16, 1, True),    # the kernel raises
    (4, 2, 128, torch.float32, torch.bfloat16, 1, True),    # f32 model
    (4, 2, 128, torch.float32, torch.float32, 1, False),    # f32 cache
    (4, 2, 128, torch.bfloat16, torch.bfloat16, 4, False),  # prefill
])
def test_attention_lowering_routes_decode_steps_to_the_kernel_wrapper(
        monkeypatch, Hq, Hkv, D, qdt, kvdt, Sq, routed):
    """Every single-query step over a bf16 cache goes to decode_attention,
    whatever its head dim or group size: on a CUDA device the wrapper
    then launches the kernel or raises, so no shape takes the plain path
    there unseen. Here, on the CPU, the wrapper runs the plain version."""
    from whisper_tensor_tpu_torch.milli.ops import attention as lowering

    calls = []

    def spy(*args):
        calls.append(args)
        return decode_attention(*args)

    monkeypatch.setattr(lowering, "decode_attention", spy)
    rng = np.random.default_rng(Hq + D)
    B, L = 2, 16
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D),
                                             dtype=np.float32)).to(qdt)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, L, D),
                                                 dtype=np.float32)).to(kvdt)
            for _ in range(2))
    pos = torch.tensor([3, 9])
    y = _attention_lowering(q, k, v, pos, 0.1)
    assert len(calls) == int(routed)
    assert y.shape == (B, Hq, Sq, D) and y.dtype == qdt
    if routed:
        torch.testing.assert_close(
            y, decode_attention_plain(q, k, v, pos, 0.1), atol=0, rtol=0)


INT8_SHAPES = [(1, 256, 384), (8, 384, 512), (33, 256, 128), (600, 128, 256)]


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_plain_matches_jax_and_oracle(M, K, N, dtype):
    """The plain version against the JAX package's int8_matmul (on the
    CPU it takes its jnp form, as above 512 rows on the chip) and
    QuantMatMulMilli.eval. Both sum exact f32 products in f32: 1e-5
    relative in f32; in bf16 the single rounding of the result may land
    one bf16 ulp apart, 2^-7 of the output's scale."""
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w_i8, scale = quantize_int8(rng.standard_normal((K, N)) * 0.05)
    if dtype == "bf16":
        x = _bf16(x)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want_jax = np.asarray(jax_int8_matmul(jnp.asarray(x, jdt),
                                          jnp.asarray(w_i8),
                                          jnp.asarray(scale)), np.float32)
    want_oracle = QuantMatMulMilli().eval([x, w_i8, scale])[0]
    got = int8_matmul_plain(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(w_i8),
                            torch.from_numpy(scale)).float().numpy()
    mag = float(np.abs(want_oracle).max())
    tol = dict(atol=1e-5 * mag, rtol=1e-5) if dtype == "f32" else \
        dict(atol=2.0 ** -7 * mag, rtol=0)
    np.testing.assert_allclose(got, want_jax, **tol)
    np.testing.assert_allclose(got, want_oracle, **tol)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _attn_inputs(1, 2, 1, 16, 128, seed=0))
    x = torch.randn(2, 128).bfloat16()
    w = torch.randint(-127, 128, (128, 256), dtype=torch.int8)
    s = torch.rand(256)
    a0, m0 = decode_attention.launches, int8_matmul.launches
    torch.testing.assert_close(decode_attention(q, k, v, torch.tensor(3), .1),
                               decode_attention_plain(q, k, v,
                                                      torch.tensor(3), .1))
    torch.testing.assert_close(int8_matmul(x, w, s),
                               int8_matmul_plain(x, w, s))
    assert (decode_attention.launches, int8_matmul.launches) == (a0, m0)


@pytest.mark.parametrize("dt,arr", [
    ("f32", np.array([1.5, -2.25e-3, 3e38], np.float32)),
    ("f16", np.array([1.5, -2.25e-3, 6e4], np.float16)),
    ("i64", np.array([-(1 << 62), 0, 7], np.int64)),
    ("i32", np.array([-(1 << 30), 0, 7], np.int32)),
    ("i8", np.array([-127, 0, 127], np.int8)),
    ("u8", np.array([0, 200, 255], np.uint8)),
    ("bool", np.array([True, False, True])),
    ("bf16", None),
])
def test_dtype_round_trip_bit_exact(dt, arr):
    if dt == "bf16":
        arr = np.asarray(jnp.asarray([1.5, -2.25e-3, 3e38], jnp.bfloat16))
    t = to_device(arr, CPU)
    back = to_host(t)
    assert back.dtype == arr.dtype
    assert back.tobytes() == arr.tobytes()


def test_dtype_unmapped_raises_and_f32_declared_bf16_is_cast():
    from whisper_tensor_tpu_torch.dtype import DType, to_torch

    with pytest.raises(NotImplementedError, match="U16"):
        to_torch(DType.U16)
    t = to_device(np.array([1.0, 1.00390625], np.float32), CPU, DType.BF16)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0, 1.0]      # rounded to nearest even
