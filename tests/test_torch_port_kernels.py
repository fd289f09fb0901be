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
    CARD_SMS, decode_attention, decode_attention_plain, decode_splits,
    heads_per_block, merge_partial_softmax)
from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm  # noqa: E402,E501
from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (  # noqa: E402
    int8_matmul, int8_matmul_plain, int8_plan)
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


# (B, Hq, Hkv, L): the smoke's direct decode and batched slots, ragged
# lengths, a group of 11 heads, one key
SPLIT_SHAPES = [(1, 32, 8, 2048), (8, 32, 8, 2048), (16, 32, 8, 2048),
                (64, 32, 8, 2048), (1, 32, 8, 2047), (3, 11, 1, 100),
                (2, 4, 4, 33), (1, 8, 2, 1)]


@pytest.mark.parametrize("B,Hq,Hkv,L", SPLIT_SHAPES)
def test_decode_splits_cover_every_key_once(B, Hq, Hkv, L):
    """Split c takes keys [c * chunk, (c + 1) * chunk): every key of the
    cache lies in exactly one split, and no split is empty of cache."""
    splits, chunk = decode_splits(B, Hq, Hkv, L)
    owner = np.zeros(L, np.int64)
    for c in range(splits):
        owner[c * chunk:min((c + 1) * chunk, L)] += 1
    assert (owner == 1).all()
    assert (splits - 1) * chunk < L <= splits * chunk


def test_decode_splits_fill_the_card_and_stop_when_the_batch_does():
    """B = 1 at Llama-3-8B's 32/8 heads: 8 head blocks a row, split into
    at least 2 blocks a multiprocessor of the H100's 132; a batch whose
    head blocks already reach that runs one split."""
    assert heads_per_block(32, 8) == 4
    splits, _ = decode_splits(1, 32, 8, 2048)
    assert 8 * splits >= 2 * CARD_SMS
    for B in (64, 128):
        assert B * 8 >= 2 * CARD_SMS
        assert decode_splits(B, 32, 8, 2048) == (1, 2048)
    assert decode_splits(16, 32, 8, 2048)[0] > 1


def _split_states(q, k, v, pos, scale, splits, chunk):
    """Each split's partial softmax state in plain f32 torch: m, l (B, Hq,
    S) and acc (B, Hq, S, D) over the live keys of its chunk; a chunk past
    pos is (-inf, 0, 0)."""
    B, Hq, _, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = (q.float() * scale) @ kf.transpose(-1, -2)            # (B, Hq, 1, L)
    s = s[:, :, 0]
    n_keys = pos.reshape(-1).expand(B).long().clamp(0, L - 1) + 1
    m = torch.full((B, Hq, splits), -np.inf)
    l = torch.zeros(B, Hq, splits)
    acc = torch.zeros(B, Hq, splits, D)
    for b in range(B):
        for c in range(splits):
            lo, hi = c * chunk, min((c + 1) * chunk, int(n_keys[b]))
            if lo >= hi:
                continue
            sc = s[b, :, lo:hi]
            m[b, :, c] = sc.amax(-1)
            p = torch.exp(sc - m[b, :, c, None])
            l[b, :, c] = p.sum(-1)
            acc[b, :, c] = (p[:, None, :] @ vf[b, :, lo:hi])[:, 0]
    return m, l, acc


# (B, Hq, Hkv, L, positions, splits): empty splits (a short row among
# many splits), pos 0, L not a multiple of the chunk, a split of one key
MERGE_CASES = [(2, 8, 2, 192, [5, 191], 12), (1, 4, 4, 64, [0], 8),
               (3, 8, 2, 100, [99, 33, 64], 7), (1, 4, 2, 37, [36], 37),
               (2, 4, 1, 50, [49, 1], 1)]


@pytest.mark.parametrize("B,Hq,Hkv,L,pos_list,splits", MERGE_CASES)
def test_merging_split_states_is_the_plain_attention(B, Hq, Hkv, L, pos_list,
                                                     splits):
    """The second pass's reference: the plain computation cut into
    splits and merged equals decode_attention_plain in f32, up to f32
    rounding (the same terms summed in another order)."""
    rng = np.random.default_rng(B * L + splits)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               for sh in ((B, Hq, 1, 128), (B, Hkv, L, 128),
                          (B, Hkv, L, 128)))
    pos = torch.tensor(pos_list)
    chunk = -(-L // splits)
    m, l, acc = _split_states(q, k, v, pos, 0.09, splits, chunk)
    assert splits == 1 or bool((m == -np.inf).any()) or pos_list[0] == L - 1
    got = merge_partial_softmax(m, l, acc)
    want = decode_attention_plain(q, k, v, pos, 0.09)[:, :, 0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_merge_partial_softmax_weighs_empty_splits_zero():
    """(m, l) = (-inf, 0) adds nothing, and all-empty gives 0 (no NaN)."""
    m = torch.tensor([[1.0, -np.inf, 0.5], [-np.inf, -np.inf, -np.inf]])
    l = torch.tensor([[2.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    acc = torch.tensor([[[4.0], [0.0], [3.0]], [[0.0], [0.0], [0.0]]])
    got = merge_partial_softmax(m, l, acc)
    w = float(np.exp(0.5 - 1.0))
    want = (4.0 + 3.0 * w) / (2.0 + 1.0 * w)
    torch.testing.assert_close(got, torch.tensor([[want], [0.0]]))


@pytest.mark.parametrize("B,Hq,Hkv,L,D", DECODE_SHAPES)
def test_merged_split_states_match_pallas_interpret(B, Hq, Hkv, L, D):
    """The split-and-merge computation, with the wrapper's own plan for
    these shapes, against the TPU kernel in interpret mode; bf16 in and
    out, 2e-2 absolute as the plain version's test above."""
    q, k, v = _attn_inputs(B, Hq, Hkv, L, D, seed=B + L)
    pos = np.asarray([0, L - 1, L // 2, 7][:B], np.int32)
    scale = 1.0 / np.sqrt(D)
    want = ragged_decode_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(pos), scale, interpret=True)
    splits, chunk = decode_splits(B, Hq, Hkv, L)
    assert splits > 1
    m, l, acc = _split_states(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(pos), scale, splits, chunk)
    got = merge_partial_softmax(m, l, acc).bfloat16()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32)[:, :, 0],
                               atol=2e-2, rtol=0)


def _attention_lowering(q, k, v, mask, scale):
    op = AttentionMilli(scale=scale)
    return LOWERINGS["Attention"](op, [q, k, v, mask], [None] * 4, CPU)[0]


# GPT-2's 12 heads of 64 (a group of 1) and a GQA group of 4 at head
# dim 64, which the TPU kernel does not take (its jnp form would)
DECODE_SHAPES_64 = [(2, 12, 12, 256, 64), (1, 8, 2, 100, 64)]


@pytest.mark.parametrize("B,Hq,Hkv,L,D", DECODE_SHAPES_64)
def test_head_dim_64_split_states_match_the_oracle(B, Hq, Hkv, L, D):
    """At head dim 64 the plain version, and the split-and-merge
    computation with the wrapper's own plan for D = 64, against
    AttentionMilli.eval's rank-1 position mask in f32: the same f32
    arithmetic in another order, 1e-5."""
    q, k, v = _attn_inputs(B, Hq, Hkv, L, D, seed=3 * B + L)
    pos = np.asarray([5, L - 1][:B], np.int64)
    scale = 1.0 / np.sqrt(D)
    want = AttentionMilli(scale=scale).eval([q, k, v, pos])[0]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(pos), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    splits, chunk = decode_splits(B, Hq, Hkv, L, D)
    assert splits > 1
    m, l, acc = _split_states(tq, tk, tv, torch.from_numpy(pos), scale,
                              splits, chunk)
    np.testing.assert_allclose(merge_partial_softmax(m, l, acc).numpy(),
                               want[:, :, 0], atol=1e-5, rtol=1e-5)


# (M, K, N): the fused q/k/v, down and lm_head of Llama-3-8B, GPT-2's
# tied head (odd N), and a K and N that are multiples of nothing
INT8_PLAN_SHAPES = [(4096, 6144), (14336, 4096), (4096, 128256),
                    (768, 50257), (1001, 77)]


@pytest.mark.parametrize("K,N", INT8_PLAN_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 5, 8, 9, 16, 17, 128, 300, 512, 2048])
@pytest.mark.parametrize("x_bf16", [True, False])
def test_int8_plan_splits_on_whole_stages(K, N, M, x_bf16):
    """The path by rows and x's type (the tensor cores from
    TENSOR_MIN_ROWS rows of bf16 x, f32 x on the CUDA cores at every M),
    rows a block that cover M (CUDA cores: the smallest power of two, up
    to 8), and K splits of whole stages that cover every row of W once,
    within two waves of the card."""
    plan = int8_plan(M, K, N, x_bf16)
    assert plan.path == ("tensor" if x_bf16 and M >= qm.TENSOR_MIN_ROWS
                         else "cores")
    if plan.path == "cores":
        assert plan.bm == next(b for b in qm.CORE_ROWS if b >= min(M, 8))
    else:
        assert plan.bm == (16 if M <= 16 else 64 if M <= 256 else 128)
    lim = qm.kernel_limits(plan.path, plan.bm, x_bf16)
    assert plan.kchunk % lim.stage_rows == 0
    assert (plan.splits - 1) * plan.kchunk < K <= plan.splits * plan.kchunk
    blocks = -(-M // plan.bm) * -(-N // lim.tile_cols)
    wave = lim.blocks_per_sm * lim.sms
    assert plan.splits <= max(1, -(-2 * wave // blocks))


def test_int8_plan_counts_by_waves_with_the_cpu_defaults():
    """The H100's limits as CPU defaults (132 multiprocessors): at M = 1
    the down projection's 32 column blocks split K, within two waves; the
    lm_head's 1,002 column blocks fill two waves and run unsplit, as do
    2,048 prefill rows; 16 rows on the down projection split too."""
    for (path, bm, bf16), blocks in qm.BLOCKS_PER_SM.items():
        lim = qm.kernel_limits(path, bm, bf16)
        assert (lim.stage_rows, lim.tile_cols, lim.blocks_per_sm,
                lim.sms) == (qm.STAGE_ROWS[path], qm.TILE_COLS[path], blocks,
                             CARD_SMS)
    down = int8_plan(1, 14336, 4096)
    assert down.path == "cores" and down.splits > 1
    assert 32 * down.splits <= 2 * qm.BLOCKS_PER_SM["cores", 1, True] * CARD_SMS
    assert int8_plan(1, 4096, 128256).splits == 1
    assert int8_plan(2048, 4096, 28672) == qm.Int8Plan("tensor", 128, 1, 4096)
    assert int8_plan(16, 14336, 4096).splits > 1


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


INT8_SHAPES = [(1, 256, 384), (8, 384, 512), (33, 256, 128), (600, 128, 256),
               (3, 200, 77), (2, 768, 1001)]


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

    # every DType but STRING has a device type since the generic ONNX
    # path (dtype.py's table); strings live on the host only
    assert to_torch(DType.U16) == torch.uint16
    with pytest.raises(NotImplementedError, match="STRING"):
        to_torch(DType.STRING)
    t = to_device(np.array([1.0, 1.00390625], np.float32), CPU, DType.BF16)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0, 1.0]      # rounded to nearest even
