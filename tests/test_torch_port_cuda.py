"""The PyTorch port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked `cuda` and skips where torch sees no CUDA
device. The module imports torch, numpy and the port only, so it also
runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

(`--noconftest` skips tests/conftest.py, which sets JAX up for the rest
of the suite.) Inputs come from numpy or from seeded torch generators.
"""

import numpy as np
import pytest
import torch

from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
from whisper_tensor_tpu_torch.backends.cuda import flash_attention as fa
from whisper_tensor_tpu_torch.backends.cuda import packed_matmul as pm
from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm
from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
    decode_attention, decode_attention_plain, decode_limits, decode_splits,
    heads_per_block)
from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
    flash_agreement_bound, flash_attention, flash_attention_plain,
    flash_splits)
from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
    kv_write_limits, kv_write_pair, kv_write_pair_plain, kv_write_plan,
    ragged_kv_write, ragged_kv_write_plain)
from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
    dequant_repacked, dequantize_packed, packed_matmul, packed_matmul_plain,
    packed_plan)
from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
    int8_matmul, int8_matmul_plain, int8_plan)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _assert_agree(got, want, magnitude):
    """|got - want| within agreement_bound, element by element: one ulp
    of each output plus f32 summation-order noise (see its docstring)."""
    err = (got.float() - want.float()).abs()
    bound = agreement_bound(want, magnitude)
    assert bool((err <= bound).all()), \
        f"max |err| {err.max().item()}, worst err/bound " \
        f"{(err / bound.clamp_min(1e-30)).max().item()}"


# (B, Hq, Hkv, L, D); groups of 16, 12 and 11 query heads are split
# over blocks of 8, 6 and 1 heads; the keys are split over blocks at
# every shape below 264 head blocks (decode_splits: 64 splits at B = 1,
# L = 2048, 4 at B = 16), and B = 64 runs one split. Head dim 64: GPT-2's
# 12 heads of 64 (a group of 1) at B 1, 16 and 64, L 256 and 1,024, and
# GQA groups of 4 and 3
DECODE_SHAPES = [(4, 8, 2, 192, 128), (2, 4, 4, 256, 128),
                 (3, 16, 2, 512, 128), (1, 32, 8, 64, 128),
                 (2, 32, 8, 2048, 128), (2, 32, 2, 256, 128),
                 (2, 24, 2, 128, 128), (1, 11, 1, 64, 128),
                 (1, 32, 8, 2048, 128), (16, 32, 8, 2048, 128),
                 (64, 32, 8, 96, 128),
                 (1, 12, 12, 256, 64), (16, 12, 12, 256, 64),
                 (64, 12, 12, 256, 64), (1, 12, 12, 1024, 64),
                 (16, 12, 12, 1024, 64), (64, 12, 12, 1024, 64),
                 (2, 8, 2, 192, 64), (3, 9, 3, 100, 64),
                 # head dim 256: Gemma-2 2B's 8/4 heads at B 1 and 16,
                 # Gemma 2B's 8/1, Gemma-3 1B's 4/1, a group of 16 over
                 # two blocks of 8, a group of 2 at a ragged L
                 (1, 8, 4, 2048, 256), (16, 8, 4, 2048, 256),
                 (1, 8, 1, 2048, 256), (4, 4, 1, 512, 256),
                 (2, 16, 1, 300, 256), (3, 4, 2, 77, 256)]


@pytest.mark.parametrize("B,Hq,Hkv,L,D", DECODE_SHAPES)
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32,
                                 torch.float16])
def test_decode_attention_kernel_matches_plain(cuda, B, Hq, Hkv, L, D, qdt):
    """An f32 or f16 query (a model computing in that type over a bf16
    cache) gives an output of its type."""
    rng = np.random.default_rng(B * L)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda).bfloat16()
               for s in ((B, Hq, 1, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    q = q.to(qdt)
    # a row at 0, one at the last slot, one in between, one beyond L
    pos = torch.tensor([0, L - 1, L // 2, L + 5] * (B // 4 + 1),
                       device=cuda)[:B]
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, pos, 0.088)
    want = decode_attention_plain(q, k, v, pos, 0.088)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    assert got.dtype == qdt
    _assert_agree(got, want,
                  decode_attention_plain(q.float(), k, v.abs(), pos, 0.088))


# (B, L, positions): pos on the last key of a split and on the first of
# the next (64 splits of 32 keys at B = 1, L = 2048), pos 0 with 63 empty
# splits, a ragged batch of 16 at L = 2048 (4 splits of 512)
SPLIT_EDGES = [(1, 2048, [31]), (1, 2048, [32]), (1, 2048, [63]),
               (1, 2048, [64]), (1, 2048, [62]), (1, 2048, [125]),
               (1, 2048, [0]), (1, 2048, [2047]), (2, 100, [31, 32]),
               (16, 2048, [0, 1, 17, 100, 511, 512, 513, 1000, 1023, 1024,
                           1366, 1535, 1536, 2046, 2047, 9000])]


@pytest.mark.parametrize("B,L,pos_list", SPLIT_EDGES)
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 128), (12, 12, 64),
                                      (8, 4, 256)])
def test_decode_attention_kernel_split_edges(cuda, B, L, pos_list, Hq, Hkv,
                                             D):
    """Rows whose live keys end at a split's edge, a row of one key among
    64 splits (63 of them empty), and a ragged batch of 16 rows over 4
    splits, at Llama-3's heads and GPT-2's: within agreement_bound of the
    plain version."""
    splits, chunk = decode_splits(B, Hq, Hkv, L, D,
                                  torch.cuda.current_device())
    assert splits > 1
    g = torch.Generator(device=cuda).manual_seed(B + L + pos_list[0])
    q = torch.randn(B, Hq, 1, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, Hkv, L, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    pos = torch.tensor(pos_list, device=cuda)
    got = decode_attention(q, k, v, pos, 0.088)
    want = decode_attention_plain(q, k, v, pos, 0.088)
    torch.cuda.synchronize()
    _assert_agree(got, want,
                  decode_attention_plain(q.float(), k, v.abs(), pos, 0.088))


@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 128), (12, 12, 64)])
def test_decode_attention_kernel_is_deterministic(cuda, Hq, Hkv, D):
    """Split keys and their merge in a fixed order: repeats are bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, Hq, 1, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, Hkv, 2048, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    pos = torch.tensor([700, 2047], device=cuda)
    first = decode_attention(q, k, v, pos, 0.088)
    for _ in range(3):
        assert torch.equal(decode_attention(q, k, v, pos, 0.088).view(
            torch.int16), first.view(torch.int16))


def test_decode_attention_kernel_pos_forms(cuda):
    """pos as () or (B,), int64 or int32, or a () expanded to (B,) (the
    Attention lowering's form of a scalar mask), all give the same rows."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 8, 1, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 2, 96, 128, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    full = decode_attention(q, k, v, torch.tensor([40, 40], device=cuda), 0.1)
    for pos in (torch.tensor(40, device=cuda),
                torch.tensor(40, dtype=torch.int32, device=cuda),
                torch.tensor([40, 40], dtype=torch.int32, device=cuda),
                torch.tensor(40, device=cuda).reshape(-1).expand(2)):
        torch.testing.assert_close(decode_attention(q, k, v, pos, 0.1), full,
                                   atol=0, rtol=0)


# (mode, B, Hq, Hkv, Sq, Skv, D): a direct prefill, admission pieces of
# 128 at ragged positions (keys split over blocks), GPT-2 width with
# ragged edges, a group of 8 heads (one block of 8) and of 3 (blocks of
# 1), causal with rows that see no key (Sq > Skv), an additive mask per
# batch row and for the batch; then the 128-row tiling's edges at both
# head dims: Sq and Skv one past or short of a multiple of 128 and of the
# 64-key tile, a pos inside a tile, and small grids whose keys split
FLASH_CASES = [("pos", 1, 32, 8, 512, 2048, 128),
               ("pos", 4, 32, 8, 128, 2048, 128),
               ("pos", 2, 12, 12, 300, 1000, 64),
               ("pos", 1, 8, 1, 100, 100, 128),
               ("pos", 2, 6, 2, 70, 90, 64),
               ("causal", 2, 32, 8, 300, 1000, 128),
               ("causal", 1, 4, 2, 200, 120, 64),
               ("mask", 2, 8, 2, 130, 200, 128),
               ("mask1", 1, 4, 4, 64, 256, 64),
               ("pos", 1, 32, 8, 129, 2001, 128),
               ("pos", 1, 12, 12, 257, 1000, 64),
               ("pos", 3, 32, 8, 127, 1090, 128),
               ("causal", 1, 16, 2, 333, 333, 64),
               ("causal", 2, 8, 8, 127, 129, 128),
               ("causal", 1, 32, 8, 3, 65, 128),
               ("mask", 1, 12, 12, 100, 190, 64),
               ("mask1", 2, 32, 8, 129, 127, 128),
               # head dim 256: Gemma-3 1B's 4/1 heads and Gemma 2B's 8/1
               # under an additive mask (the Gemma recipes' mode), a
               # prompt piece, Gemma-2 2B's 8/4 in every mode, the edges
               ("mask1", 1, 4, 1, 300, 2048, 256),
               ("mask1", 1, 8, 1, 128, 2048, 256),
               ("mask", 2, 8, 4, 129, 200, 256),
               ("pos", 1, 8, 4, 512, 2048, 256),
               ("pos", 4, 8, 4, 128, 2048, 256),
               ("causal", 2, 8, 4, 127, 129, 256),
               ("causal", 1, 4, 2, 70, 40, 256),
               ("pos", 2, 16, 1, 65, 1000, 256),
               # head dims 80 and 160 (the SD UNet's, native since the
               # image slice): every mode, key splits, ragged edges
               ("pos", 1, 8, 8, 300, 1000, 80),
               ("causal", 2, 8, 8, 127, 129, 80),
               ("mask", 1, 8, 8, 64, 77, 80),
               ("pos", 1, 8, 8, 129, 2001, 160),
               ("causal", 1, 8, 4, 333, 333, 160),
               ("mask1", 2, 8, 8, 70, 77, 160)]


def _flash_inputs(cuda, mode, B, Hq, Hkv, Sq, Skv, D):
    """bf16 q as a transposed view (the recipes' layout), k, v, and the
    mode's extras; pos of row 0 is 0 (a whole prompt)."""
    g = torch.Generator(device=cuda).manual_seed(B * Sq + Skv + D)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, Hkv, Skv, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    extra = {}
    if mode == "pos":
        pos = torch.randint(0, Skv, (B,), generator=g, device=cuda)
        pos[0] = 0
        extra["pos_bound"] = pos
    elif mode == "causal":
        extra["causal"] = True
    else:
        m = torch.randn(B if mode == "mask" else 1, 1, Sq, Skv, generator=g,
                        device=cuda) * 2
        m[torch.rand(m.shape, generator=g, device=cuda) < 0.3] = -torch.inf
        m[0, 0, 3] = -torch.inf
        extra["mask"] = m
    return q.transpose(1, 2), k, v, extra


@pytest.mark.parametrize("mode,B,Hq,Hkv,Sq,Skv,D", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, mode, B, Hq, Hkv, Sq, Skv,
                                              D):
    """Within flash_agreement_bound, element by element; rows with no
    visible key are 0; q is read through its strides."""
    q, k, v, extra = _flash_inputs(cuda, mode, B, Hq, Hkv, Sq, Skv, D)
    assert not q.is_contiguous()
    scale = D ** -0.5
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, scale, **extra)
    want = flash_attention_plain(q, k, v, scale, **extra)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.shape == (B, Hq, Sq, D) and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    bound = flash_agreement_bound(
        want, flash_attention_plain(q, k, v.abs(), scale, **extra))
    assert bool((err <= bound).all()), \
        f"max |err| {err.max().item()}, worst err/bound " \
        f"{(err / bound.clamp_min(1e-30)).max().item()}"
    if mode == "causal" and Sq > Skv:
        assert not got[:, :, :Sq - Skv].float().any()
    if mode.startswith("mask"):
        assert not got[0, :, 3].float().any()


# the speculative verify block: Sq = k query rows at a scalar start (B =
# 1, the direct path) or at ragged per-row starts (B = 4), among them 0,
# a start just inside a 64-key tile (65) and one whose last row sees the
# cache's last key
@pytest.mark.parametrize("Sq", [2, 4, 5, 8])
@pytest.mark.parametrize("Hq,Hkv,D,Skv", [(32, 8, 128, 2048),
                                          (12, 12, 64, 1024)])
@pytest.mark.parametrize("B", [1, 4])
def test_flash_attention_kernel_at_the_verify_block(cuda, Sq, Hq, Hkv, D,
                                                    Skv, B):
    """Within flash_agreement_bound, element by element; the grid is a
    few blocks, so the keys split over blocks (flash_splits)."""
    q, k, v, _ = _flash_inputs(cuda, "pos", B, Hq, Hkv, Sq, Skv, D)
    pos = (torch.tensor(700, device=cuda) if B == 1 else
           torch.tensor([0, 65, 1000, Skv - Sq], device=cuda))
    assert flash_splits(B, Hq, Hkv, Sq, Skv, D,
                        torch.cuda.current_device())[0] > 1
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, D ** -0.5, pos_bound=pos)
    want = flash_attention_plain(q, k, v, D ** -0.5, pos_bound=pos)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.shape == (B, Hq, Sq, D)
    err = (got.float() - want.float()).abs()
    bound = flash_agreement_bound(
        want, flash_attention_plain(q, k, v.abs(), D ** -0.5, pos_bound=pos))
    assert bool((err <= bound).all()), \
        f"max |err| {err.max().item()}, worst err/bound " \
        f"{(err / bound.clamp_min(1e-30)).max().item()}"


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_kernel_split_is_deterministic(cuda, D):
    """A 128-row piece at B = 1 fills a fraction of the card, so its keys
    are split over blocks and merged in split order: repeats are
    bit-equal, and within flash_agreement_bound."""
    Hq, Hkv = (12, 12) if D == 64 else (32, 8)
    q, k, v, extra = _flash_inputs(cuda, "pos", 1, Hq, Hkv, 128, 2048, D)
    extra["pos_bound"] = torch.tensor([1000], device=cuda)
    assert flash_splits(1, Hq, Hkv, 128, 2048, D,
                        torch.cuda.current_device())[0] > 1
    first = flash_attention(q, k, v, D ** -0.5, **extra)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v, D ** -0.5, **extra)
                           .view(torch.int16), first.view(torch.int16))
    want = flash_attention_plain(q, k, v, D ** -0.5, **extra)
    err = (first.float() - want.float()).abs()
    assert bool((err <= flash_agreement_bound(want, flash_attention_plain(
        q, k, v.abs(), D ** -0.5, **extra))).all())


def test_flash_attention_kernel_pos_forms(cuda):
    """pos_bound as () or (B,), int64 or int32: the same rows."""
    q, k, v, _ = _flash_inputs(cuda, "causal", 2, 8, 2, 48, 200, 128)
    full = flash_attention(q, k, v, 0.1,
                           pos_bound=torch.tensor([40, 40], device=cuda))
    for pos in (torch.tensor(40, device=cuda),
                torch.tensor(40, dtype=torch.int32, device=cuda),
                torch.tensor([40, 40], dtype=torch.int32, device=cuda)):
        torch.testing.assert_close(flash_attention(q, k, v, 0.1,
                                                   pos_bound=pos),
                                   full, atol=0, rtol=0)


@pytest.mark.parametrize("mode,B,Hq,Hkv,Sq,Skv", [
    ("mask1", 1, 4, 1, 2048, 2048), ("mask1", 1, 8, 1, 128, 2048),
    ("pos", 2, 8, 4, 200, 700), ("causal", 1, 8, 4, 129, 129)])
def test_flash_attention_split_plans_at_head_dim_256(cuda, mode, B, Hq, Hkv,
                                                     Sq, Skv):
    """Head dim 256's tile shape (q in registers, 3 stages of 32 keys),
    unsplit and split over the keys: within flash_agreement_bound."""
    q, k, v, extra = _flash_inputs(cuda, mode, B, Hq, Hkv, Sq, Skv, 256)
    mask = extra.get("mask")
    pos = extra.get("pos_bound")
    for splits, chunk in ((1, -(-Skv // 64) * 64),
                          flash_splits(B, Hq, Hkv, Sq, Skv, 256)):
        got = fa._launch(q, k, v, None if mask is None else mask.contiguous(),
                         Sq * Skv if mask is not None and mask.shape[0] > 1
                         else 0, pos, "causal" in extra, 0.0625, splits,
                         chunk)
        want = flash_attention_plain(q, k, v, 0.0625, **extra)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        bound = flash_agreement_bound(
            want, flash_attention_plain(q, k, v.abs(), 0.0625, **extra))
        assert bool((err <= bound).all()), (splits, err.max().item())


def test_flash_attention_wrapper_raises_on_unsupported_cuda_inputs(cuda):
    q, k, v, _ = _flash_inputs(cuda, "causal", 1, 4, 2, 32, 64, 64)
    pos = torch.tensor(3, device=cuda)
    n0 = flash_attention.launches
    for args, kw, match in (
            ((q[..., :48], k[..., :48].contiguous(), v[..., :48].contiguous()),
             {"pos_bound": pos}, "unsupported"),              # head dim 48
            ((q.float(), k, v), {"pos_bound": pos}, "unsupported"),
            ((q, k.transpose(2, 3).contiguous().transpose(2, 3), v),
             {"pos_bound": pos}, "contiguous"),
            ((q, k, v), {"pos_bound": pos, "causal": True}, "excludes"),
            ((q, k, v), {"pos_bound": pos.float()}, "pos_bound"),
            ((q, k, v), {"mask": torch.zeros(1, 1, 32, 63, device=cuda)},
             "mask")):
        with pytest.raises(ValueError, match=match):
            flash_attention(*args, 0.1, **kw)
    assert flash_attention.launches == n0


# (M, K, N): decode rows, a partial row tile, K not a multiple of the
# stages (200, 1000; 72, 1001 not of 8 either), N not a multiple of the
# 128-column tile nor of 16 (odd: 77, 99, 33, GPT-2's 50,257 head), the
# tensor path's 16-, 64- and 128-row tiles, prefill rows past 512, and
# the speculative verify block's M = k at Llama-3-8B's widths, k = 4 and
# 5 on either side of int8_plan's switch between the two paths
INT8_SHAPES = [(1, 256, 384), (8, 384, 512), (33, 256, 128), (5, 200, 48),
               (17, 1024, 1040), (512, 256, 384), (3, 4096, 6144),
               (1, 768, 50257), (64, 768, 50257), (2, 200, 77), (9, 72, 99),
               (16, 1000, 33), (3, 1001, 77), (130, 4096, 1000),
               (300, 1001, 200), (600, 256, 384), (2048, 512, 256),
               (4, 4096, 6144), (5, 4096, 6144), (4, 14336, 4096),
               (5, 4096, 28672)]


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_matches_plain(cuda, M, K, N, tdt):
    """bf16: within agreement_bound, element by element; f32: the same
    f32 products summed in another order, 1e-5 of the scale. Every
    shape launches the kernel."""
    g = torch.Generator(device=cuda).manual_seed(M * N)
    x = torch.randn(M, K, generator=g, device=cuda).to(tdt)
    w = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(N, generator=g, device=cuda) * 0.01
    n0 = int8_matmul.launches
    got, want = int8_matmul(x, w, s), int8_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == n0 + 1
    if tdt == torch.bfloat16:
        _assert_agree(got, want, int8_matmul_plain(x.float().abs(), w.abs(),
                                                   s))
    else:
        torch.testing.assert_close(
            got, want, atol=1e-5 * max(1.0, want.abs().max().item()), rtol=0)


@pytest.mark.parametrize("M", [1, 5, 300])
def test_f16_x_takes_the_quantized_kernels_through_f32(cuda, M):
    """An f16 model's x: int8_matmul and packed_matmul widen it to f32 at
    the kernel's edge and round the f32 result once to f16: one launch
    each, bit for bit the f32-x kernel's result rounded, and within
    agreement_bound (f16's ulp) of the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(M)
    K, N = 512, 384
    x = torch.randn(M, K, generator=g, device=cuda).half()
    w = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(N, generator=g, device=cuda) * 0.01
    n0 = int8_matmul.launches
    got = int8_matmul(x, w, s)
    assert int8_matmul.launches == n0 + 1 and got.dtype == torch.float16
    assert torch.equal(got, int8_matmul(x.float(), w, s).half())
    _assert_agree(got, int8_matmul_plain(x, w, s),
                  int8_matmul_plain(x.float().abs(), w.abs(), s))
    q, sc, o = (torch.from_numpy(a).to(cuda) for a in
                _packed_layout(4, 32, K, N, True, seed=M))
    n0 = packed_matmul.launches
    got = packed_matmul(x, q, sc, o, 4)
    assert packed_matmul.launches == n0 + 1 and got.dtype == torch.float16
    assert torch.equal(got, packed_matmul(x.float(), q, sc, o, 4).half())
    _assert_agree(got, packed_matmul_plain(x, q, sc, o, 4),
                  x.float().abs() @ dequantize_packed(q, sc, o, 4).abs())


@pytest.mark.parametrize("M", [600, 2048])
def test_int8_matmul_kernel_takes_prefill_rows_past_512(cuda, M):
    """More than 512 rows launch the kernel (the tensor cores; the JAX
    package leaves them to XLA, a limit of the TPU's VMEM): within
    agreement_bound of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, 4096, generator=g, device=cuda).bfloat16()
    w = torch.randint(-127, 128, (4096, 1024), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(1024, generator=g, device=cuda) * 0.01
    n0 = int8_matmul.launches
    got = int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == n0 + 1
    assert int8_plan(M, 4096, 1024, True,
                     torch.cuda.current_device()).path == "tensor"
    _assert_agree(got, int8_matmul_plain(x, w, s),
                  int8_matmul_plain(x.float().abs(), w.abs(), s))


@pytest.mark.parametrize("path,M,dtype", [("cores", 1, torch.bfloat16),
                                          ("cores", 7, torch.float32),
                                          ("tensor", 12, torch.bfloat16),
                                          ("tensor", 100, torch.bfloat16)])
def test_int8_matmul_kernel_is_deterministic(cuda, path, M, dtype):
    """Both paths, chosen by rows and x's type, with K split (fixed-order
    sums, no atomics): repeats are bit-equal, and within agreement_bound
    of the plain version (f32: 1e-5 of the scale)."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, 4096, generator=g, device=cuda).to(dtype)
    w = torch.randint(-127, 128, (4096, 1024), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(1024, generator=g, device=cuda) * 0.01
    plan = int8_plan(M, 4096, 1024, dtype == torch.bfloat16,
                     torch.cuda.current_device())
    assert plan.path == path and plan.splits > 1
    first = int8_matmul(x, w, s)
    for _ in range(3):
        assert torch.equal(_bits(int8_matmul(x, w, s)), _bits(first))
    want = int8_matmul_plain(x, w, s)
    if dtype == torch.bfloat16:
        _assert_agree(first, want, int8_matmul_plain(x.float().abs(),
                                                     w.abs(), s))
    else:
        torch.testing.assert_close(
            first, want, atol=1e-5 * max(1.0, want.abs().max().item()),
            rtol=0)


def _packed_layout(bits, G, K, N, has_off, seed):
    """Random packed weights in the kernel's layout, from numpy: q bytes,
    scales in [0.001, 0.05), offsets in [-0.2, 0.2) or zeros."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(0, 256, (K // 2, N), dtype=np.uint8) if bits == 4
         else rng.integers(-128, 128, (K, N), dtype=np.int8))
    s = rng.uniform(0.001, 0.05, (K // G, N)).astype(np.float32)
    o = (rng.uniform(-0.2, 0.2, (K // G, N)).astype(np.float32) if has_off
         else np.zeros_like(s))
    return q, s, o


# (bits, G, has_off): the nibble layout at the classic block, the K-quant
# sub-scale, the GPTQ group and a group shorter than a thread's 16 rows;
# the int8 layout at Q6_K's and Q8_K's groups and without offsets (Q8_0)
PACKED_LAYOUTS = [(4, 32, True), (4, 16, True), (4, 128, True),
                  (4, 8, True), (8, 16, True), (8, 256, True),
                  (8, 32, False)]


# (M, N): decode rows (the CUDA cores), then bf16 rows from 9 up on
# the tensor cores (f32 x stays on the CUDA cores at every M), with
# ragged N (77, 100) and no row cap (513, 600, 2048)
PACKED_ROWS = [(1, 256), (5, 384), (5, 77), (12, 77), (16, 1040), (17, 77),
               (64, 100), (512, 128), (513, 77), (600, 256), (2048, 100)]


@pytest.mark.parametrize("bits,G,has_off", PACKED_LAYOUTS)
@pytest.mark.parametrize("M,N", PACKED_ROWS)
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
def test_packed_matmul_kernel_matches_plain(cuda, bits, G, has_off, M, N,
                                            tdt):
    """K = 512, so every G divides it. bf16: within agreement_bound,
    element by element; f32: the same f32 products summed in another
    order, 1e-5 of the scale. The kernel is launched at every M."""
    K = 512
    q, s, o = (torch.from_numpy(a).to(cuda) for a in
               _packed_layout(bits, G, K, N, has_off, seed=M * N + G))
    g = torch.Generator(device=cuda).manual_seed(M + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(tdt)
    n0 = packed_matmul.launches
    got = packed_matmul(x, q, s, o, bits, has_off)
    want = packed_matmul_plain(x, q, s, o, bits, has_off)
    torch.cuda.synchronize()
    assert packed_matmul.launches == n0 + 1
    assert got.dtype == tdt and got.shape == (M, N)
    if tdt == torch.bfloat16:
        w = dequantize_packed(q, s, o, bits, has_off)
        _assert_agree(got, want, x.float().abs() @ w.abs())
    else:
        torch.testing.assert_close(
            got, want, atol=1e-5 * max(1.0, want.abs().max().item()), rtol=0)


@pytest.mark.parametrize("bits,G,has_off", PACKED_LAYOUTS)
def test_packed_matmul_kernel_dequantizes_bit_exactly(cuda, bits, G,
                                                      has_off):
    """x = the identity: every output is one product 1 * W[k, n] added to
    zero, so the kernel's f32 output is its dequantized W, which must
    equal the numpy dequant_repacked bit for bit (q * s and - o each
    rounded; an FMA would round once). N = 100 takes the unaligned
    staging."""
    K = 256
    for N in (256, 100):
        q, s, o = _packed_layout(bits, G, K, N, has_off, seed=G + N)
        want = dequant_repacked({"q": q, "scales": s, "offsets": o,
                                 "bits": np.int8(bits)})
        got = packed_matmul(torch.eye(K, device=cuda),
                            *(torch.from_numpy(a).to(cuda) for a in (q, s, o)),
                            bits, True if bits == 4 else has_off)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("path,M,dtype", [("cores", 7, torch.bfloat16),
                                          ("cores", 12, torch.float32),
                                          ("tensor", 12, torch.bfloat16)])
def test_packed_matmul_kernel_is_deterministic(cuda, path, M, dtype):
    """Both paths, chosen by rows and x's type, with K split (fixed-order
    sums, no atomics): repeats are bit-equal, and within agreement_bound
    of the plain version."""
    q, s, o = (torch.from_numpy(a).to(cuda)
               for a in _packed_layout(4, 32, 4096, 1024, True, seed=3))
    x = torch.randn(M, 4096, device=cuda).to(dtype)
    plan = packed_plan(M, 4096, 1024, 32, 4, dtype == torch.bfloat16,
                       torch.cuda.current_device())
    assert plan.path == path and plan.splits > 1
    first = packed_matmul(x, q, s, o, 4, True)
    for _ in range(3):
        assert torch.equal(packed_matmul(x, q, s, o, 4, True).view(
            _bits(first).dtype), _bits(first))
    w = dequantize_packed(q, s, o, 4, True)
    _assert_agree(first, packed_matmul_plain(x, q, s, o, 4, True),
                  x.float().abs() @ w.abs())


def test_kernel_limits_on_the_card_match_the_cpu_defaults(cuda):
    """The launch plans read each kernel's tile constants and blocks a
    multiprocessor on the card (wt_packed_limits, wt_decode_limits: the
    occupancy calculator). The tile constants and the heads a block equal
    the CPU defaults everywhere; on an H100 (132 multiprocessors, compute
    capability 9.0) so do the blocks a multiprocessor where the defaults
    were measured (bits 4, G 32, bf16 x; other layouts change a block's
    shared memory and registers), so the CPU plan tests of Llama-3-8B's
    Q4_0 shapes check the plans the card runs."""
    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    h100 = props.multi_processor_count == 132 and props.major == 9
    differ = []          # (kernel, key, card, CPU default) on an H100
    for path, rows in (("cores", (1, 2, 4, 8, 16)), ("tensor", (16, 64))):
        for bm in rows:
            for bits in (4, 8):
                for bf16 in (True, False) if path == "cores" else (True,):
                    for G in (4, 16, 32, 128):
                        card = pm.kernel_limits(path, bm, bits, bf16, G, index)
                        cpu = pm.kernel_limits(path, bm, bits, bf16, G)
                        assert (card.stage_q_rows, card.tile_cols) == (
                            cpu.stage_q_rows, cpu.tile_cols)
                        assert card.blocks_per_sm >= 1
                        if h100 and (bits, G, bf16) == (4, 32, True):
                            assert card == cpu, (path, bm)
    for Hq, Hkv in ((32, 8), (16, 1), (24, 2), (11, 1), (8, 2), (4, 4),
                    (12, 12)):
        for D in (64, 128, 256):
            card = decode_limits(Hq, Hkv, D, index)
            cpu = decode_limits(Hq, Hkv, D)
            assert card[0] == heads_per_block(Hq, Hkv) and card[1] >= 1
            # at D = 64 the default is GPT-2's group of 1 (the registers
            # of other groups' blocks give one block less)
            if h100 and card != cpu and (D == 128 or Hq == Hkv):
                differ.append(("decode", (Hq, Hkv, D), card, cpu))
        for D in fa.HEAD_DIMS:
            card = fa.flash_limits(Hq, Hkv, D, index)
            cpu = fa.flash_limits(Hq, Hkv, D)
            assert card[:2] == cpu[:2] and card[2] >= 1
            if h100 and card != cpu:
                differ.append(("flash", (Hq, Hkv, D), card, cpu))
    for path, bm, bf16 in qm.BLOCKS_PER_SM:
        card = qm.kernel_limits(path, bm, bf16, index)
        cpu = qm.kernel_limits(path, bm, bf16)
        assert (card.stage_rows, card.tile_cols) == (cpu.stage_rows,
                                                     cpu.tile_cols)
        assert card.blocks_per_sm >= 1
        if h100 and card != cpu:
            differ.append(("int8", (path, bm, bf16), card, cpu))
    assert not differ, differ


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("G", [16, 32, 128])
@pytest.mark.parametrize("M", [1, 16, 64])
def test_packed_matmul_kernel_at_the_down_projection(cuda, bits, G, M):
    """Llama-3-8B's down projection (K 14,336, N 4,096): 32 column blocks,
    so K is split (12 ways at M = 1, 8 on the tensor cores at M = 16 and
    64); within agreement_bound."""
    K, N = 14336, 4096
    q, s, o = (torch.from_numpy(a).to(cuda)
               for a in _packed_layout(bits, G, K, N, True, seed=G + bits))
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    assert packed_plan(M, K, N, G, bits, True,
                       torch.cuda.current_device()).splits > 1
    got = packed_matmul(x, q, s, o, bits, True)
    w = dequantize_packed(q, s, o, bits, True)
    want = packed_matmul_plain(x, q, s, o, bits, True)
    torch.cuda.synchronize()
    _assert_agree(got, want, x.float().abs() @ w.abs())


def test_packed_matmul_wrapper_raises_on_unsupported_cuda_inputs(cuda):
    q, s, o = (torch.from_numpy(a).to(cuda)
               for a in _packed_layout(4, 32, 256, 128, True, seed=1))
    x = torch.randn(2, 256, device=cuda)
    n0 = packed_matmul.launches
    with pytest.raises(ValueError, match="bf16, f32 or f16"):
        packed_matmul(x.double(), q, s, o, 4)
    with pytest.raises(ValueError, match="bits"):
        packed_matmul(x, q.view(torch.int8), s, o, 4)      # int8 q at bits 4
    with pytest.raises(ValueError, match="bits"):
        packed_matmul(x, q, s, o, 8)                       # q rows are K/2
    with pytest.raises(ValueError, match="K % 16"):
        packed_matmul(x[:, :248], q[:124], s[:31], o[:31], 4)
    with pytest.raises(ValueError, match="scales"):
        packed_matmul(x, q, s[:, :64], o, 4)
    with pytest.raises(ValueError, match="offsets"):
        packed_matmul(x, q, s, o[:7], 4)                   # 7 does not divide
    with pytest.raises(ValueError, match="contiguous"):
        packed_matmul(x, q, s.t().contiguous().t(), o, 4)
    assert packed_matmul.launches == n0


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


KV_WRITE_DTYPES = [(torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.float32),
                   (torch.bfloat16, torch.float32),      # f32 into bf16
                   (torch.bfloat16, torch.float16),      # f16 into bf16
                   (torch.float32, torch.bfloat16),      # bf16 into f32
                   (torch.float32, torch.float16)]       # f16 into f32


@pytest.mark.parametrize("cache_dt,upd_dt", KV_WRITE_DTYPES)
@pytest.mark.parametrize("B,S,D,L", [
    (B, S, D, L) for B in (1, 8, 64) for S in (1, 16, 128) for D in (64, 128)
    for L in (64, 2048) if S <= L])
def test_ragged_kv_write_kernel_is_bit_exact(cuda, B, S, D, L, cache_dt,
                                             upd_dt):
    """A copy: the whole cache equals the plain version's bit for bit
    (written slabs and untouched elements), in place. Rows at 0, the
    last slot, in between, beyond L - S and negative (clamped)."""
    g = torch.Generator(device=cuda).manual_seed(B * S + D + L)
    H = 2
    cache = torch.randn(B, H, L, D, generator=g, device=cuda).to(cache_dt)
    upd = torch.randn(B, H, S, D, generator=g, device=cuda).to(upd_dt)
    pos = torch.tensor([0, L - S, L // 3, L + 7, -3, 5, 1, L - 1] * 8,
                       device=cuda)[:B]
    want = ragged_kv_write_plain(cache.clone(), upd, pos)
    n0, ptr = ragged_kv_write.launches, cache.data_ptr()
    got = ragged_kv_write(cache, upd, pos)
    torch.cuda.synchronize()
    assert ragged_kv_write.launches == n0 + 1
    assert got is cache and got.data_ptr() == ptr
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("cache_dt,upd_dt", KV_WRITE_DTYPES)
def test_ragged_kv_write_kernel_reads_strided_updates(cuda, cache_dt, upd_dt):
    """The llama recipe's V update is a transposed view, and an odd
    stride takes the element-by-element path: both bit-exact."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, L, D, S = 4, 8, 256, 128, 16
    base = torch.randn(B, S, H, D, generator=g, device=cuda).to(upd_dt)
    wide = torch.randn(B, H, S, D + 1, generator=g, device=cuda).to(upd_dt)
    pos = torch.tensor([0, 17, 240, 100], device=cuda, dtype=torch.int32)
    for upd in (base.transpose(1, 2), wide[..., :D]):
        assert not upd.is_contiguous()
        cache = torch.randn(B, H, L, D, generator=g, device=cuda).to(cache_dt)
        want = ragged_kv_write_plain(cache.clone(), upd, pos)
        got = ragged_kv_write(cache, upd, pos)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want))


def test_kernel_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    q = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        decode_attention(q, kv, kv.float(), torch.tensor(3, device=cuda), 0.1)
    with pytest.raises(ValueError, match="unsupported"):
        decode_attention(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                         kv[..., :48].contiguous(),
                         torch.tensor(3, device=cuda), 0.1)   # head dim 48
    x = torch.zeros(2, 64, dtype=torch.float64, device=cuda)
    w = torch.zeros(64, 128, dtype=torch.int8, device=cuda)
    n0 = int8_matmul.launches
    with pytest.raises(ValueError, match="bf16, f32 or f16"):
        int8_matmul(x, w, torch.ones(128, device=cuda))
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(x.bfloat16(), w, torch.ones(100, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x.bfloat16(), w.t().contiguous().t(),
                    torch.ones(128, device=cuda))
    assert int8_matmul.launches == n0
    cache = torch.zeros(2, 2, 16, 64, dtype=torch.bfloat16, device=cuda)
    upd = torch.zeros(2, 2, 1, 64, dtype=torch.bfloat16, device=cuda)
    pos = torch.tensor([1, 2], device=cuda)
    n0 = ragged_kv_write.launches
    for bad in (upd.double(),                                 # f64 update
                torch.zeros(2, 2, 17, 64, dtype=torch.bfloat16,
                            device=cuda),                     # S > L
                upd[:1]):                                     # batch differs
        with pytest.raises(ValueError, match="unsupported"):
            ragged_kv_write(cache, bad, pos)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_kv_write(cache.transpose(2, 3).contiguous().transpose(2, 3),
                        upd, pos)
    with pytest.raises(ValueError, match="pos"):
        ragged_kv_write(cache, upd, pos.float())
    with pytest.raises(ValueError, match="pos"):
        ragged_kv_write(cache, upd, pos.cpu())
    assert ragged_kv_write.launches == n0


# (B, H, L, D, S, positions): the decode pair of 16 slots with phase 2's
# positions (5000 clamps to L - 1, -1 counts from the end), a 128-row
# piece of 4 rows (1950 + 128 and 3000 clamp to L - 128), GPT-2's decode
# pair at 64 slots, the direct path's scalar start at S 1 and 32, and
# the speculative verify block's S = k = 4 and 5, scalar and per-row
PAIR_SHAPES = [
    (16, 8, 2048, 128, 1, [0, 1, 511, 2046, 2047, 5000, -1] + list(
        range(100, 1000, 100))),
    (4, 8, 2048, 128, 128, [0, 128, 1950, 3000]),
    (64, 12, 256, 64, 1, [0, 255, 300, -1, 17, 128, -256, 9] * 8),
    (1, 8, 2048, 128, 1, 100), (1, 8, 2048, 128, 32, 2040),
    (1, 8, 2048, 128, 1, -1), (3, 2, 64, 5, 3, [0, 62, -4]),
    (1, 8, 2048, 128, 4, 100), (1, 8, 2048, 128, 5, 2043),
    (4, 8, 2048, 128, 4, [0, 65, 1000, 2044]),
    (4, 12, 256, 64, 5, [3, 63, 200, 251])]


@pytest.mark.parametrize("cache_dt,upd_dt", KV_WRITE_DTYPES)
@pytest.mark.parametrize("B,H,L,D,S,pos_list", PAIR_SHAPES)
def test_kv_write_pair_kernel_is_bit_exact(cuda, B, H, L, D, S, pos_list,
                                           cache_dt, upd_dt):
    """A layer's K and V writes in one launch: both whole caches equal
    the plain version's bit for bit, in place, V's update the llama
    recipe's transposed view; one launch, counted once by each wrapper's
    counter. D = 5 takes the element-by-element path."""
    g = torch.Generator(device=cuda).manual_seed(B * S + D + L)
    ck, cv = (torch.randn(B, H, L, D, generator=g, device=cuda).to(cache_dt)
              for _ in range(2))
    uk = torch.randn(B, H, S, D, generator=g, device=cuda).to(upd_dt)
    uv = torch.randn(B, S, H, D, generator=g, device=cuda).to(
        upd_dt).transpose(1, 2)
    pos = torch.tensor(pos_list, device=cuda)
    want = kv_write_pair_plain(ck.clone(), uk, cv.clone(), uv, pos)
    n0 = ragged_kv_write.launches, kv_write_pair.launches
    ptrs = ck.data_ptr(), cv.data_ptr()
    got = kv_write_pair(ck, uk, cv, uv, pos)
    torch.cuda.synchronize()
    assert (ragged_kv_write.launches, kv_write_pair.launches) == (
        n0[0] + 1, n0[1] + 1)
    assert got[0] is ck and got[1] is cv
    assert (ck.data_ptr(), cv.data_ptr()) == ptrs
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_kv_write_pair_kernel_pos_forms(cuda):
    """int32 starts, a strided (B,) view and a () start expanded to (B,)
    (stride 0) give the int64 starts' caches."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, H, L, D = 6, 4, 64, 128
    ck, cv = (torch.randn(B, H, L, D, generator=g, device=cuda).bfloat16()
              for _ in range(2))
    uk, uv = (torch.randn(B, H, 1, D, generator=g, device=cuda).bfloat16()
              for _ in range(2))
    pos = torch.tensor([3, 63, -2, 70, 0, 9], device=cuda)
    want = kv_write_pair_plain(ck.clone(), uk, cv.clone(), uv, pos)
    wide = torch.stack([pos, pos * 0]).t().reshape(-1)[::2]
    for p in (pos.int(), wide):
        got = kv_write_pair(ck.clone(), uk, cv.clone(), uv, p)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
    one = torch.tensor(17, device=cuda)
    want = kv_write_pair_plain(ck.clone(), uk, cv.clone(), uv, one)
    for p in (one, one.expand(B)):
        got = kv_write_pair(ck.clone(), uk, cv.clone(), uv, p)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))


def test_kv_write_pair_wrapper_raises_on_unsupported_cuda_inputs(cuda):
    cache = torch.zeros(2, 2, 16, 64, dtype=torch.bfloat16, device=cuda)
    upd = torch.zeros(2, 2, 1, 64, dtype=torch.bfloat16, device=cuda)
    pos = torch.tensor([1, 2], device=cuda)
    n0 = ragged_kv_write.launches, kv_write_pair.launches
    bad = [  # (cache_v, update_v, pos, message)
        (cache[..., :32].contiguous(), upd, pos, "unsupported"),  # V shape
        (cache.float(), upd, pos, "unsupported"),                 # V type
        (cache, upd.float(), pos, "unsupported"),        # updates' types
        (cache, torch.zeros(2, 2, 2, 64, dtype=torch.bfloat16,
                            device=cuda), pos, "unsupported"),    # S differs
        (cache, upd.half(), pos, "unsupported"),  # V's f16, K's bf16
        (cache.transpose(2, 3).contiguous().transpose(2, 3), upd, pos,
         "contiguous"),
        (cache, upd.cpu(), pos, "contiguous"),            # update on the CPU
        (cache, upd, pos.float(), "pos"), (cache, upd, pos.cpu(), "pos"),
        (cache, upd, pos[:1], "pos"), (cache, upd, pos[None], "pos")]
    for cv, uv, p, msg in bad:
        with pytest.raises(ValueError, match=msg):
            kv_write_pair(cache, upd, cv, uv, p)
    assert (ragged_kv_write.launches, kv_write_pair.launches) == n0


def test_kv_write_plan_on_the_card_matches_the_cpu_defaults(cuda):
    """wt_kv_write_limits reads the kernel's threads and blocks a
    multiprocessor on the card (its launch bounds hold 16); on an H100
    the plans of phase 2's shapes are the CPU tests' plans."""
    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    h100 = props.multi_processor_count == 132 and props.major == 9
    for cb, ub in ((2, 2), (4, 4), (2, 4)):
        card = kv_write_limits(cb, ub, index)
        assert card[:2] == kv_write_limits(cb, ub)[:2]
        assert card[2] == props.multi_processor_count
    for args in ((2, 16, 8, 1, 128), (2, 4, 8, 128, 128), (2, 64, 12, 1, 64),
                 (2, 1, 8, 1, 128), (2, 1, 8, 32, 128)):
        card, cpu = kv_write_plan(*args, 2, 2, index), kv_write_plan(*args)
        assert card.units == cpu.units and card.blocks >= 1
        if h100:
            assert card == cpu, args


def test_attention_lowering_sends_a_head_dim_64_decode_step_to_the_kernel(
        cuda):
    """A bf16 single-query step with head dim 64 (GPT-2's) goes to the
    kernel: it launches, within agreement_bound of the plain version."""
    from whisper_tensor_tpu_torch.milli.ops.attention import AttentionMilli
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS

    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(2, 12, 1, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 12, 256, 64, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    pos = torch.tensor([3, 200], device=cuda)
    n0 = decode_attention.launches
    (got,) = LOWERINGS["Attention"](AttentionMilli(scale=0.125),
                                    [q, k, v, pos], [None] * 4, cuda)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    _assert_agree(got, decode_attention_plain(q, k, v, pos, 0.125),
                  decode_attention_plain(q.float(), k, v.abs(), pos, 0.125))


def _tiny_llama(max_len, pos_per_row=False, weight_map=None, head_dim=128,
                dtype=None):
    """A 2-layer llama (the CPU tests' tiny shapes: hidden 256, 2 query
    heads and 1 KV head of `head_dim`, vocab 512) in `dtype` (bf16 by
    default), weights from numpy. weight_map: filled with the recipe's
    {initializer: HF name}."""
    import zlib

    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step)
    from whisper_tensor_tpu_torch.model import Model

    D = head_dim
    cfg = LlamaConfig(num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, hidden_size=256,
                      intermediate_size=384, vocab_size=512, head_dim=D)

    def weights(name):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
        shape = {"embed": (512, 256), "lm_head": (512, 256),
                 "q_proj": (2 * D, 256), "o_proj": (256, 2 * D),
                 "k_proj": (D, 256), "v_proj": (D, 256),
                 "gate_proj": (384, 256), "up_proj": (384, 256),
                 "down_proj": (256, 384)}
        s = next(v for key, v in shape.items() if key in name)
        return (rng.standard_normal(s) * 0.08).astype(np.float32)

    return Model.new_from_onnx(build_llama_step(
        weights, cfg, max_len=max_len, dtype=dtype or DType.BF16,
        pos_per_row=pos_per_row, weight_map=weight_map))


def _direct_pair(cuda, max_len, quantize="int8", **model_kw):
    """The tiny llama's interfaces on the card and on the CPU, over a bf16
    cache (the servers' cache type)."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)

    model = _tiny_llama(max_len, **model_kw)
    kw = dict(max_len=max_len, cache_dtype=DType.BF16, quantize=quantize)
    return (TextInferenceInterface(model, device=cuda, **kw),
            TextInferenceInterface(model, device="cpu", **kw))


@pytest.mark.parametrize("max_len,L,n_new", [(64, 7, 8), (512, 300, 6)])
def test_tiny_llama_on_the_gpu_goes_through_both_kernels(cuda, max_len, L,
                                                         n_new):
    """A 2-layer bf16 int8 llama on the card, a short prompt and a long
    one (300 tokens, bucket 512): the prefill launches flash_attention
    once per layer, greedy decoding launches decode_attention and
    int8_matmul, and the per-step logits stay within 3% of their scale
    of a teacher-forced prefill over the same tokens on the CPU, whose
    wrappers take the plain versions (bf16 rounds at 2^-8 relative, and
    the two paths round and sum in other places through both layers)."""
    gpu, cpu = _direct_pair(cuda, max_len)
    prompt = np.random.default_rng(11).integers(3, 259, (2, L))
    a0, f0, m0 = (decode_attention.launches, flash_attention.launches,
                  int8_matmul.launches)
    toks, logits = gpu.generate_with_logits(prompt, n_new)
    assert flash_attention.launches - f0 == 2              # 2 layers
    assert decode_attention.launches - a0 == 2 * (n_new - 1)
    assert int8_matmul.launches > m0
    assert toks.shape == (2, n_new)
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    want = cpu.logits(full).astype(np.float32)[:, L - 1:]
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=0.03 * np.abs(want).max())


def test_tiny_llama_writes_each_layer_s_caches_in_one_launch(cuda):
    """The direct path (a scalar start) and the batcher (per-row starts)
    on the card: one cache-write launch a layer for every run of the step
    graph, all of them pairs; no index_copy_ on the direct path."""
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    gpu, _ = _direct_pair(cuda, 64)
    runs = []
    step = gpu.step

    def counted(*a, **kw):
        runs.append(1)
        return step(*a, **kw)

    gpu.step = counted
    n0 = ragged_kv_write.launches, kv_write_pair.launches
    gpu.generate_tokens(np.random.default_rng(3).integers(3, 259, (2, 7)), 5)
    torch.cuda.synchronize()
    assert len(runs) == 5
    assert (ragged_kv_write.launches - n0[0],
            kv_write_pair.launches - n0[1]) == (2 * 5, 2 * 5)
    b = ContinuousBatcher(_tiny_llama(64, pos_per_row=True), max_len=64,
                          max_batch=4, chunk=4, quantize="int8",
                          prefill_chunk=16, device=cuda)
    runs.clear()
    step = b.iface.step
    b.iface.step = counted
    n0 = ragged_kv_write.launches, kv_write_pair.launches
    b.start()
    rng = np.random.default_rng(4)
    try:
        for f in [b.submit(rng.integers(3, 259, (n,)), 5)
                  for n in (4, 21, 9)]:
            f.result(timeout=300)
    finally:
        b.stop()
    assert runs
    assert (ragged_kv_write.launches - n0[0],
            kv_write_pair.launches - n0[1]) == (2 * len(runs),) * 2


def test_tiny_llama_batcher_on_the_gpu_launches_all_three_kernels(cuda):
    """The batcher on the card over a 2-layer bf16 int8 llama, prompts of
    3 to 300 tokens in 16-token prefill pieces: every request is served,
    each kernel's launch counter rises (flash_attention in every piece),
    the ragged cache write takes the kernel (no plain path on the card),
    and each answer stands a teacher-forced prefill of the direct path
    on the card: every emitted token's logit within 3% of the logits'
    scale of that step's largest."""
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    model = _tiny_llama(512, pos_per_row=True)
    b = ContinuousBatcher(model, max_len=512, max_batch=4, chunk=4,
                          quantize="int8", prefill_chunk=16,
                          device=cuda).start()
    counters = (decode_attention, int8_matmul, ragged_kv_write,
                flash_attention)
    before = [f.launches for f in counters]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 259, (n,)) for n in (5, 40, 300, 12, 3, 170)]
    try:
        outs = [f.result(timeout=300)
                for f in [b.submit(p, 6) for p in prompts]]
    finally:
        b.stop()
    assert all(o.shape == (6,) and (o >= 0).all() and (o < 512).all()
               for o in outs)
    rose = [f.launches - n for f, n in zip(counters, before)]
    assert min(rose) > 0, rose
    gpu, _ = _direct_pair(cuda, 512)
    for p, o in zip(prompts, outs):
        full = np.concatenate([p, o[:-1]])[None]
        lg = gpu.logits(full).astype(np.float32)[0, len(p) - 1:]
        gap = lg.max(-1) - lg[np.arange(6), o]
        assert gap.max() <= 0.03 * np.abs(lg).max(), (len(p), gap)


def test_tiny_llama_super_graph_job_on_the_gpu(cuda):
    """The LLM super graph (super_graph/llm.py) over a 2-layer bf16 llama
    of head dim 128 on the card, on its int8 text interface's graph and
    weights (TextInferenceInterface.eval_backend): the prefill launches
    flash_attention once a layer, each decode step decode_attention once
    a layer, every run writes each cache with one
    ragged_kv_write launch (Model.eval runs no pair pass), int8_matmul
    launches once a QuantMatMul call, each equal to the lowering's
    calls; the answer stands a teacher-forced prefill of the direct path
    on the CPU (every emitted token's logit within 3% of the logits'
    scale of that step's largest)."""
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
    from whisper_tensor_tpu_torch.super_graph import ExecutionContext
    from whisper_tensor_tpu_torch.super_graph.llm import build_llm_supergraph
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    gpu, cpu = _direct_pair(cuda, 64)
    model = gpu.model
    n_new, text = 6, "hello there"
    g = build_llm_supergraph(model.name, "bytes", n_layers=2, n_kv_heads=1,
                             max_len=64, head_dim=128, n_new=n_new)
    calls = {"Attention": 0, "DynUpdateSlice": 0, "QuantMatMul": 0}
    saved = {k: LOWERINGS[k] for k in calls}

    def counting(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    counters = (flash_attention, decode_attention, ragged_kv_write,
                kv_write_pair, int8_matmul)
    before = [f.launches for f in counters]
    LOWERINGS.update({k: counting(k, fn) for k, fn in saved.items()})
    try:
        out = g.run(ExecutionContext(models={model.name: model}, device=cuda,
                                     backends={model.name:
                                               gpu.eval_backend()}),
                    {"text": text})
    finally:
        LOWERINGS.update(saved)
    flash, decode, kv, pair, i8 = [f.launches - n
                                   for f, n in zip(counters, before)]
    assert (flash, decode) == (2, 2 * (n_new - 1))
    assert flash + decode == calls["Attention"]
    assert kv == calls["DynUpdateSlice"] == 2 * 2 * n_new and pair == 0
    assert i8 == calls["QuantMatMul"] > 0
    toks = out["tokens"]
    assert toks.shape == (n_new,)
    prompt = np.asarray(ByteTokenizer().encode(text), np.int64)
    full = np.concatenate([prompt, toks[:-1]])[None]
    lg = cpu.logits(full).astype(np.float32)[0, len(prompt) - 1:]
    gap = lg.max(-1) - lg[np.arange(n_new), toks]
    assert gap.max() <= 0.03 * np.abs(lg).max(), gap


def test_tiny_llama_q4_0_on_the_gpu_direct_and_batched(cuda):
    """The 2-layer bf16 llama host-quantized to q4_0: the direct path and
    the batcher launch packed_matmul (and int8_matmul never); each
    answer stands a teacher-forced prefill of the direct path on the
    card (3% of the logits' scale, as above), and the direct path's
    decode logits stay within 3% of the scale of the CPU's teacher-
    forced prefill (plain versions)."""
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    gpu, cpu = _direct_pair(cuda, 64, quantize="q4_0")
    assert gpu._packed and not gpu._quantized
    prompt = np.random.default_rng(5).integers(3, 259, (2, 9))
    p0, i0 = packed_matmul.launches, int8_matmul.launches
    toks, logits = gpu.generate_with_logits(prompt, 6)
    assert packed_matmul.launches > p0 and int8_matmul.launches == i0
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    want = cpu.logits(full).astype(np.float32)[:, 8:]
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=0.03 * np.abs(want).max())
    b = ContinuousBatcher(_tiny_llama(64, pos_per_row=True), max_len=64,
                          max_batch=4, chunk=4, quantize="q4_0",
                          prefill_chunk=16, device=cuda).start()
    p0 = packed_matmul.launches
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, 259, (n,)) for n in (4, 21, 9)]
    try:
        outs = [f.result(timeout=300)
                for f in [b.submit(p, 5) for p in prompts]]
    finally:
        b.stop()
    assert packed_matmul.launches > p0 and int8_matmul.launches == i0
    for p, o in zip(prompts, outs):
        lg = gpu.logits(np.concatenate([p, o[:-1]])[None]
                        ).astype(np.float32)[0, len(p) - 1:]
        gap = lg.max(-1) - lg[np.arange(5), o]
        assert gap.max() <= 0.03 * np.abs(lg).max(), (len(p), gap)


# -- GPTQ/AWQ layouts, beam search, constraints, hidden states ------------

def _batched_answers_stand(cuda, model, gpu, quantize, n_new=5, **kw):
    """Prompts of 4, 21 and 9 tokens through the batcher on the card (bf16
    cache, 16-token prefill pieces); each answer stands a teacher-forced
    prefill of the direct path `gpu`: every emitted token's logit within
    3% of the logits' scale of that step's largest."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    b = ContinuousBatcher(model, max_len=64, max_batch=4, chunk=4,
                          quantize=quantize, prefill_chunk=16,
                          cache_dtype=DType.BF16, device=cuda, **kw).start()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, 259, (n,)) for n in (4, 21, 9)]
    try:
        outs = [f.result(timeout=300)
                for f in [b.submit(p, n_new) for p in prompts]]
    finally:
        b.stop()
    for p, o in zip(prompts, outs):
        lg = gpu.logits(np.concatenate([p, o[:-1]])[None]
                        ).astype(np.float32)[0, len(p) - 1:]
        gap = lg.max(-1) - lg[np.arange(n_new), o]
        assert gap.max() <= 0.03 * np.abs(lg).max(), (len(p), gap)


@pytest.mark.parametrize("D", [32, 96])
def test_tiny_llama_of_a_head_dim_no_attention_kernel_takes(cuda, D):
    """ROADMAP C16: a bf16 int8 llama of head dim 32 or 96 (Phi-3-mini's)
    on the card, direct and batched. Neither attention kernel takes that
    head dim, so the Attention lowering runs the plain path (no launch,
    no raise); the cache writes and the int8 products still launch their
    kernels. Decode logits within 3% of the scale of the CPU's teacher-
    forced prefill; batched answers stand the direct path's."""
    gpu, cpu = _direct_pair(cuda, 64, head_dim=D)
    prompt = np.random.default_rng(5).integers(3, 259, (2, 9))
    counters = (decode_attention, flash_attention, kv_write_pair,
                int8_matmul)
    before = [c.launches for c in counters]
    toks, logits = gpu.generate_with_logits(prompt, 6)
    torch.cuda.synchronize()
    rose = [c.launches - n for c, n in zip(counters, before)]
    assert rose[:2] == [0, 0] and rose[2] == 2 * 6 and rose[3] > 0, rose
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    want = cpu.logits(full).astype(np.float32)[:, 8:]
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=0.03 * np.abs(want).max())
    before = [c.launches for c in counters]
    _batched_answers_stand(cuda, _tiny_llama(64, pos_per_row=True,
                                             head_dim=D), gpu, "int8")
    rose = [c.launches - n for c, n in zip(counters, before)]
    assert rose[:2] == [0, 0] and min(rose[2:]) > 0, rose


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_tiny_llama_in_f16_over_a_bf16_cache(cuda, quantize):
    """ROADMAP C17: a llama loaded with dtype=f16 over the servers' bf16
    cache, dense and int8, direct and batched, on the card: each step's
    K/V update is written by kv_write_pair (f16 into bf16), decode steps
    run decode_attention on an f16 query, int8 products take f16 x
    through f32; the f16 prefill runs the plain attention path (flash is
    bf16 only, as the TPU kernel). Decode logits within 3% of the scale
    of the CPU's teacher-forced prefill; batched answers stand the direct
    path's."""
    from whisper_tensor_tpu_torch.dtype import DType

    gpu, cpu = _direct_pair(cuda, 64, quantize=quantize, dtype=DType.F16)
    prompt = np.random.default_rng(7).integers(3, 259, (2, 9))
    counters = (decode_attention, flash_attention, kv_write_pair,
                int8_matmul)
    before = [c.launches for c in counters]
    toks, logits = gpu.generate_with_logits(prompt, 6)
    torch.cuda.synchronize()
    rose = [c.launches - n for c, n in zip(counters, before)]
    assert rose[:3] == [2 * 5, 0, 2 * 6], rose
    assert (rose[3] > 0) == (quantize == "int8"), rose
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    want = cpu.logits(full).astype(np.float32)[:, 8:]
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=0.03 * np.abs(want).max())
    before = [c.launches for c in counters]
    _batched_answers_stand(cuda, _tiny_llama(64, pos_per_row=True,
                                             dtype=DType.F16), gpu, quantize)
    rose = [c.launches - n for c, n in zip(counters, before)]
    assert rose[0] > 0 and rose[2] > 0, rose


def _gptq_layout(K, N, G, seed):
    """A GPTQ-style quantized weight in the kernel's layout, by the
    port's repack_for_kernel: 4-bit values, zero points 1..15, scales
    in [0.001, 0.011); returns (layout dict, the (K, N) f32 weight)."""
    from whisper_tensor_tpu_torch.importers.quantized import (
        dequant_dense, repack_for_kernel)

    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (K, N)).astype(np.uint8)
    zeros = rng.integers(1, 16, (K // G, N)).astype(np.float32)
    scales = rng.random((K // G, N), dtype=np.float32) * 0.01 + 0.001
    return repack_for_kernel(q, zeros, scales), dequant_dense(q, zeros, scales)


@pytest.mark.parametrize("G", [64, 128])
@pytest.mark.parametrize("M,K,N", [(1, 4096, 1024), (1, 4096, 6144),
                                   (5, 512, 200), (16, 14336, 512),
                                   (17, 512, 1064), (512, 4096, 256)])
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
def test_packed_matmul_kernel_on_the_gptq_layout(cuda, G, M, K, N, tdt):
    """The kernel on repack_for_kernel's layout (groups of 64 and 128,
    offsets from zero points, ragged N): bf16 within agreement_bound of
    the plain version, element by element; f32 the same products summed
    in another order, 1e-5 of the scale; x = I gives the numpy
    dequantization of the layout bit for bit."""
    rp, _ = _gptq_layout(K, N, G, seed=M + K + N + G)
    assert bool(rp["has_off"])
    q, s, o = (torch.from_numpy(rp[k]).to(cuda)
               for k in ("q", "scales", "offsets"))
    g = torch.Generator(device=cuda).manual_seed(M * G)
    x = torch.randn(M, K, generator=g, device=cuda).to(tdt)
    n0 = packed_matmul.launches
    got = packed_matmul(x, q, s, o, 4, True)
    want = packed_matmul_plain(x, q, s, o, 4, True)
    torch.cuda.synchronize()
    assert packed_matmul.launches == n0 + 1 and got.shape == (M, N)
    if tdt == torch.bfloat16:
        w = dequantize_packed(q, s, o, 4, True)
        _assert_agree(got, want, x.float().abs() @ w.abs())
    else:
        torch.testing.assert_close(
            got, want, atol=1e-5 * max(1.0, want.abs().max().item()), rtol=0)
    if K <= 4096 and N <= 1064:
        eye = packed_matmul(torch.eye(K, device=cuda), q, s, o, 4, True)
        np.testing.assert_array_equal(eye.cpu().numpy().view(np.int32),
                                      dequant_repacked(rp).view(np.int32))


@pytest.mark.parametrize("cache_dt,upd_dt", KV_WRITE_DTYPES)
@pytest.mark.parametrize("B,W,H,L,D,pos", [(1, 4, 8, 2048, 128, 37),
                                           (2, 3, 2, 64, 128, 63),
                                           (3, 2, 12, 256, 64, 0)])
def test_beam_reorder_then_kv_write_pair(cuda, B, W, H, L, D, pos, cache_dt,
                                         upd_dt):
    """A beam step on the card: the caches gathered by parent beam into
    the second buffer (TextInferenceInterface._reorder_caches), then
    the next step's kv_write_pair at the direct path's scalar start into
    that buffer. Both whole caches equal the plain write into the CPU's
    gather bit for bit: the write lands in the reordered rows."""
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)

    R = B * W
    g = torch.Generator(device=cuda).manual_seed(R * L + D + pos)
    src = [torch.randn(R, H, L, D, generator=g, device=cuda).to(cache_dt)
           for _ in range(2)]
    dst = [torch.empty_like(c) for c in src]
    rows = torch.randint(0, W, (B, W), generator=g, device=cuda)
    rows = (torch.arange(B, device=cuda)[:, None] * W + rows).reshape(-1)
    uk = torch.randn(R, H, 1, D, generator=g, device=cuda).to(upd_dt)
    uv = torch.randn(R, 1, H, D, generator=g, device=cuda).to(
        upd_dt).transpose(1, 2)
    start = torch.tensor(pos, device=cuda)
    want = kv_write_pair_plain(src[0].cpu()[rows.cpu()], uk.cpu(),
                               src[1].cpu()[rows.cpu()], uv.cpu(),
                               start.cpu())
    TextInferenceInterface._reorder_caches(None, src, dst, rows)
    n0 = kv_write_pair.launches
    got = kv_write_pair(dst[0], uk, dst[1], uv, start)
    torch.cuda.synchronize()
    assert kv_write_pair.launches == n0 + 1
    assert got[0] is dst[0] and got[1] is dst[1]
    for a, b in zip(got, want):
        assert torch.equal(_bits(a.cpu()), _bits(b))


def test_tiny_llama_beam_constraint_and_hidden_states_on_the_gpu(cuda):
    """The 2-layer bf16 int8 llama on the card: beam search (W = 3)
    launches decode_attention and one kv_write_pair a layer a step at
    B*W rows, and the best beam's mean log-probability by
    sequence_scores stands the score the search ranks it by (1% of its
    size: bf16 rounding between decode and prefill); a constrained
    greedy decode fullmatches with the kernels launched; hidden_states
    (C12: the lm_head is a QuantMatMul) stands the CPU's plain versions
    within 3% of its scale."""
    import re

    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    gpu, cpu = _direct_pair(cuda, 64)
    prompt = np.random.default_rng(8).integers(3, 259, (2, 7))
    a0, p0 = decode_attention.launches, kv_write_pair.launches
    toks, score = gpu.beam_search_tokens(prompt, 6, beam=3,
                                         return_scores=True)
    torch.cuda.synchronize()
    assert toks.shape == (2, 6)
    assert decode_attention.launches - a0 == 2 * 5
    assert kv_write_pair.launches - p0 == 2 * 6
    full = np.concatenate([prompt, toks], axis=1)
    mean = gpu.sequence_scores(full, np.full(2, 7), np.full(2, 13))
    np.testing.assert_allclose(mean * 6, score, rtol=0.01)
    gpu.tokenizer = ByteTokenizer()
    a0, m0 = decode_attention.launches, int8_matmul.launches
    text = gpu.run_string_in_string_out("hi", 16, regex=r"ab{1,4}c")
    assert re.fullmatch(r"ab{1,4}c", text)
    assert decode_attention.launches > a0 and int8_matmul.launches > m0
    want = cpu.hidden_states(prompt).astype(np.float32)
    got = gpu.hidden_states(prompt).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.03 * np.abs(want).max())


def test_tiny_llama_speculative_greedy_on_the_gpu(cuda):
    """The 2-layer bf16 int8 llama drafting for itself at k 4 on the
    card: flash_attention launches once a layer for each prefill and
    each verify round (4 query rows at a scalar start), kv_write_pair
    once a layer for every run of either step graph, int8_matmul at the
    verify's 4 rows. The verify block and a decode step round in bf16 in
    different places, so the tokens must equal plain greedy decoding up
    to the first difference, which must be a near tie (the plain
    decode's margin over the speculative token within 6% of its logits'
    scale: twice the 3% the tests above allow between paths), and every
    token must stand a teacher-forced prefill (3% of the scale)."""
    from whisper_tensor_tpu_torch.interfaces.speculative import (
        SpeculativeDecoder)

    gpu, _ = _direct_pair(cuda, 64)
    prompt = np.random.default_rng(12).integers(3, 259, (1, 7))
    plain, plain_logits = gpu.generate_with_logits(prompt, 20)
    dec = SpeculativeDecoder(gpu, gpu, k=4)
    f0, w0, m0 = (flash_attention.launches, kv_write_pair.launches,
                  int8_matmul.launches)
    toks = dec.generate_tokens(prompt, 20)
    torch.cuda.synchronize()
    rounds = dec.last_rounds
    assert flash_attention.launches - f0 == 2 * (2 + rounds)
    assert kv_write_pair.launches - w0 == 2 * (2 + rounds * (4 + 1))
    assert int8_matmul.launches > m0
    scale = np.abs(plain_logits).max()
    differ = np.nonzero(toks[0] != plain[0])[0]
    if differ.size:
        i = differ[0]
        row = plain_logits[0, i]
        assert row[plain[0, i]] - row[toks[0, i]] <= 0.06 * scale
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    forced = gpu.logits(full).astype(np.float32)[0, 6:]
    gaps = forced.max(-1) - forced[np.arange(20), toks[0]]
    assert gaps.max() <= 0.03 * np.abs(forced).max()


def test_tiny_llama_adapted_batcher_on_the_gpu(cuda):
    """The 2-layer bf16 llama with two adapters (rank 8 on q, k, v, o,
    gate, up and down) through the batcher on the card: base, a and b
    requests in one batch are served, the attention and cache-write
    kernels launch, and one decode step of the adapted graph at 4 rows
    under slots 0, 1, 2, 1 stands the same step with every kernel's
    plain version in place, on copies of one cache, within 3% of the
    logits' scale (the rounding the tests above allow between paths)."""
    from whisper_tensor_tpu_torch.milli.ops import attention, misc
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    wmap = {}
    model = _tiny_llama(512, pos_per_row=True, weight_map=wmap)
    rng = np.random.default_rng(21)
    shapes = {"q_proj": (256, 256), "o_proj": (256, 256),
              "k_proj": (256, 128), "v_proj": (256, 128),
              "gate_proj": (256, 384), "up_proj": (256, 384),
              "down_proj": (384, 256)}                   # (K, N)

    def adapter():
        out = {}
        for init, hf in wmap.items():
            proj = [k for k in shapes if k in hf]
            if not proj:
                continue                                 # the lm_head
            K, N = shapes[proj[0]]
            out[init] = ((rng.standard_normal((K, 8)) * 0.1).astype(
                np.float32), (rng.standard_normal((8, N)) * 0.1).astype(
                np.float32), 2.0)
        return out

    b = ContinuousBatcher(model, max_len=512, max_batch=4, chunk=4,
                          prefill_chunk=16, device=cuda,
                          adapters={"a": adapter(), "b": adapter()}).start()
    n0 = [f.launches for f in (decode_attention, flash_attention,
                               kv_write_pair)]
    prompts = [rng.integers(3, 259, (n,)) for n in (5, 40, 12, 170)]
    try:
        outs = [f.result(timeout=300) for f in [
            b.submit(p, 6, adapter=a)
            for p, a in zip(prompts, (None, "a", "b", "a"))]]
    finally:
        b.stop()
    assert all(o.shape == (6,) for o in outs)
    assert all(f.launches > n for f, n in zip(
        (decode_attention, flash_attention, kv_write_pair), n0))
    iface = b.iface
    caches = iface.fresh_cache(4)
    iface.step(torch.from_numpy(rng.integers(3, 259, (4, 32))).to(cuda),
               torch.zeros(4, dtype=torch.int64, device=cuda), caches,
               torch.tensor([0, 1, 2, 1], device=cuda))
    ids = torch.from_numpy(rng.integers(3, 259, (4, 1))).to(cuda)
    pos = torch.full((4,), 32, dtype=torch.int64, device=cuda)
    lora = torch.tensor([0, 1, 2, 1], device=cuda)
    got = iface.step(ids, pos, [c.clone() for c in caches], lora).float()
    swaps = [(attention, "flash_attention", flash_attention_plain),
             (attention, "decode_attention", decode_attention_plain),
             (misc, "kv_write_pair", kv_write_pair_plain)]
    saved = [getattr(m, a) for m, a, _ in swaps]
    try:
        for m, a, fn in swaps:
            setattr(m, a, fn)
        want = iface.step(ids, pos, [c.clone() for c in caches],
                          lora).float()
    finally:
        for (m, a, _), fn in zip(swaps, saved):
            setattr(m, a, fn)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 0.03 * scale
    # the adapters act: the adapted rows part from the base model's
    base = iface.step(ids, pos, [c.clone() for c in caches]).float()
    assert (base[0] - got[0]).abs().max() <= 0.03 * scale
    assert min((base[r] - got[r]).abs().max() for r in (1, 2, 3)) \
        > 0.03 * scale


# -- the Attention lowering's causal and additive routes to flash ---------
# (B, Hq, Hkv, Sq, Skv, D, qdt, mask) around the edge of what the kernel
# takes: the route must be exactly the wrapper's domain (a wrapper
# launches its kernel or raises, so a routed call the wrapper refuses
# would fail, and one it takes but the route misses runs the plain path)
FLASH_ROUTES = [
    (1, 4, 2, 16, 16, 64, torch.bfloat16, None),
    (2, 8, 2, 33, 70, 128, torch.bfloat16, "B"),
    (1, 4, 4, 16, 16, 128, torch.bfloat16, "1"),
    (1, 4, 2, 16, 16, 96, torch.bfloat16, None),      # D outside
    (1, 4, 2, 16, 16, 32, torch.bfloat16, "1"),       # D outside
    (1, 4, 2, 16, 16, 64, torch.float32, None),       # f32
    (1, 4, 2, 16, 16, 64, torch.float16, "1"),        # f16
    (1, 4, 2, 16, 16, 64, torch.bfloat16, "H"),       # mask per head
]


def _route_inputs(cuda, B, Hq, Hkv, Sq, Skv, D, qdt, mask):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + Sq + D)
    q = torch.randn(B, Hq, Sq, D, generator=g, device=cuda).to(qdt)
    k, v = (torch.randn(B, Hkv, Skv, D, generator=g, device=cuda).to(qdt)
            for _ in range(2))
    m = None
    if mask is not None:
        mb, mh = (B if mask == "B" else 1), (Hq if mask == "H" else 1)
        m = torch.where(torch.rand(mb, mh, Sq, Skv, generator=g,
                                   device=cuda) < 0.7, 0.0, -1e4).to(qdt)
    return q, k, v, m


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,qdt,mask", FLASH_ROUTES)
def test_flash_route_is_exactly_what_the_wrapper_takes(cuda, B, Hq, Hkv, Sq,
                                                       Skv, D, qdt, mask):
    from whisper_tensor_tpu_torch.milli.ops.attention import (AttentionMilli,
                                                             flash_mode)

    q, k, v, m = _route_inputs(cuda, B, Hq, Hkv, Sq, Skv, D, qdt, mask)
    op = AttentionMilli(is_causal=m is None)
    mode = flash_mode(op, q, k, v, m, need_qk=False)
    kw = {"causal": True} if m is None else {"mask": m}
    if mode is None:
        with pytest.raises(ValueError):
            flash_attention(q, k, v, 0.125, **kw)
    else:
        assert mode == ("causal" if m is None else "additive")
        flash_attention(q, k, v, 0.125, **kw)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,qdt,mask", FLASH_ROUTES)
def test_attention_lowering_takes_flash_in_its_causal_and_additive_modes(
        cuda, B, Hq, Hkv, Sq, Skv, D, qdt, mask):
    """A routed call launches flash once and agrees with the kernel's plain
    version; a call just outside the route launches nothing and agrees
    with the f32 plain path on the CPU."""
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
    from whisper_tensor_tpu_torch.milli.ops.attention import (AttentionMilli,
                                                             flash_mode)

    q, k, v, m = _route_inputs(cuda, B, Hq, Hkv, Sq, Skv, D, qdt, mask)
    op = AttentionMilli(scale=0.125, is_causal=m is None)
    ins = [q, k, v] + ([] if m is None else [m])
    routed = flash_mode(op, q, k, v, m, need_qk=False) is not None
    n0 = flash_attention.launches
    (got,) = LOWERINGS["Attention"](op, ins, [None] * len(ins), cuda)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + int(routed)
    if routed:
        kw = {"causal": True} if m is None else {"mask": m}
        want = flash_attention_plain(q, k, v, 0.125, **kw)
        mag = flash_attention_plain(q, k, v.abs(), 0.125, **kw)
        err = (got.float() - want.float()).abs()
        assert bool((err <= flash_agreement_bound(want, mag)).all())
    else:
        cpu = torch.device("cpu")
        (want,) = LOWERINGS["Attention"](
            op, [t.cpu() for t in ins], [None] * len(ins), cpu)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=2e-2, atol=2e-2)


def test_causal_rows_that_see_no_key_take_the_mean_of_v(cuda):
    """Sq > Skv: the first Sq - Skv rows see no key; the oracle's -1e30
    fill gives them the mean of v. The rest run the kernel's causal mode
    in one launch."""
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
    from whisper_tensor_tpu_torch.milli.ops.attention import AttentionMilli

    q, k, v, _ = _route_inputs(cuda, 1, 4, 2, 40, 24, 64, torch.bfloat16,
                               None)
    n0 = flash_attention.launches
    (got,) = LOWERINGS["Attention"](AttentionMilli(scale=0.125,
                                                   is_causal=True),
                                    [q, k, v], [None] * 3, cuda)
    assert flash_attention.launches == n0 + 1
    mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(2, dim=1)
    torch.testing.assert_close(got[:, :, :16].float(),
                               mean.to(torch.bfloat16).float().expand(
                                   1, 4, 16, 64), rtol=0, atol=0)
    want = flash_attention_plain(q[:, :, 16:], k, v, 0.125, causal=True)
    mag = flash_attention_plain(q[:, :, 16:], k, v.abs(), 0.125, causal=True)
    err = (got[:, :, 16:].float() - want.float()).abs()
    assert bool((err <= flash_agreement_bound(want, mag)).all())


# the SD UNet's unmasked calls: self-attention at 8 heads of 40, 80 and
# 160 (padded by the lowering to 64, 128 and 256), the cross-attention's
# 77 text keys at each, a head dim the kernel has (SD-2's 64), and key
# counts that end inside a 32- or 64-key tile
SD_UNMASKED = [(2, 8, 1024, 1024, 40), (2, 8, 256, 256, 80),
               (2, 8, 64, 64, 160), (1, 8, 4096, 4096, 40),
               (2, 8, 1024, 77, 40), (2, 8, 256, 77, 80),
               (2, 8, 64, 77, 160), (2, 5, 100, 77, 64),
               (1, 8, 300, 200, 160)]


@pytest.mark.parametrize("B,H,Sq,Skv,D", SD_UNMASKED)
def test_attention_lowering_takes_flash_unmasked_at_the_sd_shapes(
        cuda, B, H, Sq, Skv, D):
    """One flash launch a call, within flash_agreement_bound of the plain
    version at the native head dim; q, k and v are the recipe's
    transposed views."""
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
    from whisper_tensor_tpu_torch.milli.ops.attention import (AttentionMilli,
                                                             flash_mode)

    g = torch.Generator(device=cuda).manual_seed(B * Sq + Skv + D)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, Skv, H, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    op = AttentionMilli(scale=D ** -0.5)
    assert flash_mode(op, q, k, v, None, False) == "none"
    n0 = flash_attention.launches
    (got,) = LOWERINGS["Attention"](op, [q, k, v], [None] * 3, cuda)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.shape == (B, H, Sq, D)
    want = flash_attention_plain(q, k, v, D ** -0.5)
    mag = flash_attention_plain(q, k, v.abs(), D ** -0.5)
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_agreement_bound(want, mag)).all()), \
        f"max |err| {err.max().item()}"


def _write_tiny_sd(d):
    """A tiny `sd` diffusers directory from the port's recipes and a
    seeded getter (numpy and safetensors only)."""
    import json
    import os

    from safetensors.numpy import save_file

    from whisper_tensor_tpu_torch.importers.recipes.diffusion import (unet,
                                                                      vae)

    get = unet.random_unet_weights(0)

    def component(sub, cfg_json, *builds):
        rec = {}

        def getter(name, shape=None):
            rec[name] = np.ascontiguousarray(get(name, shape), np.float32)
            return rec[name]

        for build, kw in builds:
            build(getter, **kw)
        os.makedirs(os.path.join(d, sub))
        with open(os.path.join(d, sub, "config.json"), "w") as f:
            json.dump(cfg_json, f)
        save_file(rec, os.path.join(d, sub, "model.safetensors"))

    ucfg = {"block_out_channels": [32, 64], "layers_per_block": 1,
            "cross_attention_dim": 32, "attention_head_dim": 2,
            "norm_num_groups": 8, "sample_size": 16,
            "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"]}
    vcfg = {"block_out_channels": [8, 8, 16, 16], "layers_per_block": 1,
            "norm_num_groups": 4}
    component("unet", ucfg, (unet.build_sd_unet, dict(
        cfg=unet.UNetConfig.from_hf(ucfg), batch=2, latent_hw=(16, 16))))
    vc = vae.VAEConfig.from_hf(vcfg)
    component("vae", vcfg,
              (vae.build_vae_decoder, dict(cfg=vc, latent_hw=(16, 16))),
              (vae.build_vae_encoder, dict(cfg=vc, image_hw=(128, 128))))
    E, F = 32, 64
    p = "text_model.encoder.layers.0."
    clip = {"text_model.embeddings.token_embedding.weight": (100, E),
            "text_model.embeddings.position_embedding.weight": (77, E),
            "text_model.final_layer_norm.weight": (E,),
            "text_model.final_layer_norm.bias": (E,),
            p + "mlp.fc1.weight": (F, E), p + "mlp.fc1.bias": (F,),
            p + "mlp.fc2.weight": (E, F), p + "mlp.fc2.bias": (E,)}
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        clip[p + f"self_attn.{n}.weight"] = (E, E)
        clip[p + f"self_attn.{n}.bias"] = (E,)
    for n in ("layer_norm1", "layer_norm2"):
        clip[p + n + ".weight"] = clip[p + n + ".bias"] = (E,)
    os.makedirs(os.path.join(d, "text_encoder"))
    with open(os.path.join(d, "text_encoder", "config.json"), "w") as f:
        json.dump({"num_hidden_layers": 1, "hidden_size": E,
                   "num_attention_heads": 2, "intermediate_size": F,
                   "vocab_size": 100, "max_position_embeddings": 77,
                   "hidden_act": "quick_gelu", "bos_token_id": 1,
                   "eos_token_id": 2}, f)
    save_file({n: np.ascontiguousarray(get(n, s), np.float32)
               for n, s in clip.items()},
              os.path.join(d, "text_encoder", "model.safetensors"))
    with open(os.path.join(d, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionPipeline"}, f)


def test_tiny_sd_pipeline_on_the_gpu(cuda, tmp_path):
    """txt2img, img2img and inpaint in bf16 on the card: the UNet's
    unmasked attention (2 heads of 16 and of 32, padded to 64; the
    cross-attention's 77 keys) and CLIP's causal attention launch flash
    once a call; each image within bf16's drift of the same pipeline on
    the CPU (kernels' plain versions)."""
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.image_gen import (
        ImageGenConfig, image_interface_from_bundle)
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
    from whisper_tensor_tpu_torch.milli.ops.attention import flash_mode

    d = str(tmp_path / "sd")
    _write_tiny_sd(d)
    kw = dict(dtype="bf16", img2img=True, height=128, width=128)
    gpu = image_interface_from_bundle(identify_and_load(d, **kw))
    cpu = image_interface_from_bundle(identify_and_load(d, **kw),
                                      device="cpu")
    calls = []
    attention = LOWERINGS["Attention"]

    def spy(op, ins, static, device):
        if device.type == "cuda":
            m = ins[3] if len(ins) > 3 else None
            calls.append(flash_mode(op, ins[0], ins[1], ins[2], m,
                                    op.n_out >= 4) is not None)
        return attention(op, ins, static, device)

    cfg = ImageGenConfig(steps=3, height=128, width=128, seed=5)
    init = np.random.default_rng(1).integers(0, 255, (128, 128, 3)).astype(
        np.uint8)
    mask = np.zeros((128, 128), np.float32)
    mask[:, 64:] = 1
    LOWERINGS["Attention"] = spy
    try:
        n0 = fa.flash_attention.launches
        imgs = [gpu.run("x", cfg=cfg).pixels,
                gpu.run_img2img("x", init, strength=0.5, cfg=cfg).pixels,
                gpu.run_inpaint("x", init, mask, cfg=cfg).pixels]
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches - n0
    finally:
        LOWERINGS["Attention"] = attention
    assert sum(calls) == launches > 0
    want = [cpu.run("x", cfg=cfg).pixels,
            cpu.run_img2img("x", init, strength=0.5, cfg=cfg).pixels,
            cpu.run_inpaint("x", init, mask, cfg=cfg).pixels]
    for a, b in zip(imgs, want):
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert a.shape == (128, 128, 3) and a.std() > 1.0
        assert diff.mean() <= 3.0, diff.mean()


# -- training (int8_matmul_dx, the trainer on the card, the grad guards) ----

# (K, N) of W. The TMA path: QLoRA's k/v widths, a K that is not a
# multiple of the 256-row tile, an N below one 64-column stage. The
# cp.async path: an odd N (W staged by plain loads), odd K and N, and a K
# whose bf16 dx rows are not whole 16-byte units (f32 dy takes the TMA
# path there). Small M splits the reduction on both paths.
DX_SHAPES = [(4096, 1024), (1000, 4096), (264, 48), (1000, 771), (257, 129),
             (4100, 512)]


def _dx_inputs(dev, M, K, N, tdt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn(M, N, generator=gen, device=dev).to(tdt)
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, generator=gen, device=dev) * 0.01 + 1e-3
    return dy, w, s


@pytest.mark.parametrize("K,N", DX_SHAPES)
@pytest.mark.parametrize("M", [1, 5, 1000, 1024, 2048])
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
def test_int8_matmul_dx_kernel_matches_plain(cuda, M, K, N, tdt):
    dy, w, s = _dx_inputs(cuda, M, K, N, tdt, M * 7 + K + N)
    plan = qm.dx_plan(M, K, N, tdt, torch.cuda.current_device())
    bf16 = tdt == torch.bfloat16
    assert plan.path == ("tma" if qm.dx_tma_takes(K, N, bf16)
                         else "cp.async")
    n0 = qm.int8_matmul_dx.launches
    paths = dict(qm.int8_matmul_dx.path_launches)
    got = qm.int8_matmul_dx(dy, w, s)
    torch.cuda.synchronize()
    assert qm.int8_matmul_dx.launches == n0 + 1
    paths[plan.path] += 1
    assert qm.int8_matmul_dx.path_launches == paths
    assert got.shape == (M, K) and got.dtype == tdt
    _assert_agree(got, qm.int8_matmul_dx_plain(dy, w, s),
                  qm.int8_matmul_dx_plain(dy.float().abs(), w.abs(), s))


# (M, K, N, path, split): each path with its reduction split and whole
@pytest.mark.parametrize("M,K,N,path,split", [
    (300, 512, 1024, "tma", True), (2048, 4096, 1024, "tma", False),
    (300, 512, 1000, "cp.async", True), (1024, 4096, 1000, "cp.async",
                                         False)])
def test_int8_matmul_dx_kernel_is_deterministic(cuda, M, K, N, path, split):
    dy, w, s = _dx_inputs(cuda, M, K, N, torch.bfloat16, 3)
    s += 0.1
    plan = qm.dx_plan(M, K, N, torch.bfloat16, torch.cuda.current_device())
    assert plan.path == path and (plan.splits > 1) == split
    first = qm.int8_matmul_dx(dy, w, s)
    for _ in range(3):
        assert torch.equal(qm.int8_matmul_dx(dy, w, s), first)


@pytest.mark.parametrize("path", qm.DX_PATHS)
@pytest.mark.parametrize("bf16", [True, False])
def test_int8_matmul_dx_limits_on_the_card_are_the_plans_cpu_defaults(
        cuda, path, bf16):
    got = qm.dx_limits(path, bf16, torch.cuda.current_device())
    want = qm.dx_limits(path, bf16)
    assert (got.stage_cols, got.tile_rows, got.tile_cols,
            got.blocks_per_sm) == (want.stage_cols, want.tile_rows,
                                   want.tile_cols, want.blocks_per_sm)


def test_int8_matmul_dx_tma_path_allocates_no_scratch(cuda):
    """The TMA path's only allocation is dx: the split into hi and lo
    happens in the product's registers (the cp.async path allocates 4 M
    N bytes of scratch for them)."""
    M, K, N = 1024, 4096, 16384
    dy, w, s = _dx_inputs(cuda, M, K, N, torch.bfloat16, 5)
    assert qm.dx_plan(M, K, N) == qm.DxPlan("tma", 1, N)   # no partials
    qm.int8_matmul_dx(dy, w, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = qm.int8_matmul_dx(dy, w, s)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= \
        out.numel() * out.element_size() + (1 << 20)


def _tiny_gpt2_train():
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)

    cfg = GPT2Config(n_layer=2, n_head=4, n_embd=64, vocab_size=128,
                     n_positions=32)
    return build_gpt2_train(random_gpt2_weights(cfg, 1), cfg)


def test_tiny_trainer_on_the_gpu_matches_the_cpu(cuda):
    """Two SGD steps of a tiny GPT-2 (f32) on the card and on the CPU:
    losses within 1e-4 relative, parameters within 1e-4 of each tensor's
    largest (f32 sums in other orders); the forward's attention runs the
    plain path (no flash launch)."""
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    data = _tiny_gpt2_train()
    ids = np.random.default_rng(0).integers(0, 128, (2, 17))
    out = {}
    for dev in ("cuda", "cpu"):
        tr = LMTrainer(Model.new_from_onnx(data), optimizer="sgd", lr=0.1,
                       device=dev)
        p = tr.init_params()
        s = tr.init_opt_state(p)
        f0 = fa.flash_attention.launches
        losses = []
        for _ in range(2):
            p, s, loss = tr.train_step(p, s, ids[:, :-1], ids[:, 1:])
            losses.append(float(loss))
        assert fa.flash_attention.launches == f0
        out[dev] = (losses, {k: v.float().cpu().numpy()
                             for k, v in p.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for k, want in out["cpu"][1].items():
        err = np.abs(out["cuda"][1][k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


def test_qlora_step_runs_the_dx_kernel_once_a_backward_call(cuda):
    """A QLoRA step (int8-frozen tiny llama, bf16 compute and adapters,
    remat): int8_matmul launches once a QuantMatMul call, forward and
    re-forward; int8_matmul_dx once a backward call of Int8MatMul; no
    flash launch; the int8 base unchanged."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_train)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    cfg = LlamaConfig(hidden_size=128, intermediate_size=512,
                      num_attention_heads=4, num_key_value_heads=2,
                      num_hidden_layers=2, vocab_size=512)
    rng = np.random.default_rng(2)
    cache = {}

    def get(n):
        if n not in cache:
            if "norm" in n:
                cache[n] = np.ones(128, np.float32)
            else:
                shp = {"embed": (512, 128), "lm_head": (512, 128),
                       "k_proj": (64, 128), "v_proj": (64, 128),
                       "gate": (512, 128), "up": (512, 128),
                       "down": (128, 512)}
                key = next((k for k in shp if k in n), None)
                cache[n] = (rng.standard_normal(shp.get(key, (128, 128)))
                            * 0.05).astype(np.float32)
        return cache[n]

    tr = LMTrainer(Model.new_from_onnx(build_llama_train(get, cfg, 32)),
                   lr=5e-3, compute_dtype=DType.BF16,
                   param_dtype=DType.BF16, lora_rank=4,
                   lora_targets=("wq_", "wk_", "wv_", "wo_"),
                   quantize_base="int8", remat=True, device="cuda")
    p = tr.init_params()
    s = tr.init_opt_state(p)
    base = {n: t.clone() for n, t in tr._frozen_params().items()}
    ids = rng.integers(0, 512, (2, 17))
    n_quant = sum(n.op.KIND == "QuantMatMul" for n in tr.milli.nodes)
    i0, d0 = qm.int8_matmul.launches, qm.int8_matmul_dx.launches
    b0, f0 = qm.Int8MatMul.backward_calls, fa.flash_attention.launches
    p, s, loss = tr.train_step(p, s, ids[:, :-1], ids[:, 1:])
    torch.cuda.synchronize()
    assert np.isfinite(float(loss)) and n_quant == 7
    assert qm.int8_matmul.launches - i0 == 2 * n_quant
    assert qm.int8_matmul_dx.launches - d0 == \
        qm.Int8MatMul.backward_calls - b0 == n_quant
    assert fa.flash_attention.launches == f0
    for n, t in tr._frozen_params().items():
        assert torch.equal(t, base[n]), n


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    q = torch.randn(1, 4, 8, 64, device=cuda).bfloat16()
    cache = torch.zeros(1, 4, 16, 64, device=cuda, dtype=torch.bfloat16)
    pos = torch.tensor([3], device=cuda)
    x = torch.randn(4, 256, device=cuda).bfloat16()
    w = torch.randint(-127, 128, (256, 128), device=cuda, dtype=torch.int8)
    s = torch.rand(128, device=cuda) + 0.1

    def g(t):
        return t.clone().requires_grad_(True)

    calls = {
        "flash_attention": lambda: fa.flash_attention(g(q), q, q, 0.125,
                                                      causal=True),
        "decode_attention": lambda: decode_attention(
            g(q[:, :, :1]).contiguous(), cache, cache, pos, 0.125),
        "ragged_kv_write": lambda: ragged_kv_write(cache.clone(),
                                                   g(q[:, :, :1]), pos),
        "kv_write_pair": lambda: kv_write_pair(
            cache.clone(), g(q[:, :, :1]), cache.clone(), q[:, :, :1], pos),
        "int8_matmul": lambda: int8_matmul(g(x), w, s),
        "int8_matmul_dx": lambda: qm.int8_matmul_dx(
            g(x[:, :128]).contiguous(), w, s),
        "packed_matmul": lambda: packed_matmul(
            g(x), torch.zeros(128, 128, dtype=torch.uint8, device=cuda),
            torch.ones(8, 128, device=cuda), torch.zeros(8, 128,
                                                         device=cuda), 4),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
    xg = x.float().requires_grad_(True)
    y = qm.Int8MatMul.apply(xg, w, s)
    y.sum().backward()
    _assert_agree(xg.grad, qm.int8_matmul_dx_plain(torch.ones_like(y), w, s),
                  qm.int8_matmul_dx_plain(torch.ones_like(y), w.abs(), s))


# -- the rest of the text family (DeepSeek, T5, LLaVA) ----------------------
# tiny checkpoints in bf16 safetensors with chip_smoke.py's seeded tiled
# weights and its HF name tables

def _write_family(d, cfg, shapes_fn, out_rows):
    import chip_smoke
    import ml_dtypes

    d.mkdir()
    chip_smoke.write_hf(d, cfg, getattr(chip_smoke, shapes_fn)(cfg), 7, np,
                        np.dtype(ml_dtypes.bfloat16), out_rows)
    return str(d)


def _launches():
    return {"flash": flash_attention.launches,
            "decode": decode_attention.launches,
            "int8": int8_matmul.launches,
            "writes": ragged_kv_write.launches,
            "pairs": kv_write_pair.launches}


def _rose(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _launches().items()}


def _quant_nodes(iface):
    return sum(n.op.KIND == "QuantMatMul" for n in iface._exec.graph.nodes)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
def test_tiny_deepseek_on_the_gpu_takes_no_attention_kernel(cuda, tmp_path,
                                                            absorb):
    """MLA (absorbed: q and k 80 wide over a 64-wide latent v; naive: 48
    over 32) takes no attention kernel on the card and does not raise;
    the latent and rope-key caches are written by one single-cache launch
    each a layer a run (unpaired: their widths differ); int8_matmul
    launches once a QuantMatMul node a run. Decode logits within 3% of
    the scale of the CPU's teacher-forced prefill."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)

    cfg = dict(model_type="deepseek_v2", hidden_size=256,
               num_attention_heads=2, q_lora_rank=None, kv_lora_rank=64,
               qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
               n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
               moe_intermediate_size=128, intermediate_size=256,
               first_k_dense_replace=1, moe_layer_freq=1, vocab_size=512,
               num_hidden_layers=2)
    path = _write_family(tmp_path / "ds", cfg, "deepseek_shapes",
                         ("lm_head.weight",))
    (model,) = identify_and_load(path, dtype="bf16", max_len=64,
                                 absorb_mla=absorb).models.values()
    kw = dict(max_len=64, cache_dtype=DType.BF16, quantize="int8")
    gpu = TextInferenceInterface(model, device=cuda, **kw)
    cpu = TextInferenceInterface(model, device="cpu", **kw)
    prompt = np.random.default_rng(5).integers(3, 259, (2, 9))
    before = _launches()
    toks, logits = gpu.generate_with_logits(prompt, 6)
    rose = _rose(before)
    assert rose == {"flash": 0, "decode": 0, "int8": 6 * _quant_nodes(gpu),
                    "writes": 2 * 2 * 6, "pairs": 0}, rose
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    want = cpu.logits(full).astype(np.float32)[:, 8:]
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=0.03 * np.abs(want).max())


def test_tiny_t5_on_the_gpu_takes_no_attention_kernel(cuda, tmp_path):
    """T5's attention (a per-head relative-position bias; one query row a
    decoder step) takes no kernel on the card; the decoder's caches are
    written one pair a layer a step. The decoder's step logits within 3%
    of the scale of one teacher-forced decoder pass on the CPU."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.seq2seq import Seq2SeqInterface

    cfg = dict(model_type="t5", d_model=256, d_kv=64, d_ff=512, num_heads=4,
               num_layers=2, num_decoder_layers=2, vocab_size=512,
               relative_attention_num_buckets=8,
               relative_attention_max_distance=16,
               feed_forward_proj="gated-gelu", tie_word_embeddings=False)
    path = _write_family(tmp_path / "t5", cfg, "t5_shapes",
                         ("lm_head.weight",))
    b = identify_and_load(path, dtype="bf16", max_len=32, enc_len=16)
    spec = b.interfaces["text2text"]
    enc, dec = b.models[spec["encoder"]], b.models[spec["decoder"]]
    gpu, cpu = (Seq2SeqInterface(enc, dec, 32, cache_dtype=DType.BF16,
                                 device=dev) for dev in (cuda, "cpu"))
    ids = np.random.default_rng(6).integers(3, 259, (1, 11))
    before = _launches()
    toks = gpu.generate_tokens(ids, 6)
    assert gpu.beam_search_tokens(ids, 6, beam=3).shape == (1, 6)
    rose = _rose(before)
    assert rose == {"flash": 0, "decode": 0, "int8": 0, "writes": 2 * 12,
                    "pairs": 2 * 12}, rose
    seq = np.concatenate([[[0]], toks[:, :-1]], axis=1)
    got, want = (
        s._step(torch.from_numpy(seq).to(s.device),
                torch.zeros((), dtype=torch.int64, device=s.device),
                s.fresh_cache(1), [s.encode(ids)[n] for n in s.cross_in])
        .float().cpu().numpy() for s in (gpu, cpu))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.03 * np.abs(want).max())
    assert (got.argmax(-1) == toks).mean() > 0.8


def test_tiny_llava_on_the_gpu_goes_through_the_kernels(cuda, tmp_path):
    """A tiny LLaVA (a CLIP tower of 2 layers, 2 heads of 64, 32 x 32
    images in 8 x 8 patches; a llama text model of 2 layers, 2 heads of
    128, int8) on the card: the tower's unmasked attention and the
    inputs_embeds prefill launch flash_attention once a layer, each
    decode step decode_attention once a layer and the cache-write pair
    once a layer, int8_matmul once a QuantMatMul node a run. Prefill
    logits within 3% of the scale of the CPU's."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.multimodal import (
        MultimodalLanguageInterface)
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.super_graph.links import (Image,
                                                            MultimodalItem)
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    cfg = {"model_type": "llava", "vision_feature_layer": -2,
           "vision_config": dict(hidden_size=128, intermediate_size=256,
                                 num_attention_heads=2, num_hidden_layers=2,
                                 image_size=32, patch_size=8),
           "text_config": dict(model_type="llama", hidden_size=256,
                               intermediate_size=512, num_attention_heads=2,
                               num_key_value_heads=2, num_hidden_layers=2,
                               vocab_size=512)}
    path = _write_family(tmp_path / "llava", cfg, "llava_shapes",
                         ("language_model.lm_head.weight",))
    b = identify_and_load(path, dtype="bf16", max_len=64, quantize="int8")
    spec = b.interfaces["multimodal"]
    mms = [MultimodalLanguageInterface(
        TextInferenceInterface(b.models[spec["model"]], max_len=64,
                               cache_dtype=DType.BF16, quantize="int8",
                               device=dev), "embed_tokens",
        b.models[spec["vision"]]) for dev in (cuda, "cpu")]
    px = np.random.default_rng(8).integers(0, 255, (32, 32, 3))
    items = [MultimodalItem(text="look: "),
             MultimodalItem(image=Image(px.astype(np.uint8))),
             MultimodalItem(text=" now")]
    for mm in mms:
        mm.text.tokenizer = ByteTokenizer()
    before = _launches()
    embeds = mms[0].embed_items(items)
    assert _rose(before)["flash"] == 2           # the tower's 2 layers
    before = _launches()
    mms[0].generate_from_embeds(embeds, 5)
    rose = _rose(before)
    prefill_q = sum(n.op.KIND == "QuantMatMul"
                    for n in mms[0]._embeds_exec.graph.nodes)
    assert prefill_q > 0
    assert rose == {"flash": 2, "decode": 2 * 4,
                    "int8": prefill_q + 4 * _quant_nodes(mms[0].text),
                    "writes": 2 * 5, "pairs": 2 * 5}, rose
    L = embeds.shape[1]
    got, want = (mm.prefill_embeds(e, mm.text.fresh_cache(1))[0, :L]
                 .float().cpu().numpy()
                 for mm, e in ((mms[0], _pad(embeds, 32)),
                               (mms[1], _pad(embeds.cpu(), 32))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.03 * np.abs(want).max())


def _pad(embeds, n):
    out = torch.zeros((1, n, embeds.shape[2]), dtype=embeds.dtype,
                      device=embeds.device)
    out[:, :embeds.shape[1]] = embeds
    return out
