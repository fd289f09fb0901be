"""flash_attention of the PyTorch port on the CPU: its plain version
against the JAX package's Pallas kernel, the Attention lowering's
routing, and prompts prefilled in several pieces by the batcher.

* The Pallas flash_attention runs in interpret mode, as
  tests/test_pallas_kernels.py runs it, on bf16 inputs from numpy with
  fixed seeds: pos-bound, causal and additive modes, GQA 4/2, ragged Sq
  and Skv, head dims 64 and 128, and rows with no visible key on purpose
  (causal with Sq > Skv, a mask row of -inf). Tolerance, per element:
  flash_agreement_bound (backends/cuda/flash_attention.py), one bf16 ulp
  of the output plus 2^-7 + 2^-16 of the attention over |v|: both round
  the unnormalized probabilities to bf16, against different maxima.
* The tiny GPT-2 of tests/test_torch_port_batching.py prefills prompts
  in 16-token pieces through both packages' ContinuousBatchers at an f32
  cache: the same tokens (tolerance zero).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import ml_dtypes  # noqa: E402

from whisper_tensor_tpu.backends.pallas.attention import (  # noqa: E402
    flash_attention as pallas_flash_attention)
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu_torch.backends.cuda import (  # noqa: E402
    flash_attention as fa)
from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (  # noqa: E402
    merge_partial_softmax)
from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (  # noqa: E402
    flash_agreement_bound, flash_attention, flash_attention_plain)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import (  # noqa: E402
    attention as attention_lowering)
from whisper_tensor_tpu_torch.milli.ops.attention import (  # noqa: E402
    AttentionMilli)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)

from tests.test_torch_port_batching import V, _onnx  # noqa: E402

CPU = torch.device("cpu")

# (mode, B, Hq, Hkv, Sq, Skv, D)
CASES = [("pos", 2, 4, 2, 256, 384, 64),
         ("pos", 1, 4, 2, 200, 333, 128),      # ragged Sq and Skv
         ("pos", 3, 2, 2, 64, 160, 64),
         ("causal", 1, 4, 2, 200, 333, 64),
         ("causal", 2, 2, 1, 200, 120, 128),   # rows 0..79 see no key
         ("mask", 2, 4, 2, 130, 200, 64),      # a mask per batch row
         ("mask1", 1, 4, 2, 128, 256, 128)]    # one mask for the batch


def _inputs(mode, B, Hq, Hkv, Sq, Skv, D):
    """bf16 q, k, v (numpy, ml_dtypes) and the mode's extras."""
    rng = np.random.default_rng(B * 1000 + Sq + Skv + D)

    def bf16(*shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    q, k, v = bf16(B, Hq, Sq, D), bf16(B, Hkv, Skv, D), bf16(B, Hkv, Skv, D)
    extra = {}
    if mode == "pos":
        extra["pos_bound"] = rng.integers(0, Skv, (B,)).astype(np.int32)
        extra["pos_bound"][0] = 0                # row 0: a plain prompt
    elif mode == "causal":
        extra["causal"] = True
    else:
        mask = (rng.standard_normal((B if mode == "mask" else 1, 1, Sq, Skv))
                * 2.0).astype(np.float32)
        mask[rng.random(mask.shape) < 0.3] = -np.inf
        mask[0, 0, 3] = -np.inf                  # a row with no visible key
        extra["mask"] = mask
    return q, k, v, extra


def _torch(a):
    a = np.asarray(a)
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a)


@pytest.mark.parametrize("mode,B,Hq,Hkv,Sq,Skv,D", CASES)
def test_plain_version_matches_the_pallas_kernel(mode, B, Hq, Hkv, Sq, Skv,
                                                 D):
    q, k, v, extra = _inputs(mode, B, Hq, Hkv, Sq, Skv, D)
    scale = D ** -0.5
    want = np.asarray(pallas_flash_attention(
        q, k, v, scale, extra.get("causal", False), mask=extra.get("mask"),
        pos_bound=extra.get("pos_bound"), interpret=True)).astype(np.float32)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    kw = {n: (_torch(a) if isinstance(a, np.ndarray) else a)
          for n, a in extra.items()}
    got = flash_attention_plain(tq, tk, tv, scale, **kw)
    assert got.shape == (B, Hq, Sq, D) and got.dtype == torch.bfloat16
    magnitude = flash_attention_plain(tq, tk, tv.abs(), scale, **kw)
    err = (got.float() - torch.from_numpy(want)).abs()
    bound = flash_agreement_bound(got, magnitude)
    assert bool((err <= bound).all()), \
        f"worst err/bound {(err / bound.clamp_min(1e-30)).max().item()}"
    if mode == "causal" and Sq > Skv:
        assert not got[:, :, :Sq - Skv].float().any()   # no visible key: 0
    if mode.startswith("mask"):
        assert not got[0, :, 3].float().any()
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(flash_attention(tq, tk, tv, scale, **kw), got,
                               rtol=0, atol=0)


def _attention_call(Sq, qdt, cdt, spy_flash, spy_decode, monkeypatch):
    """Run the Attention lowering on a (2, 4, Sq, 64) query over a
    (2, 2, 48, 64) cache with a per-row position mask, the two kernels'
    wrappers replaced by spies that call the real ones."""
    calls = {"flash": 0, "decode": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(attention_lowering, "flash_attention",
                        counted("flash", spy_flash))
    monkeypatch.setattr(attention_lowering, "decode_attention",
                        counted("decode", spy_decode))
    g = torch.Generator().manual_seed(Sq)
    q = torch.randn(2, 4, Sq, 64, generator=g).to(qdt)
    k, v = (torch.randn(2, 2, 48, 64, generator=g).to(cdt) for _ in range(2))
    pos = torch.tensor([3, 20])
    (y,) = LOWERINGS["Attention"](AttentionMilli(scale=0.125),
                                  [q, k, v, pos], [None] * 4, CPU)
    return calls, y, (q, k, v, pos)


@pytest.mark.parametrize("Sq,qdt,cdt,route", [
    (16, torch.bfloat16, torch.bfloat16, "flash"),   # a bf16 prefill
    (16, torch.float32, torch.float32, "dense"),     # an f32 cache
    (16, torch.float32, torch.bfloat16, "dense"),    # f32 q, bf16 cache
    (1, torch.bfloat16, torch.bfloat16, "decode")])  # a decode step
def test_attention_lowering_routes_prefill_to_flash(Sq, qdt, cdt, route,
                                                    monkeypatch):
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)

    calls, y, (q, k, v, pos) = _attention_call(
        Sq, qdt, cdt, flash_attention, decode_attention, monkeypatch)
    assert calls == {"flash": int(route == "flash"),
                     "decode": int(route == "decode")}
    if route == "flash":
        torch.testing.assert_close(
            y, flash_attention_plain(q, k, v, 0.125, pos_bound=pos),
            rtol=0, atol=0)


def test_prefill_reads_the_query_view_without_a_copy(monkeypatch):
    """The recipes' q reaches Attention as a Transpose view; the lowering
    hands that view to the wrapper as it is (the kernel reads strides)."""
    seen = []

    def spy(q, k, v, scale, **kw):
        seen.append(q)
        return flash_attention(q, k, v, scale, **kw)

    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 16, 4, 64, generator=g).bfloat16().transpose(1, 2)
    k, v = (torch.randn(2, 2, 48, 64, generator=g).bfloat16()
            for _ in range(2))
    monkeypatch.setattr(attention_lowering, "flash_attention", spy)
    LOWERINGS["Attention"](AttentionMilli(scale=0.125),
                           [q, k, v, torch.tensor(5)], [None] * 4, CPU)
    assert len(seen) == 1 and seen[0].data_ptr() == q.data_ptr() \
        and not seen[0].is_contiguous()


def _gpt2_batchers():
    """The JAX package's and the port's batcher on one ragged GPT-2 graph
    (max_len 128), each with its own Model of the same ONNX bytes."""
    data = _onnx(128)[1]
    # a slot per request: a slot that frees and takes a chunked admission
    # meets the JAX batcher's fault with its previous tenant's park
    # (ROADMAP C), which the port repairs
    common = dict(max_len=128, max_batch=3, chunk=4,
                  prompt_buckets=(16, 32, 64), prefill_chunk=16)
    return (JaxBatcher(JaxModel.new_from_onnx(data),
                       cache_dtype=JaxDType.F32, **common),
            ContinuousBatcher(Model.new_from_onnx(data), cache_dtype=DType.F32,
                              device="cpu", **common))


def test_prompts_in_prefill_pieces_match_the_jax_batcher():
    """Prompts of 35 to 64 tokens prefill in 16-token pieces (3 or 4
    each) through both batchers at an f32 cache: the same tokens."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, V, (n,)).astype(np.int64)
               for n in (35, 64, 47)]
    outs = []
    for b in _gpt2_batchers():
        b.start()
        try:
            outs.append([f.result(timeout=300)
                         for f in [b.submit(p, 6) for p in prompts]])
        finally:
            b.stop()
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_bf16_pieces_go_through_flash(monkeypatch):
    """At a bf16 cache every prefill piece of every layer calls the
    flash_attention wrapper: 2 layers x 3 pieces for a 40-token prompt
    under prefill_chunk 16, then decode steps, which do not."""
    from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step, random_gpt2_weights)

    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=128, vocab_size=V,
                     n_positions=128)
    data = build_gpt2_step(random_gpt2_weights(cfg), cfg, max_len=128,
                           dtype=JaxDType.BF16, pos_per_row=True)
    calls = []

    def spy(q, k, v, scale, **kw):
        calls.append(q.shape[2])
        return flash_attention(q, k, v, scale, **kw)

    monkeypatch.setattr(attention_lowering, "flash_attention", spy)
    b = ContinuousBatcher(Model.new_from_onnx(data), max_len=128,
                          max_batch=2, chunk=4, prompt_buckets=(16, 32),
                          prefill_chunk=16, device="cpu").start()
    try:
        prompt = np.random.default_rng(3).integers(0, V, (40,))
        out = b.submit(prompt, 5).result(timeout=300)
    finally:
        b.stop()
    assert out.shape == (5,)
    assert calls == [16] * 6


# (B, Hq, Hkv, Sq, Skv, D): the smoke's direct prefill (i), an admission
# group (ii), a 128-row piece (iii), a long prompt (iv), GPT-2's width,
# a GQA group of 8 (16 positions a block), one row, ragged Skv
FLASH_PLAN_SHAPES = [(1, 32, 8, 2048, 2048, 128), (4, 32, 8, 512, 2048, 128),
                     (1, 32, 8, 128, 2048, 128), (1, 32, 8, 8192, 8192, 128),
                     (1, 12, 12, 1024, 1024, 64), (1, 12, 12, 16, 256, 64),
                     (2, 16, 2, 130, 200, 128), (1, 4, 4, 1, 1, 64),
                     (1, 32, 8, 128, 100, 128)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", FLASH_PLAN_SHAPES)
def test_flash_splits_cover_every_key_once_in_whole_tiles(B, Hq, Hkv, Sq,
                                                          Skv, D):
    """Split c takes keys [c * chunk, (c + 1) * chunk), a whole number of
    64-key tiles: every key lies in exactly one split, none is empty of
    keys, and the grid with its splits stays within one wave of the card
    unless it already fills one unsplit (CPU defaults: the H100's)."""
    splits, chunk = fa.flash_splits(B, Hq, Hkv, Sq, Skv, D)
    assert chunk % fa.KEY_TILE == 0
    assert (splits - 1) * chunk < Skv <= splits * chunk
    heads, tq, per_sm, sms = fa.flash_limits(Hq, Hkv, D)
    assert heads == fa.heads_per_block(Hq, Hkv) and heads * tq == 128
    assert (per_sm, sms) == (fa.BLOCKS_PER_SM[D], fa.CARD_SMS)
    blocks = B * (Hq // heads) * -(-Sq // tq)
    wave = per_sm * sms
    if blocks >= wave:
        assert splits == 1
    else:
        assert splits <= min(fa.MAX_SPLITS, -(-Skv // fa.KEY_TILE))
        assert blocks * (splits - 1) < wave


def test_flash_splits_count_by_waves():
    """(i), (ii) and (iv) fill the card unsplit; the 128-row piece at
    B = 1 (32 blocks of 4 heads x 32 positions) takes enough splits to
    fill one wave, and GPT-2's 1,024-token prompt (96 blocks) a few."""
    assert fa.flash_splits(1, 32, 8, 2048, 2048, 128) == (1, 2048)
    assert fa.flash_splits(4, 32, 8, 512, 2048, 128) == (1, 2048)
    assert fa.flash_splits(1, 32, 8, 8192, 8192, 128) == (1, 8192)
    splits, chunk = fa.flash_splits(1, 32, 8, 128, 2048, 128)
    assert 32 * splits >= fa.BLOCKS_PER_SM[128] * fa.CARD_SMS
    assert chunk == -(-2048 // 64 // splits) * 64
    assert fa.flash_splits(1, 12, 12, 1024, 1024, 64)[0] > 1


def _flash_split_states(q, k, v, scale, pos, splits, chunk):
    """Each key split's partial softmax state in plain f32 torch, with
    the pos-bound visibility: m, l (B, Hq, Sq, S) and acc (B, Hq, Sq, S,
    D) over the visible keys of its range; a range with no visible key of
    a row is (-inf, 0, 0) for that row."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    j = torch.arange(Skv)
    vis = j <= pos.view(B, 1, 1, 1) + torch.arange(Sq).view(1, 1, Sq, 1)
    ms, ls, accs = [], [], []
    for c in range(splits):
        part = vis & (j >= c * chunk) & (j < (c + 1) * chunk)
        sc = s.masked_fill(~part, -torch.inf)
        m = sc.amax(-1)
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p, vf))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [(1, 4, 2, 40, 300, 64),
                                               (2, 4, 4, 70, 200, 128)])
def test_flash_split_states_merge_to_the_plain_attention(B, Hq, Hkv, Sq, Skv,
                                                         D):
    """The kernel's split-and-merge computation in plain torch, with the
    wrapper's plan for these shapes (the keys split over blocks):
    merge_partial_softmax of the splits' states equals
    flash_attention_plain over f32 inputs (no bf16 rounding of p) to
    1e-5; rows whose keys all lie in later splits, or with none visible,
    included."""
    splits, chunk = fa.flash_splits(B, Hq, Hkv, Sq, Skv, D)
    assert splits > 1
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    pos = torch.tensor([-5, 150][:B])
    m, l, acc = _flash_split_states(q, k, v, D ** -0.5, pos, splits, chunk)
    want = flash_attention_plain(q, k, v, D ** -0.5, pos_bound=pos)
    torch.testing.assert_close(merge_partial_softmax(m, l, acc), want,
                               atol=1e-5, rtol=1e-5)
