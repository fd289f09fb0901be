"""The PyTorch port's packed weights against the JAX package, on the CPU.

(a) Copies: the port's PackedFormat, dequantize_blocks, quantize_blocks,
    repack_packed_tensor and dequant_repacked equal the reference's byte
    for byte, for all 12 formats, on random block bytes with finite
    scales (the reference held to its numpy path: its native C++
    dequantizer is not what the port copies).
(b) packed_matmul_plain against the JAX packed_matmul (its jnp path on
    the CPU, as tests/test_packed_matmul.py runs it) and against x @
    dequant_repacked: bits 4 and 8, with and without offsets, G 16, 32,
    128 and 256, M 1, 5 and 600, N a multiple of 128 and odd, x in f32
    and bf16. Tolerance: in f32 the reference's own (rtol 2e-5 of the
    scale, tests/test_packed_matmul.py:84-86); in bf16 agreement_bound
    (one bf16 ulp + f32 summation-order noise, element by element).
(c) Routing: every PackedMatMul node lowers to the port's packed_matmul,
    which takes its plain version on CPU tensors; a model with packed
    sources builds the reference's PackedMatMul nodes, in the same order.
(d) Host quantization (q4_0, q8_0, q5_0, q4_k, q6_k) of a tiny llama
    (2 layers, hidden 256, so K-quant blocks fit) and a tiny GPT-2, built
    from the same ONNX bytes in both packages: logits within 1e-5 at f32,
    8 greedy tokens equal, the same weights left dense.
(e) GGUF: tiny arch-qwen2 files (attention biases, NeoX rope) in Q4_0,
    Q8_0, Q4_K and Q6_K, written by the port's write_gguf (the reference
    writer's bytes), loaded packed and host-dequantized, token-exact
    against the JAX GgufLoader; an arch-llama file written the llama.cpp
    way (Q/K rows permuted as convert_hf_to_gguf.py permutes them) loads
    to the port's transformers q4_0 load of the HF weights, logits bit
    for bit, and to the JAX package's tokens (ROADMAP C5: the reference's
    GGUF loader feeds those rows unpermuted and gets other logits); a
    mixed-format file leaves the fused q/k/v dense, as the reference does.
(f) A GGUF and a q4_0 model through the port's ContinuousBatcher,
    token-exact against the port's direct path and the JAX batcher, and
    one /v1/completions over a GGUF model.
"""

import http.client
import json
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from whisper_tensor_tpu import packed_format as jax_pf  # noqa: E402
from whisper_tensor_tpu.backends.cpu import dequant as jax_dequant  # noqa: E402
from whisper_tensor_tpu.backends.pallas import (  # noqa: E402
    packed_matmul as jax_pm)
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers import gguf as jax_gguf  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gguf_llama as jax_gguf_llama, gpt2 as jax_gpt2, llama as jax_llama)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxText)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.server.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from whisper_tensor_tpu.tensor import PackedTensor as JaxPacked  # noqa: E402
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch import packed_format as pf  # noqa: E402
from whisper_tensor_tpu_torch.backends.cpu import dequant  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda import (  # noqa: E402
    agreement_bound, packed_matmul as pm)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers import gguf  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    gguf_llama)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.milli import transforms  # noqa: E402
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.server.batching import (  # noqa: E402
    ContinuousBatcher)
from whisper_tensor_tpu_torch.tensor import PackedTensor  # noqa: E402

F = pf.PackedFormat
HOST_FORMATS = ["q4_0", "q8_0", "q5_0", "q4_k", "q6_k"]
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _numpy_dequant(monkeypatch):
    """The reference's dequantize_blocks on its numpy path."""
    monkeypatch.setattr(jax_native, "native_dequantize",
                        lambda data, fmt, n: None)


# -- (a) the copies ------------------------------------------------------------

# byte offsets of each format's f16 scale fields (Q8_K: an f32 at 0)
SCALE_AT = {F.Q4_0: (0,), F.Q4_1: (0, 2), F.Q5_0: (0,), F.Q5_1: (0, 2),
            F.Q8_0: (0,), F.Q8_1: (0, 2), F.Q2_K: (80, 82), F.Q3_K: (108,),
            F.Q4_K: (0, 2), F.Q5_K: (0, 2), F.Q6_K: (208,)}


def _random_blocks(fmt, n_blocks, seed):
    """Random block bytes whose scale fields are finite (a random f16 is
    inf or nan about 6% of the time); everything else stays random."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n_blocks, fmt.block_bytes), dtype=np.uint8)
    if fmt is F.Q8_K:
        raw[:, 0:4] = rng.uniform(0.01, 0.1, (n_blocks, 1)).astype(
            np.float32).view(np.uint8)
    for off in SCALE_AT.get(fmt, ()):
        raw[:, off:off + 2] = rng.uniform(0.01, 0.1, (n_blocks, 1)).astype(
            np.float16).view(np.uint8)
    return raw.tobytes()


def test_formats_match_the_reference():
    assert [f.name for f in F] == [f.name for f in jax_pf.PackedFormat]
    for f in F:
        jf = jax_pf.PackedFormat[f.name]
        assert (f.value, f.block_size, f.block_bytes, f.bits_per_weight) == (
            jf.value, jf.block_size, jf.block_bytes, jf.bits_per_weight)
    assert {k: v.name for k, v in pf.GGML_TYPE_TO_PACKED.items()} == {
        k: v.name for k, v in jax_pf.GGML_TYPE_TO_PACKED.items()}


@pytest.fixture(params=["whole", "pieces"])
def pieces(request, monkeypatch):
    """Large tensors go through the host in pieces of whole blocks on
    threads: "pieces" cuts these small ones into pieces of 3 blocks (and
    of one row for the repack)."""
    if request.param == "pieces":
        monkeypatch.setattr(dequant, "PIECE_BLOCKS", 3)
        monkeypatch.setattr(pm, "PIECE_BLOCKS", 3)
    return request.param


@pytest.mark.parametrize("fmt", list(F), ids=lambda f: f.value)
def test_dequantize_and_repack_match_the_reference(fmt, pieces):
    N, K = 8, 512
    data = _random_blocks(fmt, N * K // fmt.block_size, seed=K + len(fmt.value))
    jfmt = jax_pf.PackedFormat[fmt.name]
    got = dequant.dequantize_blocks(data, fmt, N * K)
    want = jax_dequant.dequantize_blocks(data, jfmt, N * K)
    assert np.isfinite(want).all()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for dt in ("F32", "BF16"):
        a = PackedTensor(data, fmt, (N, K)).dequantize(DType[dt]).numpy()
        b = JaxPacked(data, jfmt, (N, K)).dequantize(JaxDType[dt]).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rp = pm.repack_packed_tensor(PackedTensor(data, fmt, (N, K)))
    jrp = jax_pm.repack_packed_tensor(JaxPacked(data, jfmt, (N, K)))
    assert set(rp) == set(jrp)
    for k in rp:
        assert rp[k].dtype == jrp[k].dtype and rp[k].shape == jrp[k].shape
        assert np.asarray(rp[k]).tobytes() == np.asarray(jrp[k]).tobytes(), k
    w = pm.dequant_repacked(rp)
    assert w.tobytes() == jax_pm.dequant_repacked(jrp).tobytes()
    # the repack is exact: the device layout dequantizes to the blocks'
    # values (a zero may change its sign: Q3_K's d * sc * 0 is -0 where
    # sc < 0, the repack's u * ds - 4 * ds is +0)
    np.testing.assert_array_equal(w, got.reshape(N, K).T)


@pytest.mark.parametrize("fmt", [F.Q4_0, F.Q8_0, F.Q5_0, F.Q4_K, F.Q6_K],
                         ids=lambda f: f.value)
def test_quantize_blocks_writes_the_reference_bytes(fmt, pieces):
    x = (np.random.default_rng(3).standard_normal(4096) * 0.1).astype(
        np.float32)
    got = dequant.quantize_blocks(x, fmt)
    assert got == jax_dequant.quantize_blocks(
        x, jax_pf.PackedFormat[fmt.name])
    assert len(got) == fmt.storage_bytes(x.size)


def test_quantize_blocks_refuses_formats_without_a_writer():
    with pytest.raises(ValueError, match="unsupported"):
        dequant.quantize_blocks(np.zeros(256, np.float32), F.Q2_K)
    with pytest.raises(ValueError, match="whole"):
        dequant.quantize_blocks(np.zeros(100, np.float32), F.Q4_0)


# -- (b) the plain version ------------------------------------------------------

def _layout(bits, G, K, N, has_off, seed):
    rng = np.random.default_rng(seed)
    q = (rng.integers(0, 256, (K // 2, N), dtype=np.uint8) if bits == 4
         else rng.integers(-128, 128, (K, N), dtype=np.int8))
    s = rng.uniform(0.001, 0.05, (K // G, N)).astype(np.float32)
    o = (rng.uniform(-0.2, 0.2, (K // G, N)).astype(np.float32) if has_off
         else np.zeros_like(s))
    return q, s, o


LAYOUTS = [(4, 32, True), (4, 16, True), (4, 128, True), (4, 256, True),
           (8, 16, True), (8, 256, True), (8, 32, False)]


@pytest.mark.parametrize("bits,G,has_off", LAYOUTS)
@pytest.mark.parametrize("M", [1, 5, 600])
@pytest.mark.parametrize("N", [128, 77])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_packed_matmul_plain_matches_the_jax_function(bits, G, has_off, M,
                                                       N, dt):
    K = 512
    q, s, o = _layout(bits, G, K, N, has_off, seed=M * N + G)
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    if dt == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(jax_pm.packed_matmul(x, q, s, o, bits, has_off))
    xt = torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16 if dt == "bf16" else torch.float32)
    args = [torch.from_numpy(a) for a in (q, s, o)]
    got = pm.packed_matmul_plain(xt, *args, bits, has_off)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    w = pm.dequant_repacked({"q": q, "scales": s, "offsets": o,
                             "bits": np.int8(bits)})
    dense = x.astype(np.float32) @ w
    if dt == "f32":
        for ref in (want, dense):
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                       rtol=2e-5, atol=2e-5)
    else:
        mag = torch.from_numpy(np.abs(x.astype(np.float32)) @ np.abs(w))
        for ref in (torch.from_numpy(want.astype(np.float32)).bfloat16(),
                    torch.from_numpy(dense).bfloat16()):
            err = (got.float() - ref.float()).abs()
            assert bool((err <= agreement_bound(ref, mag)).all())


# -- the kernel's launch plan (packed_plan) ----------------------------------------

# (K, N): Llama-3-8B's fused q/k/v, o, gate/up, down and lm_head, GPT-2's
# lm_head (ragged N), a small odd case
PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
               (4096, 128256), (768, 50257), (512, 77)]
PLAN_LAYOUTS = [(4, 32), (4, 16), (4, 128), (4, 256), (8, 16), (8, 32),
                (8, 256)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
@pytest.mark.parametrize("bits,G", PLAN_LAYOUTS)
@pytest.mark.parametrize("M", [1, 7, 16, 17, 512, 2048])
def test_packed_plan_splits_on_stages_and_groups(K, N, bits, G, M):
    """The splits cover the rows of q once, each a whole number of
    stages and of groups; at bits 4 a split is a run of q rows, so the
    low nibble (W row r) and the high nibble (row r + K/2) of a byte
    fall in the same split."""
    plan = pm.packed_plan(M, K, N, G, bits)
    kq = K // 2 if bits == 4 else K
    assert plan.kchunk % pm.STAGE_Q_ROWS[plan.path, bits] == 0
    assert plan.kchunk % G == 0
    assert (plan.splits - 1) * plan.kchunk < kq <= plan.splits * plan.kchunk
    split_of = np.minimum(np.arange(K) % kq // plan.kchunk, plan.splits - 1)
    owner = np.zeros((plan.splits, K), bool)
    owner[split_of, np.arange(K)] = True
    assert (owner.sum(0) == 1).all()                 # each W row once
    if bits == 4:
        r = np.arange(K // 2)
        assert (split_of[r] == split_of[r + K // 2]).all()
    for c in range(plan.splits):                     # no split cuts a group
        lo = c * plan.kchunk
        assert lo % G == 0


@pytest.mark.parametrize("M", [1, 2, 5, 8, 15, 16, 17, 64, 512, 513, 2048,
                               100000])
def test_packed_plan_path_follows_the_rows_without_a_cap(M):
    """bf16 x: the CUDA cores up to 8 rows, the tensor cores from 9 on,
    at any M; f32 x: the CUDA cores at every M (16 rows a block)."""
    bf16 = pm.packed_plan(M, 4096, 4096, 32, 4)
    assert bf16.path == ("tensor" if M >= pm.TENSOR_MIN_ROWS else "cores")
    assert pm.TENSOR_MIN_ROWS == 9
    f32 = pm.packed_plan(M, 4096, 4096, 32, 4, x_bf16=False)
    assert f32.path == "cores" and f32.bm == min(16, 1 << (M - 1).bit_length())


def test_packed_plan_fills_the_card_at_decode():
    """M = 1: the down projection (32 column tiles) is split to fill the
    H100's 132 multiprocessors twice over; lm_head (1,002 tiles) already
    does and is not split. M = 16 on the tensor cores (16-row tiles):
    the split grid fills one wave of blocks rather than spill a few
    blocks into a second."""
    down = pm.packed_plan(1, 14336, 4096, 32, 4)
    assert down.splits > 1 and 32 * down.splits >= 2 * pm.card_sms()
    assert pm.packed_plan(1, 4096, 128256, 32, 4).splits == 1
    tdown = pm.packed_plan(16, 14336, 4096, 32, 4)
    wave = pm.BLOCKS_PER_SM["tensor", tdown.bm] * pm.card_sms()
    assert tdown.path == "tensor" and tdown.bm == 16
    assert wave - 32 < 32 * tdown.splits <= wave


# -- tiny models -----------------------------------------------------------------

# V covers the byte tokenizer's ids (the HTTP test sends text)
E, I, V, HD = 256, 256, 320, 128
LLAMA = dict(num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
             hidden_size=E, intermediate_size=I, vocab_size=V, head_dim=HD,
             rope_theta=10000.0, rms_norm_eps=1e-5)
HF_SHAPES = {"embed_tokens": (V, E), "lm_head": (V, E), "q_proj": (2 * HD, E),
             "k_proj": (HD, E), "v_proj": (HD, E), "o_proj": (E, 2 * HD),
             "gate_proj": (I, E), "up_proj": (I, E), "down_proj": (E, I)}


def _hf_weight(name):
    """HF-named tiny-llama weights (out, in), seeded by name."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if "norm" in name:
        return (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    if name.endswith(".bias"):
        n = 2 * HD if "q_proj" in name else HD
        return (0.1 * rng.standard_normal(n)).astype(np.float32)
    shape = next(s for k, s in HF_SHAPES.items() if k in name)
    return (0.08 * rng.standard_normal(shape)).astype(np.float32)


def _llama_onnx(per_row=False, dt="F32"):
    return jax_llama.build_llama_step(
        _hf_weight, jax_llama.LlamaConfig(**LLAMA), max_len=MAX_LEN,
        dtype=JaxDType[dt], pos_per_row=per_row)


def _gpt2_onnx():
    cfg = jax_gpt2.GPT2Config(n_layer=2, n_head=2, n_embd=E, vocab_size=V,
                              n_positions=MAX_LEN)
    return jax_gpt2.build_gpt2_step(jax_gpt2.random_gpt2_weights(cfg, seed=4),
                                    cfg, max_len=MAX_LEN, dtype=JaxDType.F32)


def _pair(port_model, jax_model, **kw):
    """(port, reference) interfaces at an f32 cache, bucket 16."""
    port = TextInferenceInterface(port_model, max_len=MAX_LEN,
                                  prompt_buckets=(16,), device="cpu",
                                  cache_dtype=DType.F32, **kw)
    ref = JaxText(jax_model, max_len=MAX_LEN, prompt_buckets=(16,),
                  cache_dtype=JaxDType.F32, weight_dtype=JaxDType.F32, **kw)
    return port, ref


PROMPT = np.random.default_rng(7).integers(0, V, (2, 7)).astype(np.int64)


def _assert_same_run(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.logits(PROMPT),
                               np.asarray(ref.logits(PROMPT)),
                               rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(port.generate_tokens(PROMPT, 8),
                                  ref.generate_tokens(PROMPT, 8))


def _kinds(iface):
    return [n.op.KIND for n in iface.milli.nodes]


# -- (c) routing ---------------------------------------------------------------------

def test_every_packed_matmul_node_lowers_to_the_wrapper(monkeypatch):
    data = _llama_onnx()
    port = TextInferenceInterface(Model.new_from_onnx(data), max_len=MAX_LEN,
                                  prompt_buckets=(16,), device="cpu",
                                  quantize="q4_0")
    calls = {"wrapper": 0, "plain": 0}
    wrapper, plain = transforms.packed_matmul, pm.packed_matmul_plain

    def spy_wrapper(*a, **kw):
        calls["wrapper"] += 1
        return wrapper(*a, **kw)

    def spy_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(transforms, "packed_matmul", spy_wrapper)
    monkeypatch.setattr(pm, "packed_matmul_plain", spy_plain)
    n0 = pm.packed_matmul.launches
    port.logits(PROMPT)
    n_nodes = _kinds(port).count("PackedMatMul")
    # fused q/k/v and gate/up, o and down per layer, and the lm_head
    assert n_nodes == 9
    assert calls == {"wrapper": n_nodes, "plain": n_nodes}
    assert pm.packed_matmul.launches == n0


@pytest.mark.parametrize("quantize", ["q4_0", "q4_k"])
def test_packed_nodes_are_the_references(quantize):
    """The same ONNX bytes, fused and packed in each package: the same
    node kinds in the same order, the same packed weights, bit for bit,
    and the same weight inputs, scales and offsets in f32."""
    data = _llama_onnx()
    port, ref = _pair(Model.new_from_onnx(data), JaxModel.new_from_onnx(data),
                      quantize=quantize)
    assert _kinds(port) == _kinds(ref)
    assert list(port._packed) == list(ref._packed)
    for n, rp in port._packed.items():
        for k in ("q", "scales", "offsets"):
            assert rp[k].tobytes() == np.asarray(ref._packed[n][k]).tobytes()
    assert port.weight_names == ref.weight_names
    host = port.host_weights()
    assert all(host[n].dtype == np.float32 for n in host
               if n.endswith(("::pscales", "::poffsets")))
    # the reference interface's own arrays, under its names (its
    # `_weights`, :604-617), load into the port and give its logits
    want = port.logits(PROMPT)
    ref_arrays = {}
    for n in ref.weight_names:
        if n.endswith("::pscales"):
            ref_arrays[n] = ref._packed[n[:-9]]["scales"]
        elif n.endswith("::poffsets"):
            ref_arrays[n] = ref._packed[n[:-10]]["offsets"]
        elif n in ref._packed:
            ref_arrays[n] = ref._packed[n]["q"]
        else:
            ref_arrays[n] = np.asarray(ref._dense_np(n))
    port.load_weights(ref_arrays)
    np.testing.assert_array_equal(port.logits(PROMPT), want)


# -- (d) host quantization ---------------------------------------------------------

@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("quantize", HOST_FORMATS)
def test_host_quantized_models_match_the_jax_package(family, quantize):
    data = _llama_onnx() if family == "llama" else _gpt2_onnx()
    port, ref = _pair(Model.new_from_onnx(data), JaxModel.new_from_onnx(data),
                      quantize=quantize)
    assert port._packed and set(port._packed) == set(ref._packed)
    # the weights left dense (the embeddings, norms and biases) are the
    # same in both
    dense = [n for n in port.weight_names if n not in port._packed
             and not n.endswith(("::pscales", "::poffsets"))]
    assert dense == [n for n in ref.weight_names if n not in ref._packed
                     and not n.endswith(("::pscales", "::poffsets"))]
    _assert_same_run(port, ref)


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TextInferenceInterface(Model.new_from_onnx(_llama_onnx()),
                               max_len=MAX_LEN, device="cpu",
                               quantize="q3_k")


# -- (e) GGUF -------------------------------------------------------------------------

GGUF_NAMES = {"input_layernorm.weight": "attn_norm.weight",
              "post_attention_layernorm.weight": "ffn_norm.weight",
              "self_attn.q_proj.weight": "attn_q.weight",
              "self_attn.k_proj.weight": "attn_k.weight",
              "self_attn.v_proj.weight": "attn_v.weight",
              "self_attn.q_proj.bias": "attn_q.bias",
              "self_attn.k_proj.bias": "attn_k.bias",
              "self_attn.v_proj.bias": "attn_v.bias",
              "self_attn.o_proj.weight": "attn_output.weight",
              "mlp.gate_proj.weight": "ffn_gate.weight",
              "mlp.up_proj.weight": "ffn_up.weight",
              "mlp.down_proj.weight": "ffn_down.weight"}


def _llama_cpp_permute(w, n_head):
    """convert_hf_to_gguf.py's LlamaModel.permute of Q/K rows."""
    return np.ascontiguousarray(
        w.reshape(n_head, 2, w.shape[0] // n_head // 2, *w.shape[1:])
        .swapaxes(1, 2).reshape(w.shape))


def _gguf_tensors(arch, fmt_of, permute=False):
    """GGUF tensors of the tiny llama's HF weights: norms and the token
    table in f32, every matmul weight quantized by rows in fmt_of(name);
    Q/K rows permuted the llama.cpp way when `permute`."""
    def q(name, w):
        fmt = fmt_of(name)
        return PackedTensor(dequant.quantize_blocks(w, fmt), fmt, w.shape)

    t = {"token_embd.weight": _hf_weight("model.embed_tokens.weight"),
         "output_norm.weight": _hf_weight("model.norm.weight"),
         "output.weight": q("output", _hf_weight("lm_head.weight"))}
    for i in range(LLAMA["num_hidden_layers"]):
        for hf, gg in GGUF_NAMES.items():
            if hf.endswith(".bias") and arch != "qwen2":
                continue
            w = _hf_weight(f"model.layers.{i}.{hf}")
            if permute and hf in ("self_attn.q_proj.weight",
                                  "self_attn.k_proj.weight"):
                w = _llama_cpp_permute(w, 2 if "q_proj" in hf else 1)
            t[f"blk.{i}.{gg}"] = q(gg, w) if w.ndim == 2 else w
    return t


def _gguf_meta(arch):
    p = arch + "."
    return {"general.architecture": arch, "general.name": f"tiny-{arch}",
            p + "block_count": LLAMA["num_hidden_layers"],
            p + "embedding_length": E, p + "attention.head_count": 2,
            p + "attention.head_count_kv": 1, p + "attention.key_length": HD,
            p + "feed_forward_length": I, p + "context_length": MAX_LEN,
            p + "vocab_size": V, p + "attention.layer_norm_rms_epsilon": 1e-5,
            p + "rope.freq_base": 10000.0}


def _write_gguf(path, arch, fmt_of, permute=False):
    """Written by the port's writer; the reference's writer gives the
    same bytes."""
    tensors = _gguf_tensors(arch, fmt_of, permute)
    gguf.write_gguf(str(path), _gguf_meta(arch), tensors)
    jax_gguf.write_gguf(str(path) + ".ref", _gguf_meta(arch), {
        k: (JaxPacked(v.data, jax_pf.PackedFormat[v.fmt.name], v.shape)
            if isinstance(v, PackedTensor) else v)
        for k, v in tensors.items()})
    assert path.read_bytes() == (path.parent / (path.name + ".ref")).read_bytes()
    return str(path)


def _load(pkg, path, **cfg):
    reg = loader_registry() if pkg == "port" else jax_loaders()
    (_, model), = reg["gguf"].load({"path": path, "max_len": MAX_LEN,
                                    "dtype": "f32", **cfg}).models.items()
    return model


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("fmt", [F.Q4_0, F.Q8_0, F.Q4_K, F.Q6_K],
                         ids=lambda f: f.value)
def test_qwen2_gguf_matches_the_jax_loader(tmp_path, fmt, packed):
    path = _write_gguf(tmp_path / "tiny.gguf", "qwen2", lambda n: fmt)
    model = _load("port", path, packed_weights=packed)
    assert bool(model.graph.store.packed_sources) == packed
    port, ref = _pair(model, _load("jax", path, packed_weights=packed))
    assert _kinds(port) == _kinds(ref)
    assert len(port._packed) == (9 if packed else 0)
    assert list(port._packed) == list(ref._packed)
    _assert_same_run(port, ref)


def test_the_packed_gguf_graph_is_the_references(tmp_path):
    """build_from_gguf_packed writes the reference's ONNX bytes (arch
    qwen2: no rows to un-permute) and the same store entries; the store
    keeps the matmul weights lazy until a dense copy is asked for."""
    path = _write_gguf(tmp_path / "tiny.gguf", "qwen2", lambda n: F.Q4_0)
    data, geo, entries = gguf_llama.build_from_gguf_packed(
        gguf.GGUFFile(path), max_len=MAX_LEN, dtype=DType.BF16)
    jdata, jgeo, jentries = jax_gguf_llama.build_from_gguf_packed(
        jax_gguf.GGUFFile(path), max_len=MAX_LEN, dtype=JaxDType.BF16)
    assert data == jdata and geo == jgeo and list(entries) == list(jentries)
    model = _load("port", path)
    store = model.graph.store
    TextInferenceInterface(model, max_len=MAX_LEN, device="cpu")
    assert all(n not in store._cache for n in store.packed_sources)


def test_gguf_loader_names_what_it_leaves_out(tmp_path):
    path = _write_gguf(tmp_path / "tiny.gguf", "qwen2", lambda n: F.Q4_0)
    gl = loader_registry()["gguf"]
    assert gl.can_load(path) and not gl.can_load(str(tmp_path))
    # decode_windows loads (tests/test_torch_port_windows.py serves it)
    b = gl.load({"path": path, "max_len": MAX_LEN, "decode_windows": "32"})
    assert list(b.interfaces["text"]["windows"]) == ["32"]
    # gemma, gemma2 and phi3 load (tests/test_torch_port_gemma_phi3.py)
    other = tmp_path / "gpt2.gguf"
    gguf.write_gguf(str(other), {"general.architecture": "gpt2"}, {})
    with pytest.raises(ValueError, match="gpt2"):
        gl.load({"path": str(other)})


def test_llama_cpp_permuted_gguf_loads_as_the_transformers_q4_0(tmp_path):
    """A llama.cpp-style arch-llama file (Q/K rows permuted for GGML's
    interleaved rope) in Q4_0: the port un-permutes the rows, so it runs
    the very blocks of the transformers load with quantize="q4_0" —
    logits bit for bit, the same tokens, and the JAX package's tokens on
    the HF checkpoint. The JAX GGUF loader feeds the permuted rows to the
    NeoX rotary and gets other logits (ROADMAP C5)."""
    from safetensors.numpy import save_file

    ckpt = tmp_path / "hf"
    ckpt.mkdir()
    names = ["model.embed_tokens.weight", "lm_head.weight", "model.norm.weight"]
    names += [f"model.layers.{i}.{hf}" for i in range(2) for hf in GGUF_NAMES
              if not hf.endswith(".bias")]
    save_file({n: _hf_weight(n) for n in names}, str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps(dict(
        LLAMA, model_type="llama", max_position_embeddings=MAX_LEN)))
    path = _write_gguf(tmp_path / "llama.gguf", "llama", lambda n: F.Q4_0,
                       permute=True)

    from whisper_tensor_tpu_torch.importers.loaders import (
        loader_registry as port_loaders)

    cfg = {"path": str(ckpt), "max_len": MAX_LEN, "dtype": "f32"}
    (_, hf_model), = port_loaders()["transformers"].load(cfg).models.items()
    (_, jax_hf), = jax_loaders()["transformers"].load(cfg).models.items()
    via_gguf, _ = _pair(_load("port", path), jax_hf)
    via_hf, ref = _pair(hf_model, jax_hf, quantize="q4_0")
    np.testing.assert_array_equal(via_gguf.logits(PROMPT),
                                  via_hf.logits(PROMPT))
    np.testing.assert_array_equal(via_gguf.generate_tokens(PROMPT, 8),
                                  via_hf.generate_tokens(PROMPT, 8))
    _assert_same_run(via_gguf, ref)
    _, jax_gguf_iface = _pair(_load("port", path), _load("jax", path))
    assert np.abs(np.asarray(jax_gguf_iface.logits(PROMPT))
                  - via_gguf.logits(PROMPT)).max() > 1e-2


def test_mixed_format_gguf_leaves_the_fused_qkv_dense(tmp_path):
    """Q4_K q/k and Q6_K v do not fuse into one packed tensor: the fused
    q/k/v is a dense MatMul (reference interfaces/text.py:501-503), the
    other weights stay packed."""
    def fmt_of(name):
        return F.Q6_K if name == "attn_v.weight" else F.Q4_K

    path = _write_gguf(tmp_path / "mixed.gguf", "qwen2", fmt_of)
    port, ref = _pair(_load("port", path), _load("jax", path))
    assert _kinds(port) == _kinds(ref)
    assert list(port._packed) == list(ref._packed)
    assert len(port._packed) == 7 and not any(
        "fused3" in n for n in port._packed)
    assert _kinds(port).count("MatMul") == 2          # the two fused q/k/v
    _assert_same_run(port, ref)


# -- (f) the batcher and the server ------------------------------------------------

def _batch_run(cls, model, quantize, **kw):
    b = cls(model, max_len=MAX_LEN, max_batch=2, chunk=4,
            prompt_buckets=(16,), quantize=quantize, **kw).start()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, V, (n,)).astype(np.int64) for n in (3, 9, 5)]
    try:
        futs = [b.submit(p, n) for p, n in zip(prompts, (6, 4, 8))]
        return prompts, [f.result(timeout=300) for f in futs]
    finally:
        b.stop()


@pytest.mark.parametrize("source", ["gguf", "q4_0"])
def test_packed_models_through_the_batcher(tmp_path, source):
    """A ragged_decode GGUF model (Q4_K) and a q4_0 host-quantized one
    through the port's ContinuousBatcher: the port's direct path's tokens
    and the JAX batcher's."""
    if source == "gguf":
        path = _write_gguf(tmp_path / "tiny.gguf", "qwen2", lambda n: F.Q4_K)
        ragged = _load("port", path, ragged_decode=True)
        jax_ragged = _load("jax", path, ragged_decode=True)
        scalar, quantize = _load("port", path), None
    else:
        ragged = Model.new_from_onnx(_llama_onnx(per_row=True))
        jax_ragged = JaxModel.new_from_onnx(_llama_onnx(per_row=True))
        scalar, quantize = Model.new_from_onnx(_llama_onnx()), "q4_0"
    prompts, outs = _batch_run(ContinuousBatcher, ragged, quantize,
                               cache_dtype=DType.F32, device="cpu")
    _, jax_outs = _batch_run(JaxBatcher, jax_ragged, quantize,
                             cache_dtype=JaxDType.F32)
    direct = TextInferenceInterface(scalar, max_len=MAX_LEN,
                                    prompt_buckets=(16,), device="cpu",
                                    cache_dtype=DType.F32, quantize=quantize)
    assert direct._packed
    for p, o, j in zip(prompts, outs, jax_outs):
        np.testing.assert_array_equal(o, j)
        np.testing.assert_array_equal(
            o, direct.generate_tokens(p[None], len(o))[0])


def test_a_gguf_completion_over_http(tmp_path):
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    path = _write_gguf(tmp_path / "tiny.gguf", "llama", lambda n: F.Q4_0,
                       permute=True)
    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("auto", {"path": path,
                                              "max_len": MAX_LEN})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
        c.request("POST", "/v1/completions", body=json.dumps(
            {"model": str(entry.id), "prompt": "hi", "max_tokens": 5,
             "temperature": 0}), headers={"Content-Type": "application/json"})
        r = c.getresponse()
        body = json.loads(r.read())
    finally:
        api.stop()
    assert r.status == 200 and body["usage"]["completion_tokens"] == 5
    iface = srv._text_iface(entry)
    assert iface._packed
    ids = np.asarray(ByteTokenizer().encode("hi"), np.int64)[None]
    toks = iface.generate_tokens(ids, 5)[0]
    assert body["choices"][0]["text"] == ByteTokenizer().decode(list(toks))
