"""The public names the port took last from the JAX package, each held
against the JAX package on the CPU.

* TextInferenceInterface.decode_tokens: from each side's own prefill of
  the tiny llama of tests/test_torch_port_slice.py (f32 cache), the
  greedy tokens equal the JAX package's decode_tokens exactly, plain and
  under a DFA constraint, and equal generate_tokens over the same
  prompt; the caches hold what the JAX program's hold.
* MultimodalLanguageInterface.generate_from_embeds, which now ends in
  decode_tokens: the tokens of the loop it had before (the embeds
  prefill, then one step a token, one generator throughout), greedy and
  sampled, and generate_tokens' tokens on the prompt's own embeddings;
  sampled through a top-1 filter under a repetition penalty (the first
  token counted as seen), the JAX package's generate_from_embeds.
* milli.transforms.apply_matmul_fusion: the fused map and every weight
  its getter binds, bit for bit.
* dtype: promote over every pair of DType (the same DType or the same
  error), bits, is_numeric and milli.ops.common.np_dtype_of over every
  DType, AnyDType's fields, check and repr.
* SymbolicGraph.producer_of over every tensor of a built graph (each
  package's own ids), and symbolic_graph.ops.base.opset_of.
* NumericTensor.scalar, .item, .has_nan and tensor.as_tensor on seeded
  arrays of each dtype.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from whisper_tensor_tpu import dtype as jax_dtype  # noqa: E402
from whisper_tensor_tpu import tensor as jax_tensor  # noqa: E402
from whisper_tensor_tpu import tokenizer as ref_tok  # noqa: E402
from whisper_tensor_tpu.milli.ops import common as jax_common  # noqa: E402
from whisper_tensor_tpu.milli.transforms import (  # noqa: E402
    apply_matmul_fusion as jax_fusion)
from whisper_tensor_tpu.packed_format import (  # noqa: E402
    PackedFormat as JaxPacked)
from whisper_tensor_tpu.symbolic_graph.ops.base import (  # noqa: E402
    opset_of as jax_opset_of)
from whisper_tensor_tpu.tensor_info import (  # noqa: E402
    TensorInfo as JaxInfo)
from whisper_tensor_tpu_torch import dtype as port_dtype  # noqa: E402
from whisper_tensor_tpu_torch import tensor as port_tensor  # noqa: E402
from whisper_tensor_tpu_torch import tokenizer as port_tok  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.multimodal import (  # noqa: E402
    MultimodalLanguageInterface)
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    SamplingParams, TextInferenceInterface, _pick_token)
from whisper_tensor_tpu_torch.milli.ops import common as port_common  # noqa: E402
from whisper_tensor_tpu_torch.milli.transforms import (  # noqa: E402
    apply_matmul_fusion)
from whisper_tensor_tpu_torch.packed_format import PackedFormat  # noqa: E402
from whisper_tensor_tpu_torch.symbolic_graph.ops.base import (  # noqa: E402
    opset_of)
from whisper_tensor_tpu_torch.tensor_info import TensorInfo  # noqa: E402

from tests.test_torch_port_slice import MAX_LEN, PROMPT, _pair  # noqa: E402
from tests.test_torch_port_slice import models  # noqa: F401,E402 (fixture)

N_NEW = 10


def _jax_prefill(ref, prompt):
    """The JAX interface's prefill at the prompt's bucket: (first greedy
    token, its caches)."""
    import jax.numpy as jnp

    B, L = prompt.shape
    bucket = min(b for b in ref.prompt_buckets if b >= L)
    ids = np.zeros((B, bucket), np.int64)
    ids[:, :L] = prompt
    step = ref._traced_step(B, bucket)
    logits, caches = step(jnp.asarray(ids), jnp.asarray(0, jnp.int64),
                          ref.fresh_cache(B), ref._weights())
    return np.asarray(logits[:, L - 1, :]).argmax(-1), caches


def _port_prefill(port, prompt):
    B, L = prompt.shape
    ids, _ = port._prompt(prompt)
    caches = port.fresh_cache(B)
    logits = port.step(ids, torch.zeros((), dtype=torch.int64), caches)
    return logits[:, L - 1, :].argmax(-1), caches


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_decode_tokens_is_token_exact(models, quantize):  # noqa: F811
    """From each side's own prefill: the JAX package's decode_tokens,
    generate_tokens' tokens, and the caches the JAX program returns
    (f32, summation order only)."""
    ref, port = _pair(models, DType.F32, quantize)
    L = PROMPT.shape[1]
    jfirst, jcaches = _jax_prefill(ref, PROMPT)
    first, caches = _port_prefill(port, PROMPT)
    np.testing.assert_array_equal(first.numpy(), jfirst)
    want = ref.decode_tokens(jfirst, L, jcaches, N_NEW)
    got = port.decode_tokens(first.numpy(), L, caches, N_NEW)
    assert got.shape == (PROMPT.shape[0], N_NEW) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], first.numpy())
    np.testing.assert_array_equal(got, port.generate_tokens(PROMPT, N_NEW))
    # decode_tokens drops the caches its program returns: run the
    # program itself from a fresh prefill to read them
    import jax
    import jax.numpy as jnp

    prog = ref._decode_program(PROMPT.shape[0], N_NEW)
    jfirst, jcaches = _jax_prefill(ref, PROMPT)
    _, jcaches = prog(jnp.asarray(jfirst), jnp.asarray(L, jnp.int64),
                      jcaches, ref._weights(), jax.random.PRNGKey(0),
                      None, None)
    for c, jc in zip(caches, jcaches):
        jc = np.asarray(jc)
        # n_new step runs: the last emitted token's keys are written too
        assert np.abs(c.numpy() - jc).max() <= 1e-5 * np.abs(jc).max()


@pytest.mark.parametrize("pattern", [r"(yes|no|maybe)!", r"[0-9]{2,5}"])
def test_decode_tokens_under_a_constraint(models, pattern):  # noqa: F811
    """The tokens after the first stay in the language, from its start
    state: the JAX package's decode_tokens exactly."""
    ref, port = _pair(models, DType.F32, None)
    ref.tokenizer, port.tokenizer = (ref_tok.ByteTokenizer(),
                                     port_tok.ByteTokenizer())
    L = PROMPT.shape[1]
    jfirst, jcaches = _jax_prefill(ref, PROMPT)
    first, caches = _port_prefill(port, PROMPT)
    want = ref.decode_tokens(jfirst, L, jcaches, N_NEW,
                             constraint=ref.compile_constraint(regex=pattern))
    cons = port.compile_constraint(regex=pattern)
    assert cons.start == 0          # the JAX program starts its rows at 0
    got = port.decode_tokens(first, L, caches, N_NEW, constraint=cons)
    np.testing.assert_array_equal(got, want)


def _parent_generate_from_embeds(mm, embeds, n_new, sampling=None):
    """The loop generate_from_embeds ran before it called decode_tokens:
    the embeds prefill, then one step a further token, each picked with
    one generator seeded once."""
    B, L, E = embeds.shape
    Sb = min(b for b in mm.text.prompt_buckets if b >= L)
    padded = torch.zeros((B, Sb, E), dtype=embeds.dtype)
    padded[:, :L] = embeds
    caches = mm.text.fresh_cache(B)
    logits = mm.prefill_embeds(padded, caches)
    gen = None
    if sampling is not None and sampling.temperature > 0.0:
        gen = torch.Generator()
        gen.manual_seed(int(sampling.seed))
    toks = [_pick_token(logits[:, L - 1, :], gen, sampling, None)]
    pos = torch.full((), L, dtype=torch.int64)
    for _ in range(1, n_new):
        last = mm.text.step(toks[-1][:, None], pos, caches)[:, -1, :]
        toks.append(_pick_token(last, gen, sampling, None))
        pos = pos + 1
    return torch.stack(toks, dim=1).numpy()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_generate_from_embeds_keeps_its_tokens(models, quantize):  # noqa: F811
    port = TextInferenceInterface(models[DType.F32], max_len=MAX_LEN,
                                  quantize=quantize, device="cpu")
    mm = MultimodalLanguageInterface(port, embed_weight_name="embed_tokens")
    embeds = mm._wte()[torch.from_numpy(PROMPT)]
    got = mm.generate_from_embeds(embeds, N_NEW)
    np.testing.assert_array_equal(
        got, _parent_generate_from_embeds(mm, embeds, N_NEW))
    np.testing.assert_array_equal(got, port.generate_tokens(PROMPT, N_NEW))


@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_generate_from_embeds_keeps_its_tokens(models, seed):  # noqa: F811
    """Sampled, the first token and the rest draw from one stream of the
    seed, as before decode_tokens took over the loop: the parent loop's
    tokens, and generate_tokens' on the prompt, whose k-th token takes
    the stream's k-th pick (the JAX package draws token k from
    fold_in(seed, k) in both)."""
    port = TextInferenceInterface(models[DType.F32], max_len=MAX_LEN,
                                  device="cpu")
    mm = MultimodalLanguageInterface(port, embed_weight_name="embed_tokens")
    embeds = mm._wte()[torch.from_numpy(PROMPT)]
    sp = SamplingParams(temperature=1.5, top_k=50, seed=seed)
    got = mm.generate_from_embeds(embeds, N_NEW, sampling=sp)
    np.testing.assert_array_equal(
        got, _parent_generate_from_embeds(mm, embeds, N_NEW, sp))
    np.testing.assert_array_equal(
        got, port.generate_tokens(PROMPT, N_NEW, sampling=sp))
    # the draw matters: the seeded tokens are not the greedy ones
    assert (got != mm.generate_from_embeds(embeds, N_NEW)).any()


def test_sampled_generate_from_embeds_against_the_jax_package(models):  # noqa: F811
    """Through the sampling path (temperature > 0) with a top-1 filter,
    so both frameworks' draws pick alike, under a repetition penalty that
    counts the first token as seen and not the prompt, as the JAX decode
    program does: the JAX package's generate_from_embeds exactly."""
    from whisper_tensor_tpu.interfaces.multimodal import (
        MultimodalLanguageInterface as JaxMultimodal)
    from whisper_tensor_tpu.interfaces.text import (
        SamplingParams as JaxSampling)

    ref, port = _pair(models, DType.F32, None)
    jmm = JaxMultimodal(ref, embed_weight_name="embed_tokens")
    mm = MultimodalLanguageInterface(port, embed_weight_name="embed_tokens")
    kw = dict(temperature=0.7, top_k=1, repetition_penalty=3.0, seed=5)
    want = jmm.generate_from_embeds(jmm._wte()[PROMPT], N_NEW,
                                    sampling=JaxSampling(**kw))
    embeds = mm._wte()[torch.from_numpy(PROMPT)]
    got = mm.generate_from_embeds(embeds, N_NEW,
                                  sampling=SamplingParams(**kw))
    np.testing.assert_array_equal(got, want)
    # the penalty bites: the greedy tokens differ
    assert (got != mm.generate_from_embeds(embeds, N_NEW)).any()


@pytest.mark.parametrize("dt", [DType.F32, DType.BF16])
def test_apply_matmul_fusion_matches_the_jax_package(models, dt):  # noqa: F811
    port_milli, port_w = models[dt].graph.to_milli()
    ref_model = models["jax", dt]
    ref_milli, ref_w = ref_model.graph.to_milli()
    fused, get = apply_matmul_fusion(port_milli, port_w,
                                     models[dt].graph.store)
    jfused, jget = jax_fusion(ref_milli, ref_w, ref_model.graph.store)
    assert fused == jfused
    assert any(len(m) == 3 for m in fused.values())      # q/k/v
    assert list(port_milli.inputs) == list(ref_milli.inputs)
    for n in list(fused) + [n for n in port_w if n in port_milli.inputs]:
        a, b = get(n), jget(n, jax_dtype.DType.F32)
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("a", list(DType), ids=lambda d: d.name)
def test_promote_over_every_pair(a):
    ja = jax_dtype.DType[a.name]
    for b in DType:
        jb = jax_dtype.DType[b.name]
        try:
            want = jax_dtype.promote(ja, jb).name
        except (ValueError, TypeError) as e:
            with pytest.raises(type(e)):
                port_dtype.promote(a, b)
            continue
        assert port_dtype.promote(a, b).name == want, (a, b)


@pytest.mark.parametrize("dt", list(DType), ids=lambda d: d.name)
def test_bits_is_numeric_and_np_dtype_of(dt):
    jdt = jax_dtype.DType[dt.name]
    assert dt.bits == jdt.bits
    assert dt.is_numeric == jdt.is_numeric
    assert port_common.np_dtype_of(TensorInfo.minimal(dt)) == \
        jax_common.np_dtype_of(JaxInfo.minimal(jdt))


def test_any_dtype():
    for kw, jkw in [({"scalar": DType.BF16},
                     {"scalar": jax_dtype.DType.BF16}),
                    ({"packed": PackedFormat.Q4_K},
                     {"packed": JaxPacked.Q4_K})]:
        got, want = port_dtype.AnyDType(**kw), jax_dtype.AnyDType(**jkw)
        assert got.is_packed == want.is_packed
        assert repr(got) == repr(want)
        assert got == port_dtype.AnyDType(**kw)
    for bad in ({}, {"scalar": DType.F32, "packed": PackedFormat.Q8_0}):
        with pytest.raises(ValueError):
            port_dtype.AnyDType(**bad)


def test_producer_of_and_opset_of(models):  # noqa: F811
    """Each package's producer_of over its own tensor ids (each package
    numbers tensors from its own global counter): every op's outputs map
    to that op, graph inputs and initializers to none, and the producers
    in op order are the JAX package's."""
    g, jg = models[DType.F32].graph, models["jax", DType.F32].graph
    found = []
    for graph in (g, jg):
        produced = {t for op in graph.ops for t in op.outputs
                    if t is not None}
        for op in graph.ops:
            assert all(graph.producer_of(t) is op
                       for t in op.outputs if t is not None)
        assert all(graph.producer_of(t) is None
                   for t in graph.tensors if t not in produced)
        assert graph.producer_of(max(graph.tensors) + 1) is None
        found.append([(graph.producer_of(t).name,
                       graph.producer_of(t).op.OP_TYPE)
                      for op in graph.ops for t in op.outputs[:1]
                      if t is not None])
    assert found[0] == found[1] and len(found[0]) == len(g.ops)
    for opsets in ({"": 23, "wt": 1}, {}):
        for dom in ("", "wt", "com.microsoft"):
            assert opset_of(opsets, dom) == jax_opset_of(opsets, dom)
    assert opset_of({"": 17}) == jax_opset_of({"": 17}) == 17


_TENSOR_DTYPES = [DType.F32, DType.F16, DType.BF16, DType.I64, DType.I8,
                  DType.U8, DType.BOOL]


@pytest.mark.parametrize("dt", _TENSOR_DTYPES, ids=lambda d: d.name)
def test_numeric_tensor_scalar_item_has_nan_as_tensor(dt):
    jdt = jax_dtype.DType[dt.name]
    rng = np.random.default_rng(7)
    arr = (rng.standard_normal((3, 4)) * 10).astype(np.float32)
    if dt.is_float:
        arr[1, 2] = np.nan
    host = arr.astype(dt.to_numpy()) if dt is not DType.BOOL else arr > 0
    for x in (host, host[:1, :1], 3):
        got = port_tensor.as_tensor(x, dt)
        want = jax_tensor.as_tensor(x, jdt)
        assert got.dtype.name == want.dtype.name
        assert got.shape == want.shape
        assert got.numpy().tobytes() == np.asarray(want.numpy()).tobytes()
        assert got.has_nan() == want.has_nan()
        gi, wi = got.item(), want.item()
        assert type(gi) is type(wi)
        np.testing.assert_array_equal(np.asarray(gi, np.float64),
                                      np.asarray(wi, np.float64))
    same = port_tensor.as_tensor(host)
    assert port_tensor.as_tensor(same) is same
    s, js = (port_tensor.NumericTensor.scalar(2.5, dt),
             jax_tensor.NumericTensor.scalar(2.5, jdt))
    assert s.shape == js.shape == () and s.dtype.name == js.dtype.name
    assert s.item() == js.item()
