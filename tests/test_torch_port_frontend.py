"""The PyTorch port's own front half against the JAX package's.

The port keeps trimmed copies of the framework-neutral layers it runs
(recipes, ONNX codec, symbolic graph, milli ops and passes, tokenizer).
Here each copy is held to the module it came from, at small sizes
(tiny llama and GPT-2 step graphs, weights from numpy with fixed seeds):

* the llama and GPT-2 recipes write byte-identical ONNX, in f32 and
  bf16, with a scalar and a per-row `pos`;
* `to_milli` of the same bytes gives the same node kinds in the same
  order, and so do the matmul fusion and int8 quantization passes, whose
  int8 weights and scales are bit-identical;
* every milli op kind the port lowers evaluates (numpy `eval`) to the
  same bytes as the reference's class, on the inputs it meets when the
  reference graph runs on seeded feeds (QuantMatMul and PackedMatMul,
  which only the quantization and packing passes make, on seeded
  inputs of their own);
* the tokenizers encode, decode, stream and render chat prompts exactly
  as the reference's, byte-level and through an HF tokenizer.json.
Tolerance: zero everywhere (the copies run the same numpy code). The
port's quantize_int8 copies the reference's numpy definition; the
reference may take a native C++ fast path instead, whose scales can
differ from that definition in the last bit, so these tests hold the
reference to its numpy path.
"""

import json
import zlib

import ml_dtypes
import numpy as np
import pytest

pytest.importorskip("jax")

from whisper_tensor_tpu import tokenizer as jax_tokenizer  # noqa: E402
from whisper_tensor_tpu.backends.pallas.quant_matmul import (  # noqa: E402
    quantize_int8 as jax_quantize_int8)
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gpt2 as jax_gpt2, llama as jax_llama)
from whisper_tensor_tpu.milli import transforms as jax_transforms  # noqa: E402
from whisper_tensor_tpu.milli.ops import einsum as jax_einsum  # noqa: E402
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch import tokenizer  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    gpt2, llama)
from whisper_tensor_tpu_torch.milli import transforms  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import einsum as port_einsum  # noqa: E402
from whisper_tensor_tpu_torch.model import Model  # noqa: E402

MAX_LEN, V = 64, 512
LLAMA = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, hidden_size=128, intermediate_size=192,
             vocab_size=V, head_dim=32)
GPT2 = dict(n_layer=2, n_head=2, n_embd=64, vocab_size=V,
            n_positions=MAX_LEN)


def _llama_weights(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    E, I, D = LLAMA["hidden_size"], LLAMA["intermediate_size"], 32
    shapes = {"embed_tokens": (V, E), "lm_head": (V, E), "norm": (E,),
              "layernorm": (E,), "q_proj": (4 * D, E), "k_proj": (2 * D, E),
              "v_proj": (2 * D, E), "o_proj": (E, 4 * D),
              "gate_proj": (I, E), "up_proj": (I, E), "down_proj": (E, I)}
    shape = next(s for k, s in shapes.items() if k + ".weight" in name)
    if len(shape) == 1:
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (0.08 * rng.standard_normal(shape)).astype(np.float32)


def _onnx(pkg, family, dt, per_row):
    """The step graph's ONNX bytes from one package's recipe; both take
    the same numpy weights."""
    if family == "llama":
        mod = llama if pkg == "port" else jax_llama
        return mod.build_llama_step(_llama_weights, mod.LlamaConfig(**LLAMA),
                                    max_len=MAX_LEN, dtype=dt,
                                    pos_per_row=per_row)
    mod = gpt2 if pkg == "port" else jax_gpt2
    weights = jax_gpt2.random_gpt2_weights(jax_gpt2.GPT2Config(**GPT2))
    return mod.build_gpt2_step(weights, mod.GPT2Config(**GPT2),
                               max_len=MAX_LEN, dtype=dt, pos_per_row=per_row)


@pytest.fixture(autouse=True)
def _numpy_quantize(monkeypatch):
    """The reference's quantize_int8 on its numpy path."""
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)


GRAPHS = [(f, dt, per_row) for f in ("llama", "gpt2") for dt in ("F32", "BF16")
          for per_row in (False, True)]


@pytest.mark.parametrize("family,dt,per_row", GRAPHS)
def test_recipes_write_byte_identical_onnx(family, dt, per_row):
    want = _onnx("jax", family, JaxDType[dt], per_row)
    got = _onnx("port", family, DType[dt], per_row)
    assert len(got) == len(want) and got == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8",
                                   "float16", "float64"])
@pytest.mark.parametrize("shape", [(300, 77), (1, 5), (4096, 1)])
def test_transposed_equals_numpys_transpose(dtype, shape):
    """The recipes' torch transpose gives np.ascontiguousarray(a.T) bit
    for bit, for ml_dtypes' bf16 too, from a read-only or a strided
    array as well."""
    from whisper_tensor_tpu_torch.importers.recipes.llm import transposed

    dt = np.dtype(getattr(ml_dtypes, dtype, None) or dtype)
    a = (np.random.default_rng(3).standard_normal(shape) * 50).astype(dt)
    ro = a.copy()
    ro.setflags(write=False)
    for src in (a, ro, np.asfortranarray(a)):
        got, want = transposed(src), np.ascontiguousarray(src.T)
        assert got.dtype == want.dtype and got.flags.c_contiguous
        assert got.tobytes() == want.tobytes()


def test_random_gpt2_weights_match():
    want = jax_gpt2.random_gpt2_weights(jax_gpt2.GPT2Config(**GPT2), seed=3)
    got = gpt2.random_gpt2_weights(gpt2.GPT2Config(**GPT2), seed=3)
    for name in ("transformer.wte.weight", "transformer.h.1.attn.c_attn.weight",
                 "transformer.h.0.ln_1.bias", "transformer.ln_f.weight"):
        np.testing.assert_array_equal(got(name), want(name))


def _milli_pair(family, dt, per_row, passes):
    """(reference, port) milli graphs of one ONNX, with their models and
    the weight inputs; `passes` runs the matmul fusion and int8
    quantization in each package. Returns also the quantized weights."""
    data = _onnx("jax", family, JaxDType[dt], per_row)
    out = []
    for pkg, model_cls, tr in (("jax", JaxModel, jax_transforms),
                               ("port", Model, transforms)):
        m = model_cls.new_from_onnx(data)
        milli, weight_inputs = m.graph.to_milli()
        quantized = {}
        if passes:
            fused = tr.fuse_parallel_matmuls(milli, set(weight_inputs))
            store = m.graph.store

            def dense(n, fused=fused, store=store):
                if n in fused:
                    return np.concatenate([store.get_numeric(k).numpy()
                                           for k, _ in fused[n]], axis=1)
                return store.get_numeric(n).numpy()

            live = [n for n in milli.inputs
                    if n in weight_inputs or n in fused]
            quantized = tr.quantize_matmul_weights(milli, live, dense,
                                                   min_elements=4096)
        out.append((m, milli, weight_inputs, quantized))
    return out


@pytest.mark.parametrize("family,dt,per_row", GRAPHS)
@pytest.mark.parametrize("passes", [False, True], ids=["to_milli", "passes"])
def test_milli_graphs_have_the_same_kinds_in_order(family, dt, per_row,
                                                   passes):
    (_, ref, ref_w, ref_q), (_, port, port_w, port_q) = _milli_pair(
        family, dt, per_row, passes)
    assert [n.op.KIND for n in port.nodes] == [n.op.KIND for n in ref.nodes]
    assert [n.inputs for n in port.nodes] == [n.inputs for n in ref.nodes]
    assert list(port.inputs) == list(ref.inputs)
    assert list(port.outputs) == list(ref.outputs)
    assert port_w == ref_w
    assert sorted(port_q) == sorted(ref_q) and (not passes or port_q)
    for n, (w, s) in ref_q.items():
        assert port_q[n][0].dtype == w.dtype and port_q[n][1].dtype == s.dtype
        np.testing.assert_array_equal(port_q[n][0], w)
        np.testing.assert_array_equal(port_q[n][1], s)


def test_quantize_int8_matches():
    w = np.random.default_rng(5).standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0                               # an all-zero column
    for got, want in zip(transforms.quantize_int8(w), jax_quantize_int8(w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _feeds(family, dt, per_row, milli, model, weight_inputs):
    """Seeded feeds for a milli graph: 2 rows of 5 tokens at pos 3 (or
    3 and 10), caches of small normal values in the cache's type."""
    rng = np.random.default_rng(17)
    np_dt = np.float32 if dt == "F32" else ml_dtypes.bfloat16
    heads, hd = 2, 32                  # KV heads and head dim of both
    feeds = {"input_ids": rng.integers(0, V, (2, 5)).astype(np.int64),
             "pos": (np.array([3, 10]) if per_row else np.array(3))
             .astype(np.int64)}
    for name in milli.inputs:
        if name.startswith("cache_"):
            feeds[name] = (0.5 * rng.standard_normal(
                (2, heads, MAX_LEN, hd))).astype(np_dt)
        elif name in weight_inputs:
            feeds[name] = model.graph.store.get_numeric(
                weight_inputs[name]).numpy()
    return feeds


def _capture_eval_cases(per_kind=4):
    """{KIND: [(reference op, port op, inputs)]}: the first `per_kind`
    nodes of each kind in each graph, as the reference graphs run on
    seeded feeds."""
    cases = {}
    for family, dt, per_row in [("llama", "BF16", False),
                                ("llama", "F32", True),
                                ("gpt2", "F32", False),
                                ("gpt2", "BF16", True)]:
        (jm, ref, ref_w, _), (_, port, _, _) = _milli_pair(
            family, dt, per_row, passes=False)
        port_op = {id(a.op): b.op for a, b in zip(ref.nodes, port.nodes)}
        taken = {}

        def capture(op, inputs, port_op=port_op, taken=taken):
            taken[op.KIND] = taken.get(op.KIND, 0) + 1
            if taken[op.KIND] <= per_kind:
                cases.setdefault(op.KIND, []).append((op, port_op[id(op)],
                             [None if x is None else np.array(x)
                              for x in inputs]))
            return None                          # the reference's own eval

        ref.eval(_feeds(family, dt, per_row, ref, jm, ref_w), op_impl=capture)
    rng = np.random.default_rng(9)
    w = (0.05 * rng.standard_normal((128, 96))).astype(np.float32)
    w_i8, scale = jax_quantize_int8(w)
    for x_dt in (np.float32, ml_dtypes.bfloat16):
        x = rng.standard_normal((2, 5, 128)).astype(x_dt)
        cases.setdefault("QuantMatMul", []).append(
            (jax_transforms.QuantMatMulMilli(), transforms.QuantMatMulMilli(),
             [x, w_i8, scale]))
        # PackedMatMul (made by the packing pass): the nibble layout at
        # G 32 and the int8 layout at G 16, seeded
        for bits, G in ((4, 32), (8, 16)):
            q = (rng.integers(0, 256, (64, 96), dtype=np.uint8) if bits == 4
                 else rng.integers(-128, 128, (128, 96), dtype=np.int8))
            s = rng.uniform(0.001, 0.05, (128 // G, 96)).astype(np.float32)
            o = rng.uniform(-0.2, 0.2, (128 // G, 96)).astype(np.float32)
            cases.setdefault("PackedMatMul", []).append(
                (jax_transforms.PackedMatMulMilli(bits=bits),
                 transforms.PackedMatMulMilli(bits=bits), [x, q, s, o]))
        # Einsum (made by the multi-LoRA surgery): its three equations
        for eq, shapes in (("bsk,nkr->bnsr", [(2, 5, 128), (3, 128, 16)]),
                           ("bnsr,bn->bnsr", [(2, 3, 5, 16), (2, 3)]),
                           ("bnsr,nrm->bsm", [(2, 3, 5, 16), (3, 16, 96)])):
            ins = [rng.standard_normal(sh).astype(x_dt) for sh in shapes]
            cases.setdefault("Einsum", []).append(
                (jax_einsum.EinsumMilli(equation=eq),
                 port_einsum.EinsumMilli(equation=eq), ins))
    return cases


@pytest.fixture(scope="module")
def eval_cases():
    return _capture_eval_cases()


# The kinds the text recipes' graphs hold. KVWrite, the port's merge of
# a layer's two cache writes (pair_cache_writes), has no counterpart in
# the JAX package: its eval is held against two of the reference's
# DynUpdateSlice evals in tests/test_torch_port_transforms.py. Every
# other kind of LOWERINGS is held to the reference's eval on the
# conformance corpus's graphs (tests/test_torch_conformance_ops.py).
RECIPE_KINDS = ("Attention", "Cast", "CastLike", "Constant",
                "DynUpdateSlice", "Einsum", "Gather", "LayerNorm", "MatMul",
                "PackedMatMul", "QuantMatMul", "RMSNorm", "Range", "Reshape",
                "Rotary", "Shape", "SimpleBinary", "SimpleUnary", "Split",
                "Squeeze", "Transpose", "Unsqueeze", "Where")


@pytest.mark.parametrize("kind", RECIPE_KINDS)
def test_milli_op_eval_matches_the_reference(kind, eval_cases):
    assert kind in LOWERINGS
    cases = eval_cases.get(kind)
    assert cases, f"no node of kind {kind} in the recipes' graphs"
    for ref_op, port_op, inputs in cases:
        assert type(port_op).__name__ == type(ref_op).__name__
        assert port_op.KIND == ref_op.KIND == kind
        want = ref_op.eval(list(inputs))
        got = port_op.eval(list(inputs))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, kind
            assert g.tobytes() == w.tobytes(), kind


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_port_graphs_hold_only_port_op_classes(family):
    """After both passes, every op of the port's graph is a class of the
    port: its isinstance checks never meet a class of the JAX package."""
    (_, ref, _, _), (_, port, _, _) = _milli_pair(family, "BF16", True,
                                                  passes=True)
    kinds = {n.op.KIND for n in port.nodes}
    assert "QuantMatMul" in kinds
    assert all(type(n.op).__module__.startswith("whisper_tensor_tpu_torch.")
               for n in port.nodes)
    assert all(type(n.op).__module__.startswith("whisper_tensor_tpu.")
               for n in ref.nodes)


CORPUS = ["hello there", "", "  leading and trailing  ", "naïve café — 東京 🚀",
          "line one\nline two\ttabbed", "a" * 300, "mixed 123 456.789 !?",
          "Ünïcödé ßtrings and emoji 👩‍💻 joined"]


def _hf_dir(tmp_path):
    """A byte-level BPE tokenizer.json trained on the corpus, and a
    tokenizer_config.json with a chat template."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS * 3, trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=["<s>", "</s>"]))
    tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<s>", "eos_token": "</s>",
        "chat_template": "{{ bos_token }}{% for m in messages %}[{{ m.role }}]"
                         " {{ m.content }}\n{% endfor %}"
                         "{% if add_generation_prompt %}[assistant] {% endif %}"}))
    return str(tmp_path)


MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "naïve café?"}]


@pytest.mark.parametrize("source", ["bytes", "hf"])
def test_tokenizers_match_the_reference(source, tmp_path):
    src = "bytes" if source == "bytes" else _hf_dir(tmp_path)
    ref = jax_tokenizer.AnyTokenizer.load(src)
    port = tokenizer.AnyTokenizer.load(src)
    assert port.vocab_size == ref.vocab_size
    for text in CORPUS:
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids) == text
        # streaming: every prefix of the token list, as the servers do
        want, got = (jax_tokenizer.IncrementalDecoder(ref, window=8, commit=4),
                     tokenizer.IncrementalDecoder(port, window=8, commit=4))
        for i in ids:
            want.push(i)
            got.push(i)
            assert got.text == want.text and got.length == want.length
        assert got.text_from(3) == want.text_from(3)
    assert tokenizer.apply_chat_template(port, MESSAGES) == \
        jax_tokenizer.apply_chat_template(ref, MESSAGES)
