"""The PyTorch port's milli-op lowerings and graph executor against the
JAX package's numpy oracle (its MilliGraph.eval, over its own lowering
of the same ONNX bytes and its own graph passes), on a tiny llama step
graph (2 layers,
hidden 256, 2 query heads and 1 KV head of 128, vocab 512, max_len 64)
and on the tiny GPT-2 step graphs of tests/test_batching.py (2 layers,
n_embd 32, 2 heads, vocab 211), scalar and per-row (ragged) position;
weights and inputs from numpy with fixed seeds."""

import zlib

import numpy as np
import pytest
import torch

from whisper_tensor_tpu.dtype import DType as JaxDType
from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (GPT2Config,
                                                            build_gpt2_step,
                                                            random_gpt2_weights)
from whisper_tensor_tpu.importers.recipes.llm.llama import (LlamaConfig,
                                                             build_llama_step)
from whisper_tensor_tpu.milli.ir import MilliGraph
from whisper_tensor_tpu.milli.transforms import (fuse_parallel_matmuls,
                                                 quantize_matmul_weights)
from whisper_tensor_tpu.model import Model as JaxModel
from whisper_tensor_tpu_torch.backends.torch_exec.compiler import GraphExecutor
from whisper_tensor_tpu_torch.dtype import DType, to_device, to_host
from whisper_tensor_tpu_torch.interfaces.text import TextInferenceInterface
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
from whisper_tensor_tpu_torch.model import Model

CPU = torch.device("cpu")
CFG = LlamaConfig(num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=1, hidden_size=256,
                  intermediate_size=384, vocab_size=512, head_dim=128)
MAX_LEN = 64
CONFIGS = ["f32-dense", "f32-int8", "bf16-dense", "bf16-int8"]
# op kinds of the llama step graph (QuantMatMul replaces MatMul under int8)
KINDS = ["Attention", "Cast", "Constant", "DynUpdateSlice", "Gather",
         "RMSNorm", "Range", "Reshape", "Rotary", "Shape", "SimpleBinary",
         "SimpleUnary", "Split", "Squeeze", "Transpose"]
CASES = ([(c, k) for c in CONFIGS for k in KINDS]
         + [(c, "MatMul") for c in CONFIGS if c.endswith("dense")]
         + [(c, "QuantMatMul") for c in CONFIGS if c.endswith("int8")])


def _weights(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    E, I, V, D = 256, 384, 512, 128
    shape = {"embed": (V, E), "lm_head": (V, E), "q_proj": (E, E),
             "o_proj": (E, E), "k_proj": (D, E), "v_proj": (D, E),
             "gate_proj": (I, E), "up_proj": (I, E), "down_proj": (E, I)}
    for key, s in shape.items():
        if key in name:
            return (rng.standard_normal(s) * 0.08).astype(np.float32)
    return (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)


def _with_oracle(iface, data):
    """Give the port interface `iface` (built from the ONNX bytes `data`)
    its oracle: the JAX package's milli graph of the same bytes, after
    the JAX package's fusion and int8 passes, as `iface.ref_milli`. Its
    weight inputs carry the port's names, so one feed dict drives both;
    `iface.port_op` maps each of its ops to the port's op at the same
    node."""
    milli, weight_inputs = JaxModel.new_from_onnx(data).graph.to_milli()
    fused = fuse_parallel_matmuls(milli, set(weight_inputs))
    if iface._quantized:
        live = [n for n in milli.inputs if n in weight_inputs or n in fused]
        quantize_matmul_weights(milli, live, iface._dense_np)
    assert list(milli.inputs) == list(iface.milli.inputs)
    assert ([n.op.KIND for n in milli.nodes]
            == [n.op.KIND for n in iface.milli.nodes])
    iface.ref_milli = milli
    iface.port_op = {id(r.op): p.op
                     for r, p in zip(milli.nodes, iface.milli.nodes)}
    return iface


def _iface(config):
    dt = DType.F32 if config.startswith("f32") else DType.BF16
    data = build_llama_step(_weights, CFG, max_len=MAX_LEN,
                            dtype=JaxDType[dt.name])
    return _with_oracle(TextInferenceInterface(
        Model.new_from_onnx(data), max_len=MAX_LEN, cache_dtype=dt,
        device="cpu", quantize="int8" if config.endswith("int8") else None),
        data)


def _feeds(iface, S, pos, seed):
    rng = np.random.default_rng(seed)
    np_dt = iface.cache_dtype.to_numpy()
    feeds = {"input_ids": rng.integers(0, iface._vocab_size(), (2, S)
                                       ).astype(np.int64),
             "pos": np.asarray(pos, np.int64)}
    for n in iface.cache_in_names:
        feeds[n] = (rng.standard_normal(
            (2, iface.n_heads, MAX_LEN, iface.head_dim)) * 0.5).astype(np_dt)
    feeds.update(iface.host_weights())
    return feeds


def _tol(out: np.ndarray):
    """f32: summation order only, 1e-5 of the output's scale. bf16:
    2e-2 of the scale - one or two roundings at 2^-8 relative, plus the
    attention probabilities the reference rounds to bf16."""
    if out.dtype.kind in "iub":
        return 0.0
    scale = max(1.0, float(np.abs(out.astype(np.float32)).max()))
    return (1e-5 if out.dtype == np.float32 else 2e-2) * scale


def _widen(a):
    """bf16 host array -> f32 (other arrays as they are)."""
    return a.astype(np.float32) if a is not None and a.dtype.kind == "V" \
        else a


@pytest.fixture(scope="module")
def per_kind_errors():
    """Per config: run the oracle over a prefill and a decode step; at
    every node also run the port's lowering on the same inputs (all
    given as static host values as well as tensors) and record, per op
    kind, the worst error relative to that output's tolerance.

    In the bf16 graphs each node's port output is held against the
    oracle run on the same inputs widened to f32 (the algorithm in f32):
    the oracle's RMSNorm keeps ml_dtypes bf16 in bf16 (its f32 stash
    tests dtype.kind == "f", which ml_dtypes' bf16 is not), where the
    reference's XLA lowering and the port compute in f32."""
    return {config: _kind_errors(_iface(config), ((16, 0, 1), (1, 21, 2)))
            for config in CONFIGS}


def _kind_errors(iface, runs):
    """{op kind: worst error / tolerance} over oracle runs of `iface`'s
    step graph at (S, pos, seed), the port's lowering beside each node."""
    worst = {}

    def op_impl(op, ins):
        want = op.eval(ins)
        ref = op.eval([_widen(a) for a in ins])
        tens = [None if a is None else to_device(np.asarray(a), CPU)
                for a in ins]
        got = LOWERINGS[op.KIND](iface.port_op[id(op)], tens, list(ins), CPU)
        ratio = 0.0
        for g, w, r in zip(got, want, ref):
            w = np.asarray(w)
            g = to_host(g)
            assert g.shape == w.shape and g.dtype == w.dtype, op.KIND
            err = float(np.abs(g.astype(np.float64)
                               - np.asarray(r, np.float64)).max(initial=0))
            tol = _tol(w)
            ratio = max(ratio, err / tol if tol else
                        (0.0 if err == 0 else np.inf))
        worst[op.KIND] = max(worst.get(op.KIND, 0.0), ratio)
        return want

    for S, pos, seed in runs:
        iface.ref_milli.eval(_feeds(iface, S, pos, seed), op_impl=op_impl)
    return worst


@pytest.mark.parametrize("config,kind", CASES)
def test_lowering_matches_oracle_in_step_graph(per_kind_errors, config, kind):
    worst = per_kind_errors[config]
    assert kind in worst, f"{kind} not in the {config} step graph"
    assert worst[kind] <= 1.0, (config, kind, worst[kind])


@pytest.mark.parametrize("config", CONFIGS)
def test_step_graph_kinds_are_all_covered(per_kind_errors, config):
    want = set(KINDS) | {"QuantMatMul" if config.endswith("int8")
                         else "MatMul"}
    assert set(per_kind_errors[config]) == want


@pytest.mark.parametrize("config", ["f32-dense", "f32-int8"])
def test_executor_matches_oracle_whole_step(config):
    """GraphExecutor over the whole f32 step graph (prefill, then decode
    steps on the updated caches) against the JAX package's
    MilliGraph.eval: logits and
    every cache, 1e-5 of their scale. (Whole bf16 graphs are held
    against the JAX package in test_torch_port_slice.py: the oracle
    runs bf16 RMSNorm in bf16, see per_kind_errors.)"""
    iface = _iface(config)
    ex = GraphExecutor(iface.milli, CPU)
    for S, pos, seed in ((16, 0, 3), (1, 17, 4), (1, 18, 5)):
        feeds = _feeds(iface, S, pos, seed)
        want = iface.ref_milli.eval(feeds)
        got = ex({n: to_device(a, CPU) for n, a in feeds.items()})
        for name, w in want.items():
            g = to_host(got[name])
            err = np.abs(g.astype(np.float64) - w.astype(np.float64)).max()
            assert err <= _tol(w), (config, name, err)


def test_executor_folds_once_per_plan_and_writes_caches_in_place():
    iface = _iface("f32-dense")
    ex = GraphExecutor(iface.milli, CPU)
    feeds = {n: to_device(a, CPU)
             for n, a in _feeds(iface, 1, 5, 6).items()}
    cache = feeds["cache_k_0"]
    first = ex(feeds)
    assert first["new_cache_k_0"] is cache         # written in place
    (plan,) = ex._plans.values()
    kinds = {st.op.KIND for st in plan.steps}
    # shape arithmetic and constants were folded when the plan was built
    assert not kinds & {"Shape", "Constant", "Squeeze", "Range"}
    assert len(plan.steps) < len(iface.milli.nodes)
    again = ex(feeds)
    assert len(ex._plans) == 1
    torch.testing.assert_close(again["logits"], first["logits"])
    feeds["input_ids"] = feeds["input_ids"].repeat(1, 2)   # new shape
    ex(feeds)
    assert len(ex._plans) == 2


def test_executor_raises_for_an_op_without_lowering():
    """A milli op kind without a lowering raises, naming its kind. Since
    the vision ops came every milli op of the JAX package has one
    (GridSample was this test's op until then; Einsum, Pow and Conv
    before it), so the op here is the test's own."""
    from whisper_tensor_tpu.milli.ir import MilliOp

    class Unlowered(MilliOp):
        KIND = "Unlowered"

        def infer(self, infos):
            return [infos[0]]

    g = MilliGraph("no-lowering")
    a, b = g.add_input("a"), g.add_input("b")
    g.mark_output("y", g.op1(Unlowered(), a, b))
    ex = GraphExecutor(g, CPU)
    with pytest.raises(NotImplementedError, match="Unlowered"):
        ex({"a": torch.ones(2, 3), "b": torch.ones(2, 3)})


# -- the GPT-2 step graphs (the batcher tests' fixtures) ---------------------
GPT2_CONFIGS = ["gpt2-scalar-f32", "gpt2-ragged-f32", "gpt2-ragged-bf16"]
GPT2_KINDS = ["Attention", "CastLike", "Constant", "DynUpdateSlice",
              "Gather", "LayerNorm", "MatMul", "Range", "Reshape", "Shape",
              "SimpleBinary", "SimpleUnary", "Split", "Squeeze",
              "Transpose", "Unsqueeze"]
GPT2_SCALAR_KINDS = ["Cast", "Where"]        # the scalar graph's mask


def _gpt2_kinds(config):
    return GPT2_KINDS + (GPT2_SCALAR_KINDS if "scalar" in config else [])


def _gpt2_iface(config):
    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=211,
                     n_positions=MAX_LEN)
    dt = DType.F32 if config.endswith("f32") else DType.BF16
    data = build_gpt2_step(random_gpt2_weights(cfg), cfg, max_len=MAX_LEN,
                           dtype=JaxDType[dt.name],
                           pos_per_row="ragged" in config)
    return _with_oracle(TextInferenceInterface(
        Model.new_from_onnx(data), max_len=MAX_LEN, cache_dtype=dt,
        device="cpu"), data)


def _gpt2_runs(config):
    """(S, pos, seed): a prefill and decode steps; the ragged graph's
    rows at different positions."""
    if "ragged" in config:
        return ((16, [0, 0], 7), (1, [21, 5], 8), (1, [22, 6], 9))
    return ((16, 0, 7), (1, 21, 8), (1, 22, 9))


@pytest.fixture(scope="module")
def gpt2_per_kind_errors():
    return {c: _kind_errors(_gpt2_iface(c), _gpt2_runs(c)[:2])
            for c in GPT2_CONFIGS}


@pytest.mark.parametrize("config,kind", [(c, k) for c in GPT2_CONFIGS
                                         for k in _gpt2_kinds(c)])
def test_gpt2_lowering_matches_oracle_in_step_graph(gpt2_per_kind_errors,
                                                    config, kind):
    """The llama graph's tolerances (_tol: 1e-5 of the scale at f32,
    2e-2 at bf16)."""
    worst = gpt2_per_kind_errors[config]
    assert kind in worst, f"{kind} not in the {config} step graph"
    assert worst[kind] <= 1.0, (config, kind, worst[kind])


@pytest.mark.parametrize("config", GPT2_CONFIGS)
def test_gpt2_step_graph_kinds_are_all_covered(gpt2_per_kind_errors, config):
    assert set(gpt2_per_kind_errors[config]) == set(_gpt2_kinds(config))


@pytest.mark.parametrize("config", ["gpt2-scalar-f32", "gpt2-ragged-f32"])
def test_gpt2_executor_matches_oracle_whole_step(config):
    """GraphExecutor over a whole f32 GPT-2 step graph (prefill, then two
    decode steps on the updated caches) against the JAX package's
    MilliGraph.eval: logits
    and every cache, 1e-5 of their scale."""
    iface = _gpt2_iface(config)
    ex = GraphExecutor(iface.milli, CPU)
    for S, pos, seed in _gpt2_runs(config):
        feeds = _feeds(iface, S, pos, seed)
        want = iface.ref_milli.eval(feeds)
        got = ex({n: to_device(a, CPU) for n, a in feeds.items()})
        for name, w in want.items():
            g = to_host(got[name])
            err = np.abs(g.astype(np.float64) - w.astype(np.float64)).max()
            assert err <= _tol(w), (config, name, err)
