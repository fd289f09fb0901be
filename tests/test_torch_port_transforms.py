"""The port's own milli-graph pass pair_cache_writes, on the CPU.

The recipes write a layer's K and V caches with two DynUpdateSlice nodes
that share their start; pair_cache_writes merges them into one KVWrite
node, one launch of the cache-write kernel on the card. Checked here: on
the port's llama (GQA), GPT-2 and Qwen3 (qk_norm) step graphs, with a
scalar and a per-row start, every layer's two writes merge and none is
left; the text interface runs the merged graph and keeps `milli` the JAX
package's graph; hand-built graphs do not merge when the starts, the
caches' shapes or types, the updates' shapes or the axes differ, or when
a node between the two writes reads the first; and a merged graph gives
the unmerged one's outputs bit for bit (the numpy oracle and the
executor). The port's recipes build every graph; weights and inputs come
from numpy with fixed seeds. The JAX package is not needed.
"""

import zlib

import numpy as np
import pytest
import torch

from whisper_tensor_tpu_torch.backends.torch_exec.compiler import GraphExecutor
from whisper_tensor_tpu_torch.dtype import DType, to_device, to_host
from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
    LlamaConfig, build_llama_step)
from whisper_tensor_tpu_torch.interfaces.text import TextInferenceInterface
from whisper_tensor_tpu_torch.milli.ir import MilliGraph
from whisper_tensor_tpu_torch.milli.ops import (Cast, DynUpdateSliceMilli,
                                                KVWriteMilli)
from whisper_tensor_tpu_torch.milli.transforms import pair_cache_writes
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.tensor_info import TensorInfo

CPU = torch.device("cpu")
MAX_LEN = 32
LAYERS = 2
LLAMA = LlamaConfig(num_hidden_layers=LAYERS, num_attention_heads=4,
                    num_key_value_heads=2, hidden_size=64,
                    intermediate_size=96, vocab_size=97, head_dim=16)
QWEN3 = LlamaConfig(num_hidden_layers=LAYERS, num_attention_heads=4,
                    num_key_value_heads=2, hidden_size=64,
                    intermediate_size=96, vocab_size=97, head_dim=16,
                    model_type="qwen3", qk_norm=True)
GPT2 = GPT2Config(n_layer=LAYERS, n_head=2, n_embd=32, vocab_size=97,
                  n_positions=MAX_LEN)


def _llama_weights(cfg):
    E, I, V, D = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.hd)
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    shapes = {"embed": (V, E), "lm_head": (V, E), "q_proj": (Hq * D, E),
              "o_proj": (E, Hq * D), "k_proj": (Hkv * D, E),
              "v_proj": (Hkv * D, E), "gate_proj": (I, E),
              "up_proj": (I, E), "down_proj": (E, I), "q_norm": (D,),
              "k_norm": (D,)}

    def get(name):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        for key, s in shapes.items():
            if key in name:
                scale = 1.0 if len(s) == 1 else 0.1
                return (scale * rng.standard_normal(s)).astype(np.float32)
        return (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    return get


def _model(family, per_row, dtype=DType.F32):
    if family == "gpt2":
        data = build_gpt2_step(random_gpt2_weights(GPT2), GPT2,
                               max_len=MAX_LEN, dtype=dtype,
                               pos_per_row=per_row)
    else:
        cfg = QWEN3 if family == "qwen3" else LLAMA
        data = build_llama_step(_llama_weights(cfg), cfg, max_len=MAX_LEN,
                                dtype=dtype, pos_per_row=per_row)
    return Model.new_from_onnx(data)


def _kinds(milli):
    return [n.op.KIND for n in milli.nodes]


GRAPHS = [(f, r) for f in ("llama", "gpt2", "qwen3") for r in (False, True)]


@pytest.mark.parametrize("family,per_row", GRAPHS)
def test_every_layer_s_two_cache_writes_merge(family, per_row):
    """One KVWrite a layer, none of the recipes' DynUpdateSlice left:
    cache_k_i, its update, cache_v_i, its update and pos in, the graph's
    new_cache_k_i and new_cache_v_i out."""
    milli, _ = _model(family, per_row).graph.to_milli()
    assert _kinds(milli).count("DynUpdateSlice") == 2 * LAYERS
    before = list(milli.nodes)
    assert pair_cache_writes(milli) == LAYERS
    assert "DynUpdateSlice" not in _kinds(milli)
    assert len(milli.nodes) == len(before) - LAYERS
    writes = [n for n in milli.nodes if n.op.KIND == "KVWrite"]
    assert len(writes) == LAYERS
    for i, node in enumerate(writes):
        ck, _, cv, _, pos = node.inputs
        assert (ck, cv, pos) == (milli.inputs[f"cache_k_{i}"],
                                 milli.inputs[f"cache_v_{i}"],
                                 milli.inputs["pos"])
        assert node.outputs == [milli.outputs[f"new_cache_k_{i}"],
                                milli.outputs[f"new_cache_v_{i}"]]
        assert node.op.axis == 2
    # the other nodes are the same objects, in the same order
    assert [n for n in milli.nodes if n.op.KIND != "KVWrite"] == [
        n for n in before if n.op.KIND != "DynUpdateSlice"]
    assert pair_cache_writes(milli) == 0          # nothing left to pair


@pytest.mark.parametrize("family,per_row", [("llama", False),
                                            ("gpt2", True), ("qwen3", True)])
def test_the_interface_runs_the_merged_graph(family, per_row):
    """The executor's graph holds the KVWrite nodes; `milli` keeps the
    two writes a layer, node for node the JAX package's graph."""
    iface = TextInferenceInterface(_model(family, per_row), max_len=MAX_LEN,
                                   prompt_buckets=(8,), device="cpu")
    assert _kinds(iface._exec.graph).count("KVWrite") == LAYERS
    assert "DynUpdateSlice" not in _kinds(iface._exec.graph)
    assert _kinds(iface.milli).count("DynUpdateSlice") == 2 * LAYERS
    assert "KVWrite" not in _kinds(iface.milli)


def _feeds(milli, model, family, S, pos, seed, np_dt):
    rng = np.random.default_rng(seed)
    vocab = 97
    feeds = {"input_ids": rng.integers(0, vocab, (2, S)).astype(np.int64),
             "pos": np.asarray(pos, np.int64)}
    heads, hd = ((GPT2.n_head, GPT2.n_embd // GPT2.n_head)
                 if family == "gpt2" else (LLAMA.num_key_value_heads,
                                           LLAMA.hd))
    _, weight_inputs = model.graph.to_milli()
    for name in milli.inputs:
        if name.startswith("cache_"):
            feeds[name] = rng.standard_normal(
                (2, heads, MAX_LEN, hd)).astype(np_dt)
        elif name in weight_inputs:
            feeds[name] = model.graph.store.get_numeric(
                weight_inputs[name]).numpy()
    return feeds


# (S, scalar pos, per-row pos, seed): a prefill, then decode steps, the
# last at the cache's end (whole graphs take positions their tables hold;
# tests/test_torch_port_kv_write.py covers starts that clamp)
RUNS = [(8, 3, [3, 0], 1), (1, 17, [17, 9], 2), (1, MAX_LEN - 1, [5, 31], 3)]


@pytest.mark.parametrize("family,per_row", GRAPHS)
@pytest.mark.parametrize("dtype", [DType.F32, DType.BF16])
def test_the_merged_graph_gives_the_same_bits(family, per_row, dtype):
    """The merged graph's logits and every cache, bit for bit the
    unmerged graph's, through the executor (the lowerings on the CPU)
    and, at f32, through the numpy oracle."""
    model = _model(family, per_row, dtype)
    plain, _ = model.graph.to_milli()
    merged, _ = model.graph.to_milli()
    assert pair_cache_writes(merged) == LAYERS
    np_dt = dtype.to_numpy()
    for S, pos, rows, seed in RUNS:
        feeds = _feeds(plain, model, family, S, rows if per_row else pos,
                       seed, np_dt)
        pairs = [[{n: to_host(t) for n, t in GraphExecutor(g, CPU)(
            {n: to_device(a, CPU) for n, a in feeds.items()}).items()}
            for g in (plain, merged)]]
        if dtype is DType.F32:
            pairs.append([plain.eval(feeds), merged.eval(feeds)])
        for want, got in pairs:
            assert got.keys() == want.keys()
            for n, a in got.items():
                assert a.tobytes() == want[n].tobytes(), (n, S, pos)


# -- hand-built graphs: what does not merge -------------------------------

def _writes(k_cache=((2, 3, 8, 4), DType.F32), v_cache=None,
            k_upd=None, v_upd=None, second_start="pos", second_axis=2,
            reader_between=False):
    """Two cache writes, K then V, as the recipes emit them; the
    arguments change one thing about the second."""
    g = MilliGraph("writes")
    v_cache = v_cache or k_cache

    def info(spec):
        return None if spec is None else TensorInfo.shaped(spec[1], spec[0])

    ck = g.add_input("cache_k", info(k_cache))
    cv = g.add_input("cache_v", info(v_cache))
    uk = g.add_input("update_k", info(k_upd))
    uv = g.add_input("update_v", info(v_upd))
    pos = g.add_input("pos", TensorInfo.shaped(DType.I64, [2]))
    other = g.add_input("pos2", TensorInfo.shaped(DType.I64, [2]))
    nk = g.op1(DynUpdateSliceMilli(axis=2), ck, uk, pos)
    if reader_between:
        g.mark_output("read", g.op1(Cast(dtype=DType.F32), nk))
    nv = g.op1(DynUpdateSliceMilli(axis=second_axis), cv, uv,
               pos if second_start == "pos" else other)
    g.mark_output("new_cache_k", nk)
    g.mark_output("new_cache_v", nv)
    return g


@pytest.mark.parametrize("kw,merges", [
    ({}, 1),
    ({"k_upd": ((2, 3, 1, 4), DType.F32),
      "v_upd": ((2, 3, 1, 4), DType.F32)}, 1),
    ({"second_start": "pos2"}, 0),                            # starts
    ({"v_cache": ((2, 3, 16, 4), DType.F32)}, 0),             # cache shape
    ({"v_cache": ((2, 3, 8, 4), DType.BF16)}, 0),             # cache type
    ({"k_upd": ((2, 3, 1, 4), DType.F32),
      "v_upd": ((2, 3, 2, 4), DType.F32)}, 0),                # update shape
    ({"k_upd": ((2, 3, 1, 4), DType.F32),
      "v_upd": ((2, 3, 1, 4), DType.BF16)}, 0),               # update type
    ({"second_axis": 1}, 0),                                  # axis
    ({"k_cache": ((2, 8, 12), DType.F32)}, 0),                # 3-D caches
    ({"reader_between": True}, 0),          # a node reads the first write
], ids=["pair", "pair-known-updates", "starts", "cache-shape", "cache-type",
        "update-shape", "update-type", "axis", "3-D", "read-between"])
def test_writes_merge_only_when_they_may(kw, merges):
    g = _writes(**kw)
    kinds = _kinds(g)
    assert pair_cache_writes(g) == merges
    if merges:
        assert _kinds(g) == ["KVWrite"]
        assert isinstance(g.nodes[0].op, KVWriteMilli)
    else:
        assert _kinds(g) == kinds


def test_a_merged_hand_built_pair_evaluates_as_its_two_writes():
    rng = np.random.default_rng(4)
    feeds = {"cache_k": rng.standard_normal((2, 3, 8, 4)).astype(np.float32),
             "cache_v": rng.standard_normal((2, 3, 8, 4)).astype(np.float32),
             "update_k": rng.standard_normal((2, 3, 2, 4)).astype(np.float32),
             "update_v": rng.standard_normal((2, 3, 2, 4)).astype(np.float32),
             "pos": np.asarray([5, 0], np.int64),
             "pos2": np.asarray([0, 0], np.int64)}
    g = _writes()
    want = g.eval(feeds)
    assert pair_cache_writes(g) == 1
    got = g.eval(feeds)
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].tobytes() == want[n].tobytes(), n
