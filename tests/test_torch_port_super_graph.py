"""The port's SuperGraph layer against the JAX package's, on the CPU.

The same job graphs, built by both packages from the same arguments,
run in the JAX package (its oracle, or `xla` on the CPU where its oracle
cannot run the graph) and in the port on device="cpu", in its "torch"
mode (the device path) and its "oracle" mode. Tolerances: tokens exact;
f32 values rtol 1e-5, atol 1e-6 (one f32 rounding order apart) unless a
test states another; images within 1 of 255 per pixel.

* JSON: `build_llm_supergraph`, `build_diffusion_supergraph` and
  `build_training_supergraph` give equal dicts in both packages, and a
  graph made by either package loads and runs in the other, and in a
  fresh interpreter.
* The LLM job on a tiny GPT-2 and a tiny GQA llama (f32, and bf16, whose
  caches the port makes in the graph's declared type): tokens equal the
  JAX package's job and the port's TextInferenceInterface greedy tokens.
* Capture taps (EvalBackend(capture=), GraphExecutor taps): the labels
  and values of the JAX package's EvalBackend("xla", capture=); a label
  that is not chosen is never reported; a replayed plan reports its taps;
  a tap and a subscribed link keep the value they had when assigned,
  whatever a later in-place cache write does.
* The node kinds of the reference's tests/test_super_graph.py:25-127,
  the audio nodes, and the phoneme nodes (equal to the JAX nodes').
* The diffusion job on the tiny f32 `sd` pipeline: each step's latents
  and the image against the JAX package's job and the port's
  ImageGenerationInterface.
* The training job: losses over 3 steps against the JAX package's, and a
  fresh-interpreter run.
* The StreamingObserver reports a subscribed bf16 torch tensor and a
  tensor map, and fails the job on a value it cannot encode.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (  # noqa: E402
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu.importers.recipes.llm.llama import (  # noqa: E402
    LlamaConfig, build_llama_step)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
import whisper_tensor_tpu.super_graph as jsg  # noqa: E402
import whisper_tensor_tpu.super_graph.image as jsg_image  # noqa: E402
import whisper_tensor_tpu.super_graph.llm as jsg_llm  # noqa: E402
import whisper_tensor_tpu.super_graph.nodes as jsg_nodes  # noqa: E402
import whisper_tensor_tpu.super_graph.training as jsg_training  # noqa: E402
from whisper_tensor_tpu_torch.backends.eval_backend import (  # noqa: E402
    EvalBackend, SymbolicObserver)
from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (  # noqa: E402
    GraphExecutor)
from whisper_tensor_tpu_torch.dtype import DType, to_host  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
import whisper_tensor_tpu_torch.super_graph as sg  # noqa: E402
import whisper_tensor_tpu_torch.super_graph.image as sg_image  # noqa: E402
import whisper_tensor_tpu_torch.super_graph.llm as sg_llm  # noqa: E402
import whisper_tensor_tpu_torch.super_graph.nodes as sg_nodes  # noqa: E402
import whisper_tensor_tpu_torch.super_graph.training as sg_training  # noqa: E402
from whisper_tensor_tpu_torch.server.scheduler import (  # noqa: E402
    ObserverSettings, Scheduler)
from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
BF16 = np.dtype(ml_dtypes.bfloat16)

# -- models -------------------------------------------------------------------

GPT2 = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=300,
                  n_positions=64)
GPT2_KW = dict(n_layers=2, n_kv_heads=2, max_len=64, head_dim=16)

E, I, V, D, L, MAX = 64, 96, 300, 16, 2, 32
LLAMA = LlamaConfig(num_hidden_layers=L, num_attention_heads=4,
                    num_key_value_heads=2, hidden_size=E,
                    intermediate_size=I, vocab_size=V, head_dim=D)
LLAMA_KW = dict(n_layers=L, n_kv_heads=2, max_len=MAX, head_dim=D)
_LLAMA_SHAPES = {"embed_tokens": (V, E), "lm_head": (V, E), "norm": (E,),
                 "q_proj": (4 * D, E), "k_proj": (2 * D, E),
                 "v_proj": (2 * D, E), "o_proj": (E, 4 * D),
                 "gate_proj": (I, E), "up_proj": (I, E),
                 "down_proj": (E, I)}


def _llama_weight(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = next(s for k, s in _LLAMA_SHAPES.items() if k in name)
    if len(shape) == 1:
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (rng.standard_normal(shape) * 0.08).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """{key: (JAX Model, port Model)} from one set of ONNX bytes each."""
    out = {}
    data = build_gpt2_step(random_gpt2_weights(GPT2), GPT2, max_len=64)
    out["gpt2"] = (JaxModel.new_from_onnx(data, name="m"),
                   Model.new_from_onnx(data, name="m"))
    for dt in ("F32", "BF16"):
        data = build_llama_step(_llama_weight, LLAMA, max_len=MAX,
                                dtype=JaxDType[dt])
        out["llama", dt] = (JaxModel.new_from_onnx(data, name="m"),
                            Model.new_from_onnx(data, name="m"))
    return out


class Recorder(sg.SuperObserver):
    """Records node names and every assigned value."""

    def __init__(self):
        self.nodes, self.assigned, self.progress = [], {}, []

    def on_node_executed(self, node, ms):
        self.nodes.append(node.name)

    def on_tensor_assigned(self, name, value):
        self.assigned.setdefault(name, []).append(value)

    def on_progress(self, node, fraction):
        self.progress.append(fraction)


def _port_ctx(models, mode="torch", **kw):
    return sg.ExecutionContext(models=models, backend_mode=mode,
                               device="cpu", **kw)


# -- JSON across packages -------------------------------------------------------

def _llm_pair(**kw):
    return (jsg_llm.build_llm_supergraph("m", "bytes", n_new=5, **kw),
            sg_llm.build_llm_supergraph("m", "bytes", n_new=5, **kw))


def _diffusion_pair(**kw):
    args = dict(steps=3, latent_hw=(16, 16), seed=5, bos_token_id=1,
                eos_token_id=2, seq_len=8, **kw)
    return (jsg_image.build_diffusion_supergraph("te", "unet", "vae", **args),
            sg_image.build_diffusion_supergraph("te", "unet", "vae", **args))


@pytest.mark.parametrize("kind", ["llm", "llm_bf16_cache", "diffusion",
                                  "diffusion_flow_v"])
def test_builders_give_the_jax_packages_json(kind):
    if kind == "llm":
        j, p = _llm_pair(**GPT2_KW)
    elif kind == "llm_bf16_cache":
        j, p = _llm_pair(cache_dtype=BF16, **LLAMA_KW)
    elif kind == "diffusion":
        j, p = _diffusion_pair()
    else:
        j, p = _diffusion_pair(schedule="rectified_flow",
                               prediction_type="v_prediction")
    assert p.to_json() == j.to_json()
    # nested Scan bodies survive both packages' loaders
    back = sg.SuperGraph.from_json(json.loads(j.dumps()))
    assert back.to_json() == j.to_json()
    assert jsg.SuperGraph.loads(p.dumps()).to_json() == j.to_json()


def test_each_packages_llm_json_runs_in_the_other(models):
    jm, pm = models["gpt2"]
    j, p = _llm_pair(**GPT2_KW)
    want = j.run(jsg.ExecutionContext(models={"m": jm}), {"text": "hi"})
    got = sg.SuperGraph.loads(j.dumps()).run(_port_ctx({"m": pm}),
                                            {"text": "hi"})
    back = jsg.SuperGraph.loads(p.dumps()).run(
        jsg.ExecutionContext(models={"m": jm}), {"text": "hi"})
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(back["tokens"], want["tokens"])
    assert got["text"] == want["text"] == back["text"]


def test_port_json_loads_and_runs_in_a_fresh_interpreter(tmp_path):
    """The port's graphs deserialize where no builder ran, and the LLM
    job runs there (device="cpu"), without jax."""
    j, p = _llm_pair(**GPT2_KW)
    (tmp_path / "llm.json").write_text(p.dumps())
    (tmp_path / "diff.json").write_text(_diffusion_pair()[1].dumps())
    (tmp_path / "step.onnx").write_bytes(
        build_gpt2_step(random_gpt2_weights(GPT2), GPT2, max_len=64))
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.super_graph import ExecutionContext, SuperGraph
import whisper_tensor_tpu_torch.super_graph.image
import whisper_tensor_tpu_torch.super_graph.llm
d = {str(tmp_path)!r}
diff = SuperGraph.from_json(json.load(open(d + '/diff.json')))
diff.validate()
g = SuperGraph.from_json(json.load(open(d + '/llm.json')))
m = Model.new_from_onnx_file(d + '/step.onnx', name='m')
out = g.run(ExecutionContext(models={{'m': m}}, device='cpu'), {{'text': 'hi'}})
assert 'jax' not in sys.modules and 'whisper_tensor_tpu' not in sys.modules
print('TOKENS', json.dumps([int(t) for t in out['tokens']]))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    jm = JaxModel.new_from_onnx((tmp_path / "step.onnx").read_bytes(),
                                name="m")
    want = j.run(jsg.ExecutionContext(models={"m": jm}), {"text": "hi"})
    got = json.loads(r.stdout.split("TOKENS", 1)[1])
    assert got == [int(t) for t in want["tokens"]]


# -- the LLM job ------------------------------------------------------------------

@pytest.mark.parametrize("key", ["gpt2", ("llama", "F32"), ("llama", "BF16")],
                         ids=["gpt2", "llama_f32", "llama_bf16"])
@pytest.mark.parametrize("mode", ["torch", "oracle"])
def test_llm_job_tokens_equal_the_jax_job_and_the_interface(models, key,
                                                            mode):
    jm, pm = models[key]
    kw = GPT2_KW if key == "gpt2" else LLAMA_KW
    n_new = 6
    jgraph = jsg_llm.build_llm_supergraph("m", "bytes", n_new=n_new, **kw)
    # the JAX package's oracle refuses a bf16 step graph's cache writes
    # (its caches are f32, ROADMAP C23): its xla mode runs that job
    jmode = "xla" if key == ("llama", "BF16") else "oracle"
    want = jgraph.run(jsg.ExecutionContext(models={"m": jm},
                                           backend_mode=jmode),
                      {"text": "hello"})
    obs = Recorder()
    got = sg.SuperGraph.from_json(jgraph.to_json()).run(
        _port_ctx({"m": pm}, mode, observer=obs), {"text": "hello"})
    assert got["tokens"].shape == (n_new,)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["text"] == want["text"]
    # every node observed: 4 top-level nodes, the Scan, the join, the
    # decode, and a decode step for each of the n_new - 1 iterations
    assert obs.nodes.count("LLMDecodeStepNode") == n_new - 1
    assert {"TokenizerLoadNode", "TokenizerEncodeNode", "LLMPrefillNode",
            "ConstNode", "ScanNode", "JoinTokensNode",
            "TokenizerDecodeNode"} <= set(obs.nodes)
    # the port's direct path, greedy, at the graph's cache type
    dt = DType.BF16 if key == ("llama", "BF16") else DType.F32
    iface = TextInferenceInterface(pm, max_len=kw["max_len"], cache_dtype=dt,
                                   prompt_buckets=(8, 16), device="cpu")
    prompt = np.asarray(ByteTokenizer().encode("hello"), np.int64)[None]
    np.testing.assert_array_equal(got["tokens"],
                                  iface.generate_tokens(prompt, n_new)[0])


def test_a_subscribed_link_keeps_the_value_it_had_when_assigned(models):
    """The prefill's caches are written in place by every later step
    (the port's cache writes write into the tensor they are handed): the
    prefill_state an observer received must still be the prefill's."""
    jm, pm = models["llama", "F32"]
    g = sg_llm.build_llm_supergraph("m", "bytes", n_new=6, **LLAMA_KW)
    obs = Recorder()
    g.run(_port_ctx({"m": pm}, observer=obs), {"text": "hello"})
    prefill = obs.assigned["prefill_state"][0]
    final = obs.assigned["final_state"][0]
    n_prompt = len("hello")
    k0 = prefill["cache_k_0"].numpy()
    # the prefill wrote rows 0..n_prompt-1 only; the decode steps wrote on
    assert np.abs(k0[:, :, :n_prompt]).max() > 0
    assert np.abs(k0[:, :, n_prompt:]).max() == 0
    assert np.abs(final["cache_k_0"].numpy()[:, :, n_prompt:n_prompt + 4]
                  ).max() > 0
    # and it equals a prefill run on its own
    feeds = {"input_ids": np.asarray([ByteTokenizer().encode("hello")]),
             "pos": np.asarray(0, np.int64)}
    for i in range(L):
        for kv in "kv":
            feeds[f"cache_{kv}_{i}"] = np.zeros((1, 2, MAX, D), np.float32)
    ref = pm.eval(feeds, device="cpu")
    for i in range(L):
        np.testing.assert_array_equal(prefill[f"cache_k_{i}"].numpy(),
                                      ref[f"new_cache_k_{i}"])


def test_observer_without_on_tensor_assigned_gets_no_snapshots():
    class Timings(sg.SuperObserver):
        def on_node_executed(self, node, ms):
            pass

    assert not Timings().subscribed("prefill_state")
    assert Recorder().subscribed("prefill_state")


# -- capture taps ---------------------------------------------------------------------

def _step_feeds(n=3, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    feeds = {"input_ids": rng.integers(3, 200, (1, n)).astype(np.int64),
             "pos": np.asarray(0, np.int64)}
    for i in range(L):
        for kv in "kv":
            feeds[f"cache_{kv}_{i}"] = np.zeros((1, 2, MAX, D), dtype)
    return feeds


def _labels(pm):
    """Three labels of the step graph: layer 0's attention output, a
    cache write's output and an input the graph reads."""
    names = [pm.graph.tensors[o].name for sop in pm.graph.ops
             for o in sop.outputs if o is not None]
    attn = next(n for n in names if "attn" in n.lower() or "attention"
                in n.lower())
    return [attn, "new_cache_k_0", "input_ids"]


class Taps(SymbolicObserver):
    def __init__(self):
        self.got = {}

    def on_tensor_assigned(self, graph, name, value):
        self.got.setdefault(name, []).append(value)


def test_taps_report_the_jax_packages_labels_and_values(models):
    from whisper_tensor_tpu.backends.eval_backend import (
        EvalBackend as JaxEvalBackend, SymbolicObserver as JaxObserver)

    jm, pm = models["llama", "F32"]
    labels = set(_labels(pm))

    class JaxTaps(JaxObserver):
        def __init__(self):
            self.got = {}

        def on_tensor_assigned(self, graph, name, value):
            self.got[name] = np.asarray(value)

    jobs, pobs = JaxTaps(), Taps()
    JaxEvalBackend("xla", observer=jobs, capture=labels).run(
        jm.graph, _step_feeds())
    be = EvalBackend("torch", observer=pobs, device="cpu", capture=labels)
    be.run(pm.graph, _step_feeds())
    assert set(pobs.got) == set(jobs.got) == labels
    for name in labels:
        np.testing.assert_allclose(to_host(pobs.got[name][0]),
                                   jobs.got[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_unchosen_labels_are_never_reported_and_replays_report_taps(models):
    jm, pm = models["llama", "F32"]
    attn = _labels(pm)[0]
    obs = Taps()
    be = EvalBackend("torch", observer=obs, device="cpu",
                     capture={attn, "no such label"})
    outs = [be.run(pm.graph, _step_feeds(seed=s)) for s in range(3)]
    assert set(obs.got) == {attn}
    assert len(obs.got[attn]) == 3              # the build, two replays
    ex = be._executor(pm.graph)[0]
    assert ex.tap_labels == [attn] and len(ex._plans) == 1
    # each replay's value is its own run's, not the first one's
    assert not torch.equal(obs.got[attn][0], obs.got[attn][1])
    ref = EvalBackend("oracle").run(pm.graph, _step_feeds(seed=2))
    np.testing.assert_allclose(outs[2]["logits"], ref["logits"], rtol=RTOL,
                               atol=ATOL)
    # without taps nothing is reported, and the executor has none
    plain = Taps()
    be2 = EvalBackend("torch", observer=plain, device="cpu")
    be2.run(pm.graph, _step_feeds())
    assert plain.got == {} and be2._executor(pm.graph)[0].tap_labels == []


def test_derived_backends_key_executors_by_the_taps_the_graph_holds(models):
    """Derived backends share executors by the chosen labels that the
    lowered graph holds: a set of names the graph lacks (link names) runs
    the untapped executor, two sets that differ only in such names share
    one, and past TAPPED_EXECUTORS tap sets the least recently used
    tapped executor is dropped while the untapped one stays."""
    from whisper_tensor_tpu_torch.backends.eval_backend import (
        TAPPED_EXECUTORS)

    jm, pm = models["llama", "F32"]
    g = pm.graph
    base = EvalBackend("torch", device="cpu")
    plain = base._executor(g)[0]
    assert base.derive(capture={"first_token", "prefill_state"})._executor(
        g)[0] is plain
    attn = _labels(pm)[0]
    one = base.derive(capture={attn, "first_token"})._executor(g)[0]
    assert one is not plain and one.tap_labels == [attn]
    assert base.derive(capture={attn})._executor(g)[0] is one
    names = sorted({g.tensors[o].name for sop in g.ops
                    for o in sop.outputs if o is not None} - {attn})
    for name in names[:TAPPED_EXECUTORS + 2]:
        base.derive(capture={name})._executor(g)
    tapped = [k for k in base._executors if k[1]]
    assert len(tapped) == TAPPED_EXECUTORS
    assert (g.id, frozenset({attn})) not in base._executors
    assert base._executor(g)[0] is plain
    # a dropped tap set is made again, and still reports its tap
    obs = Taps()
    base.derive(observer=obs, capture={attn}).run(g, _step_feeds())
    assert set(obs.got) == {attn}


def test_a_tap_is_a_snapshot_taken_where_its_value_was_made(models):
    """Tap the cache input and the written cache of one step, with the
    cache fed as a device tensor (written in place): the input's tap is
    the zeros it came in as, the output's the written values, on the
    build and on a replay."""
    jm, pm = models["llama", "F32"]
    milli, weights = pm.graph.to_milli()
    ex = GraphExecutor(milli, torch.device("cpu"),
                       taps=["cache_k_0", "new_cache_k_0"])
    w = {n: torch.from_numpy(pm.graph.store.get_numeric(n).numpy().copy())
         for n in weights}
    for run in range(2):
        feeds = {k: torch.from_numpy(v.copy())
                 for k, v in _step_feeds(seed=run).items()}
        cache = feeds["cache_k_0"]
        out, taps = ex.run({**w, **feeds})
        assert torch.count_nonzero(cache) > 0       # written in place
        assert torch.count_nonzero(taps["cache_k_0"]) == 0
        assert torch.equal(taps["new_cache_k_0"], cache)
        cache.zero_()                           # a later write elsewhere
        assert torch.count_nonzero(taps["new_cache_k_0"]) > 0


def test_subscribed_step_labels_reach_the_job_observer(models):
    """A label inside the step graph, subscribed on the job, is reported
    once per run of the step graph: the prefill and each decode step."""
    jm, pm = models["llama", "F32"]
    attn = _labels(pm)[0]
    g = sg_llm.build_llm_supergraph("m", "bytes", n_new=5, **LLAMA_KW)

    class Sub(Recorder):
        def subscribed(self, name):
            return name in (attn, "first_token")

    obs = Sub()
    g.run(_port_ctx({"m": pm}, observer=obs, capture_labels={attn}),
          {"text": "hello"})
    assert set(obs.assigned) == {attn, "first_token"}
    assert len(obs.assigned[attn]) == 5
    assert len(obs.assigned["first_token"]) == 1
    # the prefill's value is Model.eval's
    prompt = np.asarray([ByteTokenizer().encode("hello")], np.int64)
    feeds = _step_feeds()
    feeds["input_ids"] = prompt
    jobs = Taps()
    EvalBackend("oracle", observer=jobs).run(pm.graph, feeds)
    np.testing.assert_allclose(to_host(obs.assigned[attn][0]),
                               jobs.got[attn][0], rtol=RTOL, atol=ATOL)


# -- node kinds -------------------------------------------------------------------------

def _node_graphs(pkg):
    """The reference tests' node graphs (tests/test_super_graph.py:25-127),
    built with `pkg`'s classes: (graph, feeds, ctx kwargs) triples."""
    S, N = pkg, pkg.nodes
    out = []
    g = S.SuperGraph("tok")
    text_l = g.mark_input("text", g.link(S.LinkKind.STRING))
    tok_l, ids_l = g.link(S.LinkKind.TOKENIZER), g.link(S.LinkKind.TENSOR)
    out_l = g.link(S.LinkKind.STRING)
    g.add(N.TokenizerLoadNode(outputs={"tokenizer": tok_l}, source="bytes"))
    g.add(N.TokenizerEncodeNode(inputs={"tokenizer": tok_l, "text": text_l},
                                outputs={"tokens": ids_l}))
    g.add(N.TokenizerDecodeNode(inputs={"tokenizer": tok_l, "tokens": ids_l},
                                outputs={"text": out_l}))
    g.mark_output("round_trip", out_l)
    g.mark_output("ids", ids_l)
    out.append((g, {"text": "hello port"}))

    g = S.SuperGraph("cache")
    h = g.mark_input("hash", g.link(S.LinkKind.HASH))
    t = g.mark_input("tokens", g.link(S.LinkKind.TENSOR))
    st = g.mark_input("state", g.link(S.LinkKind.TENSOR_MAP))
    g.add(N.RNNCacheWriteNode(inputs={"hash": h, "tokens": t, "state": st}))
    rs, rl = g.link(S.LinkKind.TENSOR_MAP), g.link(S.LinkKind.TENSOR)
    t2 = g.mark_input("tokens2", g.link(S.LinkKind.TENSOR))
    g.add(N.RNNCacheReadNode(inputs={"hash": h, "tokens": t2},
                             outputs={"state": rs, "prefix_len": rl}))
    tv = g.mark_input("tensor", g.link(S.LinkKind.TENSOR))
    g.add(N.TensorCacheWriteNode(inputs={"tensor": tv}, key="w", store_id=3))
    tr = g.link(S.LinkKind.TENSOR)
    g.add(N.TensorCacheReadNode(outputs={"tensor": tr}, key="w", store_id=3))
    g.add(N.TensorPackCacheWriteNode(inputs={"tensors": st}, key="p"))
    pr = g.link(S.LinkKind.TENSOR_MAP)
    g.add(N.TensorPackCacheReadNode(outputs={"tensors": pr}, key="p"))
    for name, lid in (("state", rs), ("prefix_len", rl), ("read", tr),
                      ("pack", pr)):
        g.mark_output(name, lid)
    out.append((g, {"hash": np.asarray(7), "tokens": np.arange(4),
                    "tokens2": np.arange(6),
                    "state": {"h": np.ones(3, np.float32)},
                    "tensor": np.full((2, 2), 3.0, np.float32)}))

    body = S.SuperGraph("body")
    b_acc = body.mark_input("acc", body.link(S.LinkKind.TENSOR))
    b_x = body.mark_input("x", body.link(S.LinkKind.TENSOR))
    b_out, b_y = body.link(S.LinkKind.TENSOR), body.link(S.LinkKind.TENSOR)
    body.add(N.ReportProgressNode(inputs={"value": b_x},
                                  outputs={"value": b_y}))
    body.add(_Accumulate(pkg)(inputs={"acc": b_acc, "x": b_y},
                              outputs={"out": b_out}))
    body.mark_output("acc_out", b_out)
    body.mark_output("y", b_y)
    g = S.SuperGraph("scan")
    init = g.mark_input("init", g.link(S.LinkKind.TENSOR))
    xs = g.mark_input("xs", g.link(S.LinkKind.TENSOR))
    fin, ys = g.link(S.LinkKind.TENSOR), g.link(S.LinkKind.TENSOR)
    scan = N.ScanNode(inputs={"init": init, "xs": xs},
                      outputs={"final_acc": fin, "ys": ys},
                      state=[("init", "acc", "acc_out")],
                      scan_inputs=[("xs", "x", 0)],
                      scan_outputs=[("y", "ys", 0)])
    scan.body = body
    g.add(scan)
    g.mark_output("final", fin)
    g.mark_output("ys", ys)
    out.append((g, {"init": np.zeros((), np.float32),
                    "xs": np.asarray([0.25, 0.5, 0.75], np.float32)}))
    return out


_ACCUMULATE = {}


def _Accumulate(pkg):
    """acc + x, registered once in each package's node registry."""
    if pkg.__name__ not in _ACCUMULATE:
        class AccumulateNode(pkg.nodes.SuperNode):
            def execute(self, ctx, ins):
                return {"out": np.asarray(ins["acc"]) + np.asarray(ins["x"])}

        AccumulateNode.__name__ = f"AccumulateNode_{len(_ACCUMULATE)}"
        pkg.nodes.register_node(AccumulateNode)
        _ACCUMULATE[pkg.__name__] = AccumulateNode
    return _ACCUMULATE[pkg.__name__]


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("which", [0, 1, 2], ids=["tokenizer", "caches",
                                                   "scan_progress"])
@pytest.mark.parametrize("mode", ["torch", "oracle"])
def test_node_kinds_give_the_jax_packages_results(which, mode):
    (jg, feeds), = [_node_graphs(jsg)[which]]
    pg, _ = _node_graphs(sg)[which]
    jobs, pobs = Recorder(), Recorder()

    class JaxRecorder(jsg.SuperObserver):
        def on_progress(self, node, f):
            jobs.progress.append(f)

    want = jg.run(jsg.ExecutionContext(observer=JaxRecorder()), dict(feeds))
    got = pg.run(sg.ExecutionContext(backend_mode=mode, device="cpu",
                                     observer=pobs), dict(feeds))
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])
    assert pobs.progress == jobs.progress


def test_audio_nodes_and_the_phoneme_nodes():
    sr = 16000
    clip = sg.AudioClip(np.sin(np.linspace(0, 440 * 2 * np.pi, sr)
                               ).astype(np.float32), sr)
    jclip = jsg.AudioClip(clip.samples, sr)
    ctx, jctx = sg.ExecutionContext(backend_mode="oracle"), \
        jsg.ExecutionContext()
    for name, params in (("AudioClipToMelSpectrogramNode", {}),
                         ("AudioClipToMelSpectrogramNode",
                          {"sample_rate": 8000, "pad_to_frames": 30}),
                         ("AudioClipToTensorNode", {"sample_rate": 8000})):
        got = getattr(sg_nodes, name)(**params).execute(ctx, {"audio": clip})
        want = getattr(jsg_nodes, name)(**params).execute(
            jctx, {"audio": jclip})
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    clip_out = sg_nodes.TensorToAudioClipNode(sample_rate=100).execute(
        ctx, {"tensor": torch.ones(1, 5)})["audio"]
    assert clip_out.sample_rate == 100 and clip_out.samples.shape == (5,)
    params = {"language": "en-us", "phoneme_id_map": {
        "^": [1], "$": [2], "_": [0], "h": [5], "a": [6], "ɪ": [7]},
        "vocab": {"h": 3, "a": 4, "ɪ": 5}}
    for name in ("TextToPhonemesNode", "PiperPhonemesToTensorNode",
                 "KokoroPhonemesToTensorNode"):
        d = {"type": name, "name": name, "inputs": {}, "outputs": {},
             "params": params}
        node, jnode = (m.SuperNode.from_json(d) for m in (sg_nodes, jsg_nodes))
        ins = {"text": "Hi, 42 cats!", "phonemes": "haɪ, h"}
        got, want = node.execute(ctx, ins), jnode.execute(jctx, ins)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    f5 = sg_nodes.F5TextToTensorNode(vocab={"a": 3, "b": 4})
    np.testing.assert_array_equal(f5.execute(ctx, {"text": "abz"})["tokens"],
                                  [[3, 4, 0]])


# -- the diffusion job --------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_pair(tmp_path_factory):
    from test_diffusers_loader import _write_sd_pipeline
    from whisper_tensor_tpu.importers.loaders import \
        identify_and_load as jax_load
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load

    d = _write_sd_pipeline(str(tmp_path_factory.mktemp("sd")))
    kw = dict(dtype="f32", height=128, width=128)
    return jax_load(d, **kw), identify_and_load(d, **kw)


def _sd_graph(pkg_image, spec, bundle, steps, seed):
    m = bundle.models
    return pkg_image.build_diffusion_supergraph(
        m[spec["text_encoder"]].name, m[spec["unet"]].name,
        m[spec["vae"]].name, steps=steps,
        latent_channels=spec["latent_channels"], latent_hw=(16, 16),
        seed=seed, bos_token_id=spec.get("bos_token_id", 49406),
        eos_token_id=spec.get("eos_token_id", 49407),
        seq_len=spec.get("seq_len", 77))


def test_diffusion_job_steps_and_image_match_the_jax_job_and_interface(
        sd_pair):
    from whisper_tensor_tpu_torch.interfaces.image_gen import (
        ImageGenConfig, image_interface_from_bundle)

    jb, pb = sd_pair
    spec = pb.interfaces["image"]
    steps, seed = 2, 3
    iface = image_interface_from_bundle(pb, device="cpu")
    ids = iface.encode_prompt("a red cube")
    nids = iface.encode_prompt("")
    feeds = {"prompt_ids": ids, "negative_ids": nids}
    jgraph = _sd_graph(jsg_image, spec, jb, steps, seed)
    jmodels = {m.name: m for m in jb.models.values()}
    pmodels = {m.name: m for m in pb.models.values()}
    want = jgraph.run(jsg.ExecutionContext(models=jmodels,
                                           backend_mode="oracle"), feeds)
    graph = sg.SuperGraph.from_json(jgraph.to_json())
    obs = Recorder()
    with torch.inference_mode():
        got = graph.run(sg.ExecutionContext(models=pmodels, device="cpu",
                                            observer=obs), feeds)
    traj, jtraj = got["latent_trajectory"], want["latent_trajectory"]
    assert traj.shape == jtraj.shape == (steps, 1, 4, 16, 16)
    # each step's latents: f32 within 1e-5 of the latents' scale (a
    # UNet of convolutions and attention summed in another order)
    for s in range(steps):
        scale = float(np.abs(jtraj[s]).max())
        assert np.abs(traj[s] - jtraj[s]).max() <= 1e-5 * scale, s
    assert len(obs.assigned["step_latents"]) == steps
    np.testing.assert_array_equal(to_host(obs.assigned["step_latents"][-1]),
                                  traj[-1])
    d = np.abs(got["image"].pixels.astype(int)
               - want["image"].pixels.astype(int))
    assert d.max() <= 1, d.max()
    ref = iface.run("a red cube", cfg=ImageGenConfig(
        steps=steps, height=128, width=128, seed=seed))
    d = np.abs(got["image"].pixels.astype(int) - ref.pixels.astype(int))
    assert d.max() <= 1, d.max()
    assert got["image"].pixels.std() > 1.0


# -- the training job -------------------------------------------------------------------

def _training_job():
    from whisper_tensor_tpu.milli import MilliGraph
    from whisper_tensor_tpu.milli.ops import MatMul, SimpleUnary
    from whisper_tensor_tpu.milli.optimizers import (OptimizerKind,
                                                     OptimizerOptions)
    from whisper_tensor_tpu.milli.training_graph import build_training_graph

    rng = np.random.default_rng(0)
    g = MilliGraph("mlp")
    x, w1, w2 = g.add_input("x"), g.add_input("w1"), g.add_input("w2")
    h = g.op1(SimpleUnary("tanh"), g.op1(MatMul(), x, w1))
    g.mark_output("pred", g.op1(MatMul(), h, w2))
    params = {"w1": rng.standard_normal((6, 8)).astype(np.float32),
              "w2": rng.standard_normal((8, 3)).astype(np.float32)}
    train, meta = build_training_graph(
        g, list(params), "pred", loss="mse",
        optimizer=OptimizerOptions(OptimizerKind.ADAMW, lr=5e-2))
    feeds = {"init_state": jsg_training.initial_train_state(meta, params),
             "batches_x": rng.standard_normal((3, 4, 6)).astype(np.float32),
             "batches_target": rng.standard_normal((3, 4, 3)).astype(
                 np.float32)}
    return jsg_training.build_training_supergraph(train, meta,
                                                  ["x", "target"]), feeds


@pytest.mark.parametrize("mode", ["torch", "oracle"])
def test_training_job_losses_match_the_jax_job(mode):
    jgraph, feeds = _training_job()
    want = jgraph.run(jsg.ExecutionContext(backend_mode="oracle"), feeds)
    got = sg.SuperGraph.loads(jgraph.dumps()).run(
        sg.ExecutionContext(backend_mode=mode, device="cpu"), feeds)
    assert got["losses"].shape == (3,)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    assert got["losses"][-1] < got["losses"][0]
    for k, v in want["final_state"].items():
        np.testing.assert_allclose(np.asarray(got["final_state"][k]),
                                   np.asarray(v), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert float(got["final_state"]["step"]) == 4.0


def test_training_builder_and_initial_state_match_the_jax_package():
    from whisper_tensor_tpu_torch.milli import MilliGraph
    from whisper_tensor_tpu_torch.milli.ops import MatMul, SimpleUnary
    from whisper_tensor_tpu_torch.milli.optimizers import (OptimizerKind,
                                                           OptimizerOptions)
    from whisper_tensor_tpu_torch.milli.training_graph import (
        build_training_graph)

    jgraph, feeds = _training_job()
    g = MilliGraph("mlp")
    x, w1, w2 = g.add_input("x"), g.add_input("w1"), g.add_input("w2")
    h = g.op1(SimpleUnary("tanh"), g.op1(MatMul(), x, w1))
    g.mark_output("pred", g.op1(MatMul(), h, w2))
    params = {k: feeds["init_state"][k] for k in ("w1", "w2")}
    train, meta = build_training_graph(
        g, list(params), "pred", loss="mse",
        optimizer=OptimizerOptions(OptimizerKind.ADAMW, lr=5e-2))
    pgraph = sg_training.build_training_supergraph(train, meta,
                                                   ["x", "target"])
    assert pgraph.to_json() == jgraph.to_json()
    _same(sg_training.initial_train_state(meta, params),
          feeds["init_state"])


def test_training_job_runs_in_a_fresh_interpreter(tmp_path):
    jgraph, feeds = _training_job()
    (tmp_path / "job.json").write_text(jgraph.dumps())
    np.savez(tmp_path / "feeds.npz", x=feeds["batches_x"],
             y=feeds["batches_target"],
             **{f"s_{k}": v for k, v in feeds["init_state"].items()})
    code = f"""
import json, sys
import numpy as np
sys.path.insert(0, {ROOT!r})
from whisper_tensor_tpu_torch.super_graph import ExecutionContext, SuperGraph
import whisper_tensor_tpu_torch.super_graph.training
sg = SuperGraph.from_json(json.load(open({str(tmp_path / 'job.json')!r})))
z = np.load({str(tmp_path / 'feeds.npz')!r})
state = {{k[2:]: z[k] for k in z.files if k.startswith('s_')}}
out = sg.run(ExecutionContext(device='cpu'),
             {{'init_state': state, 'batches_x': z['x'],
               'batches_target': z['y']}})
print('LOSSES', json.dumps([float(v) for v in out['losses']]))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = jgraph.run(jsg.ExecutionContext(backend_mode="oracle"), feeds)
    got = json.loads(r.stdout.split("LOSSES", 1)[1])
    np.testing.assert_allclose(got, want["losses"], rtol=RTOL, atol=ATOL)


# -- the streaming observer ---------------------------------------------------------------

def _job_reports(fn, subs):
    sched = Scheduler()
    try:
        sched.submit(fn, ObserverSettings(tensor_subscriptions=set(subs)))
        reports = []
        while True:
            r = sched.reports.get(timeout=60)
            reports.append(r)
            if r["type"] in ("job_result", "job_error"):
                return reports
    finally:
        sched.shutdown()


def test_streaming_observer_reports_a_subscribed_bf16_torch_tensor():
    """The reference's observer drops what numpy cannot take (a bf16 or a
    device torch tensor) without a word; the port's reports it."""
    value = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(
        torch.bfloat16)

    def job(obs):
        obs.on_tensor_assigned("h", value)
        obs.on_tensor_assigned("m", {"a": value, "b": np.ones(2)})
        obs.on_tensor_assigned("ignored", value)
        return "done"

    reports = _job_reports(job, {"h", "m"})
    assigned = [r for r in reports if r["type"] == "tensor_assigned"]
    assert [r["link"] for r in assigned] == ["h", "m"]
    t = assigned[0]["tensor"]
    assert t["shape"] == [2, 3] and t["dtype"] == "bfloat16"
    assert (t["lo"], t["hi"]) == (0.0, 5.0)
    assert set(assigned[1]["tensors"]) == {"a", "b"}
    assert assigned[1]["tensors"]["a"]["hi"] == 5.0
    assert reports[-1] == {"type": "job_result", "job": 1, "result": "done"}


def test_the_scheduler_keeps_nothing_of_a_finished_job():
    """A finished job's closure (a super-graph job's models and their
    device weights) is freed when the job ends, not when the next job
    arrives."""
    import gc
    import weakref

    class Held:
        pass

    held = Held()
    ref = weakref.ref(held)

    def job(obs, held=held):
        return "done"

    sched = Scheduler()
    try:
        sched.submit(job)
        del job, held
        while sched.reports.get(timeout=60)["type"] != "job_result":
            pass
        for _ in range(100):
            gc.collect()
            if ref() is None:
                break
            time.sleep(0.01)
        assert ref() is None
    finally:
        sched.shutdown()


def test_streaming_observer_fails_the_job_on_a_value_it_cannot_encode():
    def job(obs):
        obs.on_tensor_assigned("text", "not a tensor")
        return "unreachable"

    reports = _job_reports(job, {"text"})
    assert reports[-1]["type"] == "job_error"
    assert "not a tensor" in reports[-1]["error"]
    assert not [r for r in reports if r["type"] == "tensor_assigned"]
