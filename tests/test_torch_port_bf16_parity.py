"""Where the bf16 GPT-2 of the int8 batcher parity test parts between the
JAX package and the port, on the CPU.

The graph is the one of test_torch_port_batching.py's
test_int8_gpt2_of_head_dim_64_at_a_bf16_cache_matches_the_jax_batcher
(2 layers, n_embd 128, 2 heads of 64, vocab 521, sharp_gpt2_weights, a
bf16 per-row-position step graph), fed its 23-token prompt and four of
the JAX batcher's tokens as one teacher-forced prefill. Both packages'
milli graphs run it, the JAX package's jitted with every node's output
captured, the port's through its executor, and each node's output is
held against the other's.

The test checks what holds at XLA's default flags: every node before
the first LayerNorm agrees bit for bit, and that LayerNorm is the first
node to part (XLA keeps the embedding sum that feeds it in f32 across
the fused chain; the port rounds it to bf16, as the precision contract
of docs/architecture.md:60-62 says). The rest of the probe prints a
report, which the parity test's tolerance rests on:

    python tests/test_torch_port_bf16_parity.py

  * node by node, unquantized and int8, at XLA's default flags and with
    --xla_allow_excess_precision=false (a child process), the port as
    it is and with its prefill and decode attention swapped for the
    dense path that the JAX package's CPU run takes;
  * how many int8 values and scales the JAX package's quantize_int8
    (its native C++ path where built, -ffast-math) gives apart from its
    numpy path, which the port copies;
  * for the three prompts and the JAX batcher's tokens, teacher-forced:
    the JAX logits' top-two margin at each step, and the largest |logit|
    difference over the step's largest |logit|, the port against the
    JAX package and the JAX package against itself without excess
    precision.
"""

import json
import os
import subprocess
import sys

if __name__ == "__main__":          # the report: the suite's set-up
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from test_torch_port_batching import sharp_gpt2_weights  # noqa: E402
from whisper_tensor_tpu.backends.xla.compiler import (  # noqa: E402
    _trace_graph, ensure_x64)
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (  # noqa: E402
    GPT2Config, build_gpt2_step)
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxTextInterface)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    TextInferenceInterface)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402

VOCAB = 521
# the JAX batcher's first four tokens after the 23-token prompt
FORCED = [69, 81, 199, 498]


def _onnx():
    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=128, vocab_size=VOCAB,
                     n_positions=128)
    return build_gpt2_step(sharp_gpt2_weights(cfg), cfg, max_len=128,
                           dtype=JaxDType.BF16, pos_per_row=True)


def _prompts():
    gen = np.random.default_rng(31)
    return [gen.integers(0, VOCAB, (n,)).astype(np.int64)
            for n in (5, 23, 40)]


def _host(t):
    a = np.asarray(t.float() if isinstance(t, torch.Tensor)
                   and t.dtype == torch.bfloat16 else t)
    return a.astype(np.float32) if a.dtype.kind in "fV" else a


def _dense_attention(monkeypatch):
    """The port's prefill and decode attention through its dense path
    (the JAX package's CPU path: normalized probabilities rounded to
    bf16), in place of the kernels' plain versions."""
    import whisper_tensor_tpu_torch.milli.ops.attention as lowering

    def dense(q, k, v, scale, pos_bound=None):
        pos = pos_bound.reshape(-1).expand(q.shape[0])
        mask = lowering.position_mask(pos, q.shape[2], k.shape[2])
        op = lowering.AttentionMilli(scale=scale)
        return lowering.attention(op, [q, k, v, mask], None, None)[0]

    monkeypatch(lowering, "flash_attention", dense)
    monkeypatch(lowering, "decode_attention",
                lambda q, k, v, pos, scale: dense(q, k, v, scale, pos))


def nodes_apart(quantize=None, dense=False):
    """[(node index, kind, max |difference|, differing elements)] of the
    nodes whose outputs differ, in graph order, and the kinds of all."""
    ensure_x64()
    patched = []
    if dense:
        def monkeypatch(mod, name, value):
            patched.append((mod, name, getattr(mod, name)))
            setattr(mod, name, value)
        _dense_attention(monkeypatch)
    try:
        data = _onnx()
        seq = np.concatenate([_prompts()[1], FORCED])[None]
        kw = dict(max_len=128, quantize=quantize, prompt_buckets=(32,))
        ref = JaxTextInterface(JaxModel.new_from_onnx(data),
                               cache_dtype=JaxDType.BF16, **kw)
        port = TextInferenceInterface(Model.new_from_onnx(data),
                                      cache_dtype=DType.BF16, device="cpu",
                                      **kw)
        jm, pm = ref.milli, port.milli
        assert [n.op.KIND for n in jm.nodes] == [n.op.KIND for n in pm.nodes]
        feeds = {"input_ids": torch.from_numpy(seq),
                 "pos": torch.zeros(1, dtype=torch.int64)}
        feeds.update(zip(port.cache_in_names, port.fresh_cache(1)))
        feeds.update(port._weights())
        _, got = port._exec.__class__(pm, port.device)._build(
            [feeds[n] for n in pm.inputs])
        jfeeds = {"input_ids": jnp.asarray(seq),
                  "pos": jnp.zeros(1, jnp.int64)}
        jfeeds.update(zip(ref.cache_in_names, ref.fresh_cache(1)))
        jfeeds.update(zip(ref.weight_names, ref._weights()))
        tids = [t for n in jm.nodes for t in n.outputs]
        out = jax.jit(_trace_graph(jm, {}, capture_tids=tids))(
            *[jfeeds[n] for n in jm.inputs])
        want = dict(zip(tids, out[len(jm.outputs):]))
    finally:
        for mod, name, value in patched:
            setattr(mod, name, value)
    apart = []
    for k, (jn, pn) in enumerate(zip(jm.nodes, pm.nodes)):
        for jt, pt in zip(jn.outputs, pn.outputs):
            if pt not in got:
                continue
            a, b = _host(want[jt]), _host(got[pt])
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            if d.size and d.max() > 0:
                apart.append((k, jn.op.KIND, float(d.max()),
                              int((d > 0).sum())))
                break
    return apart, [n.op.KIND for n in jm.nodes]


def test_the_first_node_to_part_is_the_first_layer_norm():
    """At XLA's default flags every node before the first LayerNorm
    agrees bit for bit, and that LayerNorm is the first to part."""
    apart, kinds = nodes_apart()
    assert apart, "the bf16 graphs agree at every node"
    assert apart[0][:2] == (kinds.index("LayerNorm"), "LayerNorm"), apart[0]


# -- the report ----------------------------------------------------------

def _batcher_tokens():
    from whisper_tensor_tpu.server.batching import ContinuousBatcher

    b = ContinuousBatcher(JaxModel.new_from_onnx(_onnx()), max_len=128,
                          max_batch=3, chunk=4, quantize="int8",
                          cache_dtype=JaxDType.BF16,
                          prompt_buckets=(16, 32, 64),
                          prefill_chunk=16).start()
    try:
        return [f.result(timeout=300).tolist()
                for f in [b.submit(p, 6) for p in _prompts()]]
    finally:
        b.stop()


def teacher_forced_logits(pkg, tokens):
    """Each prompt plus its tokens (all but the last) through `pkg`'s
    direct path (int8, a bf16 cache), one teacher-forced prefill: the
    logits of the steps that chose the tokens, one array a prompt."""
    data = _onnx()
    kw = dict(max_len=128, quantize="int8", prompt_buckets=(16, 32, 64))
    if pkg == "jax":
        iface = JaxTextInterface(JaxModel.new_from_onnx(data),
                                 cache_dtype=JaxDType.BF16, **kw)
    else:
        iface = TextInferenceInterface(Model.new_from_onnx(data),
                                       cache_dtype=DType.BF16, device="cpu",
                                       **kw)
    out = []
    for p, t in zip(_prompts(), tokens):
        seq = np.concatenate([p, t[:-1]])[None]
        out.append(np.asarray(iface.logits(seq), np.float32)[0, len(p) - 1:])
    return out


def quantizer_differences():
    """{matrix: (differing int8 values, differing scales)}: the JAX
    package's quantize_int8 as it runs here against its numpy path."""
    from whisper_tensor_tpu.backends.pallas import quant_matmul as qm
    from whisper_tensor_tpu.utils import native

    data = _onnx()
    model = Model.new_from_onnx(data)
    iface = TextInferenceInterface(model, max_len=128, quantize="int8",
                                   device="cpu")
    out = {}
    for name in iface._quantized:
        w = iface._dense_np(name, DType.F32)
        q, s = qm.quantize_int8(w)
        inner, native.native_quantize_int8 = (native.native_quantize_int8,
                                              lambda w: None)
        try:
            q0, s0 = qm.quantize_int8(w)
        finally:
            native.native_quantize_int8 = inner
        out[name] = (int((np.asarray(q) != q0).sum()),
                     int((np.asarray(s) != s0).sum()))
    return out


def _child(*args):
    """Run this file in a child process with XLA's excess precision off;
    its JSON output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false"))
    res = subprocess.run([sys.executable, __file__, *args], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=900)
    return json.loads(res.stdout.strip().splitlines()[-1])


def _spread(a, b):
    """Per prompt, the largest over its steps of max |a - b| / max |a|."""
    return [round(float((np.abs(x - y).max(-1) / np.abs(x).max(-1)).max()),
                  4) for x, y in zip(a, b)]


def main(argv):
    jax.config.update("jax_platforms", "cpu")
    if argv[1:] == ["--nodes"]:
        print(json.dumps({f"{q or 'bf16'}{' dense' if d else ''}":
                          nodes_apart(q, d)[0][:3]
                          for q in (None, "int8") for d in (False, True)}))
        return
    if argv[1:2] == ["--logits"]:
        tokens = json.loads(argv[2])
        print(json.dumps([x.tolist() for x in
                          teacher_forced_logits("jax", tokens)]))
        return
    for q in (None, "int8"):
        for d in (False, True):
            apart, kinds = nodes_apart(q, d)
            print(f"default XLA flags, {q or 'unquantized'}, port attention "
                  f"{'dense' if d else 'as is'}: {len(apart)} of "
                  f"{len(kinds)} nodes part; first three {apart[:3]}")
    for key, apart in _child("--nodes").items():
        print(f"--xla_allow_excess_precision=false, {key}: first three "
              f"nodes apart {apart}")
    print(f"quantize_int8 here against its numpy path (differing int8 "
          f"values, scales): {quantizer_differences()}")
    tokens = _batcher_tokens()
    ref = teacher_forced_logits("jax", tokens)
    port = teacher_forced_logits("port", tokens)
    off = [np.asarray(x, np.float32)
           for x in _child("--logits", json.dumps(tokens))]
    print(f"the JAX batcher's tokens: {tokens}")
    margins = [(np.sort(x, -1)[:, -1] - np.sort(x, -1)[:, -2]).tolist()
               for x in ref]
    print(f"the JAX package's top-two margin at each teacher-forced step, "
          f"per prompt: {margins}")
    print(f"teacher-forced max |logit difference| / max |logit|, per "
          f"prompt: the port against the JAX package {_spread(ref, port)}; "
          f"the JAX package against itself without excess precision "
          f"{_spread(ref, off)}")


if __name__ == "__main__":
    main(sys.argv)
