"""The milli training artifact on the PyTorch port against the JAX package.

For the forward graphs of the JAX package's tests/test_milli_training.py
(an MLP under mse, a linear layer under cross-entropy, a GPT-2 training
graph of 2 layers of 16 with AdamW, softcapped GQA attention, strided
and negative-step Slice, the unary and reduce families, GroupNorm,
stop_gradients, external gradients, bf16 LoRA adapters) each package
builds the same graph with its own op classes and its own
build_training_graph. Held against the JAX package:
  * graph_to_json of the port's training graph equals the JAX
    package's (the backward rules and the optimizer ops node for node);
  * the port's GraphExecutor on the CPU gives the loss, every grad::*
    and every new::* / state::* output of the JAX package's MilliGraph
    .eval within 1e-5 of each output's largest |value| (f32; the bf16
    case 2^-7 of it, a bf16 ulp, as bf16 sums round in other orders).
    Under Adam a parameter whose gradient is float noise (below 1e-3 of
    its tensor's largest: a key bias, whose exact gradient is zero) may
    step by up to lr either way in either package, so its new::* value
    is held within lr;
  * each optimizer's update equals its closed form (1e-5 relative).
A Concat's backward runs on the port only: the JAX package's rule
imports a name its module lacks (ROADMAP C22), so it is held against
autograd.
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import whisper_tensor_tpu as jax_pkg  # noqa: E402
import whisper_tensor_tpu_torch as port_pkg  # noqa: E402
from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (  # noqa: E402
    GraphExecutor)
from whisper_tensor_tpu_torch.dtype import to_device, to_host  # noqa: E402


def _ns(pkg):
    """The milli API of one package."""
    import importlib

    name = pkg.__name__
    m = types.SimpleNamespace()
    for mod in ("milli.ir", "milli.ops", "milli.ops.attention",
                "milli.ops.norm", "milli.ops.shape", "milli.ops.reduce",
                "milli.autodiff", "milli.optimizers",
                "milli.training_graph", "milli.serde", "milli.transforms",
                "tensor_info", "dtype", "model",
                "importers.recipes.llm.gpt2"):
        mm = importlib.import_module(f"{name}.{mod}")
        for k in dir(mm):
            if not k.startswith("_"):
                setattr(m, k, getattr(mm, k))
    return m


J, P = _ns(jax_pkg), _ns(port_pkg)


def _mlp(M):
    g = M.MilliGraph("mlp")
    x = g.add_input("x")
    w1, b1, w2 = g.add_input("w1"), g.add_input("b1"), g.add_input("w2")
    h = g.op1(M.SimpleUnary("tanh"),
              g.op1(M.SimpleBinary("add"), g.op1(M.MatMul(), x, w1), b1))
    g.mark_output("pred", g.op1(M.MatMul(), h, w2))
    return g


def _case_mlp(M, rng):
    params = {"w1": rng.standard_normal((4, 8)).astype(np.float32) * 0.5,
              "b1": np.zeros(8, dtype=np.float32),
              "w2": rng.standard_normal((8, 3)).astype(np.float32) * 0.5}
    feeds = {"x": rng.standard_normal((5, 4)).astype(np.float32),
             "target": rng.standard_normal((5, 3)).astype(np.float32)}
    g, meta = M.build_training_graph(
        _mlp(M), list(params), "pred", loss="mse",
        optimizer=M.OptimizerOptions(M.OptimizerKind.ADAM, lr=0.05))
    feeds.update(params)
    feeds.update(M.init_opt_state(meta, params))
    feeds["step"] = np.asarray(1.0, np.float32)
    return g, feeds


def _case_cross_entropy(M, rng):
    fwd = M.MilliGraph("lin")
    xi, wi = fwd.add_input("x"), fwd.add_input("w")
    fwd.mark_output("pred", fwd.op1(M.MatMul(), xi, wi))
    g, _ = M.build_training_graph(
        fwd, ["w"], "pred", loss="cross_entropy",
        optimizer=M.OptimizerOptions(M.OptimizerKind.SGD, lr=0.1))
    return g, {"x": rng.standard_normal((6, 4)).astype(np.float32),
               "w": rng.standard_normal((4, 7)).astype(np.float32),
               "target": rng.integers(0, 7, (6,)).astype(np.int64)}


def _case_transformer(M, rng):
    cfg = M.GPT2Config(n_layer=2, n_head=2, n_embd=16, vocab_size=61,
                       n_positions=32)
    data = M.build_gpt2_train(M.random_gpt2_weights(cfg, 0), cfg)
    model = M.Model.new_from_onnx(data)
    milli, weight_inputs = model.graph.to_milli(bake_small_constants=False)
    params = sorted(weight_inputs)
    B, S = 2, 8
    g, meta = M.build_training_graph(
        milli, params, "logits", loss="cross_entropy",
        optimizer=M.OptimizerOptions(M.OptimizerKind.ADAMW, lr=1e-3,
                                     weight_decay=0.01),
        input_infos={"input_ids": M.TensorInfo.shaped(M.DType.I64, [B, S])})
    pv = {n: model.graph.store.get_numeric(n).numpy() for n in params}
    feeds = {"input_ids": rng.integers(0, 61, (B, S)).astype(np.int64),
             "target": rng.integers(0, 61, (B, S)).astype(np.int64),
             "step": np.asarray(1.0, np.float32), **pv,
             **M.init_opt_state(meta, pv)}
    return g, feeds


def _case_softcap(M, rng):
    B, Hq, Hkv, S, D = 2, 4, 2, 6, 8
    g = M.MilliGraph("attn_softcap")
    q, k, v = g.add_input("q"), g.add_input("k"), g.add_input("v")
    g.mark_output("pred", g.op1(
        M.AttentionMilli(is_causal=True, softcap=5.0), q, k, v))
    tg, _ = M.build_training_graph(
        g, ["q", "k", "v"], "pred", loss="mse",
        input_infos={"q": M.TensorInfo.shaped(M.DType.F32, [B, Hq, S, D]),
                     "k": M.TensorInfo.shaped(M.DType.F32, [B, Hkv, S, D]),
                     "v": M.TensorInfo.shaped(M.DType.F32, [B, Hkv, S, D])})
    return tg, {"q": rng.standard_normal((B, Hq, S, D)).astype(np.float32),
                "k": rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
                "v": rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
                "target": rng.standard_normal((B, Hq, S, D)).astype(
                    np.float32)}


SLICES = [([1], [7], [0], [2]), ([6], [-9], [0], [-2]),
          ([0, 5], [8, 0], [0, 1], [3, -1]), ([2], [6], [1], [1])]


def _case_slice(i):
    starts, ends, axes, steps = SLICES[i]

    def build(M, rng):
        g = M.MilliGraph("slice_bwd")
        x = g.add_input("x")
        consts = [g.op1(M.Constant(np.asarray(v, np.int64)))
                  for v in (starts, ends, axes, steps)]
        g.mark_output("pred", g.op1(M.Slice(), x, *consts))
        xv = rng.standard_normal((8, 6)).astype(np.float32)
        out = M.Slice().eval([xv] + [np.asarray(v) for v in
                                     (starts, ends, axes, steps)])[0]
        tg, _ = M.build_training_graph(
            g, ["x"], "pred", loss="mse",
            input_infos={"x": M.TensorInfo.shaped(M.DType.F32, [8, 6])})
        return tg, {"x": xv, "target": rng.standard_normal(
            out.shape).astype(np.float32)}

    return build


UNARY = [("tanh", (-2, 2)), ("sigmoid", (-3, 3)), ("exp", (-1, 1)),
         ("log", (0.5, 2)), ("sqrt", (0.5, 2)), ("relu", (-1, 1)),
         ("erf", (-1, 1)), ("abs", (0.2, 1)), ("sin", (-2, 2)),
         ("cos", (-2, 2)), ("reciprocal", (0.5, 2)), ("softplus", (-2, 2)),
         ("neg", (-1, 1)), ("tan", (-0.6, 0.6)), ("asin", (-0.8, 0.8)),
         ("acos", (-0.8, 0.8)), ("atan", (-2, 2)), ("sinh", (-1.5, 1.5)),
         ("cosh", (-1.5, 1.5)), ("asinh", (-2, 2)), ("acosh", (1.2, 3)),
         ("atanh", (-0.7, 0.7)), ("floor", (0.1, 0.9)), ("ceil", (0.1, 0.9)),
         ("round", (0.1, 0.4)), ("sign", (0.5, 2))]


def _case_unary(mode, domain):
    def build(M, rng):
        g = M.MilliGraph(f"u_{mode}")
        x = g.add_input("x")
        g.mark_output("pred", g.op1(M.SimpleUnary(mode), x))
        tg, _ = M.build_training_graph(g, ["x"], "pred", loss="l1")
        return tg, {"x": rng.uniform(*domain, (3, 4)).astype(np.float32),
                    "target": rng.standard_normal((3, 4)).astype(
                        np.float32)}

    return build


REDUCE = [("sum", False), ("mean", True), ("max", False), ("min", True),
          ("prod", True), ("prod", False), ("l1", False), ("l2", True),
          ("sumsquare", False), ("logsumexp", True), ("logsumexp", False)]


def _case_reduce(mode, keepdims):
    def build(M, rng):
        g = M.MilliGraph(f"red_{mode}")
        x = g.add_input("x")
        g.mark_output("pred", g.op1(
            M.Reduce(mode, axes=[1], keepdims=keepdims), x))
        tg, _ = M.build_training_graph(
            g, ["x"], "pred", loss="mse",
            input_infos={"x": M.TensorInfo.shaped(M.DType.F32, [3, 4, 5])})
        xv = (rng.uniform(0.3, 2.0, (3, 4, 5)) * np.where(
            rng.random((3, 4, 5)) < 0.5, -1, 1)).astype(np.float32)
        shape = (3, 1, 5) if keepdims else (3, 5)
        return tg, {"x": xv, "target": rng.standard_normal(shape).astype(
            np.float32)}

    return build


def _case_groupnorm(M, rng):
    N, C, S, G = 2, 6, 5, 3
    g = M.MilliGraph("gn")
    x, s, b, w = (g.add_input(n) for n in ("x", "s", "b", "w"))
    y = g.op1(M.GroupNormMilli(epsilon=1e-5, num_groups=G), x, s, b)
    g.mark_output("pred", g.op1(M.SimpleBinary("mul"), y, w))
    feeds = {"x": rng.standard_normal((N, C, S)).astype(np.float32),
             "s": rng.standard_normal(C).astype(np.float32),
             "b": rng.standard_normal(C).astype(np.float32),
             "w": rng.standard_normal((N, C, S)).astype(np.float32)}
    tg, _ = M.build_training_graph(
        g, ["x", "s", "b"], "pred", loss="mse",
        input_infos={n: M.TensorInfo.numeric(v) for n, v in feeds.items()})
    feeds["target"] = rng.standard_normal((N, C, S)).astype(np.float32)
    return tg, feeds


def _case_stop_gradients(M, rng):
    fwd = M.MilliGraph("f")
    x, w, w2 = fwd.add_input("x"), fwd.add_input("w"), fwd.add_input("w2")
    h = fwd.op1(M.MatMul(), x, w)
    fwd.mark_output("pred", fwd.op1(M.MatMul(), h, w2))
    g = M.MilliGraph("f:train")
    ins = {n: g.add_input(n) for n in fwd.inputs}
    out = g.merge_graph(fwd, ins)
    t = g.add_input("target")
    loss = M.mse_loss(g, out["pred"], t)
    g.mark_output("loss", loss)
    h_tid = next(n.outputs[0] for n in g.nodes if n.op.KIND == "MatMul")
    grads = M.generate_backward(
        g, loss, {"w2": ins["w2"]},
        M.BackwardGenOptions(stop_gradients={h_tid}))
    g.mark_output("grad::w2", grads["w2"])
    return g, {"x": rng.standard_normal((2, 3)).astype(np.float32),
               "w": rng.standard_normal((3, 4)).astype(np.float32),
               "w2": rng.standard_normal((4, 2)).astype(np.float32),
               "target": np.zeros((2, 2), dtype=np.float32)}


def _case_external_gradients(M, rng):
    g = M.MilliGraph("bptt")
    x, w, w2 = g.add_input("x"), g.add_input("W"), g.add_input("W2")
    h = g.op1(M.MatMul(), x, w)
    g.mark_output("h", h)
    y = g.op1(M.MatMul(), h, w2)
    loss = g.op1(M.Reduce("mean", axes=None, keepdims=False), y)
    g.mark_output("loss", loss)
    grads = M.generate_backward(
        g, loss, {"W": w}, M.BackwardGenOptions(external_gradients={h: "g_h"}))
    g.mark_output("grad::W", grads["W"])
    return g, {"x": rng.standard_normal((3, 4)).astype(np.float32),
               "W": rng.standard_normal((4, 5)).astype(np.float32),
               "W2": rng.standard_normal((5, 2)).astype(np.float32),
               "g_h": rng.standard_normal((3, 5)).astype(np.float32)}


def _case_bf16_lora(M, rng):
    bf16 = M.DType.BF16.to_numpy()
    W = (0.25 * rng.standard_normal((8, 6))).astype(bf16)
    g = M.MilliGraph("lin16")
    x, w = g.add_input("x"), g.add_input("W")
    g.mark_output("y", g.op1(M.MatMul(), x, w))
    ad = M.inject_lora(g, ["W"], rank=2, weight_getter=lambda n: W, seed=5)
    ad["W::lora_b"] = (0.1 * rng.standard_normal((2, 6))).astype(bf16)
    xv = (0.5 * rng.standard_normal((4, 8))).astype(bf16)
    tv = rng.standard_normal((4, 6)).astype(bf16)
    names = sorted(ad)
    tg, _ = M.build_training_graph(
        g, names, "y", loss="mse",
        optimizer=M.OptimizerOptions(M.OptimizerKind.SGD_MOMENTUM, lr=0.1),
        input_infos={"x": M.TensorInfo.numeric(xv),
                     "W": M.TensorInfo.numeric(W),
                     **{n: M.TensorInfo.numeric(v) for n, v in ad.items()}})
    feeds = {"x": xv, "W": W, "target": tv, **ad}
    feeds.update({f"state::v::{n}": np.zeros_like(v) for n, v in ad.items()})
    return tg, feeds


CASES = {"mlp_adam": _case_mlp, "cross_entropy_sgd": _case_cross_entropy,
         "gpt2_adamw": _case_transformer, "attention_softcap": _case_softcap,
         "groupnorm": _case_groupnorm, "stop_gradients": _case_stop_gradients,
         "external_gradients": _case_external_gradients,
         "bf16_lora": _case_bf16_lora}
CASES.update({f"slice_{i}": _case_slice(i) for i in range(len(SLICES))})
CASES.update({f"unary_{m}": _case_unary(m, d) for m, d in UNARY})
CASES.update({f"reduce_{m}_{'keep' if k else 'drop'}": _case_reduce(m, k)
              for m, k in REDUCE})


ADAM_LR = {"mlp_adam": 0.05, "gpt2_adamw": 1e-3}


def _port_run(g, feeds):
    ex = GraphExecutor(g, torch.device("cpu"))
    out = ex({k: to_device(v, torch.device("cpu")) for k, v in feeds.items()})
    return {k: to_host(v) for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_graph_matches_the_jax_package(case):
    jg, jfeeds = CASES[case](J, np.random.default_rng(17))
    pg, pfeeds = CASES[case](P, np.random.default_rng(17))
    assert P.graph_to_json(pg) == J.graph_to_json(jg)
    want = jg.eval(jfeeds)
    got = _port_run(pg, pfeeds)
    assert set(got) == set(want)
    low = case.startswith("bf16")
    for k in want:
        w = np.asarray(want[k], np.float64)
        gv = np.asarray(got[k], np.float64)
        assert gv.shape == w.shape and got[k].dtype == want[k].dtype, k
        tol = (2.0 ** -7 if low else 1e-5) * max(np.abs(w).max(), 1e-30)
        if k.startswith("new::") and case in ADAM_LR:
            # Adam turns a gradient of float noise (a key bias's, whose
            # exact value is zero) into a step of up to lr either way
            gr = np.abs(np.asarray(want["grad::" + k[5:]], np.float64))
            tol = np.where(gr >= 1e-3 * gr.max(), tol, ADAM_LR[case])
        assert (np.abs(gv - w) <= tol).all(), (case, k,
                                               np.abs(gv - w).max())


def test_serde_round_trips_and_reads_the_jax_package_json():
    jg, _ = _case_transformer(J, np.random.default_rng(3))
    pg, feeds = _case_transformer(P, np.random.default_rng(3))
    d = P.graph_to_json(pg)
    back = P.graph_from_json(J.graph_to_json(jg))
    assert P.graph_to_json(back) == d
    got = _port_run(back, feeds)
    want = _port_run(pg, feeds)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind,nesterov", [
    ("SGD", False), ("SGD_MOMENTUM", False), ("SGD_MOMENTUM", True),
    ("ADAM", False), ("ADAMW", False)])
def test_optimizers_match_their_closed_form(kind, nesterov):
    rng = np.random.default_rng(2)
    p = rng.standard_normal((3, 3)).astype(np.float32)
    gr = rng.standard_normal((3, 3)).astype(np.float32)
    v0 = rng.standard_normal((3, 3)).astype(np.float32)
    m0 = rng.standard_normal((3, 3)).astype(np.float32) * 0.1
    lr, mom, b1, b2, eps, wd, t = 0.1, 0.9, 0.9, 0.999, 1e-8, 0.01, 3.0
    k = P.OptimizerKind[kind]
    g = P.MilliGraph("opt")
    p_in, gr_in = g.add_input("p"), g.add_input("g")
    opts = P.OptimizerOptions(kind=k, lr=lr, momentum=mom, nesterov=nesterov,
                              beta1=b1, beta2=b2, eps=eps, weight_decay=wd)
    P.generate_optimizer_ops(g, {"p": p_in}, {"p": gr_in}, opts)
    feeds = {"p": p, "g": gr}
    if kind == "SGD_MOMENTUM":
        feeds["state::v::p"] = v0
    if kind in ("ADAM", "ADAMW"):
        feeds.update({"state::m::p": m0, "state::v::p": np.abs(v0) * 0.1,
                      "step": np.asarray(t, np.float32)})
    out = _port_run(g, feeds)
    if kind == "SGD":
        expect = p - (lr * gr + lr * wd * p)
    elif kind == "SGD_MOMENTUM":
        v = mom * v0 + gr
        np.testing.assert_allclose(out["state::v::p"], v, rtol=1e-5)
        eff = gr + mom * v if nesterov else v
        expect = p - lr * eff
    else:
        gd = gr + wd * p if kind == "ADAM" else gr
        m = b1 * m0 + (1 - b1) * gd
        v = b2 * np.abs(v0) * 0.1 + (1 - b2) * gd * gd
        upd = (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
        if kind == "ADAMW":
            upd = upd + wd * p
        expect = p - lr * upd
        np.testing.assert_allclose(out["state::m::p"], m, rtol=1e-5)
        np.testing.assert_allclose(out["state::v::p"], v, rtol=1e-5)
    np.testing.assert_allclose(out["new::p"], expect, rtol=1e-5, atol=1e-6)


def test_concat_backward_matches_autograd():
    """ROADMAP C22: the JAX package's Concat rule imports `ReduceOp` from
    its milli reduce module, which has none, so its backward raises; the
    port's copy leaves that import out."""
    rng = np.random.default_rng(4)
    g = P.MilliGraph("cat")
    a, b = g.add_input("a"), g.add_input("b")
    g.mark_output("pred", g.op1(P.Concat(axis=1), a, b))
    tg, _ = P.build_training_graph(g, ["a", "b"], "pred", loss="mse")
    av = rng.standard_normal((2, 3)).astype(np.float32)
    bv = rng.standard_normal((2, 4)).astype(np.float32)
    tv = rng.standard_normal((2, 7)).astype(np.float32)
    out = _port_run(tg, {"a": av, "b": bv, "target": tv})
    at = torch.from_numpy(av).requires_grad_(True)
    bt = torch.from_numpy(bv).requires_grad_(True)
    loss = ((torch.cat([at, bt], 1) - torch.from_numpy(tv)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(out["grad::a"], at.grad.numpy(), rtol=1e-5)
    np.testing.assert_allclose(out["grad::b"], bt.grad.numpy(), rtol=1e-5)
    with pytest.raises(ImportError):
        jg = J.MilliGraph("cat")
        ja, jb = jg.add_input("a"), jg.add_input("b")
        jg.mark_output("pred", jg.op1(J.Concat(axis=1), ja, jb))
        J.build_training_graph(jg, ["a", "b"], "pred", loss="mse")


def test_grad_only_kinds_lower_as_their_eval():
    """GatherGrad, SumTo and the three convolution gradients: the port's
    lowering of one node against the op's numpy eval (copied from the
    JAX package, whose tests hold it)."""
    rng = np.random.default_rng(9)
    cases = [
        (P.GatherGrad(axis=0), [np.asarray([5, 3], np.int64),
                                np.asarray([[1, 4], [1, -1]], np.int64),
                                rng.standard_normal((2, 2, 3)).astype(
                                    np.float32)]),
        (P.GatherGrad(axis=1), [np.asarray([2, 6], np.int64),
                                np.asarray([0, 5, 0], np.int64),
                                rng.standard_normal((2, 3)).astype(
                                    np.float32)]),
        (P.SumTo(), [rng.standard_normal((4, 3, 5)).astype(np.float32),
                     np.asarray([3, 1], np.int64)]),
    ]
    from whisper_tensor_tpu_torch.milli.ops.conv import (
        ConvBiasGrad, ConvInputGrad, ConvWeightGrad)

    x = rng.standard_normal((2, 4, 7, 6)).astype(np.float32)
    w = rng.standard_normal((6, 2, 3, 2)).astype(np.float32)
    geo = dict(strides=[2, 1], pads=[1, 0, 0, 1], dilations=[1, 2], groups=2)
    gy = rng.standard_normal((2, 6, 3, 5)).astype(np.float32)
    cases += [(ConvInputGrad(**geo), [np.asarray(x.shape, np.int64), w, gy]),
              (ConvWeightGrad(**geo), [np.asarray(w.shape, np.int64), x, gy]),
              (ConvBiasGrad(), [gy])]
    for op, ins in cases:
        g = P.MilliGraph(op.KIND)
        tids = [g.add_input(f"i{j}") for j in range(len(ins))]
        g.mark_output("y", g.op1(op, *tids))
        got = _port_run(g, {f"i{j}": v for j, v in enumerate(ins)})["y"]
        want = op.eval(ins)[0]
        assert got.shape == want.shape, op.KIND
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=op.KIND)
