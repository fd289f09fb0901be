"""The PyTorch port's generic ONNX path against the JAX package on the
CPU: the same ONNX bytes and seeded numpy feeds through the JAX package's
`Model.eval(mode="xla")` and the port's `Model.eval(device="cpu")`.

* the llama and GPT-2 step graphs of the text recipes, 2 layers at
  narrow widths, f32 and bf16, with a scalar and a per-row `pos`
  (logits and updated caches): f32 to rtol 1e-4 / atol 1e-5 (the two
  packages sum in other orders); bf16 to 1/32 of each output's largest
  |value| (bf16 rounds at other places in the two packages, ROADMAP
  C10; measured at most 1.38%, llama's logits);
* the control-flow graphs (nested If, a two-state Scan, a Loop with a
  condition and an outer-scope capture) exactly;
* ONNX opset-23 Attention in bf16, causal and with an additive
  (1, 1, Sq, Skv) mask, GQA and D 64/128, where the port takes
  flash_attention's causal and additive modes (its plain version on the
  CPU) and the JAX package its XLA path: within flash_agreement_bound of
  an f32 reference made from the JAX package's output, i.e. one bf16 ulp
  of the output plus 2^-7 of the |v|-weighted magnitude; a causal call
  with Sq > Skv, whose first rows see no key (the mean of v), included.
"""

import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gpt2 as jax_gpt2)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (  # noqa: E402
    flash_agreement_bound)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.onnx_builder import (  # noqa: E402
    OnnxBuilder, WeightStorage)
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    gpt2, llama)
from whisper_tensor_tpu_torch.milli.ops import attention as port_attention  # noqa: E402
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


def _step_onnx(family, dt, per_row):
    if family == "llama":
        return llama.build_llama_step(_llama_weights,
                                      llama.LlamaConfig(**LLAMA),
                                      max_len=MAX_LEN, dtype=DType[dt],
                                      pos_per_row=per_row)
    weights = jax_gpt2.random_gpt2_weights(jax_gpt2.GPT2Config(**GPT2))
    return gpt2.build_gpt2_step(weights, gpt2.GPT2Config(**GPT2),
                                max_len=MAX_LEN, dtype=DType[dt],
                                pos_per_row=per_row)


def _step_feeds(model, dt, per_row):
    """2 rows of 5 tokens at pos 3 (or 3 and 10), caches of small normal
    values in the cache's type."""
    rng = np.random.default_rng(17)
    np_dt = np.float32 if dt == "F32" else ml_dtypes.bfloat16
    feeds = {}
    for name, info in model.input_infos().items():
        if name == "input_ids":
            feeds[name] = rng.integers(0, V, (2, 5)).astype(np.int64)
        elif name == "pos":
            feeds[name] = (np.array([3, 10]) if per_row
                           else np.array(3)).astype(np.int64)
        else:
            shape = [2] + [int(d.value()) for d in info.dims()[1:]]
            feeds[name] = (0.5 * rng.standard_normal(shape)).astype(np_dt)
    return feeds


STEPS = [(f, dt, per_row) for f in ("llama", "gpt2") for dt in ("F32", "BF16")
         for per_row in (False, True)]


@pytest.mark.parametrize("family,dt,per_row", STEPS)
def test_step_graph_matches_the_jax_package(family, dt, per_row):
    data = _step_onnx(family, dt, per_row)
    port = Model.new_from_onnx(data)
    feeds = _step_feeds(port, dt, per_row)
    want = JaxModel.new_from_onnx(data).eval(
        {k: v.copy() for k, v in feeds.items()}, mode="xla")
    got = port.eval({k: v.copy() for k, v in feeds.items()}, device="cpu")
    assert port.backend("torch", device="cpu").last_path == "torch"
    assert sorted(got) == sorted(want)
    for name in want:
        g = np.asarray(got[name]).astype(np.float32)
        w = np.asarray(want[name]).astype(np.float32)
        assert g.shape == w.shape, name
        if dt == "F32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=np.abs(w).max() / 32,
                                       err_msg=name)


# -- control flow ----------------------------------------------------------

_ST = WeightStorage.embed()


def _nested_if():
    inner_t = OnnxBuilder("it")
    inner_t.node("Mul", ["x", inner_t.const(np.float32(10))], outputs=["iv"])
    inner_t.output("iv", DType.F32, [2])
    inner_e = OnnxBuilder("ie")
    inner_e.node("Mul", ["x", inner_e.const(np.float32(100))], outputs=["iv"])
    inner_e.output("iv", DType.F32, [2])
    then_b = OnnxBuilder("t")
    then_b.node("If", ["c2"], outputs=["ov"],
                then_branch=inner_t.build_graph_proto(_ST),
                else_branch=inner_e.build_graph_proto(_ST))
    then_b.output("ov", DType.F32, [2])
    else_b = OnnxBuilder("e")
    else_b.node("Neg", ["x"], outputs=["ov"])
    else_b.output("ov", DType.F32, [2])
    b = OnnxBuilder("nested_if")
    b.input("c1", DType.BOOL, [])
    b.input("c2", DType.BOOL, [])
    b.input("x", DType.F32, [2])
    b.node("If", ["c1"], outputs=["y"],
           then_branch=then_b.build_graph_proto(_ST),
           else_branch=else_b.build_graph_proto(_ST))
    b.output("y", DType.F32, [2])
    x = np.asarray([1.0, 2.0], np.float32)
    return b.build(), [{"c1": np.asarray(c1), "c2": np.asarray(c2), "x": x}
                       for c1, c2 in ((True, True), (True, False),
                                      (False, True))]


def _scan_two_states():
    body = OnnxBuilder("body2")
    for n in ("s1", "s2", "a", "b"):
        body.input(n, DType.F32, [1])
    body.node("Add", ["s1", "a"], outputs=["s1_o"])
    body.node("Mul", ["s2", "b"], outputs=["s2_o"])
    body.node("Sub", ["a", "b"], outputs=["d_o"])
    body.node("Add", ["s1_o", "s2_o"], outputs=["t_o"])
    for n in ("s1_o", "s2_o", "d_o", "t_o"):
        body.output(n, DType.F32, [1])
    b = OnnxBuilder("scan2")
    b.input("i1", DType.F32, [1])
    b.input("i2", DType.F32, [1])
    b.input("sa", DType.F32, [3, 1])
    b.input("sb", DType.F32, [3, 1])
    b.node("Scan", ["i1", "i2", "sa", "sb"], outputs=["f1", "f2", "d", "t"],
           num_scan_inputs=2, body=body.build_graph_proto(_ST))
    for n, s in (("f1", [1]), ("f2", [1]), ("d", [3, 1]), ("t", [3, 1])):
        b.output(n, DType.F32, s)
    rng = np.random.default_rng(3)
    return b.build(), [{"i1": np.zeros(1, np.float32),
                        "i2": np.ones(1, np.float32),
                        "sa": rng.standard_normal((3, 1)).astype(np.float32),
                        "sb": rng.standard_normal((3, 1)).astype(np.float32)}]


def _loop_with_condition():
    body = OnnxBuilder("lbody")
    body.input("iter", DType.I64, [])
    body.input("cond_in", DType.BOOL, [])
    body.input("acc", DType.F32, [])
    body.node("Add", ["acc", "delta"], outputs=["acc_o"])   # outer capture
    body.node("Less", ["acc_o", body.const(np.float32(7))], outputs=["cond_o"])
    body.node("Identity", ["acc_o"], outputs=["scan_o"])
    body.output("cond_o", DType.BOOL, [])
    body.output("acc_o", DType.F32, [])
    body.output("scan_o", DType.F32, [])
    b = OnnxBuilder("loop")
    b.input("m", DType.I64, [])
    b.input("c", DType.BOOL, [])
    b.input("acc0", DType.F32, [])
    b.input("delta", DType.F32, [])
    b.node("Loop", ["m", "c", "acc0"], outputs=["final", "trace"],
           body=body.build_graph_proto(_ST))
    b.output("final", DType.F32, [])
    b.output("trace", DType.F32, ["n"])
    return b.build(), [{"m": np.asarray(m, np.int64), "c": np.asarray(True),
                        "acc0": np.asarray(0.5, np.float32),
                        "delta": np.asarray(d, np.float32)}
                       for m, d in ((100, 2.0), (3, 1.5))]


@pytest.mark.parametrize("make", [_nested_if, _scan_two_states,
                                  _loop_with_condition],
                         ids=["nested_if", "scan_two_states", "loop"])
def test_control_flow_matches_the_jax_package(make):
    data, runs = make()
    port, ref = Model.new_from_onnx(data), JaxModel.new_from_onnx(data)
    for feeds in runs:
        want = ref.eval(dict(feeds), mode="xla")
        got = port.eval(dict(feeds), device="cpu")
        assert port.backend("torch", device="cpu").last_path == \
            "torch-control"
        for name in want:
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))


# -- Attention in bf16: flash_attention's causal and additive modes ---------

ATTN = [  # (B, Hq, Hkv, Sq, Skv, D, mode)
    (1, 4, 2, 16, 16, 64, "causal"), (2, 4, 4, 24, 40, 128, "causal"),
    (1, 2, 1, 20, 12, 64, "causal"),                 # Sq > Skv
    (1, 4, 2, 16, 16, 64, "additive"), (2, 2, 1, 12, 33, 128, "additive"),
    (2, 4, 2, 8, 8, 64, "additive-per-row"),
]


def _attention_onnx(B, Hq, Hkv, Sq, Skv, D, mode):
    b = OnnxBuilder("attn", opset=23)
    b.input("q", DType.BF16, [B, Hq, Sq, D])
    b.input("k", DType.BF16, [B, Hkv, Skv, D])
    b.input("v", DType.BF16, [B, Hkv, Skv, D])
    ins = ["q", "k", "v"]
    if mode != "causal":
        mb = B if mode == "additive-per-row" else 1
        b.input("mask", DType.BF16, [mb, 1, Sq, Skv])
        ins.append("mask")
    b.node("Attention", ins, outputs=["y"],
           is_causal=1 if mode == "causal" else None)
    b.output("y", DType.BF16, [B, Hq, Sq, D])
    return b.build()


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,mode", ATTN)
def test_bf16_attention_takes_flash_and_matches_the_jax_package(
        B, Hq, Hkv, Sq, Skv, D, mode, monkeypatch):
    rng = np.random.default_rng(B * 1000 + Sq * 10 + D)
    bf = ml_dtypes.bfloat16
    feeds = {"q": rng.standard_normal((B, Hq, Sq, D)).astype(bf),
             "k": rng.standard_normal((B, Hkv, Skv, D)).astype(bf),
             "v": rng.standard_normal((B, Hkv, Skv, D)).astype(bf)}
    if mode != "causal":
        mb = B if mode == "additive-per-row" else 1
        visible = rng.uniform(size=(mb, 1, Sq, Skv)) < 0.7
        visible[..., 0] = True
        feeds["mask"] = np.where(visible, 0.0, -1e4).astype(bf)
    calls = []
    real = port_attention.flash_attention

    def spy(q, k, v, scale, **kw):
        calls.append((tuple(q.shape), kw.get("causal", False),
                      kw.get("mask") is not None))
        return real(q, k, v, scale, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    data = _attention_onnx(B, Hq, Hkv, Sq, Skv, D, mode)
    got = Model.new_from_onnx(data).eval(feeds, device="cpu")["y"]
    want = JaxModel.new_from_onnx(data).eval(feeds, mode="xla")["y"]
    assert len(calls) == 1
    assert calls[0][1] == (mode == "causal")
    assert calls[0][2] == (mode != "causal")
    # the bound of flash_agreement_bound around the JAX package's output,
    # with the magnitude from the port's plain path on |v|
    mag = Model.new_from_onnx(data).eval(
        dict(feeds, v=np.abs(feeds["v"].astype(np.float32)).astype(bf)),
        device="cpu")["y"]
    ref = torch.from_numpy(want.astype(np.float32))
    bound = flash_agreement_bound(ref, torch.from_numpy(
        mag.astype(np.float32))).numpy()
    err = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (err <= bound).all(), float((err - bound).max())


# -- C15: a row hidden everywhere by a large finite additive mask ---------


@pytest.mark.parametrize("Hq,Hkv", [(4, 1), (2, 2)])
def test_c15_a_row_masked_everywhere_keeps_the_scores_order(Hq, Hkv):
    """An additive mask of -1e9 on every key of a row: the oracle's
    scores are float64 (NumPy promotes them by the float64 scale), so
    the row keeps softmax(scores); f32 scores + -1e9 round to one value
    and give the mean of v. The lowering shifts the mask by its row
    maximum first, which leaves every softmax alone and keeps the order.
    Fails on the parent (the row came out as the mean of v)."""
    from whisper_tensor_tpu_torch.milli.ops.attention import AttentionMilli
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS

    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, Hq, 3, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, Hkv, 5, 8)).astype(np.float32)
            for _ in range(2))
    mask = np.where(rng.uniform(size=(1, 1, 3, 5)) > 0.4, 0.0, -1e9)
    mask[0, 0, 1] = -1e9                          # row 1 sees no key
    mask = mask.astype(np.float32)
    op = AttentionMilli()
    want = op.eval([q, k, v, mask])[0]
    cpu = torch.device("cpu")
    (got,) = LOWERINGS["Attention"](
        op, [torch.from_numpy(a) for a in (q, k, v, mask)], [None] * 4, cpu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
