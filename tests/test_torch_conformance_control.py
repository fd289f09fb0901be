"""The PyTorch port's generic ONNX path on the CPU, beyond the
single-node corpus:

* tests/conformance/test_control_flow.py's 11 tests (If/Scan/Loop, the
  legacy opset-11 attribute forms, string tensors) ported to the port's
  builder and `Model.eval(..., device="cpu")`: control flow runs on the
  host, each nested graph and every other node through torch;
* tests/conformance/test_random.py's 2 tests (RandomNormalLike by
  moments, seeds that differ give different draws);
* replay: one Model reused with different lifted feeds (a Reshape shape
  input, a TopK k input) and with data that gives a different NonZero
  count at equal shapes;
* the corpus numbers 2,453 cases, every one selected (66 of them the
  vision ops, the last family ported).
"""

import numpy as np

import torch_conformance as tc
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.importers.onnx_builder import (OnnxBuilder,
                                                             WeightStorage)
from whisper_tensor_tpu_torch.model import Model


def _ev(m, feeds):
    return m.eval(feeds, device="cpu")


def test_if_nested_in_branches():
    inner_t = OnnxBuilder("it")
    inner_t.node("Mul", ["x", inner_t.const(np.float32(10))], outputs=["iv"])
    inner_t.output("iv", DType.F32, [2])
    inner_e = OnnxBuilder("ie")
    inner_e.node("Mul", ["x", inner_e.const(np.float32(100))], outputs=["iv"])
    inner_e.output("iv", DType.F32, [2])

    then_b = OnnxBuilder("t")
    then_b.node("If", ["c2"], outputs=["ov"],
                then_branch=inner_t.build_graph_proto(WeightStorage.embed()),
                else_branch=inner_e.build_graph_proto(WeightStorage.embed()))
    then_b.output("ov", DType.F32, [2])
    else_b = OnnxBuilder("e")
    else_b.node("Neg", ["x"], outputs=["ov"])
    else_b.output("ov", DType.F32, [2])

    b = OnnxBuilder("nested_if")
    b.input("c1", DType.BOOL, [])
    b.input("c2", DType.BOOL, [])
    b.input("x", DType.F32, [2])
    b.node("If", ["c1"], outputs=["y"],
           then_branch=then_b.build_graph_proto(WeightStorage.embed()),
           else_branch=else_b.build_graph_proto(WeightStorage.embed()))
    b.output("y", DType.F32, [2])
    m = Model.new_from_onnx(b.build())
    x = np.asarray([1.0, 2.0], dtype=np.float32)
    t, f = np.asarray(True), np.asarray(False)
    np.testing.assert_array_equal(_ev(m, {"c1": t, "c2": t, "x": x})["y"], x * 10)
    np.testing.assert_array_equal(_ev(m, {"c1": t, "c2": f, "x": x})["y"], x * 100)
    np.testing.assert_array_equal(_ev(m, {"c1": f, "c2": t, "x": x})["y"], -x)


def test_scan_reverse_direction():
    body = OnnxBuilder("body")
    body.input("acc", DType.F32, [1])
    body.input("el", DType.F32, [1])
    body.node("Add", ["acc", "el"], outputs=["acc_o"])
    body.node("Identity", ["acc_o"], outputs=["sc_o"])
    body.output("acc_o", DType.F32, [1])
    body.output("sc_o", DType.F32, [1])
    b = OnnxBuilder("scan_rev")
    b.input("init", DType.F32, [1])
    b.input("seq", DType.F32, [4, 1])
    b.node("Scan", ["init", "seq"], outputs=["fin", "outs"],
           num_scan_inputs=1, scan_input_directions=[1],
           body=body.build_graph_proto(WeightStorage.embed()))
    b.output("fin", DType.F32, [1])
    b.output("outs", DType.F32, [4, 1])
    m = Model.new_from_onnx(b.build())
    seq = np.asarray([[1], [2], [3], [4]], dtype=np.float32)
    out = _ev(m, {"init": np.zeros(1, np.float32), "seq": seq})
    np.testing.assert_array_equal(out["fin"], [10])
    # reverse: visits 4,3,2,1 -> partials [4,7,9,10]
    np.testing.assert_array_equal(out["outs"][:, 0], [4, 7, 9, 10])


def test_loop_with_condition():
    body = OnnxBuilder("lbody")
    body.input("iter", DType.I64, [])
    body.input("cond_in", DType.BOOL, [])
    body.input("acc", DType.F32, [])
    acc2 = body.node("Add", ["acc", body.const(np.float32(2))], outputs=["acc_o"])
    lim = body.const(np.float32(7))
    body.node("Less", ["acc_o", lim], outputs=["cond_o"])
    body.node("Identity", ["acc_o"], outputs=["scan_o"])
    body.output("cond_o", DType.BOOL, [])
    body.output("acc_o", DType.F32, [])
    body.output("scan_o", DType.F32, [])
    b = OnnxBuilder("loop")
    b.input("m", DType.I64, [])
    b.input("c", DType.BOOL, [])
    b.input("acc0", DType.F32, [])
    b.node("Loop", ["m", "c", "acc0"], outputs=["final", "trace"],
           body=body.build_graph_proto(WeightStorage.embed()))
    b.output("final", DType.F32, [])
    b.output("trace", DType.F32, ["n"])
    m = Model.new_from_onnx(b.build())
    out = _ev(m, {"m": np.asarray(100, dtype=np.int64), "c": np.asarray(True),
                  "acc0": np.asarray(0.0, dtype=np.float32)})
    # 0 -> 2,4,6,8 (cond 8<7 false stops AFTER producing 8)
    assert float(out["final"]) == 8.0
    np.testing.assert_array_equal(out["trace"], [2, 4, 6, 8])


def test_legacy_attr_forms_opset11():
    """Squeeze/Unsqueeze/Slice/Pad/ReduceSum with attributes (pre-13)."""
    b = OnnxBuilder("legacy", opset=11)
    b.input("x", DType.F32, [1, 3, 1, 4])
    s = b.node("Squeeze", ["x"], axes=[0, 2])
    u = b.node("Unsqueeze", [s], axes=[0])
    sl = b.node("Slice", [u], starts=[1], ends=[3], axes=[2])
    r = b.node("ReduceSum", [sl], axes=[2], keepdims=0)
    b.node("Identity", [r], outputs=["y"])
    b.output("y", DType.F32, [1, 3])
    m = Model.new_from_onnx(b.build())
    x = np.arange(12, dtype=np.float32).reshape(1, 3, 1, 4)
    out = _ev(m, {"x": x})["y"]
    ref = x.squeeze((0, 2))[None][:, :, 1:3].sum(axis=2)
    np.testing.assert_array_equal(out, ref)
    # the oracle too
    out2 = m.eval({"x": x}, mode="oracle")["y"]
    np.testing.assert_array_equal(np.asarray(out2), ref)


def test_string_tensor_identity_and_cast():
    b = OnnxBuilder("strings")
    b.input("s", DType.STRING, [3])
    y = b.node("Identity", ["s"], outputs=["y"])
    b.output("y", DType.STRING, [3])
    m = Model.new_from_onnx(b.build())
    arr = np.array(["1.5", "2", "-3"], dtype=object)
    out = _ev(m, {"s": arr})["y"]
    assert list(out) == ["1.5", "2", "-3"]

    b2 = OnnxBuilder("str_cast")
    b2.input("s", DType.STRING, [3])
    from whisper_tensor_tpu_torch.dtype import DTYPE_TO_ONNX

    y = b2.node("Cast", ["s"], to=DTYPE_TO_ONNX[DType.F32])
    b2.node("Identity", [y], outputs=["f"])
    b2.output("f", DType.F32, [3])
    m2 = Model.new_from_onnx(b2.build())
    np.testing.assert_allclose(_ev(m2, {"s": arr})["f"], [1.5, 2.0, -3.0])


def test_scan_two_states_two_inputs_two_outputs():
    """Scan with 2 state vars, 2 scan inputs, 2 scan outputs (the full
    generality of the reference's ScanOperation: state triples + scan
    slicing, src/symbolic_graph/ops/scan.rs:16)."""
    body = OnnxBuilder("body2")
    body.input("s1", DType.F32, [1])
    body.input("s2", DType.F32, [1])
    body.input("a", DType.F32, [1])
    body.input("b", DType.F32, [1])
    body.node("Add", ["s1", "a"], outputs=["s1_o"])        # running sum of a
    body.node("Mul", ["s2", "b"], outputs=["s2_o"])        # running prod of b
    body.node("Sub", ["a", "b"], outputs=["d_o"])          # scan out 1
    body.node("Add", ["s1_o", "s2_o"], outputs=["t_o"])    # scan out 2
    for n, s in (("s1_o", [1]), ("s2_o", [1]), ("d_o", [1]), ("t_o", [1])):
        body.output(n, DType.F32, s)
    b = OnnxBuilder("scan2")
    b.input("i1", DType.F32, [1])
    b.input("i2", DType.F32, [1])
    b.input("sa", DType.F32, [3, 1])
    b.input("sb", DType.F32, [3, 1])
    b.node("Scan", ["i1", "i2", "sa", "sb"],
           outputs=["f1", "f2", "d", "t"], num_scan_inputs=2,
           body=body.build_graph_proto(WeightStorage.embed()))
    for n, s in (("f1", [1]), ("f2", [1]), ("d", [3, 1]), ("t", [3, 1])):
        b.output(n, DType.F32, s)
    m = Model.new_from_onnx(b.build())
    sa = np.asarray([[1], [2], [3]], np.float32)
    sb = np.asarray([[2], [3], [4]], np.float32)
    out = _ev(m, {"i1": np.zeros(1, np.float32),
                  "i2": np.ones(1, np.float32), "sa": sa, "sb": sb})
    np.testing.assert_array_equal(out["f1"], [6])    # 1+2+3
    np.testing.assert_array_equal(out["f2"], [24])   # 2*3*4
    np.testing.assert_array_equal(out["d"][:, 0], [-1, -1, -1])
    np.testing.assert_array_equal(out["t"][:, 0], [1 + 2, 3 + 6, 6 + 24])


def test_scan_outer_scope_capture():
    """The Scan body references a tensor from the OUTER graph (the
    reference supports outer-scope capture in nested subgraphs)."""
    b = OnnxBuilder("scan_cap")
    b.input("init", DType.F32, [1])
    b.input("seq", DType.F32, [4, 1])
    b.input("gain", DType.F32, [1])
    body = OnnxBuilder("bodyc")
    body.input("acc", DType.F32, [1])
    body.input("el", DType.F32, [1])
    body.node("Mul", ["el", "gain"], outputs=["g"])  # outer-scope "gain"
    body.node("Add", ["acc", "g"], outputs=["acc_o"])
    body.output("acc_o", DType.F32, [1])
    b.node("Scan", ["init", "seq"], outputs=["fin"], num_scan_inputs=1,
           body=body.build_graph_proto(WeightStorage.embed()))
    b.output("fin", DType.F32, [1])
    m = Model.new_from_onnx(b.build())
    out = _ev(m, {"init": np.zeros(1, np.float32),
                  "seq": np.asarray([[1], [2], [3], [4]], np.float32),
                  "gain": np.asarray([10.0], np.float32)})
    np.testing.assert_array_equal(out["fin"], [100.0])


def test_if_multiple_outputs():
    tb = OnnxBuilder("t")
    tb.node("Identity", ["x"], outputs=["o1"])
    tb.node("Neg", ["x"], outputs=["o2"])
    tb.output("o1", DType.F32, [2])
    tb.output("o2", DType.F32, [2])
    eb = OnnxBuilder("e")
    eb.node("Neg", ["x"], outputs=["o1"])
    eb.node("Identity", ["x"], outputs=["o2"])
    eb.output("o1", DType.F32, [2])
    eb.output("o2", DType.F32, [2])
    b = OnnxBuilder("if2")
    b.input("c", DType.BOOL, [])
    b.input("x", DType.F32, [2])
    b.node("If", ["c"], outputs=["y1", "y2"],
           then_branch=tb.build_graph_proto(WeightStorage.embed()),
           else_branch=eb.build_graph_proto(WeightStorage.embed()))
    b.output("y1", DType.F32, [2])
    b.output("y2", DType.F32, [2])
    m = Model.new_from_onnx(b.build())
    x = np.asarray([1.0, -2.0], np.float32)
    out = _ev(m, {"c": np.asarray(True), "x": x})
    np.testing.assert_array_equal(out["y1"], x)
    np.testing.assert_array_equal(out["y2"], -x)
    out = _ev(m, {"c": np.asarray(False), "x": x})
    np.testing.assert_array_equal(out["y1"], -x)
    np.testing.assert_array_equal(out["y2"], x)


def test_loop_trip_count_only_outer_capture():
    """Pure for-loop (cond stays true) whose body captures an
    outer-scope tensor."""
    body = OnnxBuilder("lb")
    body.input("iter", DType.I64, [])
    body.input("cond_in", DType.BOOL, [])
    body.input("acc", DType.F32, [])
    body.node("Add", ["acc", "delta"], outputs=["acc_o"])  # outer capture
    body.node("Identity", ["cond_in"], outputs=["cond_o"])
    body.output("cond_o", DType.BOOL, [])
    body.output("acc_o", DType.F32, [])
    b = OnnxBuilder("loop_tc")
    b.input("m", DType.I64, [])
    b.input("c", DType.BOOL, [])
    b.input("acc0", DType.F32, [])
    b.input("delta", DType.F32, [])
    b.node("Loop", ["m", "c", "acc0"], outputs=["final"],
           body=body.build_graph_proto(WeightStorage.embed()))
    b.output("final", DType.F32, [])
    m = Model.new_from_onnx(b.build())
    out = _ev(m, {"m": np.asarray(5, np.int64), "c": np.asarray(True),
                  "acc0": np.asarray(1.0, np.float32),
                  "delta": np.asarray(0.5, np.float32)})
    assert float(out["final"]) == 3.5


def test_loop_zero_iterations():
    body = OnnxBuilder("lb0")
    body.input("iter", DType.I64, [])
    body.input("cond_in", DType.BOOL, [])
    body.input("acc", DType.F32, [])
    body.node("Add", ["acc", body.const(np.float32(1))], outputs=["acc_o"])
    body.node("Identity", ["cond_in"], outputs=["cond_o"])
    body.output("cond_o", DType.BOOL, [])
    body.output("acc_o", DType.F32, [])
    b = OnnxBuilder("loop0")
    b.input("m", DType.I64, [])
    b.input("c", DType.BOOL, [])
    b.input("acc0", DType.F32, [])
    b.node("Loop", ["m", "c", "acc0"], outputs=["final"],
           body=body.build_graph_proto(WeightStorage.embed()))
    b.output("final", DType.F32, [])
    m = Model.new_from_onnx(b.build())
    out = _ev(m, {"m": np.asarray(0, np.int64), "c": np.asarray(True),
                  "acc0": np.asarray(7.0, np.float32)})
    assert float(out["final"]) == 7.0


def test_string_cast_roundtrip_and_int():
    from whisper_tensor_tpu_torch.dtype import DTYPE_TO_ONNX

    b = OnnxBuilder("str_rt")
    b.input("f", DType.F32, [3])
    s = b.node("Cast", ["f"], to=DTYPE_TO_ONNX[DType.STRING])
    y = b.node("Cast", [s], to=DTYPE_TO_ONNX[DType.F32])
    b.node("Identity", [y], outputs=["out"])
    b.output("out", DType.F32, [3])
    m = Model.new_from_onnx(b.build())
    f = np.asarray([1.5, -2.0, 0.25], np.float32)
    np.testing.assert_allclose(_ev(m, {"f": f})["out"], f)

    b2 = OnnxBuilder("str_i64")
    b2.input("s", DType.STRING, [3])
    y = b2.node("Cast", ["s"], to=DTYPE_TO_ONNX[DType.I64])
    b2.node("Identity", [y], outputs=["out"])
    b2.output("out", DType.I64, [3])
    m2 = Model.new_from_onnx(b2.build())
    arr = np.array(["12", "-7", "0"], dtype=object)
    np.testing.assert_array_equal(_ev(m2, {"s": arr})["out"], [12, -7, 0])


# -- tests/conformance/test_random.py -----------------------------------


def _rnl(mean, scale, seed=None):
    b = OnnxBuilder("rnl", opset=23)
    b.input("x", DType.F32, [200, 500])
    attrs = {"mean": mean, "scale": scale}
    if seed is not None:
        attrs["seed"] = float(seed)
    b.node("RandomNormalLike", ["x"], outputs=["out_0"], **attrs)
    b.output("out_0", DType.F32, [200, 500])
    return Model.new_from_onnx(b.build(), name="rnl")


def test_random_normal_like_moments():
    x = np.zeros((200, 500), np.float32)
    for mode in ("oracle", "torch"):
        out = np.asarray(_rnl(1.5, 0.5, seed=7).eval(
            {"x": x}, mode=mode, device="cpu")["out_0"])
        assert out.shape == x.shape and out.dtype == np.float32
        # se(mean) = 0.5/sqrt(1e5) ~ 0.0016; allow 6 sigma
        assert abs(out.mean() - 1.5) < 0.01, out.mean()
        assert abs(out.std() - 0.5) < 0.01, out.std()


def test_random_normal_like_seed_variation():
    x = np.zeros((200, 500), np.float32)
    a = _ev(_rnl(0.0, 1.0, seed=1), {"x": x})["out_0"]
    b = _ev(_rnl(0.0, 1.0, seed=2), {"x": x})["out_0"]
    assert not np.allclose(a, b)


# -- replay: lifted feeds and data-shaped outputs -------------------------


def test_replay_with_a_new_reshape_shape_input():
    """The target shape is a graph input: lifted to a host value, its
    value keys the plan, so a plan built for one shape never replays for
    another."""
    b = OnnxBuilder("reshape_in")
    b.input("x", DType.F32, [2, 6])
    b.input("shape", DType.I64, [2])
    b.node("Reshape", ["x", "shape"], outputs=["y"])
    b.output("y", DType.F32, ["a", "b"])
    m = Model.new_from_onnx(b.build())
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    for shape in ([3, 4], [4, 3], [3, 4], [12, 1]):
        y = _ev(m, {"x": x, "shape": np.asarray(shape, np.int64)})["y"]
        np.testing.assert_array_equal(y, x.reshape(shape))
    assert m.backend("torch", device="cpu").last_path == "torch"


def test_replay_with_a_new_topk_k_input():
    b = OnnxBuilder("topk_in")
    b.input("x", DType.F32, [3, 7])
    b.input("k", DType.I64, [1])
    b.node("TopK", ["x", "k"], outputs=["v", "i"], axis=1)
    b.output("v", DType.F32, [3, "k"])
    b.output("i", DType.I64, [3, "k"])
    m = Model.new_from_onnx(b.build())
    x = np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32)
    order = np.argsort(-x, axis=1, kind="stable")
    for k in (2, 5, 2, 7):
        out = _ev(m, {"x": x, "k": np.asarray([k], np.int64)})
        np.testing.assert_array_equal(out["i"], order[:, :k])
        np.testing.assert_array_equal(
            out["v"], np.take_along_axis(x, order[:, :k], axis=1))


def test_replay_with_a_new_nonzero_count_at_equal_shapes():
    """NonZero's output shape follows the data: a Shape read after it is
    folded afresh each run, never replayed from the first."""
    b = OnnxBuilder("nonzero_shape")
    b.input("x", DType.F32, [4, 5])
    nz = b.node("NonZero", ["x"])
    b.node("Shape", [nz], outputs=["n"])
    t = b.node("Transpose", [nz], perm=[1, 0])
    b.node("ReduceSum", [t, b.const_i64([0])], outputs=["s"], keepdims=0)
    b.output("n", DType.I64, [2])
    b.output("s", DType.I64, [2])
    m = Model.new_from_onnx(b.build())
    rng = np.random.default_rng(1)
    for density in (0.2, 0.7, 0.2, 1.0):
        x = (rng.uniform(size=(4, 5)) < density).astype(np.float32)
        want = np.asarray(np.nonzero(x))
        out = _ev(m, {"x": x})
        np.testing.assert_array_equal(out["n"], want.shape)
        np.testing.assert_array_equal(out["s"], want.sum(axis=1))


# -- the corpus as a whole ---------------------------------------------------

ALL_CASES = tc.cases_of(*tc.MODULES)


def test_the_selected_corpus_numbers_2353_cases():
    """(The name is the count before the recurrent, spectral and vision
    ops came: every case is selected now.)"""
    assert len(ALL_CASES) == 2453
    assert len(tc.selected(ALL_CASES)) == 2453
    vision = {"DeformConv", "GridSample", "AffineGrid", "RoiAlign",
              "Col2Im", "CenterCropPad", "NonMaxSuppression", "ImageDecoder"}
    assert sum(c.op_type in vision for c in tc.selected(ALL_CASES)) == 66


_BUNDLE_SCRIPT = r"""
import sys
sys.path[:0] = [sys.argv[2], sys.argv[3]]
import torch_conformance as tc
print("WROTE", tc.write_bundle(tc.Path(sys.argv[1])))
"""


def test_the_corpus_bundle_holds_the_selected_cases(tmp_path):
    """tests/torch_corpus.npz, which chip_smoke.py runs on the GPU, is the
    selected corpus as it stands, written afresh under the bundle's string
    hash seed: names, ONNX bytes, feeds, expected outputs, tolerances."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(tc.__file__).resolve().parent
    fresh = tmp_path / "corpus.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _BUNDLE_SCRIPT, str(fresh), str(tests),
         str(tests.parent)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONHASHSEED="0"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WROTE 2453" in proc.stdout
    want, got = tc.read_bundle(fresh), tc.read_bundle()
    assert [b.name for b in got] == [b.name for b in want]
    for g, w in zip(got, want):
        assert g.onnx == w.onnx, w.name
        assert (g.rtol, g.atol, g.op_type) == (w.rtol, w.atol, w.op_type)
        assert list(g.inputs) == list(w.inputs), w.name
        pairs = list(zip(g.inputs.values(), w.inputs.values()))
        for ge, we in zip(g.expected, w.expected):
            pairs += (list(zip(ge, we)) if isinstance(we, list)
                      else [(ge, we)])
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, w.name
            if a.dtype == np.dtype(object):
                assert list(a.reshape(-1)) == list(b.reshape(-1)), w.name
            else:
                assert a.tobytes() == b.tobytes(), w.name
