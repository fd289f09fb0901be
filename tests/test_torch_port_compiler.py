"""The port's compiler facade (whisper_tensor_tpu_torch/compiler.py)
against the JAX package's (whisper_tensor_tpu/compiler.py), on the CPU.

The three cases of tests/test_compiler_quant.py:13-56 run through both
facades on the same seeded feeds: a MatMul + tanh graph (outputs to 1e-5
relative, 1e-6 absolute, and op_census), a NonZero graph (the JAX
facade falls back to its interpreter; the port lowers NonZero, so it
stays on its torch path, with the same indices) and a Model whose
weights the program feeds from its store (uploaded once: a second run
uploads no byte). On the CPU a kind with no lowering (Binarizer, a
string kind) runs through its numpy eval as a step of the plan and the
program says why, while a step graph's caches are still written in place
over two steps; on the card (and in an executor not asked for host
steps) it raises NoLowering. Any other error propagates; with no device
named, the program asks for the card.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from whisper_tensor_tpu import compiler as ref  # noqa: E402
from whisper_tensor_tpu.milli import MilliGraph as RefMilli  # noqa: E402
from whisper_tensor_tpu.milli import ops as ref_ops  # noqa: E402
from whisper_tensor_tpu_torch import compiler as port  # noqa: E402
from whisper_tensor_tpu_torch.milli.ir import MilliGraph  # noqa: E402
from whisper_tensor_tpu_torch.milli import ops as port_ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _tanh_graph(G, O):
    g = G("p")
    x, w = g.add_input("x"), g.add_input("w")
    g.mark_output("y", g.op1(O.SimpleUnary("tanh"), g.op1(O.MatMul(), x, w)))
    return g


def _nonzero_graph(G, O):
    g = G("nz")
    x = g.add_input("x")
    g.mark_output("idx", g.op1(O.NonZero(), x))
    return g


def test_matmul_tanh_matches_the_jax_facade():
    feeds = {"x": np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32),
             "w": np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)}
    g = _tanh_graph(MilliGraph, port_ops)
    prog = port.build_program(port.CompilationSubject(milli=g), device="cpu")
    out = prog.run(feeds)
    want = ref.build_program(ref.CompilationSubject(
        milli=_tanh_graph(RefMilli, ref_ops)))
    want_out = want.run(feeds)
    assert (prog.backend, want.backend) == ("torch", "xla")
    np.testing.assert_allclose(out["y"], want_out["y"], **TOL)
    np.testing.assert_allclose(out["y"], np.tanh(feeds["x"] @ feeds["w"]),
                               **TOL)
    assert port.op_census(g) == {"MatMul": 1, "SimpleUnary": 1}
    assert port.op_census(g) == ref.op_census(_tanh_graph(RefMilli, ref_ops))
    np.testing.assert_allclose(out["y"],
                               port.interpret_milli_graph(g, feeds)["y"],
                               **TOL)
    assert prog.stats["op_count"] == 2 and prog.stats["compile_ms"] > 0
    assert "fallback_reason" not in prog.stats
    ref_g = _tanh_graph(RefMilli, ref_ops)
    for graph in (g, ref_g):
        graph.tensors[graph.nodes[0].outputs[0]].label = "mm"
    assert g.intermediate_labels() == ref_g.intermediate_labels()
    assert g.intermediate_labels()[g.nodes[0].outputs[0]] == "mm"


def test_nonzero_stays_on_the_torch_path_with_the_jax_indices():
    x = np.asarray([0.0, 3.0, 0.0, 1.0], dtype=np.float32)
    prog = port.build_program(port.CompilationSubject(
        milli=_nonzero_graph(MilliGraph, port_ops)), device="cpu")
    want = ref.build_program(ref.CompilationSubject(
        milli=_nonzero_graph(RefMilli, ref_ops)))
    out, want_out = prog.run({"x": x}), want.run({"x": x})
    assert (prog.backend, want.backend) == ("torch", "failed-xla")
    np.testing.assert_array_equal(out["idx"], want_out["idx"])
    np.testing.assert_array_equal(out["idx"], [[1, 3]])


def _feeder_model(pkg):
    import importlib

    DType = importlib.import_module(f"{pkg}.dtype").DType
    OnnxBuilder = importlib.import_module(
        f"{pkg}.importers.onnx_builder").OnnxBuilder
    Model = importlib.import_module(f"{pkg}.model").Model
    w = np.random.default_rng(0).standard_normal((2048, 4)).astype(np.float32)
    b = OnnxBuilder("m")
    b.input("x", DType.F32, [3, 2048])
    y = b.matmul("x", b.initializer("w", w))
    b.node("Identity", [y], outputs=["y"])
    b.output("y", DType.F32, [3, 4])
    return Model.new_from_onnx(b.build()), w


def test_a_models_weights_are_fed_from_its_store_and_uploaded_once():
    model, w = _feeder_model("whisper_tensor_tpu_torch")
    ref_model, _ = _feeder_model("whisper_tensor_tpu")
    prog = port.build_program(port.CompilationSubject(model=model),
                              device="cpu")
    want = ref.build_program(ref.CompilationSubject(model=ref_model))
    x = np.random.default_rng(1).standard_normal((3, 2048)).astype(np.float32)
    out = prog.run({"x": x})
    np.testing.assert_allclose(out["y"], want.run({"x": x})["y"], **TOL)
    np.testing.assert_allclose(out["y"], x @ w, rtol=1e-4, atol=1e-4)
    assert prog.stats["weight_bytes_uploaded"] == w.nbytes
    x2 = x[::-1].copy()
    np.testing.assert_allclose(prog.run({"x": x2})["y"],
                               want.run({"x": x2})["y"], **TOL)
    assert prog.stats["weight_bytes_uploaded"] == w.nbytes
    assert prog.backend == "torch"


def test_a_kind_without_a_lowering_falls_back_and_says_why():
    from whisper_tensor_tpu_torch.milli.ops.extra import BinarizerMilli

    g = MilliGraph("bin")
    x = g.add_input("x")
    g.mark_output("y", g.op1(port_ops.SimpleUnary("tanh"),
                             g.op1(BinarizerMilli(threshold=0.5), x)))
    prog = port.build_program(port.CompilationSubject(milli=g), device="cpu")
    xv = np.asarray([[0.2, 0.7], [0.9, -1.0]], np.float32)
    out = prog.run({"x": xv})
    assert prog.backend == "failed-torch"
    assert "Binarizer" in prog.stats["fallback_reason"]
    np.testing.assert_allclose(out["y"], np.tanh((xv > 0.5).astype(np.float32)),
                               **TOL)
    # later runs replay the plan, the host step among them
    np.testing.assert_allclose(prog.run({"x": -xv})["y"],
                               np.tanh((-xv > 0.5).astype(np.float32)), **TOL)


def _binarized_cache_step():
    """y = tanh(cache written at pos with Binarizer(x)): the write is the
    ragged cache write of a decode step, its update made by a kind with
    no lowering."""
    from whisper_tensor_tpu_torch.milli.ops.extra import BinarizerMilli
    from whisper_tensor_tpu_torch.milli.ops.misc import DynUpdateSliceMilli

    g = MilliGraph("step")
    cache, x, pos = g.add_input("cache_k"), g.add_input("x"), g.add_input("pos")
    upd = g.op1(BinarizerMilli(threshold=0.5), x)
    g.mark_output("y", g.op1(port_ops.SimpleUnary("tanh"),
                             g.op1(DynUpdateSliceMilli(axis=2), cache, upd,
                                   pos)))
    return g


def test_a_host_step_keeps_the_caches_written_in_place_over_two_steps():
    import torch

    g = _binarized_cache_step()
    prog = port.build_program(port.CompilationSubject(milli=g), device="cpu")
    rng = np.random.default_rng(5)
    cache = torch.zeros((1, 2, 4, 2))
    want = np.zeros((1, 2, 4, 2), np.float32)
    for step in range(2):
        x = rng.standard_normal((1, 2, 1, 2)).astype(np.float32)
        pos = np.asarray([step], np.int64)
        ref_out = g.eval({"cache_k": want.copy(), "x": x, "pos": pos})
        out = prog.run({"cache_k": cache, "x": x, "pos": pos})
        want[:, :, step] = (x[:, :, 0] > 0.5).astype(np.float32)
        np.testing.assert_array_equal(cache.numpy(), want)
        np.testing.assert_allclose(out["y"], np.tanh(want), **TOL)
        np.testing.assert_allclose(out["y"], ref_out["y"], **TOL)
    assert prog.backend == "failed-torch"
    assert "Binarizer" in prog.stats["fallback_reason"]


def test_an_executor_not_asked_for_host_steps_raises_no_lowering():
    import torch

    from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (
        GraphExecutor, NoLowering)

    g = _binarized_cache_step()
    cache = torch.zeros((1, 2, 4, 2))
    feeds = {"cache_k": cache, "x": torch.ones((1, 2, 1, 2)),
             "pos": torch.zeros((1,), dtype=torch.int64)}
    with pytest.raises(NoLowering, match="Binarizer"):
        GraphExecutor(g, torch.device("cpu"))(feeds)
    with pytest.raises(ValueError, match="CPU only"):
        GraphExecutor(g, torch.device("cuda"), host_ops=True)


@pytest.mark.cuda
def test_on_the_card_a_kind_without_a_lowering_raises():
    import torch

    from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (
        NoLowering)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    prog = port.build_program(port.CompilationSubject(
        milli=_binarized_cache_step()))
    cache = torch.zeros((1, 2, 4, 2), device="cuda")
    with pytest.raises(NoLowering, match="Binarizer"):
        prog.run({"cache_k": cache, "x": np.ones((1, 2, 1, 2), np.float32),
                  "pos": np.zeros((1,), np.int64)})
    assert prog.backend == "torch" and "fallback_reason" not in prog.stats


def test_a_string_value_of_a_host_step_stays_on_the_host():
    from whisper_tensor_tpu_torch.milli.ops.extra import (LabelEncoderMilli,
                                                          StringConcatMilli)

    g = MilliGraph("str")
    ids, suffix = g.add_input("ids"), g.add_input("suffix")
    names = g.op1(LabelEncoderMilli(keys=[0, 1, 2], values=["a", "b", "c"],
                                    default="?", value_is_string=True),
                  g.op1(port_ops.SimpleBinary("add"), ids, ids))
    g.mark_output("s", g.op1(StringConcatMilli(), names, suffix))
    prog = port.build_program(port.CompilationSubject(milli=g), device="cpu")
    feeds = {"ids": np.asarray([0, 1, 3], np.int64),
             "suffix": np.asarray(["!", "?", "."], dtype=object)}
    out = prog.run(feeds)
    assert list(out["s"]) == ["a!", "c?", "?."]
    assert list(out["s"]) == list(g.eval(feeds)["s"])
    assert prog.backend == "failed-torch"
    reason = prog.stats["fallback_reason"]
    assert "LabelEncoder" in reason and "StringConcat" in reason


def test_an_error_that_is_not_a_missing_lowering_propagates():
    prog = port.build_program(port.CompilationSubject(
        milli=_tanh_graph(MilliGraph, port_ops)), device="cpu")
    with pytest.raises(RuntimeError):
        prog.run({"x": np.zeros((2, 4), np.float32),
                  "w": np.zeros((5, 3), np.float32)})
    assert prog.backend == "torch" and "fallback_reason" not in prog.stats


def test_the_program_runs_on_the_card_unless_asked_for_the_cpu():
    import torch

    subject = port.CompilationSubject(milli=_tanh_graph(MilliGraph, port_ops))
    if torch.cuda.is_available():
        assert port.build_program(subject).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port.build_program(subject)
    assert port.build_program(subject, device="cpu").device.type == "cpu"

