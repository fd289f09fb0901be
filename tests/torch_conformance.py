"""The conformance corpus through the PyTorch port (helper of
tests/test_torch_conformance_*.py).

Each case of tests/conformance/cases_*.py is built into ONNX bytes with
the port's own OnnxBuilder (a case's custom graph builder runs with the
port's builder in place of the JAX package's), run through the port's
`Model.eval(..., device="cpu")` and held to the case's independent
oracle by the rules of tests/conformance/harness.py:98-129 (`check_case`):
`assert_allclose` at the case's rtol/atol for floats, exact for integers
and strings. Every case is selected: the port has every op type of the
corpus.

The selected cases are also kept as a bundle, torch_corpus.npz beside
this file: each case's ONNX bytes (the port's builder), feeds, expected
outputs and tolerances, so that chip_smoke.py runs the corpus on the GPU
with the port alone (the case modules import the JAX package). Some case
modules seed their data from hash(name), which varies with the process's
string hash seed; the bundle is written with PYTHONHASHSEED=0. Rewrite
it after a change to the corpus with

    PYTHONPATH=. python tests/torch_conformance.py --write

(tests/test_torch_conformance_control.py holds it to the cases).
"""

from __future__ import annotations

import importlib
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

from whisper_tensor_tpu_torch import onnx_pb as port_pb
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.importers.onnx_builder import (OnnxBuilder,
                                                             WeightStorage)
from whisper_tensor_tpu_torch.model import Model

# the corpus modules, in tests/conformance/test_conformance.py's order
MODULES = ("cases_elementwise", "cases_shape", "cases_nn", "cases_dtypes",
           "cases_reduce2", "cases_pool", "cases_misc2", "cases_more",
           "cases_breadth", "cases_attention", "cases_norm_family",
           "cases_sce", "cases_ref_resize", "cases_newops",
           "cases_ref_reduce", "cases_ref_misc", "cases_ref_final",
           "cases_ref_last", "cases_sequence")


def cases_of(*modules: str) -> List:
    out = []
    for m in modules:
        out += importlib.import_module(f"conformance.{m}").CASES
    return out


def selected(cases) -> List:
    """The cases the port runs: all of them."""
    return list(cases)


def _port_attr(v):
    """An attribute value built with the JAX package's builder (a nested
    graph) re-read as the port's proto: same wire bytes."""
    if type(v).__module__.startswith("whisper_tensor_tpu.") and \
            hasattr(v, "dumps"):
        return getattr(port_pb, type(v).__name__).parse(v.dumps())
    return v


class _Bytes:
    """Stands in for the JAX package's Model in a case's builder: keeps
    the ONNX bytes the builder produced."""

    @staticmethod
    def new_from_onnx(data, base_dir=None, name=""):
        return data


def onnx_bytes(case) -> bytes:
    """The case's graph, built with the port's OnnxBuilder."""
    if case.builder is not None:
        mod = sys.modules[case.builder.__module__]
        names = ("OnnxBuilder", "Model", "DType", "WeightStorage")
        saved = [getattr(mod, n) for n in names]
        for n, v in zip(names, (OnnxBuilder, _Bytes, DType, WeightStorage)):
            setattr(mod, n, v)
        try:
            return case.builder(case)
        finally:
            for n, v in zip(names, saved):
                setattr(mod, n, v)
    b = OnnxBuilder(case.name, opset=case.opset,
                    custom_opsets={"wt": 1} if case.domain else None)
    in_names = []
    for n, v in case.inputs.items():
        if v is None:      # absent optional input -> empty-name slot
            in_names.append("")
            continue
        v = np.asarray(v)
        if n in case.initializer_names:
            b.initializer(n, v)
        else:
            b.input(n, DType.from_numpy(v.dtype), list(v.shape))
        in_names.append(n)
    out_names = [f"out_{k}" for k in range(len(case.expected))]
    b.node(case.op_type, in_names, outputs=out_names, domain=case.domain,
           **{k: _port_attr(v) for k, v in case.attrs.items()})
    for nm, e in zip(out_names, case.expected):
        if isinstance(e, list):
            el = np.asarray(e[0]) if e else np.zeros(0, np.float32)
            b.output(nm, DType.from_numpy(el.dtype), [])
            continue
        e = np.asarray(e)
        b.output(nm, DType.from_numpy(e.dtype), list(e.shape))
    return b.build()


def port_model(case) -> Model:
    return Model.new_from_onnx(onnx_bytes(case), name=case.name)


def feeds_of(case) -> Dict[str, np.ndarray]:
    return {n: v for n, v in case.inputs.items()
            if n not in case.initializer_names and v is not None}


def _is_float(dt: np.dtype) -> bool:
    if dt.kind in "fc":
        return True
    try:
        import ml_dtypes

        ml_dtypes.finfo(dt)
        return True
    except Exception:
        return False


def check_outputs(case, out, rtol=None, atol=None) -> float:
    """check_case's comparison (harness.py:98-129) of `out` against the
    case's expected values; returns the worst float error as a share of
    the tolerance (0 for exact outputs)."""
    rtol = case.rtol if rtol is None else rtol
    atol = case.atol if atol is None else atol
    worst = 0.0

    def share(got, exp):
        g, e = got.astype(np.float64), exp.astype(np.float64)
        ok = np.isfinite(e) & np.isfinite(g)
        if not ok.any():
            return 0.0
        err = np.abs(g[ok] - e[ok])
        tol = atol + rtol * np.abs(e[ok])
        share = np.where(tol > 0, err / np.where(tol > 0, tol, 1.0),
                         np.where(err > 0, np.inf, 0.0))
        return float(share.max()) if share.size else 0.0

    for k, expected in enumerate(case.expected):
        if isinstance(expected, list):
            got_seq = out[f"out_{k}"]
            assert isinstance(got_seq, list), \
                f"{case.name}: expected a sequence, got {type(got_seq)}"
            assert len(got_seq) == len(expected), \
                f"{case.name}: sequence length {len(got_seq)} != " \
                f"{len(expected)}"
            for gi, ei in zip(got_seq, expected):
                np.testing.assert_allclose(
                    np.asarray(gi, dtype=np.float64),
                    np.asarray(ei, dtype=np.float64), rtol=rtol, atol=atol,
                    err_msg=case.name, equal_nan=True)
            continue
        got = np.asarray(out[f"out_{k}"])
        expected = np.asarray(expected)
        assert got.shape == expected.shape, \
            f"{case.name}: shape {got.shape} != {expected.shape}"
        if expected.dtype == np.dtype(object):
            assert list(got.reshape(-1)) == list(expected.reshape(-1))
        elif _is_float(expected.dtype) or _is_float(got.dtype):
            np.testing.assert_allclose(
                got.astype(np.float64), expected.astype(np.float64),
                rtol=rtol, atol=atol, err_msg=case.name, equal_nan=True)
            worst = max(worst, share(got, expected))
        else:
            np.testing.assert_array_equal(got, expected, err_msg=case.name)
    return worst


def check_port_case(case, device="cpu") -> str:
    """Run one case through the port; returns the backend's last_path,
    which is the host interpreter's exactly when the graph holds what
    torch cannot (strings, sequences, optionals, ai.onnx.ml)."""
    model = port_model(case)
    be = model.backend("torch", device=device)
    out = be.run(model.graph, feeds_of(case))
    check_outputs(case, out)
    assert (be.last_path == "oracle") == model.graph.needs_host_eval(), \
        (case.name, be.last_path)
    return be.last_path


# -- the bundle -------------------------------------------------------------

BUNDLE = Path(__file__).with_name("torch_corpus.npz")


@dataclass
class BundleCase:
    """A corpus case as the bundle keeps it (the fields check_outputs and
    feeds_of read, and the case's ONNX bytes)."""

    name: str
    op_type: str
    onnx: bytes
    inputs: Dict[str, np.ndarray]
    expected: list
    rtol: float
    atol: float
    initializer_names: tuple = field(default_factory=tuple)


def _pack(arrays: dict, meta: dict, key: str, value) -> None:
    v = np.asarray(value)
    if v.dtype == np.dtype(object):
        arrays[key] = v.astype(str)
        meta[key] = ["object", list(v.shape)]
    else:
        arrays[key] = np.frombuffer(np.ascontiguousarray(v).tobytes(),
                                    np.uint8)
        meta[key] = [v.dtype.name, list(v.shape)]


def _unpack(z, meta: dict, key: str) -> np.ndarray:
    import ml_dtypes  # noqa: F401  (registers the bf16/f8/f4 names)

    name, shape = meta[key]
    if name == "object":
        return z[key].astype(object).reshape(shape)
    return np.frombuffer(z[key].tobytes(), np.dtype(name)).reshape(shape)


def write_bundle(path: Path = BUNDLE) -> int:
    arrays, meta, cases = {}, {}, []
    for i, case in enumerate(selected(cases_of(*MODULES))):
        arrays[f"{i}.onnx"] = np.frombuffer(onnx_bytes(case), np.uint8)
        feeds = feeds_of(case)
        for j, v in enumerate(feeds.values()):
            _pack(arrays, meta, f"{i}.in.{j}", v)
        outs = []
        for k, e in enumerate(case.expected):
            if isinstance(e, list):
                for j, el in enumerate(e):
                    _pack(arrays, meta, f"{i}.out.{k}.{j}", el)
                outs.append(len(e))
            else:
                _pack(arrays, meta, f"{i}.out.{k}", e)
                outs.append(None)
        cases.append({"name": case.name, "op_type": case.op_type,
                      "rtol": case.rtol, "atol": case.atol,
                      "inputs": list(feeds), "outputs": outs})
    blob = json.dumps({"cases": cases, "arrays": meta}).encode()
    np.savez_compressed(path, meta=np.frombuffer(blob, np.uint8), **arrays)
    return len(cases)


def read_bundle(path: Path = BUNDLE) -> List[BundleCase]:
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes())
        arrays = meta["arrays"]
        out = []
        for i, c in enumerate(meta["cases"]):
            inputs = {n: _unpack(z, arrays, f"{i}.in.{j}")
                      for j, n in enumerate(c["inputs"])}
            expected = []
            for k, n in enumerate(c["outputs"]):
                expected.append(
                    _unpack(z, arrays, f"{i}.out.{k}") if n is None else
                    [_unpack(z, arrays, f"{i}.out.{k}.{j}")
                     for j in range(n)])
            out.append(BundleCase(c["name"], c["op_type"],
                                  z[f"{i}.onnx"].tobytes(), inputs,
                                  expected, c["rtol"], c["atol"]))
    return out


if __name__ == "__main__":
    import os

    if os.environ.get("PYTHONHASHSEED") != "0":
        # some case modules seed their data from hash(name): write the
        # bundle under one fixed string hash
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED="0"))
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python tests/torch_conformance.py "
                 "--write")
    print(f"wrote {write_bundle()} cases to {BUNDLE}")
