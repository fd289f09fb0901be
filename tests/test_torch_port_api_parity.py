"""The port's public surface against the JAX package's.

For every module of whisper_tensor_tpu/ that has a copy at the same path
in whisper_tensor_tpu_torch/, the JAX module's public functions and
classes (those it defines), and the methods of those classes (from the
class dicts along the JAX package's part of each MRO: `dir()` hides an
Enum class's methods), must exist in the port's module, read with
`getattr` (which sees Enum members too). What the port lacks must be
exactly the allow-list below, each entry with its reason: jax-only,
left out by design, or queued under its ROADMAP item. A new gap fails
the test, and so does an entry that is no longer a gap.
"""

import importlib
import inspect
import types
from pathlib import Path

import pytest

pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]

# methods of this name are jax-only wherever they stand
JAX_ONLY_METHODS = {"to_jax": "jax-only: lowers a milli op to jax.numpy"}

ALLOWED = {
    # jax-only
    "dtype:DType.to_jax": "jax-only: the jnp dtype",
    "tensor:NumericTensor.from_jax": "jax-only: wraps a jax.Array",
    "tensor:NumericTensor.jax": "jax-only: materializes a jax.Array",
    "tensor:NumericTensor.backend": "jax-only: numpy or jax storage",
    "tensor:NumericTensor.to_backend": "jax-only: numpy or jax storage",
    "tensor:NumericTensor.raw": "jax-only: the numpy or jax array",
    "milli.ops.norm:jax_rsqrt": "jax-only: an XLA rsqrt",
    # left out by design: windowed decode (a v5e KV-read trick)
    "importers.lora:LoraMergedStore.meta": "by design: windowed decode",
    "importers.lora:LoraMergedStore.zeros_getter":
        "by design: windowed decode",
    "importers.quantized:QuantizedStore.meta": "by design: windowed decode",
    "importers.quantized:QuantizedStore.zeros_getter":
        "by design: windowed decode",
    "interfaces.text:TextInferenceInterface.window_cache_dims":
        "by design: windowed decode",
    # queued: ROADMAP A15, in its order
    "interfaces.text:TextInferenceInterface.decode_tokens": "queued: A15",
    "milli.transforms:apply_matmul_fusion": "queued: A15",
    "symbolic_graph.ir:SymbolicGraph.producer_of": "queued: A15",
    "symbolic_graph.ops.base:opset_of": "queued: A15",
    "dtype:DType.is_numeric": "queued: A15",
    "dtype:DType.bits": "queued: A15",
    "dtype:AnyDType": "queued: A15",
    "dtype:promote": "queued: A15",
    "milli.ops.common:np_dtype_of": "queued: A15",
    "tensor:NumericTensor.scalar": "queued: A15",
    "tensor:NumericTensor.item": "queued: A15",
    "tensor:NumericTensor.has_nan": "queued: A15",
    "tensor:as_tensor": "queued: A15",
}


def _module_pairs():
    pairs = []
    for p in sorted((ROOT / "whisper_tensor_tpu").rglob("*.py")):
        rel = p.relative_to(ROOT / "whisper_tensor_tpu").with_suffix("")
        if not (ROOT / "whisper_tensor_tpu_torch" / p.relative_to(
                ROOT / "whisper_tensor_tpu")).exists():
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        pairs.append(".".join(parts))
    return pairs


_METHOD_TYPES = (types.FunctionType, staticmethod, classmethod, property)


def _gaps():
    gaps = set()
    for key in _module_pairs():
        suffix = "." + key if key else ""
        ref = importlib.import_module("whisper_tensor_tpu" + suffix)
        port = importlib.import_module("whisper_tensor_tpu_torch" + suffix)
        for name, v in vars(ref).items():
            if name.startswith("_") or not (inspect.isfunction(v)
                                            or inspect.isclass(v)):
                continue
            if getattr(v, "__module__", None) != ref.__name__:
                continue        # imported there, defined elsewhere
            mine = getattr(port, name, None)
            if mine is None:
                gaps.add(f"{key}:{name}")
                continue
            if not inspect.isclass(v):
                continue
            for c in v.__mro__:
                if not c.__module__.startswith("whisper_tensor_tpu."):
                    continue
                for attr, x in vars(c).items():
                    if (not attr.startswith("_")
                            and isinstance(x, _METHOD_TYPES)
                            and getattr(mine, attr, None) is None):
                        gaps.add(f"{key}:{name}.{attr}")
    return gaps


def test_what_the_port_lacks_is_the_allow_list():
    gaps = _gaps()
    by_rule = {g for g in gaps if g.rsplit(".", 1)[-1] in JAX_ONLY_METHODS}
    assert by_rule, "the jax-only method rule matches no gap: drop it"
    new = sorted(gaps - by_rule - set(ALLOWED))
    stale = sorted(set(ALLOWED) - gaps)
    assert not new, f"public names the port lacks, not allowed: {new}"
    assert not stale, f"allow-list entries the port now has: {stale}"


def test_the_pairs_cover_the_new_modules():
    pairs = set(_module_pairs())
    assert {"compiler", "milli.validate_infer", "importers.pth",
            "importers.onnx_builder", "symbolic_graph.tensor_store",
            "server.main"} <= pairs
    assert "" in pairs      # the package's own __init__


@pytest.mark.parametrize("entry", sorted(ALLOWED))
def test_each_entry_gives_a_reason(entry):
    reason = ALLOWED[entry]
    assert reason.startswith(("jax-only:", "by design:", "queued: A"))
