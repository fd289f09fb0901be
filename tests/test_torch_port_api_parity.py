"""The port's public surface against the JAX package's.

For every module of whisper_tensor_tpu/ that has a copy at the same path
in whisper_tensor_tpu_torch/, the JAX module's public functions and
classes (those it defines), and the methods of those classes (from the
class dicts along the JAX package's part of each MRO: `dir()` hides an
Enum class's methods), must exist in the port's module, read with
`getattr` (which sees Enum members too). What the port lacks must be
exactly the allow-list below, each entry with its reason: jax-only or
left out by design. A new gap fails the test, and so does an entry that
is no longer a gap.

The same holds for parameters: each parameter of each such function, of
each class (its constructor) and of each method (as the class resolves
it) is a parameter of the port's by name, and what the port lacks is
exactly the second allow-list, PARAMS_ALLOWED. `*args` and `**kwargs`
name no parameter.
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
}

PARAMS_ALLOWED = {
    # left out by design
    "interfaces.text:TextInferenceInterface(pad_batch_pow2)":
        "by design: pads a batch to a power of two, a v5e tiling cliff "
        "(ROADMAP, left out by design)",
    "parallel.pipeline:pipeline_apply(stacked_params)":
        "by design: an eager rank takes its local blocks, cut by "
        "local_block (parallel/pipeline.py), as local_params",
    "parallel.pipeline:pipeline_apply(param_specs)":
        "by design: an eager rank's blocks carry their specs through "
        "local_block (parallel/pipeline.py)",
    # jax-only
    "tensor:NumericTensor(backend)": "jax-only: numpy or jax storage",
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


def _params(f):
    """The names of f's parameters, None where it has no signature."""
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _unwrap(x):
    return x.__func__ if isinstance(x, (staticmethod, classmethod)) else x


def _param_gaps():
    """{"module:callable(param)"} for each parameter of a JAX callable
    that its port counterpart lacks."""
    gaps = set()

    def compare(label, ref_fn, port_fn):
        want, have = _params(ref_fn), _params(port_fn)
        if want is None or have is None:
            return
        gaps.update(f"{label}({p})" for p in want if p not in have)

    for key in _module_pairs():
        suffix = "." + key if key else ""
        ref = importlib.import_module("whisper_tensor_tpu" + suffix)
        port = importlib.import_module("whisper_tensor_tpu_torch" + suffix)
        for name, v in vars(ref).items():
            if name.startswith("_") or not (inspect.isfunction(v)
                                            or inspect.isclass(v)):
                continue
            if getattr(v, "__module__", None) != ref.__name__:
                continue
            mine = getattr(port, name, None)
            if mine is None:
                continue        # a missing name: the test above
            compare(f"{key}:{name}", v, mine)
            if not inspect.isclass(v):
                continue
            attrs = {a for c in v.__mro__
                     if c.__module__.startswith("whisper_tensor_tpu.")
                     for a, x in vars(c).items()
                     if not a.startswith("_")
                     and isinstance(x, _METHOD_TYPES)
                     and not isinstance(x, property)}
            for attr in attrs:
                theirs = _unwrap(inspect.getattr_static(v, attr))
                ours = inspect.getattr_static(mine, attr, None)
                if ours is not None and callable(_unwrap(ours)):
                    compare(f"{key}:{name}.{attr}", theirs, _unwrap(ours))
    return gaps


def test_the_parameters_the_port_lacks_are_the_allow_list():
    gaps = _param_gaps()
    new = sorted(gaps - set(PARAMS_ALLOWED))
    stale = sorted(set(PARAMS_ALLOWED) - gaps)
    assert not new, f"parameters the port lacks, not allowed: {new}"
    assert not stale, f"allow-list entries the port now has: {stale}"


def test_the_parameter_walk_sees_the_ported_parameters():
    """The walk reads the parameters this check was made for: a
    constructor's, a method's as its class resolves it, a function's."""
    from whisper_tensor_tpu.interfaces import text as jax_text
    from whisper_tensor_tpu_torch.interfaces import text, tts

    assert {"fuse_matmuls", "quantize_precomputed"} <= set(
        _params(text.TextInferenceInterface))
    assert "pad_batch_pow2" in _params(jax_text.TextInferenceInterface)
    assert "mode" in _params(_unwrap(inspect.getattr_static(
        tts.TextToSpeechInterface, "from_bundle")))


@pytest.mark.parametrize("entry", sorted(PARAMS_ALLOWED))
def test_each_parameter_entry_gives_a_reason(entry):
    assert PARAMS_ALLOWED[entry].startswith(("jax-only:", "by design:"))


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
    assert reason.startswith(("jax-only:", "by design:"))
