"""GPTQ / AWQ checkpoints on the port, against the JAX package.

The port's importers/quantized.py is a copy of the reference's: the
GPTQ (classic and gptq_v2) and AWQ packers and unpackers, dequant_dense
(with act-order g_idx) and repack_for_kernel must give the reference's
bytes on the same seeded inputs. The one rule the port drops is the
reference's N % 128 (the TPU's lane width): the port's packed_matmul
takes any N, so a 64-column projection packs too.

End to end, the reference's own tiny GPTQ/AWQ llama writer
(tests/test_gptq_awq.py:_write_quantized_llama: 2 layers, hidden 128,
4 query and 2 KV heads, vocab 130, groups of 64) is loaded by both
packages' TransformersLoader at f32 on the CPU: the port's logits must
stand the reference's to 1e-5 relative and 1e-4 absolute (both compute
W = q * s - z * s in f32 and sum in another order), its quantized
Linears must each run as a PackedMatMul node, and act-order (desc_act)
weights must stay dense, as in the reference. A tiny GPTQ/AWQ GPT-2
(_write_quantized_gpt2) holds its greedy tokens to the reference's.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from whisper_tensor_tpu.importers import quantized as ref_q  # noqa: E402
from whisper_tensor_tpu_torch.importers import quantized as port_q  # noqa: E402

from tests.test_gptq_awq import _write_quantized_llama  # noqa: E402

K, N = 256, 192


def _random_quant(seed, k=K, n=N, g=64):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (k, n)).astype(np.uint8)
    zeros = rng.integers(1, 16, (k // g, n)).astype(np.float32)
    scales = rng.random((k // g, n), dtype=np.float32) * 0.1 + 0.01
    return q, zeros, scales


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_gptq_pack_and_unpack_are_the_references(v2, g):
    q, zeros, scales = _random_quant(1, g=g)
    spec_r = ref_q.QuantSpec("gptq", 4, g, v2=v2)
    spec_p = port_q.QuantSpec("gptq", 4, g, v2=v2)
    packed = port_q.pack_gptq(q, zeros, scales, spec_p)
    _assert_same(packed, ref_q.pack_gptq(q, zeros, scales, spec_r))
    qw, qz, sc = packed
    _assert_same(port_q.unpack_gptq(qw, qz, sc.astype(np.float32), spec_p),
                 ref_q.unpack_gptq(qw, qz, sc.astype(np.float32), spec_r))


@pytest.mark.parametrize("g", [32, 64, 128])
def test_awq_pack_and_unpack_are_the_references(g):
    q, zeros, scales = _random_quant(2, g=g)
    spec_r, spec_p = ref_q.QuantSpec("awq", 4, g), port_q.QuantSpec("awq", 4, g)
    packed = port_q.pack_awq(q, zeros, scales, spec_p)
    _assert_same(packed, ref_q.pack_awq(q, zeros, scales, spec_r))
    qw, qz, sc = packed
    got = port_q.unpack_awq(qw, qz, sc.astype(np.float32), spec_p)
    _assert_same(got, ref_q.unpack_awq(qw, qz, sc.astype(np.float32), spec_r))
    np.testing.assert_array_equal(got[0], q)


@pytest.mark.parametrize("act_order", [False, True])
def test_dequant_dense_is_the_references(act_order):
    q, zeros, scales = _random_quant(3)
    g_idx = (np.random.default_rng(4).integers(0, K // 64, K)
             if act_order else None)
    _assert_same([port_q.dequant_dense(q, zeros, scales, g_idx)],
                 [ref_q.dequant_dense(q, zeros, scales, g_idx)])


@pytest.mark.parametrize("g", [64, 128])
def test_repack_for_kernel_is_the_references(g):
    """q, scales, offsets and bits byte for byte; the port adds has_off
    (zero points make offsets)."""
    q, zeros, scales = _random_quant(5, n=256, g=g)
    ref = ref_q.repack_for_kernel(q, zeros, scales)
    got = port_q.repack_for_kernel(q, zeros, scales)
    assert set(got) == set(ref) | {"has_off"} and bool(got["has_off"])
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype
        assert np.asarray(got[k]).tobytes() == np.asarray(ref[k]).tobytes()


@pytest.mark.parametrize("n,g,k", [(64, 64, 256), (1024 + 40, 128, 256),
                                   (8, 32, 128)])
def test_repack_takes_any_n_the_kernel_takes(n, g, k):
    """The reference's N % 128 lane rule is dropped: these N pack on
    the port (the reference returns None), with the reference's layout
    rule for every byte."""
    q, zeros, scales = _random_quant(6, k=k, n=n, g=g)
    assert ref_q.repack_for_kernel(q, zeros, scales) is None
    got = port_q.repack_for_kernel(q, zeros, scales)
    half = k // 2
    np.testing.assert_array_equal(got["q"] & 0xF, q[:half])
    np.testing.assert_array_equal(got["q"] >> 4, q[half:])
    np.testing.assert_array_equal(got["offsets"],
                                  (zeros * scales).astype(np.float32))


@pytest.mark.parametrize("k,g", [(200, 8), (256, 96)])
def test_repack_refuses_what_the_kernel_refuses(k, g):
    """K not a multiple of 16, or groups not dividing K: no layout."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 16, (k, 128)).astype(np.uint8)
    n_groups = -(-k // g)
    zeros = np.ones((n_groups, 128), np.float32)
    assert port_q.repack_for_kernel(q, zeros, zeros) is None


@pytest.mark.parametrize("g", [64, 128])
def test_packed_matmul_plain_on_the_gptq_layout(g):
    """The port's packed_matmul (its plain version, on CPU tensors) on
    a repack_for_kernel layout equals x @ dequant_dense to f32 rounding
    (q*s - z*s against (q - z)*s: 1e-5 relative, 1e-4 absolute)."""
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)

    q, zeros, scales = _random_quant(8, n=200, g=g)
    rp = port_q.repack_for_kernel(q, zeros, scales)
    x = np.random.default_rng(9).standard_normal((5, K)).astype(np.float32)
    got = packed_matmul(torch.from_numpy(x), torch.from_numpy(rp["q"]),
                        torch.from_numpy(rp["scales"]),
                        torch.from_numpy(rp["offsets"]), 4,
                        bool(rp["has_off"]))
    want = x @ ref_q.dequant_dense(q, zeros, scales)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_quantized_store_is_the_references(tmp_path):
    """names, dense loads and the packed source of a GPTQ checkpoint
    with a sibling bias and an act-order module."""
    from safetensors.numpy import save_file

    from whisper_tensor_tpu.importers.safetensors_io import (
        SafetensorsStore as RefStore)
    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)

    g = 64
    q, zeros, scales = _random_quant(10, g=g)
    spec = port_q.QuantSpec("gptq", 4, g)
    qw, qz, sc = port_q.pack_gptq(q, zeros, scales, spec)
    g_idx = np.random.default_rng(11).permutation(
        np.repeat(np.arange(K // g), g)).astype(np.int32)
    path = str(tmp_path / "model.safetensors")
    save_file({"m.qweight": qw, "m.qzeros": qz, "m.scales": sc,
               "m.bias": np.ones(N, np.float32),
               "a.qweight": qw, "a.qzeros": qz, "a.scales": sc,
               "a.g_idx": g_idx}, path)
    ref = ref_q.QuantizedStore(RefStore([path]),
                               ref_q.QuantSpec("gptq", 4, g))
    port = port_q.QuantizedStore(SafetensorsStore([path]), spec)
    assert sorted(port.names()) == sorted(ref.names()) == [
        "a.weight", "m.bias", "m.weight"]
    for name in ("m.weight", "a.weight", "m.bias"):
        assert port.load(name).tobytes() == ref.load(name).tobytes()
    assert port.packed_source("a.weight")() is None      # act-order: dense
    assert port.packed_source("m.bias") is None
    # N = 192 is not a multiple of 128: the reference leaves it dense
    assert ref.packed_source("m.weight")() is None
    got = port.packed_source("m.weight")()
    want = port_q.repack_for_kernel(q, zeros, sc.astype(np.float32))
    for k in ("q", "scales", "offsets"):
        np.testing.assert_array_equal(got[k], want[k])


def _loaded(d, package):
    """(interface, model) of the tiny checkpoint through `package`'s
    TransformersLoader at f32 (the port's on the CPU)."""
    if package == "jax":
        from whisper_tensor_tpu.importers.loaders import loader_registry
        from whisper_tensor_tpu.interfaces.text import TextInferenceInterface
        kw = {}
    else:
        from whisper_tensor_tpu_torch.importers.loaders import loader_registry
        from whisper_tensor_tpu_torch.interfaces.text import (
            TextInferenceInterface)
        kw = {"device": "cpu"}
    bundle = loader_registry()["transformers"].load(
        {"path": str(d), "dtype": "f32", "max_len": 64})
    model = next(iter(bundle.models.values()))
    return TextInferenceInterface(model, max_len=64, prompt_buckets=(16,),
                                  **kw), model


@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_loader_end_to_end(tmp_path, method):
    """Every quantized Linear records a packed source (14), runs as one
    PackedMatMul node (q, k, v, o and down alone, gate and up fused: 6
    a layer; the reference packs 4, its k/v of 64 columns staying
    dense), and the logits stand the reference's."""
    d, _ = _write_quantized_llama(tmp_path, method)
    ref, _ = _loaded(d, "jax")
    port, model = _loaded(d, "port")
    assert len(model.graph.store.packed_sources) == 14
    assert len(ref._packed) == 8
    assert len(port._packed) == 12
    assert any(n.endswith("::fused2") for n in port._packed)
    kinds = [node.op.KIND for node in port._exec.graph.nodes]
    assert kinds.count("PackedMatMul") == 12
    assert "QuantMatMul" not in kinds
    ids = np.random.default_rng(0).integers(0, 130, (2, 9)).astype(np.int64)
    want = np.asarray(ref.logits(ids))
    got = port.logits(ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(port.generate_tokens(ids, 6),
                                  ref.generate_tokens(ids, 6))


def test_act_order_checkpoint_stays_dense(tmp_path):
    """A GPTQ checkpoint with desc_act (a permuted g_idx on every
    Linear): no packed node, and the logits stand the reference's."""
    from safetensors.numpy import load_file, save_file

    d, _ = _write_quantized_llama(tmp_path, "gptq")
    sd = load_file(str(d / "model.safetensors"))
    rng = np.random.default_rng(12)
    for name in [n for n in sd if n.endswith(".qweight")]:
        k = sd[name].shape[0] * 8
        sd[name[:-8] + ".g_idx"] = rng.permutation(
            np.arange(k) // 64).astype(np.int32)
    save_file(sd, str(d / "model.safetensors"))
    cfg = json.loads((d / "config.json").read_text())
    cfg["quantization_config"]["desc_act"] = True
    (d / "config.json").write_text(json.dumps(cfg))
    ref, _ = _loaded(d, "jax")
    port, _ = _loaded(d, "port")
    assert port._packed == {}
    ids = np.random.default_rng(1).integers(0, 130, (1, 7)).astype(np.int64)
    np.testing.assert_allclose(port.logits(ids), np.asarray(ref.logits(ids)),
                               rtol=1e-5, atol=1e-4)


def _write_quantized_gpt2(tmp_path, method: str, g: int = 64):
    """A tiny GPT-2 checkpoint (2 layers, n_embd 128, 2 heads, vocab 130)
    with every Conv1D in GPTQ/AWQ format, as _write_quantized_llama
    writes its llama: the quantized matrix is the Conv1D's own (in, out)
    weight, as GPTQ/AWQ packers take it. Every width is a multiple of
    128, so each quantized weight packs in both packages. Returns (dir,
    {HF name: dense f32 (in, out) weight as dequantized})."""
    from safetensors.numpy import save_file

    E, V = 128, 130
    rng = np.random.default_rng(8)
    spec = ref_q.QuantSpec(method, 4, g)
    pack = ref_q.pack_gptq if method == "gptq" else ref_q.pack_awq
    qcfg = ({"quant_method": "gptq", "bits": 4, "group_size": g,
             "desc_act": False, "sym": True} if method == "gptq" else
            {"quant_method": "awq", "bits": 4, "group_size": g,
             "version": "gemm", "zero_point": True})
    sd, dense = {}, {}

    def dense_w(name, shape, scale=0.05):
        sd[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def conv1d(mod, k_in, n_out):
        q = rng.integers(0, 16, (k_in, n_out)).astype(np.uint8)
        zeros = rng.integers(1, 15, (k_in // g, n_out)).astype(np.float32)
        scales = rng.random((k_in // g, n_out), dtype=np.float32) * 0.01 \
            + 0.001
        qw, qz, sc = pack(q, zeros, scales, spec)
        sd[mod + ".qweight"], sd[mod + ".qzeros"] = qw, qz
        sd[mod + ".scales"] = sc
        dense[mod + ".weight"] = ref_q.dequant_dense(
            q, zeros, sc.astype(np.float32))
        dense_w(mod + ".bias", (n_out,))

    dense_w("transformer.wte.weight", (V, E), 0.5)
    dense_w("transformer.wpe.weight", (64, E))
    for n in ("weight", "bias"):
        dense_w(f"transformer.ln_f.{n}", (E,))
    sd["transformer.ln_f.weight"] += 1.0
    for i in range(2):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            dense_w(p + ln + ".weight", (E,))
            sd[p + ln + ".weight"] += 1.0
            dense_w(p + ln + ".bias", (E,))
        conv1d(p + "attn.c_attn", E, 3 * E)
        conv1d(p + "attn.c_proj", E, E)
        conv1d(p + "mlp.c_fc", E, 4 * E)
        conv1d(p + "mlp.c_proj", 4 * E, E)
    d = tmp_path / f"tiny-gpt2-{method}"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "gpt2", "n_layer": 2, "n_head": 2, "n_embd": E,
        "vocab_size": V, "n_positions": 64,
        "quantization_config": qcfg}))
    save_file(sd, str(d / "model.safetensors"))
    return d, {**{k: v for k, v in sd.items() if not k.endswith(
        (".qweight", ".qzeros", ".scales"))}, **dense}


@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_gptq_gpt2_is_refused(tmp_path, method):
    """GPTQ/AWQ GPT-2 checkpoints were refused while the port's GPT-2
    recipe recorded no weight map. They load now: each quantized Conv1D
    records a packed source under its initializer name (8 PackedMatMul
    nodes), greedy tokens equal the JAX package's on the same checkpoint
    (every weight packs in both), and the logits stand those of a dense
    GPT-2 built from the dequantized (in, out) weights to 1e-5 relative
    and 1e-4 absolute. The dense weights the port's loader hands the
    recipe keep Conv1D's (in, out) layout (QuantizedStore(linear=False));
    the reference transposes them to (out, in), which its dense path
    cannot run, so only its packed path is compared."""
    from whisper_tensor_tpu.interfaces.text import (
        TextInferenceInterface as JaxTextInterface)
    from whisper_tensor_tpu.importers.loaders import (
        loader_registry as jax_loaders)
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import loader_registry
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step)
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.model import Model

    d, dense = _write_quantized_gpt2(tmp_path, method)
    cfg = {"path": str(d), "dtype": "f32", "max_len": 64}
    pb = loader_registry()["transformers"].load(cfg)
    model = next(iter(pb.models.values()))
    assert len(model.graph.store.packed_sources) == 8
    port = TextInferenceInterface(model, max_len=64, prompt_buckets=(16,),
                                  device="cpu")
    assert sum(n.op.KIND == "PackedMatMul"
               for n in port._exec.graph.nodes) == 8
    jb = jax_loaders()["transformers"].load(cfg)
    ref = JaxTextInterface(next(iter(jb.models.values())), max_len=64,
                           prompt_buckets=(16,))
    assert len(ref._packed) == 8
    ids = np.random.default_rng(2).integers(0, 130, (2, 9)).astype(np.int64)
    np.testing.assert_array_equal(port.generate_tokens(ids, 8),
                                  np.asarray(ref.generate_tokens(ids, 8)))
    gcfg = GPT2Config(n_layer=2, n_head=2, n_embd=128, vocab_size=130,
                      n_positions=64)
    plain = TextInferenceInterface(
        Model.new_from_onnx(build_gpt2_step(dense.__getitem__, gcfg,
                                            max_len=64, dtype=DType.F32)),
        max_len=64, prompt_buckets=(16,), device="cpu")
    want = plain.logits(ids)
    np.testing.assert_allclose(port.logits(ids), want, rtol=1e-5,
                               atol=1e-4)
    assert np.abs(want).max() > 0.5
