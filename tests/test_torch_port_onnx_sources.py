"""ONNX files as a model source on the port, against the JAX package, on
the CPU.

* The three origin round trips of tests/test_origin_reference.py: the
  port's builder writes the JAX builder's bytes over the same
  safetensors and .pth origins (records exact, nested and
  non-contiguous .pth tensors included), and the port loads them. A
  dense .pth tensor loads by its span; the one safetensors header
  reader keeps every type, or raises.
* `WeightStorage.bin_file` exports: the .onnx and .bin bytes equal the
  JAX builder's.
* `GGUFFile.stored` (ExternalBinary, ExternalPacked) and
  `gguf_tokenizer` (a gpt2 BPE and a llama piece vocabulary) against the
  JAX package's entries and token ids; `TensorStore.evict`.
* The `onnx` loader through `auto`, the Server (`list_loaders`,
  `run_loader`) and `cli inspect`, and the loaders' probe order.
* A tiny GPT-2 step exported with .bin weights, loaded by the `onnx`
  loader and decoded greedily by `build_program`: token-exact against
  the JAX package's loader and facade.
* A bf16 checkpoint referenced by origin (the llama recipe over
  `SafetensorsStore.lazy`): the ONNX holds no weight payload, and its
  logits equal the `transformers` loader's load of the same files.
Outputs in f32 to rtol 1e-5, atol 1e-6 unless a case says otherwise;
bytes and records exact.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from whisper_tensor_tpu.importers import onnx_builder as ref_ob  # noqa: E402
from whisper_tensor_tpu.dtype import DType as RefDType  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers import onnx_builder as ob  # noqa: E402
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.onnx_pb import ModelProto  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _build(mod, dt, w_lazy, b_arr):
    b = mod.OnnxBuilder()
    x = b.input("x", dt.F32, (2, 4))
    w = b.initializer("w", w_lazy)
    bias = b.initializer("b", b_arr)
    h = b.node("MatMul", [x, w])
    b.node("Add", [h, bias], outputs=["y"])
    b.output("y", dt.F32, (2, 3))
    return b


def _affine_checks(data, W, B, base_dir=None):
    m = Model.new_from_onnx(data, base_dir=base_dir)
    x = np.random.default_rng(3).standard_normal((2, 4)).astype(np.float32)
    for mode in ("torch", "oracle"):
        kw = {"device": "cpu"} if mode == "torch" else {}
        out = np.asarray(m.eval({"x": x}, mode=mode, **kw)["y"])
        np.testing.assert_allclose(out, x @ W + B, rtol=1e-5, atol=1e-5)


def _record(data, name):
    tp = {t.name: t for t in ModelProto.parse(data).graph.initializer}[name]
    return tp, [(e.key, e.value) for e in tp.external_data]


def test_safetensors_origin_round_trip(tmp_path):
    from safetensors.numpy import save_file

    from whisper_tensor_tpu.importers.safetensors_io import (
        SafetensorsStore as RefStore)
    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)

    rng = np.random.default_rng(11)
    W = rng.standard_normal((4, 3)).astype(np.float32)
    B = rng.standard_normal((3,)).astype(np.float32)
    ckpt = tmp_path / "model.safetensors"
    save_file({"w": W}, str(ckpt))
    st = SafetensorsStore([str(ckpt)])
    assert st.meta("w") == RefStore([str(ckpt)]).meta("w")
    data = _build(ob, DType, st.lazy("w"), B).build(
        ob.WeightStorage.origin_reference())
    assert data == _build(ref_ob, RefDType, RefStore([str(ckpt)]).lazy("w"),
                          B).build(ref_ob.WeightStorage.origin_reference())
    tp, rec = _record(data, "w")
    assert tp.data_location == 1 and not tp.raw_data
    assert rec == [("format", "safetensors"), ("tensor_name", "w"),
                   ("location", str(ckpt))]
    assert _record(data, "b")[0].data_location != 1
    _affine_checks(data, W, B)
    np.testing.assert_array_equal(st.zeros_getter()("w"), np.zeros_like(W))



def test_a_safetensors_origin_is_read_by_its_span_alone(tmp_path,
                                                        monkeypatch):
    """The port's origin reader takes the tensor's span from the file's
    header and reads it alone, bf16 included: no safetensors backend is
    asked (one may map or copy the whole file for each tensor)."""
    import safetensors
    from safetensors.torch import save_file

    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)

    g = torch.Generator().manual_seed(7)
    sd = {"a": torch.randn(3, 5, generator=g).bfloat16(),
          "b": torch.randn(4, generator=g),
          "c": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    save_file(sd, str(tmp_path / "m.safetensors"))
    st = SafetensorsStore([str(tmp_path / "m.safetensors")])
    b = ob.OnnxBuilder()
    for name in sd:
        b.initializer(name, st.lazy(name))
        b.output(name, st.lazy(name).dtype, sd[name].shape)
    data = b.build(ob.WeightStorage.origin_reference())

    def refuse(*a, **k):
        raise AssertionError("the reader asked a safetensors backend")

    monkeypatch.setattr(safetensors, "safe_open", refuse)
    store = Model.new_from_onnx(data).graph.store
    for name, t in sd.items():
        got = store.get_numeric(name).numpy()
        want = (t.view(torch.int16).numpy().view(got.dtype)
                if t.dtype == torch.bfloat16 else t.numpy())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

def test_one_header_reader_gives_every_type_or_raises(tmp_path):
    """meta, lazy and the origin reader share one header reader: an
    unsigned type keeps its own type through an origin-referenced file,
    and a type the reader's table lacks raises in each of them."""
    import struct

    from safetensors.numpy import save_file

    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)

    u = np.arange(6, dtype=np.uint16).reshape(2, 3) * 1000
    save_file({"u": u}, str(tmp_path / "u.safetensors"))
    st = SafetensorsStore([str(tmp_path / "u.safetensors")])
    assert st.meta("u") == ((2, 3), np.dtype(np.uint16))
    assert st.lazy("u").dtype is DType.U16
    b = ob.OnnxBuilder()
    b.initializer("u", st.lazy("u"))
    b.output("u", DType.U16, (2, 3))
    data = b.build(ob.WeightStorage.origin_reference())
    got = Model.new_from_onnx(data).graph.store.get_numeric("u").numpy()
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, u)

    hdr = json.dumps({"z": {"dtype": "C64", "shape": [1],
                            "data_offsets": [0, 8]}}).encode()
    odd = tmp_path / "odd.safetensors"
    odd.write_bytes(struct.pack("<Q", len(hdr)) + hdr + bytes(8))
    odd_st = SafetensorsStore.__new__(SafetensorsStore)
    odd_st._by_name = {"z": str(odd)}
    with pytest.raises(ValueError, match="C64"):
        odd_st.meta("z")
    with pytest.raises(ValueError, match="C64"):
        odd_st.lazy("z")
    tp = {t.name: t for t in ModelProto.parse(data).graph.initializer}["u"]
    for e in tp.external_data:
        if e.key == "location":
            e.value = str(odd)
        if e.key == "tensor_name":
            e.value = "z"
    from whisper_tensor_tpu_torch.onnx_pb import tensor_proto_to_numpy

    with pytest.raises(ValueError, match="C64"):
        tensor_proto_to_numpy(tp)


def test_pth_origin_round_trip(tmp_path):
    from whisper_tensor_tpu.importers.pth import load_pth_lazy as ref_lazy
    from whisper_tensor_tpu_torch.importers.pth import load_pth_lazy

    rng = np.random.default_rng(12)
    W = rng.standard_normal((4, 3)).astype(np.float32)
    B = rng.standard_normal((3,)).astype(np.float32)
    ckpt = tmp_path / "model.pth"
    torch.save({"w": torch.from_numpy(W), "b": torch.from_numpy(B)},
               str(ckpt))
    lazy, ref = load_pth_lazy(str(ckpt)), ref_lazy(str(ckpt))
    assert set(lazy) == set(ref) == {"w", "b"}
    for k in lazy:
        assert lazy[k].origin == ref[k].origin
        assert lazy[k].shape == ref[k].shape
        assert lazy[k].dtype.name == ref[k].dtype.name
    lw = lazy["w"]
    with open(ckpt, "rb") as f:
        f.seek(lw.origin["offset"])
        raw = f.read(lw.origin["length"])
    np.testing.assert_array_equal(np.frombuffer(raw, np.float32).reshape(4, 3),
                                  W)
    np.testing.assert_array_equal(lw.load(), W)
    data = _build(ob, DType, lw, B).build(ob.WeightStorage.origin_reference())
    assert data == _build(ref_ob, RefDType, ref["w"], B).build(
        ref_ob.WeightStorage.origin_reference())
    _, rec = _record(data, "w")
    assert [k for k, _ in rec] == ["format", "tensor_name", "location",
                                   "offset", "length"]
    assert int(dict(rec)["length"]) == W.nbytes
    _affine_checks(data, W, B)


def test_pth_lazy_nested_and_noncontiguous(tmp_path):
    from whisper_tensor_tpu.importers.pth import load_pth_lazy as ref_lazy
    from whisper_tensor_tpu_torch.importers.pth import load_pth_lazy

    rng = np.random.default_rng(13)
    W = rng.standard_normal((6, 4)).astype(np.float32)
    ckpt = tmp_path / "m.pth"
    torch.save({"enc": {"w": torch.from_numpy(W).t(),
                        "tail": torch.from_numpy(W)[2:],
                        "h": torch.from_numpy(W).bfloat16()}}, str(ckpt))
    lazy, ref = load_pth_lazy(str(ckpt)), ref_lazy(str(ckpt))
    assert set(lazy) == set(ref) == {"enc.w", "enc.tail", "enc.h"}
    for k in lazy:
        assert lazy[k].origin == ref[k].origin, k
    assert lazy["enc.w"].origin is None   # the transposed view: no span
    np.testing.assert_array_equal(lazy["enc.w"].load(), W.T)
    np.testing.assert_array_equal(lazy["enc.tail"].load(), W[2:])
    assert lazy["enc.tail"].origin["offset"] == ref["enc.tail"].origin["offset"]
    h = lazy["enc.h"].load()
    assert h.dtype == DType.BF16.to_numpy()
    np.testing.assert_array_equal(h.astype(np.float32),
                                  torch.from_numpy(W).bfloat16().float().numpy())


def test_pth_lazy_reads_a_dense_tensor_by_its_span(tmp_path, monkeypatch):
    """A dense tensor loads its own span of the file (the checkpoint is
    not unpickled again), through the file's absolute path; only a
    tensor with no span goes through torch.load."""
    from whisper_tensor_tpu_torch.importers.pth import load_pth_lazy

    W = np.random.default_rng(15).standard_normal((5, 3)).astype(np.float32)
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "elsewhere").mkdir()
    torch.save({"w": torch.from_numpy(W), "wt": torch.from_numpy(W).t()},
               str(tmp_path / "ckpt" / "m.pth"))
    monkeypatch.chdir(tmp_path / "ckpt")
    lazy = load_pth_lazy("m.pth")
    monkeypatch.chdir(tmp_path / "elsewhere")
    loads, real = [], torch.load

    def counted(path, *a, **k):
        loads.append(path)
        return real(path, *a, **k)

    monkeypatch.setattr(torch, "load", counted)
    np.testing.assert_array_equal(lazy["w"].load(), W)
    assert loads == []
    np.testing.assert_array_equal(lazy["wt"].load(), W.T)
    assert loads == [str(tmp_path / "ckpt" / "m.pth")]


def test_bin_file_export_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(14)
    big = rng.standard_normal((1024, 300)).astype(np.float32)   # >= 1 MiB
    small = rng.standard_normal((300,)).astype(np.float32)
    outs = {}
    for who, mod, dt in (("p", ob, DType), ("j", ref_ob, RefDType)):
        d = tmp_path / who
        b = mod.OnnxBuilder("bin")
        x = b.input("x", dt.F32, (2, 1024))
        y = b.gemm(x, b.initializer("w", big), b.initializer("c", small))
        b.hint_shape(y, dt.F32, (2, 300))
        b.node("Identity", [y], outputs=["y"])
        b.output("y", dt.F32, (2, 300))
        data = b.build(mod.WeightStorage.bin_file(str(d / "m.bin")))
        (d / "m.onnx").write_bytes(data)
        outs[who] = (data, (d / "m.bin").read_bytes())
    assert outs["p"] == outs["j"]
    assert len(outs["p"][1]) == big.nbytes
    assert ob.EXTERNAL_THRESHOLD_BYTES == ref_ob.EXTERNAL_THRESHOLD_BYTES
    _, rec = _record(outs["p"][0], "w")
    assert rec == [("location", "m.bin"), ("offset", "0"),
                   ("length", str(big.nbytes))]
    m = Model.new_from_onnx_file(str(tmp_path / "p" / "m.onnx"))
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    np.testing.assert_allclose(m.eval({"x": x}, device="cpu")["y"],
                               x @ big + small, rtol=1e-4, atol=1e-4)


def _gguf(tmp_path, pkg_write, tokenizer_meta):
    from whisper_tensor_tpu_torch.backends.cpu.dequant import quantize_blocks
    from whisper_tensor_tpu_torch.packed_format import PackedFormat
    from whisper_tensor_tpu_torch.tensor import PackedTensor

    rng = np.random.default_rng(15)
    dense = rng.standard_normal((8, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    packed = PackedTensor(quantize_blocks(q, PackedFormat.Q4_0),
                          PackedFormat.Q4_0, (4, 64))
    path = str(tmp_path / "t.gguf")
    pkg_write(path, {"general.architecture": "llama", **tokenizer_meta},
              {"dense": dense, "packed": packed})
    return path, dense


def test_gguf_stored_entries_equal_the_jax_packages(tmp_path):
    from whisper_tensor_tpu.importers.gguf import GGUFFile as RefGGUF
    from whisper_tensor_tpu_torch.importers.gguf import GGUFFile, write_gguf
    from whisper_tensor_tpu_torch.symbolic_graph.tensor_store import (
        ExternalBinary, ExternalPacked, TensorStore)

    path, dense = _gguf(tmp_path, write_gguf, {})
    g, ref = GGUFFile(path), RefGGUF(path)
    for name, kind in (("dense", ExternalBinary), ("packed", ExternalPacked)):
        e, r = g.stored(name), ref.stored(name)
        assert isinstance(e, kind)
        assert (e.path, e.offset, e.length, e.shape) == (
            r.path, r.offset, r.length, r.shape)
        loaded = e.load()
        if name == "dense":
            np.testing.assert_array_equal(loaded.numpy(), dense)
        else:
            assert bytes(loaded.data) == bytes(g.load(name).data)
    store = TensorStore()
    store.put("dense", g.stored("dense"))
    first = store.get("dense")
    assert store.get("dense") is first          # cached
    store.evict("dense")
    assert store.get("dense") is not first      # read again
    np.testing.assert_array_equal(store.get_numeric("dense").numpy(), dense)
    assert store.total_bytes() == dense.nbytes
    store.evict()
    assert not store._cache


_TEXT = "hello world, the cat sat on a mat"


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_gguf_tokenizer_gives_the_jax_token_ids(tmp_path, model):
    from whisper_tensor_tpu.importers.gguf import GGUFFile as RefGGUF
    from whisper_tensor_tpu.importers.gguf import (
        gguf_tokenizer as ref_tokenizer)
    from whisper_tensor_tpu_torch.importers.gguf import (GGUFFile,
                                                         gguf_tokenizer,
                                                         write_gguf)

    if model == "gpt2":
        pytest.importorskip("tokenizers")
        byte_chars = [chr(c) for c in range(ord("!"), ord("~") + 1)]
        tokens = byte_chars + ["Ġ"] + ["he", "ll", "hell", "hello",
                                            "Ġw", "or", "ld"]
        merges = ["h e", "l l", "he ll", "hell o", "Ġ w", "o r",
                  "l d"]
        meta = {"tokenizer.ggml.model": "gpt2",
                "tokenizer.ggml.tokens": tokens,
                "tokenizer.ggml.merges": merges}
        text = "hello world"
    else:
        tokens = ["<unk>", "▁the", "▁cat", "▁", "s", "at",
                  "▁sat", "on", "a", "m", "h", "e", "l", "o", "w",
                  "r", "d", ",", "t", "c"]
        meta = {"tokenizer.ggml.model": "llama",
                "tokenizer.ggml.tokens": tokens}
        text = _TEXT
    path, _ = _gguf(tmp_path, write_gguf, meta)
    mine = gguf_tokenizer(GGUFFile(path))
    ref = ref_tokenizer(RefGGUF(path))
    ids = mine.encode(text)
    assert ids == ref.encode(text) and len(ids) > 3
    assert mine.decode(ids) == ref.decode(ids)


def _write_gpt2_bin(tmp_path):
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step, random_gpt2_weights)

    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=256, vocab_size=1024,
                     n_positions=32)
    path = tmp_path / "gpt2.onnx"
    path.write_bytes(build_gpt2_step(
        random_gpt2_weights(cfg, seed=4), cfg, max_len=32,
        storage=ob.WeightStorage.bin_file(str(tmp_path / "gpt2.bin"))))
    return str(path), cfg


def test_the_onnx_loader_through_auto_the_server_and_cli_inspect(tmp_path):
    from whisper_tensor_tpu import cli as jax_cli
    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.importers.loaders import (identify_and_load,
                                                            loader_registry)
    from whisper_tensor_tpu_torch.server.main import Server

    path, _ = _write_gpt2_bin(tmp_path)
    assert os.path.getsize(tmp_path / "gpt2.bin") > 1 << 20
    assert loader_registry()["onnx"].can_load(path)
    assert not loader_registry()["onnx"].can_load(str(tmp_path))
    bundle = identify_and_load(path)
    (model,) = bundle.models.values()
    assert model.name == "gpt2.onnx" and not bundle.interfaces
    srv = Server(device="cpu")
    listing = srv._dispatch({"type": "list_loaders"})["loaders"]
    assert listing["onnx"] == {
        "description": "Load a raw ONNX model file",
        "config": [{"name": "path", "type": "file_path",
                    "description": "model file or directory",
                    "default": None, "required": True, "choices": None,
                    "min": None, "max": None}]}
    reply = srv._dispatch({"type": "run_loader", "loader": "onnx",
                           "config": {"path": path}})
    (mid,) = reply["loaded"]
    assert srv.models.get(mid).model.name == "gpt2.onnx"
    outs = []
    for main in (cli.main, jax_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["inspect", "--model", path])
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0]["weight_bytes"] > 1 << 20


def test_the_loaders_are_probed_in_the_jax_packages_order(tmp_path):
    from whisper_tensor_tpu.importers.loaders import _LOADERS as REF
    from whisper_tensor_tpu_torch.importers.loaders import (_LOADERS,
                                                            identify_and_load,
                                                            loader_registry)

    from tests.torch_tts_sets import write_piper_voice

    def tiers(reg):
        out = {}
        for name, ld in reg.items():
            if name != "auto":
                out.setdefault(getattr(ld, "PRIORITY", 0), set()).add(name)
        return out

    assert tiers(_LOADERS) == tiers(REF)
    onnx_path = write_piper_voice(str(tmp_path))
    assert loader_registry()["onnx"].can_load(onnx_path)
    assert identify_and_load(onnx_path).meta["architecture"] == "piper-vits"


def _greedy(run, n_layer, steps=6):
    ids = np.asarray([[5, 9, 2, 77]], np.int64)
    caches = {f"cache_{kv}_{i}": np.zeros((1, 2, 32, 128), np.float32)
              for i in range(n_layer) for kv in "kv"}
    toks, pos = [], 0
    for _ in range(steps):
        out = run(dict(caches, input_ids=ids, pos=np.asarray(pos, np.int64)))
        caches = {k: np.asarray(out["new_" + k]) for k in caches}
        pos += ids.shape[1]
        toks.append(int(np.asarray(out["logits"])[0, -1].argmax()))
        ids = np.asarray([[toks[-1]]], np.int64)
    return toks, np.asarray(out["logits"])


def test_a_bin_exported_gpt2_step_decodes_as_in_the_jax_package(tmp_path):
    from whisper_tensor_tpu import compiler as ref_compiler
    from whisper_tensor_tpu.importers.loaders import (
        identify_and_load as ref_load)
    from whisper_tensor_tpu_torch.compiler import (CompilationSubject,
                                                   build_program)
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load

    path, cfg = _write_gpt2_bin(tmp_path)
    (model,) = identify_and_load(path).models.values()
    prog = build_program(CompilationSubject(model=model), device="cpu")
    toks, logits = _greedy(prog.run, cfg.n_layer)
    assert prog.backend == "torch"
    uploaded = prog.stats["weight_bytes_uploaded"]
    assert uploaded >= os.path.getsize(tmp_path / "gpt2.bin")
    (ref_model,) = ref_load(path).models.values()
    ref_prog = ref_compiler.build_program(
        ref_compiler.CompilationSubject(model=ref_model))
    ref_toks, ref_logits = _greedy(ref_prog.run, cfg.n_layer)
    assert toks == ref_toks
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)
    assert prog.stats["weight_bytes_uploaded"] == uploaded


def _write_bf16_llama(d):
    from safetensors.torch import save_file

    cfg = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
           "num_hidden_layers": 2, "hidden_size": 64,
           "intermediate_size": 128, "num_attention_heads": 4,
           "num_key_value_heads": 2, "vocab_size": 96,
           "max_position_embeddings": 64, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "tie_word_embeddings": False,
           "torch_dtype": "bfloat16"}
    (d / "config.json").write_text(json.dumps(cfg))
    g = torch.Generator().manual_seed(21)
    shapes = {"model.embed_tokens.weight": (96, 64),
              "model.norm.weight": (64,), "lm_head.weight": (96, 64)}
    for i in range(2):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (64,),
                       p + "post_attention_layernorm.weight": (64,),
                       p + "self_attn.q_proj.weight": (64, 64),
                       p + "self_attn.k_proj.weight": (32, 64),
                       p + "self_attn.v_proj.weight": (32, 64),
                       p + "self_attn.o_proj.weight": (64, 64),
                       p + "mlp.gate_proj.weight": (128, 64),
                       p + "mlp.up_proj.weight": (128, 64),
                       p + "mlp.down_proj.weight": (64, 128)})
    sd = {n: ((1 + 0.1 * torch.randn(s, generator=g)) if len(s) == 1
              else 0.2 * torch.randn(s, generator=g)).bfloat16()
          for n, s in shapes.items()}
    save_file(sd, str(d / "model.safetensors"))
    return cfg


def test_a_bf16_origin_referenced_llama_stands_the_transformers_load(tmp_path):
    from whisper_tensor_tpu_torch.importers.loaders import loader_registry
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step)
    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)

    hf = _write_bf16_llama(tmp_path)
    st = SafetensorsStore.from_dir(str(tmp_path))
    data = build_llama_step(st.lazy, LlamaConfig.from_hf(hf), max_len=32,
                            dtype=DType.BF16, pos_per_row=True,
                            storage=ob.WeightStorage.origin_reference())
    graph = ModelProto.parse(data).graph
    refs = [t for t in graph.initializer if t.data_location == 1]
    assert {dict((e.key, e.value) for e in t.external_data)["tensor_name"]
            for t in refs} == set(st.names())
    assert sum(len(t.raw_data) for t in graph.initializer) < 4096  # no weights
    path = tmp_path / "origin.onnx"
    path.write_bytes(data)
    (mine,) = loader_registry()["onnx"].load({"path": str(path)}
                                              ).models.values()
    (want,) = [e for e in loader_registry()["transformers"].load(
        {"path": str(tmp_path), "dtype": "bf16", "max_len": 32,
         "ragged_decode": True}).models.values()]
    for name in ("embed_tokens", "final_norm"):
        np.testing.assert_array_equal(
            mine.graph.store.get_numeric(name).numpy().view(np.uint16),
            want.graph.store.get_numeric(name).numpy().view(np.uint16))
    feeds = {"input_ids": np.asarray([[3, 17, 40, 8, 91]], np.int64),
             "pos": np.zeros(1, np.int64)}
    for i in range(2):
        for kv in "kv":
            feeds[f"cache_{kv}_{i}"] = np.zeros((1, 2, 32, 16),
                                                DType.BF16.to_numpy())
    a = mine.eval(dict(feeds), device="cpu")["logits"].astype(np.float32)
    b = want.eval(dict(feeds), device="cpu")["logits"].astype(np.float32)
    # the same bf16 weights: the matmul weights reach the product as a
    # transposed view in one graph and a transposed copy in the other,
    # which on the CPU gives the same bits
    np.testing.assert_array_equal(a, b)


def test_the_hf_module_weight_getters_equal_the_jax_packages():
    transformers = pytest.importorskip("transformers")
    from whisper_tensor_tpu.importers.recipes.llm import gpt2 as ref_gpt2
    from whisper_tensor_tpu.importers.recipes.llm import llama as ref_llama
    from whisper_tensor_tpu_torch.importers.recipes.llm import gpt2, llama

    torch.manual_seed(0)
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, vocab_size=40,
        tie_word_embeddings=True))
    g2 = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        n_embd=32, n_layer=1, n_head=2, vocab_size=40, n_positions=16))
    for mine, ref, model, extra in (
            (llama.hf_weight_getter, ref_llama.hf_weight_getter, lm,
             ["lm_head.weight"]),
            (gpt2.hf_gpt2_weight_getter, ref_gpt2.hf_gpt2_weight_getter, g2,
             [])):
        get, want = mine(model), ref(model)
        for name in list(model.state_dict()) + extra:
            np.testing.assert_array_equal(get(name), want(name))


def test_the_server_entry_point_asks_for_the_card(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    cmd = [sys.executable, "-m", "whisper_tensor_tpu_torch.server.main"]
    helped = subprocess.run(cmd + ["--help"], capture_output=True,
                            text=True, env=env, timeout=120, cwd=tmp_path)
    assert helped.returncode == 0
    for flag in ("--host", "--port", "--device"):
        assert flag in helped.stdout
    if not torch.cuda.is_available():
        run = subprocess.run(cmd + ["--port", "0"], capture_output=True,
                             text=True, env=env, timeout=120, cwd=tmp_path)
        assert run.returncode != 0 and "CUDA" in run.stderr
