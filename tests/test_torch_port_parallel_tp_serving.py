"""Tensor- and data-parallel serving on the port against the JAX
package: `TextInferenceInterface(mesh=, shard_rules=)`.

Gloo worlds of 2 and 4 CPU ranks (tests/torch_parallel_world.py) each
build the port's interface over a mesh from the same ONNX bytes as the
JAX package's (its recipes, seeded weights), with the JAX package's
rules; this process runs the JAX package's interface over the same mesh
shape on the conftest's virtual 8-device CPU mesh. At an f32 cache the
greedy tokens must be equal and the logits within the JAX test's
tolerance (rtol 1e-4, atol 1e-5: collectives re-associate sums), on
every rank. The JAX package's native quantizers are forced onto their
numpy paths (the port copies those).
"""

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_parallel_world as tasks  # noqa: E402
from torch_parallel_world import World  # noqa: E402
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm import gpt2 as jax_gpt2  # noqa: E402
from whisper_tensor_tpu.importers.onnx_builder import (  # noqa: E402
    WeightStorage as JaxStorage)
from whisper_tensor_tpu.importers.recipes.llm import llama as jax_llama  # noqa: E402
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    TextInferenceInterface as JaxText, _bucket)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.parallel import mesh as jax_mesh  # noqa: E402
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (  # noqa: E402
    dequant_repacked)
from whisper_tensor_tpu_torch.parallel.tp import (  # noqa: E402
    shard_packed_rows, take_shard)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _numpy_quantizers(monkeypatch):
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)
    monkeypatch.setattr(jax_native, "native_dequantize",
                        lambda data, fmt, n: None)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


def _gpt2_onnx(vocab=256, E=64):
    cfg = jax_gpt2.GPT2Config(n_layer=2, n_head=4, n_embd=E,
                              vocab_size=vocab, n_positions=64)
    return jax_gpt2.build_gpt2_step(jax_gpt2.random_gpt2_weights(cfg, seed=3),
                                    cfg, max_len=64, dtype=JaxDType.F32)


def _llama_onnx(E, H, KV, I=128, V=128):
    D = E // H
    shapes = {"embed_tokens": (V, E), "lm_head": (V, E), "q_proj": (E, E),
              "k_proj": (KV * D, E), "v_proj": (KV * D, E),
              "o_proj": (E, E), "gate_proj": (I, E), "up_proj": (I, E),
              "down_proj": (E, I)}

    def weight(name):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
        shape = next(s for k, s in shapes.items() if k in name)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    cfg = jax_llama.LlamaConfig(
        num_hidden_layers=2, num_attention_heads=H, num_key_value_heads=KV,
        hidden_size=E, intermediate_size=I, vocab_size=V, rope_theta=10000.0,
        rms_norm_eps=1e-5)
    return jax_llama.build_llama_step(weight, cfg, max_len=64,
                                      dtype=JaxDType.F32)


def _jax(onnx, dp=1, tp=1, rules=None, **kw):
    mesh = None if tp * dp == 1 else jax_mesh.make_mesh(dp=dp, sp=1, tp=tp)
    if "quantize" in kw:
        kw["weight_dtype"] = JaxDType.F32
    return JaxText(JaxModel.new_from_onnx(onnx), max_len=64,
                   prompt_buckets=(8,), cache_dtype=JaxDType.F32, mesh=mesh,
                   shard_rules=rules, **kw)


def _hold(got, ref, prompt, n_new):
    want_toks = ref.generate_tokens(prompt, n_new)
    want_logits = np.asarray(ref.logits(prompt))
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["tokens"], want_toks,
                                      err_msg=f"rank {rank}")
        np.testing.assert_allclose(g["logits"], want_logits, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {rank}")
        assert g["fallbacks"] == [], g["fallbacks"]


# -- GPT-2 at (dp, tp) --------------------------------------------------------

@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2)])
def test_gpt2_serving_matches_the_jax_package(request, dp, tp):
    onnx = _gpt2_onnx()
    prompt = np.random.default_rng(17).integers(0, 256, (4, 6))
    got = request.getfixturevalue(f"world{dp * tp}").run(
        tasks.serve, onnx, dp, tp, "GPT2_RULES", prompt, 12)
    _hold(got, _jax(onnx, dp, tp, jax_mesh.GPT2_RULES), prompt, 12)
    for rank, g in enumerate(got):
        # fused q/k/v in sections, a row-parallel sum a projection, the
        # vocab-parallel embedding's sum, the head's gather
        assert g["split"]["wqkv_0"] == (1, 3)
        assert g["shapes"]["wqkv_0"] == (64, 192 // tp)
        assert g["shapes"]["wte"] == (256 // tp, 64)
        assert g["cache"] == (4 // dp, 4 // tp, 64, 16)
        assert g["kinds"]["AllReduce"] == 2 * 2 + 1
        assert g["kinds"]["AllGather"] == 1
        assert g["kinds"]["VocabGather"] == 1


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1)])
def test_windowed_serving_matches_the_jax_package(world2, dp, tp):
    """Windowed decode (windows 16 and 32) over a mesh: each rank's
    greedy tokens equal the JAX package's windowed tokens and the port's
    flat ones, and the windows' caches are the rank's share (rows cut
    over dp, heads over tp)."""
    cfg = jax_gpt2.GPT2Config(n_layer=2, n_head=4, n_embd=64,
                              vocab_size=256, n_positions=64)
    weights = jax_gpt2.random_gpt2_weights(cfg, seed=3)
    wins = {w: jax_gpt2.build_gpt2_step(
        weights, cfg, max_len=w, dtype=JaxDType.F32,
        storage=JaxStorage.none()) for w in (16, 32)}
    onnx = _gpt2_onnx()
    prompt = np.random.default_rng(19).integers(0, 256, (4, 6))
    got = world2.run(tasks.windowed, onnx, wins, dp, tp, "GPT2_RULES",
                     prompt, 40)
    main = JaxModel.new_from_onnx(onnx)
    models = {w: JaxModel.new_from_onnx(b) for w, b in wins.items()}
    for m in models.values():
        m.graph.store = main.graph.store
    want = JaxText(main, max_len=64, prompt_buckets=(8,),
                   cache_dtype=JaxDType.F32,
                   window_models=models).generate_tokens(prompt, 40)
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["tokens"], want,
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(g["flat"], want)
        assert g["fallbacks"] == []
        assert g["caches"] == [(4 // dp, 4 // tp, n, 16) for n in (16, 32,
                                                                   64)]


def test_sampled_tokens_agree_across_ranks(world2):
    onnx = _gpt2_onnx()
    prompt = np.random.default_rng(18).integers(0, 256, (2, 5))
    got = world2.run(tasks.serve, onnx, 1, 2, "GPT2_RULES", prompt, 16,
                     None, True)
    np.testing.assert_array_equal(got[0]["tokens"], got[1]["tokens"])
    assert (got[0]["tokens"] >= 0).all() and (got[0]["tokens"] < 256).all()


def test_a_weight_tp_does_not_divide_is_refused(world2):
    onnx = _gpt2_onnx(vocab=257)
    for msg in world2.run(tasks.refused, onnx, 2, "GPT2_RULES"):
        assert msg.startswith("wte of shape (257, 64): the global size of "
                              "its dimension 0 (257) should be divisible "
                              "by 2"), msg
    with pytest.raises(ValueError, match="divisible by 2"):
        _jax(onnx, 1, 2, jax_mesh.GPT2_RULES).logits(np.zeros((1, 4),
                                                               np.int64))


# -- Llama ------------------------------------------------------------------

@pytest.mark.parametrize("E,H,KV,tp", [(64, 4, 2, 2), (128, 8, 2, 4)])
def test_llama_serving_matches_the_jax_package(request, E, H, KV, tp):
    """Hkv = 2 at tp 2 cuts the caches' heads; at tp 4 the caches and the
    k/v projections stay whole and each rank reads its query heads' kv
    head (the JAX package answers through GSPMD there)."""
    onnx = _llama_onnx(E, H, KV)
    prompt = np.random.default_rng(19).integers(0, 128, (2, 5))
    got = request.getfixturevalue(f"world{tp}").run(
        tasks.serve, onnx, 1, tp, "LLAMA_RULES", prompt, 12)
    _hold(got, _jax(onnx, 1, tp, jax_mesh.LLAMA_RULES), prompt, 12)
    D = E // H
    for g in got:
        assert g["shapes"]["wq_0"] == (E, E // tp)
        assert g["shapes"]["embed_tokens"] == (128 // tp, E)
        if KV % tp == 0:
            assert g["cache"] == (2, KV // tp, 64, D)
            assert g["shapes"]["wk_0"] == (E, KV * D // tp)
            assert "KVHeads" not in g["kinds"]
        else:
            assert g["cache"] == (2, KV, 64, D)
            assert "wk_0" not in g["split"] and "wv_0" not in g["split"]
            assert g["kinds"]["KVHeads"] == 2


# -- int8 and q4_0 ---------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_quantized_serving_matches_the_jax_package(world2, family, quantize):
    """Hidden 128 and FFN 512: the FFN and the head are large enough for
    int8 (quantize_matmul_weights' 65,536 elements). The JAX package
    cannot shard int8 Llama: LLAMA_RULES' unanchored patterns catch the
    rank-1 `w_up_0::scale` with a rank-2 spec and device_put refuses it.
    The port places each `::` companion from its base weight's rule, and
    is held there to the JAX package's single-device int8 run."""
    onnx = (_gpt2_onnx(vocab=512, E=128) if family == "gpt2"
            else _llama_onnx(128, 4, 2, I=512, V=512))
    rules = "GPT2_RULES" if family == "gpt2" else "LLAMA_RULES"
    prompt = np.random.default_rng(20).integers(0, 512, (2, 6))
    got = world2.run(tasks.serve, onnx, 1, 2, rules, prompt, 10, quantize)
    jax_tp = 1 if (family, quantize) == ("llama", "int8") else 2
    _hold(got, _jax(onnx, 1, jax_tp, getattr(jax_mesh, rules),
                    quantize=quantize), prompt, 10)
    row = "wmp_0" if family == "gpt2" else "w_down_0"
    col = "wfc_0" if family == "gpt2" else "w_up_0"
    for g in got:
        if quantize == "int8":
            # the column shard cuts its scale, the row shard keeps it whole
            # the FFN's products in 2 layers (GPT-2 2, Llama 3) and the
            # head
            assert g["kinds"]["QuantMatMul"] == 2 * (
                2 if family == "gpt2" else 3) + 1
            assert g["split"][col + "::scale"] == (0, 1)
            assert row + "::scale" not in g["split"]
            assert g["shapes"][row] == (256, 128)
            assert g["shapes"][row + "::scale"] == (128,)
        else:
            assert g["kinds"]["PackedMatMul"] > 0
            # 4-bit rows in pairs: the row shard's q holds 256 rows
            assert g["shapes"][row] == (128, 128)
            assert g["shapes"][row + "::pscales"] == (8, 128)
            assert g["split"][col + "::pscales"] == (1, 1)


@pytest.mark.parametrize("bits,G,parts", [(4, 32, 2), (4, 32, 4), (8, 16, 2)])
def test_packed_row_shards_dequantize_to_the_rows(bits, G, parts):
    """Each row shard, repacked from its logical rows, dequantizes to
    those rows of dequant_repacked bit for bit."""
    rng = np.random.default_rng(bits + G + parts)
    K, N = 256, 24
    q = (rng.integers(0, 256, (K // 2, N), dtype=np.uint8) if bits == 4
         else rng.integers(-128, 128, (K, N), dtype=np.int8))
    rp = {"q": q, "scales": rng.standard_normal((K // G, N)).astype(
        np.float32), "offsets": rng.standard_normal((K // G, N)).astype(
        np.float32), "bits": np.int8(bits)}
    full = dequant_repacked(rp)
    for i in range(parts):
        mine = {"q": shard_packed_rows(q, bits, parts, i),
                "scales": take_shard(rp["scales"], 0, parts, i),
                "offsets": take_shard(rp["offsets"], 0, parts, i),
                "bits": np.int8(bits)}
        rows = slice(i * K // parts, (i + 1) * K // parts)
        assert np.array_equal(dequant_repacked(mine), full[rows])
    with pytest.raises(ValueError, match="divisible by 3"):
        take_shard(rp["scales"], 0, 3, 0, name="w::pscales")


# -- multi-LoRA -------------------------------------------------------------------

def test_adapters_under_tp_match_the_jax_package(world2):
    """Adapter stacks under tp (JAX test_tp_serving_with_adapters): row 0
    on the base model, row 1 under adapter a, against the JAX package's
    sharded logits."""
    import jax.numpy as jnp

    onnx = _gpt2_onnx()
    r = np.random.default_rng(21)
    A = (r.standard_normal((64, 4)) * 0.1).astype(np.float32)
    B = (r.standard_normal((4, 256)) * 0.1).astype(np.float32)
    ids = np.random.default_rng(22).integers(0, 256, (2, 6))
    got = world2.run(tasks.adapted_logits, onnx, 2, A, B, ids)

    sharded = _jax(onnx, 1, 2, jax_mesh.GPT2_RULES)
    sharded.install_adapters({"a": {"wfc_0": (A, B, 0.5)}})
    Sb = _bucket(6, sharded.prompt_buckets)
    padded = np.zeros((2, Sb), np.int64)
    padded[:, :6] = ids
    step = sharded._traced_step(2, Sb)
    want, _ = jax.jit(lambda i, c, w: step(
        i, jnp.asarray(0, jnp.int64), c, w))(
        jnp.asarray(padded), sharded.fresh_cache(2),
        sharded.weights_with_rows([jnp.asarray([0, 1], jnp.int64)]))
    want = np.asarray(want)[:, :6, :]
    for g in got:
        np.testing.assert_allclose(g["logits"], want, rtol=RTOL, atol=ATOL)
        assert g["fallbacks"] == []
        # wfc_0 is column-parallel: B's columns are cut, A stays whole
        assert g["split"]["wfc_0::lora_bs"] == (2, 1)
        assert "wfc_0::lora_as" not in g["split"]
