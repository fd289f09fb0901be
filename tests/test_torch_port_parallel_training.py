"""Training across ranks on the PyTorch port against the JAX package.

A spawned gloo world of 8 CPU ranks (and one of 2), one each for the
module (tests/torch_parallel_world.py), runs the port's LMTrainer under
a mesh, its sharded checkpoints and PipelinedLMTrainer
(tests/torch_training_world.py: the ranks import only the port). This
process runs the JAX package on the conftest's virtual 8-device mesh, on
the same ONNX bytes and numpy batches, and holds the ranks to it: the
JAX tests' configs (tests/test_training.py:68, :124,
tests/test_lora.py:165, tests/test_checkpoint.py:61,
tests/test_pipeline_trainer.py:24, :51), their tolerance on losses
(rtol 2e-4, atol 1e-5 in f32), and beyond them:
  * each parameter's gradient gathered whole against jax.grad of the
    JAX trainer's loss_fn, within 1e-5 of the tensor's largest |g| (a
    gradient off by a factor of tp would hide under AdamW, whose step
    hardly moves when a gradient is scaled), and two SGD steps' params
    within 1e-5 of the tensor's largest |p|; the same for
    PipelinedLMTrainer at dp x pp x tp = 2 x 2 x 2 (its gradients and
    one SGD step's update);
  * Adam's params by tests/test_torch_port_training.py's bound (every
    element within steps * lr, those with a real first-step gradient
    within 1e-2 * lr);
  * bf16 compute: losses within 1e-2 relative (ROADMAP C10);
  * every rank holding the same block of a parameter holds the same
    values after the steps.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parallel_world import World  # noqa: E402
import torch_training_world as tasks  # noqa: E402
from whisper_tensor_tpu.dtype import DType as JDType  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gpt2 as jax_gpt2, llama as jax_llama)
from whisper_tensor_tpu.model import Model as JModel  # noqa: E402
from whisper_tensor_tpu.parallel import mesh as jax_mesh  # noqa: E402
from whisper_tensor_tpu.parallel import (  # noqa: E402
    pipeline_trainer as jax_pipe)
from whisper_tensor_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from whisper_tensor_tpu.training.trainer import (  # noqa: E402
    LMTrainer as JaxTrainer)
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402

GPT2 = dict(n_layer=1, n_head=4, n_embd=64, vocab_size=64, n_positions=32)
LLAMA = dict(model_type="llama", hidden_size=128, intermediate_size=256,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=1, vocab_size=128, rms_norm_eps=1e-5)
MESH = dict(dp=2, sp=2, tp=2)
RNG = np.random.default_rng(2)
BATCHES = [RNG.integers(0, 64, (4, 17)) for _ in range(4)]


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    w = World(8, tmp_path_factory.mktemp("world8"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def gpt2_bytes():
    cfg = jax_gpt2.GPT2Config(**GPT2)
    return jax_gpt2.build_gpt2_train(jax_gpt2.random_gpt2_weights(cfg), cfg)


def _llama_getter(cfg, seed):
    rng = np.random.default_rng(seed)
    kv = cfg.hidden_size // cfg.num_attention_heads \
        * cfg.num_key_value_heads
    shapes = {"embed": (cfg.vocab_size, cfg.hidden_size),
              "q_proj": (cfg.hidden_size, cfg.hidden_size),
              "o_proj": (cfg.hidden_size, cfg.hidden_size),
              "k_proj": (kv, cfg.hidden_size), "v_proj": (kv, cfg.hidden_size),
              "gate_proj": (cfg.intermediate_size, cfg.hidden_size),
              "up_proj": (cfg.intermediate_size, cfg.hidden_size),
              "down_proj": (cfg.hidden_size, cfg.intermediate_size),
              "lm_head": (cfg.vocab_size, cfg.hidden_size)}
    cache = {}

    def get(n):
        if n not in cache:
            if "norm" in n:
                cache[n] = (1 + 0.1 * rng.standard_normal(cfg.hidden_size)
                            ).astype(np.float32)
            else:
                key = next(k for k in shapes if k in n)
                cache[n] = (rng.standard_normal(shapes[key]) * 0.05
                            ).astype(np.float32)
        return cache[n]

    return get


@pytest.fixture(scope="module")
def llama_bytes():
    cfg = jax_llama.LlamaConfig(**LLAMA)
    return jax_llama.build_llama_train(_llama_getter(cfg, 3), cfg,
                                       max_len=32)


@pytest.fixture
def numpy_quantizer(monkeypatch):
    """The reference's quantize_int8 on its numpy path (its native fast
    path's scales can differ in the last bit)."""
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)


def _model(request, family):
    return request.getfixturevalue(f"{family}_bytes")


def _jax(data, batches, mesh=None, rules=None, **kw):
    if mesh is not None:
        kw.update(mesh=jax_mesh.make_mesh(**mesh),
                  rules=None if rules is None else getattr(jax_mesh, rules))
    tr = JaxTrainer(JModel.new_from_onnx(data), **kw)
    p = tr.init_params()
    s = tr.init_opt_state(p)
    losses = []
    for b in batches:
        p, s, loss = tr.train_step(p, s, b[:, :-1], b[:, 1:])
        losses.append(float(np.asarray(loss)))
    return tr, {k: np.asarray(v) for k, v in p.items()}, s, losses


def _jax_grads(data, b, **kw):
    tr = JaxTrainer(JModel.new_from_onnx(data), **kw)
    p = tr.init_params()
    return {k: np.asarray(v) for k, v in jax.grad(tr.loss_fn)(
        p, b[:, :-1], b[:, 1:], tr._frozen_params()).items()}


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _close_rel(got, want, rel, what):
    assert set(got) == set(want), what
    for k in want:
        scale = max(np.abs(_f32(want[k])).max(), 1e-30)
        err = np.abs(_f32(got[k]) - _f32(want[k])).max()
        assert err <= rel * scale, (what, k, err, scale)


def _adam_close(got, want, grads, lr, steps, what):
    for k in want:
        d = np.abs(_f32(got[k]) - _f32(want[k]))
        assert d.max() <= steps * lr, (what, k, d.max())
        g = np.abs(_f32(grads[k]))
        real = g >= 1e-3 * g.max()
        if real.any():
            assert d[real].max() <= 1e-2 * lr, (what, k, d[real].max())


def _same_blocks(outs, what):
    """Ranks at the same coordinates on a parameter's cutting axes hold
    the same block, bit for bit; a whole parameter is equal everywhere."""
    for name in outs[0]["local"]:
        axes = outs[0]["axes"].get(name, ())
        groups = {}
        for o in outs:
            groups.setdefault(tuple(o["index"][a] for a in axes),
                              []).append(o["local"][name])
        for blocks in groups.values():
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, blocks[0],
                                              err_msg=f"{what}: {name}")


def _losses_equal_on_every_rank(outs):
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]


# -- LMTrainer at dp x sp x tp ---------------------------------------------

def test_sharded_train_matches_single_device(world8, gpt2_bytes):
    """tests/test_training.py:68 at dp=2, sp=2, tp=2 (AdamW, 3 steps on
    one batch): losses against JAX's single device and its own mesh,
    params against the single device."""
    ids = np.random.default_rng(2).integers(0, 64, (4, 17))
    batches = [ids] * 3
    kw = dict(optimizer="adamw", lr=1e-2)
    outs = world8.run(tasks.train, gpt2_bytes, MESH, None, batches, kw)
    _, jp, _, single = _jax(gpt2_bytes, batches, **kw)
    _, _, _, sharded = _jax(gpt2_bytes, batches, mesh=MESH, **kw)
    _losses_equal_on_every_rank(outs)
    np.testing.assert_allclose(outs[0]["losses"], single, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0]["losses"], sharded, rtol=2e-4,
                               atol=1e-5)
    _adam_close(outs[0]["params"], jp, _jax_grads(gpt2_bytes, ids, **kw),
                1e-2, 3, "adamw at dp=2, sp=2, tp=2")
    _same_blocks(outs, "adamw at dp=2, sp=2, tp=2")
    assert outs[0]["fallbacks"] == []


@pytest.mark.parametrize("family,rules", [("gpt2", None),
                                          ("llama", "LLAMA_RULES")])
def test_sharded_gradients_match_jax_grad(request, world8, family, rules):
    """Each parameter's gradient at dp=2, sp=2, tp=2, gathered whole,
    against jax.grad of the JAX trainer's loss_fn; then two SGD steps."""
    data = _model(request, family)
    kw = dict(optimizer="sgd", lr=1e-2)
    outs = world8.run(tasks.train, data, MESH, rules, BATCHES[:2], kw,
                      True)
    want = _jax_grads(data, BATCHES[0], **kw)
    _, jp, _, jl = _jax(data, BATCHES[:2], **kw)
    for o in outs:
        _close_rel(o["grads"], want, 1e-5, f"{family} gradients")
    _losses_equal_on_every_rank(outs)
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=2e-4, atol=1e-5)
    _close_rel(outs[0]["params"], jp, 1e-5, f"{family} after 2 SGD steps")
    _same_blocks(outs, family)


@pytest.mark.parametrize("family,rules", [("gpt2", None),
                                          ("llama", "LLAMA_RULES")])
def test_the_tp_pass_needs_no_fallback_on_the_training_graphs(
        request, world8, family, rules):
    """At tp=4 (GPT-2) and tp=2 (llama, whose 2 kv heads tp=4 would not
    divide) the training graph is cut with no gather fallen back to:
    one AllGather (the logits), one AllReduce for the embedding's lookup
    and two a layer (the row-parallel products), CopyIns on the
    replicated inputs of the cut work."""
    data = _model(request, family)
    outs = world8.run(tasks.train, data, dict(dp=2, tp=4) if family ==
                      "gpt2" else dict(dp=4, tp=2), rules, BATCHES[:1],
                      dict(optimizer="sgd", lr=1e-2), True)
    want = _jax_grads(data, BATCHES[0], optimizer="sgd", lr=1e-2)
    for o in outs:
        assert o["fallbacks"] == []
        k = o["kinds"]
        assert k["AllGather"] == 1 and k["AllReduce"] == 1 + 2, k
        assert k["CopyIn"] >= 2, k
        _close_rel(o["grads"], want, 1e-5, f"{family} at tp")


@pytest.mark.parametrize("case", ["clip_accum", "remat_schedule", "bf16",
                                  "sequence_not_cut"])
def test_sharded_options_match_single_device(request, world8, case):
    """grad_clip (the global norm over cut gradients) and accum_steps,
    remat ("dots") with a schedule, bf16 compute with remat, and a
    sequence sp does not divide (left uncut, as the reference's trainer
    leaves it), each at dp=2, sp=2, tp=2 against JAX's single device."""
    family, rules, kw, batches, rtol = {
        "clip_accum": ("gpt2", None, dict(optimizer="adamw", lr=1e-2,
                                          grad_clip=0.05, accum_steps=2),
                       BATCHES, 2e-4),
        "remat_schedule": ("llama", "LLAMA_RULES", dict(
            optimizer="adamw", lr=1e-2, remat="dots",
            lr_schedule="warmup_cosine", warmup_steps=1, total_steps=4),
            BATCHES[:3], 2e-4),
        "bf16": ("gpt2", None, dict(optimizer="adamw", lr=1e-2,
                                    remat=True), BATCHES[:2], 1e-2),
        "sequence_not_cut": ("gpt2", None, dict(optimizer="sgd", lr=1e-1),
                             [b[:, :16] for b in BATCHES[:2]], 2e-4),
    }[case]
    data = _model(request, family)
    port_kw, jax_kw = dict(kw), dict(kw)
    if case == "bf16":
        port_kw["compute_dtype"] = DType.BF16
        jax_kw["compute_dtype"] = JDType.BF16
    outs = world8.run(tasks.train, data, MESH, rules, batches, port_kw)
    _, _, _, jl = _jax(data, batches, **jax_kw)
    _losses_equal_on_every_rank(outs)
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=rtol, atol=1e-5)
    _same_blocks(outs, case)


# -- FSDP, LoRA, QLoRA -------------------------------------------------------

def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_fsdp_train_matches_single_device(world8, gpt2_bytes):
    """tests/test_training.py:124 at dp=4, tp=2: the single device's
    losses; the weights cut as the JAX trainer cuts them; each rank's
    masters and AdamW moments of a cut weight 1/dp of the tp block."""
    ids = np.random.default_rng(3).integers(0, 64, (4, 17))
    batches = [ids] * 3
    kw = dict(optimizer="adamw", lr=1e-2)
    mesh = dict(dp=4, tp=2)
    outs = world8.run(tasks.train, gpt2_bytes, mesh, None, batches,
                      dict(kw, fsdp=True, fsdp_min_size=4096))
    _, _, _, single = _jax(gpt2_bytes, batches, **kw)
    jtr, _, _, fsdp = _jax(gpt2_bytes, batches, mesh=dict(dp=4, sp=1, tp=2),
                           fsdp=True, fsdp_min_size=4096, **kw)
    _losses_equal_on_every_rank(outs)
    np.testing.assert_allclose(outs[0]["losses"], single, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0]["losses"], fsdp, rtol=2e-4, atol=1e-5)
    want = {n: _strip(s.spec) for n, s in zip(jtr.weight_names,
                                              jtr.param_shardings)}
    assert {n: _strip(s) for n, s in outs[0]["specs"].items()} == want
    assert want["wqkv_0"] == ("dp", "tp")
    whole = outs[0]["params"]
    for o in outs:
        n_tp = 0
        for n, block in o["local"].items():
            spec = o["specs"][n]
            cut = (4 if "dp" in spec else 1) * (2 if "tp" in spec else 1)
            assert block.size * cut == whole[n].size, n
            n_tp += whole[n].size // (2 if "tp" in spec else 1)
        # f32 masters; AdamW's mu and nu cut alike
        assert o["opt_bytes"] == 2 * o["param_bytes"]
        assert o["param_bytes"] < n_tp * 4 / 2
    _same_blocks(outs, "fsdp")


def test_lora_with_fsdp_mesh(world8, gpt2_bytes):
    """tests/test_lora.py:165 at dp=4, tp=2: the frozen base cut over dp
    (and tp), the adapters whole on every rank, the step's loss the
    single device's."""
    ids = np.random.default_rng(2).integers(0, 64, (4, 9))
    kw = dict(optimizer="adamw", lr=1e-2, lora_rank=2,
              lora_targets=["wqkv", "wproj"])
    outs = world8.run(tasks.train, gpt2_bytes, dict(dp=4, tp=2), None,
                      [ids] * 2, dict(kw, fsdp=True, fsdp_min_size=4096))
    _, jp, _, jl = _jax(gpt2_bytes, [ids] * 2, **kw)
    _losses_equal_on_every_rank(outs)
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=2e-4, atol=1e-5)
    assert set(outs[0]["local"]) == set(jp)
    for o in outs:
        assert all(v.shape == jp[n].shape for n, v in o["local"].items())
        # wqkv_0 (64, 192) ("dp", "tp"), wproj_0 (64, 64) ("tp", "dp")
        assert o["frozen_shapes"]["wqkv_0"] == (16, 96)
        assert o["frozen_shapes"]["wproj_0"] == (32, 16)
    _same_blocks(outs, "lora under fsdp")


def test_qlora_at_dp2_matches_jax(world2, llama_bytes, numpy_quantizer):
    """An int8-frozen base with adapters at dp=2 (the base whole on both
    ranks, on the plain int8 products here) against JAX's QLoRA."""
    kw = dict(optimizer="adamw", lr=1e-2, lora_rank=4,
              quantize_base="int8", remat=True)
    batches = [b % 128 for b in BATCHES[:3]]
    outs = world2.run(tasks.train, llama_bytes, dict(dp=2), "LLAMA_RULES",
                      batches, kw)
    _, jp, _, jl = _jax(llama_bytes, batches, **kw)
    _losses_equal_on_every_rank(outs)
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=1e-5)
    for o in outs:
        assert sum(s == (128, 256) or s == (256, 128)
                   for s in o["frozen_shapes"].values()) == 3
        _close_rel(o["local"], jp, 1e-3, "QLoRA adapters")
    _same_blocks(outs, "qlora")


# -- sharded checkpoints -----------------------------------------------------

def test_sharded_save_and_resharded_load(world8, gpt2_bytes, tmp_path):
    """tests/test_checkpoint.py:61: a file the port's world writes at
    dp=2, sp=2, tp=2 loads in the JAX package (whose next step equals the
    world's own resumed step), and a JAX file loads in the port's world
    (whose next step equals JAX's)."""
    kw = dict(optimizer="adamw", lr=1e-2)
    b0, b1 = BATCHES[0], BATCHES[1]
    ckpt = str(tmp_path / "port.npz")
    world8.run(tasks.train, gpt2_bytes, MESH, None, [b0], kw, False, ckpt)
    resumed = world8.run(tasks.train, gpt2_bytes, MESH, None, [b1], kw,
                         False, None, ckpt)
    assert resumed[0]["loaded_step"] == 1
    jtr = JaxTrainer(JModel.new_from_onnx(gpt2_bytes), **kw)
    fresh = jtr.init_opt_state(jtr.init_params())
    p, s, step, extra = jax_ckpt.load_checkpoint(ckpt, opt_state_like=fresh)
    assert step == 1 and extra == {"lr": 1e-2}
    # the file holds the single device's first step, optimizer included
    _, jp1, js1, _ = _jax(gpt2_bytes, [b0], **kw)
    _adam_close(p, jp1, _jax_grads(gpt2_bytes, b0, **kw), 1e-2, 1,
                "the port's file against JAX's step")
    for got, want in zip(jax.tree.leaves(s), jax.tree.leaves(js1)):
        _close_rel({"leaf": np.asarray(got)}, {"leaf": np.asarray(want)},
                   1e-4, "optimizer leaves")
    p, s, loss = jtr.train_step(p, s, b1[:, :-1], b1[:, 1:])
    np.testing.assert_allclose(resumed[0]["losses"], [float(loss)],
                               rtol=2e-4, atol=1e-5)
    for k, v in p.items():     # one Adam step apart at most (lr)
        assert np.abs(resumed[0]["params"][k] - np.asarray(v)).max() <= 1e-2
    # a JAX file into the port's world
    jckpt = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(jckpt, jp1, js1, step=1)
    outs = world8.run(tasks.train, gpt2_bytes, MESH, None, [b1], kw, False,
                      None, jckpt)
    np.testing.assert_allclose(outs[0]["losses"], [float(loss)], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0]["losses"], resumed[0]["losses"],
                               rtol=1e-6)
    _same_blocks(outs, "loaded from JAX's file")


# -- PipelinedLMTrainer ------------------------------------------------------

PIPE = dict(n_layer=4, n_head=4, n_embd=32, vocab_size=64, n_positions=32)


def _pipe_batches(seed, n=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(1, 64, (8, 17))
        out.append((seq[:, :-1], seq[:, 1:]))
    return out


@pytest.fixture(scope="module")
def pipe_model():
    """The layered tests' GPT-2: its ONNX bytes and its weights by HF
    name (the recipe's getter draws them in the order it is asked, so
    both models read this one dict)."""
    cfg = jax_gpt2.GPT2Config(**PIPE)
    wg = jax_gpt2.random_gpt2_weights(cfg)
    data = jax_gpt2.build_gpt2_train(wg, cfg)
    names = ["transformer.wte.weight", "transformer.wpe.weight",
             "transformer.ln_f.weight", "transformer.ln_f.bias"] + [
        f"transformer.h.{i}.{leaf}" for i in range(cfg.n_layer)
        for leaf in ("ln_1.weight", "ln_1.bias", "attn.c_attn.weight",
                     "attn.c_attn.bias", "attn.c_proj.weight",
                     "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
                     "mlp.c_fc.weight", "mlp.c_fc.bias",
                     "mlp.c_proj.weight", "mlp.c_proj.bias")]
    return data, {n: wg(n) for n in names}


def _jax_pipe(weights, lr, optimizer="adamw"):
    from jax.sharding import Mesh

    cfg = jax_gpt2.GPT2Config(**PIPE)
    mesh1 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                 ("dp", "pp", "tp"))
    return jax_pipe.PipelinedLMTrainer(
        jax_pipe.layered_gpt2(cfg, weights.__getitem__), mesh1,
        microbatches=2, lr=lr, optimizer=optimizer)


def test_layered_gpt2_matches_imported_graph(world2, pipe_model):
    """tests/test_pipeline_trainer.py:24: layered_gpt2's block through
    the pipeline at pp=2 gives the imported training graph's loss (the
    port's LMTrainer) and the JAX layered model's."""
    data, weights = pipe_model
    batches = _pipe_batches(0)
    outs = world2.run(tasks.layered, PIPE, weights, (1, 2, 1), batches, 0,
                      0.0, data)
    ref = _jax_pipe(weights, 0.0)
    want = float(ref.loss_fn(ref.init_params(), *batches[0]))
    for o in outs:
        assert abs(o["first_loss"] - o["graph_loss"]) / o["graph_loss"] < 1e-5
        assert abs(o["first_loss"] - want) / want < 1e-5


def test_dp_pp_tp_composed_step_matches_single_device(world8, pipe_model):
    """tests/test_pipeline_trainer.py:51: dp2 x pp2 x tp2 composed steps
    against JAX's single device (losses, the head and the block's weights
    after two steps)."""
    _, weights = pipe_model
    batches = _pipe_batches(1)
    outs = world8.run(tasks.layered, PIPE, weights, (2, 2, 2), batches, 2,
                      1e-2)
    ref = _jax_pipe(weights, 1e-2)
    rp = ref.init_params()
    ro = ref.init_opt_state(rp)
    want = []
    for _ in range(2):
        rp, ro, loss = ref.train_step(rp, ro, *batches[0])
        want.append(float(loss))
    for o in outs:
        np.testing.assert_allclose(o["losses"], want, rtol=2e-4)
        np.testing.assert_allclose(o["head"]["wte_t"],
                                   np.asarray(rp["head"]["wte_t"]),
                                   rtol=2e-3, atol=2e-5)
        for k in ("wproj", "wqkv", "ln1g"):
            np.testing.assert_allclose(o["block"][k],
                                       np.asarray(rp["block"][k]),
                                       rtol=2e-3, atol=2e-5)
        # each rank holds 2 of the 4 layers and its tp block of them
        assert o["block_local"]["wqkv"] == (2, 32, 48)
        assert o["block_local"]["wproj"] == (2, 16, 32)


def test_dp_pp_tp_gradients_and_sgd_step_match_jax_grad(world8, pipe_model):
    """The pipelined trainer's own gradient rules at dp2 x pp2 x tp2
    (the loss / dp backward, the embedding's copy_in over pp, the
    block's copy_in and reduce_out): every gradient gathered whole
    against jax.grad of the JAX PipelinedLMTrainer's loss_fn, and one
    SGD step's update over -lr against it, each within 1e-5 of the
    tensor's largest |g| (AdamW would hide a factor of dp, pp or tp;
    lr is large so that the update stands clear of f32 rounding)."""
    _, weights = pipe_model
    batches = _pipe_batches(2)
    lr = 10.0
    outs = world8.run(tasks.layered, PIPE, weights, (2, 2, 2), batches, 1,
                      lr, None, "sgd", True)
    ref = _jax_pipe(weights, lr, "sgd")
    rp = ref.init_params()
    want = jax.grad(ref.loss_fn)(rp, *batches[0])
    for o in outs:
        for group in ("embed", "block", "head"):
            for k, g in want[group].items():
                g = np.asarray(g)
                scale = max(float(np.abs(g).max()), 1e-30)
                step = (o[group][k] - np.asarray(rp[group][k])) / -lr
                for what, got in (("gradient", o["grads"][group][k]),
                                  ("SGD step", step)):
                    err = float(np.abs(got - g).max()) / scale
                    assert err <= 1e-5, (group, k, what, err)
