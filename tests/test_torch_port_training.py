"""Training on the PyTorch port against the JAX package, on the CPU.

LMTrainer (whisper_tensor_tpu_torch/training/trainer.py: autograd over
the port's executor, optax's formulas in torch) is held against the JAX
package's LMTrainer (jax.grad and optax) on the same ONNX bytes: a GPT-2
of 2 layers of 64, 4 heads, vocab 128, and a llama of 2 layers of 128
(4/2 heads, FFN 512, vocab 512: the shapes at which the int8 pass takes
gate, up, down and the head), batches of B 2 x S 12 made with numpy from
a seed. The JAX side runs as its own tests run it on the CPU: XLA, its
int8 products on the jnp fallback, quantize_int8 on its numpy path.

Tolerances, and why:
  * losses: 1e-5 relative at every step (the same f32 graph; only the
    order of f32 sums differs);
  * the first step's gradients: 1e-5 of each tensor's largest |g|;
  * SGD's parameters: 1e-5 of each tensor's largest |p| (a step is lr *
    g, so the gradients' agreement carries over);
  * Adam's (adam, adamw) parameters: every element within steps * lr,
    and the elements whose first-step |g| is at least 1e-3 of their
    tensor's largest within 1e-2 * lr. Adam divides each element's step
    by its own gradient history, so where the exact gradient is zero (a
    key bias: softmax ignores a shift shared by a query's scores) the
    two packages' float noise of opposite signs moves the element by up
    to lr a step either way; where the gradient is real the steps agree
    (measured: 5e-4 * lr);
  * bf16 compute: losses within 1e-2 relative (bf16 rounds in other
    places in the two packages, ROADMAP C10);
  * remat: equal to no remat within 1e-6 (the same operations, run
    again).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.dtype import DType as JDType  # noqa: E402
from whisper_tensor_tpu.importers import lora as jax_lora  # noqa: E402
from whisper_tensor_tpu.importers.recipes.llm import (  # noqa: E402
    gpt2 as jax_gpt2, llama as jax_llama)
from whisper_tensor_tpu.model import Model as JModel  # noqa: E402
from whisper_tensor_tpu.backends.pallas.quant_matmul import (  # noqa: E402
    int8_matmul as jax_int8_matmul)
from whisper_tensor_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from whisper_tensor_tpu.training.trainer import (  # noqa: E402
    LMTrainer as JaxTrainer)
from whisper_tensor_tpu.utils import native as jax_native  # noqa: E402
from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (  # noqa: E402
    decode_attention)
from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (  # noqa: E402
    flash_attention)
from whisper_tensor_tpu_torch.backends.cuda.kv_write import (  # noqa: E402
    kv_write_pair, ragged_kv_write)
from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (  # noqa: E402
    packed_matmul)
from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (  # noqa: E402
    Int8MatMul, int8_matmul, int8_matmul_dx, int8_matmul_dx_plain,
    int8_matmul_plain)
from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (  # noqa: E402
    GraphExecutor)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers import lora  # noqa: E402
from whisper_tensor_tpu_torch.importers.recipes.llm import (  # noqa: E402
    gpt2, llama)
from whisper_tensor_tpu_torch.milli.ir import MilliGraph  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import Constant, Range  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops.attention import (  # noqa: E402
    AttentionMilli, flash_mode, kernel_attention_disabled, pos_mode)
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.training import checkpoint  # noqa: E402
from whisper_tensor_tpu_torch.training.trainer import LMTrainer  # noqa: E402

GPT2 = dict(n_layer=2, n_head=4, n_embd=64, vocab_size=128, n_positions=32)
LLAMA = dict(model_type="llama", hidden_size=128, intermediate_size=512,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=2, vocab_size=512, rms_norm_eps=1e-5)
RNG = np.random.default_rng(20240418)
BATCHES = [RNG.integers(0, 128, (2, 13)) for _ in range(6)]


@pytest.fixture(scope="module")
def gpt2_bytes():
    cfg = jax_gpt2.GPT2Config(**GPT2)
    return jax_gpt2.build_gpt2_train(jax_gpt2.random_gpt2_weights(cfg, 1),
                                     cfg)


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
                cache[n] = np.ones(cfg.hidden_size, np.float32)
            else:
                key = next(k for k in shapes if k in n)
                cache[n] = (rng.standard_normal(shapes[key]) * 0.05
                            ).astype(np.float32)
        return cache[n]

    return get


@pytest.fixture(scope="module")
def llama_bytes():
    cfg = jax_llama.LlamaConfig(**LLAMA)
    wm = {}
    data = jax_llama.build_llama_train(_llama_getter(cfg, 3), cfg,
                                       max_len=32, weight_map=wm)
    return data, wm


@pytest.fixture
def numpy_quantizer(monkeypatch):
    """The reference's quantize_int8 on its numpy path (its native fast
    path's scales can differ in the last bit)."""
    monkeypatch.setattr(jax_native, "native_quantize_int8", lambda w: None)


def _jax_run(data, steps, batches=BATCHES, **kw):
    tr = JaxTrainer(JModel.new_from_onnx(data), **kw)
    p = tr.init_params()
    s = tr.init_opt_state(p)
    losses = []
    for b in batches[:steps]:
        p, s, loss = tr.train_step(p, s, b[:, :-1], b[:, 1:])
        losses.append(float(np.asarray(loss)))
    return tr, {k: np.asarray(v) for k, v in p.items()}, s, losses


def _port_run(data, steps, batches=BATCHES, **kw):
    tr = LMTrainer(Model.new_from_onnx(data), device="cpu", **kw)
    p = tr.init_params()
    s = tr.init_opt_state(p)
    losses = []
    for b in batches[:steps]:
        p, s, loss = tr.train_step(p, s, b[:, :-1], b[:, 1:])
        losses.append(float(loss))
    return tr, {k: v.numpy() for k, v in p.items()}, s, losses


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _close_rel(got, want, rel, what):
    for k in want:
        scale = max(np.abs(_f32(want[k])).max(), 1e-30)
        err = np.abs(_f32(got[k]) - _f32(want[k])).max()
        assert err <= rel * scale, (what, k, err, scale)


def _adam_close(got, want, grads, lr, steps, what):
    """Adam's bound (module docstring)."""
    for k in want:
        d = np.abs(_f32(got[k]) - _f32(want[k]))
        assert d.max() <= steps * lr, (what, k, d.max())
        g = np.abs(_f32(grads[k]))
        real = g >= 1e-3 * g.max()
        if real.any():
            assert d[real].max() <= 1e-2 * lr, (what, k, d[real].max())


def _jax_grads(tr, p, b):
    return {k: np.asarray(v) for k, v in jax.grad(tr.loss_fn)(
        {k: jax.numpy.asarray(v) for k, v in p.items()},
        b[:, :-1], b[:, 1:], tr._frozen_params()).items()}


def _port_grads(tr, p, b):
    leaves = {k: torch.as_tensor(np.asarray(v)).requires_grad_(True)
              for k, v in p.items()}
    loss = tr.loss_fn(leaves, b[:, :-1], b[:, 1:])
    names = list(leaves)
    gs = torch.autograd.grad(loss, [leaves[n] for n in names],
                             allow_unused=True)
    return {n: (np.zeros_like(np.asarray(p[n])) if g is None else g.numpy())
            for n, g in zip(names, gs)}


# -- the graphs --------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_training_recipes_are_byte_identical(family):
    if family == "gpt2":
        jcfg, pcfg = jax_gpt2.GPT2Config(**GPT2), gpt2.GPT2Config(**GPT2)
        jw, pw = {}, {}
        want = jax_gpt2.build_gpt2_train(
            jax_gpt2.random_gpt2_weights(jcfg, 4), jcfg, weight_map=jw)
        got = gpt2.build_gpt2_train(gpt2.random_gpt2_weights(pcfg, 4), pcfg,
                                    weight_map=pw)
    else:
        jcfg = jax_llama.LlamaConfig(**LLAMA)
        pcfg = llama.LlamaConfig(**LLAMA)
        jw, pw = {}, {}
        want = jax_llama.build_llama_train(_llama_getter(jcfg, 5), jcfg, 32,
                                           weight_map=jw)
        got = llama.build_llama_train(_llama_getter(pcfg, 5), pcfg, 32,
                                      weight_map=pw)
    assert got == want
    assert pw == jw and pw


# -- LMTrainer against the JAX package ------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd",
                                       "sgd_momentum"])
def test_optimizers_match_the_jax_trainer(gpt2_bytes, optimizer):
    lr = 1e-2
    jt, jp, js, jl = _jax_run(gpt2_bytes, 3, optimizer=optimizer, lr=lr)
    pt, pp, ps, pl = _port_run(gpt2_bytes, 3, optimizer=optimizer, lr=lr)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    p0 = {k: v.numpy() for k, v in pt.init_params().items()}
    jg = _jax_grads(jt, p0, BATCHES[0])
    _close_rel(_port_grads(pt, p0, BATCHES[0]), jg, 1e-5, "first grads")
    if optimizer.startswith("sgd"):
        _close_rel(pp, jp, 1e-5, "params")
    else:
        _adam_close(pp, jp, jg, lr, 3, "params")
    # the state lists its leaves as jax.tree.leaves does
    jleaves = jax.tree.leaves(js)
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in ps] == [(tuple(np.shape(t)), str(np.asarray(t).dtype))
                             for t in jleaves]


def test_bf16_compute_matches_the_jax_trainer(gpt2_bytes):
    _, _, _, jl = _jax_run(gpt2_bytes, 2, lr=1e-2,
                           compute_dtype=JDType.BF16)
    _, pp, _, pl = _port_run(gpt2_bytes, 2, lr=1e-2,
                             compute_dtype=DType.BF16)
    np.testing.assert_allclose(pl, jl, rtol=1e-2)
    assert all(v.dtype == np.float32 for v in pp.values())   # f32 masters


OPTIONS = {
    "grad_clip": dict(optimizer="sgd", lr=0.5, grad_clip=0.5),
    "accum_steps": dict(optimizer="sgd", lr=0.5, accum_steps=2),
    "warmup_cosine": dict(optimizer="sgd", lr=0.5,
                          lr_schedule="warmup_cosine", warmup_steps=2,
                          total_steps=5),
    "warmup_linear": dict(optimizer="sgd", lr=0.5,
                          lr_schedule="warmup_linear", warmup_steps=2,
                          total_steps=5),
    "all_with_adamw": dict(optimizer="adamw", lr=1e-2, grad_clip=0.5,
                           accum_steps=2, lr_schedule="warmup_cosine",
                           warmup_steps=1, total_steps=4),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_options_match_the_jax_trainer(gpt2_bytes, case):
    kw = OPTIONS[case]
    jt, jp, js, jl = _jax_run(gpt2_bytes, 5, **kw)
    pt, pp, ps, pl = _port_run(gpt2_bytes, 5, **kw)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    p0 = {k: v.numpy() for k, v in pt.init_params().items()}
    moved = max(np.abs(pp[k] - p0[k]).max() for k in pp)
    assert moved > 1e-4, case                  # the steps did something
    if kw["optimizer"] == "sgd":
        _close_rel(pp, jp, 1e-5, case)
    else:
        _adam_close(pp, jp, _jax_grads(jt, p0, BATCHES[0]), kw["lr"], 5,
                    case)
    jleaves = jax.tree.leaves(js)
    assert len(ps) == len(jleaves)
    for a, b in zip(ps, jleaves):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.double().numpy(),
                                   np.asarray(b, np.float64),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_equals_no_remat(gpt2_bytes, remat):
    _, base, _, bl = _port_run(gpt2_bytes, 2, lr=1e-2)
    _, got, _, gl = _port_run(gpt2_bytes, 2, lr=1e-2, remat=remat)
    np.testing.assert_allclose(gl, bl, rtol=1e-6)
    for k in base:
        np.testing.assert_allclose(got[k], base[k], rtol=1e-6, atol=1e-6)


def test_lora_trains_only_the_adapters_as_the_jax_trainer(gpt2_bytes):
    kw = dict(lr=1e-2, lora_rank=4, lora_targets=("wqkv_", "wfc_"))
    jt, jp, _, jl = _jax_run(gpt2_bytes, 2, **kw)
    pt, pp, _, pl = _port_run(gpt2_bytes, 2, **kw)
    assert sorted(pp) == sorted(jp) == sorted(
        f"{w}_{i}::lora_{s}" for w in ("wqkv", "wfc") for i in (0, 1)
        for s in "ab")
    for k, v in pt._lora_init.items():               # inject_lora's init
        np.testing.assert_array_equal(v, jt._lora_init[k])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    p0 = {k: v.numpy() for k, v in pt.init_params().items()}
    _adam_close(pp, jp, _jax_grads(jt, p0, BATCHES[0]), 1e-2, 2, "lora")
    # the base stayed as the store holds it
    store = pt.model.graph.store
    for n, t in pt._frozen_params().items():
        np.testing.assert_array_equal(t.numpy(),
                                      store.get_numeric(n).numpy())


def test_int8_frozen_base_matches_the_jax_trainer(llama_bytes,
                                                  numpy_quantizer):
    data, _ = llama_bytes
    batches = [RNG.integers(0, 512, (2, 13)) for _ in range(3)]
    kw = dict(lr=5e-3, lora_rank=4,
              lora_targets=("wq_", "wk_", "wv_", "wo_"),
              quantize_base="int8")
    _, _, _, jl = _jax_run(data, 3, batches, **kw)
    calls0 = Int8MatMul.backward_calls
    pt, _, _, pl = _port_run(data, 3, batches, **kw)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    quant = [n for n in pt.milli.nodes if n.op.KIND == "QuantMatMul"]
    # gate, up, down in 2 layers and the head; each x needs a gradient
    assert len(quant) == 7
    assert Int8MatMul.backward_calls - calls0 == 3 * len(quant)
    for n, t in pt._frozen_params().items():
        if n in pt._quantized_base:
            np.testing.assert_array_equal(t.numpy(),
                                          pt._quantized_base[n][0])


@pytest.mark.parametrize("M,K,N,dt", [(5, 7, 9, "f32"), (4, 33, 65, "f32"),
                                      (16, 64, 130, "f32"),
                                      (6, 31, 17, "bf16")])
def test_int8_matmul_backward_matches_autograd_and_jax(M, K, N, dt):
    rng = np.random.default_rng(M * K * N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt, st, dyt = torch.from_numpy(w), torch.from_numpy(s), \
        torch.from_numpy(dy).to(tdt)
    Int8MatMul.apply(xt, wt, st).backward(dyt)
    got = xt.grad.float().numpy()
    xr = xt.detach().clone().requires_grad_(True)
    int8_matmul_plain(xr, wt, st).backward(dyt)
    np.testing.assert_array_equal(got, xr.grad.float().numpy())
    np.testing.assert_array_equal(
        got, int8_matmul_dx(dyt, wt, st).float().numpy())
    if dt == "f32":
        jnp = jax.numpy
        _, vjp = jax.vjp(lambda a: jax_int8_matmul(a, jnp.asarray(w),
                                                   jnp.asarray(s)),
                         jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(dy))[0])
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# -- checkpoints and PEFT directories ------------------------------------------

def test_a_jax_checkpoint_resumes_in_the_port(gpt2_bytes, tmp_path):
    lr = 1e-2
    jt, jp6, _, jl6 = _jax_run(gpt2_bytes, 6, lr=lr)
    jt3, jp3, js3, _ = _jax_run(gpt2_bytes, 3, lr=lr)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, jp3, js3, step=3, extra={"lr": lr})
    pt = LMTrainer(Model.new_from_onnx(gpt2_bytes), lr=lr, device="cpu")
    p, s, step, extra = checkpoint.load_checkpoint(
        path, opt_state_like=pt.init_opt_state(pt.init_params()))
    assert step == 3 and extra == {"lr": lr}
    losses = []
    for b in BATCHES[3:6]:
        p, s, loss = pt.train_step(p, s, b[:, :-1], b[:, 1:])
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jl6[3:], rtol=1e-5)
    _adam_close({k: v.numpy() for k, v in p.items()}, jp6,
                _jax_grads(jt, jp3, BATCHES[3]), lr, 3, "resumed")


def test_a_port_checkpoint_loads_in_the_jax_package(gpt2_bytes, tmp_path):
    pt, pp, ps, _ = _port_run(gpt2_bytes, 2, lr=1e-2)
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, pp, ps, step=2)
    jt = JaxTrainer(JModel.new_from_onnx(gpt2_bytes), lr=1e-2)
    fresh = jt.init_opt_state(jt.init_params())
    jp, js, step, _ = jax_ckpt.load_checkpoint(path, opt_state_like=fresh)
    assert step == 2
    for a, b in zip(jax.tree.leaves(js), ps):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    b = BATCHES[2]
    _, _, jl = jt.train_step(jp, js, b[:, :-1], b[:, 1:])
    _, _, pl = pt.train_step(pp, ps, b[:, :-1], b[:, 1:])
    np.testing.assert_allclose(float(pl), float(np.asarray(jl)), rtol=1e-5)


def test_peft_directories_cross_both_ways(llama_bytes, tmp_path):
    _, wm = llama_bytes
    rng = np.random.default_rng(7)
    ad = {}
    for i in range(2):
        for w, (K, N) in (("wq", (128, 128)), ("w_down", (512, 128))):
            ad[f"{w}_{i}::lora_a"] = rng.standard_normal((K, 4)).astype(
                np.float32)
            ad[f"{w}_{i}::lora_b"] = rng.standard_normal((4, N)).astype(
                np.float32)
    port_dir = lora.save_peft_adapter(ad, wm, 4, str(tmp_path / "port"),
                                      alpha=8.0)
    jax_dir = jax_lora.save_peft_adapter(ad, wm, 4, str(tmp_path / "jax"),
                                         alpha=8.0)
    for d in (port_dir, jax_dir):
        for read in (lora.load_peft_adapter_arrays,
                     jax_lora.load_peft_adapter_arrays):
            back = read(d, wm)
            assert len(back) == 4
            for name, (a, b, sc) in back.items():
                np.testing.assert_array_equal(a, ad[f"{name}::lora_a"])
                np.testing.assert_array_equal(b, ad[f"{name}::lora_b"])
                assert sc == 2.0


# -- the grad guards -------------------------------------------------------------

def _route_calls():
    q = torch.randn(1, 2, 3, 64)
    cache = torch.zeros(1, 2, 8, 64)
    pos = torch.tensor([0])
    x = torch.randn(2, 32)
    w8 = torch.randint(-127, 128, (32, 16), dtype=torch.int8)
    s8 = torch.rand(16) + 0.1
    qp = torch.randint(0, 255, (32, 16), dtype=torch.uint8)
    sp = torch.rand(1, 16) + 0.1
    return {
        "flash_attention": lambda g: flash_attention(
            g(q), q, q, 0.125, causal=True),
        "decode_attention": lambda g: decode_attention(
            g(q[:, :, :1]), cache, cache, pos, 0.125),
        "ragged_kv_write": lambda g: ragged_kv_write(
            cache.clone(), g(q[:, :, :1]), pos),
        "kv_write_pair": lambda g: kv_write_pair(
            cache.clone(), g(q[:, :, :1]), cache.clone(), q[:, :, :1], pos),
        "packed_matmul": lambda g: packed_matmul(g(x), qp, sp, sp, 8),
        "int8_matmul": lambda g: int8_matmul(g(x), w8, s8),
        "int8_matmul_dx": lambda g: int8_matmul_dx(g(torch.randn(2, 16)),
                                                   w8, s8),
    }


@pytest.mark.parametrize("kernel", sorted(_route_calls()))
def test_kernel_routes_refuse_an_input_that_requires_grad(kernel):
    call = _route_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel} has no backward"):
        call(lambda t: t.clone().requires_grad_(True))
    with torch.no_grad():                     # no gradient: the plain version
        call(lambda t: t.clone().requires_grad_(True))
    call(lambda t: t)


def test_kernel_attention_disabled_sends_every_call_to_the_plain_path():
    op = AttentionMilli(is_causal=True)
    q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    dec = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16)
    pos = torch.tensor([3])
    assert flash_mode(op, q, k, k, None, False) == "causal"
    assert pos_mode(AttentionMilli(), dec, k, k, pos, False) == "decode"
    with kernel_attention_disabled():
        assert flash_mode(op, q, k, k, None, False) is None
        assert pos_mode(AttentionMilli(), dec, k, k, pos, False) is None
        with kernel_attention_disabled():
            pass
        assert flash_mode(op, q, k, k, None, False) is None
    assert flash_mode(op, q, k, k, None, False) == "causal"


def test_the_executor_never_lifts_an_input_that_requires_grad():
    g = MilliGraph("range")
    n = g.add_input("n")
    zero = g.op1(Constant(np.asarray(0.0, np.float32)))
    one = g.op1(Constant(np.asarray(1.0, np.float32)))
    g.mark_output("r", g.op1(Range(), zero, n, one))
    ex = GraphExecutor(g, torch.device("cpu"))
    assert ex({"n": torch.tensor(3.0)})["r"].tolist() == [0.0, 1.0, 2.0]
    ex = GraphExecutor(g, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="requires grad"):
        ex({"n": torch.tensor(3.0, requires_grad=True)})


def test_the_trainer_refuses_what_is_not_ported(gpt2_bytes, tmp_path):
    """What the trainer refuses (a mesh that is not a parallel.mesh.Mesh,
    quantize_base without adapters, a missing card by default), and, as
    in the JAX package, fsdp and rules without a mesh doing nothing: the
    same steps as the plain trainer's and the JAX trainer's given them.
    Training across ranks is held in test_torch_port_parallel_training.py;
    a checkpoint loaded with a mesh but no shardings comes back whole."""
    m = Model.new_from_onnx(gpt2_bytes)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        LMTrainer(m, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="lora_rank"):
        LMTrainer(m, device="cpu", quantize_base="int8")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMTrainer(m)                      # the card, by default
    kw = dict(optimizer="sgd", lr=1e-2)
    _, plain, s, pl = _port_run(gpt2_bytes, 2, **kw)
    for extra in (dict(fsdp=True), dict(rules=[]),
                  dict(fsdp=True, fsdp_min_size=1)):
        _, got, _, gl = _port_run(gpt2_bytes, 2, **kw, **extra)
        _, _, _, jl = _jax_run(gpt2_bytes, 2, **kw, **extra)
        assert gl == pl
        np.testing.assert_allclose(gl, jl, rtol=1e-5)
        for k in plain:
            np.testing.assert_array_equal(got[k], plain[k])
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, plain, s, step=2)
    back, _, step, _ = checkpoint.load_checkpoint(path, mesh=object())
    assert step == 2 and all(np.array_equal(back[k], plain[k])
                             for k in plain)


def test_int8_matmul_dx_plain_sums_in_f32_and_rounds_once():
    rng = np.random.default_rng(11)
    dy = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    w = torch.randint(-127, 128, (9, 40), dtype=torch.int8)
    s = torch.rand(40) + 0.5
    want = ((dy.double() * s.double()) @ w.double().t())
    got = int8_matmul_dx_plain(dy.bfloat16(), w, s)
    assert got.dtype == torch.bfloat16
    ref = ((dy.bfloat16().double() * s.double()) @ w.double().t())
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(),
                               rtol=2 ** -8, atol=1e-5)
    np.testing.assert_allclose(int8_matmul_dx_plain(dy, w, s).double(),
                               want, rtol=1e-5)
