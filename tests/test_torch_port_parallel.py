"""The port's parallel/ primitives against the JAX package's.

Spawned gloo worlds of 2 and 4 CPU ranks (tests/torch_parallel_world.py;
one spawn per world size for the module) run the port's mesh helpers,
collectives, ring attention, expert-parallel MoE and pipeline schedule;
this process runs the JAX package's counterparts on the conftest's
virtual 8-device mesh and holds the ranks' results to them. Inputs are
made from numpy with fixed seeds and handed to both.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parallel_world import World  # noqa: E402
import torch_parallel_world as tasks  # noqa: E402
from whisper_tensor_tpu.parallel import mesh as jax_mesh  # noqa: E402
from whisper_tensor_tpu.parallel import moe as jax_moe  # noqa: E402
from whisper_tensor_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_apply as jax_pipeline_apply)
from whisper_tensor_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention_sharded as jax_ring)
from whisper_tensor_tpu_torch.parallel import moe as port_moe  # noqa: E402


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


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


# -- the mesh and the collectives -------------------------------------------

GPT2_NAMES = ["wte", "wte_t", "wpe", "wqkv_0", "bqkv_0", "wproj_0",
              "bproj_0", "wfc_0", "bfc_0", "wmp_0", "bmp_0", "ln_f_g"]
GPT2_SHAPES = [(256, 64), (64, 256), (64, 64), (64, 192), (192,), (64, 64),
               (64,), (64, 256), (256,), (256, 64), (64,), (64,)]
LLAMA_NAMES = ["embed_tokens", "wq_0", "wk_0", "wv_0", "wo_0", "w_gate_0",
               "w_up_0", "w_down_0", "lm_head", "norm_0"]
LLAMA_SHAPES = [(128, 64), (64, 64), (64, 32), (64, 32), (64, 64),
                (64, 128), (64, 128), (128, 64), (64, 128), (64,)]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_factorizations_and_specs(request, n):
    names = {"gpt2": GPT2_NAMES, "llama": LLAMA_NAMES}
    shapes = {"gpt2": GPT2_SHAPES, "llama": LLAMA_SHAPES}
    got = _world(request, n).run(tasks.meshes, names, shapes)
    jm = jax_mesh.make_mesh(dp=n // 2, sp=1, tp=2)
    for rank, g in enumerate(got):
        assert g["make"] == {"dp": n // 2, "sp": 1, "tp": 2}
        assert g["make_ep"] == ({"dp": 1, "sp": 1, "tp": 2, "ep": n // 2}
                                if n > 2 else {"dp": 1, "sp": 1, "tp": 2})
        assert g["make"] == dict(jm.shape)
        assert g["auto"] == dict(jax_mesh.auto_mesh(n).shape)
        assert g["too_many"] == f"need {2 * n} devices, have {n}"
        # n/2 hosts of two ranks: dp spans them, tp stays inside
        assert g["multihost"] == {"dp": n // 2, "sp": 1, "tp": 2}
        assert g["oversubscribed"] == f"need 8 devices, have {n}"
        assert g["indivisible"] == ("local devices 2 not divisible by "
                                    "sp*tp=4")
        for key, rules in (("gpt2", jax_mesh.GPT2_RULES),
                           ("llama", jax_mesh.LLAMA_RULES)):
            want = [tuple(s.spec) for s in jax_mesh.weight_shardings(
                names[key], jm, rules)]
            assert [tuple(s) for s in g[key]] == want
            want = [tuple(s.spec) for s in jax_mesh.fsdp_shardings(
                names[key], shapes[key], jm, rules, min_size=1024)]
            assert [tuple(s) for s in g[key + "_fsdp"]] == want
        dp_i, tp_i = g["index"]
        assert (dp_i, tp_i) == divmod(rank, 2)
        arr = np.arange(8 * 6).reshape(8, 6)
        rows, cols = 8 // 2, 6 // (n // 2)
        np.testing.assert_array_equal(
            g["shard"], arr[tp_i * rows:(tp_i + 1) * rows,
                            dp_i * cols:(dp_i + 1) * cols])
        assert "odd" in g["odd"] and "dimension 0 (5) should be divisible " \
            "by 2" in g["odd"]


def test_jax_refuses_what_the_port_refuses():
    """jax.device_put refuses a dimension its mesh axis does not divide,
    as shard_array does (test_mesh_factorizations_and_specs)."""
    jm = jax_mesh.make_mesh(dp=1, sp=1, tp=2)
    with pytest.raises(ValueError, match="divisible by 2"):
        jax_mesh.shard_array(np.zeros((5, 4), np.float32),
                             jax_mesh.named(jm, "tp"))


@pytest.mark.parametrize("n", [2, 4])
def test_collectives(request, n):
    got = _world(request, n).run(tasks.collectives)
    xs = [np.arange(3, dtype=np.float32) + 10 * r for r in range(n)]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["sum"], sum(xs))
        np.testing.assert_array_equal(g["gather"], np.stack(xs))
        np.testing.assert_array_equal(g["bcast"], xs[-1])
        np.testing.assert_array_equal(g["shift"], xs[(r - 1) % n])
        np.testing.assert_array_equal(g["back"], xs[(r + 1) % n])
        # d/dx_r of sum_s (s + 1) * shift(x)_s: x_r lands on rank r + 1
        np.testing.assert_array_equal(g["shift_grad"],
                                      np.full(3, (r + 1) % n + 1.0))
        # every rank's loss sums the gathered squares: the gradients of
        # the n losses add up on x_r
        np.testing.assert_array_equal(g["gather_grad"], 2.0 * n * xs[r])
        assert g["calls"] >= 7


# -- ring attention ------------------------------------------------------------

def _full_attention(q, k, v, scale, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        S = q.shape[2]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_full_and_the_jax_ring(request, n, causal):
    rng = np.random.default_rng(10 + n + causal)
    B, H, S, D = 2, 2, 32, 16
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    got = _world(request, n).run(tasks.ring, q, k, v, causal)
    ref = _full_attention(q, k, v, D ** -0.5, causal)
    jax_out = np.asarray(jax_ring(q, k, v, jax_mesh.make_mesh(sp=n),
                                  causal=causal))
    for out in got:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, jax_out, rtol=1e-5, atol=1e-5)


# -- expert parallelism ------------------------------------------------------------

def _moe_params(rng, E, D, F):
    return {
        "router_w": rng.standard_normal((E, D)).astype(np.float32),
        "w_gate": (rng.standard_normal((E, D, F)) / np.sqrt(D)
                   ).astype(np.float32),
        "w_up": (rng.standard_normal((E, D, F)) / np.sqrt(D)
                 ).astype(np.float32),
        "w_down": (rng.standard_normal((E, F, D)) / np.sqrt(F)
                   ).astype(np.float32)}


@pytest.mark.parametrize("capacity,norm_topk,scale",
                         [(32, True, 1.0), (32, False, 2.5), (3, True, 1.0)])
def test_moe_ffn_matches_the_jax_version(capacity, norm_topk, scale):
    """Single process, capacity 32 (no drops) and 3 (drops)."""
    rng = np.random.default_rng(1)
    T, D, F, E, k = 32, 8, 12, 8, 2
    p = _moe_params(rng, E, D, F)
    x = rng.standard_normal((T, D)).astype(np.float32)
    args = [p["router_w"], p["w_gate"], p["w_up"], p["w_down"]]
    want = np.asarray(jax_moe.moe_ffn(x, *args, k=k, capacity=capacity,
                                      norm_topk=norm_topk, scale=scale))
    got = port_moe.moe_ffn(torch.from_numpy(x),
                           *[torch.from_numpy(a) for a in args], k=k,
                           capacity=capacity, norm_topk=norm_topk,
                           scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if capacity == 3:
        full = np.asarray(jax_moe.moe_ffn(x, *args, k=k, capacity=T))
        assert np.abs(got - full).max() > 0      # tokens were dropped
    logits = x @ p["router_w"].T
    np.testing.assert_allclose(
        float(port_moe.load_balance_loss(torch.from_numpy(logits), k)),
        float(jax_moe.load_balance_loss(logits, k)), rtol=1e-6)
    assert port_moe.moe_capacity(1024, 64, 6) == jax_moe.moe_capacity(
        1024, 64, 6)


@pytest.mark.parametrize("n,mesh_kw", [(2, {"ep": 2}), (4, {"ep": 4}),
                                       (4, {"tp": 2, "ep": 2})])
@pytest.mark.parametrize("capacity", [64, 6])
def test_moe_ffn_sharded(request, n, mesh_kw, capacity):
    rng = np.random.default_rng(2)
    T, D, F, E, k = 64, 16, 16, 8, 2
    p = _moe_params(rng, E, D, F)
    x = rng.standard_normal((T, D)).astype(np.float32)
    args = [p["router_w"], p["w_gate"], p["w_up"], p["w_down"]]
    want = np.asarray(jax_moe.moe_ffn(x, *args, k=k, capacity=capacity))
    got = _world(request, n).run(tasks.moe, p, x, k, capacity, mesh_kw)
    shard = (E // mesh_kw["ep"], D, F // mesh_kw.get("tp", 1))
    for g in got:
        assert g["w_gate"] == shard
        np.testing.assert_allclose(g["out"], want, rtol=1e-5, atol=1e-5)


def test_moe_ffn_with_aux_trains():
    rng = np.random.default_rng(3)
    E, D, F, T = 4, 8, 8, 32
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in _moe_params(rng, E, D, F).items()}
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))

    def loss():
        out, aux = port_moe.moe_ffn_with_aux(
            x, p["router_w"], p["w_gate"], p["w_up"], p["w_down"], k=2,
            capacity=T)
        return ((out - y) ** 2).mean() + aux

    l0 = loss()
    l0.backward()
    with torch.no_grad():
        for v in p.values():
            v -= 0.05 * v.grad
    assert float(loss()) < float(l0)


# -- pipeline parallelism ------------------------------------------------------------

def _stack(L, D, rng):
    return {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)
                  ).astype(np.float32),
            "b": (0.1 * rng.standard_normal((L, D))).astype(np.float32)}


def _sequential(params, x):
    h = torch.from_numpy(x)
    ps = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    for i in range(ps["w"].shape[0]):
        h = torch.tanh(h @ ps["w"][i] + ps["b"][i])
    (h ** 2).sum().backward()
    return h.detach().numpy(), {k: v.grad.numpy() for k, v in ps.items()}


def _jax_stage(p, h):
    import jax.numpy as jnp

    return jnp.tanh(h @ p["w"] + p["b"])


@pytest.mark.parametrize("n,M", [(2, 4), (4, 4), (4, 2)])
def test_pipeline_matches_sequential_and_jax(request, n, M):
    from jax.sharding import Mesh as JaxMesh

    rng = np.random.default_rng(n * 10 + M)
    L, D, B = 2 * n, 8, 8
    params = _stack(L, D, rng)
    x = rng.standard_normal((B, D)).astype(np.float32)
    got = _world(request, n).run(tasks.pipeline, params, x, M, True)
    ref, ref_grads = _sequential(params, x)
    jm = JaxMesh(np.asarray(jax.devices()[:n]), ("pp",))

    def loss(ps):
        return (jax_pipeline_apply(_jax_stage, ps, x, jm,
                                   microbatches=M) ** 2).sum()

    jax_out = np.asarray(jax_pipeline_apply(_jax_stage, params, x, jm,
                                            microbatches=M))
    # the JAX package's gradient at pp 2 (it costs seconds to trace)
    jax_grads = jax.grad(loss)(params) if n == 2 else ref_grads
    per = L // n
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["out"], ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["out"], jax_out, rtol=1e-5, atol=1e-6)
        for k in params:
            mine = slice(r * per, (r + 1) * per)
            # a rank's gradient covers its own layers, zero elsewhere
            np.testing.assert_allclose(g["grads"][k][mine],
                                       ref_grads[k][mine], rtol=1e-4,
                                       atol=1e-5)
            rest = np.delete(g["grads"][k], np.arange(mine.start, mine.stop),
                             axis=0)
            assert not rest.any()
    for k in params:
        total = sum(g["grads"][k] for g in got)
        np.testing.assert_allclose(total, np.asarray(jax_grads[k]),
                                   rtol=1e-4, atol=1e-5)
