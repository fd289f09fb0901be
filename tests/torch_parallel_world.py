"""Spawned torch.distributed worlds for the port's parallel tests, and
the tasks their ranks run.

A `World(n, tmp)` starts n processes (multiprocessing's spawn), each a
gloo rank on the CPU joined through a `file://` store under `tmp` (no
port, so pytest-xdist workers never meet), with torch on one thread.
`world.run(task, *args)` hands every rank the same task and returns the
ranks' results in rank order; a rank that raises fails the call with
its traceback. This module and the tasks import only numpy, torch and
the port: the ranks never import jax or the JAX package (the test
files, in the parent, hold their results against it).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import traceback
from typing import Any, List

import numpy as np
import torch

TIMEOUT_S = 300


def _serve(rank: int, n: int, store: str, inq, outq) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from whisper_tensor_tpu_torch.parallel.mesh import distributed_init

    distributed_init(f"file://{store}", n, rank, device="cpu",
                     timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
    try:
        while True:
            task = inq.get()
            if task is None:
                break
            fn, args = task
            try:
                outq.put((rank, True, fn(rank, n, *args)))
            except BaseException:       # reported to the parent, which fails
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp):
        ctx = mp.get_context("spawn")
        self.n = n
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(n)]
        store = os.path.join(str(tmp), f"store-{n}")
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, n, store, self.inqs[r], self.outq))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> List[Any]:
        for q in self.inqs:
            q.put((fn, args))
        got = {}
        try:
            for _ in range(self.n):
                rank, ok, res = self.outq.get(timeout=TIMEOUT_S)
                got[rank] = (ok, res)
        except queue.Empty:
            raise RuntimeError(f"{fn.__name__}: ranks {sorted(got)} of "
                               f"{self.n} answered in {TIMEOUT_S} s")
        bad = {r: res for r, (ok, res) in got.items() if not ok}
        if bad:
            raise RuntimeError(f"{fn.__name__} failed on ranks "
                               f"{sorted(bad)}:\n" + "\n".join(bad.values()))
        return [got[r][1] for r in range(self.n)]

    def close(self) -> None:
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# -- tasks (each runs on every rank: task(rank, n, *args)) ---------------------

def _kinds(graph) -> dict:
    out = {}
    for node in graph.nodes:
        out[node.op.KIND] = out.get(node.op.KIND, 0) + 1
    return out


def _interface(onnx: bytes, dp: int, tp: int, rules: str, **kw):
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(dp=dp, tp=tp, device="cpu")
    return TextInferenceInterface(
        Model.new_from_onnx(onnx), max_len=64, prompt_buckets=(8,),
        cache_dtype=DType.F32, mesh=mesh,
        shard_rules=getattr(M, rules), device="cpu", **kw)


def serve(rank, n, onnx: bytes, dp: int, tp: int, rules: str, prompt,
          n_new: int, quantize=None, sampled: bool = False) -> dict:
    """Greedy (or sampled) tokens and prefill logits of the sharded
    interface, with what its plan did."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.interfaces.text import SamplingParams

    kw = {} if quantize is None else {"quantize": quantize,
                                      "weight_dtype": DType.F32}
    it = _interface(onnx, dp, tp, rules, **kw)
    sp = (SamplingParams(temperature=0.9, top_k=20, seed=5) if sampled
          else None)
    toks = it.generate_tokens(prompt, n_new, sampling=sp)
    weights = it._weights()
    return {"tokens": toks, "logits": it.logits(prompt),
            "fallbacks": list(it._tp.fallbacks),
            "kinds": _kinds(it._exec.graph),
            "split": {k: (v.dim, v.sections) for k, v in it._tp.inputs.items()},
            "shapes": {k: tuple(v.shape) for k, v in weights.items()},
            "cache": tuple(it.fresh_cache(prompt.shape[0])[0].shape),
            "comm_calls": it.mesh.comm_calls}


def windowed(rank, n, onnx: bytes, wins: dict, dp: int, tp: int,
             rules: str, prompt, n_new: int) -> dict:
    """Greedy tokens of the sharded interface with window graphs ({size:
    the recipe's structure-only ONNX at that max_len}, over the main
    model's store) and without them, with the sharded cache lengths
    each windowed step ran over."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.parallel import mesh as M

    main = Model.new_from_onnx(onnx)
    models = {}
    for w, data in wins.items():
        models[w] = Model.new_from_onnx(data)
        models[w].graph.store = main.graph.store
    kw = dict(max_len=64, prompt_buckets=(8,), cache_dtype=DType.F32,
              mesh=M.make_mesh(dp=dp, tp=tp, device="cpu"),
              shard_rules=getattr(M, rules), device="cpu")
    it = TextInferenceInterface(main, window_models=models, **kw)
    lengths = []
    inner = it.step

    def step(ids, pos, caches, lora_idx=None, window=None):
        lengths.append(tuple(caches[0].shape))
        return inner(ids, pos, caches, lora_idx, window)

    it.step = step
    toks = it.generate_tokens(prompt, n_new)
    flat = TextInferenceInterface(main, **kw).generate_tokens(prompt, n_new)
    return {"tokens": toks, "flat": flat, "caches": sorted(set(lengths)),
            "fallbacks": list(it._tp.fallbacks)}


def refused(rank, n, onnx: bytes, tp: int, rules: str) -> str:
    """The message of the ValueError a sharded interface raises."""
    try:
        it = _interface(onnx, 1, tp, rules)
        it.logits(np.zeros((1, 4), np.int64))
    except ValueError as e:
        return str(e)
    return ""


def adapted_logits(rank, n, onnx: bytes, tp: int, A, B, ids) -> np.ndarray:
    """Prefill logits with LoRA adapter `a` on wfc_0 (scale 0.5), rows
    0 and 1 on slots 0 (base) and 1 (a)."""
    import whisper_tensor_tpu_torch.interfaces.text as T

    it = _interface(onnx, 1, tp, "GPT2_RULES")
    it.install_adapters({"a": {"wfc_0": (A, B, 0.5)}})
    Sb = T._bucket(ids.shape[1], it.prompt_buckets)
    padded = np.zeros((ids.shape[0], Sb), np.int64)
    padded[:, :ids.shape[1]] = ids
    logits = it.step(torch.from_numpy(padded),
                     torch.zeros((), dtype=torch.int64),
                     it.fresh_cache(ids.shape[0]),
                     lora_idx=torch.tensor([0, 1]))
    return {"logits": logits[:, :ids.shape[1]].numpy(),
            "fallbacks": list(it._tp.fallbacks),
            "kinds": _kinds(it._exec_lora.graph),
            "split": {k: (v.dim, v.sections) for k, v in it._tp.inputs.items()}}


def ring(rank, n, q, k, v, causal: bool) -> np.ndarray:
    from whisper_tensor_tpu_torch.parallel.mesh import Mesh
    from whisper_tensor_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)

    mesh = Mesh(("sp",), (n,), device="cpu")
    return ring_attention_sharded(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), mesh,
                                  causal=causal).numpy()


def moe(rank, n, p: dict, x, k: int, capacity: int, mesh_kw: dict):
    from whisper_tensor_tpu_torch.parallel.mesh import make_mesh
    from whisper_tensor_tpu_torch.parallel.moe import (moe_ffn,
                                                       shard_moe_params)

    mesh = make_mesh(device="cpu", **mesh_kw)
    sp = shard_moe_params(p, mesh)
    out = moe_ffn(torch.from_numpy(x), sp["router_w"], sp["w_gate"],
                  sp["w_up"], sp["w_down"], k=k, capacity=capacity,
                  mesh=mesh)
    return {"out": out.numpy(), "w_gate": tuple(sp["w_gate"].shape)}


def _mlp_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline(rank, n, params: dict, x, microbatches: int, grads: bool):
    """Output of pipeline_apply over pp = n and, with grads, this rank's
    gradients of sum(out ** 2) with respect to the whole stacks."""
    from whisper_tensor_tpu_torch.parallel.mesh import (Mesh, Sharding,
                                                        local_block)
    from whisper_tensor_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = Mesh(("pp",), (n,), device="cpu")
    ps = {k: torch.from_numpy(v).requires_grad_(grads)
          for k, v in params.items()}
    mine = {k: local_block(v, Sharding(mesh, ("pp",)), k)
            for k, v in ps.items()}
    out = pipeline_apply(_mlp_stage, mine, torch.from_numpy(x), mesh,
                         microbatches=microbatches)
    res = {"out": out.detach().numpy()}
    if grads:
        (out ** 2).sum().backward()
        res["grads"] = {k: v.grad.numpy() for k, v in ps.items()}
    return res


def meshes(rank, n, names, shapes):
    """The mesh helpers' factorizations and spec tuples on this world."""
    from whisper_tensor_tpu_torch.parallel import mesh as M

    out = {"make": M.make_mesh(dp=n // 2, tp=2, device="cpu").shape,
           "make_ep": M.make_mesh(tp=2, ep=n // 2, device="cpu").shape,
           "auto": M.auto_mesh(n, device="cpu").shape}
    try:
        M.make_mesh(dp=n, tp=2, device="cpu")
    except ValueError as e:
        out["too_many"] = str(e)
    saved = os.environ.get("LOCAL_WORLD_SIZE")
    os.environ["LOCAL_WORLD_SIZE"] = "2"     # "hosts" of two ranks
    try:
        out["multihost"] = M.multihost_mesh(sp=1, tp=2, device="cpu").shape
        try:
            M.multihost_mesh(dp_hosts=4, sp=1, tp=2, device="cpu")
        except ValueError as e:
            out["oversubscribed"] = str(e)
        try:
            M.multihost_mesh(sp=1, tp=4, device="cpu")
        except ValueError as e:
            out["indivisible"] = str(e)
    finally:
        if saved is None:
            del os.environ["LOCAL_WORLD_SIZE"]
        else:
            os.environ["LOCAL_WORLD_SIZE"] = saved
    mesh = M.make_mesh(dp=n // 2, tp=2, device="cpu")
    for key, rules in (("gpt2", M.GPT2_RULES), ("llama", M.LLAMA_RULES)):
        out[key] = [s.spec for s in M.weight_shardings(names[key], mesh,
                                                       rules)]
        out[key + "_fsdp"] = [s.spec for s in M.fsdp_shardings(
            names[key], shapes[key], mesh, rules, min_size=1024)]
    out["index"] = (mesh.index("dp"), mesh.index("tp"))
    arr = np.arange(8 * 6).reshape(8, 6)
    out["shard"] = M.shard_array(arr, M.named(mesh, "tp", "dp")).numpy()
    try:
        M.shard_array(np.zeros((5, 4)), M.named(mesh, "tp"), "odd")
    except ValueError as e:
        out["odd"] = str(e)
    return out


def collectives(rank, n):
    """Each helper of parallel/comm.py on small tensors, with and
    without autograd."""
    from whisper_tensor_tpu_torch.parallel import comm
    from whisper_tensor_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(("x",), (n,), device="cpu")
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    out = {"sum": comm.all_reduce(x, mesh, "x").numpy(),
           "gather": comm.all_gather(x[None], mesh, "x", 0).numpy(),
           "bcast": comm.broadcast(x, mesh, "x", src=n - 1).numpy(),
           "shift": comm.ring_shift(x, mesh, "x").numpy(),
           "back": comm.ring_shift(x, mesh, "x", -1).numpy()}
    w = x.clone().requires_grad_(True)
    (comm.ring_shift(w, mesh, "x") * (rank + 1)).sum().backward()
    out["shift_grad"] = w.grad.numpy()
    w = x.clone().requires_grad_(True)
    (comm.all_gather(w, mesh, "x", 0) ** 2).sum().backward()
    out["gather_grad"] = w.grad.numpy()
    out["calls"] = mesh.comm_calls
    return out
