"""Tasks of the port's training across ranks, run by every rank of a
spawned world (tests/torch_parallel_world.py World: task(rank, n, ...)).

Each builds its mesh (parallel.mesh.make_mesh on the CPU) and the port's
trainer, runs its steps on the whole batches every rank is handed, and
returns what the test holds against the JAX package: losses, the
parameters and gradients gathered whole (parallel.mesh.gather_block),
this rank's own blocks and coordinates, the bytes it keeps. Like the
rest of the ranks' code, this module imports only numpy, torch and the
port.
"""

from __future__ import annotations

import torch


def _mesh(mesh_kw: dict):
    from whisper_tensor_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device="cpu", **mesh_kw)


def _trainer(onnx: bytes, mesh, rules, kw: dict):
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.parallel import mesh as M
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    return LMTrainer(Model.new_from_onnx(onnx), mesh=mesh,
                     rules=None if rules is None else getattr(M, rules),
                     device="cpu", **kw)


def _whole(tr, params: dict) -> dict:
    """The parameters gathered whole (adapters are whole already)."""
    from whisper_tensor_tpu_torch.parallel.mesh import gather_block

    by_name = dict(zip(tr.weight_names, tr.param_shardings))
    return {n: (gather_block(v, by_name[n]) if n in by_name else v
                ).float().numpy() for n, v in params.items()}


def _nbytes(ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def train(rank, n, onnx: bytes, mesh_kw: dict, rules, batches, kw: dict,
          grads: bool = False, save=None, load=None):
    """Steps on `batches` under the mesh. grads: first the gathered
    gradients at the initial parameters (value_and_grad). save: a path
    the sharded checkpoint is written to after the steps. load: a
    checkpoint whose blocks the steps start from (load_checkpoint with
    the trainer's shardings)."""
    from whisper_tensor_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)

    mesh = _mesh(mesh_kw)
    tr = _trainer(onnx, mesh, rules, kw)
    p = tr.init_params()
    s = tr.init_opt_state(p)
    out = {"fallbacks": None if tr.tp_plan is None
           else list(tr.tp_plan.fallbacks),
           "kinds": {}, "index": {a: mesh.index(a) for a in mesh.shape}}
    if tr.tp_plan is not None:
        for node in tr.tp_plan.graph.nodes:
            out["kinds"][node.op.KIND] = out["kinds"].get(node.op.KIND, 0) + 1
    if load is not None:
        p, s, step, _ = load_checkpoint(
            load, opt_state_like=s, mesh=mesh,
            param_shardings=tr.param_shardings, param_order=tr.weight_names)
        out["loaded_step"] = step
    if grads:
        b = batches[0]
        loss, g = tr.value_and_grad(p, b[:, :-1], b[:, 1:])
        out["grad_loss"] = float(loss)
        out["grads"] = _whole(tr, g)
    losses = []
    for b in batches:
        p, s, loss = tr.train_step(p, s, b[:, :-1], b[:, 1:])
        losses.append(float(loss))
    out["losses"] = losses
    out["params"] = _whole(tr, p)
    out["local"] = {k: v.float().numpy() for k, v in p.items()}
    out["specs"] = ({n: sh.spec for n, sh in zip(tr.weight_names,
                                                 tr.param_shardings)}
                    if tr.param_shardings is not None else {})
    out["axes"] = {n: tuple(a for a in sh.axes())
                   for n, sh in zip(tr.weight_names, tr.param_shardings or [])}
    out["param_bytes"] = _nbytes(p.values())
    out["opt_bytes"] = _nbytes(x for x in s if x.ndim)
    out["opt_shapes"] = [tuple(x.shape) for x in s]
    frozen = tr._frozen_params()
    out["frozen_shapes"] = {k: tuple(v.shape) for k, v in frozen.items()}
    if save is not None:
        save_checkpoint(save, p, s, step=len(batches), extra={"lr": 1e-2},
                        mesh=mesh, param_shardings=tr.param_shardings,
                        param_order=tr.weight_names)
    return out


def layered(rank, n, cfg_kw: dict, weights: dict, mesh_shape, batches,
            steps: int, lr: float, onnx=None, optimizer: str = "adamw",
            grads: bool = False):
    """PipelinedLMTrainer over layered_gpt2 (of `weights`, HF names) on a
    (dp, pp, tp) mesh: the first batch's loss, `steps` steps on
    `batches`, the head's and the blocks' parameters gathered whole;
    with `onnx`, the port's LMTrainer loss of the imported graph on the
    first batch (no mesh); with `grads`, the gradients at the initial
    parameters on the first batch (value_and_grad), gathered whole."""
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config)
    from whisper_tensor_tpu_torch.parallel.mesh import Mesh, gather_block
    from whisper_tensor_tpu_torch.parallel.pipeline_trainer import (
        PipelinedLMTrainer, layered_gpt2)

    cfg = GPT2Config(**cfg_kw)
    mesh = Mesh(("dp", "pp", "tp"), mesh_shape, device="cpu")
    tr = PipelinedLMTrainer(layered_gpt2(cfg, weights.__getitem__,
                                         tp_axis="tp"),
                            mesh, microbatches=2, lr=lr, optimizer=optimizer)
    p = tr.init_params()
    o = tr.init_opt_state(p)
    ids, tgt = batches[0]
    out = {"first_loss": float(tr.loss_fn(p, ids, tgt))}
    if grads:
        _, g = tr.value_and_grad(p, ids, tgt)
        out["grads"] = {
            "embed": {k: v.numpy() for k, v in g["embed"].items()},
            "block": {k: gather_block(v, tr.block_sharding(k)).numpy()
                      for k, v in g["block"].items()},
            "head": {k: v.numpy() for k, v in g["head"].items()}}
    if onnx is not None:
        from whisper_tensor_tpu_torch.model import Model
        from whisper_tensor_tpu_torch.training.trainer import LMTrainer

        ref = LMTrainer(Model.new_from_onnx(onnx), optimizer="sgd", lr=0.0,
                        device="cpu")
        with torch.no_grad():
            out["graph_loss"] = float(ref.loss_fn(ref.init_params(), ids,
                                                  tgt))
    losses = []
    for i in range(steps):
        ids, tgt = batches[i % len(batches)]
        p, o, loss = tr.train_step(p, o, ids, tgt)
        losses.append(float(loss))
    out["losses"] = losses
    out["embed"] = {k: v.numpy() for k, v in p["embed"].items()}
    out["head"] = {k: v.numpy() for k, v in p["head"].items()}
    out["block"] = {k: gather_block(v, tr.block_sharding(k)).numpy()
                    for k, v in p["block"].items()}
    out["block_local"] = {k: tuple(v.shape) for k, v in p["block"].items()}
    return out
