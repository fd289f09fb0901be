"""Train a small GPT-2 on a synthetic copy task with the PyTorch port's
LMTrainer (autograd), optionally sharded over a (dp, sp, tp) mesh.

The port's counterpart of examples/gpt2_train.py: the same flags, sizes
and output, on the card unless --cpu asks for the CPU. The port's mesh
is a torch.distributed world of one process a rank, so --mesh starts one
process for each rank of the product (dp=2,sp=2,tp=2: eight), joined
over a local TCP store: gloo on the CPU, and gloo where the ranks
outnumber the cards and share them (NCCL takes one rank a card).
Every rank runs the same batches; the trainer cuts them over the mesh.

Reference equivalent: examples/gpt2_train.rs.

Run: python examples/torch_port/gpt2_train.py [--steps 40]
     [--mesh dp=2,sp=2,tp=2] [--cpu]
"""

import argparse
import os
import queue
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _train(args, device, mesh=None, verbose=True):
    """The training loop; returns the losses."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    cfg = GPT2Config(n_layer=2, n_head=4, n_embd=64, vocab_size=128,
                     n_positions=64)
    model = Model.new_from_onnx(
        build_gpt2_train(random_gpt2_weights(cfg), cfg), name="gpt2-train")
    trainer = LMTrainer(model, optimizer="adamw", lr=3e-3, mesh=mesh,
                        compute_dtype=DType.BF16 if args.bf16 else None,
                        grad_clip=args.grad_clip, accum_steps=args.accum,
                        device=device)
    params = trainer.init_params()
    opt_state = trainer.init_opt_state(params)

    rng = np.random.default_rng(0)

    def copy_task_batch(B=8, S=32):
        """seq = [pattern, pattern]; the model must learn to copy."""
        half = S // 2
        pat = rng.integers(1, 128, (B, half))
        seq = np.concatenate([pat, pat], axis=1)
        return seq[:, :-1], seq[:, 1:]

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        ids, targets = copy_task_batch()
        params, opt_state, loss = trainer.train_step(params, opt_state,
                                                     ids, targets)
        losses.append(float(loss))
        if verbose and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:3d}  loss {losses[-1]:.4f}", flush=True)
    if verbose:
        print(f"done in {time.time() - t0:.1f}s", flush=True)
    return losses


def _rank(rank, n, port, spec, args, cpu, out):
    """One rank of the --mesh world (a spawned process)."""
    import torch
    import torch.distributed as dist

    from whisper_tensor_tpu_torch.parallel.mesh import (distributed_init,
                                                        make_mesh)

    if cpu:
        device, backend = "cpu", "gloo"
    else:
        cards = torch.cuda.device_count()
        device = f"cuda:{rank % max(cards, 1)}"
        backend = "nccl" if n <= cards else "gloo"
    distributed_init(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=rank, backend=backend, device=device)
    try:
        mesh = make_mesh(**spec, device=device)
        if rank == 0:
            print("mesh:", mesh, flush=True)
        losses = _train(args, device, mesh, verbose=rank == 0)
        if rank == 0:
            out.put(losses)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute, f32 master weights")
    ap.add_argument("--grad-clip", type=float, default=None)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation microsteps")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")
    if not args.mesh:
        return {"device": str(device), "losses": _train(args, device)}

    import multiprocessing as mp

    spec = {k: int(v) for k, v in
            (kv.split("=") for kv in args.mesh.split(","))}
    n = int(np.prod(list(spec.values())))
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank,
                         args=(r, n, port, spec, args, args.cpu, out))
             for r in range(n)]
    for p in procs:
        p.start()
    losses, t0 = None, time.time()
    try:
        while losses is None:
            try:
                losses = out.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) \
                        or time.time() - t0 > 900:
                    break
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    rcs = [p.exitcode for p in procs]
    if losses is None or any(rcs):
        raise SystemExit(f"a rank failed: exit codes {rcs}")
    return {"device": str(device), "losses": losses, "ranks": n}


if __name__ == "__main__":
    main()
