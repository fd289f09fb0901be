"""Multi-host distributed training demo on the PyTorch port: N processes
join one torch.distributed world and run a tp-sharded + dp-batched train
step whose gradient all-reduce crosses process boundaries.

The port's counterpart of examples/multihost_train.py, on
`parallel.mesh.distributed_init` and `multihost_mesh`, with the port's
collectives (parallel.comm) in place of jax.sharding. A rank is one
process: on its card by default (NCCL, or gloo where the ranks of a host
outnumber its cards and share them), on the CPU with --cpu (gloo).
--local-devices counts a host's devices; in the JAX example they are
virtual devices inside each process, here they are the host's ranks
(LOCAL_WORLD_SIZE, which multihost_mesh reads to lay dp over the hosts
and tp inside each). 0, the default, puts every process on one host.

Reference: the reference has NO distributed execution (SURVEY §2.6) —
this is the net-new multi-host story built on
`parallel.mesh.distributed_init` and `multihost_mesh`.

Run (launcher — spawns both workers on this machine over localhost):
    python examples/torch_port/multihost_train.py --smoke [--cpu]
Several hosts (one command per process):
    python examples/torch_port/multihost_train.py --worker \\
        --coordinator host0:9876 --num-processes 2 --process-id <i>
"""

import argparse
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def worker(coordinator, num_processes, process_id, local_devices, cpu):
    import numpy as np
    import torch
    import torch.distributed as dist

    from whisper_tensor_tpu_torch.parallel import comm
    from whisper_tensor_tpu_torch.parallel.mesh import (
        Sharding, distributed_init, local_block, multihost_mesh)

    n_local = local_devices or num_processes
    if local_devices:
        os.environ["LOCAL_WORLD_SIZE"] = str(local_devices)
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        cards = torch.cuda.device_count()
        device = torch.device("cuda", process_id % n_local % max(cards, 1))
        backend = "nccl" if n_local <= cards else "gloo"
    distributed_init(coordinator=coordinator, num_processes=num_processes,
                     process_id=process_id, backend=backend, device=device)
    try:
        mesh = multihost_mesh(sp=1, tp=2, device=device)
        if process_id == 0:
            print(f"world: {dist.get_world_size()} ranks ({backend}, "
                  f"{device.type})  mesh: {mesh.shape}", flush=True)

        rng = np.random.default_rng(0)
        B, Din, H = 64, 32, 128
        x = rng.standard_normal((B, Din)).astype(np.float32)
        y = rng.standard_normal((B, Din)).astype(np.float32)
        w1 = (rng.standard_normal((Din, H)) * 0.2).astype(np.float32)
        w2 = (rng.standard_normal((H, Din)) * 0.2).astype(np.float32)

        def put(a, *spec):
            return torch.from_numpy(np.ascontiguousarray(
                local_block(a, Sharding(mesh, spec)))).to(device)

        # Megatron layout: W1 column-cut, W2 row-cut over tp; the batch
        # over dp
        xd, yd = put(x, "dp"), put(y, "dp")
        w1d, w2d = put(w1, None, "tp"), put(w2, "tp")

        def step(w1, w2):
            w1 = w1.detach().requires_grad_(True)
            w2 = w2.detach().requires_grad_(True)
            h = torch.tanh(comm.copy_in(xd, mesh, "tp") @ w1)
            pred = comm.reduce_out(h @ w2, mesh, "tp")
            # each dp rank's term of the global mean, summed
            loss = comm.reduce_out(((pred - yd) ** 2).sum() / (B * Din),
                                   mesh, "dp")
            g1, g2 = torch.autograd.grad(loss, [w1, w2])
            g1, g2 = comm.all_reduce_many([g1, g2], mesh, "dp")
            return loss.detach(), (w1 - 0.1 * g1).detach(), \
                (w2 - 0.1 * g2).detach()

        for i in range(10):
            loss, w1d, w2d = step(w1d, w2d)
            if process_id == 0:
                print(f"step {i:2d}  loss {float(loss):.6f}", flush=True)
        print(f"MULTIHOST TRAIN OK pid={process_id} "
              f"final_loss={float(loss):.6f}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="spawn 2 local workers over localhost")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="a host's ranks (0 = every process on one host)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.worker:
        worker(args.coordinator, args.num_processes, args.process_id,
               args.local_devices, args.cpu)
        return None

    from whisper_tensor_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}", flush=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i),
         "--local-devices", str(args.local_devices)]
        + (["--cpu"] if args.cpu else []))
        for i in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise SystemExit(f"worker failed: rcs={rcs}")
    print("both workers finished", flush=True)
    return {"device": str(device), "ranks": 2}


if __name__ == "__main__":
    main()
