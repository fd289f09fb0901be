"""A multi-process training step of the PyTorch port (the counterpart of
tests/test_multihost.py).

Four processes, two "hosts" of two (LOCAL_WORLD_SIZE=2), join one world
through the port's distributed_init with a TCP coordinator on a free
local port (gloo on the CPU). multihost_mesh(tp=2) lays dp over the
hosts and tp inside each, so dp=2. Each process runs the JAX test's
child step, a tanh MLP with W1 column-cut and W2 row-cut over tp and the
batch cut over dp, with the port's collectives (copy_in, reduce_out,
all_reduce over dp), and holds it against the same numpy referee; then
one LMTrainer step of a tiny GPT-2 over the same mesh, which this
process holds against the JAX package's single device. The children
import only the port.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (  # noqa: E402
    GPT2Config, build_gpt2_train, random_gpt2_weights)
from whisper_tensor_tpu.model import Model as JModel  # noqa: E402
from whisper_tensor_tpu.training.trainer import (  # noqa: E402
    LMTrainer as JaxTrainer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys
pid, port, onnx_path, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 sys.argv[4])
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from whisper_tensor_tpu_torch.parallel import comm
from whisper_tensor_tpu_torch.parallel.mesh import (
    Sharding, distributed_init, gather_block, local_block, multihost_mesh)

print("BACKEND", distributed_init(coordinator=f"127.0.0.1:{port}",
                                  num_processes=4, process_id=pid,
                                  device="cpu"), flush=True)
assert dist.get_world_size() == 4
# dp spans the two "hosts", tp=2 inside each
mesh = multihost_mesh(sp=1, tp=2, device="cpu")
assert mesh.shape == {"dp": 2, "sp": 1, "tp": 2}, mesh.shape

rng = np.random.default_rng(0)
B, Din, H = 32, 16, 64
x_full = rng.standard_normal((B, Din)).astype(np.float32)
y_full = rng.standard_normal((B, Din)).astype(np.float32)
w1_full = (rng.standard_normal((Din, H)) * 0.3).astype(np.float32)
w2_full = (rng.standard_normal((H, Din)) * 0.3).astype(np.float32)

def put(a, *spec):
    return torch.from_numpy(np.ascontiguousarray(
        local_block(a, Sharding(mesh, spec))))

# Megatron layout: W1 column-cut, W2 row-cut over tp; the batch over dp
x, y = put(x_full, "dp"), put(y_full, "dp")
w1 = put(w1_full, None, "tp").requires_grad_(True)
w2 = put(w2_full, "tp").requires_grad_(True)
h = torch.tanh(comm.copy_in(x, mesh, "tp") @ w1)
pred = comm.reduce_out(h @ w2, mesh, "tp")
# each dp rank's term of the global mean, summed into the loss
loss = comm.reduce_out(((pred - y) ** 2).sum() / (B * Din), mesh, "dp")
g1, g2 = torch.autograd.grad(loss, [w1, w2])
g1, g2 = comm.all_reduce_many([g1, g2], mesh, "dp")
w1n = gather_block((w1 - 0.1 * g1).detach(), Sharding(mesh, (None, "tp")))
w2n = gather_block((w2 - 0.1 * g2).detach(), Sharding(mesh, ("tp",)))

def ref_step(w1, w2):
    h = np.tanh(x_full @ w1)
    pred = h @ w2
    loss = np.mean((pred - y_full) ** 2)
    gp = 2.0 * (pred - y_full) / pred.size
    g2 = h.T @ gp
    gh = gp @ w2.T
    g1 = x_full.T @ (gh * (1 - h * h))
    return loss, w1 - 0.1 * g1, w2 - 0.1 * g2

rl, rw1, rw2 = ref_step(w1_full, w2_full)
np.testing.assert_allclose(float(loss), rl, rtol=1e-5)
np.testing.assert_allclose(w1n.numpy(), rw1, rtol=1e-5, atol=1e-6)
np.testing.assert_allclose(w2n.numpy(), rw2, rtol=1e-5, atol=1e-6)
print(f"MULTIHOST OK pid={pid} loss={float(loss):.6f}", flush=True)

from whisper_tensor_tpu_torch.model import Model
from whisper_tensor_tpu_torch.training.trainer import LMTrainer
with open(onnx_path, "rb") as f:
    onnx = f.read()
tr = LMTrainer(Model.new_from_onnx(onnx), optimizer="sgd", lr=1e-2,
               mesh=mesh)
p = tr.init_params()
s = tr.init_opt_state(p)
ids = np.random.default_rng(4).integers(0, 64, (4, 17))
p, s, loss = tr.train_step(p, s, ids[:, :-1], ids[:, 1:])
whole = {n: gather_block(p[n], sh).numpy()
         for n, sh in zip(tr.weight_names, tr.param_shardings)}
np.savez(os.path.join(out_dir, f"params-{pid}.npz"), **whole)
print("TRAIN " + json.dumps({"pid": pid, "loss": float(loss),
                             "fallbacks": tr.tp_plan.fallbacks}), flush=True)
dist.destroy_process_group()
""" % {"repo": REPO}

CFG = dict(n_layer=1, n_head=4, n_embd=64, vocab_size=64, n_positions=32)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_four_process_train_step(tmp_path):
    cfg = GPT2Config(**CFG)
    data = build_gpt2_train(random_gpt2_weights(cfg), cfg)
    onnx = tmp_path / "gpt2.onnx"
    onnx.write_bytes(data)
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    port = _free_port()
    procs = []
    for i in range(4):
        env = dict(os.environ, LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(i % 2))
        procs.append(subprocess.Popen(
            [sys.executable, str(child), str(i), str(port), str(onnx),
             str(tmp_path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert "BACKEND gloo" in out and "MULTIHOST OK" in out, out[-3000:]
    # every process computed the same replicated loss
    losses = {ln.split("loss=")[1] for out in outs for ln in out.splitlines()
              if "MULTIHOST OK" in ln}
    assert len(losses) == 1, losses
    # the LMTrainer step against the JAX package's single device
    train = [json.loads(ln[len("TRAIN "):]) for out in outs
             for ln in out.splitlines() if ln.startswith("TRAIN ")]
    assert len(train) == 4 and all(t["fallbacks"] == [] for t in train)
    tr = JaxTrainer(JModel.new_from_onnx(data), optimizer="sgd", lr=1e-2)
    p = tr.init_params()
    s = tr.init_opt_state(p)
    ids = np.random.default_rng(4).integers(0, 64, (4, 17))
    p, s, loss = tr.train_step(p, s, ids[:, :-1], ids[:, 1:])
    for t in train:
        np.testing.assert_allclose(t["loss"], float(np.asarray(loss)),
                                   rtol=2e-4, atol=1e-5)
    for i in range(4):
        with np.load(tmp_path / f"params-{i}.npz") as got:
            for k, v in p.items():
                want = np.asarray(v)
                assert np.abs(got[k] - want).max() <= \
                    1e-5 * np.abs(want).max(), (i, k)
