"""Train a small conv net on a synthetic MNIST-like task on the PyTorch
port, using the symbolic training-artifact path
(forward+loss+backward+optimizer as one editable milli graph) run by the
compiler facade (compiler.build_program: the graph executor on a torch
device).

The port's counterpart of examples/mnist_train.py: the same flags,
sizes and output, on the card unless --cpu asks for the CPU (the JAX
example compiles the graph to one XLA program; the port runs it on its
GraphExecutor through build_program).

Reference equivalent: examples/mnist_train.rs. No dataset files exist in
this image, so the task is synthetic: classify which quadrant of the
image contains the bright blob (learnable, non-trivial).

Run: python examples/torch_port/mnist_train.py [--steps 60] [--oracle]
     [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from whisper_tensor_tpu_torch.milli import MilliGraph  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import (  # noqa: E402
    Constant, Conv, MatMul, Reshape, SimpleUnary)
from whisper_tensor_tpu_torch.milli.optimizers import (  # noqa: E402
    OptimizerKind, OptimizerOptions)
from whisper_tensor_tpu_torch.milli.training_graph import (  # noqa: E402
    build_training_graph, init_opt_state)


def synthetic_batch(rng, n=64):
    x = rng.normal(0, 0.1, (n, 1, 14, 14)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    for i, lab in enumerate(labels):
        r, c = divmod(int(lab), 2)
        x[i, 0, 3 + 7 * r, 3 + 7 * c] = 3.0
        x[i, 0, 4 + 7 * r, 3 + 7 * c] = 3.0
    return x, labels.astype(np.int64)


def build_forward(rng):
    g = MilliGraph("convnet")
    x = g.add_input("x")
    w1 = g.add_input("conv_w")    # (8,1,3,3)
    b1 = g.add_input("conv_b")
    w2 = g.add_input("fc_w")      # (8*7*7, 4)
    h = g.op1(Conv(strides=[2, 2], pads=[1, 1, 1, 1]), x, w1, b1)
    h = g.op1(SimpleUnary("relu"), h)
    shp = g.op1(Constant(np.asarray([0, 8 * 7 * 7], dtype=np.int64)))
    h = g.op1(Reshape(), h, shp)
    g.mark_output("pred", g.op1(MatMul(), h, w2))
    params = {
        "conv_w": (rng.standard_normal((8, 1, 3, 3)) * 0.3).astype(np.float32),
        "conv_b": np.zeros(8, dtype=np.float32),
        "fc_w": (rng.standard_normal((8 * 7 * 7, 4)) * 0.05).astype(np.float32),
    }
    return g, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--oracle", action="store_true",
                    help="run the interpreter instead of the executor")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")

    rng = np.random.default_rng(0)
    fwd, params = build_forward(rng)
    g, meta = build_training_graph(
        fwd, list(params), "pred", loss="cross_entropy",
        optimizer=OptimizerOptions(OptimizerKind.ADAMW, lr=3e-3))
    print(f"training graph: {g} (census: {g.op_census()})")
    state = init_opt_state(meta, params)

    compiled = None
    if not args.oracle:
        from whisper_tensor_tpu_torch.compiler import (CompilationSubject,
                                                       build_program)

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        x, y = synthetic_batch(rng)
        feeds = {"x": x, "target": y, **params, **state,
                 "step": np.asarray(step + 1.0, dtype=np.float32)}
        if args.oracle:
            out = g.eval(feeds)
        else:
            if compiled is None:
                compiled = build_program(CompilationSubject(milli=g), device)
            out = compiled.run(feeds)
        params = {k: out[f"new::{k}"] for k in params}
        state = {k: out[meta.opt_state_in_to_out[k]] for k in state}
        losses.append(float(out["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {float(out['loss']):.4f}")

    # eval accuracy on a fresh batch
    x, y = synthetic_batch(rng, 256)
    pred = fwd.eval({"x": x, **params})["pred"]
    acc = (pred.argmax(-1) == y).mean()
    print(f"accuracy: {acc:.3f}  ({time.time() - t0:.1f}s)")
    if acc <= 0.9:
        raise SystemExit("training failed to converge")
    return {"device": str(device), "losses": losses, "accuracy": float(acc)}


if __name__ == "__main__":
    main()
