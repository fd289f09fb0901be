"""Train the MNIST-like conv net on the PyTorch port as a SERIALIZABLE
SuperGraph job: the epoch loop is a SuperGraph Scan whose body runs the milli training
artifact (forward+loss+backward+AdamW as one graph, embedded via milli
serde). The job JSON round-trips before running — what executes is the
deserialized graph, as if it had been shipped to a server.

The port's counterpart of examples/mnist_train_supergraph.py: the same
flags, sizes and output, on the card unless --cpu asks for the CPU; it
imports the net and the batches from the port's mnist_train.py beside
it.

Reference equivalent: examples/mnist_train_supergraph.rs.

Run: python examples/torch_port/mnist_train_supergraph.py [--steps 40]
     [--smoke] [--oracle] [--cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mnist_train import build_forward, synthetic_batch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = 12

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.milli.optimizers import (OptimizerKind,
                                                           OptimizerOptions)
    from whisper_tensor_tpu_torch.milli.training_graph import \
        build_training_graph
    from whisper_tensor_tpu_torch.super_graph import (ExecutionContext,
                                                      SuperGraph)
    from whisper_tensor_tpu_torch.super_graph.training import (
        build_training_supergraph, initial_train_state)

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")

    rng = np.random.default_rng(0)
    fwd, params = build_forward(rng)
    train, meta = build_training_graph(
        fwd, list(params), "pred", loss="cross_entropy",
        optimizer=OptimizerOptions(OptimizerKind.ADAMW, lr=3e-3))

    sg = build_training_supergraph(train, meta, ["x", "target"],
                                   name="mnist_train")
    # the serializable-job property: run the DESERIALIZED graph
    wire = json.dumps(sg.to_json())
    print(f"job JSON: {len(wire) / 1024:.0f} KiB")
    sg2 = SuperGraph.from_json(json.loads(wire))

    xs, ys = zip(*(synthetic_batch(rng) for _ in range(args.steps)))
    feeds = {"init_state": initial_train_state(meta, params),
             "batches_x": np.stack(xs), "batches_target": np.stack(ys)}

    t0 = time.time()
    ctx = ExecutionContext(backend_mode="oracle" if args.oracle else "torch",
                           device=device)
    out = sg2.run(ctx, feeds)
    losses = np.asarray(out["losses"], dtype=np.float64)
    print(f"losses: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({args.steps} steps, {time.time() - t0:.1f}s)")
    if not losses[-1] < losses[0]:
        raise SystemExit("SuperGraph training did not learn")

    final = out["final_state"]
    x, y = synthetic_batch(rng, 256)
    pred = fwd.eval({"x": x, **{k: final[k] for k in params}})["pred"]
    acc = float((pred.argmax(-1) == y).mean())
    print(f"accuracy: {acc:.3f}")
    if not args.smoke and acc <= 0.9:
        raise SystemExit("SuperGraph training failed to converge")
    return {"device": str(device), "losses": losses.tolist(),
            "accuracy": acc}


if __name__ == "__main__":
    main()
