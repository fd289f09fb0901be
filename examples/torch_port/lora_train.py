"""LoRA fine-tune a small GPT-2 on the PyTorch port: low-rank A·B
adapters injected by milli graph surgery (milli.transforms.inject_lora);
ONLY the adapters train — the base weights are frozen inputs of the
step graph.

The port's counterpart of examples/lora_train.py: the same flags, sizes
and output, on the card unless --cpu asks for the CPU.

Reference equivalent: examples/rwkv_lora_train.rs (adapters trained
through the milli training artifact).

Run: python examples/torch_port/lora_train.py [--steps 40] [--rank 4]
     [--smoke] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=8.0)
    ap.add_argument("--targets", default="wqkv,wproj,wfc,wmp",
                    help="comma list of weight-name substrings to adapt")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run for CI (6 steps)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")

    cfg = GPT2Config(n_layer=2, n_head=4, n_embd=64, vocab_size=128,
                     n_positions=64)
    model = Model.new_from_onnx(
        build_gpt2_train(random_gpt2_weights(cfg), cfg), name="gpt2-lora")

    steps = 6 if args.smoke else args.steps
    trainer = LMTrainer(model, optimizer="adamw", lr=1e-2,
                        lora_rank=args.rank, lora_alpha=args.alpha,
                        lora_targets=[t for t in args.targets.split(",") if t],
                        device=device)
    params = trainer.init_params()
    opt_state = trainer.init_opt_state(params)
    n_adapter = sum(int(np.prod(tuple(v.shape))) for v in params.values())
    n_base = sum(
        int(np.prod(model.graph.store.get_numeric(n).numpy().shape))
        for n in trainer.weight_names)
    print(f"adapters: {len(params)} tensors, {n_adapter:,} params "
          f"({100.0 * n_adapter / n_base:.2f}% of the {n_base:,} frozen)")

    rng = np.random.default_rng(0)

    def copy_task_batch(B=8, S=32):
        half = S // 2
        pat = rng.integers(1, 128, (B, half))
        seq = np.concatenate([pat, pat], axis=1)
        return seq[:, :-1], seq[:, 1:]

    t0 = time.time()
    losses = []
    for step in range(steps):
        ids, targets = copy_task_batch()
        params, opt_state, loss = trainer.train_step(params, opt_state,
                                                     ids, targets)
        loss = float(loss)
        losses.append(loss)
        first = losses[0]
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:3d}  loss {loss:.4f}")
    print(f"done in {time.time() - t0:.1f}s (loss {first:.4f} -> {loss:.4f})")
    if not loss < first:
        raise SystemExit("LoRA training did not reduce the loss")
    return {"device": str(device), "losses": losses}


if __name__ == "__main__":
    main()
