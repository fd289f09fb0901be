"""Continuous-batching serving demo on the PyTorch port: N concurrent
clients against one ContinuousBatcher (the scheduler behind the WS
server's ragged models).

The port's counterpart of examples/serve_clients.py: the same flags,
sizes and output, on the card unless --cpu asks for the CPU.
Reference serving seam: crates/whisper-tensor-server/src/scheduler.rs.
Run:  python examples/torch_port/serve_clients.py [--clients 8]
      [--tokens 32] [--model /path/to/hf_dir] [--cpu]
      (defaults to a random tiny GPT-2)
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
    ap.add_argument("--model", help="HF dir (loaded with ragged_decode)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill piece width (0 = whole bucket)")
    ap.add_argument("--prefix", type=int, default=0,
                    help="shared system-prompt length: prefill its KV "
                         "once, reuse for every request")
    ap.add_argument("--adapters", default="",
                    help="multi-LoRA: name=peft_dir[,name2=dir2] — "
                         "clients round-robin base + adapters in one "
                         "batch (needs --model, gpt2/llama-family)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    device = resolve_device("cpu" if args.cpu else None)
    if args.model:
        from whisper_tensor_tpu_torch.importers.loaders import loader_registry

        bundle = loader_registry()["transformers"].load(
            {"path": args.model, "ragged_decode": True, "max_len": 512,
             "serve_adapters": args.adapters})
        model = next(iter(bundle.models.values()))
        spec = bundle.interfaces["text"]
        max_len = 512
        dtype = DType.BF16
    else:
        from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
            GPT2Config, build_gpt2_step, random_gpt2_weights)
        from whisper_tensor_tpu_torch.model import Model

        cfg = GPT2Config(n_layer=2, n_head=2, n_embd=64, vocab_size=503,
                         n_positions=256)
        model = Model.new_from_onnx(build_gpt2_step(
            random_gpt2_weights(cfg), cfg, max_len=256, dtype=DType.F32,
            pos_per_row=True))
        max_len = 256
        dtype = DType.F32

    adapters = None
    adapter_names = [None]
    if args.adapters:
        if not args.model:
            raise SystemExit("--adapters needs --model")
        from whisper_tensor_tpu_torch.importers.lora import \
            load_peft_adapter_arrays

        adapters = {n: load_peft_adapter_arrays(d, spec["weight_map"])
                    for n, d in (kv.split("=", 1)
                                 for kv in args.adapters.split(","))}
        adapter_names += sorted(adapters)
    srv = ContinuousBatcher(model, max_len=max_len,
                            max_batch=args.clients, chunk=args.chunk,
                            cache_dtype=dtype,
                            prompt_buckets=(16, 32, 64),
                            prefill_chunk=args.prefill_chunk or None,
                            adapters=adapters,
                            prefix_ids=(np.arange(args.prefix) % 97
                                        if args.prefix else None),
                            device=device).start()
    print(f"device: {device}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, (int(rng.integers(4, 16)),))
               .astype(np.int64) for _ in range(args.clients)]
    t0 = time.time()
    try:
        futs = [srv.submit(p, args.tokens,
                           adapter=adapter_names[i % len(adapter_names)])
                for i, p in enumerate(prompts)]
        outs = []
        for i, f in enumerate(futs):
            out = f.result(timeout=600)
            outs.append(np.asarray(out))
            print(f"client {i}: prompt_len={len(prompts[i])} -> "
                  f"{len(out)} tokens {[int(t) for t in out[:8]]}…")
    finally:
        srv.stop()
    dt = time.time() - t0
    total = sum(len(o) for o in outs)
    print(f"\n{args.clients} concurrent clients, {total} tokens in "
          f"{dt:.2f}s -> {total / dt:.0f} tok/s aggregate")
    return {"device": str(device), "prompts": prompts, "tokens": outs,
            "tok_s": total / dt}


if __name__ == "__main__":
    main()
