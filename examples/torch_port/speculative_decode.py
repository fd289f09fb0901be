"""Speculative decoding demo on the PyTorch port: a small draft GPT-2
proposes token blocks that the target verifies in single forwards
(interfaces/speculative.py), and the greedy output is token-exact vs
plain decode.

The port's counterpart of examples/speculative_decode.py: the same
flags, sizes and output, on the card unless --cpu asks for the CPU.
Net-new beyond the reference (its scheduler emits one token per model
evaluation, crates/whisper-tensor-server/src/scheduler.rs); this is
the standard serving-latency lever for big targets with cheap drafts.

Run: python examples/torch_port/speculative_decode.py [--smoke] [--k 4]
     [--cpu]
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
    ap.add_argument("--k", type=int, default=4,
                    help="block length (k-1 draft proposals per round)")
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run for CI (8 tokens)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step, random_gpt2_weights)
    from whisper_tensor_tpu_torch.interfaces.speculative import \
        SpeculativeDecoder
    from whisper_tensor_tpu_torch.interfaces.text import \
        TextInferenceInterface
    from whisper_tensor_tpu_torch.model import Model

    device = resolve_device("cpu" if args.cpu else None)
    max_len = 128
    tcfg = GPT2Config(n_layer=2, n_head=2, n_embd=64, vocab_size=211,
                      n_positions=max_len)
    dcfg = GPT2Config(n_layer=1, n_head=2, n_embd=16, vocab_size=211,
                      n_positions=max_len)

    def iface(cfg, seed):
        m = Model.new_from_onnx(build_gpt2_step(
            random_gpt2_weights(cfg, seed=seed), cfg, max_len=max_len,
            dtype=DType.F32))
        return TextInferenceInterface(m, max_len=max_len,
                                      prompt_buckets=(16, 32), device=device)

    target, draft = iface(tcfg, 0), iface(dcfg, 1)
    # a SELF-draft accepts every proposal — the acceptance ceiling;
    # the tiny random draft shows the truthful bad-draft floor
    drafts = [("tiny-draft", draft), ("self-draft", iface(tcfg, 0))]
    prompt = np.asarray([5, 17, 3, 99, 42], np.int64)
    n = 8 if args.smoke else args.tokens
    print(f"device: {device}")

    ref = target.generate_tokens(prompt[None], n)[0]
    out = {"device": str(device), "plain": ref}
    for name, d in drafts:
        dec = SpeculativeDecoder(target, d, k=args.k)
        t0 = time.time()
        toks = dec.generate_tokens(prompt, n)[0]
        dt = time.time() - t0
        if not (toks == ref).all():
            raise SystemExit(f"{name}: {toks} is not plain greedy's {ref}")
        out[name] = toks
        print(f"{name}: {n} tokens in {dt:.2f}s, "
              f"token-exact vs plain greedy")
    print("ok")
    return out


if __name__ == "__main__":
    main()
