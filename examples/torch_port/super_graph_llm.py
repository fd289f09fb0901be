"""SuperGraph LLM decode demo on the PyTorch port: build the
serializable decode job, run it with observers streaming node timings and
progress, and cross-check against the text interface's decode loop.

The port's counterpart of examples/super_graph_llm.py: the same sizes
and output, on the card unless --cpu asks for the CPU.

Reference equivalent: examples/super_graph_test.rs.
Run: python examples/torch_port/super_graph_llm.py [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_step, random_gpt2_weights)
    from whisper_tensor_tpu_torch.interfaces.text import \
        TextInferenceInterface
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.super_graph import (ExecutionContext,
                                                      SuperObserver)
    from whisper_tensor_tpu_torch.super_graph.llm import build_llm_supergraph
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")

    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=64, vocab_size=300,
                     n_positions=64)
    model = Model.new_from_onnx(
        build_gpt2_step(random_gpt2_weights(cfg), cfg, max_len=64),
        name="demo-gpt2")

    sg = build_llm_supergraph("demo-gpt2", "bytes", n_layers=2, n_kv_heads=2,
                              max_len=64, head_dim=32, n_new=12)
    print("job graph:", sg)
    print("serialized bytes:", len(sg.dumps()))

    class Obs(SuperObserver):
        def on_node_executed(self, node, ms):
            print(f"  [{ms:7.2f} ms] {node.name}")

        def on_progress(self, node, f):
            print(f"  progress {f * 100:5.1f}%")

    ctx = ExecutionContext(models={"demo-gpt2": model}, observer=Obs(),
                           device=device)
    out = sg.run(ctx, {"text": "hello tpu"})
    print("tokens:", out["tokens"].tolist())
    print("text  :", repr(out["text"]))

    iface = TextInferenceInterface(model, max_len=64, prompt_buckets=(16, 32),
                                   device=device)
    tok = ByteTokenizer()
    prompt = np.asarray(tok.encode("hello tpu"), dtype=np.int64)[None]
    fast = iface.generate_tokens(prompt, 12)[0]
    if not (np.asarray(out["tokens"]) == fast).all():
        raise SystemExit("super-graph and interface paths diverge")
    print("the text interface's decode produced identical tokens ✓")
    return {"device": str(device), "tokens": np.asarray(out["tokens"]),
            "text": out["text"]}


if __name__ == "__main__":
    main()
