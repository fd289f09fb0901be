"""LoRA fine-tune an RWKV-7 model on the PyTorch port through the milli
training artifact with true BPTT across the recurrent state — the reference's
examples/rwkv_lora_train.rs, INCLUDING the part it documents as broken
(rwkv_lora_train.rs:11-27: "mixed BF16/F32 dtype mismatches break the
backward pass"): here the step graph runs bf16 activations over f32
recurrent state and the backward is generated with explicit dtypes by
construction.

Shape of the job (reference parity):
  * build the RWKV-7 step graph from raw weights (importers recipe)
  * inject low-rank A·B adapters on the attention/FFN projections by
    milli graph surgery (milli.transforms.inject_lora)
  * append a cross-entropy loss and generate the symbolic backward
    with BackwardGenOptions.external_gradients — each step's state
    OUTPUTS receive the gradient flowing back from the next step
    (BPTT seeding, reference BackwardGenOptions mod.rs:207-243)
  * train ONLY the adapters: python loop = forward sweep storing
    states, backward sweep threading state gradients, SGD on adapters

The port's counterpart of examples/rwkv_lora_train.py: the same flags,
sizes and output, on the card unless --cpu asks for the CPU. Where the
JAX example compiles each program with compile_milli (XLA), the port
runs it through compiler.build_program (the graph executor).

Run: python examples/torch_port/rwkv_lora_train.py [--steps 30] [--smoke]
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
    ap.add_argument("--steps", type=int, default=30,
                    help="optimizer steps (epochs over the toy sequence)")
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = 6

    from whisper_tensor_tpu_torch.compiler import (CompilationSubject,
                                                   build_program)
    from whisper_tensor_tpu_torch.device import resolve_device
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.rwkv7 import (
        Rwkv7Config, build_rwkv7_step, random_rwkv7_weights)
    from whisper_tensor_tpu_torch.milli.autodiff import (BackwardGenOptions,
                                                         generate_backward)
    from whisper_tensor_tpu_torch.milli.losses import cross_entropy_loss
    from whisper_tensor_tpu_torch.milli.transforms import inject_lora
    from whisper_tensor_tpu_torch.model import Model

    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")
    cfg = Rwkv7Config(n_layer=2, n_embd=64, n_head=2, vocab_size=96,
                      lora_w=16, lora_a=16, lora_v=16, lora_g=32)
    sd = random_rwkv7_weights(cfg, seed=0)
    model = Model.new_from_onnx(
        build_rwkv7_step(lambda n: sd[n], cfg, dtype=DType.BF16),
        name="rwkv7-tiny")
    milli, weight_inputs = model.graph.to_milli(bake_small_constants=False)

    # adapter targets: the per-block attention + FFN projections
    # (reference adapts att/ffn linears); weights are the "_T"
    # matmul-RHS inputs the recipe emits
    targets = [n for n in weight_inputs
               if n.endswith("_weight_T")
               and any(k in n for k in ("att_receptance", "att_key",
                                        "att_value", "att_output",
                                        "ffn_key", "ffn_value"))]
    if not targets:
        raise SystemExit("no adapter-eligible weights found")
    store = model.graph.store

    def getter(name):
        return store.get_numeric(name).numpy()

    adapters = inject_lora(milli, targets, rank=args.rank,
                           weight_getter=getter, seed=1)

    # loss + symbolic BPTT backward
    target_t = milli.add_input("target")
    loss_tid = cross_entropy_loss(milli, milli.outputs["logits"], target_t)
    milli.mark_output("loss", loss_tid)
    state_in = {n: t for n, t in milli.inputs.items()
                if n.startswith(("tmix_x_", "vk_state_", "cmix_x_"))}

    B = 2
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab_size, (args.seq + 1,)).astype(np.int64)
    # .copy(): the frozen-base check at the end compares against these
    # snapshots, so they must not alias the store's arrays
    weights = {n: getter(n).copy() for n in weight_inputs
               if n in milli.inputs}
    H, D = cfg.n_head, cfg.n_embd // cfg.n_head

    def zero_states():
        st = {}
        for n in state_in:
            if n.startswith("vk_state_"):
                st[n] = np.zeros((B, H, D, D), np.float32)
            else:
                st[n] = np.zeros((B, cfg.n_embd),
                                 DType.BF16.to_numpy())
        return st

    # several backward rules (LayerNorm span, reduce axes) need
    # resolved shapes: infer with the concrete training-batch infos
    from whisper_tensor_tpu_torch.tensor_info import TensorInfo

    milli.infer_all({
        "token": TensorInfo.numeric(np.zeros(B, np.int64)),
        "target": TensorInfo.numeric(np.zeros(B, np.int64)),
        **{n: TensorInfo.numeric(v) for n, v in zero_states().items()},
        **{n: TensorInfo.numeric(v) for n, v in weights.items()},
        **{n: TensorInfo.numeric(v) for n, v in adapters.items()}})

    # snapshot a FORWARD-ONLY program for the state-recording sweep
    # (the combined step also computes every gradient; running it for
    # the forward pass would pay the backward twice per BPTT step)
    from whisper_tensor_tpu_torch.milli.serde import (graph_from_json,
                                                      graph_to_json)

    fwd = graph_from_json(graph_to_json(milli))

    ext = {milli.outputs[n]: f"g::{n}" for n in milli.outputs
           if n.startswith("new_")}
    wrt = {**{n: milli.inputs[n] for n in adapters}, **state_in}
    grads = generate_backward(milli, loss_tid, wrt,
                              BackwardGenOptions(external_gradients=ext))
    for n, gt in grads.items():
        milli.mark_output(f"grad::{n}", gt)

    example = {"token": np.zeros(B, np.int64), "target": np.zeros(B, np.int64),
               **zero_states(), **weights, **adapters,
               **{f"g::new_{n}": np.zeros_like(v)
                  for n, v in zero_states().items()}}
    step = build_program(CompilationSubject(milli=milli), device).run
    fwd_example = {k: v for k, v in example.items()
                   if not k.startswith("g::")}
    step_fwd = build_program(CompilationSubject(milli=fwd), device).run

    t0 = time.time()
    losses = []
    for it in range(args.steps):
        # forward sweep: record each step's input states
        states = zero_states()
        trail = []
        for t in range(args.seq):
            trail.append(states)
            out = step_fwd({**fwd_example, **states, **adapters,
                            "token": np.full(B, seq[t]),
                            "target": np.full(B, seq[t + 1])})
            states = {n: np.asarray(out[f"new_{n}"]) for n in states}
        # backward sweep: thread state grads from the future
        g_state = {f"g::new_{n}": np.zeros_like(v)
                   for n, v in zero_states().items()}
        g_ad = {n: np.zeros(v.shape, np.float32)
                for n, v in adapters.items()}
        total_loss = 0.0
        for t in reversed(range(args.seq)):
            out = step({**example, **trail[t], **adapters, **g_state,
                        "token": np.full(B, seq[t]),
                        "target": np.full(B, seq[t + 1])})
            total_loss += float(np.asarray(out["loss"]))
            for n in adapters:
                g_ad[n] += np.asarray(out[f"grad::{n}"], np.float32)
            g_state = {f"g::new_{n}": np.asarray(out[f"grad::{n}"])
                       for n in zero_states()}
        for n in adapters:          # SGD on the adapters ONLY
            adapters[n] = (adapters[n].astype(np.float32)
                           - args.lr * g_ad[n]).astype(adapters[n].dtype)
        losses.append(total_loss / args.seq)
        print(f"step {it:3d}  loss/tok {losses[-1]:.4f}")
        if it == 0:
            first = total_loss
    print(f"# {args.steps} BPTT steps in {time.time() - t0:.1f}s; "
          f"loss/tok {first / args.seq:.4f} -> {total_loss / args.seq:.4f}")
    if not total_loss < first:
        raise SystemExit("LoRA BPTT training did not reduce the loss")
    # frozen base: the weights dict was never touched
    for n in list(weights)[:3]:
        np.testing.assert_array_equal(weights[n], getter(n))
    print("OK: adapters trained, base frozen, bf16 step + f32 state BPTT")
    return {"device": str(device), "losses": losses}


if __name__ == "__main__":
    main()
