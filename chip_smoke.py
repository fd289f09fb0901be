#!/usr/bin/env python3
"""Smoke run of the PyTorch port (whisper_tensor_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers N] [--plant-fault] [--kernels-only]
                          [--generic-only] [--plans]

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU
and the CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX
package, and it fails (non-zero exit, no result line) without a GPU or
outside a checkout.

Phases:
  0. the card: name and power limit (nvidia-smi), compute capability,
     whether ml_dtypes imports;
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and time it;
  2. each kernel against its plain PyTorch version on the card, at the
     served paths' shapes: max error against a stated tolerance (zero
     for the cache write, a copy, over the whole caches), the median time
     of kernel and plain version (CUDA events; for the cache write,
     which is shorter than its launch, also the device time alone and
     the host's microseconds a call), the time of one PyTorch call
     computing the same function where there is one
     (scaled_dot_product_attention for the attention kernels, scatter_
     a cache for the cache write; timed only), and the kernel's bound:
     the larger of the bytes it must move
     over 3.35 TB/s and its operations over 989 TFLOP/s. flash_attention
     runs eleven cases: a 2048-token direct prefill, an admission group,
     a 128-row piece, an 8192-token prompt, GPT-2's width and piece, the
     causal and additive modes, ragged edges, and the speculative verify
     block (4 rows at a scalar start, 5 rows at 4 ragged starts); packed_matmul runs the
     layouts of Q4_0, Q4_K, Q6_K (int8 values, G 16), Q8_0 (no offsets)
     and a 128-row group at the fused q/k/v, o, gate/up, down and
     lm_head shapes, M 1, 16, 128, 512 and 2048 for Q4_0 and M 1 and
     512 for the others, with torch's _weight_int4pack_mm as the 4-bit
     yardstick, then f32 x at M 512 and 2048 and both of its paths at
     M 1 to 16; at decode shapes it also prints the device time alone
     and the host's microseconds a call. The cache write runs as one
     cache (ragged_kv_write) and as the pair that the served paths run
     (kv_write_pair: a layer's K and V in one launch) at the decode
     step of 16 slots, a 128-row piece, GPT-2's 64 slots and the direct
     path's scalar start. Head dim 256 (the Gemma family): flash's
     additive mode under the Gemma recipes' masks (Gemma-3 1B's 4/1
     heads global and in a 512-key window, Gemma 2B's 8/1, at 2,048
     rows and a 128-row prompt) with both of the kernel's tile shapes
     at that head dim timed, decode_attention at 8/4 heads (B 1 and 16)
     and the cache-write pair; f16 (an f16 model over the bf16 cache):
     decode_attention's f16 query and the cache write's f16 mode, each
     timed against a cast at the kernel's edge;
  3. the direct path: a Llama-3-8B-width checkpoint (hidden 4096, 32/8
     heads of 128, FFN 14336, vocab 128256, rope theta 5e5; depth cut to
     --layers, random weights from a seed) is written to disk, loaded by
     the port's Server through its loader (bf16, int8 weights, max_len
     2048), and served by its OpenAI HTTP API; three
     requests go through it, and the kernels' launch counters must rise;
     in this phase and in phases 4, 6 and 7 every run of the step graph
     must write each layer's K and V caches in one kv_write_pair launch.
     Then the greedy decode again: each decode_attention call against
     its plain version on the same inputs, the decode's logits with the
     plain version swapped in, and against a teacher-forced prefill;
  4. the batched path: the same checkpoint loaded with ragged_decode
     (16 slots, chunks of 16 up to 64, prefill pieces of 128, an
     automatic prefix pool of 8) and served over HTTP to 32 client
     threads in three waves (28 completions and 4 streamed chats,
     prompts of 5 to 400 tokens, eight sharing a 64-token prefix, 24
     greedy and 8 sampled). Every request must answer in full, all three
     kernels' counters must rise, (d) each greedy answer must stand a
     teacher-forced prefill over prompt and answer, and (e) the greedy
     requests again on a fresh batcher must give the same tokens with
     the plain kv_write_pair in place of the kernel.
     --plant-fault makes every decode-step cache write of the served
     traffic land one position early, which (d) must catch;
  5. long prompts, on the same checkpoint, run at the end of phases 3
     and 4 on their models: a 1900-token prompt served by the direct
     path (bucket 2048, 32 tokens), then its decode again with each
     flash_attention call shadowed by the plain version, and with the
     plain version in place (logits within phase 3's bound), and its time
     to first token with either; four concurrent prompts of 500 to 1900
     tokens served by the batcher in 128-token pieces, every
     flash_attention call shadowed, and each answer held to a
     teacher-forced prefill. The flash_attention counter must rise in
     both;
  6. packed weights. (6a) The checkpoint loaded with quantize="q4_0"
     (host-quantized into Q4_0 blocks, kept packed on the card) answers
     phase 3's three requests over HTTP; packed_matmul's counter must
     rise and int8_matmul's stay 0, one forward must launch it once per
     matmul weight; then phase 3's checks (a)-(c) with every
     packed_matmul call shadowed by its plain version, and the rates
     against phase 3's int8. (6b) The same weights written by the port's
     write_gguf as an arch-llama GGUF, Q/K rows permuted the way
     llama.cpp's converter permutes them (Q4_K, Q6_K for ffn_down and
     output), loaded by GgufLoader with ragged_decode (16 slots, pieces
     of 128) and served 16 concurrent requests (prompts of 5 to 400
     tokens, 12 greedy, 4 sampled); the counters of packed_matmul and
     the three attention and cache kernels must rise, (d) each greedy
     answer stand a teacher-forced prefill, and (f) the longest greedy
     answer stand one over the same file loaded dense
     (packed_weights=False);
  7. GPT-2 124M's widths (12 layers, 12 heads of 64, vocab 50,257) in
     the reference's serving arm, dense bf16 then int8: 64 concurrent
     greedy requests through the batcher, (d) for each;
  8. the direct path's other routes, at the end of phase 3 on its int8
     model: (g) a json_schema and a regex completion must finish inside
     their languages, each token admitted by the DFA table from the
     state before it; (h) a chat with `tools` must answer one tool call
     that parses; (i) /v1/embeddings of three inputs, last and mean
     pooling, unit vectors, the hidden states within phase 3's bound of
     a prefill with every plain version in place (the C12 case: an int8
     lm_head); (j) best_of=4 must answer the candidate sequence_scores
     ranks first; (k) num_beams=4 through the generate_text message:
     the best beam's teacher-forced score must stand the search's. The
     int8, decode and cache-write counters must rise in each (flash in
     the place of decode in (i), a prefill). It prints the DFA tables'
     MB, constrained against unconstrained tok/s, beam ms a step and the
     cache reorder's;
  9. the checkpoint written as GPTQ (4-bit, groups of 128, the classic
     zeros-1 format, desc_act off, lm_head dense), loaded by the
     TransformersLoader with ragged_decode (16 slots): one PackedMatMul
     node per quantized Linear (q/k/v and gate/up fused), 16 concurrent
     completions (12 greedy, 4 sampled) with a constrained and an
     embeddings request among them; packed_matmul's launches must equal
     the lowering's PackedMatMul calls and int8_matmul's stay 0, (d) for
     each greedy answer, and one prompt's logits must stand those of
     the checkpoint's dequantized dense weights;
 10. LoRA adapters, speculative decoding and the profiler.
     (m) speculative decoding, at the end of phase 3 on its int8 model:
     the target drafting for itself and a truncated draft (layer 0 of
     the same weights with the embedding and the head, loaded from the
     same file), greedy at k 4 and 5 over 64 tokens, sampled at
     temperature 0.8 (repeatable), once over the WebSocket's
     generate_text with draft_model_id, and timed against plain decode;
     at the end of phase 4, a batch of 4 self-drafted on its pos_per_row
     model. Greedy tokens must equal the target's own greedy decode up
     to a near tie and stand a teacher-forced prefill (spec_agreement:
     the verify block and a decode step round in bf16 in different
     places); flash_attention must launch once a layer for each prefill
     and verify round, and int8_matmul once for each QuantMatMul call.
     (l) after phase 9: the checkpoint loaded dense bf16 with
     ragged_decode and serve_adapters a and b (PEFT dirs the smoke
     writes: r 16, alpha 32, all seven projections), 24 concurrent
     completions (8 base, 8 `"adapter": "a"`, 8 `"model": "<name>:b"`):
     answers in full, one cache write a layer a step through both
     graphs, (d) under each answer's adapter; a decode step of 16 rows
     through the pre-surgery and the adapted graph timed in turns;
     load_adapter c over the WebSocket with requests in flight, 8
     completions under c, /v1/models, the card's GB before, during and
     after the swap; one prompt's logits under a against the checkpoint
     loaded with lora=<a> (merged at load) on the direct path. (n)
     start_profiler, one served completion, stop_profiler over the
     WebSocket: the Chrome trace must hold the port's kernels by name.
     Last, `cli generate --draft-model` on phase 7's GPT-2 checkpoint
     must print the speculative decoder's text.
 11. the generic ONNX path (Model.eval and EvalBackend on the default
     device, the card): (a) every case of the CPU tests' conformance
     corpus (tests/torch_corpus.npz: 2,160 cases outside the op
     families not ported yet) at the case's own tolerances (a case that
     needs another on the card is listed in CARD_TOLERANCES with its
     measured error and reason); the cases passed by path (one graph on
     the card, control flow on the host, the host by design) and the
     worst float error as a share of its tolerance; any failure fails
     the smoke. (b) ONNX opset-23 Attention in bf16 through Model.eval
     at Llama-3-8B's 32/8 heads of 128 (S 2,048) and GPT-2's 12 heads of
     64 (S 1,024), causal and with an additive (1, 1, S, S) mask: one
     flash_attention launch each, within flash_agreement_bound of its
     plain version, host-timed beside the plain path. (c) the step
     graphs at full width through Model.eval: phase 3's checkpoint with
     a per-row pos, a 1,900-token prefill (flash, pos-bound) and 8
     greedy decode steps (decode_attention, one ragged_kv_write a cache
     a run), launches equal to the lowering's calls, logits within phase
     3's bound of the text interface's teacher-forced prefill; GPT-2
     124M's widths with a scalar pos, a 512-token prefill whose additive
     mask takes flash's additive mode, logits against the lowering's
     plain path. `--generic-only` writes the checkpoint and runs phase
     11 alone.
 12. Gemma-3 1B (q4_0; 6 layers, so its global layer is in), Gemma-2 2B
     (int8; then its weights as a Q8_0 GGUF of arch gemma2, dequantized
     on the host by the loader), Gemma 2B and Phi-3-mini, each at its
     published widths (FAMILIES) on seeded weights, bf16, max_len 2048,
     loaded by the port's Server and served over HTTP (phase 3's three
     requests): every run of the step graph writes each layer's caches
     in one kv_write_pair launch; flash_attention launches once for each
     of the lowering's Sq > 1 additive Attention calls on Gemma and
     Gemma-3 (head dim 256), and never on Gemma-2 (its softcap) and
     Phi-3 (head dim 96), whose attention runs the plain path;
     decode_attention never (these recipes' decode steps carry an
     additive mask, Phi-3's head dim is 96); int8 and packed launches
     equal the lowering's QuantMatMul and PackedMatMul calls; the greedy
     answer stands a teacher-forced prefill (phase 3's bound).
Each step prints its seconds, the peak host RSS and its peak bytes on
the card. The last three lines are the kernels' JSON summary line, the
card, and the result line.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import http.client
import json
import math
import re
import resource
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20240418
# Llama-3-8B's published widths (bench.py:360-368)
WIDTHS = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=8,
              intermediate_size=14336, vocab_size=128256, rope_theta=500000.0,
              rms_norm_eps=1e-5, max_position_embeddings=8192)
MAX_LEN = 2048
BYTE_VOCAB = 259          # ids the byte tokenizer decodes to text
# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def foreign_modules() -> list:
    """Imported modules of jax or of the JAX package (whisper_tensor_tpu,
    by exact name or the `whisper_tensor_tpu.` prefix, so the port's own
    whisper_tensor_tpu_torch does not count)."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "whisper_tensor_tpu")
                  or m.startswith(("jax.", "whisper_tensor_tpu.")))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
def time_ms(torch, fn, argsets, reps: int = 7, inner: int = 5) -> float:
    """Median ms per call over `reps` runs of `inner` calls, cycling
    through argsets (copies larger than L2 together, so every call reads
    its operands from device memory as the main path does)."""
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times, i = [], 0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(*argsets[i % len(argsets)])
            i += 1
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_time_ms(torch, fn, argsets, reps: int = 7, inner: int = 20) -> float:
    """Median device ms per call, for kernels shorter than their launch:
    each run of `inner` calls is enqueued behind a spin kernel
    (torch.cuda._sleep, ~25 ms) that holds the stream while the host
    enqueues them, so the events time the calls back to back on the
    device, not the host's launch rate."""
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times, i = [], 0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            fn(*argsets[i % len(argsets)])
            i += 1
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_us(torch, fn, argsets, reps: int = 5, inner: int = 100) -> float:
    """Median host microseconds a call: the wall time to enqueue `inner`
    calls behind a spin kernel (torch.cuda._sleep), which keeps the
    device busy so that no call waits on it; the wrapper's own cost and
    its launches, what holds a host-bound decode step back."""
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times, i = [], 0
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*argsets[i % len(argsets)])
            i += 1
        times.append((time.perf_counter() - t0) / inner * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by): the least time for the work, the larger of
    its bytes over the memory rate and its operations over the bf16
    tensor-core rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))   # > 3x the 50 MB L2


def worst_share(got, ref, magnitude, bound):
    """(max |got - ref|, max of |got - ref| / bound, element by element)."""
    err = (got.float() - ref.float()).abs()
    lim = bound(ref, magnitude).clamp_min(1e-30)
    return err.max().item(), (err / lim).max().item()


def phase2(torch, results):
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention, decode_attention_plain, decode_splits)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # Tolerance, element by element (agreement_bound): kernel and plain
    # version compute in f32 from the same bf16/int8 inputs and round
    # once to bf16, so they may land one bf16 ulp apart (2^-7 |plain|),
    # plus f32 summation-order noise (2^-16 of the sum of the terms'
    # magnitudes, the plain version on absolute inputs).
    say("phase 2: kernels against their plain versions (tolerance per "
        "element: 2^-7 |plain| + 2^-16 * plain on |inputs|)")

    worst, timing, shapes = 0.0, None, {}
    L = MAX_LEN
    # (Hq, Hkv, D, L, B, positions). Llama-3-8B's heads: B=1 all keys
    # live, the smoke's direct decode (pos near 100), a () int32 pos,
    # phase 4's ragged slots, 16 full rows; GPT-2's 12 heads of 64 (phase
    # 7's model) over its 1,024 positions at B 1, 16 and 64; head dim 256
    # at Gemma-2 2B's 8/4 heads, B 1 and 16, and an f16 query (an f16
    # model over the servers' bf16 cache)
    bf16, f16 = torch.bfloat16, torch.float16
    cases = [(32, 8, 128, L, 1, [L - 1], bf16), (32, 8, 128, L, 1, [100], bf16),
             (32, 8, 128, L, 1, [1234], bf16),
             (32, 8, 128, L, 8, [0, 1, 17, 511, 1000, L - 2, L - 1, 5000],
              bf16),
             (32, 8, 128, L, 16, [L - 1] * 16, bf16)] + [
        (12, 12, 64, 1024, B, [1023] * B, bf16) for B in (1, 16, 64)] + [
        (8, 4, 256, L, 1, [L - 1], bf16), (8, 4, 256, L, 16, [L - 1] * 16, bf16),
        (8, 4, 256, L, 1, [L - 1], f16)]
    for Hq, Hkv, D, L, B, pos_list, qdt in cases:
        scale = 1.0 / math.sqrt(D)
        kv_bytes = 2 * B * Hkv * L * D * 2
        sets = []
        for _ in range(copies_for(kv_bytes)):
            q = torch.randn(B, Hq, 1, D, generator=gen, device=dev).to(qdt)
            k = torch.randn(B, Hkv, L, D, generator=gen, device=dev).bfloat16()
            v = torch.randn(B, Hkv, L, D, generator=gen, device=dev).bfloat16()
            pos = torch.tensor(pos_list, dtype=torch.int64, device=dev)
            if pos_list == [1234]:
                pos = pos.reshape(()).to(torch.int32)   # () int32 form
            sets.append((q, k, v, pos, scale))
        q, k, v, pos, _ = sets[0]
        got = decode_attention(*sets[0])
        ref = decode_attention_plain(*sets[0])
        err, share = worst_share(got, ref, decode_attention_plain(
            q.float(), k, v.abs(), pos, scale), agreement_bound)
        ms = time_ms(torch, decode_attention, sets)
        plain_ms = time_ms(torch, decode_attention_plain, sets)
        # device time alone (calls queued behind a spin kernel): at these
        # sizes the times above are the host's launch rate
        dev_ms = device_time_ms(torch, decode_attention, sets)
        h_us = host_us(torch, decode_attention, sets)
        # the library call: SDPA over each row's live keys (a boolean
        # mask), GQA by head index
        live = (torch.arange(L, device=dev)
                <= pos.reshape(-1).expand(B)[:, None].clamp(0, L - 1))
        # (an f16 query crosses to the cache's type: SDPA takes one type)
        lsets = [(q.to(k.dtype), k, v, live[:, None, None, :])
                 for q, k, v, _, _ in sets]
        calls = [(sdpa_gqa(torch, q, k, v, m, scale),)
                 for q, k, v, m in lsets]
        lib_ms = time_ms(torch, lambda f: f(), calls)
        lib_dev = device_time_ms(torch, lambda f: f(), calls)
        n_live = int(live.sum())
        bms, bby = bound(2 * B * Hq * D * q.element_size()
                         + 2 * Hkv * n_live * D * 2, 4 * Hq * D * n_live)
        splits, chunk = decode_splits(B, Hq, Hkv, L, D,
                                      torch.cuda.current_device())
        label = (f"GPT-2 D=64 B={B} L={L}" if D == 64 else
                 f"D=256 B={B} L={L}" + (" f16 q" if qdt == f16 else "")
                 if D == 256 else
                 f"B={B} pos={pos_list[0] if B == 1 else 'ragged' if B == 8 else 'L-1'}")
        shapes[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "device_ms": dev_ms,
                         "library_device_ms": lib_dev, "host_us": h_us}
        if qdt == f16:
            # ROADMAP C17's choice: the kernel's f16 query against a cast
            # at the kernel's edge (q to f32, the f32-q kernel, the output
            # back to f16), the same numbers
            def edge(q, k, v, pos, scale):
                return decode_attention(q.float(), k, v, pos, scale).half()

            if not torch.equal(edge(*sets[0]), got):
                fail("decode_attention: the f16 query's output is not the "
                     "f32 query's rounded to f16")
            shapes[label].update(
                edge_cast_ms=time_ms(torch, edge, sets),
                edge_cast_device_ms=device_time_ms(torch, edge, sets))
            say(f"  decode_attention {label}: the kernel's f16 query "
                f"{ms:.4f} ms (device {dev_ms:.4f}) against a cast at its "
                f"edge {shapes[label]['edge_cast_ms']:.4f} ms (device "
                f"{shapes[label]['edge_cast_device_ms']:.4f}), equal outputs")
        say(f"  decode_attention B={B} Hq/Hkv={Hq}/{Hkv} D={D} L={L} "
            f"q {str(qdt)[6:]} pos={pos_list} ({splits} splits of {chunk} "
            f"keys): "
            f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; kernel "
            f"{ms:.4f} ms ({bms / ms:.1%} of the bound), plain "
            f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (kernel/SDPA "
            f"{ms / lib_ms:.2f}), bound {bms:.4f} ms ({bby}); device time "
            f"alone: kernel {dev_ms:.4f} ms ({bms / dev_ms:.1%} of the "
            f"bound), SDPA {lib_dev:.4f} ms; host {h_us:.1f} us a call")
        if not share <= 1.0:
            fail(f"decode_attention disagrees with its plain version "
                 f"(B={B}, pos={pos_list}): err/tol {share}")
        worst = max(worst, err)
        if timing is None:
            timing = (ms, plain_ms, f"B=1 L={L} all keys live", bms, bby,
                      lib_ms)
    results.append({
        "name": "decode_attention", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/decode_attention.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/decode_attention.py:179",
        "launches": None, "max_abs_err": worst, "ms": timing[0],
        "plain_ms": timing[1], "bound_ms": timing[3], "bound_by": timing[4],
        "library_ms": timing[5], "shape": timing[2], "shapes": shapes})

    phase2_int8(torch, results)


def phase2_int8(torch, results):
    """int8_matmul against its plain version: M 1, 16, 128, 512 and 2048
    on the five Llama-3-8B shapes, GPT-2's tied head (N 50,257, odd) at M
    1 and 64, f32 x at M 512 and 2048 on gate/up and down; each with its
    plan, kernel and device time, the plain version's, the library call's
    (_weight_int8pack_mm) and, as information, a bf16 torch.matmul of x
    against the weight already converted to bf16 (the tensor-core product
    without the conversion; the port never calls it). Then both paths at
    M 1 to 16 on down and gate/up (the crossover of int8_plan)."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul, int8_matmul_plain, int8_plan)

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    say("  int8_matmul (tolerance per element: agreement_bound, plain "
        "version on |x| and |W|; library: _weight_int8pack_mm, bf16 "
        "scales; yardstick: bf16 x @ W already in bf16)")
    worst, timing, shapes, lib_err = 0.0, None, {}, None
    # (K, N, rows, x type): Llama-3-8B's five shapes, GPT-2's head, f32 x
    cases = [(K, N, (1, 16, 128, 512, 2048), torch.bfloat16)
             for K, N in MATMUL_SHAPES] + [
        (768, 50257, (1, 64), torch.bfloat16),
        (4096, 28672, (512, 2048), torch.float32),
        (14336, 4096, (512, 2048), torch.float32)]
    for K, N, rows, xdt in cases:
        wsets = []
        for _ in range(copies_for(K * N)):
            w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                              dtype=torch.int8)
            s = torch.rand(N, generator=gen, device=dev) * 0.01 + 1e-3
            wsets.append((w, s))
        wbf = wsets[0][0].bfloat16()            # the yardstick's weight
        for M in rows:
            sets = [(torch.randn(M, K, generator=gen, device=dev).to(xdt),
                     w, s) for w, s in wsets]
            x, w, s = sets[0]
            got = int8_matmul(*sets[0])
            ref = int8_matmul_plain(*sets[0])
            err, share = worst_share(got, ref, int8_matmul_plain(
                x.float().abs(), w.abs(), s), agreement_bound)
            del got, ref
            big = M >= 512
            slow = dict(reps=3, inner=1) if big else {}
            ms = time_ms(torch, int8_matmul, sets)
            dev_ms = device_time_ms(torch, int8_matmul, sets,
                                    **(dict(reps=3, inner=5) if big else {}))
            plain_ms = time_ms(torch, int8_matmul_plain, sets[:2], **slow)
            lib_ms = yard_ms = None
            if xdt == torch.bfloat16:
                try:
                    calls = [(int8pack_call(torch, x, w, s),)
                             for x, w, s in sets[:2]]
                    lib_ms = time_ms(torch, lambda f: f(), calls, **slow)
                    del calls
                except (RuntimeError, NotImplementedError) as e:
                    lib_err = f"{type(e).__name__}: {str(e)[:200]}"
                yard_ms = time_ms(torch, lambda x: torch.matmul(x, wbf),
                                  [(x,) for x, _, _ in sets[:2]], **slow)
            xb = x.element_size()
            bms, bby = bound(M * K * xb + K * N + N * 4 + M * N * xb,
                             2 * M * K * N)
            plan = int8_plan(M, K, N, xdt == torch.bfloat16, card)
            lib = "none" if lib_ms is None else (
                f"{lib_ms:.4f} ms (kernel/library {ms / lib_ms:.2f})")
            yard = "" if yard_ms is None else (
                f", bf16 yardstick {yard_ms:.4f} ms")
            tname = "bf16" if xdt == torch.bfloat16 else "f32"
            say(f"  int8_matmul {tname} x M={M} K={K} N={N} ({plan.path}, "
                f"{plan.bm} rows a block, {plan.splits} splits): "
                f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; kernel "
                f"{ms:.4f} ms, device {dev_ms:.4f} ms ({bms / dev_ms:.1%} of "
                f"the bound), plain {plain_ms:.4f} ms (kernel/plain "
                f"{ms / plain_ms:.2f}), _weight_int8pack_mm {lib}{yard}, "
                f"bound {bms:.4f} ms ({bby})")
            if not share <= 1.0:
                fail(f"int8_matmul disagrees with its plain version "
                     f"({tname} x, M={M}, K={K}, N={N}): err/tol {share}")
            worst = max(worst, err)
            shapes[f"{tname} M={M} K={K} N={N}"] = {
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "yardstick_ms": yard_ms,
                "bound_ms": bms, "path": plan.path, "splits": plan.splits}
            if (M, K, N, xdt) == (1, 4096, 28672, torch.bfloat16):
                timing = (ms, plain_ms, "M=1 K=4096 N=28672 (gate/up)",
                          bms, bby, lib_ms)
            del sets
        del wsets, wbf
        torch.cuda.empty_cache()
    if lib_err:
        say(f"  _weight_int8pack_mm raised on the card: {lib_err}")

    # the crossover: both paths at the same rows, down and gate/up
    say("  int8_matmul paths at decode rows: device ms of the CUDA-core "
        "path / the tensor-core path, each with int8_plan's splits")
    for K, N in ((14336, 4096), (4096, 28672)):
        wsets = [(torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                dtype=torch.int8),
                  torch.rand(N, generator=gen, device=dev) * 0.01 + 1e-3)
                 for _ in range(copies_for(K * N))]
        line = []
        for M in (1, 2, 4, 5, 8, 16):
            sets = [(torch.randn(M, K, generator=gen, device=dev).bfloat16(),
                     w, s) for w, s in wsets]
            t = []
            for path in ("cores", "tensor"):
                plan = qm._path_plan(path, M, K, N, True, card)

                def run(x, w, s, plan=plan):
                    return qm._launch(x, w, s, plan)

                _, share = worst_share(run(*sets[0]), int8_matmul_plain(
                    *sets[0]), int8_matmul_plain(sets[0][0].float().abs(),
                                                 sets[0][1].abs(),
                                                 sets[0][2]),
                    agreement_bound)
                if not share <= 1.0:
                    fail(f"int8_matmul's {path} path disagrees with its "
                         f"plain version (M={M}, K={K}, N={N})")
                t.append(device_time_ms(torch, run, sets))
            line.append(f"M={M} {t[0]:.4f}/{t[1]:.4f}")
            del sets
        say(f"    K={K} N={N}: " + ", ".join(line))
        del wsets
        torch.cuda.empty_cache()
    results.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/quant_matmul.py:68",
        "launches": None, "max_abs_err": worst, "ms": timing[0],
        "plain_ms": timing[1], "bound_ms": timing[3], "bound_by": timing[4],
        "library_ms": timing[5], "library_error": lib_err,
        "shape": timing[2], "shapes": shapes})


def int8pack_call(torch, x, w, s):
    """One torch.ops.aten._weight_int8pack_mm call computing x @ W *
    scales for an int8 (K, N) weight (the yardstick, timed only; the port
    never calls it): its weight is (N, K) int8, its scales bf16 (N,).
    Returns a ready call, or raises where the card's torch has no such
    kernel for these inputs."""
    wt = w.t().contiguous()
    sb = s.bfloat16()
    mm = torch.ops.aten._weight_int8pack_mm
    mm(x, wt, sb)
    return lambda: mm(x, wt, sb)


def phase2_kv_write(torch, results):
    """The cache-write kernel against its plain version: a copy, so
    bit-exact over the whole caches (the written slabs and every
    untouched element), written in place. First the single-cache call
    (ragged_kv_write), then the pair that writes a layer's K and V caches
    in one launch (kv_write_pair, what the served paths run), each timed
    against its bound and the library call (one scatter_ a cache), with
    the host's microseconds a call."""
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        clamped_start, kv_write_pair, kv_write_pair_plain, kv_write_plan,
        ragged_kv_write, ragged_kv_write_plain)

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    decode_pos = [0, 1, 511, 2046, 2047, 5000, -1] + list(range(100, 1000, 100))

    def scatter_index(p, B, H, L, S, D):
        """The library call's index (B, H, S, D) along the cache axis."""
        return (clamped_start(p.reshape(-1), L, S)[:, None, None, None]
                + torch.arange(S, device=dev)[None, None, :, None]
                ).expand(B, H, S, D).contiguous()

    def same(got, want):
        view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        return torch.equal(got.view(view), want.view(view))

    # (label, B, H, L, D, S, cache type, update type, positions): a decode
    # step of the 16 slots (5000 clamps to L - 1, -1 counts from the end),
    # a chunked-prefill piece of 4 rows (1950 + 128 and 3000 clamp to
    # L - 128), an f32 update into the bf16 cache
    L = MAX_LEN
    cases = (("decode", 16, 8, L, 128, 1, torch.bfloat16, torch.bfloat16,
              decode_pos),
             ("admission piece", 4, 8, L, 128, 128, torch.bfloat16,
              torch.bfloat16, [0, 128, 1950, 3000]),
             ("f32 update", 16, 8, L, 128, 1, torch.bfloat16, torch.float32,
              decode_pos))
    say("  ragged_kv_write: bit-exact against the plain version over the "
        "whole cache, in place")
    timing = None
    for label, B, H, L, D, S, cdt, udt, pos_list in cases:
        sets = []
        for _ in range(copies_for(B * H * L * D * 2)):
            cache = torch.randn(B, H, L, D, generator=gen,
                                device=dev).to(cdt)
            upd = torch.randn(B, H, S, D, generator=gen, device=dev).to(udt)
            sets.append((cache, upd, torch.tensor(pos_list, device=dev)))
        cache, upd, pos = sets[0]
        want = ragged_kv_write_plain(cache.clone(), upd, pos)
        ptr = cache.data_ptr()
        got = ragged_kv_write(cache, upd, pos)
        torch.cuda.synchronize()
        exact = same(got, want)
        err = (got.float() - want.float()).abs().max().item()
        ms = time_ms(torch, ragged_kv_write, sets)
        plain_ms = time_ms(torch, ragged_kv_write_plain, sets)
        dev_ms = device_time_ms(torch, ragged_kv_write, sets)
        plain_dev_ms = device_time_ms(torch, ragged_kv_write_plain, sets)
        h_us = host_us(torch, ragged_kv_write, sets)
        # the library call: one scatter_ along the cache axis, its index
        # (B, H, S, D) and the update in the cache's type built first
        lsets = [(c, scatter_index(p, B, H, L, S, D), u.to(cdt))
                 for c, u, p in sets]

        def scatter(c, idx, u):
            return c.scatter_(2, idx, u)

        same_lib = same(scatter(cache.clone(), *lsets[0][1:]),
                        ragged_kv_write(cache.clone(), upd, pos))
        lib_ms = time_ms(torch, scatter, lsets)
        lib_dev_ms = device_time_ms(torch, scatter, lsets)
        del lsets
        # the update read once and written once into its slab
        bms, bby = bound(B * H * S * D * (upd.element_size()
                                          + cache.element_size()), 0)
        say(f"  ragged_kv_write {label} B={B} H={H} L={L} D={D} S={S} "
            f"{str(udt)[6:]} into {str(cdt)[6:]}: bit-exact {exact}, in "
            f"place {got.data_ptr() == ptr}, max_abs_err={err:.6g}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_ {lib_ms:.4f} "
            f"ms; device time alone: kernel {dev_ms:.4f} ms, plain "
            f"{plain_dev_ms:.4f} ms, scatter_ {lib_dev_ms:.4f} ms (same "
            f"cache as the kernel's: {same_lib}); host {h_us:.1f} us a "
            f"call; bound {bms:.5f} ms ({bby})")
        if not exact or got.data_ptr() != ptr:
            fail(f"ragged_kv_write ({label}) is not the plain version's "
                 f"in-place copy")
        if timing is None:
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bby, library_ms=lib_ms,
                          shape=f"B={B} H={H} L={L} D={D} S=1 bf16",
                          device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                          library_device_ms=lib_dev_ms, host_us=h_us)
        del sets, cache, upd, want, got
        torch.cuda.empty_cache()
    results.append({
        "name": "ragged_kv_write", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/kv_write.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/kv_write.py:104",
        "launches": None, "max_abs_err": 0.0, **timing})

    # the pair: K contiguous, V the llama recipe's transposed view; the
    # decode pair of the 16 slots, the 128-row piece, GPT-2's decode pair
    # at 64 slots, the direct path's scalar start (S 1 and 32), f32 into
    # bf16; the same positions as above
    pair_cases = (
        ("decode pair", 16, 8, L, 128, 1, torch.bfloat16, torch.bfloat16,
         decode_pos),
        ("piece pair", 4, 8, L, 128, 128, torch.bfloat16, torch.bfloat16,
         [0, 128, 1950, 3000]),
        ("GPT-2 decode pair", 64, 12, 256, 64, 1, torch.bfloat16,
         torch.bfloat16, [0, 255, 300, -1, 17, 128, -256, 9] * 8),
        ("direct pair", 1, 8, L, 128, 1, torch.bfloat16, torch.bfloat16,
         100),
        ("direct pair", 1, 8, L, 128, 32, torch.bfloat16, torch.bfloat16,
         2040),
        ("f32 update pair", 16, 8, L, 128, 1, torch.bfloat16,
         torch.float32, decode_pos),
        ("f16 update pair", 16, 8, L, 128, 1, torch.bfloat16,
         torch.float16, decode_pos),
        ("Gemma-2 direct pair", 1, 4, L, 256, 1, torch.bfloat16,
         torch.bfloat16, 100),
        ("Phi-3 direct pair", 1, 32, L, 96, 1, torch.bfloat16,
         torch.bfloat16, 100))
    say("  kv_write_pair: a layer's K and V caches in one launch, bit-exact "
        "against the plain version (two ragged_kv_write_plain) over both "
        "whole caches, in place; library: two scatter_ calls")
    pair, shapes = None, {}
    for label, B, H, L, D, S, cdt, udt, pos_list in pair_cases:
        sets = []
        for _ in range(copies_for(2 * B * H * L * D * 2)):
            ck, cv = (torch.randn(B, H, L, D, generator=gen,
                                  device=dev).to(cdt) for _ in range(2))
            uk = torch.randn(B, H, S, D, generator=gen, device=dev).to(udt)
            uv = torch.randn(B, S, H, D, generator=gen,
                             device=dev).to(udt).transpose(1, 2)
            sets.append((ck, uk, cv, uv, torch.tensor(pos_list, device=dev)))
        ck, uk, cv, uv, pos = sets[0]
        want = kv_write_pair_plain(ck.clone(), uk, cv.clone(), uv, pos)
        n0 = kv_write_pair.launches
        ptrs = ck.data_ptr(), cv.data_ptr()
        got = kv_write_pair(ck, uk, cv, uv, pos)
        torch.cuda.synchronize()
        exact = all(same(a, b) for a, b in zip(got, want))
        in_place = (got[0].data_ptr(), got[1].data_ptr()) == ptrs
        if not (exact and in_place and kv_write_pair.launches == n0 + 1):
            fail(f"kv_write_pair ({label}, S={S}) is not the plain "
                 f"version's in-place copy in one launch")
        ms = time_ms(torch, kv_write_pair, sets)
        plain_ms = time_ms(torch, kv_write_pair_plain, sets)
        dev_ms = device_time_ms(torch, kv_write_pair, sets)
        h_us = host_us(torch, kv_write_pair, sets)
        lsets = [(k, scatter_index(p, B, H, L, S, D), a.to(cdt), v, b.to(cdt))
                 for k, a, v, b, p in sets]

        def scatters(k, idx, a, v, b):
            return k.scatter_(2, idx, a), v.scatter_(2, idx, b)

        same_lib = all(same(x, y) for x, y in zip(
            scatters(ck.clone(), lsets[0][1], lsets[0][2], cv.clone(),
                     lsets[0][4]),
            kv_write_pair(ck.clone(), uk, cv.clone(), uv, pos)))
        lib_ms = time_ms(torch, scatters, lsets)
        lib_dev_ms = device_time_ms(torch, scatters, lsets)
        del lsets
        bms, bby = bound(2 * B * H * S * D * (uk.element_size()
                                              + ck.element_size()), 0)
        plan = kv_write_plan(2, B, H, S, D, ck.element_size(),
                             uk.element_size(), card)
        scalar = "scalar pos" if isinstance(pos_list, int) else "pos (B,)"
        say(f"  kv_write_pair {label} B={B} H={H} L={L} D={D} S={S} "
            f"{str(udt)[6:]} into {str(cdt)[6:]}, {scalar} ({plan.blocks} "
            f"blocks, {plan.units} 16-byte units): bit-exact {exact}, in "
            f"place {in_place}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, two scatter_ {lib_ms:.4f} ms (kernel/library "
            f"{ms / lib_ms:.2f}); device time alone: kernel {dev_ms:.4f} "
            f"ms ({bms / dev_ms:.1%} of the bound), two scatter_ "
            f"{lib_dev_ms:.4f} ms (same caches as the kernel's: "
            f"{same_lib}); host {h_us:.1f} us a call; bound {bms:.5f} ms "
            f"({bby})")
        key = f"{label} B={B} S={S} {str(udt)[6:]}"
        shapes[key] = {
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "bound_ms": bms, "host_us": h_us, "blocks": plan.blocks}
        if udt == torch.float16:
            # ROADMAP C17's choice: the kernel's f16 mode against a cast
            # at its edge (both updates to bf16 first, then the bf16 pair)
            def edge(k, a, v, b, p):
                return kv_write_pair(k, a.bfloat16(), v, b.bfloat16(), p)

            shapes[key].update(
                edge_cast_ms=time_ms(torch, edge, sets),
                edge_cast_device_ms=device_time_ms(torch, edge, sets),
                edge_cast_host_us=host_us(torch, edge, sets))
            say(f"  kv_write_pair {label}: the kernel's f16 mode {ms:.4f} "
                f"ms (device {dev_ms:.4f}, host {h_us:.1f} us) against a "
                f"cast at its edge {shapes[key]['edge_cast_ms']:.4f} ms "
                f"(device {shapes[key]['edge_cast_device_ms']:.4f}, host "
                f"{shapes[key]['edge_cast_host_us']:.1f} us)")
        if pair is None:
            pair = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                        library_ms=lib_ms,
                        shape=f"B={B} H={H} L={L} D={D} S=1 bf16, K and V",
                        device_ms=dev_ms, library_device_ms=lib_dev_ms,
                        host_us=h_us)
        del sets, ck, cv, uk, uv, want, got
        torch.cuda.empty_cache()
    decode = shapes["decode pair B=16 S=1 bfloat16"]
    piece = shapes["piece pair B=4 S=128 bfloat16"]
    say(f"  aims (information): the decode pair host-timed no slower than "
        f"two scatter_ ({decode['ms']:.4f} against {decode['library_ms']:.4f}"
        f" ms: {'met' if decode['ms'] <= decode['library_ms'] else 'missed'})"
        f", on the device at most 0.0035 ms ({decode['device_ms']:.4f}: "
        f"{'met' if decode['device_ms'] <= 0.0035 else 'missed'}); the piece "
        f"pair on the device at most 0.0056 ms ({piece['device_ms']:.4f}: "
        f"{'met' if piece['device_ms'] <= 0.0056 else 'missed'}); "
        f"{card_line()}")
    results.append({
        "name": "kv_write_pair", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/kv_write.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/kv_write.py:104",
        "launches": None, "max_abs_err": 0.0, **pair, "shapes": shapes})


def sdpa_gqa(torch, q, k, v, mask, scale):
    """One call of scaled_dot_product_attention with GQA by head index
    (enable_gqa), ready to run: the yardstick attention call, timed
    only. The port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def flash_work(torch, mode, B, Hq, Hkv, Sq, Skv, D, extra):
    """(visible (query, key) pairs per query head, the K/V bytes those
    pairs read): what this run's data needs. A key tile past the last
    visible key is never read; K/V rows up to the last visible key of
    each batch row are read once."""
    dev = torch.device("cuda")
    j = torch.arange(Skv, device=dev)
    s = torch.arange(Sq, device=dev)[:, None]
    if mode == "pos":
        limit = extra["pos_bound"].reshape(-1).expand(B).long()
        vis = j <= limit.view(B, 1, 1) + s
    elif mode == "causal":
        vis = (j <= s + (Skv - Sq)).expand(B, Sq, Skv)
    else:     # an entry of -1e30 (the Gemma recipes') weighs exactly 0
        vis = (extra["mask"][:, 0] > -1e20).expand(B, Sq, Skv)
    pairs = int(vis.sum())
    last = torch.where(vis.any(1), j, -1).amax(1)          # (B,)
    kv_bytes = int((last + 1).clamp_min(0).sum()) * Hkv * D * 2 * 2
    return pairs, kv_bytes


def phase2_flash(torch, results):
    """flash_attention against its plain version, at the shapes of the
    direct prefill, an admission group, a 128-row piece, a long prompt,
    GPT-2's width, the causal and additive modes, and ragged edges."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain,
        flash_splits)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    say("  flash_attention (tolerance per element: flash_agreement_bound, "
        "2^-7 |plain| + (2^-7 + 2^-16) * plain with |v|)")
    # (label, mode, B, Hq, Hkv, Sq, Skv, D, pos)
    cases = (("(i) direct prefill", "pos", 1, 32, 8, 2048, 2048, 128, [0]),
             ("(ii) admission group", "pos", 4, 32, 8, 512, 2048, 128,
              [0, 300, 1000, 1536]),
             ("(iii) prefill piece", "pos", 1, 32, 8, 128, 2048, 128, [1024]),
             ("(iv) long prompt", "pos", 1, 32, 8, 8192, 8192, 128, [0]),
             ("(v) GPT-2 width", "pos", 1, 12, 12, 1024, 1024, 64, [0]),
             ("(vi) causal", "causal", 2, 32, 8, 1024, 1536, 128, None),
             ("(vii) additive mask", "mask", 2, 32, 8, 512, 1024, 128, None),
             ("(viii) ragged edges", "pos", 1, 32, 8, 300, 1000, 128, [700]),
             ("(ix) GPT-2 piece", "pos", 1, 12, 12, 128, 1024, 64, [512]),
             ("(x) verify block", "pos", 1, 32, 8, 4, 2048, 128, [700]),
             ("(xi) verify block, 4 rows", "pos", 4, 32, 8, 5, 2048, 128,
              [0, 65, 1000, 2043]),
             # head dim 256 under the Gemma recipes' additive (1, 1, Sq,
             # max_len) mask: Gemma-3 1B's 4/1 heads, global and window
             # 512, and Gemma 2B's 8/1, at 2,048 rows and a 128-row prompt
             ("(xii) Gemma-3 global", "global", 1, 4, 1, 2048, 2048, 256,
              None),
             ("(xiii) Gemma-3 window 512", "window", 1, 4, 1, 2048, 2048,
              256, None),
             ("(xiv) Gemma-3 128-row prompt", "global", 1, 4, 1, 128, 2048,
              256, None),
             ("(xv) Gemma 2B", "global", 1, 8, 1, 2048, 2048, 256, None),
             ("(xvi) Gemma 2B 128-row prompt", "global", 1, 8, 1, 128, 2048,
              256, None))
    card = torch.cuda.current_device()
    worst, head, shapes = 0.0, None, {}
    for label, mode, B, Hq, Hkv, Sq, Skv, D, pos_list in cases:
        extra, dense = {}, None
        if mode == "pos":
            extra["pos_bound"] = torch.tensor(pos_list, device=dev)
            dense = (torch.arange(Skv, device=dev)
                     <= extra["pos_bound"].view(B, 1, 1)
                     + torch.arange(Sq, device=dev)[:, None])[:, None]
        elif mode == "causal":
            extra["causal"] = True
            dense = (torch.arange(Skv, device=dev)
                     <= torch.arange(Sq, device=dev)[:, None]
                     + (Skv - Sq))[None, None]
        elif mode in ("global", "window"):
            # a prompt at position 0: key j visible from row i iff j <= i
            # (and j > i - 512 in a window layer); -1e30 elsewhere, the
            # lowering's f32 mask (its rows' maximum is 0 already)
            j = torch.arange(Skv, device=dev)
            i = torch.arange(Sq, device=dev)[:, None]
            vis = (j <= i) & ((j > i - 512) if mode == "window" else True)
            extra["mask"] = dense = torch.where(vis, 0.0, -1e30)[None, None]
        else:
            m = torch.randn(B, 1, Sq, Skv, generator=gen, device=dev) * 2
            m[torch.rand(m.shape, generator=gen, device=dev) < 0.3] = \
                -torch.inf
            extra["mask"] = dense = m
        nbytes = (2 * B * Hq * Sq + 2 * B * Hkv * Skv) * D * 2
        sets = []
        for _ in range(copies_for(nbytes)):
            q = torch.randn(B, Sq, Hq, D, generator=gen,
                            device=dev).bfloat16().transpose(1, 2)
            k, v = (torch.randn(B, Hkv, Skv, D, generator=gen,
                                device=dev).bfloat16() for _ in range(2))
            sets.append((q, k, v))
        q, k, v = sets[0]
        scale = 1.0 / math.sqrt(D)
        got = flash_attention(q, k, v, scale, **extra)
        ref = flash_attention_plain(q, k, v, scale, **extra)
        err, share = worst_share(got, ref, flash_attention_plain(
            q, k, v.abs(), scale, **extra), flash_agreement_bound)
        del ref
        big = Sq * Skv >= 8192 * 8192

        def kernel(q, k, v):
            return flash_attention(q, k, v, scale, **extra)

        ms = time_ms(torch, kernel, sets)
        dev_ms = device_time_ms(torch, kernel, sets,
                                **(dict(reps=3, inner=5) if big else {}))
        plain_ms = time_ms(torch, lambda q, k, v: flash_attention_plain(
            q, k, v, scale, **extra), sets[:2], reps=3 if big else 7,
            inner=1 if big else 5)
        calls = [(sdpa_gqa(torch, q, k, v, dense, scale),)
                 for q, k, v in sets[:2]]
        lib_ms = time_ms(torch, lambda f: f(), calls, reps=3 if big else 7,
                         inner=1 if big else 5)
        lib_dev = device_time_ms(torch, lambda f: f(), calls,
                                 **(dict(reps=3, inner=5) if big else {}))
        splits, _ = flash_splits(B, Hq, Hkv, Sq, Skv, D, card)
        pairs, kv_bytes = flash_work(torch, mode, B, Hq, Hkv, Sq, Skv, D,
                                     extra)
        io_bytes = 2 * B * Hq * Sq * D * 2 + kv_bytes + (
            extra["mask"].numel() * 4 if "mask" in extra else 0)
        bms, bby = bound(io_bytes, 4 * D * Hq * pairs)
        tflops = 4 * D * Hq * pairs / (ms * 1e-3) / 1e12
        say(f"  flash_attention {label} {mode} B={B} Hq/Hkv={Hq}/{Hkv} "
            f"Sq={Sq} Skv={Skv} D={D} pos={pos_list} ({splits} key "
            f"splits): max_abs_err={err:.6g}, worst err/tol {share:.4g}; "
            f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s over visible keys), "
            f"device {dev_ms:.4f} ms ({bms / dev_ms:.1%} of the bound), "
            f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (kernel/SDPA "
            f"{ms / lib_ms:.2f}), SDPA device {lib_dev:.4f} ms, bound "
            f"{bms:.4f} ms ({bby})")
        if not share <= 1.0:
            fail(f"flash_attention disagrees with its plain version "
                 f"({label}): err/tol {share}")
        worst = max(worst, err)
        shapes[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "library_device_ms": lib_dev,
                         "bound_ms": bms, "splits": splits}
        if head is None:
            head = (ms, plain_ms, lib_ms, bms, bby,
                    f"B={B} Hq/Hkv={Hq}/{Hkv} Sq=Skv={Sq} D={D} pos=0")
        del sets, calls, q, k, v, got, dense
        extra.clear()
        torch.cuda.empty_cache()
    results.append({
        "name": "flash_attention", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/flash_attention.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/attention.py:175",
        "launches": None, "max_abs_err": worst, "ms": head[0],
        "plain_ms": head[1], "bound_ms": head[3], "bound_by": head[4],
        "library_ms": head[2], "shape": head[5], "shapes": shapes})


# (label, bits, G, has_off): the layouts the GGUF formats repack to, and
# a GPTQ-style group of 128
PACKED_CASES = (("Q4_0", 4, 32, True), ("Q4_K", 4, 32, True),
                ("Q6_K", 8, 16, True), ("Q8_0", 8, 32, False),
                ("G128", 4, 128, True))
# (K, N): fused q/k/v, o, fused gate/up, down, lm_head
MATMUL_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                 (4096, 128256))


def random_packed(torch, gen, bits, G, has_off, K, N):
    """Random packed weights on the card: q bytes, positive scales, and
    offsets in [0, 16) scales (zeros without offsets)."""
    dev = torch.device("cuda")
    if bits == 4:
        q = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.uint8)
    else:
        q = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    s = torch.rand(K // G, N, generator=gen, device=dev) * 0.01 + 1e-3
    o = (s * torch.rand(K // G, N, generator=gen, device=dev) * 16 if has_off
         else torch.zeros_like(s))
    return q, s, o


def packed_magnitude(torch, x, q, s, o, bits, has_off):
    """|x| @ |W|: the plain version's sum of the terms' magnitudes, by
    column chunks (agreement_bound's second part)."""
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        dequantize_packed)

    xa = x.reshape(-1, x.shape[-1]).float().abs()
    out = torch.empty((xa.shape[0], q.shape[1]), device=x.device)
    for n0 in range(0, q.shape[1], 8192):
        sl = slice(n0, n0 + 8192)
        out[:, sl] = xa @ dequantize_packed(q, s, o, bits, has_off, sl).abs()
    return out.reshape(*x.shape[:-1], q.shape[1])


def int4pack_call(torch, x, q, s, o, G):
    """One torch.ops.aten._weight_int4pack_mm call computing x @ W for a
    bits-4 layout (the yardstick, timed only; the port never calls it):
    its weight is (N, K) 4-bit values packed two to a byte, its scales
    and zeros bf16 (K/G, N, 2) with W = (v - 8) * scale + zero, so zero =
    8 s - o. Returns a ready call, or raises where the card's torch has
    no such kernel for these inputs."""
    K, N = q.shape[0] * 2, q.shape[1]
    v = torch.cat([q & 0x0F, q >> 4], dim=0).t().to(torch.int32)  # (N, K)
    packed = ((v[:, ::2] << 4) | v[:, 1::2]).to(torch.uint8)
    w = torch.ops.aten._convert_weight_to_int4pack(packed.contiguous(), 8)
    sz = torch.stack([s, 8 * s - o], dim=-1).bfloat16().contiguous()
    xb = x.bfloat16()
    mm = torch.ops.aten._weight_int4pack_mm
    mm(xb, w, G, sz)
    return lambda: mm(xb, w, G, sz)


def phase2_packed(torch, results):
    """packed_matmul against its plain version at the served paths'
    shapes, for the layouts of Q4_0, Q4_K, Q6_K, Q8_0 and a 128-row
    group; M 1, 16, 128, 512 and 2048 for Q4_0, M 1 and 512 for the
    others; f32 x at M 512 and 2048 on gate/up and down; then both
    paths at M 1..16 on the down and gate/up shapes (the crossover of
    packed_plan)."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda import packed_matmul as pm
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul, packed_matmul_plain, packed_plan)

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    say("  packed_matmul (tolerance per element: agreement_bound, plain "
        "version on |x| and |W|; library: _weight_int4pack_mm, bf16 "
        "scales)")
    worst, head, down, lib_err, shapes = 0.0, None, None, None, {}
    for label, bits, G, has_off in PACKED_CASES:
        rows = (1, 16, 128, 512, 2048) if label == "Q4_0" else (1, 512)
        for K, N in MATMUL_SHAPES:
            wbytes = (K // 2 if bits == 4 else K) * N + (
                2 if bits == 4 or has_off else 1) * (K // G) * N * 4
            wsets = [random_packed(torch, gen, bits, G, has_off, K, N)
                     for _ in range(copies_for(wbytes))]
            for M in rows:
                sets = [(torch.randn(M, K, generator=gen, device=dev)
                         .bfloat16(), *w, bits, has_off) for w in wsets]
                got = packed_matmul(*sets[0])
                ref = packed_matmul_plain(*sets[0])
                err, share = worst_share(got, ref, packed_magnitude(
                    torch, *sets[0]), agreement_bound)
                del got, ref
                ms = time_ms(torch, packed_matmul, sets)
                plain_ms = time_ms(torch, packed_matmul_plain, sets[:2],
                                   reps=3, inner=2)
                # device time alone at decode rows, where the times above
                # are the host's launch rate, and the host's time a call
                decode_rows = M <= 16 and label == "Q4_0"
                dev_ms = (device_time_ms(torch, packed_matmul, sets)
                          if decode_rows else None)
                h_us = (host_us(torch, packed_matmul, sets)
                        if decode_rows and M == 1 else None)
                lib_ms = lib_dev = None
                if bits == 4 and G in (32, 128):
                    try:
                        calls = [(int4pack_call(torch, x, q, s, o, G),)
                                 for x, q, s, o, _, _ in sets[:2]]
                        lib_ms = time_ms(torch, lambda f: f(), calls)
                        if decode_rows:
                            lib_dev = device_time_ms(torch, lambda f: f(),
                                                     calls)
                        del calls
                    except (RuntimeError, NotImplementedError) as e:
                        lib_err = f"{type(e).__name__}: {str(e)[:200]}"
                bms, bby = bound(M * K * 2 + wbytes + M * N * 2,
                                 2 * M * K * N)
                plan = packed_plan(M, K, N, G, bits, True, card)
                lib = "none" if lib_ms is None else (
                    f"{lib_ms:.4f} ms (kernel/library {ms / lib_ms:.2f})")
                say(f"  packed_matmul {label} (bits {bits}, G {G}) M={M} "
                    f"K={K} N={N} ({plan.path}, {plan.splits} splits): "
                    f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; "
                    f"kernel {ms:.4f} ms ({bms / ms:.1%} of the bound), "
                    f"plain {plain_ms:.4f} ms, library {lib}, bound "
                    f"{bms:.4f} ms ({bby})"
                    + ("" if dev_ms is None else
                       f"; device time alone: kernel {dev_ms:.4f} ms "
                       f"({bms / dev_ms:.1%} of the bound), library "
                       f"{'none' if lib_dev is None else f'{lib_dev:.4f} ms'}")
                    + ("" if h_us is None else f"; host {h_us:.1f} us a call"))
                if not share <= 1.0:
                    fail(f"packed_matmul disagrees with its plain version "
                         f"({label}, M={M}, K={K}, N={N}): err/tol {share}")
                worst = max(worst, err)
                if label == "Q4_0":
                    shapes[f"M={M} K={K} N={N}"] = {
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bms, "device_ms": dev_ms,
                        "library_device_ms": lib_dev, "host_us": h_us,
                        "path": plan.path, "splits": plan.splits}
                if (label, M, K, N) == ("Q4_0", 1, 4096, 28672):
                    head = (ms, plain_ms, lib_ms, bms, bby)
                del sets
            del wsets
            torch.cuda.empty_cache()
    if lib_err:
        say(f"  _weight_int4pack_mm raised on the card: {lib_err}")

    # f32 x (a model computing in f32) takes the CUDA cores at every M:
    # Q4_0 at prefill rows on gate/up and down, beside the plain version
    for K, N in ((4096, 28672), (14336, 4096)):
        wbytes = K // 2 * N + 2 * (K // 32) * N * 4
        wsets = [random_packed(torch, gen, 4, 32, True, K, N)
                 for _ in range(copies_for(wbytes))]
        for M in (512, 2048):
            sets = [(torch.randn(M, K, generator=gen, device=dev), *w, 4,
                     True) for w in wsets]
            err, share = worst_share(
                packed_matmul(*sets[0]), packed_matmul_plain(*sets[0]),
                packed_magnitude(torch, *sets[0]), agreement_bound)
            ms = time_ms(torch, packed_matmul, sets, reps=3, inner=2)
            plain_ms = time_ms(torch, packed_matmul_plain, sets[:2], reps=3,
                               inner=2)
            bms, bby = bound(M * K * 4 + wbytes + M * N * 4, 2 * M * K * N)
            plan = packed_plan(M, K, N, 32, 4, False, card)
            say(f"  packed_matmul Q4_0 f32 x M={M} K={K} N={N} ({plan.path}, "
                f"{plan.bm} rows a block, {plan.splits} splits): "
                f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms (kernel/plain "
                f"{ms / plain_ms:.2f}), bound {bms:.4f} ms ({bby})")
            if not share <= 1.0:
                fail(f"packed_matmul disagrees with its plain version (f32 "
                     f"x, M={M}, K={K}, N={N}): err/tol {share}")
            worst = max(worst, err)
            shapes[f"f32 M={M} K={K} N={N}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "path": plan.path, "splits": plan.splits}
            del sets
        del wsets
        torch.cuda.empty_cache()

    # the crossover: both paths at the same rows, Q4_0, down and gate/up
    say("  packed_matmul paths at decode rows (Q4_0): device ms of the "
        "CUDA-core path / the tensor-core path, each with packed_plan's "
        "splits")
    for K, N in ((14336, 4096), (4096, 28672)):
        wbytes = K // 2 * N + 2 * (K // 32) * N * 4
        wsets = [random_packed(torch, gen, 4, 32, True, K, N)
                 for _ in range(copies_for(wbytes))]
        line = []
        for M in (1, 4, 8, 9, 12, 16):
            sets = [(torch.randn(M, K, generator=gen, device=dev).bfloat16(),
                     *w, 4, True) for w in wsets]
            t = []
            for path in ("cores", "tensor"):
                plan = pm._path_plan(path, M, K, N, 32, 4, True, card)

                def run(x, q, s, o, bits, has_off, plan=plan):
                    return pm._launch(x, q, s, o, bits, has_off, plan)

                _, share = worst_share(run(*sets[0]), packed_matmul_plain(
                    *sets[0]), packed_magnitude(torch, *sets[0]),
                    agreement_bound)
                if not share <= 1.0:
                    fail(f"packed_matmul's {path} path disagrees with its "
                         f"plain version (M={M}, K={K}, N={N})")
                t.append(device_time_ms(torch, run, sets))
            line.append(f"M={M} {t[0]:.4f}/{t[1]:.4f}")
            del sets
        say(f"    K={K} N={N}: " + ", ".join(line))
        del wsets
        torch.cuda.empty_cache()
    results.append({
        "name": "packed_matmul", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/packed_matmul.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/packed_matmul.py:278",
        "launches": None, "max_abs_err": worst, "ms": head[0],
        "plain_ms": head[1], "bound_ms": head[3], "bound_by": head[4],
        "library_ms": head[2], "library_error": lib_err,
        "shape": "Q4_0 M=1 K=4096 N=28672 (gate/up)",
        "down": shapes["M=1 K=14336 N=4096"], "shapes": shapes})


def sweep_plans(torch) -> None:
    """--plans: device ms of packed_matmul (Q4_0) and decode_attention
    under forced K and key splits, beside the plan each wrapper picks (the
    numbers behind packed_plan and decode_splits). Timing only."""
    from whisper_tensor_tpu_torch.backends.cuda import decode_attention as da
    from whisper_tensor_tpu_torch.backends.cuda import packed_matmul as pm

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def forced(M, K, N, path, splits):
        bm = pm._path_plan(path, M, K, N, 32, 4, True, card).bm
        unit = math.lcm(pm.kernel_limits(path, bm, 4, True, 32,
                                         card).stage_q_rows, 32)
        units = -(-K // 2 // unit)
        per = -(-units // min(splits, units))
        return pm.PackedPlan(path, bm, -(-units // per), per * unit)

    say("plans: packed_matmul Q4_0, device ms by K splits (* the wrapper's)")
    for K, N in MATMUL_SHAPES:
        wsets = [random_packed(torch, gen, 4, 32, True, K, N)
                 for _ in range(copies_for(K // 2 * N + (K // 32) * N * 8))]
        for M, path in ((1, "cores"), (16, "cores"), (16, "tensor"),
                        (64, "tensor"), (128, "tensor"), (512, "tensor")):
            sets = [(torch.randn(M, K, generator=gen, device=dev).bfloat16(),
                     *w, 4, True) for w in wsets]
            pick = pm._path_plan(path, M, K, N, 32, 4, True, card).splits
            row, seen = [], set()
            for s in (1, 2, 3, 4, 6, 8, 11, 12, 16, 24, 32, pick):
                plan = forced(M, K, N, path, s)
                if plan.splits in seen:
                    continue
                seen.add(plan.splits)
                t = device_time_ms(torch, lambda *a, plan=plan: pm._launch(
                    *a, plan), sets, reps=5, inner=10)
                row.append((plan.splits, t))
            say(f"  K={K} N={N} M={M} {path}: " + ", ".join(
                f"{s}{'*' if s == pick else ''} {t:.4f}"
                for s, t in sorted(row)))
            del sets
        del wsets
        torch.cuda.empty_cache()

    say("plans: decode_attention Hq/Hkv 32/8 L=2048 all keys live, device "
        "ms by key splits (* the wrapper's)")
    L = MAX_LEN
    for B in (1, 4, 8, 16, 32):
        sets = []
        for _ in range(copies_for(2 * B * 8 * L * 128 * 2)):
            sets.append((
                torch.randn(B, 32, 1, 128, generator=gen,
                            device=dev).bfloat16(),
                *(torch.randn(B, 8, L, 128, generator=gen,
                              device=dev).bfloat16() for _ in range(2)),
                torch.full((B,), L - 1, device=dev), 0.088))
        pick = da.decode_splits(B, 32, 8, L, 128, card)[0]
        row = []
        for s in sorted({1, 2, 4, 8, 16, 32, 64, pick}):
            chunk = -(-L // s)
            row.append((s, device_time_ms(
                torch, lambda *a, c=chunk: da._launch(*a, -(-L // c), c),
                sets, reps=5, inner=10)))
        say(f"  B={B}: " + ", ".join(
            f"{s}{'*' if s == pick else ''} {t:.4f}" for s, t in row))
        del sets
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
def checkpoint_shapes(layers: int) -> dict:
    """HF name -> shape of the smoke checkpoint, in file order."""
    E, I, V = WIDTHS["hidden_size"], WIDTHS["intermediate_size"], \
        WIDTHS["vocab_size"]
    hd = E // WIDTHS["num_attention_heads"]
    kv = WIDTHS["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (V, E), "model.norm.weight": (E,),
              "lm_head.weight": (V, E)}
    for i in range(layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (E,),
                       p + "post_attention_layernorm.weight": (E,),
                       p + "self_attn.q_proj.weight": (E, E),
                       p + "self_attn.k_proj.weight": (kv, E),
                       p + "self_attn.v_proj.weight": (kv, E),
                       p + "self_attn.o_proj.weight": (E, E),
                       p + "mlp.gate_proj.weight": (I, E),
                       p + "mlp.up_proj.weight": (I, E),
                       p + "mlp.down_proj.weight": (E, I)})
    return shapes


def checkpoint_tensors(layers: int, np):
    """(HF name, f32 array) of the smoke checkpoint, one at a time, in
    file order. Each tensor tiles a seeded block of 2^20 + 7 normal values
    (the block length is odd, so rows do not repeat in step), scaled
    0.02; norms are ones. lm_head rows outside the byte tokenizer's ids
    are zero, so greedy text decodes to printable bytes."""
    rng = np.random.default_rng(SEED)
    for n, s in checkpoint_shapes(layers).items():
        if n.endswith("norm.weight"):
            yield n, np.ones(s, np.float32)
            continue
        base = rng.standard_normal((1 << 20) + 7, dtype=np.float32) * 0.02
        arr = np.resize(base, s)
        if n == "lm_head.weight":
            arr[BYTE_VOCAB:] = 0.0
        yield n, arr


def write_checkpoint(d: Path, layers: int, np, bf16) -> int:
    """config.json + model.safetensors at Llama-3-8B widths, `layers`
    deep, with the weights of checkpoint_tensors."""
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"],
        "num_hidden_layers": layers, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16" if bf16 else "float16", **WIDTHS}))
    return write_safetensors(d, checkpoint_shapes(layers),
                             checkpoint_tensors(layers, np), np, bf16)


def write_safetensors(d: Path, shapes: dict, tensors, np, bf16,
                      name: str = "model.safetensors") -> int:
    """d/`name` holding `tensors` ((name, f32 array) in the order of
    `shapes`), stored in bf16, or f16 where ml_dtypes is missing; returns
    the data bytes."""
    st_dtype, np_dtype = (("BF16", bf16) if bf16 is not None
                          else ("F16", np.float16))
    header, off = {}, 0
    for n, s in shapes.items():
        size = int(np.prod(s)) * 2
        header[n] = {"dtype": st_dtype, "shape": list(s),
                     "data_offsets": [off, off + size]}
        off += size
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(d / name, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for _, arr in tensors:
            f.write(np.ascontiguousarray(arr.astype(np_dtype)).tobytes())
            del arr
    return off


def request(port: int, path: str, body: dict):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        c.request("POST", path, body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def completion(port: int, body: dict) -> dict:
    status, data = request(port, "/v1/completions", body)
    if status != 200:
        fail(f"/v1/completions returned {status}: {data[:500]!r}")
    return json.loads(data)


def shadow_checked(lowering, plain, bound):
    """Install, in the Attention lowering, a decode_attention that calls
    the one installed before and holds each result against `plain` on
    the same inputs. Returns it; `.inner` is the one it wraps."""
    inner = lowering.decode_attention

    def checked(q, k, v, pos, scale):
        got = inner(q, k, v, pos, scale)
        err, share = worst_share(got, plain(q, k, v, pos, scale), plain(
            q.float(), k, v.abs(), pos, scale), bound)
        checked.calls += 1
        checked.worst = max(checked.worst, share)
        checked.max_err = max(checked.max_err, err)
        return got

    checked.inner, checked.calls, checked.worst, checked.max_err = \
        inner, 0, 0.0, 0.0
    lowering.decode_attention = checked
    return checked


def quant_spy(transforms):
    """Install, in the QuantMatMul lowering's module, an int8_matmul that
    calls the one installed before and records every call the lowering
    makes: their count, the kernel launches they made (the wrapper's
    counter around each), the most rows of x, x's types and the
    weights' shapes.
    Returns it; `.inner` is the one it wraps."""
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul)

    inner = transforms.int8_matmul

    def spy(x, w, s):
        n0 = int8_matmul.launches
        out = inner(x, w, s)
        spy.calls += 1
        spy.launched += int8_matmul.launches - n0
        spy.rows = max(spy.rows, x.numel() // x.shape[-1])
        spy.shapes.add(tuple(w.shape))
        spy.types.add(str(x.dtype)[6:])
        return out

    spy.inner, spy.calls, spy.launched, spy.rows, spy.shapes, spy.types = \
        inner, 0, 0, 0, set(), set()
    transforms.int8_matmul = spy
    return spy


def check_quant_spy(spy, what: str, min_rows: int = 1) -> None:
    """Every QuantMatMul call the lowering made launched the kernel once
    (no plain route on the card), and some call had `min_rows` rows."""
    say(f"  int8_matmul in {what}: {spy.calls} QuantMatMul calls of the "
        f"lowering, {spy.launched} kernel launches, up to {spy.rows} rows, "
        f"x in {sorted(spy.types)}")
    if spy.calls <= 0 or spy.launched != spy.calls or spy.rows < min_rows:
        fail(f"the QuantMatMul calls of {what} did not each launch the "
             f"int8_matmul kernel once (up to {min_rows} rows)")


GREEDY = {"prompt": "The capital of France is", "max_tokens": 32,
          "temperature": 0}
CHAT = {"messages": [{"role": "user", "content": "Say hello."}],
        "max_tokens": 16, "temperature": 0, "stream": True}
SAMPLED = {"prompt": "Once upon a time", "max_tokens": 24,
           "temperature": 0.8, "top_k": 50, "seed": 7}


def count_steps(iface):
    """Count the runs of `iface`'s step graph until `del iface.step`."""
    inner = iface.step

    def counted(*args, **kw):
        counted.runs += 1
        return inner(*args, **kw)

    counted.runs = 0
    iface.step = counted
    return counted


def check_cache_writes(launches: dict, runs: int, layers: int,
                       what: str) -> None:
    """Every run of the step graph wrote each layer's K and V caches in
    one launch of the cache-write kernel (kv_write_pair), and the kernel
    launched for nothing else (ragged_kv_write counts all its launches)."""
    pairs, total = launches["kv_write_pair"], launches["ragged_kv_write"]
    say(f"  cache writes ({what}): {pairs} kv_write_pair launches, {total} "
        f"launches of the kernel in all, for {runs} runs of the step graph "
        f"x {layers} layers = {runs * layers}")
    if runs <= 0 or pairs != runs * layers or total != pairs:
        fail(f"the {what} path did not write each layer's caches in one "
             f"launch a step")


def serve_three(np, port: int, iface, counters: dict, layers: int,
                snapshot=None):
    """The direct path's three requests over HTTP (a greedy completion,
    a streamed chat, a seeded sampled completion), with every counter of
    `counters` ({name: wrapper}) and the cache-write kernel's set to 0
    just before them and read just after (with `snapshot()`'s counts,
    when given). All must answer in full; the
    greedy and the sampled request repeat to the same text; the chat's
    text is the interface's 16 greedy tokens; each run of the step graph
    writes a layer's caches in one launch. Returns (greedy response,
    launches, seconds)."""
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.tokenizer import (ByteTokenizer,
                                                    apply_chat_template)

    counters = dict(counters, ragged_kv_write=ragged_kv_write,
                    kv_write_pair=kv_write_pair)
    steps = count_steps(iface)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        r1 = completion(port, GREEDY)
        status, raw = request(port, "/v1/chat/completions", CHAT)
        r3 = completion(port, SAMPLED)
        served_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if snapshot is not None:
            launches.update(snapshot())
    finally:
        del iface.step
    say(f"  three requests served in {served_s:.2f} s; kernel launches "
        f"during them: {launches}")
    check_cache_writes(launches, steps.runs, layers, "direct")
    if status != 200:
        fail(f"/v1/chat/completions returned {status}: {raw[:500]!r}")
    events = [ln[6:] for ln in raw.split(b"\n") if ln.startswith(b"data: ")]
    if not events or events[-1] != b"[DONE]":
        fail(f"chat stream did not end with [DONE]: {raw[-300:]!r}")
    chat_text = "".join(
        json.loads(e)["choices"][0].get("delta", {}).get("content") or ""
        for e in events[:-1])
    for r, want in ((r1, 32), (r3, 24)):
        got = r["usage"]["completion_tokens"]
        if got != want:
            fail(f"completion returned {got} tokens, expected {want}")
    say(f"  greedy completion: {r1['choices'][0]['text']!r}")
    say(f"  streamed chat: {chat_text!r}")
    say(f"  sampled completion (seed 7): {r3['choices'][0]['text']!r}")
    if completion(port, GREEDY)["choices"][0]["text"] != \
            r1["choices"][0]["text"]:
        fail("repeating the greedy request gave another text")
    if completion(port, SAMPLED)["choices"][0]["text"] != \
            r3["choices"][0]["text"]:
        fail("repeating the seeded sampled request gave another text")
    tok = ByteTokenizer()
    rendered = apply_chat_template(tok, CHAT["messages"])
    ids = np.asarray(tok.encode(rendered), np.int64)[None]
    chat_toks = iface.generate_tokens(ids, 16)[0]
    if len(chat_toks) != 16 or tok.decode(list(chat_toks)) != chat_text:
        fail("the streamed chat text is not the interface's 16 tokens")
    if foreign_modules():
        fail(f"the JAX package or jax was imported: {foreign_modules()}")
    return r1, launches, served_s


def decode_checks(np, iface, greedy_text: str, layers: int, kernel: str,
                  module, attr: str, install, plain):
    """The greedy request's decode again, outside the counted run: (a)
    with `install()` shadowing each call of `module.attr` (the kernel's
    wrapper as a lowering calls it) by its plain version on the same
    inputs, element by element; (b) with `plain` in place of the kernel,
    its per-step logits against the kernel path's; (c) one teacher-
    forced prefill over prompt plus output against the decode-step
    logits. Returns the prompt (1, P)."""
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompt = np.asarray(tok.encode(GREEDY["prompt"]), np.int64)[None]
    checked = install()
    try:
        toks, step_logits = iface.generate_with_logits(prompt, 32)
    finally:
        setattr(module, attr, checked.inner)
    setattr(module, attr, plain)
    try:
        toks_w, logits_w = iface.generate_with_logits(prompt, 32)
    finally:
        setattr(module, attr, checked.inner)
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    teacher = iface.logits(full).astype(np.float32)
    P = prompt.shape[1]
    forced = teacher[:, P - 1:P - 1 + 32, :]
    scale = float(np.abs(forced).max())
    # (a)
    say(f"  (a) {checked.calls} {kernel} calls of the greedy decode "
        f"against the plain version on their inputs: worst |err|/bound "
        f"{checked.worst:.4g} (max |err| {checked.max_err:.5g})")
    # (b) logits at step i follow from tokens < i: compare the steps up
    # to the first token the two runs pick differently
    differ = np.nonzero(toks[0] != toks_w[0])[0]
    n_same = int(differ[0]) + 1 if differ.size else 32
    wdiff = float(np.abs(logits_w[:, :n_same]
                         - step_logits[:, :n_same]).max())
    # (c) bf16 activations round at 2^-8 relative per op. The two paths
    # round in different places (the decode kernel keeps attention
    # probabilities in f32, prefill rounds them to bf16 as the JAX
    # package does), so each layer adds an independent difference of a
    # few bf16 ulps to the residual stream: the logits part like a random
    # walk, by sqrt(layers). Bound: 1.5% of the logits' scale per
    # sqrt(layer), 3% at 4 layers.
    frac = 0.015 * math.sqrt(layers)
    tol = frac * scale
    diff = float(np.abs(forced - step_logits).max())
    agree = float((forced.argmax(-1) == toks).mean())
    say(f"  (b) plain {kernel} in place of the kernel: logits of {n_same} "
        f"steps differ by at most {wdiff:.5g} ({wdiff / scale:.3%} of "
        f"max|logit| {scale:.4g}; bound {tol:.5g} as in (c)), same "
        f"tokens: {not differ.size}")
    say(f"  (c) decode vs teacher-forced prefill logits: max_abs_diff="
        f"{diff:.5g} ({diff / scale:.3%}; tol {tol:.5g} = {frac:.1%} of "
        f"max|logit| {scale:.4g}), argmax agreement {agree:.3f}")
    if tok.decode(list(toks[0])) != greedy_text:
        fail("the interface's greedy tokens differ from the HTTP text")
    if checked.calls <= 0 or not checked.worst <= 1.0:
        fail(f"a {kernel} call of the greedy decode disagrees with its "
             f"plain version on the same inputs")
    if not wdiff <= tol:
        fail(f"decode-step logits with the plain {kernel} disagree with "
             f"the kernel path's")
    if not diff <= tol:
        fail("decode-step logits disagree with the prefill logits")
    return prompt


def direct_rates(torch, iface, prompt, layers: int) -> dict:
    """Time to first token and decode rate at batch 1 (host clock,
    direct calls), and the bytes on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iface.generate_tokens(prompt, 1)
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    iface.generate_tokens(prompt, 129)
    total = time.perf_counter() - t0
    rate = 128 / max(total - ttft, 1e-9)
    P = prompt.shape[1]
    bucket = min(b for b in iface.prompt_buckets if b >= P)
    gb = torch.cuda.memory_allocated() / 1e9
    say(f"  time to first token {ttft * 1e3:.1f} ms (prompt {P} tokens, "
        f"bucket {bucket}), decode {rate:.1f} tok/s (batch 1, {layers} "
        f"layers), {gb:.2f} GB on the card, on {card_line()}")
    return {"ttft_ms": ttft * 1e3, "tok_s": rate, "gb": gb}


def profile_decode(torch, iface, prompt, label: str) -> None:
    """torch.profiler over one prefill and 8 decode steps of the direct
    path: the wall time, the device time its kernels took (the busy
    share of the window), and the entries with the most device time and
    the most host time. Information only."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    iface.generate_tokens(prompt, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iface.generate_tokens(prompt, 9)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_launch = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))

    def top(key):
        return "; ".join(f"{e.key[:48]} {key(e) / 1e3:.3f} ms x{e.count}"
                         for e in sorted(events, key=key, reverse=True)[:6])

    say(f"  profile ({label}, a prefill and 8 decode steps): wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}), {n_launch} kernel launches; most "
        f"device time: {top(dev_us)}; "
        f"most host time: {top(lambda e: e.self_cpu_time_total)}")


def load_direct(torch, srv, ckpt: Path, quantize: str):
    """The smoke checkpoint through the port's loader and text interface
    (bf16, `quantize`, max_len 2048), weights uploaded."""
    t0 = time.perf_counter()
    entries = srv.models.run_loader("transformers", {
        "path": str(ckpt), "dtype": "bf16", "quantize": quantize,
        "max_len": MAX_LEN})
    say(f"  loader (ONNX build + parse): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    iface = srv._text_iface(entries[0])
    iface._weights()
    torch.cuda.synchronize()
    say(f"  port interface ({quantize} quantize + upload): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"peak host RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB")
    return iface


def phase3(torch, np, ckpt: Path, layers: int, results) -> dict:
    """Returns the direct path's rates (direct_rates)."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention, decode_attention_plain)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.milli.ops import attention as attn_lowering
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    from whisper_tensor_tpu_torch.milli import transforms

    say("phase 3: the direct path")
    srv = Server()
    iface = load_direct(torch, srv, ckpt, "int8")
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    spy = quant_spy(transforms)
    try:
        r1, launches, _ = serve_three(np, api.port, iface, {
            "decode_attention": decode_attention, "int8_matmul": int8_matmul,
            "flash_attention": flash_attention}, layers)
        for res in results:
            if res["name"] in launches:
                res["launches_direct"] = launches[res["name"]]
        if min(launches.values()) <= 0:
            fail(f"a kernel of the path was never launched: {launches}")
        prompt = decode_checks(
            np, iface, r1["choices"][0]["text"], layers, "decode_attention",
            attn_lowering, "decode_attention",
            lambda: shadow_checked(attn_lowering, decode_attention_plain,
                                   agreement_bound),
            decode_attention_plain)
        rates = direct_rates(torch, iface, prompt, layers)
        profile_decode(torch, iface, prompt, "int8")
        rates["long_ttft_ms"] = phase5_direct(torch, np, iface, api.port,
                                              layers, results)
        phase8(torch, np, srv, iface, api.port, layers, rates, results)
        phase10_spec_direct(torch, np, srv, iface, ckpt, layers, results)
    finally:
        transforms.int8_matmul = spy.inner
        api.stop()
    # the long prompt's prefill runs 2,048 rows (bucket 2048)
    check_quant_spy(spy, "phases 3 and 5 (direct)", min_rows=2048)
    return rates


# ---------------------------------------------------------------------------
# phase 8: the direct path's other routes, on phase 3's model
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "color": {"enum": ["red", "green", "blue"]}},
    "required": ["ok", "color"]}
REGEX = r"(yes|no|maybe), [0-9]{2}!"
TOOLS = [{"type": "function", "function": {
    "name": "set_alarm", "parameters": {
        "type": "object", "properties": {"hour": {"enum": [6, 7, 8]},
                                         "am": {"type": "boolean"}},
        "required": ["hour", "am"]}}}]
EMBED_INPUTS = ["The capital of France is", "a", "Once upon a time there "
                "was a very long sentence that goes on"]


def admitted(cons, toks) -> bool:
    """Every token admitted by the TokenDFA's table from the state before
    it: eos only in an accepting state and then only eos."""
    state = cons.start
    for t in (int(t) for t in toks):
        if t == cons.eos_token_id:
            if not cons.accepting[state]:
                return False
            state = cons.done
        elif state == cons.done or cons.trans[state, t] < 0:
            return False
        else:
            state = int(cons.trans[state, t])
    return True


def zero(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def rose(counters: dict, what: str, names) -> dict:
    """The counters' launches since zero(); fail unless each of `names`
    rose."""
    got = {name: fn.launches for name, fn in counters.items()}
    say(f"  kernel launches in {what}: {got}")
    if min(got[n] for n in names) <= 0:
        fail(f"a kernel of {what} was never launched: {got}")
    return got


class PlainVersions:
    """Within the block, every kernel wrapper a lowering calls is its
    plain version (the int8 and packed products, both attentions, the
    cache write)."""

    def __enter__(self):
        from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
            decode_attention_plain)
        from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
            flash_attention_plain)
        from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
            kv_write_pair_plain)
        from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
            packed_matmul_plain)
        from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
            int8_matmul_plain)
        from whisper_tensor_tpu_torch.milli import transforms
        from whisper_tensor_tpu_torch.milli.ops import attention, misc

        self.swaps = [(transforms, "int8_matmul", int8_matmul_plain),
                      (transforms, "packed_matmul", packed_matmul_plain),
                      (attention, "flash_attention", flash_attention_plain),
                      (attention, "decode_attention", decode_attention_plain),
                      (misc, "kv_write_pair", kv_write_pair_plain)]
        self.saved = [getattr(m, a) for m, a, _ in self.swaps]
        for m, a, fn in self.swaps:
            setattr(m, a, fn)
        return self

    def __exit__(self, *exc):
        for (m, a, _), fn in zip(self.swaps, self.saved):
            setattr(m, a, fn)


def embeddings_check(torch, np, port: int, iface, layers: int,
                     inputs=EMBED_INPUTS) -> float:
    """/v1/embeddings of `inputs`, last and mean pooling: unit vectors,
    the interface's own; the hidden states of one prefill with the
    kernels stand one with every plain version in place, within phase
    3's bound (1.5% per sqrt(layer) of the largest |hidden|). Returns the
    request's seconds (last pooling)."""
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    secs = {}
    for pooling in ("last", "mean"):
        t0 = time.perf_counter()
        status, data = request(port, "/v1/embeddings",
                               {"input": inputs, "pooling": pooling})
        secs[pooling] = time.perf_counter() - t0
        if status != 200:
            fail(f"/v1/embeddings returned {status}: {data[:300]!r}")
        vecs = [np.asarray(d["embedding"]) for d in json.loads(data)["data"]]
        norms = [float(np.linalg.norm(v)) for v in vecs]
        if len(vecs) != len(inputs) or max(abs(n - 1) for n in norms) > 1e-5:
            fail(f"embeddings ({pooling}) are not {len(inputs)} unit vectors: "
                 f"norms {norms}")
        width = vecs[0].shape
    ids = [np.asarray(tok.encode(t), np.int64) for t in inputs]
    batch = np.zeros((len(ids), max(map(len, ids))), np.int64)
    for i, a in enumerate(ids):
        batch[i, :len(a)] = a
    hidden = iface.hidden_states(batch).astype(np.float32)
    with PlainVersions():
        plain = iface.hidden_states(batch).astype(np.float32)
    mask = np.arange(batch.shape[1])[None, :] < np.asarray(
        [len(a) for a in ids])[:, None]
    scale = float(np.abs(plain[mask]).max())
    diff = float(np.abs(hidden - plain)[mask].max())
    frac = 0.015 * math.sqrt(layers)
    say(f"  {len(inputs)} embeddings of width {width[0]}, unit norm; the "
        f"hidden states against the plain versions: max |diff| {diff:.5g} "
        f"({diff / scale:.3%} of max|hidden| {scale:.4g}; bound "
        f"{frac:.1%}); the request took {secs['last'] * 1e3:.1f} ms (last) "
        f"and {secs['mean'] * 1e3:.1f} ms (mean)")
    if not diff <= frac * scale:
        fail("the hidden states with the kernels disagree with the plain "
             "versions'")
    return secs["last"]


def beam_scores(np, iface, prompt, toks, layers: int) -> tuple:
    """(the best beam's teacher-forced summed log-probability, the bound):
    one prefill over prompt and beam; the bound is phase 3's logit bound
    (1.5% per sqrt(layer) of the largest |logit|), twice over for a
    log-softmax, for each new token."""
    full = np.concatenate([prompt, toks], axis=1)
    P, n = prompt.shape[1], toks.shape[1]
    mean = iface.sequence_scores(full, np.full(1, P), np.full(1, P + n))
    logits = iface.logits(full[:, :-1]).astype(np.float32)[:, P - 1:]
    bound = n * 2 * 0.015 * math.sqrt(layers) * float(np.abs(logits).max())
    return float(mean[0]) * n, bound


def phase8(torch, np, srv, iface, port: int, layers: int, rates: dict,
           results) -> None:
    """Phase 8: the direct path's other routes on phase 3's int8 model:
    (g) constrained completions, (h) a tool call, (i) embeddings, (j)
    best_of reranking, (k) beam search through the generate_text
    message."""
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import kv_write_pair
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.interfaces.text import SamplingParams
    from whisper_tensor_tpu_torch.server import protocol as P
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say("phase 8: the direct path's other routes (phase 3's model)")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tok = ByteTokenizer()
    counters = {"int8_matmul": int8_matmul, "decode_attention":
                decode_attention, "kv_write_pair": kv_write_pair,
                "flash_attention": flash_attention}
    decoding = ("int8_matmul", "decode_attention", "kv_write_pair")
    launches = {}

    # (g) a json_schema completion and a regex one, greedy
    zero(counters)
    for label, body, check in (
            ("json_schema", {"response_format": {
                "type": "json_schema", "json_schema": {"schema": SCHEMA}}},
             lambda t: (isinstance(json.loads(t)["ok"], bool) and
                        json.loads(t)["color"] in ("red", "green", "blue"))),
            ("regex", {"regex": REGEX},
             lambda t: re.fullmatch(REGEX, t) is not None)):
        r = completion(port, dict(body, prompt=GREEDY["prompt"],
                                  max_tokens=48, temperature=0))
        text = r["choices"][0]["text"]
        cons = (iface.compile_constraint(json_schema=SCHEMA)
                if label == "json_schema" else
                iface.compile_constraint(regex=REGEX))
        toks = tok.encode(text) + [cons.eos_token_id]
        say(f"  (g) {label}: {text!r}, finish {r['choices'][0]['finish_reason']}"
            f", DFA {cons.n_states} states, table "
            f"{cons.trans.nbytes / 1e6:.1f} MB on the card")
        try:
            ok = check(text)
        except (ValueError, KeyError, TypeError):
            ok = False
        if r["choices"][0]["finish_reason"] != "stop" or not ok:
            fail(f"the {label} completion did not finish inside its language")
        if not admitted(cons, toks):
            fail(f"a token of the {label} completion is not admitted by the "
                 f"table from the state before it")
    launches["g"] = rose(counters, "(g)", decoding)

    # (h) a tool call
    zero(counters)
    status, data = request(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Wake me at seven."}],
        "max_tokens": 64, "temperature": 0, "tools": TOOLS,
        "tool_choice": "required"})
    ch = json.loads(data)["choices"][0] if status == 200 else {}
    calls = (ch.get("message") or {}).get("tool_calls") or []
    say(f"  (h) tool call: {calls}, finish {ch.get('finish_reason')}")
    try:
        args = json.loads(calls[0]["function"]["arguments"])
        ok = (len(calls) == 1 and calls[0]["function"]["name"] == "set_alarm"
              and args["hour"] in (6, 7, 8) and isinstance(args["am"], bool)
              and ch["finish_reason"] == "tool_calls")
    except (IndexError, KeyError, ValueError, TypeError):
        ok = False
    if not ok:
        fail(f"the tools request did not answer one tool call that parses: "
             f"{status} {data[:300]!r}")
    launches["h"] = rose(counters, "(h)", decoding)

    # (i) embeddings: a prefill, so flash_attention in the place of
    # decode_attention
    zero(counters)
    embed_s = embeddings_check(torch, np, port, iface, layers)
    launches["i"] = rose(counters, "(i)", ("int8_matmul", "kv_write_pair",
                                           "flash_attention"))

    # (j) best_of=4, n=1: the answer is the candidate sequence_scores
    # ranks first
    zero(counters)
    body = {"prompt": SAMPLED["prompt"], "max_tokens": 16, "temperature": 0.8,
            "top_k": 40, "seed": 11, "n": 1, "best_of": 4}
    r = completion(port, body)
    prompt = np.asarray(tok.encode(body["prompt"]), np.int64)
    rows = iface.generate_tokens(np.tile(prompt[None], (4, 1)), 16,
                                 sampling=SamplingParams(temperature=0.8,
                                                         top_k=40, seed=11))
    cands = []
    for row in rows:
        row = [int(t) for t in row]
        cut = [row.index(e) for e in (iface.eos_token_ids or ()) if e in row]
        cands.append(row[:min(cut)] if cut else row)
    full = np.zeros((4, len(prompt) + 16), np.int64)
    for i, c in enumerate(cands):
        full[i, :len(prompt)], full[i, len(prompt):len(prompt) + len(c)] = \
            prompt, c
    lens = np.asarray([len(prompt) + len(c) for c in cands])
    scores = iface.sequence_scores(full, np.full(4, len(prompt)), lens)
    scores = np.where(lens > len(prompt), scores, -np.inf)
    best = tok.decode(cands[int(np.argmax(scores))])
    say(f"  (j) best_of=4: {r['choices'][0]['text']!r}; candidates' mean "
        f"log-probabilities {np.round(scores, 4).tolist()}")
    if r["choices"][0]["text"] != best:
        fail("the best_of answer is not the candidate sequence_scores ranks "
             "first")
    launches["j"] = rose(counters, "(j)", decoding)

    # (k) num_beams=4 through the Server's generate_text message
    zero(counters)
    beam_prompt = np.asarray(tok.encode(GREEDY["prompt"]), np.int64)[None]
    srv._dispatch({"type": P.GENERATE_TEXT, "model_id": srv_entry_id(srv),
                   "prompt": GREEDY["prompt"], "max_new_tokens": 16,
                   "num_beams": 4, "tokenizer": "bytes"})
    deadline = time.time() + 600
    res = None
    while res is None and time.time() < deadline:
        rep = srv.scheduler.reports.get(timeout=600)
        if rep["type"] in (P.JOB_RESULT, P.JOB_ERROR):
            res = rep
    if res is None or res["type"] != P.JOB_RESULT:
        fail(f"the num_beams generate_text message failed: {res}")
    events, inner = [], iface._reorder_caches

    def timed(src, dst, rows):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        inner(src, dst, rows)
        b.record()
        events.append((a, b))

    iface._reorder_caches = timed
    try:
        toks, score = iface.beam_search_tokens(beam_prompt, 16, beam=4,
                                               return_scores=True)
    finally:
        del iface._reorder_caches
    torch.cuda.synchronize()
    reorder_ms = sum(a.elapsed_time(b) for a, b in events) / max(
        1, len(events))
    forced, bound = beam_scores(np, iface, beam_prompt, toks, layers)
    say(f"  (k) num_beams=4: {res['result']['text']!r}; the search's score "
        f"{float(score[0]):.5g}, teacher-forced {forced:.5g} (|diff| "
        f"{abs(forced - float(score[0])):.4g}, bound {bound:.4g})")
    if res["result"]["text"] != tok.decode([int(t) for t in toks[0]]):
        fail("the generate_text beam answer is not the interface's best beam")
    if not abs(forced - float(score[0])) <= bound:
        fail("the best beam's teacher-forced score disagrees with the "
             "search's")
    launches["k"] = rose(counters, "(k)", decoding)
    for res_k in results:
        if res_k["name"] in counters:
            res_k["launches_routes"] = sum(
                launches[k][res_k["name"]] for k in launches)

    # information: constrained decode rate beside the unconstrained one
    # (back to back), beam step and reorder times, the DFA table's size
    cons = iface.compile_constraint(regex=r"[a-z ]{1,160}")
    iface.generate_tokens(beam_prompt, 2, constraint=cons)   # the upload

    def rate(constraint):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iface.generate_tokens(beam_prompt, 1, constraint=constraint)
        t1 = time.perf_counter()
        iface.generate_tokens(beam_prompt, 129, constraint=constraint)
        return 128 / max((time.perf_counter() - t1) - (t1 - t0), 1e-9)

    free_rate, cons_rate, free_again = rate(None), rate(cons), rate(None)
    beam_t = []
    for n in (1, 33):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iface.beam_search_tokens(beam_prompt, n, beam=4)
        beam_t.append(time.perf_counter() - t0)
    step_ms = (beam_t[1] - beam_t[0]) / 32 * 1e3
    cache_mb = sum(c.numel() * c.element_size()
                   for c in iface.fresh_cache(4)) / 1e6
    say(f"  information: constrained decode {cons_rate:.1f} tok/s against "
        f"{free_rate:.1f} and {free_again:.1f} unconstrained just before "
        f"and after (phase 3's: {rates['tok_s']:.1f}; batch 1, {layers} "
        f"layers; a DFA of {cons.n_states} states, table "
        f"{cons.trans.nbytes / 1e6:.1f} MB); beam W=4 {step_ms:.2f} ms a "
        f"step, the cache reorder {reorder_ms:.4f} ms a step (device, "
        f"{len(events)} steps; {cache_mb:.1f} MB of caches read "
        f"and written); /v1/embeddings of {len(EMBED_INPUTS)} inputs "
        f"{embed_s * 1e3:.1f} ms; on {card_line()}")
    say(f"[phase 8: {time.perf_counter() - t_phase:.1f} s, peak host RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card]")
    if foreign_modules():
        fail(f"the JAX package or jax was imported: {foreign_modules()}")


def srv_entry_id(srv) -> int:
    """The id of the one model the Server holds."""
    (entry,) = srv.models._models.values()
    return int(entry.id)


# ---------------------------------------------------------------------------
SERVE_CFG = {"dtype": "bf16", "quantize": "int8", "max_len": MAX_LEN,
             "ragged_decode": True, "serve_batch": 16, "serve_chunk": 16,
             "serve_chunk_max": 64, "prefill_chunk": 128,
             "serve_auto_prefix": 8}


def free_memory(torch) -> None:
    """Return a finished phase's host and device memory before the next
    load (the loader peaks at ~68 GB of host RSS at 32 layers)."""
    gc.collect()
    torch.cuda.empty_cache()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def host_rss_gb() -> float:
    """This process's resident memory now (ru_maxrss is the peak)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1e6
    return float("nan")


def traffic(np):
    """Three waves of requests (seeded): (wave, path, body). Prompts are
    lowercase text, one byte-tokenizer token per character; eight share
    a 64-character prefix (65-95 tokens: their 32-aligned pool key is
    the prefix itself). Wave 0 admits whole buckets, wave 1 long prompts
    in 128-token pieces, and wave 2, sent once wave 1 is admitted, the
    prefix-sharing prompts that hit the pool entry wave 0 left."""
    rng = np.random.default_rng(SEED + 4)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz    "))

    def text(n):
        return "".join(rng.choice(letters, n))

    prefix = text(64)
    waves = [[("c", prefix + text(16))]
             + [("c", text(n)) for n in (5, 9, 14, 20, 27, 31, 12, 7, 45,
                                         70, 110)],
             [("c", text(n)) for n in (150, 190, 230, 270, 300, 340, 370,
                                       400)]
             + [("s", text(n)) for n in (180, 220, 260, 330)],
             [("c", prefix + text(n)) for n in (3, 8, 12, 17, 21, 26, 30)]
             + [("c", text(18))]]
    out = []
    sampled = {1, 4, 8, 13, 17, 21, 26, 31}           # 8 of the 32
    for w, wave in enumerate(waves):
        for kind, prompt in wave:
            i = len(out)
            body = {"max_tokens": int(rng.integers(8, 65))}
            if i in sampled:
                body.update(temperature=0.8, top_k=40, seed=100 + i)
            else:
                body["temperature"] = 0
            if kind == "s":
                body.update(messages=[{"role": "user", "content": prompt}],
                            stream=True)
            else:
                body["prompt"] = prompt
            out.append((w, kind, body))
    return out


def stream_chat(port: int, body: dict):
    """(status, data events, seconds to the first content delta)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        t0 = time.perf_counter()
        c.request("POST", "/v1/chat/completions", body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        events, first = [], None
        for line in r:
            if not line.startswith(b"data: "):
                continue
            ev = line[6:].strip()
            events.append(ev)
            if first is None and ev != b"[DONE]" and (json.loads(ev).get(
                    "choices") or [{}])[0].get("delta", {}).get("content"):
                first = time.perf_counter() - t0
        return r.status, events, first
    finally:
        c.close()


def teacher_gaps(torch, np, iface, prompt, toks, slot: int = 0):
    """One prefill over prompt + answer through the batcher's interface,
    under adapter `slot` (0: the base model): per answer step, (largest
    logit - the emitted token's logit) and the logits' scale max|logit|
    over those steps."""
    full = np.concatenate([prompt, toks[:-1]])
    padded = np.zeros((1, -(-len(full) // 64) * 64), np.int64)
    padded[0, :len(full)] = full
    dev = iface.device
    logits = iface.step(torch.from_numpy(padded).to(dev),
                        torch.zeros(1, dtype=torch.int64, device=dev),
                        iface.fresh_cache(1),
                        torch.tensor([slot], device=dev) if slot else None)
    P = len(prompt)
    forced = logits[0, P - 1:P - 1 + len(toks)].float().cpu().numpy()
    emitted = forced[np.arange(len(toks)), toks]
    return forced.max(-1) - emitted, float(np.abs(forced).max())


def phase4(torch, np, ckpt: Path, layers: int, results,
           plant_fault: bool) -> None:
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, kv_write_pair_plain, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.milli.ops import misc as misc_lowering
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    say(f"phase 4: the batched path (ContinuousBatcher); host RSS "
        f"{host_rss_gb():.1f} GB after phase 3 was freed")
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("transformers",
                                     {"path": str(ckpt), **SERVE_CFG})
    say(f"  loader (ragged_decode graph): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bat = srv._batcher(entry)         # what the first request would build
    bat.iface._weights()
    torch.cuda.synchronize()
    say(f"  batcher interface (int8 quantize + upload): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"peak host RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB")
    # every request the front end hands the batcher, with its future
    records, submit = [], bat.submit

    def recorded(prompt_ids, n_new, **kw):
        fut = submit(prompt_ids, n_new, **kw)
        records.append((np.asarray(prompt_ids, np.int64).reshape(-1), n_new,
                        kw.get("sampling"), fut))
        return fut

    bat.submit = recorded
    spy = quant_spy(transforms)
    kernel_write = misc_lowering.kv_write_pair
    if plant_fault:
        say("  PLANTED FAULT: every decode-step cache write lands at pos - 1")

        def early(cache_k, update_k, cache_v, update_v, pos):
            return kernel_write(cache_k, update_k, cache_v, update_v,
                                pos - 1 if update_k.shape[2] == 1 else pos)

        misc_lowering.kv_write_pair = early
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    reqs = traffic(np)
    answers = [None] * len(reqs)

    def client(i):
        w, kind, body = reqs[i]
        t = time.perf_counter()
        if kind == "s":
            answers[i] = stream_chat(api.port, body)
        else:
            st, data = request(api.port, "/v1/completions", body)
            answers[i] = (st, data, time.perf_counter() - t)

    def admitted(n):
        """Wait until the batcher holds n requests and has admitted them
        all (none queued, no admission in flight)."""
        deadline = time.time() + 600
        while time.time() < deadline:
            st = bat.stats()
            if len(records) >= n and not st["queued"] and not st["admitting"]:
                return
            time.sleep(0.01)
        fail(f"the batcher did not admit {n} requests in 600 s: "
             f"{bat.stats()}")

    steps = count_steps(bat.iface)
    try:
        decode_attention.launches = 0
        int8_matmul.launches = 0
        ragged_kv_write.launches = 0
        kv_write_pair.launches = 0
        flash_attention.launches = 0
        threads = []
        t0 = time.perf_counter()
        for w in range(3):
            if w:
                admitted(len(threads))
            for i, (wave, _, _) in enumerate(reqs):
                if wave == w:
                    threads.append(threading.Thread(target=client, args=(i,)))
                    threads[-1].start()
        for t in threads:
            t.join(900)
        served_s = time.perf_counter() - t0
        launches = {"decode_attention": decode_attention.launches,
                    "int8_matmul": int8_matmul.launches,
                    "ragged_kv_write": ragged_kv_write.launches,
                    "kv_write_pair": kv_write_pair.launches,
                    "flash_attention": flash_attention.launches}
    finally:
        misc_lowering.kv_write_pair = kernel_write
        del bat.iface.step
        bat.submit = submit
        api.stop()
    st = bat.stats()
    say(f"  32 requests served in {served_s:.2f} s: {st['chunks_dispatched']} "
        f"chunks, {st['steps_dispatched']} steps, {st['tokens_emitted']} "
        f"tokens emitted, auto-prefix pool {st['auto_prefix']}; scheduler "
        f"host time: admissions {st['time_admit_s']} s, chunk enqueue "
        f"{st['time_dispatch_s']} s, waiting on the device "
        f"{st['time_fetch_s']} s; kernel launches during them: {launches}")
    for res in results:
        if res["name"] in launches:
            res["launches"] = launches[res["name"]]
    n_tokens, ttfts = 0, []
    for i, ((w, kind, body), ans) in enumerate(zip(reqs, answers)):
        if ans is None:
            fail(f"request {i} got no answer")
        if kind == "s":
            status, events, first = ans
            usage = (json.loads(events[-2]).get("usage", {})
                     if len(events) > 1 else {})
            if status != 200 or events[-1:] != [b"[DONE]"]:
                fail(f"streamed chat {i}: status {status}, events "
                     f"{events[-2:]!r}")
            got = usage.get("completion_tokens")
            ttfts.append(first)
        else:
            status, data, _ = ans
            if status != 200:
                fail(f"completion {i} returned {status}: {data[:300]!r}")
            got = json.loads(data)["usage"]["completion_tokens"]
        if got != body["max_tokens"]:
            fail(f"request {i} answered {got} tokens of {body['max_tokens']}")
        n_tokens += got
    if min(launches.values()) <= 0:
        fail(f"a kernel of the batched path was never launched: {launches}")
    check_cache_writes(launches, steps.runs, layers, "batched")
    if len(records) != len(reqs) or foreign_modules():
        fail(f"{len(records)} batcher requests for {len(reqs)} HTTP "
             f"requests, or foreign modules imported: {foreign_modules()}")

    # (d) every greedy answer against one teacher-forced prefill over its
    # prompt and answer (plain attention, prefill-sized matmuls): each
    # emitted token's logit within phase 3's bound (c), 1.5% of the
    # logits' scale per sqrt(layer), of that step's largest logit
    frac = 0.015 * math.sqrt(layers)
    greedy = [(p, f.result()) for p, _, sp, f in records
              if sp is None or sp.temperature <= 0]
    worst, worst_gap, steps = 0.0, 0.0, 0
    for prompt, toks in greedy:
        gaps, scale = teacher_gaps(torch, np, bat.iface, prompt, toks)
        worst = max(worst, float(gaps.max()) / (frac * scale))
        worst_gap = max(worst_gap, float(gaps.max()))
        steps += len(toks)
    say(f"  (d) {len(greedy)} greedy answers ({steps} tokens) against "
        f"teacher-forced prefills: worst (max logit - emitted logit) "
        f"{worst_gap:.5g}, {worst:.4g} of the bound ({frac:.1%} of each "
        f"answer's max|logit|)")
    if len(greedy) != 24 or not worst <= 1.0:
        fail("a greedy answer of the batched path disagrees with the "
             "teacher-forced prefill" if greedy else "no greedy answers")

    # (e) the greedy requests again on a fresh batcher sharing the
    # interface, all queued before start() so both runs schedule alike:
    # with the kernel, then with the plain write in its place
    def rerun():
        b = ContinuousBatcher(None, max_len=MAX_LEN, max_batch=32, chunk=16,
                              chunk_max=64, prefill_chunk=128, auto_prefix=8,
                              iface=bat.iface)
        futs = [b.submit(p, len(t)) for p, t in greedy]
        b.start()
        try:
            return [f.result(timeout=900) for f in futs]
        finally:
            b.stop()

    n0 = kv_write_pair.launches
    with_kernel = rerun()
    n_kernel = kv_write_pair.launches - n0
    misc_lowering.kv_write_pair = kv_write_pair_plain
    try:
        with_plain = rerun()
    finally:
        misc_lowering.kv_write_pair = kernel_write
    same = all(np.array_equal(a, b) for a, b in zip(with_kernel, with_plain))
    say(f"  (e) the {len(greedy)} greedy requests on a fresh batcher: "
        f"{n_kernel} kernel writes (K and V in each), then the plain write: "
        f"same tokens {same}")
    if not same or n_kernel <= 0 or kv_write_pair.launches != n0 + n_kernel:
        fail("the batched path's tokens change with the plain cache write")

    ttfts = [t for t in ttfts if t is not None]
    say(f"  information: {n_tokens} completion tokens in {served_s:.2f} s = "
        f"{n_tokens / served_s:.1f} tok/s over the phase; time to first "
        f"token of the {len(ttfts)} streamed chats: median "
        f"{statistics.median(ttfts) * 1e3:.1f} ms, p99 "
        f"{float(np.percentile(ttfts, 99)) * 1e3:.1f} ms ({layers} layers) "
        f"on {card_line()}")
    try:
        phase5_batched(torch, np, srv, bat, layers, results)
        phase10_spec_batched(torch, np, bat.iface, layers, results)
    finally:
        transforms.int8_matmul = spy.inner
        for b in srv._batchers.values():
            b.stop()
    check_quant_spy(spy, "phases 4 and 5 (batched)",
                    min_rows=bat.prefill_chunk)


def long_text(np, n: int, seed: int) -> str:
    """n characters of seeded lowercase text (n byte-tokenizer tokens)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz    "))
    return "".join(np.random.default_rng(seed).choice(letters, n))


def flash_shadow(lowering, plain, bound):
    """Install, in the Attention lowering, a flash_attention that calls
    the one installed before and holds each result against `plain` on
    the same inputs (flash_agreement_bound). Returns it; `.inner` is the
    one it wraps."""
    inner = lowering.flash_attention

    def checked(q, k, v, scale, **kw):
        got = inner(q, k, v, scale, **kw)
        err, share = worst_share(got, plain(q, k, v, scale, **kw),
                                 plain(q, k, v.abs(), scale, **kw), bound)
        checked.calls += 1
        checked.worst = max(checked.worst, share)
        checked.max_err = max(checked.max_err, err)
        return got

    checked.inner, checked.calls, checked.worst, checked.max_err = \
        inner, 0, 0.0, 0.0
    lowering.flash_attention = checked
    return checked


def phase5_direct(torch, np, iface, port: int, layers: int,
                  results) -> float:
    """Phase 5, the direct path (phase 3's model and HTTP API): a
    1,900-token prompt (bucket 2048) served with 32 greedy tokens; the
    flash_attention counter must rise; then the same decode with each
    flash_attention call held against its plain version, and with the
    plain version in place of the kernel (logits within phase 3's
    bound); time to first token with the kernel and with the plain
    version, as information. Returns the kernel's time to first token
    (ms)."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.milli.ops import attention as attn_lowering
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say("phase 5: long prompts, the direct path (phase 3's model)")
    text = long_text(np, 1900, SEED + 5)
    flash_attention.launches = 0
    r = completion(port, {"prompt": text, "max_tokens": 32,
                          "temperature": 0})
    n_flash = flash_attention.launches
    got = r["usage"]["completion_tokens"]
    say(f"  1900-token prompt served: {got} tokens, flash_attention "
        f"launches {n_flash} ({layers} layers, one prefill)")
    if got != 32:
        fail(f"the long prompt answered {got} tokens of 32")
    if n_flash <= 0:
        fail("flash_attention was not launched by the long-prompt prefill")
    for res in results:
        if res["name"] == "flash_attention":
            res["launches_long_direct"] = n_flash
    tok = ByteTokenizer()
    prompt = np.asarray(tok.encode(text), np.int64)[None]
    checked = flash_shadow(attn_lowering, flash_attention_plain,
                           flash_agreement_bound)
    try:
        toks, logits = iface.generate_with_logits(prompt, 32)
    finally:
        attn_lowering.flash_attention = checked.inner
    if tok.decode(list(toks[0])) != r["choices"][0]["text"]:
        fail("the interface's greedy tokens differ from the HTTP text")
    attn_lowering.flash_attention = flash_attention_plain
    try:
        toks_p, logits_p = iface.generate_with_logits(prompt, 32)
    finally:
        attn_lowering.flash_attention = checked.inner
    differ = np.nonzero(toks[0] != toks_p[0])[0]
    n_same = int(differ[0]) + 1 if differ.size else 32
    scale = float(np.abs(logits).max())
    frac = 0.015 * math.sqrt(layers)
    diff = float(np.abs(logits_p[:, :n_same] - logits[:, :n_same]).max())
    say(f"  {checked.calls} flash_attention calls of the greedy decode "
        f"against the plain version on their inputs: worst |err|/bound "
        f"{checked.worst:.4g} (max |err| {checked.max_err:.5g})")
    say(f"  plain flash_attention in place of the kernel: logits of "
        f"{n_same} steps differ by at most {diff:.5g} ({diff / scale:.3%} "
        f"of max|logit| {scale:.4g}; bound {frac * scale:.5g}, phase 3's), "
        f"same tokens: {not differ.size}")
    if checked.calls <= 0 or not checked.worst <= 1.0:
        fail("a flash_attention call of the long prompt disagrees with its "
             "plain version on the same inputs")
    if not diff <= frac * scale:
        fail("the long prompt's logits with the plain flash_attention "
             "disagree with the kernel path's")
    ttft = {}
    for name, fn in (("kernel", checked.inner), ("plain",
                                                 flash_attention_plain),
                     ("kernel again", checked.inner)):
        attn_lowering.flash_attention = fn
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iface.generate_tokens(prompt, 1)
            ttft[name] = (time.perf_counter() - t0) * 1e3
        finally:
            attn_lowering.flash_attention = checked.inner
    say(f"  information: time to first token of the 1900-token prompt "
        f"(bucket 2048, {layers} layers): kernel {ttft['kernel']:.1f} ms, "
        f"plain version {ttft['plain']:.1f} ms, kernel again "
        f"{ttft['kernel again']:.1f} ms, on {card_line()}")
    return ttft["kernel"]


def phase5_batched(torch, np, srv, bat, layers: int, results) -> None:
    """Phase 5, the batched path (phase 4's batcher, prefill pieces of
    128): four concurrent prompts of 500 to 1,900 tokens over HTTP, every
    flash_attention call held against its plain version on its inputs;
    the counter must rise, every request answer in full, and each answer
    stand a teacher-forced prefill (phase 4's check (d))."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.milli.ops import attention as attn_lowering
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    say("phase 5: long prompts, the batched path (phase 4's batcher, "
        f"prefill pieces of {bat.prefill_chunk})")
    lengths = (500, 900, 1400, 1900)
    texts = [long_text(np, n, SEED + 6 + n) for n in lengths]
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    answers = [None] * len(texts)
    records, submit = [], bat.submit

    def recorded(prompt_ids, n_new, **kw):
        fut = submit(prompt_ids, n_new, **kw)
        records.append((np.asarray(prompt_ids, np.int64).reshape(-1), fut))
        return fut

    def client(i):
        answers[i] = request(api.port, "/v1/completions", {
            "prompt": texts[i], "max_tokens": 16, "temperature": 0})

    checked = flash_shadow(attn_lowering, flash_attention_plain,
                           flash_agreement_bound)
    bat.submit = recorded
    try:
        flash_attention.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        served_s = time.perf_counter() - t0
        n_flash = flash_attention.launches
    finally:
        attn_lowering.flash_attention = checked.inner
        bat.submit = submit
        api.stop()
    say(f"  {len(texts)} prompts of {lengths} tokens served in "
        f"{served_s:.2f} s; flash_attention launches {n_flash}; "
        f"{checked.calls} calls against the plain version on their inputs: "
        f"worst |err|/bound {checked.worst:.4g} (max |err| "
        f"{checked.max_err:.5g})")
    for res in results:
        if res["name"] == "flash_attention":
            res["launches_long_batched"] = n_flash
    if n_flash <= 0:
        fail("flash_attention was not launched by the batched long prompts")
    if not checked.worst <= 1.0:
        fail("a flash_attention call of the batched long prompts disagrees "
             "with its plain version on the same inputs")
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200:
            fail(f"long prompt {i} got no answer or an error: "
                 f"{None if ans is None else ans[1][:300]!r}")
        got = json.loads(ans[1])["usage"]["completion_tokens"]
        if got != 16:
            fail(f"long prompt {i} answered {got} tokens of 16")
    if len(records) != len(texts):
        fail(f"{len(records)} batcher requests for {len(texts)} prompts")
    frac = 0.015 * math.sqrt(layers)
    worst = 0.0
    for prompt, fut in records:
        gaps, scale = teacher_gaps(torch, np, bat.iface, prompt,
                                   fut.result())
        worst = max(worst, float(gaps.max()) / (frac * scale))
    say(f"  answers against teacher-forced prefills: worst (max logit - "
        f"emitted logit) {worst:.4g} of the bound ({frac:.1%} of max|logit|)")
    if not worst <= 1.0:
        fail("a batched long-prompt answer disagrees with the "
             "teacher-forced prefill")


# ---------------------------------------------------------------------------
def packed_shadow(torch, lowering, bound):
    """Install, in the PackedMatMul lowering's module, a packed_matmul
    that calls the one installed before and holds each result against
    the plain version on the same inputs (`bound`, with |x| @ |W| as the
    magnitude). Returns it; `.inner` is the one it wraps."""
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul_plain)

    inner = lowering.packed_matmul

    def checked(x, q, s, o, bits, has_off=True):
        got = inner(x, q, s, o, bits, has_off)
        err, share = worst_share(
            got, packed_matmul_plain(x, q, s, o, bits, has_off),
            packed_magnitude(torch, x, q, s, o, bits, has_off), bound)
        checked.calls += 1
        checked.worst = max(checked.worst, share)
        checked.max_err = max(checked.max_err, err)
        return got

    checked.inner, checked.calls, checked.worst, checked.max_err = \
        inner, 0, 0.0, 0.0
    lowering.packed_matmul = checked
    return checked


def int8_shadow(lowering, bound):
    """Install, in the QuantMatMul lowering's module, an int8_matmul that
    calls the one installed before and holds each result against the
    plain version on the same inputs (`bound`, with |x| @ |W| as the
    magnitude). Returns it; `.inner` is the one it wraps."""
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul_plain)

    inner = lowering.int8_matmul

    def checked(x, w, s):
        got = inner(x, w, s)
        err, share = worst_share(got, int8_matmul_plain(x, w, s),
                                 int8_matmul_plain(x.float().abs(), w.abs(),
                                                   s), bound)
        checked.calls += 1
        checked.worst = max(checked.worst, share)
        checked.max_err = max(checked.max_err, err)
        checked.shapes.add(tuple(w.shape))
        return got

    checked.inner, checked.calls, checked.worst, checked.max_err = \
        inner, 0, 0.0, 0.0
    checked.shapes = set()
    lowering.int8_matmul = checked
    return checked


def phase6a(torch, np, ckpt: Path, layers: int, results, int8: dict) -> dict:
    """Phase 6a: phase 3's checkpoint host-quantized to q4_0 on the direct
    path, phase 3's requests and checks (a)-(c) with packed_matmul in the
    place of decode_attention, and the rates against phase 3's int8.
    Returns the q4_0 rates (direct_rates)."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul, packed_matmul_plain)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say(f"phase 6a: the direct path, host-quantized q4_0; host RSS "
        f"{host_rss_gb():.1f} GB after phase 4 was freed")
    srv = Server()
    iface = load_direct(torch, srv, ckpt, "q4_0")
    say(f"  {len(iface._packed)} packed weights, "
        f"{len(iface.weight_names) - 3 * len(iface._packed)} dense inputs")
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        r1, launches, _ = serve_three(np, api.port, iface, {
            "packed_matmul": packed_matmul, "int8_matmul": int8_matmul,
            "decode_attention": decode_attention,
            "flash_attention": flash_attention}, layers)
        for res in results:
            if res["name"] in launches:
                res["launches_q4_0_direct"] = launches[res["name"]]
        if launches["int8_matmul"] or min(
                n for k, n in launches.items() if k != "int8_matmul") <= 0:
            fail(f"the q4_0 direct path did not go through packed_matmul "
                 f"alone: {launches}")
        prompt = decode_checks(
            np, iface, r1["choices"][0]["text"], layers, "packed_matmul",
            transforms, "packed_matmul",
            lambda: packed_shadow(torch, transforms, agreement_bound),
            packed_matmul_plain)
        packed_matmul.launches = 0
        iface.generate_tokens(prompt, 2)       # a prefill and a step
        per_forward = packed_matmul.launches / 2
        say(f"  packed_matmul launches per forward: {per_forward:g} (4 per "
            f"layer + lm_head = {4 * layers + 1})")
        if per_forward != 4 * layers + 1:
            fail("a forward did not launch packed_matmul for every weight")
        rates = direct_rates(torch, iface, prompt, layers)
        profile_decode(torch, iface, prompt, "q4_0")
        say(f"  information: q4_0 against phase 3's int8: time to first "
            f"token {rates['ttft_ms']:.1f} against {int8['ttft_ms']:.1f} "
            f"ms, decode {rates['tok_s']:.1f} against {int8['tok_s']:.1f} "
            f"tok/s, {rates['gb']:.2f} against {int8['gb']:.2f} GB on the "
            f"card")
        # phase 5's long prompt: its prefill runs the kernel at 2048 rows,
        # every call held against the plain version on its inputs
        long = np.asarray(ByteTokenizer().encode(
            long_text(np, 1900, SEED + 5)), np.int64)[None]
        checked = packed_shadow(torch, transforms, agreement_bound)
        packed_matmul.launches = 0
        try:
            iface.generate_tokens(long, 1)
        finally:
            transforms.packed_matmul = checked.inner
        n_long = packed_matmul.launches
        say(f"  the 1900-token prompt's prefill (bucket 2048) at q4_0: "
            f"{n_long} packed_matmul launches, {checked.calls} calls "
            f"against the plain version on their inputs: worst |err|/bound "
            f"{checked.worst:.4g} (max |err| {checked.max_err:.5g})")
        if n_long <= 0 or checked.calls != n_long or not checked.worst <= 1.0:
            fail("the long prompt's packed_matmul calls at 2048 rows did not "
                 "all launch the kernel within agreement_bound")
        for res in results:
            if res["name"] == "packed_matmul":
                res["launches_long_q4_0"] = n_long
        ttft = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iface.generate_tokens(long, 1)
            ttft.append((time.perf_counter() - t0) * 1e3)
        say(f"  information: time to first token of phase 5's 1900-token "
            f"prompt at q4_0: {ttft[0]:.1f} ms, again {ttft[1]:.1f} ms, "
            f"against int8's {int8['long_ttft_ms']:.1f} ms (phase 5, this "
            f"run) on {card_line()}")
    finally:
        api.stop()
    return rates


GGUF_NAMES = {"input_layernorm": "attn_norm",
              "post_attention_layernorm": "ffn_norm",
              "self_attn.q_proj": "attn_q", "self_attn.k_proj": "attn_k",
              "self_attn.v_proj": "attn_v", "self_attn.o_proj": "attn_output",
              "mlp.gate_proj": "ffn_gate", "mlp.up_proj": "ffn_up",
              "mlp.down_proj": "ffn_down"}


def write_smoke_gguf(path: Path, layers: int, np, bf16) -> None:
    """The smoke checkpoint's weights (rounded to the checkpoint's bf16)
    as an arch-llama GGUF written by the port's write_gguf the way
    llama.cpp's converter writes one: Q/K rows permuted for GGML's
    interleaved rope (LlamaModel.permute); Q4_K for attn_q/k/v/output,
    ffn_gate/up and token_embd, Q6_K for ffn_down and output, F32
    norms."""
    from whisper_tensor_tpu_torch.backends.cpu.dequant import quantize_blocks
    from whisper_tensor_tpu_torch.importers.gguf import write_gguf
    from whisper_tensor_tpu_torch.packed_format import PackedFormat
    from whisper_tensor_tpu_torch.tensor import PackedTensor

    Hq, Hkv = WIDTHS["num_attention_heads"], WIDTHS["num_key_value_heads"]
    tensors = {}
    for n, arr in checkpoint_tensors(layers, np):
        if bf16 is not None:
            arr = arr.astype(bf16).astype(np.float32)
        if n.startswith("model.layers."):
            i, leaf = n[len("model.layers."):].split(".", 1)
            leaf = GGUF_NAMES[leaf[:-len(".weight")]]
            name = f"blk.{i}.{leaf}.weight"
            heads = {"attn_q": Hq, "attn_k": Hkv}.get(leaf)
            if heads:
                arr = arr.reshape(heads, 2, -1, arr.shape[1]).swapaxes(
                    1, 2).reshape(arr.shape)
        else:
            name = {"model.embed_tokens.weight": "token_embd.weight",
                    "model.norm.weight": "output_norm.weight",
                    "lm_head.weight": "output.weight"}[n]
        if arr.ndim == 1:
            tensors[name] = arr
            continue
        fmt = (PackedFormat.Q6_K if name.endswith(("ffn_down.weight",
                                                   "output.weight"))
               else PackedFormat.Q4_K)
        # the output rows past the byte tokenizer's ids are zero: the
        # K-quant writers divide 0 by a zero scale there, and the blocks
        # they write still dequantize to zeros
        with np.errstate(invalid="ignore", divide="ignore"):
            tensors[name] = PackedTensor(quantize_blocks(arr, fmt), fmt,
                                         arr.shape)
        del arr
    meta = {"general.architecture": "llama",
            "general.name": f"llama3-8b-widths-{layers}L",
            "llama.block_count": layers,
            "llama.embedding_length": WIDTHS["hidden_size"],
            "llama.attention.head_count": Hq,
            "llama.attention.head_count_kv": Hkv,
            "llama.feed_forward_length": WIDTHS["intermediate_size"],
            "llama.context_length": WIDTHS["max_position_embeddings"],
            "llama.vocab_size": WIDTHS["vocab_size"],
            "llama.attention.layer_norm_rms_epsilon": WIDTHS["rms_norm_eps"],
            "llama.rope.freq_base": WIDTHS["rope_theta"]}
    write_gguf(str(path), meta, tensors)


def phase6b(torch, np, gguf_path: Path, layers: int, results) -> None:
    """Phase 6b: the GGUF file through GgufLoader with ragged_decode (16
    slots, prefill pieces of 128) and 16 concurrent HTTP requests; the
    packed and attention kernels' counters must rise; (d) each greedy
    answer against a teacher-forced prefill; (f) one greedy answer
    against the same file loaded host-dequantized (dense)."""
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    say(f"phase 6b: the batched path, GGUF; host RSS {host_rss_gb():.1f} GB "
        f"after phase 6a was freed")
    cfg = {"path": str(gguf_path), "dtype": "bf16", "max_len": MAX_LEN,
           "ragged_decode": True, "serve_batch": 16, "serve_chunk": 16,
           "serve_chunk_max": 64, "prefill_chunk": 128}
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("gguf", cfg)
    say(f"  GgufLoader (packed, structure-only ONNX): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bat = srv._batcher(entry)
    bat.iface._weights()
    torch.cuda.synchronize()
    say(f"  batcher interface (repack + upload): "
        f"{time.perf_counter() - t0:.1f} s, {len(bat.iface._packed)} packed "
        f"weights, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
        f"card, peak host RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB")
    records, submit = [], bat.submit

    def recorded(prompt_ids, n_new, **kw):
        fut = submit(prompt_ids, n_new, **kw)
        records.append((np.asarray(prompt_ids, np.int64).reshape(-1),
                        kw.get("sampling"), fut))
        return fut

    rng = np.random.default_rng(SEED + 7)
    lengths = (5, 9, 14, 20, 31, 45, 70, 110, 150, 190, 230, 270, 300, 340,
               370, 400)
    reqs = []
    for i, n in enumerate(lengths):
        body = {"prompt": long_text(np, n, SEED + 100 + i),
                "max_tokens": int(rng.integers(8, 49)), "temperature": 0}
        if i % 4 == 2:                     # 4 of the 16 sampled
            body.update(temperature=0.8, top_k=40, seed=200 + i)
        reqs.append(body)
    answers = [None] * len(reqs)
    counters = {"packed_matmul": packed_matmul, "int8_matmul": int8_matmul,
                "decode_attention": decode_attention,
                "ragged_kv_write": ragged_kv_write,
                "kv_write_pair": kv_write_pair,
                "flash_attention": flash_attention}
    bat.submit = recorded
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    steps = count_steps(bat.iface)
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, request(api.port, "/v1/completions", reqs[i])))
            for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        served_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        del bat.iface.step
        bat.submit = submit
        api.stop()
    n_tokens = 0
    for i, (body, ans) in enumerate(zip(reqs, answers)):
        if ans is None or ans[0] != 200:
            fail(f"GGUF request {i} got no answer or an error: "
                 f"{None if ans is None else ans[1][:300]!r}")
        got = json.loads(ans[1])["usage"]["completion_tokens"]
        if got != body["max_tokens"]:
            fail(f"GGUF request {i} answered {got} tokens of "
                 f"{body['max_tokens']}")
        n_tokens += got
    st = bat.stats()
    say(f"  {len(reqs)} requests served in {served_s:.2f} s: "
        f"{st['chunks_dispatched']} chunks, {st['steps_dispatched']} steps; "
        f"kernel launches during them: {launches}")
    for res in results:
        if res["name"] == "packed_matmul":
            res["launches"] = launches["packed_matmul"]
        elif res["name"] in launches:
            res["launches_gguf_batched"] = launches[res["name"]]
    if launches["int8_matmul"] or min(
            n for k, n in launches.items() if k != "int8_matmul") <= 0:
        fail(f"a kernel of the GGUF batched path was never launched, or "
             f"int8_matmul was: {launches}")
    check_cache_writes(launches, steps.runs, layers, "GGUF batched")
    if len(records) != len(reqs) or foreign_modules():
        fail(f"{len(records)} batcher requests for {len(reqs)} HTTP "
             f"requests, or foreign modules imported: {foreign_modules()}")
    # (d) every greedy answer against a teacher-forced prefill (phase 4's
    # check and bound)
    frac = 0.015 * math.sqrt(layers)
    greedy = [(p, f.result()) for p, sp, f in records
              if sp is None or sp.temperature <= 0]
    worst = 0.0
    for prompt, toks in greedy:
        gaps, scale = teacher_gaps(torch, np, bat.iface, prompt, toks)
        worst = max(worst, float(gaps.max()) / (frac * scale))
    say(f"  (d) {len(greedy)} greedy answers against teacher-forced "
        f"prefills: worst (max logit - emitted logit) {worst:.4g} of the "
        f"bound ({frac:.1%} of each answer's max|logit|)")
    if len(greedy) != 12 or not worst <= 1.0:
        fail("a greedy GGUF answer disagrees with the teacher-forced prefill")
    say(f"  information: {n_tokens} completion tokens in {served_s:.2f} s = "
        f"{n_tokens / served_s:.1f} tok/s over the phase ({layers} layers) "
        f"on {card_line()}")
    for b in srv._batchers.values():
        b.stop()
    del bat, srv, entry
    free_memory(torch)

    # (f) the longest greedy answer against the same file loaded with
    # every weight dequantized on the host (dense bf16)
    prompt, toks = max(greedy, key=lambda pt: len(pt[0]))
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("gguf", dict(cfg, packed_weights=False))
    iface = srv._text_iface(entry)
    gaps, scale = teacher_gaps(torch, np, iface, prompt, toks)
    share = float(gaps.max()) / (frac * scale)
    say(f"  (f) the {len(prompt)}-token prompt's greedy answer against the "
        f"file loaded dense ({time.perf_counter() - t0:.1f} s to load and "
        f"run, peak host RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB, "
        f"packed weights {len(iface._packed)}): worst (max logit - emitted "
        f"logit) {share:.4g} of the bound")
    if iface._packed or not share <= 1.0:
        fail("the GGUF batched answer disagrees with the dense load")


# ---------------------------------------------------------------------------
# GPT-2 124M's published widths (bench.py:138-139) and the reference's
# serving arm (bench.py:142-170): a bf16 cache of 256 positions, 64
# slots, chunks of 32 steps up to 128
GPT2_WIDTHS = dict(n_layer=12, n_head=12, n_embd=768, vocab_size=50257,
                   n_positions=1024, layer_norm_epsilon=1e-5)
GPT2_SERVE = {"dtype": "bf16", "max_len": 256, "ragged_decode": True,
              "serve_batch": 64, "serve_chunk": 32, "serve_chunk_max": 128}


def gpt2_shapes() -> dict:
    """HF name -> shape of the GPT-2 checkpoint, in file order."""
    E, V, P = (GPT2_WIDTHS[k] for k in ("n_embd", "vocab_size",
                                         "n_positions"))
    shapes = {"transformer.wte.weight": (V, E),
              "transformer.wpe.weight": (P, E)}
    for i in range(GPT2_WIDTHS["n_layer"]):
        p = f"transformer.h.{i}."
        shapes.update({p + "ln_1.weight": (E,), p + "ln_1.bias": (E,),
                       p + "attn.c_attn.weight": (E, 3 * E),
                       p + "attn.c_attn.bias": (3 * E,),
                       p + "attn.c_proj.weight": (E, E),
                       p + "attn.c_proj.bias": (E,),
                       p + "ln_2.weight": (E,), p + "ln_2.bias": (E,),
                       p + "mlp.c_fc.weight": (E, 4 * E),
                       p + "mlp.c_fc.bias": (4 * E,),
                       p + "mlp.c_proj.weight": (4 * E, E),
                       p + "mlp.c_proj.bias": (E,)})
    shapes.update({"transformer.ln_f.weight": (E,),
                   "transformer.ln_f.bias": (E,)})
    return shapes


def gpt2_tensors(np):
    """(HF name, f32 array) of the GPT-2 checkpoint, in file order: the
    matrices tile a seeded block of 2^20 + 7 normal values scaled 0.02,
    LayerNorm gains are ones and biases zeros; the rows of the tied
    embedding past the byte tokenizer's ids are zero, so greedy text
    decodes to printable bytes."""
    rng = np.random.default_rng(SEED + 10)
    for n, s in gpt2_shapes().items():
        if len(s) == 1:
            yield n, (np.ones(s, np.float32) if "ln_" in n and
                      n.endswith("weight") else np.zeros(s, np.float32))
            continue
        base = rng.standard_normal((1 << 20) + 7, dtype=np.float32) * 0.02
        arr = np.resize(base, s)
        if n == "transformer.wte.weight":
            arr[BYTE_VOCAB:] = 0.0
        yield n, arr


def write_gpt2_checkpoint(d: Path, np, bf16) -> int:
    (d / "config.json").write_text(json.dumps({
        "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
        "torch_dtype": "bfloat16" if bf16 else "float16", **GPT2_WIDTHS}))
    return write_safetensors(d, gpt2_shapes(), gpt2_tensors(np), np, bf16)


def phase7(torch, np, ckpt: Path, results) -> None:
    """Phase 7: GPT-2 124M widths (12 layers, 12 heads of 64, vocab
    50,257) through the batcher, dense bf16 weights and then int8: 64
    concurrent greedy requests over HTTP (prompts of 8 to 32 tokens, 32
    new tokens each). Every answer must arrive in full; decode_attention
    and flash_attention must launch, at head dim 64 only, and
    ragged_kv_write; with int8, every QuantMatMul call must launch
    int8_matmul once, the (768, 50,257) tied head among them; (d) every
    answer must stand a teacher-forced prefill. tok/s as information."""
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.milli.ops import attention as attn_lowering
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    layers = GPT2_WIDTHS["n_layer"]
    rng = np.random.default_rng(SEED + 11)
    reqs = [{"prompt": long_text(np, int(rng.integers(8, 33)), SEED + 400 + i),
             "max_tokens": 32, "temperature": 0} for i in range(64)]
    counters = {"decode_attention": decode_attention,
                "flash_attention": flash_attention,
                "ragged_kv_write": ragged_kv_write,
                "kv_write_pair": kv_write_pair,
                "int8_matmul": int8_matmul}
    frac = 0.015 * math.sqrt(layers)
    for quantize in ("", "int8"):
        label = quantize or "bf16"
        say(f"phase 7 ({label} weights): GPT-2 124M widths through the "
            f"batcher; host RSS {host_rss_gb():.1f} GB")
        srv = Server()
        t0 = time.perf_counter()
        (entry,) = srv.models.run_loader("transformers", {
            "path": str(ckpt), **GPT2_SERVE, "quantize": quantize})
        bat = srv._batcher(entry)
        bat.iface._weights()
        torch.cuda.synchronize()
        say(f"  loader and batcher interface: "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{len(bat.iface._quantized)} int8 weights, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        records, submit = [], bat.submit

        def recorded(prompt_ids, n_new, **kw):
            fut = submit(prompt_ids, n_new, **kw)
            records.append((np.asarray(prompt_ids, np.int64).reshape(-1),
                            fut))
            return fut

        dims = {"decode_attention": set(), "flash_attention": set()}
        inner_dec = attn_lowering.decode_attention
        inner_flash = attn_lowering.flash_attention

        def dec(q, k, v, pos, scale):
            dims["decode_attention"].add(q.shape[-1])
            return inner_dec(q, k, v, pos, scale)

        def flash(q, k, v, scale, **kw):
            dims["flash_attention"].add(q.shape[-1])
            return inner_flash(q, k, v, scale, **kw)

        answers = [None] * len(reqs)
        bat.submit = recorded
        attn_lowering.decode_attention = dec
        attn_lowering.flash_attention = flash
        spy = quant_spy(transforms)
        api = OpenAIApi(srv, "127.0.0.1", 0).start()
        steps = count_steps(bat.iface)
        try:
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            threads = [threading.Thread(
                target=lambda i=i: answers.__setitem__(
                    i, request(api.port, "/v1/completions", reqs[i])))
                for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            served_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
        finally:
            del bat.iface.step
            attn_lowering.decode_attention = inner_dec
            attn_lowering.flash_attention = inner_flash
            transforms.int8_matmul = spy.inner
            bat.submit = submit
            api.stop()
        n_tokens = 0
        for i, ans in enumerate(answers):
            if ans is None or ans[0] != 200:
                fail(f"GPT-2 request {i} got no answer or an error: "
                     f"{None if ans is None else ans[1][:300]!r}")
            got = json.loads(ans[1])["usage"]["completion_tokens"]
            if got != 32:
                fail(f"GPT-2 request {i} answered {got} tokens of 32")
            n_tokens += got
        st = bat.stats()
        say(f"  {len(reqs)} requests served in {served_s:.2f} s: "
            f"{st['chunks_dispatched']} chunks, {st['steps_dispatched']} "
            f"steps; kernel launches during them: {launches}; head dims "
            f"seen: {dims}")
        for res in results:
            if res["name"] in launches:
                res[f"launches_gpt2_{label}"] = launches[res["name"]]
        check_cache_writes(launches, steps.runs, layers, f"GPT-2 {label}")
        if min(launches[k] for k in ("decode_attention", "flash_attention",
                                     "ragged_kv_write")) <= 0 \
                or dims != {"decode_attention": {64},
                            "flash_attention": {64}}:
            fail(f"GPT-2's attention did not go through the kernels at head "
                 f"dim 64: {launches}, {dims}")
        if quantize:
            check_quant_spy(spy, "phase 7 (int8)")
            if launches["int8_matmul"] != spy.calls or \
                    (GPT2_WIDTHS["n_embd"], GPT2_WIDTHS["vocab_size"]) \
                    not in spy.shapes:
                fail(f"int8_matmul did not launch for every QuantMatMul call "
                     f"or not on the (768, 50257) head: {spy.shapes}")
        elif launches["int8_matmul"] or spy.calls:
            fail(f"the dense GPT-2 launched int8_matmul: {launches}")
        if len(records) != len(reqs) or foreign_modules():
            fail(f"{len(records)} batcher requests for {len(reqs)} HTTP "
                 f"requests, or foreign modules imported: "
                 f"{foreign_modules()}")
        # (d) every greedy answer against a teacher-forced prefill (phase
        # 4's check and bound)
        worst = 0.0
        for prompt, fut in records:
            gaps, scale = teacher_gaps(torch, np, bat.iface, prompt,
                                       fut.result())
            worst = max(worst, float(gaps.max()) / (frac * scale))
        say(f"  (d) {len(records)} greedy answers against teacher-forced "
            f"prefills: worst (max logit - emitted logit) {worst:.4g} of "
            f"the bound ({frac:.1%} of each answer's max|logit|)")
        if not worst <= 1.0:
            fail("a greedy GPT-2 answer disagrees with the teacher-forced "
                 "prefill")
        say(f"  information: {n_tokens} completion tokens in {served_s:.2f} "
            f"s = {n_tokens / served_s:.1f} tok/s over the phase "
            f"({label} weights, {layers} layers) on {card_line()}")
        for b in srv._batchers.values():
            b.stop()
        del bat, srv, entry
        free_memory(torch)


# ---------------------------------------------------------------------------
# phase 9: a GPTQ checkpoint of the smoke weights through the batcher
GPTQ_GROUP = 128
GPTQ_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                "mlp.down_proj")


def write_gptq_checkpoint(d: Path, layers: int, torch, np, bf16) -> int:
    """The smoke checkpoint's weights as a GPTQ checkpoint: every Linear
    of the layers 4-bit in groups of 128 along K, asymmetric (min/max
    per group and column, the zero point clamped to 1..15 as the classic
    zeros-1 format needs), packed by the port's pack_gptq; desc_act off;
    embeddings, norms and lm_head dense (bf16, or f16 without
    ml_dtypes). The quantization runs on the card. Returns the bytes."""
    from whisper_tensor_tpu_torch.importers.quantized import (QuantSpec,
                                                              pack_gptq)

    spec = QuantSpec("gptq", 4, GPTQ_GROUP)
    arrays = {}
    for n, arr in checkpoint_tensors(layers, np):
        mod = n[:-len(".weight")]
        if not mod.endswith(GPTQ_LINEARS):
            arrays[n] = arr.astype(bf16 if bf16 is not None else np.float16)
            continue
        w = torch.from_numpy(arr).cuda().T.contiguous()          # (K, N)
        K, N = w.shape
        g = w.reshape(K // GPTQ_GROUP, GPTQ_GROUP, N)
        lo, hi = g.amin(1), g.amax(1)
        scale = ((hi - lo) / 15).clamp_min(1e-6).half().float()
        zero = torch.round(-lo / scale).clamp(1, 15)
        q = (torch.round(g / scale[:, None]) + zero[:, None]).clamp(0, 15)
        packed = pack_gptq(q.to(torch.uint8).reshape(K, N).cpu().numpy(),
                           zero.cpu().numpy(), scale.cpu().numpy(), spec)
        for leaf, a in zip(("qweight", "qzeros", "scales"), packed):
            arrays[f"{mod}.{leaf}"] = a
        del w, g, q, arr
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"],
        "num_hidden_layers": layers, "tie_word_embeddings": False,
        "torch_dtype": "float16", **WIDTHS, "quantization_config": {
            "quant_method": "gptq", "bits": 4, "group_size": GPTQ_GROUP,
            "desc_act": False, "sym": False, "checkpoint_format": "gptq"}}))
    codes = {np.dtype(np.int32): "I32", np.dtype(np.float16): "F16"}
    if bf16 is not None:
        codes[np.dtype(bf16)] = "BF16"
    header, off = {}, 0
    for n, a in arrays.items():
        header[n] = {"dtype": codes[a.dtype], "shape": list(a.shape),
                     "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(d / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for a in arrays.values():
            f.write(np.ascontiguousarray(a).tobytes())
    return off


def packed_spy(transforms):
    """Install, in the PackedMatMul lowering's module, a packed_matmul
    that calls the one installed before and counts the lowering's calls
    (from every thread: the batcher's and the HTTP threads' direct
    requests). Returns it; `.inner` is the one it wraps."""
    inner = transforms.packed_matmul
    lock = threading.Lock()

    def spy(x, q, s, o, bits, has_off=True):
        with lock:
            spy.calls += 1
        return inner(x, q, s, o, bits, has_off)

    spy.inner, spy.calls = inner, 0
    transforms.packed_matmul = spy
    return spy


def phase9(torch, np, ckpt: Path, layers: int, results, q4_0: dict) -> None:
    """Phase 9: the GPTQ checkpoint through the port's TransformersLoader
    with ragged_decode (16 slots, pieces of 128): one PackedMatMul node
    per quantized Linear (gate/up and q/k/v fused); 16 concurrent
    completions (12 greedy, 4 sampled) with a constrained request and an
    embeddings request among them; every PackedMatMul call of the
    lowering launches the kernel, int8_matmul never; (d) each greedy
    answer stands a teacher-forced prefill; one prompt's logits stand
    those of the checkpoint's dequantized dense weights."""
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import kv_write_pair
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say(f"phase 9: a GPTQ checkpoint (4-bit, groups of {GPTQ_GROUP}) through "
        f"the batcher; host RSS {host_rss_gb():.1f} GB")
    cfg = {"path": str(ckpt), "dtype": "bf16", "max_len": MAX_LEN,
           "ragged_decode": True, "serve_batch": 16, "serve_chunk": 16,
           "serve_chunk_max": 64, "prefill_chunk": 128}
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("transformers", cfg)
    store = entry.model.graph.store
    say(f"  TransformersLoader (GPTQ, dequantized on the host for the "
        f"recipe): {time.perf_counter() - t0:.1f} s, "
        f"{len(store.packed_sources)} packed sources")
    t0 = time.perf_counter()
    bat = srv._batcher(entry)
    iface = bat.iface
    iface._weights()
    torch.cuda.synchronize()
    kinds = [node.op.KIND for node in iface._exec.graph.nodes]
    covered = set()
    for name in iface._packed:
        covered.update([m for m, _ in iface._fused[name]]
                       if name in iface._fused else [name])
    say(f"  batcher interface (repack + upload): "
        f"{time.perf_counter() - t0:.1f} s, {len(iface._packed)} packed "
        f"nodes covering {len(covered)} quantized Linears, "
        f"{kinds.count('PackedMatMul')} PackedMatMul nodes, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    if (len(store.packed_sources) != 7 * layers
            or covered != set(store.packed_sources)
            or kinds.count("PackedMatMul") != len(iface._packed)
            or len(iface._packed) != 4 * layers or "QuantMatMul" in kinds):
        fail("the GPTQ model's quantized Linears are not each in one "
             "PackedMatMul node")
    records, submit = [], bat.submit

    def recorded(prompt_ids, n_new, **kw):
        fut = submit(prompt_ids, n_new, **kw)
        records.append((np.asarray(prompt_ids, np.int64).reshape(-1),
                        kw.get("sampling"), fut))
        return fut

    rng = np.random.default_rng(SEED + 9)
    lengths = (5, 9, 14, 20, 31, 45, 70, 110, 150, 190, 230, 270, 300, 340,
               370, 400)
    reqs = []
    for i, n in enumerate(lengths):
        body = {"prompt": long_text(np, n, SEED + 300 + i),
                "max_tokens": int(rng.integers(8, 49)), "temperature": 0}
        if i % 4 == 1:                     # 4 of the 16 sampled
            body.update(temperature=0.8, top_k=40, seed=300 + i)
        reqs.append(("/v1/completions", body))
    reqs.append(("/v1/completions", {"prompt": GREEDY["prompt"],
                                     "max_tokens": 48, "temperature": 0,
                                     "regex": REGEX}))
    reqs.append(("/v1/embeddings", {"input": EMBED_INPUTS}))
    answers = [None] * len(reqs)
    counters = {"packed_matmul": packed_matmul, "int8_matmul": int8_matmul,
                "decode_attention": decode_attention,
                "kv_write_pair": kv_write_pair,
                "flash_attention": flash_attention}
    bat.submit = recorded
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    spy = packed_spy(transforms)
    try:
        zero(counters)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, request(api.port, *reqs[i]))) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        served_s = time.perf_counter() - t0
        launches = rose(counters, "the GPTQ batched path", (
            "packed_matmul", "decode_attention", "kv_write_pair",
            "flash_attention"))
    finally:
        transforms.packed_matmul = spy.inner
        bat.submit = submit
        api.stop()
    say(f"  packed_matmul: {spy.calls} PackedMatMul calls of the lowering, "
        f"{launches['packed_matmul']} kernel launches; int8_matmul "
        f"{launches['int8_matmul']}")
    if (launches["int8_matmul"] or spy.calls <= 0
            or spy.calls != launches["packed_matmul"]):
        fail("the GPTQ path's PackedMatMul calls did not each launch the "
             "kernel once, or int8_matmul was launched")
    for res in results:
        if res["name"] in launches:
            res["launches_gptq_batched"] = launches[res["name"]]
    n_tokens = 0
    for i, ((path, body), ans) in enumerate(zip(reqs, answers)):
        if ans is None or ans[0] != 200:
            fail(f"GPTQ request {i} got no answer or an error: "
                 f"{None if ans is None else ans[1][:300]!r}")
        r = json.loads(ans[1])
        if path == "/v1/embeddings":
            norms = [float(np.linalg.norm(d["embedding"])) for d in r["data"]]
            if max(abs(n - 1) for n in norms) > 1e-5:
                fail(f"GPTQ embeddings are not unit vectors: {norms}")
            continue
        if "regex" in body:
            text = r["choices"][0]["text"]
            say(f"  the constrained request among them: {text!r}")
            if (r["choices"][0]["finish_reason"] != "stop"
                    or not re.fullmatch(REGEX, text)):
                fail("the GPTQ constrained request did not finish inside "
                     "its language")
            continue
        got = r["usage"]["completion_tokens"]
        if got != body["max_tokens"]:
            fail(f"GPTQ request {i} answered {got} tokens of "
                 f"{body['max_tokens']}")
        n_tokens += got
    if len(records) != 16 or foreign_modules():
        fail(f"{len(records)} batcher requests for 16 completions, or foreign "
             f"modules imported: {foreign_modules()}")
    frac = 0.015 * math.sqrt(layers)
    greedy = [(p, f.result()) for p, sp, f in records
              if sp is None or sp.temperature <= 0]
    worst = 0.0
    for prompt, toks in greedy:
        gaps, scale = teacher_gaps(torch, np, iface, prompt, toks)
        worst = max(worst, float(gaps.max()) / (frac * scale))
    say(f"  (d) {len(greedy)} greedy answers against teacher-forced "
        f"prefills: worst (max logit - emitted logit) {worst:.4g} of the "
        f"bound ({frac:.1%} of each answer's max|logit|); {n_tokens} "
        f"completion tokens in {served_s:.2f} s")
    if len(greedy) != 12 or not worst <= 1.0:
        fail("a greedy GPTQ answer disagrees with the teacher-forced prefill")
    for b in srv._batchers.values():
        b.stop()
    prompt = np.asarray(ByteTokenizer().encode(GREEDY["prompt"]),
                        np.int64)[None]
    rates = direct_rates(torch, iface, prompt, layers)
    profile_decode(torch, iface, prompt, "GPTQ")
    say(f"  information: GPTQ decode {rates['tok_s']:.1f} tok/s against "
        f"phase 6a's q4_0 {q4_0['tok_s']:.1f} (batch 1, {layers} layers), "
        f"{rates['gb']:.2f} against {q4_0['gb']:.2f} GB on the card")
    # the same checkpoint's dequantized dense weights (the recipe's
    # initializers): an interface without packed sources runs them
    packed_logits = iface.logits(prompt).astype(np.float32)
    saved = dict(store.packed_sources)
    store.packed_sources.clear()
    try:
        dense = TextInferenceInterface(entry.model, max_len=MAX_LEN,
                                       cache_dtype=DType.BF16)
    finally:
        store.packed_sources.update(saved)
    dense_logits = dense.logits(prompt).astype(np.float32)
    scale = float(np.abs(dense_logits).max())
    diff = float(np.abs(packed_logits - dense_logits).max())
    say(f"  the prompt's logits, packed against the dequantized dense "
        f"weights ({len(dense._packed)} packed): max |diff| {diff:.5g} "
        f"({diff / scale:.3%} of max|logit| {scale:.4g}; bound {frac:.1%})")
    if dense._packed or not diff <= frac * scale:
        fail("the GPTQ model's logits disagree with its dequantized weights'")


# ---------------------------------------------------------------------------
# phase 10: LoRA adapters, speculative decoding, the profiler
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")
LORA_R, LORA_ALPHA = 16, 32


class WSClient:
    """A client of the port's WebSocket server (RFC 6455 text frames,
    masked), enough for the protocol's JSON messages."""

    def __init__(self, port: int):
        import base64
        import os
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=900)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            f"GET / HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += self.sock.recv(4096)
        if b" 101 " not in resp.split(b"\r\n")[0]:
            fail(f"the WebSocket upgrade was refused: {resp[:200]!r}")

    def send(self, obj) -> None:
        import os

        payload = json.dumps(obj).encode()
        head = bytearray([0x81])
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        elif n < (1 << 16):
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        mask = os.urandom(4)
        self.sock.sendall(bytes(head) + mask + bytes(
            b ^ mask[i % 4] for i, b in enumerate(payload)))

    def recv(self) -> dict:
        def exact(n):
            out = b""
            while len(out) < n:
                chunk = self.sock.recv(n - len(out))
                if not chunk:
                    fail("the WebSocket server closed the connection")
                out += chunk
            return out

        head = exact(2)
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", exact(8))[0]
        return json.loads(exact(n))

    def until(self, *types) -> dict:
        """The next message of one of `types`; a job_error fails."""
        while True:
            r = self.recv()
            if r["type"] in types:
                return r
            if r["type"] == "job_error":
                fail(f"the WebSocket server answered an error: {r}")

    def close(self) -> None:
        self.sock.close()


def ws_serve(srv):
    """srv's WebSocket server on a free port, in a thread of its own:
    (port, stop). stop() cancels the server's tasks, closes its loop and
    ends its report pump."""
    import asyncio
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    loop = asyncio.new_event_loop()
    main = loop.create_task(srv.run("127.0.0.1", port))

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(main)
        except asyncio.CancelledError:
            pass                      # stop()
        finally:
            rest = asyncio.all_tasks(loop)
            for task in rest:
                task.cancel()
            loop.run_until_complete(asyncio.gather(*rest,
                                                   return_exceptions=True))
            loop.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 30
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            if time.time() > deadline:
                fail("the WebSocket server did not start")
            time.sleep(0.05)

    def stop():
        srv.scheduler.reports.put(None)
        loop.call_soon_threadsafe(main.cancel)
        t.join(30)

    return port, stop


def write_adapter(d: Path, layers: int, seed: int, np, bf16) -> None:
    """A PEFT LoRA dir the way peft's save_pretrained writes one:
    adapter_config.json and adapter_model.safetensors, r 16 and alpha 32
    (scale 2) on the seven projections of every layer. A (r, in) and B
    (out, r) are seeded normals scaled 0.02 (a fresh PEFT adapter's B is
    zero; here both are random, so each adapter changes the model)."""
    E, I = WIDTHS["hidden_size"], WIDTHS["intermediate_size"]
    kv = WIDTHS["num_key_value_heads"] * E // WIDTHS["num_attention_heads"]
    dims = {"q_proj": (E, E), "k_proj": (kv, E), "v_proj": (kv, E),
            "o_proj": (E, E), "gate_proj": (I, E), "up_proj": (I, E),
            "down_proj": (E, I)}                       # (out, in)
    shapes = {}
    for i in range(layers):
        for t in LORA_TARGETS:
            block = "mlp" if t.endswith(("gate_proj", "up_proj",
                                         "down_proj")) else "self_attn"
            mod = f"base_model.model.model.layers.{i}.{block}.{t}"
            shapes[mod + ".lora_A.weight"] = (LORA_R, dims[t][1])
            shapes[mod + ".lora_B.weight"] = (dims[t][0], LORA_R)
    rng = np.random.default_rng(seed)
    write_safetensors(d, shapes, ((n, rng.standard_normal(s, np.float32)
                                   * 0.02) for n, s in shapes.items()),
                      np, bf16, "adapter_model.safetensors")
    (d / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA", "task_type": "CAUSAL_LM", "r": LORA_R,
        "lora_alpha": LORA_ALPHA, "target_modules": list(LORA_TARGETS),
        "fan_in_fan_out": False, "use_rslora": False}))


def spec_counters() -> dict:
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import kv_write_pair
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul

    return {"flash_attention": flash_attention, "int8_matmul": int8_matmul,
            "decode_attention": decode_attention,
            "kv_write_pair": kv_write_pair}


def spec_agreement(np, iface, prompts, toks, plain, layers: int,
                   what: str) -> None:
    """Greedy speculative tokens against the target's own greedy decode,
    `plain` = (tokens, per-step logits), row by row. The verify block
    (k rows through flash_attention and k-row products) and a decode
    step (one row through decode_attention) round in bf16 at different
    places, so they can pick different tokens where the two best logits
    nearly tie (phase 3's (c) measures decode against prefill logits
    within 1.5% of their scale per sqrt(layer), at an argmax agreement
    near 0.97 on these random weights). So: the tokens must be equal up
    to the first difference, and there the plain decode must rate the
    speculative token within twice that bound of its own pick (a near
    tie); and every speculative token must stand a teacher-forced
    prefill over prompt and answer ((d): its logit within the bound of
    the step's largest). A verify that wrote or read the cache at a
    wrong offset breaks both."""
    frac = 0.015 * math.sqrt(layers)
    ptoks, plogits = plain
    P = prompts.shape[1]
    forced = iface.logits(np.concatenate([prompts, toks[:, :-1]], 1)
                          ).astype(np.float32)[:, P - 1:]
    same, worst_tie, worst_d = [], 0.0, 0.0
    for b in range(toks.shape[0]):
        tol = frac * float(np.abs(plogits[b]).max())
        differ = np.nonzero(toks[b] != ptoks[b])[0]
        same.append(int(differ[0]) if differ.size else toks.shape[1])
        if differ.size:
            i = int(differ[0])
            row = plogits[b, i]
            worst_tie = max(worst_tie, float(row[ptoks[b, i]]
                                             - row[toks[b, i]]) / (2 * tol))
        f = forced[b, np.arange(toks.shape[1])]
        gaps = f.max(-1) - f[np.arange(toks.shape[1]), toks[b]]
        worst_d = max(worst_d, float(gaps.max()) / (frac * float(
            np.abs(f).max())))
    say(f"    {what}: tokens equal to plain greedy for the first {same} of "
        f"{toks.shape[1]}; at the first difference the plain decode's "
        f"margin over the speculative token {worst_tie:.4g} of its bound "
        f"(2 x {frac:.1%} of max|logit|); (d) against a teacher-forced "
        f"prefill: worst {worst_d:.4g} of the bound ({frac:.1%})")
    if not worst_tie <= 1.0 or not worst_d <= 1.0:
        fail(f"speculative greedy tokens ({what}) part from the target's "
             f"greedy decode away from a near tie, or do not stand a "
             f"teacher-forced prefill")


def spec_run(torch, np, dec, prompts, n_new: int, plain, draft_layers: int,
             layers: int, what: str, sampling=None) -> tuple:
    """One speculative generation of `prompts` (B, P) with the counters
    set to 0 just before and read just after: greedy tokens against the
    target's own greedy decode `plain` (spec_agreement); flash_attention
    launched once a layer for the target's prefill, the draft's and every
    verify round (the draft's own steps are one row: decode_attention);
    every QuantMatMul call of the lowering launched int8_matmul once.
    Returns (tokens, rounds, seconds, launches)."""
    from whisper_tensor_tpu_torch.milli import transforms

    counters = spec_counters()
    spy = quant_spy(transforms)
    try:
        zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = dec.generate_tokens(prompts, n_new, sampling=sampling)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in counters.items()}
    finally:
        transforms.int8_matmul = spy.inner
    rounds, k = dec.last_rounds, dec.k
    flash = (1 + rounds) * layers + draft_layers
    acc = (n_new / rounds - 1) / (k - 1)
    say(f"  {what}, k={k}: {rounds} rounds (full acceptance: "
        f"{-(-(n_new - 1) // k)}), acceptance {acc:.3f}, "
        f"{secs / rounds * 1e3:.2f} ms a round, {toks.size / secs:.1f} "
        f"tok/s; launches {got}; QuantMatMul calls {spy.calls}, int8 "
        f"launches {spy.launched}, up to {spy.rows} rows")
    if sampling is None:
        spec_agreement(np, dec.target, prompts, toks, plain, layers, what)
    if got["flash_attention"] != flash:
        fail(f"flash_attention launched {got['flash_attention']} times for "
             f"{rounds} verify rounds ({what}, k={k}): {flash} expected")
    if spy.calls <= 0 or spy.launched != spy.calls \
            or got["int8_matmul"] != spy.calls:
        fail(f"the QuantMatMul calls of the speculative run ({what}) did "
             f"not each launch int8_matmul once")
    return toks, rounds, secs, got


def phase10_spec_direct(torch, np, srv, iface, ckpt: Path, layers: int,
                        results) -> None:
    """Phase 10 (m), at the end of phase 3 on its int8 model: speculative
    decoding with two drafts, the target itself (self-draft: every
    proposal accepted) and the first layer of the same weights with the
    embedding and the head (a truncated draft, near the all-rejected
    floor with random weights); greedy at k 4 and 5, 64 new tokens, each
    token-exact against the target's own greedy decode; sampled at
    temperature 0.8 (seeded, repeatable); once over the WebSocket
    generate_text with draft_model_id; speculative against plain decode
    timed back to back."""
    from whisper_tensor_tpu_torch.interfaces.speculative import (
        SpeculativeDecoder)
    from whisper_tensor_tpu_torch.interfaces.text import SamplingParams
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say("phase 10 (m): speculative decoding on phase 3's int8 model")
    t_phase = time.perf_counter()
    draft_dir = ckpt.with_name(ckpt.name + "-draft")
    shutil.rmtree(draft_dir, ignore_errors=True)
    draft_dir.mkdir(parents=True)
    cfg = json.loads((ckpt / "config.json").read_text())
    (draft_dir / "config.json").write_text(json.dumps(
        {**cfg, "num_hidden_layers": 1}))
    (draft_dir / "model.safetensors").symlink_to(ckpt / "model.safetensors")
    try:
        t0 = time.perf_counter()
        (dentry,) = srv.models.run_loader("transformers", {
            "path": str(draft_dir), "dtype": "bf16", "quantize": "int8",
            "max_len": MAX_LEN})
        draft = srv._score_iface(dentry)
        draft._weights()
        torch.cuda.synchronize()
        say(f"  the truncated draft (layer 0, the embedding and the head, "
            f"int8) loaded in {time.perf_counter() - t0:.1f} s")
        tok = ByteTokenizer()
        prompt = np.asarray(tok.encode(GREEDY["prompt"]), np.int64)[None]
        n_new = 64
        plain = iface.generate_with_logits(prompt, n_new)
        kernels = {}
        for dname, d, dl in (("self-draft", iface, layers),
                             ("truncated draft", draft, 1)):
            for k in (4, 5):
                dec = SpeculativeDecoder(iface, d, k=k)
                _, rounds, _, got = spec_run(torch, np, dec, prompt, n_new,
                                             plain, dl, layers, dname)
                kernels = {n: kernels.get(n, 0) + v for n, v in got.items()}
        for res in results:
            if res["name"] in kernels:
                res["launches_spec_direct"] = kernels[res["name"]]
        sp = SamplingParams(temperature=0.8, seed=7)
        dec = SpeculativeDecoder(iface, draft, k=4)
        a, *_ = spec_run(torch, np, dec, prompt, n_new, None, 1, layers,
                         "truncated draft, sampled at temperature 0.8",
                         sampling=sp)
        b = dec.generate_tokens(prompt, n_new, sampling=sp)
        V = iface._vocab_size()
        # the WebSocket's decoder below: the same draft and k, greedy
        want_ws = dec.generate_tokens(prompt, n_new)[0]
        if not np.array_equal(a, b) or a.min() < 0 or a.max() >= V:
            fail("the sampled speculative run is not repeatable, or left "
                 "the vocabulary")
        # speculative (self-draft, k 4) against plain decode, back to back
        dec = SpeculativeDecoder(iface, iface, k=4)
        times = {"plain": [], "spec": []}
        for which in ("plain", "spec", "spec", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "plain":
                iface.generate_tokens(prompt, n_new)
            else:
                dec.generate_tokens(prompt, n_new)
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
        tp, ts = min(times["plain"]), min(times["spec"])
        say(f"  information: {n_new} tokens, plain decode {n_new / tp:.1f} "
            f"tok/s, self-drafted k=4 {n_new / ts:.1f} tok/s "
            f"({dec.last_rounds} rounds, {ts / dec.last_rounds * 1e3:.2f} ms "
            f"a round; batch 1, {layers} layers) on {card_line()}")
        # the WebSocket server's generate_text with draft_model_id
        port, stop = ws_serve(srv)
        try:
            ws = WSClient(port)
            (entry,) = [e for e in srv.models._models.values()
                        if e.id != dentry.id]
            ws.send({"type": "generate_text", "model_id": entry.id,
                     "prompt": GREEDY["prompt"], "max_new_tokens": n_new,
                     "tokenizer": "bytes", "draft_model_id": dentry.id,
                     "draft_k": 4})
            r = ws.until("job_result")
            ws.close()
        finally:
            stop()
        say(f"  WebSocket generate_text with draft_model_id: "
            f"{r['result']['rounds']} rounds, text "
            f"{r['result']['text'][:40]!r}...")
        if r["result"]["text"] != tok.decode([int(t) for t in want_ws]):
            fail("the WebSocket speculative answer differs from the same "
                 "decoder's tokens called directly")
        srv._dispatch({"type": "unload_model", "model_id": dentry.id})
    finally:
        shutil.rmtree(draft_dir, ignore_errors=True)
    say(f"[phase 10 (m), direct: {time.perf_counter() - t_phase:.1f} s]")


def phase10_spec_batched(torch, np, iface, layers: int, results) -> None:
    """Phase 10 (m), at the end of phase 4 on its pos_per_row int8 model:
    a batch of 4 prompts, self-drafted at k 4 (both interfaces
    pos_per_row: each row's start is its own), token-exact against the
    interface's plain greedy decode of the batch."""
    from whisper_tensor_tpu_torch.interfaces.speculative import (
        SpeculativeDecoder)
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say("phase 10 (m): speculative decoding, a batch of 4 on phase 4's "
        "pos_per_row int8 model")
    tok = ByteTokenizer()
    prompts = np.stack([np.asarray(tok.encode(long_text(np, 40, SEED + 70 + i)),
                                   np.int64) for i in range(4)])
    plain = iface.generate_with_logits(prompts, 64)
    dec = SpeculativeDecoder(iface, iface, k=4)
    _, rounds, _, got = spec_run(torch, np, dec, prompts, 64, plain, layers,
                                 layers, "B=4 self-draft")
    for res in results:
        if res["name"] in got:
            res["launches_spec_batched"] = got[res["name"]]


def lora_step_rates(torch, iface, B: int, layers: int) -> None:
    """Decode steps of B rows (one chunk's step) through the pre-surgery
    graph (every row base) and through the adapted graph (rows under
    base, a and b in turn), timed in turns: base, adapted, adapted,
    base. Information only."""
    dev = iface.device
    caches = iface.fresh_cache(B)
    ids = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    pos = torch.arange(B, device=dev) * 64 + 100
    lora = torch.arange(B, device=dev) % 3

    def ms(idx, n=32):
        iface.step(ids, pos, caches, idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            iface.step(ids, pos, caches, idx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    got = {"base": [], "adapted": []}
    for which in ("base", "adapted", "adapted", "base"):
        got[which].append(ms(None if which == "base" else lora))
    b, a = min(got["base"]), min(got["adapted"])
    say(f"  information: a decode step of {B} rows, every row base "
        f"(pre-surgery graph) {b:.2f} ms = {B / b * 1e3:.0f} tok/s; rows "
        f"under base, a and b (adapted graph) {a:.2f} ms = "
        f"{B / a * 1e3:.0f} tok/s ({a / b:.2f}x; {layers} layers, de-fused "
        f"q/k/v and gate/up in both) on {card_line()}")


def phase10(torch, np, ckpt: Path, gpt2_ckpt: Path, layers: int, bf16,
            results) -> None:
    """Phase 10: (l) multi-LoRA serving, (n) the profiler, and `cli
    generate --draft-model`. (l): the checkpoint loaded dense bf16 with
    ragged_decode and serve_adapters a and b (r 16, alpha 32, all seven
    projections), 16 slots, pieces of 128; 24 concurrent completions (8
    base, 8 with "adapter": "a", 8 with model "<name>:b"); every answer
    in full, the attention and cache-write kernels' counters rise, one
    cache-write launch a layer a step through either graph, (d) each
    greedy answer stands a teacher-forced prefill under its own adapter;
    then load_adapter c over the WebSocket while 8 requests are in
    flight, 8 completions under c, /v1/models listing a, b and c, and
    the card's GB before, during and after the swap; one prompt's logits
    under a within the bound of (c) of the checkpoint loaded with
    lora=<a> (merged at load) on the direct path. (n): start_profiler,
    one served completion, stop_profiler over the WebSocket; the Chrome
    trace must name the port's kernels. Last, `cli generate
    --draft-model` on the GPT-2 checkpoint (int8, self-drafted) must
    print the plain `cli generate` text."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.interfaces.speculative import (
        SpeculativeDecoder)

    say(f"phase 10 (l): multi-LoRA serving through the batcher; host RSS "
        f"{host_rss_gb():.1f} GB")
    ads = {n: ckpt.with_name(f"adapter-{n}") for n in "abc"}
    for i, (n, d) in enumerate(ads.items()):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        write_adapter(d, layers, SEED + 40 + i, np, bf16)
    pdir = ckpt.with_name("profile")
    try:
        phase10_lora(torch, np, ckpt, ads, pdir, layers, results)
    finally:
        for d in list(ads.values()) + [pdir]:
            shutil.rmtree(d, ignore_errors=True)

    say("phase 10: cli generate --draft-model (GPT-2 124M widths, int8, "
        "self-drafted at k 4)")
    args = ["generate", "--model", str(gpt2_ckpt), "--prompt",
            GREEDY["prompt"], "--max-new-tokens", "32", "--max-len", "256",
            "-c", "quantize=int8"]
    outs = []
    for extra in ([], ["--draft-model", str(gpt2_ckpt), "--draft-k", "4"]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(args + extra)
        outs.append((out.getvalue(), err.getvalue()))
    spec_line = [ln for ln in outs[1][1].splitlines() if "speculative" in ln]
    # the CLI's speculative text is the decoder's, on an interface loaded
    # as the CLI loads it; against plain `generate` it may part at a near
    # tie (spec_agreement), so that is reported, not required
    iface, _ = cli._load_text(argparse.Namespace(
        model=str(gpt2_ckpt), config=["quantize=int8"], max_len=256,
        loader="auto", tokenizer=None, device="cuda"))
    want = iface.tokenizer.decode([int(t) for t in SpeculativeDecoder(
        iface, iface, k=4).generate_tokens(np.asarray(
            iface.tokenizer.encode(GREEDY["prompt"]), np.int64), 32)[0]])
    plain_text, spec_text = outs[0][0].rstrip("\n"), outs[1][0].rstrip("\n")
    same = next((i for i, (a, b) in enumerate(zip(plain_text, spec_text))
                 if a != b), min(len(plain_text), len(spec_text)))
    say(f"  --draft-model: {spec_line}; its text is the decoder's called "
        f"directly: {spec_text == want}; equal to plain `generate` for its "
        f"first {same} of {len(spec_text)} characters")
    if spec_text != want or not spec_line:
        fail("cli generate --draft-model printed another text than the "
             "speculative decoder's")


def phase10_lora(torch, np, ckpt: Path, ads: dict, pdir: Path, layers: int,
                 results) -> None:
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    cfg = {"path": str(ckpt), "dtype": "bf16", "max_len": MAX_LEN,
           "ragged_decode": True, "serve_batch": 16, "serve_chunk": 16,
           "prefill_chunk": 128,
           "serve_adapters": f"a={ads['a']},b={ads['b']}"}
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("transformers", cfg)
    say(f"  loader (ragged_decode graph, dense bf16): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bat = srv._batcher(entry)
    iface = bat.iface
    iface._weights()
    torch.cuda.synchronize()
    gb_loaded = torch.cuda.memory_allocated() / 1e9
    base_kinds = [n.op.KIND for n in iface._exec.graph.nodes]
    lora_kinds = [n.op.KIND for n in iface._exec_lora.graph.nodes]
    say(f"  batcher interface (adapters a, b installed, de-fused, upload): "
        f"{time.perf_counter() - t0:.1f} s, {gb_loaded:.2f} GB on the card; "
        f"graphs: base {base_kinds.count('KVWrite')} KVWrite, "
        f"{base_kinds.count('MatMul')} MatMul; adapted "
        f"{lora_kinds.count('KVWrite')} KVWrite, "
        f"{lora_kinds.count('Einsum')} Einsum")
    if (base_kinds.count("KVWrite") != layers
            or lora_kinds.count("KVWrite") != layers
            or lora_kinds.count("Einsum") != 3 * len(LORA_TARGETS) * layers
            or "Einsum" in base_kinds):
        fail("the adapted and base graphs do not each write a layer's "
             "caches in one KVWrite, or the surgery is not the expected one")
    name = entry.name
    records, submit = [], bat.submit

    def recorded(prompt_ids, n_new, **kw):
        fut = submit(prompt_ids, n_new, **kw)
        records.append((np.asarray(prompt_ids, np.int64).reshape(-1),
                        kw.get("adapter"), fut))
        return fut

    rng = np.random.default_rng(SEED + 10)
    lengths = (5, 9, 14, 20, 31, 45, 70, 110, 150, 190, 230, 300) * 2
    reqs = []
    for i, n in enumerate(lengths):
        body = {"prompt": long_text(np, n, SEED + 400 + i),
                "max_tokens": int(rng.integers(12, 41)), "temperature": 0,
                "model": name}
        if i % 3 == 1:
            body["adapter"] = "a"
        elif i % 3 == 2:
            body["model"] = f"{name}:b"
        reqs.append(body)
    counters = {"decode_attention": decode_attention,
                "kv_write_pair": kv_write_pair,
                "ragged_kv_write": ragged_kv_write,
                "flash_attention": flash_attention,
                "int8_matmul": int8_matmul, "packed_matmul": packed_matmul}
    answers = [None] * len(reqs)
    bat.submit = recorded
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    ws_port, ws_stop = ws_serve(srv)
    steps = count_steps(iface)
    try:
        zero(counters)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, request(api.port, "/v1/completions", reqs[i])))
            for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        served_s = time.perf_counter() - t0
        launches = rose(counters, "the adapted batched path", (
            "decode_attention", "kv_write_pair", "flash_attention"))
        runs = steps.runs
    finally:
        del iface.step
        bat.submit = submit
    if launches["int8_matmul"] or launches["packed_matmul"]:
        fail("the dense adapted path launched a quantized product")
    check_cache_writes(launches, runs, layers, "adapted batched")
    for res in results:
        if res["name"] in launches:
            res["launches_lora_batched"] = launches[res["name"]]
    n_tokens = 0
    for i, (body, ans) in enumerate(zip(reqs, answers)):
        if ans is None or ans[0] != 200:
            fail(f"adapter request {i} got no answer or an error: "
                 f"{None if ans is None else ans[1][:300]!r}")
        got = json.loads(ans[1])["usage"]["completion_tokens"]
        if got != body["max_tokens"]:
            fail(f"adapter request {i} answered {got} tokens of "
                 f"{body['max_tokens']}")
        n_tokens += got
    if len(records) != len(reqs) or sorted(
            str(a) for _, a, _ in records) != sorted(["None"] * 8 + ["a"] * 8
                                                     + ["b"] * 8):
        fail(f"the batcher did not receive 8 base, 8 a and 8 b requests: "
             f"{[a for _, a, _ in records]}")
    st = bat.stats()
    say(f"  24 requests (8 base, 8 a, 8 b) served in {served_s:.2f} s: "
        f"{n_tokens} tokens = {n_tokens / served_s:.1f} tok/s over the "
        f"phase, {st['chunks_dispatched']} chunks, {runs} runs of the step "
        f"graph")
    frac = 0.015 * math.sqrt(layers)

    def d_check(iface, recs, what):
        worst, outs = 0.0, {}
        for prompt, adapter, fut in recs:
            toks = fut.result()
            gaps, scale = teacher_gaps(torch, np, iface, prompt, toks,
                                       iface.adapter_slots[adapter])
            worst = max(worst, float(gaps.max()) / (frac * scale))
            outs.setdefault(adapter, []).append(toks)
        say(f"  (d) {len(recs)} greedy answers ({what}) against "
            f"teacher-forced prefills under their own adapter: worst (max "
            f"logit - emitted logit) {worst:.4g} of the bound ({frac:.1%} of "
            f"each answer's max|logit|)")
        if not worst <= 1.0:
            fail(f"a greedy answer ({what}) disagrees with the "
                 f"teacher-forced prefill under its adapter")
        return outs

    d_check(iface, records, "base, a and b")
    lora_step_rates(torch, iface, bat.max_batch, layers)
    tok = ByteTokenizer()
    prompt = np.asarray(tok.encode(GREEDY["prompt"]), np.int64)
    P = prompt.shape[0]
    padded = torch.zeros((1, 32), dtype=torch.int64, device=iface.device)
    padded[0, :P] = torch.from_numpy(prompt)
    adapted_logits = iface.step(
        padded, torch.zeros(1, dtype=torch.int64, device=iface.device),
        iface.fresh_cache(1), torch.tensor(
            [iface.adapter_slots["a"]], device=iface.device))[0, :P]
    adapted_logits = adapted_logits.float().cpu().numpy()

    # load_adapter c over the WebSocket while 8 requests are in flight
    inflight = [{"prompt": long_text(np, 60 + 20 * i, SEED + 500 + i),
                 "max_tokens": 64, "temperature": 0, "model": name,
                 **({"adapter": "ab"[i % 2]} if i % 3 else {})}
                for i in range(8)]
    fly = [None] * 8
    ws = WSClient(ws_port)
    try:
        fly_threads = [threading.Thread(target=lambda i=i: fly.__setitem__(
            i, request(api.port, "/v1/completions", inflight[i])))
            for i in range(8)]
        for t in fly_threads:
            t.start()
        deadline = time.time() + 60
        while bat.stats()["active"] < 8 and time.time() < deadline:
            time.sleep(0.002)
        active = bat.stats()["active"]
        torch.cuda.synchronize()
        gb_before = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ws.send({"type": "load_adapter", "model_id": entry.id, "name": "c",
                 "path": str(ads["c"])})
        rep = ws.until("adapter_loaded")
        swap_s = time.perf_counter() - t0
        new = srv._batcher(entry)
        if new is bat or rep["adapters"] != ["a", "b", "c"]:
            fail(f"load_adapter did not swap in a batcher serving a, b and "
                 f"c: {rep}")
        c_records, c_submit = [], new.submit

        def c_recorded(prompt_ids, n_new, **kw):
            fut = c_submit(prompt_ids, n_new, **kw)
            c_records.append((np.asarray(prompt_ids, np.int64).reshape(-1),
                              kw.get("adapter"), fut))
            return fut

        new.submit = c_recorded
        c_reqs = [{"prompt": long_text(np, 10 + 30 * i, SEED + 600 + i),
                   "max_tokens": 24, "temperature": 0,
                   "model": f"{name}:c"} for i in range(8)]
        c_ans = [None] * 8
        c_threads = [threading.Thread(target=lambda i=i: c_ans.__setitem__(
            i, request(api.port, "/v1/completions", c_reqs[i])))
            for i in range(8)]
        for t in c_threads:
            t.start()
        for t in c_threads + fly_threads:
            t.join(900)
        new.submit = c_submit
        deadline = time.time() + 300
        while bat._thread is not None and time.time() < deadline:
            time.sleep(0.01)       # the old batcher drains, then stops
        torch.cuda.synchronize()
        gb_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        ws.close()
    for i, ans in enumerate(fly + c_ans):
        body = (inflight + c_reqs)[i]
        if ans is None or ans[0] != 200 or json.loads(ans[1])["usage"][
                "completion_tokens"] != body["max_tokens"]:
            fail(f"request {i} across the adapter swap was not answered in "
                 f"full: {None if ans is None else ans[1][:300]!r}")
    # nothing here may keep the old batcher (its caches) alive
    del bat, iface, steps, submit, recorded
    free_memory(torch)
    gb_after = torch.cuda.memory_allocated() / 1e9
    say(f"  load_adapter c over the WebSocket with {active} rows in flight: "
        f"{swap_s:.2f} s to the adapter_loaded reply; 8 in-flight and 8 c "
        f"requests answered in full; card GB before the swap {gb_before:.2f}"
        f", peak during it {gb_peak:.2f}, after the old batcher drained "
        f"{gb_after:.2f} (the new batcher shares the old one's device "
        f"weights and uploads the adapter stacks)")
    new_iface = srv._batcher(entry).iface
    outs = d_check(new_iface, c_records, "under c, on the new batcher")
    if len(outs.get("c", [])) != 8:
        fail("the 8 c requests did not reach the new batcher as c")
    models = models_listing(api.port)
    say(f"  /v1/models: {models}")
    if not {f"{name}:{a}" for a in "abc"} <= set(models):
        fail("/v1/models does not list the three adapters")

    # (n) the profiler over the WebSocket around one served completion
    ws = WSClient(ws_port)
    try:
        ws.send({"type": "start_profiler", "dir": str(pdir)})
        ack = ws.until("profiler_ack")
        completion(api.port, {"prompt": GREEDY["prompt"], "max_tokens": 16,
                              "temperature": 0, "model": f"{name}:a"})
        ws.send({"type": "stop_profiler"})
        ack2 = ws.until("profiler_ack")
    finally:
        ws.close()
    trace = Path(ack2["trace"])
    events = json.loads(trace.read_text())["traceEvents"]
    kernel_names = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kernel_names) for k in (
        "decode_attention_kernel", "kv_write", "flash_attention_kernel")}
    say(f"  (n) profiler: {ack['dir']} -> {trace.name} "
        f"({trace.stat().st_size / 1e6:.1f} MB), {len(kernel_names)} kernel "
        f"events, the port's by name: {found}")
    if not ack["started"] or ack2["started"] or min(found.values()) <= 0:
        fail("the profiler's trace does not hold the port's kernel events")
    api.stop()
    ws_stop()
    for b in srv._batchers.values():
        b.stop()
    srv._batchers.clear()
    free_memory(torch)

    # the same checkpoint with `a` merged at load, on the direct path
    t0 = time.perf_counter()
    msrv = Server()
    (mentry,) = msrv.models.run_loader("transformers", {
        "path": str(ckpt), "dtype": "bf16", "max_len": MAX_LEN,
        "lora": str(ads["a"])})
    merged = msrv._text_iface(mentry).logits(prompt[None]).astype(
        np.float32)[0]
    scale = float(np.abs(merged).max())
    diff = float(np.abs(merged - adapted_logits).max())
    say(f"  the prompt's logits under a, adapted batcher (x W + (x A) B) "
        f"against -c lora=<a> merged at load (x (W + s B A)), direct: max "
        f"|diff| {diff:.5g} ({diff / scale:.3%} of max|logit| {scale:.4g}; "
        f"bound {frac:.1%} as in (c)); merged load {time.perf_counter() - t0:.1f} s")
    if not diff <= frac * scale:
        fail("the adapted logits disagree with the merged-at-load model's")


def models_listing(port: int) -> list:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", "/v1/models")
        r = c.getresponse()
        return [m["id"] for m in json.loads(r.read())["data"]]
    finally:
        c.close()


# ---------------------------------------------------------------------------
# phase 11: the generic ONNX path (Model.eval and EvalBackend) on the card

# the device phase 11 runs on (a CPU dry run at small widths sets "cpu")
CARD = "cuda"
# corpus cases that need another tolerance on the card than their own:
# {name: (rtol, atol, measured error, reason)}
CARD_TOLERANCES = {}


def phase11_corpus(torch, np) -> None:
    """(a) every case of the CPU tests' corpus (tests/torch_corpus.npz,
    the selected cases of tests/conformance/) through Model.eval on the
    default device, at the case's own tolerances."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_conformance as tc
    from whisper_tensor_tpu_torch.model import Model

    cases = tc.read_bundle()
    say(f"phase 11 (a): {len(cases)} corpus cases through Model.eval on "
        f"the card (tests/torch_corpus.npz)")
    t0 = time.perf_counter()
    paths, failures = {}, []
    worst, worst_name = 0.0, ""
    for c in cases:
        rtol, atol = CARD_TOLERANCES.get(c.name, (c.rtol, c.atol))[:2]
        try:
            m = Model.new_from_onnx(c.onnx, name=c.name)
            be = m.backend("torch")
            out = be.run(m.graph, dict(c.inputs))
            share = tc.check_outputs(c, out, rtol, atol)
            if (be.last_path == "oracle") != m.graph.needs_host_eval():
                raise AssertionError(f"ran on {be.last_path}")
        except Exception as e:                        # noqa: BLE001
            failures.append(f"{c.name}: {type(e).__name__}: "
                            f"{str(e).strip()[:400]}")
            continue
        paths[be.last_path] = paths.get(be.last_path, 0) + 1
        if share > worst:
            worst, worst_name = share, c.name
    torch.cuda.synchronize()
    say(f"  passed {sum(paths.values())} of {len(cases)} in "
        f"{time.perf_counter() - t0:.1f} s: on the card {paths.get('torch', 0)}"
        f" (one graph) + {paths.get('torch-control', 0)} (control flow on "
        f"the host, every other node on the card), on the host by design "
        f"{paths.get('oracle', 0)} (strings, sequences, ai.onnx.ml); worst "
        f"float error {worst:.4g} of the tolerance ({worst_name}); "
        f"{len(CARD_TOLERANCES)} cases at a card tolerance")
    for f in failures[:40]:
        say(f"  FAILED {f}")
    if failures:
        fail(f"{len(failures)} corpus cases failed on the card")


def attention_onnx(B, Hq, Hkv, S, D, mode):
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import OnnxBuilder

    b = OnnxBuilder("attn", opset=23)
    for n, h in (("q", Hq), ("k", Hkv), ("v", Hkv)):
        b.input(n, DType.BF16, [B, h, S, D])
    ins = ["q", "k", "v"]
    if mode == "additive":
        b.input("mask", DType.BF16, [1, 1, S, S])
        ins.append("mask")
    b.node("Attention", ins, outputs=["y"],
           is_causal=1 if mode == "causal" else None)
    b.output("y", DType.BF16, [B, Hq, S, D])
    return b.build()


def phase11_attention(torch, np) -> dict:
    """(b) ONNX Attention in bf16 at full width through Model.eval:
    Llama-3-8B's 32/8 heads of 128 at S 2,048 and GPT-2's 12 heads of 64
    at S 1,024, causal and with an additive (1, 1, S, S) mask. Each
    launches flash_attention once, within flash_agreement_bound of its
    plain version on the card; host-timed beside the plain path (the
    lowering's f32 path)."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.milli.ops import attention as lowering
    from whisper_tensor_tpu_torch.model import Model

    say("phase 11 (b): ONNX Attention in bf16 through Model.eval")
    launches = 0
    gen = torch.Generator(device=CARD).manual_seed(SEED + 11)
    for label, Hq, Hkv, S, D in (("Llama-3-8B", 32, 8, 2048, 128),
                                 ("GPT-2", 12, 12, 1024, 64)):
        for mode in ("causal", "additive"):
            q = torch.randn(1, Hq, S, D, generator=gen, device=CARD,
                            dtype=torch.bfloat16)
            k, v = (torch.randn(1, Hkv, S, D, generator=gen, device=CARD,
                                dtype=torch.bfloat16) for _ in range(2))
            feeds = {"q": q, "k": k, "v": v}
            kw = {"causal": True}
            if mode == "additive":
                hide = torch.rand(1, 1, S, S, generator=gen,
                                  device=CARD) < 0.3
                hide[..., 0] = False
                feeds["mask"] = torch.where(hide, -1e4, 0.0).to(
                    torch.bfloat16)
                kw = {"mask": feeds["mask"]}
            model = Model.new_from_onnx(attention_onnx(1, Hq, Hkv, S, D,
                                                       mode))
            n0 = flash_attention.launches
            y = torch.from_numpy(model.eval(feeds)["y"].astype(np.float32))
            n = flash_attention.launches - n0
            launches += n
            scale = 1.0 / math.sqrt(D)
            ref = flash_attention_plain(q, k, v, scale, **kw)
            mag = flash_attention_plain(q, k, v.abs(), scale, **kw)
            err = (y.to(CARD) - ref.float()).abs()
            share = float((err / flash_agreement_bound(ref, mag)).max())

            def run():
                model.eval(feeds)
                torch.cuda.synchronize()

            kernel_ms = statistics.median(_timed(run, 5))
            saved = lowering.flash_mode
            lowering.flash_mode = lambda *a, **k: None
            try:
                plain_ms = statistics.median(_timed(run, 3))
            finally:
                lowering.flash_mode = saved
            say(f"  {label} {Hq}/{Hkv} heads of {D}, S {S}, {mode}: "
                f"{n} flash launch(es); worst |err|/bound {share:.4g}; "
                f"Model.eval {kernel_ms:.2f} ms host-timed against the "
                f"plain path's {plain_ms:.2f} ms")
            if n != 1:
                fail(f"Attention ({label}, {mode}) launched flash_attention "
                     f"{n} times, not once")
            if not share <= 1.0:
                fail(f"Attention ({label}, {mode}) disagrees with "
                     f"flash_attention_plain")
    return {"flash_attention": launches}


def _timed(fn, reps: int) -> list:
    fn()                                              # warm
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


class CallCounter:
    """Counts the calls of a lowering in the LOWERINGS table, and in
    `matched` those whose inputs `where(kind, inputs)` holds for. The
    plans built while it is installed keep the counting lowerings."""

    def __init__(self, kinds, where=None):
        from whisper_tensor_tpu_torch.milli.ops import LOWERINGS

        self.table, self.saved = LOWERINGS, {}
        self.calls, self.matched = {}, {}
        for kind in kinds:
            self.saved[kind] = fn = LOWERINGS[kind]
            self.calls[kind] = self.matched[kind] = 0

            def wrapped(op, ins, static, device, fn=fn, kind=kind):
                self.calls[kind] += 1
                if where is not None and where(kind, ins):
                    self.matched[kind] += 1
                return fn(op, ins, static, device)

            LOWERINGS[kind] = wrapped

    def restore(self):
        self.table.update(self.saved)


def phase11_steps(torch, np, ckpt: Path, layers: int) -> dict:
    """(c) the text recipes' step graphs at full width through Model.eval.
    Phase 3's Llama-3-8B-width checkpoint (bf16, ragged_decode: a per-row
    pos) as the loader builds it: a 1,900-token prefill (flash_attention,
    pos-bound) and 8 greedy decode steps (decode_attention), each cache
    write one ragged_kv_write launch; the launches equal the lowering's
    calls and the logits stand the text interface's teacher-forced
    prefill within phase 3's bound. Then GPT-2 124M's widths (seeded
    random weights, a scalar pos): a 512-token prefill whose (1, 1, S,
    1,024) additive mask takes flash_attention's additive mode, its
    logits against the lowering's plain path."""
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm import gpt2
    from whisper_tensor_tpu_torch.milli.ops import attention as lowering
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    say(f"phase 11 (c): the step graphs through Model.eval; host RSS "
        f"{host_rss_gb():.1f} GB")
    counters = {"flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "ragged_kv_write": ragged_kv_write,
                "kv_write_pair": kv_write_pair}
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("transformers", {
        "path": str(ckpt), "dtype": "bf16", "max_len": MAX_LEN,
        "ragged_decode": True})
    model = entry.model
    say(f"  loader: {time.perf_counter() - t0:.1f} s")

    def fresh(m):
        out = {}
        for name, info in m.input_infos().items():
            if name.startswith("cache_"):
                dims = [1] + [int(d.value()) for d in info.dims()[1:]]
                out[name] = torch.zeros(dims, dtype=torch.bfloat16,
                                        device=CARD)
        return out

    prompt = np.asarray(ByteTokenizer().encode(long_text(
        np, MAX_LEN - 148, SEED + 12)), np.int64)   # 1,900 tokens
    P, n_new = prompt.shape[0], 8
    caches = fresh(model)
    zero(counters)
    calls = CallCounter(("Attention", "DynUpdateSlice"))
    try:
        t0 = time.perf_counter()
        out = model.eval(dict(caches, input_ids=prompt[None],
                              pos=np.asarray([0], np.int64)))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        logits = [out["logits"][0].astype(np.float32)]
        toks = [int(logits[0][-1].argmax())]
        t0 = time.perf_counter()
        for i in range(n_new):
            out = model.eval(dict(caches, input_ids=np.asarray(
                [[toks[-1]]], np.int64), pos=np.asarray([P + i], np.int64)))
            logits.append(out["logits"][0].astype(np.float32))
            toks.append(int(logits[-1][-1].argmax()))
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_new
    finally:
        calls.restore()
    got = {name: fn.launches for name, fn in counters.items()}
    # the plan's steps keep the counting wrappers: read them before the
    # replay below
    lowered = dict(calls.calls)
    # the same prefill again: the plan replays, the weights are on the card
    again = fresh(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.eval(dict(again, input_ids=prompt[None],
                    pos=np.asarray([0], np.int64)))
    replay_ms = (time.perf_counter() - t0) * 1e3
    del again
    say(f"  llama ({layers} layers): prefill of {P} tokens "
        f"{prefill_ms:.1f} ms (the first run: weights uploaded, plan "
        f"built), {replay_ms:.1f} ms replayed; {n_new} decode steps "
        f"{decode_ms:.1f} ms a step (logits and caches downloaded every "
        f"step); launches {got}; lowering calls {lowered}")
    if got["flash_attention"] != layers \
            or got["decode_attention"] != n_new * layers \
            or got["flash_attention"] + got["decode_attention"] \
            != lowered["Attention"] \
            or got["ragged_kv_write"] != lowered["DynUpdateSlice"] \
            or got["ragged_kv_write"] != 2 * (1 + n_new) * layers:
        fail(f"phase 11 (c): launches {got} do not match the lowering's "
             f"calls {lowered}")
    iface = srv._text_iface(entry)
    teacher = iface.logits(np.concatenate([prompt, toks[:-1]])[None])[0]
    teacher = teacher.astype(np.float32)
    mine = np.concatenate(logits, axis=0)
    scale = float(np.abs(teacher).max())
    frac = 0.015 * math.sqrt(layers)
    diff = float(np.abs(mine - teacher).max())
    say(f"  logits of the prefill and the decode steps against the text "
        f"interface's teacher-forced prefill: max |diff| {diff:.5g} "
        f"({diff / scale:.3%} of max|logit| {scale:.4g}; bound "
        f"{frac:.1%}, phase 3's); argmax agreement "
        f"{float((mine.argmax(-1) == teacher.argmax(-1)).mean()):.3f}")
    if not diff <= frac * scale:
        fail("phase 11 (c): Model.eval's logits disagree with the text "
             "interface's")
    del iface, model, entry, srv, caches, out, logits, teacher, mine
    free_memory(torch)

    cfg = gpt2.GPT2Config()
    g_model = Model.new_from_onnx(gpt2.build_gpt2_step(
        gpt2.random_gpt2_weights(cfg, seed=SEED), cfg, max_len=1024,
        dtype=DType.BF16, pos_per_row=False))
    ids = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int64)
    modes = []
    real = lowering.flash_attention

    def spy(q, k, v, scale, **kw):
        modes.append("additive" if kw.get("mask") is not None else "other")
        return real(q, k, v, scale, **kw)

    def prefill():
        out = g_model.eval(dict(fresh(g_model), input_ids=ids,
                                pos=np.asarray(0, np.int64)))
        return out["logits"][0].astype(np.float32)

    lowering.flash_attention = spy
    n0 = flash_attention.launches
    try:
        with_kernel = prefill()         # uploads the weights, builds the plan
    finally:
        lowering.flash_attention = real
    g_launches = flash_attention.launches - n0
    kernel_ms = statistics.median(_timed(prefill, 3))
    saved = lowering.flash_mode
    lowering.flash_mode = lambda *a, **k: None
    try:
        plain = prefill()
        plain_ms = statistics.median(_timed(prefill, 3))
    finally:
        lowering.flash_mode = saved
    scale = float(np.abs(plain).max())
    frac = 0.015 * math.sqrt(cfg.n_layer)
    diff = float(np.abs(with_kernel - plain).max())
    say(f"  GPT-2 124M widths, 512-token prefill: {g_launches} flash "
        f"launches ({modes.count('additive')} in the additive mode), "
        f"{kernel_ms:.1f} ms against the plain path's {plain_ms:.1f} ms "
        f"(host-timed, median of 3 replays); teacher-forced logits "
        f"against the plain "
        f"path's: max |diff| {diff:.5g} ({diff / scale:.3%} of max|logit| "
        f"{scale:.4g}; bound {frac:.1%})")
    if g_launches != cfg.n_layer or modes.count("additive") != cfg.n_layer:
        fail("phase 11 (c): GPT-2's prefill did not take flash_attention's "
             "additive mode once a layer")
    if not diff <= frac * scale:
        fail("phase 11 (c): GPT-2's logits on the kernel disagree with the "
             "plain path's")
    got["flash_attention"] += g_launches
    return got


def phase11(torch, np, ckpt: Path, layers: int, results) -> None:
    """Phase 11: the generic ONNX path; its launches join the kernels'
    line as launches_generic."""
    phase11_corpus(torch, np)
    free_memory(torch)
    launches = phase11_attention(torch, np)
    free_memory(torch)
    for name, n in phase11_steps(torch, np, ckpt, layers).items():
        launches[name] = launches.get(name, 0) + n
    for res in results:
        if res["name"] in launches:
            res["launches_generic"] = launches[res["name"]]
    say(f"  phase 11 launches: {launches}")



# ---------------------------------------------------------------------------
# phase 12: Gemma, Gemma-2, Gemma-3 and Phi-3 at their published widths
# (the config.json of each checkpoint named), depth cut to --layers (6
# for Gemma-3, so that its sixth layer, the global one, is in), seeded
# random weights, bf16, max_len 2048; (config, layers or None for
# --layers, quantize)
FAMILIES = {
    # google/gemma-3-1b-pt
    "gemma-3-1b": (dict(
        model_type="gemma3_text", hidden_size=1152, num_attention_heads=4,
        num_key_value_heads=1, head_dim=256, intermediate_size=6912,
        vocab_size=262144, sliding_window=512, sliding_window_pattern=6,
        rope_theta=1e6, rope_local_base_freq=1e4, query_pre_attn_scalar=256,
        rms_norm_eps=1e-6, max_position_embeddings=32768), 6, "q4_0"),
    # google/gemma-2-2b
    "gemma-2-2b": (dict(
        model_type="gemma2", hidden_size=2304, num_attention_heads=8,
        num_key_value_heads=4, head_dim=256, intermediate_size=9216,
        vocab_size=256000, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=256,
        rope_theta=10000.0, rms_norm_eps=1e-6,
        max_position_embeddings=8192), None, "int8"),
    # google/gemma-2b
    "gemma-2b": (dict(
        model_type="gemma", hidden_size=2048, num_attention_heads=8,
        num_key_value_heads=1, head_dim=256, intermediate_size=16384,
        vocab_size=256000, rope_theta=10000.0, rms_norm_eps=1e-6,
        max_position_embeddings=8192), None, ""),
    # microsoft/Phi-3-mini-4k-instruct
    "phi-3-mini": (dict(
        model_type="phi3", hidden_size=3072, num_attention_heads=32,
        num_key_value_heads=32, intermediate_size=8192, vocab_size=32064,
        rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=4096,
        tie_word_embeddings=False), None, ""),
}
# the HF names of a Gemma-2 layer in a llama.cpp GGUF (gguf_llama.py's
# _GEMMA2_LAYER_MAP)
GEMMA2_GGUF = {"input_layernorm.weight": "attn_norm.weight",
               "self_attn.q_proj.weight": "attn_q.weight",
               "self_attn.k_proj.weight": "attn_k.weight",
               "self_attn.v_proj.weight": "attn_v.weight",
               "self_attn.o_proj.weight": "attn_output.weight",
               "post_attention_layernorm.weight": "post_attention_norm.weight",
               "pre_feedforward_layernorm.weight": "ffn_norm.weight",
               "post_feedforward_layernorm.weight": "post_ffw_norm.weight",
               "mlp.gate_proj.weight": "ffn_gate.weight",
               "mlp.up_proj.weight": "ffn_up.weight",
               "mlp.down_proj.weight": "ffn_down.weight"}


def family_shapes(cfg: dict, layers: int) -> dict:
    """HF name -> shape of a Gemma, Gemma-2, Gemma-3 or Phi-3 checkpoint
    of `layers` layers."""
    mt, E, I, V = cfg["model_type"], cfg["hidden_size"], \
        cfg["intermediate_size"], cfg["vocab_size"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or E // Hq
    shapes = {"model.embed_tokens.weight": (V, E), "model.norm.weight": (E,)}
    if mt == "phi3":
        shapes["lm_head.weight"] = (V, E)
    for i in range(layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (E,),
                       p + "post_attention_layernorm.weight": (E,)})
        if mt == "phi3":
            shapes.update({
                p + "self_attn.qkv_proj.weight": ((Hq + 2 * Hkv) * D, E),
                p + "self_attn.o_proj.weight": (E, Hq * D),
                p + "mlp.gate_up_proj.weight": (2 * I, E),
                p + "mlp.down_proj.weight": (E, I)})
            continue
        shapes.update({p + "self_attn.q_proj.weight": (Hq * D, E),
                       p + "self_attn.k_proj.weight": (Hkv * D, E),
                       p + "self_attn.v_proj.weight": (Hkv * D, E),
                       p + "self_attn.o_proj.weight": (E, Hq * D)})
        if mt != "gemma":
            shapes.update({p + "pre_feedforward_layernorm.weight": (E,),
                           p + "post_feedforward_layernorm.weight": (E,)})
        if mt == "gemma3_text":
            shapes.update({p + "self_attn.q_norm.weight": (D,),
                           p + "self_attn.k_norm.weight": (D,)})
        shapes.update({p + "mlp.gate_proj.weight": (I, E),
                       p + "mlp.up_proj.weight": (I, E),
                       p + "mlp.down_proj.weight": (E, I)})
    return shapes


def family_tensors(cfg: dict, layers: int, np):
    """(HF name, f32 array) of family_shapes, in order: matrices tile a
    seeded block of 2^20 + 7 normal values scaled 0.02 (as
    checkpoint_tensors); norms are 0 for Gemma, whose RMSNorm multiplies
    by 1 + w, and 1 for Phi-3; the output rows (Gemma's tied embedding,
    Phi-3's lm_head) outside the byte tokenizer's ids are zero, so greedy
    text decodes to printable bytes."""
    rng = np.random.default_rng(SEED + 20)
    norm = 1.0 if cfg["model_type"] == "phi3" else 0.0
    for n, s in family_shapes(cfg, layers).items():
        if len(s) == 1:
            yield n, np.full(s, norm, np.float32)
            continue
        base = rng.standard_normal((1 << 20) + 7, dtype=np.float32) * 0.02
        arr = np.resize(base, s)
        if n in ("lm_head.weight", "model.embed_tokens.weight") and (
                n == "lm_head.weight" or cfg["model_type"] != "phi3"):
            arr[BYTE_VOCAB:] = 0.0
        yield n, arr


def write_family(d: Path, cfg: dict, layers: int, np, bf16) -> int:
    (d / "config.json").write_text(json.dumps({
        **cfg, "num_hidden_layers": layers,
        "torch_dtype": "bfloat16" if bf16 else "float16"}))
    return write_safetensors(d, family_shapes(cfg, layers),
                             family_tensors(cfg, layers, np), np, bf16)


def write_gemma2_gguf(path: Path, cfg: dict, layers: int, np, bf16) -> None:
    """The Gemma-2 checkpoint's weights (their bf16 values) as a GGUF of
    arch gemma2 the llama.cpp way: matrices in Q8_0, the norms in f32
    with Gemma's 1 + w baked in, written by the port's writer."""
    from whisper_tensor_tpu_torch.backends.cpu.dequant import quantize_blocks
    from whisper_tensor_tpu_torch.importers.gguf import write_gguf
    from whisper_tensor_tpu_torch.packed_format import PackedFormat
    from whisper_tensor_tpu_torch.tensor import PackedTensor

    tensors = {}
    for n, arr in family_tensors(cfg, layers, np):
        if bf16 is not None:
            arr = arr.astype(bf16).astype(np.float32)
        if n.startswith("model.layers."):
            i, leaf = n[len("model.layers."):].split(".", 1)
            name = f"blk.{i}.{GEMMA2_GGUF[leaf]}"
        else:
            name = {"model.embed_tokens.weight": "token_embd.weight",
                    "model.norm.weight": "output_norm.weight"}[n]
        if arr.ndim == 1:
            tensors[name] = arr + 1.0
            continue
        with np.errstate(invalid="ignore", divide="ignore"):
            tensors[name] = PackedTensor(quantize_blocks(
                arr, PackedFormat.Q8_0), PackedFormat.Q8_0, arr.shape)
        del arr
    a = "gemma2."
    write_gguf(str(path), {
        "general.architecture": "gemma2", "general.name": "gemma-2-2b-widths",
        a + "block_count": layers, a + "embedding_length": cfg["hidden_size"],
        a + "attention.head_count": cfg["num_attention_heads"],
        a + "attention.head_count_kv": cfg["num_key_value_heads"],
        a + "attention.key_length": cfg["head_dim"],
        a + "feed_forward_length": cfg["intermediate_size"],
        a + "context_length": cfg["max_position_embeddings"],
        a + "vocab_size": cfg["vocab_size"],
        a + "attention.layer_norm_rms_epsilon": cfg["rms_norm_eps"],
        a + "rope.freq_base": cfg["rope_theta"],
        a + "attn_logit_softcapping": cfg["attn_logit_softcapping"],
        a + "final_logit_softcapping": cfg["final_logit_softcapping"]},
        tensors)


def additive_prefill(kind, ins) -> bool:
    """An Attention call with Sq > 1 and a 4-D float (additive) mask:
    flash_attention's additive mode where the wrapper takes the head dim
    and the call has no softcap."""
    q, mask = ins[0], ins[3] if len(ins) > 3 else None
    return (q.shape[-2 if q.ndim == 4 else 1] > 1 and mask is not None
            and mask.ndim == 4 and mask.is_floating_point())


def serve_family(torch, np, label: str, loader: str, path: Path,
                 layers: int, quantize: str, results) -> None:
    """One phase-12 model through the port's Server and its OpenAI HTTP
    API: phase 3's three requests (serve_three: every run of the step
    graph writes each layer's caches in one kv_write_pair launch); the
    launches of flash_attention equal the lowering's Sq > 1 additive
    Attention calls where the route takes them (head dim 256 without a
    softcap: Gemma, Gemma-3) and are 0 elsewhere (Gemma-2's softcap,
    Phi-3's head dim 96: the plain path, which must not raise);
    decode_attention never launches (the Gemma recipes' decode steps carry
    an additive mask, Phi-3's head dim is 96); int8 and packed launches
    equal the lowering's QuantMatMul and PackedMatMul calls; the greedy
    answer stands a teacher-forced prefill (phase 3's bound). That decode
    and prefill run again outside the counted run, each flash_attention,
    int8_matmul and packed_matmul call held against its plain version on
    the same inputs (flash_agreement_bound, agreement_bound): the
    family's own shapes, masks and lm_head."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.milli.ops import attention as attn_lowering
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    # installed before the model's plans are built, which keep it
    calls = CallCounter(("Attention",), where=additive_prefill)
    qspy, pspy = quant_spy(transforms), packed_spy(transforms)
    api = None
    try:
        srv = Server()
        t0 = time.perf_counter()
        (entry,) = srv.models.run_loader(loader, {
            "path": str(path), "dtype": "bf16", "quantize": quantize,
            "max_len": MAX_LEN})
        iface = srv._text_iface(entry)
        iface._weights()
        torch.cuda.synchronize()
        say(f"  {label} ({loader}, {layers} layers, {quantize or 'dense'} "
            f"bf16): loaded in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        api = OpenAIApi(srv, "127.0.0.1", 0).start()

        def snapshot():
            return {"Attention calls": calls.calls["Attention"],
                    "additive prefill calls": calls.matched["Attention"],
                    "QuantMatMul calls": qspy.calls,
                    "PackedMatMul calls": pspy.calls}

        calls.calls["Attention"] = calls.matched["Attention"] = 0
        qspy.calls = qspy.launched = pspy.calls = 0
        r1, launches, secs = serve_three(np, api.port, iface, {
            "flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "int8_matmul": int8_matmul,
            "packed_matmul": packed_matmul}, layers, snapshot)
    finally:
        if api is not None:
            api.stop()
        calls.restore()
        transforms.int8_matmul = qspy.inner
        transforms.packed_matmul = pspy.inner
    for res in results:
        if res["name"] in launches:
            res.setdefault("launches_phase12", {})[label] = \
                launches[res["name"]]
    flash_expected = (launches["additive prefill calls"]
                      if label.startswith(("gemma-3", "gemma-2b")) else 0)
    if launches["flash_attention"] != flash_expected or (
            flash_expected == 0) == label.startswith(("gemma-3", "gemma-2b")):
        fail(f"{label}: {launches['flash_attention']} flash_attention "
             f"launches, not the lowering's {flash_expected} Sq > 1 additive "
             f"Attention calls the route takes")
    if launches["decode_attention"] or launches["Attention calls"] <= 0:
        fail(f"{label}: the decode steps launched decode_attention, or no "
             f"Attention call ran: {launches}")
    if launches["int8_matmul"] != launches["QuantMatMul calls"] or \
            launches["packed_matmul"] != launches["PackedMatMul calls"] or \
            (quantize == "int8") != (launches["int8_matmul"] > 0) or \
            (quantize == "q4_0") != (launches["packed_matmul"] > 0):
        fail(f"{label}: the int8 and packed launches are not the lowering's "
             f"QuantMatMul and PackedMatMul calls: {launches}")
    # the greedy answer against a teacher-forced prefill (phase 3's (c)),
    # every kernel call held against its plain version
    tok = ByteTokenizer()
    prompt = np.asarray(tok.encode(GREEDY["prompt"]), np.int64)[None]
    shadows = {"flash_attention": flash_shadow(
        attn_lowering, flash_attention_plain, flash_agreement_bound)}
    try:
        shadows["int8_matmul"] = int8_shadow(transforms, agreement_bound)
        shadows["packed_matmul"] = packed_shadow(torch, transforms,
                                                 agreement_bound)
        toks, step_logits = iface.generate_with_logits(prompt, 32)
        P = prompt.shape[1]
        forced = iface.logits(np.concatenate([prompt, toks[:, :-1]], axis=1)
                              ).astype(np.float32)[:, P - 1:P + 31]
    finally:
        attn_lowering.flash_attention = shadows["flash_attention"].inner
        if "int8_matmul" in shadows:
            transforms.int8_matmul = shadows["int8_matmul"].inner
        if "packed_matmul" in shadows:
            transforms.packed_matmul = shadows["packed_matmul"].inner
    for name, sh in shadows.items():
        extra = (f", weights {sorted(sh.shapes)}"
                 if name == "int8_matmul" and sh.calls else "")
        say(f"  {label}: {sh.calls} {name} calls of the greedy decode and "
            f"its teacher-forced prefill against the plain version on "
            f"their inputs: worst |err|/bound {sh.worst:.4g} (max |err| "
            f"{sh.max_err:.5g}){extra}")
        if (sh.calls > 0) != (launches[name] > 0) or not sh.worst <= 1.0:
            fail(f"{label}: the {name} calls of the greedy decode were not "
                 f"all held within the bound of the plain version, or ran "
                 f"where the counted run launched none ({launches[name]})")
    if tok.decode(list(toks[0])) != r1["choices"][0]["text"]:
        fail(f"{label}: the interface's greedy tokens differ from the HTTP "
             f"text")
    scale = float(np.abs(forced).max())
    frac = 0.015 * math.sqrt(layers)
    diff = float(np.abs(forced - step_logits).max())
    say(f"  {label}: (d) decode vs teacher-forced prefill logits: "
        f"max_abs_diff={diff:.5g} ({diff / scale:.3%} of max|logit| "
        f"{scale:.4g}; tol {frac:.1%}), argmax agreement "
        f"{float((forced.argmax(-1) == toks).mean()):.3f}; served in "
        f"{secs:.2f} s on {card_line()}")
    if not diff <= frac * scale:
        fail(f"{label}: decode-step logits disagree with the prefill logits")


def phase12(torch, np, root: Path, layers: int, bf16, results) -> None:
    """Phase 12: Gemma-3 1B (q4_0), Gemma-2 2B (int8; then the same
    weights as a Q8_0 GGUF of arch gemma2), Gemma 2B and Phi-3-mini at
    their published widths through the port's Server (serve_family)."""
    say(f"phase 12: Gemma, Gemma-2, Gemma-3 and Phi-3 at published widths; "
        f"host RSS {host_rss_gb():.1f} GB")
    for name, (cfg, depth, quantize) in FAMILIES.items():
        depth = depth or layers
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        try:
            nbytes = write_family(d, cfg, depth, np, bf16)
            say(f"  wrote {name} ({depth} layers, {nbytes / 1e9:.2f} GB)")
            serve_family(torch, np, name, "transformers", d, depth, quantize,
                         results)
            free_memory(torch)
            if name == "gemma-2-2b":
                gg = d / "gemma-2-2b.gguf"
                write_gemma2_gguf(gg, cfg, depth, np, bf16)
                say(f"  wrote it as a Q8_0 GGUF of arch gemma2 "
                    f"({gg.stat().st_size / 1e9:.2f} GB)")
                serve_family(torch, np, "gemma-2-2b GGUF", "gguf", gg, depth,
                             "", results)
                free_memory(torch)
        finally:
            shutil.rmtree(d, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="transformer layers of the smoke model (32 = full "
                         "Llama-3-8B depth)")
    ap.add_argument("--plant-fault", action="store_true",
                    help="phase 4 writes every decode step's K/V one "
                         "position early; check (d) must fail")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (no result line)")
    ap.add_argument("--generic-only", action="store_true",
                    help="write the checkpoint and run phase 11 alone (no "
                         "result line)")
    ap.add_argument("--plans", action="store_true",
                    help="time packed_matmul and decode_attention under "
                         "forced splits, then stop (no result line)")
    args = ap.parse_args()
    if not (ROOT / "whisper_tensor_tpu_torch" / "csrc").is_dir():
        fail(f"no whisper_tensor_tpu_torch/csrc beside {Path(__file__).name}: "
             f"run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    import whisper_tensor_tpu_torch  # noqa: F401  (precision contract)

    card = card_line()
    say(f"phase 0: {card}; compute capability "
        f"{torch.cuda.get_device_capability(0)}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    try:
        import ml_dtypes
        say(f"  ml_dtypes {ml_dtypes.__version__} imports")
    except ImportError:
        say("  ml_dtypes does not import: bf16 crosses as f32 on the host")

    from whisper_tensor_tpu_torch.backends.cuda import build

    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    say(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {info.seconds:.1f} s) -> {info.path.relative_to(ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say(f"  {line.strip()}")
    from whisper_tensor_tpu_torch.backends.cuda import decode_attention as da
    from whisper_tensor_tpu_torch.backends.cuda import packed_matmul as pm

    index = torch.cuda.current_device()

    def per_sm(path, rows, bits, bf16, G):
        return "/".join(str(pm.kernel_limits(path, bm, bits, bf16, G, index)
                            .blocks_per_sm) for bm in rows)

    say(f"  blocks a multiprocessor, read on the card (occupancy): "
        f"decode_attention 32/8 heads {da.decode_limits(32, 8, 128, index)[1]}; "
        f"packed_matmul at 1/2/4/8/16 rows a block on the CUDA cores and "
        f"16/64 on the tensor cores: Q4_0 bf16 x "
        f"{per_sm('cores', pm.CORE_ROWS, 4, True, 32)} and "
        f"{per_sm('tensor', (16, 64), 4, True, 32)}, Q6_K (bits 8, G 16) "
        f"{per_sm('cores', pm.CORE_ROWS, 8, True, 16)} and "
        f"{per_sm('tensor', (16, 64), 8, True, 16)}, Q4_0 f32 x "
        f"{per_sm('cores', pm.CORE_ROWS, 4, False, 32)}")

    if args.plans:
        sweep_plans(torch)
        say(f"{card_line()} (--plans: phases 2-6 not run)")
        return
    results = []
    t_start = time.perf_counter()

    def step(label, fn, *a):
        """Run one step; print its seconds, the peak host RSS and the
        step's peak bytes on the card."""
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*a)
        say(f"[{label}: {time.perf_counter() - t0:.1f} s, peak host RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f}"
            f" GB, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on "
            f"the card, {time.perf_counter() - t_start:.0f} s since phase 2]")
        free_memory(torch)
        return out

    if args.generic_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        ckpt = ROOT / "build" / "smoke" / f"llama3-8b-widths-{args.layers}L"
        shutil.rmtree(ckpt, ignore_errors=True)
        ckpt.mkdir(parents=True)
        try:
            step("write the checkpoint", write_checkpoint, ckpt, args.layers,
                 np, bf16)
            step("phase 11 (the generic ONNX path)", phase11, torch, np,
                 ckpt, args.layers, results)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        say(f"{card_line()} (--generic-only: phases 2-10 not run)")
        return
    step("phase 2: decode_attention, int8_matmul", phase2, torch, results)
    step("phase 2: ragged_kv_write", phase2_kv_write, torch, results)
    step("phase 2: flash_attention", phase2_flash, torch, results)
    step("phase 2: packed_matmul", phase2_packed, torch, results)
    if args.kernels_only:
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--kernels-only: phases 3-6 not run)")
        return
    try:
        import ml_dtypes
        bf16 = np.dtype(ml_dtypes.bfloat16)
    except ImportError:       # the loader then reads f16 and casts
        bf16 = None
    ckpt = ROOT / "build" / "smoke" / f"llama3-8b-widths-{args.layers}L"
    gguf_path = ckpt.with_suffix(".gguf")
    gpt2_ckpt = ROOT / "build" / "smoke" / "gpt2-124m-widths"
    gptq_ckpt = ckpt.with_name(ckpt.name + "-gptq")
    for d in (ckpt, gpt2_ckpt):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    try:
        nbytes = step("write the checkpoint", write_checkpoint, ckpt,
                      args.layers, np, bf16)
        say(f"wrote a {args.layers}-layer Llama-3-8B-width checkpoint "
            f"({nbytes / 1e9:.2f} GB)")
        int8 = step("phases 3 and 5 (direct)", phase3, torch, np, ckpt,
                    args.layers, results)
        step("phases 4 and 5 (batched)", phase4, torch, np, ckpt,
             args.layers, results, args.plant_fault)
        q4_0 = step("phase 6a (q4_0 direct)", phase6a, torch, np, ckpt,
                    args.layers, results, int8)
        step("write the GGUF", write_smoke_gguf, gguf_path, args.layers, np,
             bf16)
        say(f"wrote the checkpoint as a Q4_K/Q6_K GGUF "
            f"({gguf_path.stat().st_size / 1e9:.2f} GB)")
        step("phase 6b (GGUF batched)", phase6b, torch, np, gguf_path,
             args.layers, results)
        nbytes = step("write the GPT-2 checkpoint", write_gpt2_checkpoint,
                      gpt2_ckpt, np, bf16)
        say(f"wrote a GPT-2 124M-width checkpoint ({nbytes / 1e9:.2f} GB)")
        step("phase 7 (GPT-2 batched, bf16 and int8)", phase7, torch, np,
             gpt2_ckpt, results)
        shutil.rmtree(gptq_ckpt, ignore_errors=True)
        gptq_ckpt.mkdir(parents=True)
        nbytes = step("write the GPTQ checkpoint", write_gptq_checkpoint,
                      gptq_ckpt, args.layers, torch, np, bf16)
        say(f"wrote the checkpoint as GPTQ ({nbytes / 1e9:.2f} GB)")
        step("phase 9 (GPTQ batched)", phase9, torch, np, gptq_ckpt,
             args.layers, results, q4_0)
        step("phase 10 (multi-LoRA, the profiler, cli --draft-model)",
             phase10, torch, np, ckpt, gpt2_ckpt, args.layers, bf16, results)
        step("phase 11 (the generic ONNX path)", phase11, torch, np, ckpt,
             args.layers, results)
        step("phase 12 (Gemma, Gemma-2, Gemma-3, Phi-3)", phase12, torch, np,
             ROOT / "build" / "smoke", args.layers, bf16, results)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(gpt2_ckpt, ignore_errors=True)
        shutil.rmtree(gptq_ckpt, ignore_errors=True)
        gguf_path.unlink(missing_ok=True)
    say(json.dumps({"kernels": results}))
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
