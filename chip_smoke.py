#!/usr/bin/env python3
"""Smoke run of the PyTorch port (whisper_tensor_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers N] [--plant-fault] [--kernels-only]
                          [--generic-only] [--image-only] [--train-only]
                          [--inspect-only] [--text-family-only]
                          [--speech-only] [--media-only] [--gguf-only]
                          [--parallel-only] [--train-parallel-only]
                          [--onnx-only] [--examples-only] [--lora-only]
                          [--long-context-only] [--windows-only]
                          [--plans]

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
     --layers, 2 by default, random weights from a seed) is written to
     disk, loaded by
     the port's Server through its loader (bf16, int8 weights, max_len
     2048), and served by its OpenAI HTTP API; three
     requests go through it, and the kernels' launch counters must rise;
     in this phase and in phases 4, 6 and 7 every run of the step graph
     must write each layer's K and V caches in one kv_write_pair launch.
     Then the greedy decode again: each decode_attention call against
     its plain version on the same inputs, the decode's logits with the
     plain version swapped in, and against a teacher-forced prefill;
     (l) decode_tokens for 8 tokens from the prefill's caches at its pos
     must give generate_tokens' tokens, with decode_attention and
     kv_write_pair launched once a layer a step-graph run, int8_matmul
     once a QuantMatMul call and flash_attention never;
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
     against phase 3's int8. (6b, under --gguf-only since phase 19 came)
     The same weights written by the port's
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
     must print the speculative decoder's text. Since phase 22 came,
     (l), (n) and `cli generate --draft-model` run only under
     `--lora-only` (the checkpoints written first), not in the default
     run, for its time limit; (m) stays in phases 3 and 4.
 11. the generic ONNX path (Model.eval and EvalBackend on the default
     device, the card): (a) every case of the CPU tests' conformance
     corpus (tests/torch_corpus.npz: all 2,453 cases; the 9
     ImageDecoder cases are held on the CPU only, with the count and the
     reason printed, where PIL does not import) at the case's own
     tolerances (a case that
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
     (int8; its weights as a Q8_0 GGUF of arch gemma2, dequantized on
     the host by the loader, under --gguf-only since phase 20 came),
     Gemma 2B and Phi-3-mini, each at its
     published widths (FAMILIES; the others 2 layers deep, Gemma-2's
     local and global layer both in) on seeded weights, bf16, max_len
     2048,
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
  13. SD-1.5 at its published widths (runwayml/stable-diffusion-v1-5:
     UNet 320/640/1280/1280, 2 layers a block, 8 heads, cross-attention
     768, 32 groups; CLIP ViT-L/14, 12 layers of 768, vocab 49,408, 77
     positions; VAE 128/256/512/512), seeded weights written as a
     diffusers directory in f16 safetensors, loaded in bf16 by the port's
     Server: one 512 x 512 request over /v1/images/generations at 20
     Euler steps and CFG 7.5 (the UNet at batch 2), flash_attention's
     launches equal to the lowering's eligible Attention calls (the
     UNet's unmasked self- and cross-attention at head dims 40, padded
     to 64, 80 and 160; CLIP's causal calls) and every call
     held against flash_attention_plain; a second request timed (seconds
     per image); one UNet step timed, its device time split by
     torch.profiler into attention, convolution, GroupNorm and the rest,
     and its output with the kernels against the plain attention path
     (within 4% of the output's scale); the VAE decode and its one-head
     D = 512 attention (the plain path) timed; img2img at strength 0.5
     and an inpaint with a half-image mask through the interface, every
     flash call shadowed; then `cli image` at 256 x 256 and 4 steps (its
     own load; in the default run phase 18 (d)'s `cli image` of the same
     weights as an LDM file stands in for it, held to this load's image
     at 512 x 512 and 2 steps). The PNGs must decode and not be constant. Phase 2 times
     flash's unmasked mode at the UNet's shapes (self-attention at
     4,096, 1,024 and 256 positions, D 40, 80, 160; cross-attention at
     4,096 x 77) against its bound, its plain version, SDPA at the
     native head dim and the other design (zero-padding to 64, 128 or
     256 against the kernel at D = 80 and 160). `--image-only` runs
     phase 13 alone.
  14. training (`--train-only` runs it alone after the build): (a) GPT-2
     124M at its published widths and depth (seeded weights), LMTrainer
     with AdamW and bf16 compute over f32 masters at B 8 x S 1,024: a warm
     step and 5 timed steps on a fixed batch, ms a step, tok/s, peak card
     GB and the step's device time by kernel kind (torch.profiler); the
     loss finite and falling, no flash_attention launch (the trainer's
     attention runs the plain path by design), step 1's loss within 2% of
     the f32 loss on the card. (b) QLoRA at Llama-3-8B's widths, --layers
     deep: rank-16 adapters on the seven projections over an int8-frozen
     base, bf16, remat, B 2 x S 512, a warm step and 8 steps on two
     batches of README.md bytes (bench.py's llama8b_lora_train); the
     loss falls, int8_matmul launches equal the lowering's QuantMatMul
     calls (forward and re-forward), int8_matmul_dx launches equal
     Int8MatMul's backward calls, each on the TMA path; ms a step and the
     int8 kernels' device ms in a profiled step, and ms a step again
     with every dx call on the cp.async path; the same steps run again
     with every int8_matmul_dx call held against its plain version
     (agreement_bound); the int8 base unchanged; the adapters through
     save_peft_adapter and load_peft_adapter_arrays. (c) The milli
     training graph (build_training_graph, AdamW) of a 2-layer GPT-2 at
     124M's widths, B 2 x S 128, one step through the executor: grad::*
     within 1e-3 of each tensor's largest |g| of autograd's (the f32
     trainer); the same in bf16 within 5%, flash_attention launching
     once an eligible forward Attention call. Phase 2 also holds
     int8_matmul_dx against its plain version at QLoRA's M = 1,024 over
     the Llama-3-8B weight shapes (each must take the TMA path) and one
     odd K and N, with each shape's path, time, host us a call, bound,
     the cp.async path's time and a bf16 yardstick, the TMA kernel's
     ptxas line (no spills), the build's seconds and the lm_head call's
     peak memory.
 15. the introspection path (`--inspect-only` writes the checkpoints
     and runs phases 13 and 15 alone after the build). (a)-(c) and (e)'s
     Llama export run at the end of phase 3, on its Server and its
     model, so the checkpoint loads once; (d) at the end of phase 13;
     (e)'s GPT-2 and (f) after phase 14. (a) phase 3's checkpoint (int8,
     bf16; under --inspect-only loaded by run_loader over the port's
     WebSocket server), its super graph fetched (get_super_graph,
     16 new tokens) and sent back unchanged as a super_graph_request on
     a 200-token prompt (the card, the default backend mode):
     decode_attention launches 15 x layers, flash_attention layers,
     ragged_kv_write 2 x 16 x layers (one a cache a run: Model.eval runs
     no pair pass), each equal to the lowering's calls, int8_matmul
     equal to the QuantMatMul calls; every attention call held against
     its plain version; the answer stands a teacher-forced prefill
     (phase 3's bound); (b) the job with tensor_subscriptions on
     first_token and layer 0's attention output (a tap of the step
     graph's executor): one report of the link and 16 of the label,
     the label's prefill value within flash_agreement_bound of a prefill
     on the plain attention path, the job's seconds with and without the
     taps; (c) get_graph_layout (every op placed, edges down),
     get_op_milli of an Attention and a MatMul, get_tensor_slice of an
     embedding row against the checkpoint; (d) at the end of phase 13:
     generate_image over the WebSocket at 4 steps, plainly and with
     `preview` (one step_preview frame a step, flash launches equal to
     the eligible calls, the same 7 model runs with bit-equal feeds and
     outputs, and the image equal to the plain one byte for byte);
     (e) `cli export` of phase 7's GPT-2 (embedded) and of the Llama
     checkpoint (external weights), each reloaded with
     Model.new_from_onnx_file and its logits bit-equal to the original
     model's; `cli inspect` of GPT-2; (f) phase 14 (c)'s milli training
     graph as a training super graph of 3 steps on one batch, its losses
     bit-equal to 3 direct steps of the executor (deterministic
     algorithms on) and falling.
 16. the rest of the text family at published widths, seeded weights,
     bf16 (`--text-family-only` runs it alone after the build). In each
     counted run every kernel counter is 0 just before and read just
     after, and flash_attention, decode_attention, int8_matmul,
     kv_write_pair and ragged_kv_write launch exactly as often as the
     lowering's eligible calls (flash_mode's and pos_mode's choices,
     QuantMatMul, KVWrite and DynUpdateSlice calls); a rerun holds
     every kernel call against its plain version. (a) DeepSeek-V2-Lite
     (2 layers: one dense, one MoE of 64 experts; int8; max_len 2048),
     a 512-token prompt and 32 new tokens over /v1/completions with the
     absorbed and the naive MLA build: no attention kernel launches and
     the latent and rope-key caches are written unpaired; each build's
     decode stands its teacher-forced prefill (phase 3's bound), the
     naive build's teacher-forced logits the absorbed decode's within
     1/16 of each row's largest |logit| (C10); the plain MLA attention
     call's time at 2,048 keys, a decode step's QuantMatMul calls and
     the MoE layer's share. (b) flan-t5-base at full depth through `cli
     generate`, greedy and --num-beams 4, 64 tokens: the caches written
     one pair a layer, no attention kernel; the texts equal the
     interface's, its greedy decode stands a teacher-forced decoder
     pass. (c) RWKV-7 at World 1.5B widths, 4 layers, a torch.save'd
     .pth and a seeded World vocabulary: a 512-token scan and 64 tokens
     of stepwise feedback (timed); 64 tokens of the served greedy loop
     over the WebSocket and /v1/completions, on the prompt's first 32
     tokens, equal to stepwise feedback's. (d) LLaVA-1.5-7B (the
     CLIP ViT-L/14-336 tower at 4 layers, the Llama-2-7B text model at 2,
     int8): one seeded 336 x 336 PNG through generate_multimodal over
     the WebSocket and through /v1/chat/completions with an image
     content part; flash_attention in the tower and the embeds prefill,
     decode_attention in the decode; the decode stands a teacher-forced
     embeds prefill. Each family prints its load seconds, prefill or
     scan ms, decode tok/s and card bytes. Since phase 20 came the
     default run leaves out (a)'s naive build and its check against the
     absorbed one and runs (c) at 2 layers, and since phase 22 came it
     leaves out (b), for its time limit; `--text-family-only` runs them
     all as above.
 17. speech at published widths, seeded weights (`--speech-only` runs it
     alone after the build, with the 34 recurrent and spectral corpus
     cases of phase 11 (a)). (a) Whisper at openai/whisper-large-v3's
     widths (d_model 1280, 20 heads of 64, FFN 5120, 128 mel bins,
     vocabulary 51866, 1500 source and 448 target positions), bf16, at
     the published 32 + 32 layers under --speech-only and 4 + 4 in the
     default run (the smoke's time limit), with its
     generation_config.json's four-token start sequence: a seeded 30 s
     clip through /v1/audio/transcriptions (multipart WAV), the
     WebSocket `transcribe` greedy and with beams of 4, and
     `transcribe_stream` in 1 s feeds, a 75 s clip through
     transcribe_long, and the direct referee loop, in one counted run
     (flash_attention and ragged_kv_write launch as often as the
     lowering's eligible calls; the plain-path attention calls of the
     decode steps counted), then `cli stt` of the 30 s clip; the greedy
     tokens equal the referee's and the cli's text the route's; the
     decode's step logits and a teacher-forced pass on the kernels stand
     C10's rule against a teacher-forced pass on the plain path; a
     rerun holds every flash call against its plain version; load s,
     mel ms, encoder ms, prefill ms, decode tok/s and card GB. (b) the
     synthetic piper, kokoro and F5-TTS sets (tests/torch_tts_sets.py)
     through /v1/audio/speech, `generate_speech` and `cli tts`: their
     samples within 1e-5 of the port on the CPU.
 18. SDXL, SD3 and Flux at published widths, seeded bf16 weights written
     as diffusers directories (stabilityai/stable-diffusion-xl-base-1.0,
     stabilityai/stable-diffusion-3-medium-diffusers with T5-XXL at
     T5_LAYERS of 24 layers and t5_seq_len 256, black-forest-labs/
     FLUX.1-dev at FLUX_DEPTH of 19 + 38 blocks and t5_seq_len 512),
     `--media-only` at full depth, 1,024 x 1,024 and 4 steps, the default
     run at one block or layer a stage, 512 x 512 and 2 steps. Each
     through the port's Server: one /v1/images/generations request with
     every kernel counter 0 before it, flash_attention's launches equal
     to flash_mode's eligible Attention calls and no other kernel; the
     plain-path calls counted and named (the VAE's head dim 512, T5's
     per-head bias; any other fails); the interface's image for the same
     seed equal to the route's; one denoise step timed, then shadowed
     (every flash call against flash_attention_plain within
     flash_agreement_bound); the VAE decode timed; load s, s an image
     and peak card GB; (a) SDXL also img2img (shadowed) and `cli image`
     (its own load, the route's image). (d) SD-1.5's seeded weights
     (phase 13's directory, kept for it) renamed into one CompVis
     single file by the port's ldm maps: `cli image` at 512 x 512 and 2
     steps on the file gives the image of the directory (phase 13's
     load; under --media-only `cli image` of it) byte for byte. (e), under
     --media-only: the 66 vision corpus cases (phase 11 (a) runs them in
     the default run). Phase 2 also times flash's unmasked mode at the
     pipelines' attention shapes (MEDIA_FLASH).
  19. parallelism (`parallel/`), right after phase 3 on its checkpoint.
     (a) Two spawned ranks sharing the card over gloo (NCCL refuses two
     ranks on one device) load it at tp=2 through the port's loader and
     TextInferenceInterface(mesh=, shard_rules=LLAMA_RULES) (int8, a
     bf16 cache, max_len 2048) and decode 16 greedy tokens of a 24-token
     prompt (under --parallel-only also the 1,900-token prompt, and a
     q4_0 build): each rank's kernel launches equal its local
     lowering's eligible calls (counter 0 before, read after), a rerun
     holds every kernel call against its plain version, the tokens equal
     the single rank's (phase 3's model) up to a near tie and the logits
     teacher-forced on its answer lie within C10 of each step's largest
     |logit|; each rank prints its load s, TTFT, decode tok/s, card GB
     and the host ms a step spent in collectives. (c) On the same world:
     ring attention (causal and not), moe_ffn at ep=2 and
     pipeline_apply at pp=2 with its gradients, each within 1e-4 of the
     single-rank result's largest |value|. (b) A world of one under
     NCCL: the mesh path at tp=1, its tokens the single rank's, its
     collectives counted (beside (a) in the default run, after it under
     --parallel-only, which also asks gloo directly which collectives
     it takes on CUDA tensors, each in its own pair of processes).
     `--parallel-only` writes the checkpoint, builds the single-rank
     int8 and q4_0 references and runs phase 19 alone.
  20. training across ranks (`LMTrainer(mesh=, rules=, fsdp=)`, the
     sharded checkpoint, `PipelinedLMTrainer`), `--train-parallel-only`:
     (g) a world of one under NCCL: LMTrainer(mesh=make_mesh()) on phase
     14 (a)'s model (f32, B 8 x S 1,024, 2 steps) against the trainer
     without a mesh (losses within 1e-6 relative, params within 1e-6 of
     each tensor's largest |p|), and (f)'s pp=1 reference. Then two
     ranks sharing the card over gloo, each case against rank 0's
     single-rank trainer on the same card and batch: (a) GPT-2 124M at
     dp=2, AdamW, B 8 x S 1,024, 3 f32 steps (losses within rtol 2e-4,
     atol 1e-5) and 4 bf16 steps (rtol 2e-2; timed); (b) (a) under FSDP,
     the masters' and AdamW state's bytes a rank beside (a)'s; (c)
     Llama-3-8B widths, 2 layers, full-parameter AdamW in f32, LLAMA_RULES,
     B 1 x S 1,024, tp=2, 2 steps, no fallback of the tp pass, a sharded
     checkpoint that the single-rank trainer loads and whose next step
     equals the world's; (d) (c)'s model at sp=2, SGD (each rank holds
     the whole model under sp: two copies with AdamW's state do not fit
     one card); (e) QLoRA at dp=2
     (phase 14 (b)'s setup, --layers deep, 4 steps): int8_matmul and
     int8_matmul_dx launches a rank equal to the lowering's QuantMatMul
     and Int8MatMul backward calls (each dx launch on the TMA path), a
     rerun with every such call held to agreement_bound, the int8
     kernels' device ms in a profiled step, the adapters within 2 x
     steps x lr plus a bf16 ulp of the single rank's; (f)
     PipelinedLMTrainer over GPT-2 124M at pp=2, 4 microbatches, losses
     against pp=1. Each prints load s, ms a step,
     tok/s, card GB a rank and the collectives' calls and host ms a
     step. The default run carries (e) at one layer for 2 steps in phase
     19's gloo world and (g) at B 2 x S 512 in its world of one.
  21. the compiler facade and ONNX files as a model source, on phase 3's
     checkpoint (bf16, ragged_decode): (a) build_program over phase 11
     (c)'s Model runs its 1,900-token prefill and 8 greedy decode steps
     on the card: tokens equal to Model.eval's, logits bit for bit or
     within phase 3's bound (printed which), launches of flash_attention
     (2 at 2 layers), decode_attention (16) and ragged_kv_write (36)
     equal to the lowering's calls, backend "torch"; a second, shadowed
     run holds each launch against its plain version and uploads no
     weight byte (the default run makes (a)'s first run and its checks
     inside phase 11 (c), without the second run, its launches in the
     kernels' line as launches_program). `--onnx-only` writes the
     checkpoint and runs (a) whole on its own load, then (b)
     Model.save_onnx(weights="external") of that model (file sizes,
     export and load seconds) loaded back by the Server's `onnx` loader:
     tokens and logits bit for bit (a)'s; (c) the llama recipe over
     SafetensorsStore.lazy getters with WeightStorage.origin_reference():
     no weight payload in the file, loaded by the `onnx` loader, (a)'s
     tokens, logits bit for bit or within phase 3's bound; it ends with
     the result line.
  22. the port's examples (`--examples-only`, after the build; not in
     the default run): each of the 13 examples/torch_port/*.py through
     its main(argv) in this process (multihost_train starts its two
     ranks as processes, gloo on the one card), at its defaults; the
     --model ones on seeded checkpoints written here: serve_clients on
     phase 3's Llama-3-8B-width checkpoint (--layers deep; 8 clients, 32
     tokens, --prefix 64, --prefill-chunk 128), sd_image on phase 13's
     SD-1.5 (512 x 512, 4 steps), llava_chat on phase 16's LLaVA-1.5-7B
     widths (a seeded 336 x 336 .ppm), whisper_stt on phase 17's
     whisper-large-v3 widths at 4 + 4 layers (a seeded 30 s 16 kHz
     .wav), tts_speak on the synthetic piper voice. Each must exit
     without error, print its output line and run on cuda; with every
     kernel counter 0 just before its main and read just after, each
     kernel's launches must equal the lowering's eligible calls, and the
     kernels of its path (EXAMPLE_RUNS) must have launched. It prints
     each example's wall time, peak card GB and launches, a JSON line of
     them, and the result line.
  23. the long-context path (`--long-context-only`, after the build; not
     in the default run, for its time limit). (a) The kernels at its new
     shapes, each held against its plain version and timed against its
     bound and the library call: flash_attention pos-bound at B 2, 32/8
     heads, S 8,192 and 16,384 query rows over S + 512 keys (the first
     and the last 128 rows held, over every key: the plain version's
     scores of a whole prompt do not fit the card), decode_attention
     over 16,896 slots at pos 16,384 and 16,895, int8_matmul as the full
     graph's 16k lm_head (M 32,768 x N 128,256: 4.2e9 outputs, past
     2^31; held in row blocks), the prefill's kv_write_pair of 16,384
     rows (bit for bit). (b) Llama-3-8B widths at 4 layers on seeded
     weights (checkpoint_tensors), the llama recipe built from that one
     getter with logits_last_only=True and without, at S 8,192 and
     16,384 (max_len S + 512, int8, a bf16 cache, the one bucket S, B 2
     prompts that fill it); the first interface quantizes, the other
     three take its int8 weights by quantize_precomputed (their device
     tensors the first's, checked). For each S and graph that fits (a
     graph that does not is recorded): TTFT (median of 3), 32 greedy
     decode steps at pos S (decode_tokens, ms a step and tok/s), peak
     card GB and each kernel's launches against the lowering's eligible
     calls (every counter 0 just before, read just after); the
     constructor's s and the card GB each upload added, the caches' GB;
     the last-only and full graphs' greedy tokens equal at 8,192; one
     16k prefill's device time by kernel kind (torch.profiler); at
     16,384 a rerun with every decode_attention, int8_matmul and cache
     write held against its plain version (the writes bit for bit) and
     each flash call's first and last 128 rows; a shorter prompt than its
     bucket refused with a ValueError naming logits_last_only. It prints
     a JSON line of its readings and the result line.
  24. windowed decode (`--windows-only`, after the build; not in the
     default run, for its time limit). (e) The five kernels at the
     window shapes, each held against its plain version and timed beside
     its bound and a library call: flash_attention pos-bound over the
     first window's 256 keys, decode_attention in the 256 and 1,024
     windows and over 16,384 slots at the same positions, int8_matmul
     and packed_matmul at B 8, the decode step's and a bucket-512
     admission's cache-write pairs and ragged_kv_write (bit for bit).
     Then Llama-3-8B widths at 4 layers on seeded weights
     (write_checkpoint), int8, a bf16 cache: (a) the transformers loader
     with decode_windows=256,1024 at max_len 16,384, the windowed
     interface and a flat one on its device weights, B 8 prompts of 100
     tokens and 200 greedy tokens: the tokens (win_agree: equal up to
     each row's first difference, a near tie in bf16 since the kernels
     split keys by the cache's length, and standing a teacher-forced
     prefill), TTFT, decode ms a step,
     peak card GB, each upload's card bytes (the windowed one no more
     than the flat weight set), launches against the lowering's eligible
     calls (every counter 0 just before, read just after), then a rerun
     with every kernel call held against its plain version (the cache
     pairs bit for bit); (b) bench.py:544-562's serving arm: ragged graphs
     at max_len 8,192, bucket windows 16-512, 16 requests of 10-500
     tokens at once through the batcher with window admission and again
     without, each answer against the other, the sequential direct path
     and a teacher-forced prefill, the card's peak above the weights and
     slots, tok/s, the admissions' cache lengths; (c) one OpenAI
     completion and one `cli generate` over the windowed bundle, equal to
     (a)'s text; (d) phase 6b's smoke GGUF with decode_windows, packed:
     windowed tokens against flat (win_agree), packed_matmul launches
     equal the
     lowering's calls, a shadowed rerun with packed_matmul's calls too.
     It also runs phase 2's int8_matmul_dx (not on this path) for the
     kernels' line, and prints a JSON line of its readings and the result
     line.
Each step prints its seconds, the peak host RSS and its peak bytes on
the card. The last three lines are the kernels' JSON summary line, the
card, and the result line.
"""

from __future__ import annotations

import argparse
import base64
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
import types
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
            if M in (4, 5):
                # the speculative verify block's rows (k = 4, 5): the
                # bound and the library call beside the two paths
                bms, bby = bound(K * N + 4 * N + 2 * M * (K + N),
                                 2 * M * K * N)
                try:
                    calls = [(int8pack_call(torch, *st),) for st in sets[:2]]
                    lib = f"{device_time_ms(torch, lambda f: f(), calls):.4f}"
                except RuntimeError as e:
                    lib = f"raised ({str(e)[:60]})"
                line.append(f"(M={M} bound {bms:.4f} ms ({bby}), "
                            f"_weight_int8pack_mm device {lib})")
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


# Llama-3-8B's int8 products as QLoRA trains them: (K, N) of W, x (M, K)
DX_SHAPES = (("q/o", 4096, 4096), ("k/v", 4096, 1024),
             ("gate/up", 4096, 14336), ("down", 14336, 4096),
             ("lm_head", 4096, 128256), ("odd K and N", 1000, 771))
DX_ROWS = 1024          # QLoRA's M = B 2 x S 512 (phase 14 (b))


def phase2_int8_dx(torch, results):
    """int8_matmul_dx (the backward of int8_matmul for x) against its
    plain version at QLoRA's M = 1,024 over the Llama-3-8B weight shapes
    and one odd K and N: each shape's path (dx_plan), error against
    agreement_bound, the kernel's, the plain version's and the cp.async
    path's median time at the same shape (CUDA events), the host's
    microseconds a call, the bound (the larger of its bytes over 3.35
    TB/s and 2 M K N over 989 TFLOP/s) and a yardstick timed in the same
    call, dy @ W^T with W already in bf16 (the product without the scale
    or the int8 weight; no single PyTorch call computes the scaled int8
    function, so library_ms is null). Then the TMA kernel's ptxas line,
    the build's seconds and the lm_head call's peak memory beside its
    operands'. Fails where a QLoRA shape takes the cp.async path."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound, build
    from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul_dx, int8_matmul_dx_plain)

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    say("  int8_matmul_dx (dx = (dy * scale) @ W_i8^T, bf16 dy, M = "
        f"{DX_ROWS}; tolerance per element: agreement_bound, plain version "
        "on |dy| and |W|; yardstick: dy @ W^T with W already in bf16)")
    worst, timing, shapes = 0.0, None, {}
    M = DX_ROWS
    for label, K, N in DX_SHAPES:
        plan = qm.dx_plan(M, K, N, torch.bfloat16, card)
        if label != "odd K and N" and plan.path != "tma":
            fail(f"int8_matmul_dx: the QLoRA shape {label} took the "
                 f"{plan.path} path")
        sets = []
        for _ in range(copies_for(K * N + M * N * 2)):
            sets.append((torch.randn(M, N, generator=gen, device=dev)
                         .bfloat16(),
                         torch.randint(-127, 128, (K, N), generator=gen,
                                       device=dev, dtype=torch.int8),
                         torch.rand(N, generator=gen, device=dev) * 0.01
                         + 1e-3))
        dy, w, sc = sets[0]
        if label == "lm_head":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        got = int8_matmul_dx(dy, w, sc)
        if label == "lm_head":
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
        err, share = worst_share(
            got, int8_matmul_dx_plain(dy, w, sc),
            int8_matmul_dx_plain(dy.float().abs(), w.abs(), sc),
            agreement_bound)
        del got
        big = K * N >= 1 << 28
        slow = dict(reps=3, inner=1) if big else {}
        ms = time_ms(torch, int8_matmul_dx, sets)
        dev_ms = device_time_ms(torch, int8_matmul_dx, sets,
                                **(dict(reps=3, inner=5) if big else {}))
        h_us = host_us(torch, int8_matmul_dx, sets, inner=20 if big else 100)
        plain_ms = time_ms(torch, int8_matmul_dx_plain, sets[:2], **slow)
        cp_plan = qm._dx_path_plan("cp.async", M, K, N, True, card)
        cp_ms, cp_dev = (ms, dev_ms) if plan.path == "cp.async" else (
            time_ms(torch, lambda d, w, s: qm._dx_launch(d, w, s, cp_plan),
                    sets),
            device_time_ms(torch, lambda d, w, s: qm._dx_launch(
                d, w, s, cp_plan), sets,
                **(dict(reps=3, inner=5) if big else {})))
        wbf = w.bfloat16()
        yard_ms = time_ms(torch, lambda d: torch.matmul(d, wbf.t()),
                          [(d,) for d, _, _ in sets[:2]], **slow)
        del wbf
        bms, bby = bound(M * N * 2 + K * N + N * 4 + M * K * 2,
                         2 * M * K * N)
        say(f"  int8_matmul_dx {label} M={M} K={K} N={N}: {plan.path} path"
            f" ({plan.splits} splits of {plan.split_cols} columns): "
            f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; kernel "
            f"{ms:.4f} ms ({bms / ms:.1%} of the bound, {ms / yard_ms:.2f}x "
            f"the yardstick), device {dev_ms:.4f} ms, host {h_us:.1f} us a "
            f"call; cp.async path {cp_ms:.4f} ms ({cp_ms / yard_ms:.2f}x, "
            f"{cp_plan.splits} splits), device {cp_dev:.4f} ms; plain "
            f"{plain_ms:.4f} ms, bf16 yardstick {yard_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({bby})")
        if not share <= 1.0:
            fail(f"int8_matmul_dx disagrees with its plain version ({label},"
                 f" M={M}, K={K}, N={N}): err/tol {share}")
        worst = max(worst, err)
        shapes[f"{label} M={M} K={K} N={N}"] = {
            "path": plan.path, "splits": plan.splits, "ms": ms,
            "device_ms": dev_ms, "host_us": h_us, "cp_async_ms": cp_ms,
            "cp_async_device_ms": cp_dev, "plain_ms": plain_ms,
            "yardstick_ms": yard_ms, "bound_ms": bms, "bound_by": bby,
            "worst_share": share}
        if label == "lm_head":
            timing = (ms, plain_ms, f"{label} M={M} K={K} N={N}", bms, bby,
                      yard_ms)
        del sets, dy, w, sc
        torch.cuda.empty_cache()
    info = build.build_info()
    log = info.log.splitlines() if info else []
    seen = set()
    for i, line in enumerate(log):
        if "Function properties for" in line and "dx_wgmma_kernel" in line:
            kind = "bf16" if "ILb1E" in line else "f32"
            text = "; ".join(x.split(":", 1)[-1].strip()
                             for x in log[i + 1:i + 3])
            if kind in seen:
                continue
            seen.add(kind)
            say(f"  ptxas, the TMA path's kernel, {kind} dy: {text}")
            if "0 bytes spill stores, 0 bytes spill loads" not in text:
                fail(f"int8_matmul_dx: the TMA path's kernel spills "
                     f"({kind} dy)")
    if not seen:
        say("  ptxas: no log (the library was loaded as built by an earlier "
            "process)")
    say(f"  the library's build: {info.seconds if info else 0.0:.1f} s "
        f"(0.0: loaded as built); the lm_head call's peak above what was "
        f"allocated: {peak_mb:.1f} MB (dx {M * 4096 * 2 / 1e6:.1f} MB; the "
        f"cp.async path's hi and lo scratch would be "
        f"{4 * M * 128256 / 1e6:.1f} MB)")
    results.append({
        "name": "int8_matmul_dx", "route": "cuda",
        "source": "whisper_tensor_tpu_torch/csrc/int8_matmul_dx.cu",
        "replaces": "whisper_tensor_tpu/backends/pallas/quant_matmul.py:68",
        "launches": None, "max_abs_err": worst, "ms": timing[0],
        "plain_ms": timing[1], "bound_ms": timing[3], "bound_by": timing[4],
        "library_ms": None, "yardstick_ms": timing[5], "shape": timing[2],
        "lm_head_peak_mb": peak_mb,
        "note": "the port's backward of int8_matmul for x (QLoRA's frozen "
                "base); the JAX package has no Pallas backward",
        "shapes": shapes})


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
    # at 64 slots, the direct path's scalar start (S 1 and 32), f32 and
    # f16 into bf16, bf16 and f16 into f32; the same positions as above
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
        # a bf16 (or f16) model over the text interface's default f32
        # cache, the update widened to f32 in the kernel (modes 4 and 5)
        ("bf16 into f32 direct pair", 1, 32, 1024, 128, 1, torch.float32,
         torch.bfloat16, 600),
        ("f16 into f32 direct pair", 1, 32, 1024, 128, 1, torch.float32,
         torch.float16, 600),
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


# the SD-1.5 UNet's unmasked attention at a 512 x 512 image (the CFG
# pair, 8 heads): self-attention at the 64 x 64, 32 x 32 and 16 x 16
# latents' 4,096, 1,024 and 256 positions (head dims 40, 80, 160), and
# the cross-attention over the 77 text tokens at 4,096 positions
SD_FLASH = (("(sd-i) UNet self 4096, D=40", 2, 8, 4096, 4096, 40),
            ("(sd-ii) UNet self 1024, D=80", 2, 8, 1024, 1024, 80),
            ("(sd-iii) UNet self 256, D=160", 2, 8, 256, 256, 160),
            ("(sd-iv) UNet cross 4096 x 77, D=40", 2, 8, 4096, 77, 40))


def phase2_flash_sd(torch, results):
    """flash_attention's unmasked mode at the SD UNet's shapes, as the
    Attention lowering calls it (`_flash`, "none": at a head dim the
    kernel lacks, q, k and v zero-padded, the kernel, the output sliced
    back). Held to flash_agreement_bound of the plain version at the
    native head dim; timed beside the other design (padding to 64, 128
    or 256 against the native head dim), the kernel alone on padded
    inputs, the plain version, SDPA at the native head dim and the bound
    of the native work (q, k, v and out read or written once; 4 D
    operations a (query, key) pair, every pair visible)."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        HEAD_DIMS, flash_agreement_bound, flash_attention,
        flash_attention_plain, flash_splits)
    from whisper_tensor_tpu_torch.milli.ops.attention import (_flash,
                                                             flash_head_dim)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    card = torch.cuda.current_device()
    entry = next(r for r in results if r["name"] == "flash_attention")
    pad = torch.nn.functional.pad
    for label, B, H, Sq, Skv, D in SD_FLASH:
        Dp = flash_head_dim(D)
        nbytes = (2 * B * H * Sq + 2 * B * H * Skv) * D * 2
        sets = []
        for _ in range(copies_for(nbytes)):
            # the recipe's layout: (B, S, H, D) transposed to (B, H, S, D)
            q = torch.randn(B, Sq, H, D, generator=gen,
                            device=dev).bfloat16().transpose(1, 2)
            k, v = (torch.randn(B, Skv, H, D, generator=gen,
                                device=dev).bfloat16().transpose(1, 2)
                    for _ in range(2))
            sets.append((q, k, v))
        q, k, v = sets[0]
        scale = 1.0 / math.sqrt(D)

        def routed(q, k, v):
            return _flash("none", q, k, v, None, scale)

        got = routed(q, k, v)
        ref = flash_attention_plain(q, k, v, scale)
        err, share = worst_share(got, ref, flash_attention_plain(
            q, k, v.abs(), scale), flash_agreement_bound)
        del ref, got
        # the two designs, timed in turns: zero-padding to the next of
        # 64, 128 and 256 (the JAX package's), and the kernel at the
        # native head dim where it has one (80, 160)
        Dpad = next(h for h in (64, 128, 256) if h >= D)
        padded = [tuple(pad(t, (0, Dpad - D)).contiguous() for t in st)
                  for st in sets]
        ms = time_ms(torch, routed, sets)
        dev_ms = device_time_ms(torch, routed, sets)
        kern_ms = time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, scale), padded)
        pad_route_ms = time_ms(torch, lambda q, k, v: flash_attention(
            *(pad(t, (0, Dpad - D)) for t in (q, k, v)), scale)[..., :D],
            sets)
        native_ms = (time_ms(torch, lambda q, k, v: flash_attention(
            q, k.contiguous(), v.contiguous(), scale), sets)
            if D in HEAD_DIMS else None)
        big = Sq * Skv >= 4096 * 4096
        plain_ms = time_ms(torch, lambda q, k, v: flash_attention_plain(
            q, k, v, scale), sets[:2], reps=3 if big else 7,
            inner=1 if big else 5)
        calls = [(sdpa_gqa(torch, q, k, v, None, scale),)
                 for q, k, v in sets[:2]]
        lib_ms = time_ms(torch, lambda f: f(), calls)
        lib_dev = device_time_ms(torch, lambda f: f(), calls)
        io = (2 * B * H * Sq + 2 * B * H * Skv) * D * 2
        flops = 4 * D * B * H * Sq * Skv
        bms, bby = bound(io, flops)
        splits, _ = flash_splits(B, H, H, Sq, Skv, Dp, card)
        say(f"  flash_attention {label} unmasked B={B} H={H} Sq={Sq} "
            f"Skv={Skv} D={D} (the kernel at D={Dp}, {splits} key splits): "
            f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; routed "
            f"(pad, kernel, slice) {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f}"
            f" TFLOP/s of the native work), device {dev_ms:.4f} ms "
            f"({bms / dev_ms:.1%} of the bound); padded to {Dpad}: the "
            f"route {pad_route_ms:.4f} ms, the kernel alone {kern_ms:.4f} "
            f"ms; native D={D}: "
            f"{'n/a' if native_ms is None else f'{native_ms:.4f} ms'} "
            f"(k, v made contiguous in the call); plain {plain_ms:.4f} ms; SDPA at D={D}"
            f" {lib_ms:.4f} ms (routed/SDPA {ms / lib_ms:.2f}), SDPA device "
            f"{lib_dev:.4f} ms; bound {bms:.4f} ms ({bby})")
        if not share <= 1.0:
            fail(f"flash_attention's unmasked route disagrees with its "
                 f"plain version ({label}): err/tol {share}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["shapes"][label] = {
            "ms": ms, "device_ms": dev_ms, "kernel_padded_ms": kern_ms,
            "padded_route_ms": pad_route_ms, "native_ms": native_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "bound_ms": bms, "splits": splits}
        del sets, padded, calls, q, k, v
        torch.cuda.empty_cache()


# the unmasked mode at the media pipelines' shapes: SD3's joint attention
# (4,096 latent + 77 CLIP + 256 T5 rows, the CFG pair, 24 heads of 64),
# Flux's (4,096 + 512 rows, 24 heads of 128) and SDXL's self-attention at
# the 64 x 64 and 32 x 32 latent levels of a 1,024 x 1,024 image
MEDIA_FLASH = (("(m-i) SD3 joint 4429, D=64", 2, 24, 4429, 4429, 64),
               ("(m-ii) Flux joint 4608, D=128", 1, 24, 4608, 4608, 128),
               ("(m-iii) SDXL self 4096, D=64", 2, 10, 4096, 4096, 64),
               ("(m-iv) SDXL self 1024, D=64", 2, 20, 1024, 1024, 64))


def phase2_flash_media(torch, results):
    """flash_attention's unmasked mode at MEDIA_FLASH's shapes, as the
    Attention lowering calls it (`_flash`, "none"): held to
    flash_agreement_bound of the plain version, timed (CUDA events and
    the device alone) beside the plain version and SDPA, against the
    bound (q, k, v and out read or written once; 4 D operations a
    (query, key) pair)."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention_plain, flash_splits)
    from whisper_tensor_tpu_torch.milli.ops.attention import _flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    card = torch.cuda.current_device()
    entry = next((r for r in results if r["name"] == "flash_attention"),
                 None)
    for label, B, H, Sq, Skv, D in MEDIA_FLASH:
        nbytes = (2 * B * H * Sq + 2 * B * H * Skv) * D * 2
        sets = []
        for _ in range(copies_for(nbytes)):
            # the recipes' layout: (B, S, H, D) transposed to (B, H, S, D)
            q, k, v = (torch.randn(B, S, H, D, generator=gen,
                                   device=dev).bfloat16().transpose(1, 2)
                       for S in (Sq, Skv, Skv))
            sets.append((q, k, v))
        q, k, v = sets[0]
        scale = 1.0 / math.sqrt(D)

        def routed(q, k, v):
            return _flash("none", q, k, v, None, scale)

        got = routed(q, k, v)
        ref = flash_attention_plain(q, k, v, scale)
        err, share = worst_share(got, ref, flash_attention_plain(
            q, k, v.abs(), scale), flash_agreement_bound)
        del ref, got
        ms = time_ms(torch, routed, sets)
        dev_ms = device_time_ms(torch, routed, sets)
        plain_ms = time_ms(torch, lambda q, k, v: flash_attention_plain(
            q, k, v, scale), sets[:2], reps=3, inner=1)
        calls = [(sdpa_gqa(torch, q, k, v, None, scale),)
                 for q, k, v in sets[:2]]
        lib_ms = time_ms(torch, lambda f: f(), calls)
        lib_dev = device_time_ms(torch, lambda f: f(), calls)
        flops = 4 * D * B * H * Sq * Skv
        bms, bby = bound(nbytes, flops)
        splits, _ = flash_splits(B, H, H, Sq, Skv, D, card)
        say(f"  flash_attention {label} unmasked B={B} H={H} Sq={Sq} "
            f"Skv={Skv} D={D} ({splits} key splits): max_abs_err={err:.6g}, "
            f"worst err/tol {share:.4g}; {ms:.4f} ms "
            f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), device "
            f"{dev_ms:.4f} ms ({bms / dev_ms:.1%} of the bound); plain "
            f"{plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms (kernel/SDPA "
            f"{ms / lib_ms:.2f}), SDPA device {lib_dev:.4f} ms; bound "
            f"{bms:.4f} ms ({bby})")
        if not share <= 1.0:
            fail(f"flash_attention's unmasked route disagrees with its "
                 f"plain version ({label}): err/tol {share}")
        shape = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "library_device_ms": lib_dev,
                 "bound_ms": bms, "splits": splits}
        if entry is None:       # --media-only: no earlier flash case ran
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "whisper_tensor_tpu_torch/csrc/"
                               "flash_attention.cu",
                     "replaces": "whisper_tensor_tpu/backends/pallas/"
                                 "attention.py:175",
                     "launches": None, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                     "library_ms": lib_ms, "shape": label, "shapes": {}}
            results.append(entry)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["shapes"][label] = shape
        del sets, calls, q, k, v
        torch.cuda.empty_cache()


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


DECODE_TOKENS_NEW = 8      # tokens check (l) asks decode_tokens for


def decode_tokens_check(torch, np, iface, prompt, layers: int, qspy,
                        results) -> None:
    """(l) decode_tokens from a prefill's caches at its pos: the tokens
    of generate_tokens over the same prompt; with every kernel counter 0
    just before it and read just after, decode_attention and the pair
    cache write launch once a layer a step-graph run, int8_matmul once a
    QuantMatMul call of the lowering, flash_attention never."""
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul)

    n = DECODE_TOKENS_NEW
    want = iface.generate_tokens(prompt, n)
    ids, L = iface._prompt(prompt)
    caches = iface.fresh_cache(1)
    first = iface.step(ids, torch.zeros((), dtype=torch.int64, device=CARD),
                       caches)[:, L - 1].argmax(-1)
    counters = {"decode_attention": decode_attention,
                "kv_write_pair": kv_write_pair,
                "ragged_kv_write": ragged_kv_write,
                "int8_matmul": int8_matmul,
                "flash_attention": flash_attention}
    zero(counters)
    calls0, launched0 = qspy.calls, qspy.launched
    steps = count_steps(iface)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        got = iface.decode_tokens(first, L, caches, n)
    finally:
        del iface.step
    secs = time.perf_counter() - t0
    got_l = {k: fn.launches for k, fn in counters.items()}
    qcalls = qspy.calls - calls0
    say(f"  (l) decode_tokens: {n} tokens from the prefill's caches at pos "
        f"{L} in {secs * 1e3:.1f} ms ({steps.runs} step-graph runs), "
        f"{got[0].tolist()}; generate_tokens {want[0].tolist()}; kernel "
        f"launches {got_l}, QuantMatMul calls {qcalls}")
    for res in results:
        if res["name"] in got_l:
            res["launches_decode_tokens"] = got_l[res["name"]]
    if not np.array_equal(got, want):
        fail("(l) decode_tokens' tokens are not generate_tokens'")
    runs = steps.runs
    if runs != n or got_l["decode_attention"] != runs * layers \
            or got_l["kv_write_pair"] != runs * layers \
            or got_l["ragged_kv_write"] != runs * layers \
            or qcalls <= 0 or got_l["int8_matmul"] != qcalls \
            or qspy.launched - launched0 != qcalls \
            or got_l["flash_attention"]:
        fail(f"(l) launches against the lowering's calls: {runs} runs x "
             f"{layers} layers, {qcalls} QuantMatMul calls, {got_l}")


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


def phase3(torch, np, ckpt: Path, layers: int, results,
           par_ref: dict) -> dict:
    """Returns the direct path's rates (direct_rates). At its end, on its
    Server and model, phase 15 (a)-(c) and the Llama export (e), and
    phase 19's single-rank reference (into `par_ref`)."""
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
        decode_tokens_check(torch, np, iface, prompt, layers, spy, results)
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
    phase15_at_phase3(torch, np, srv, ckpt, layers, results, rates)
    par_ref["int8"] = par_reference(torch, np, iface, par_prompts(np, False))
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
        if res["name"] == "packed_matmul" and res.get("launches") is None:
            # the default run's main-path count (phase 6b, which set it,
            # runs under --gguf-only)
            res["launches"] = launches["packed_matmul"]
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
    floor with random weights); greedy at k 4 and 5, 32 new tokens, each
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
        n_new = 32
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
                "max_tokens": int(rng.integers(8, 25)), "temperature": 0,
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


def phase11_corpus(torch, np, op_types=None, want=None) -> None:
    """(a) every case of the CPU tests' corpus (tests/torch_corpus.npz,
    the selected cases of tests/conformance/), or those of `op_types`
    (`want` of them), through Model.eval on the default device, at the
    case's own tolerances."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_conformance as tc
    from whisper_tensor_tpu_torch.model import Model

    cases = [c for c in tc.read_bundle()
             if op_types is None or c.op_type in op_types]
    try:
        import PIL  # noqa: F401  (ImageDecoder decodes on the host with it)
    except ImportError:
        held = [c for c in cases if c.op_type == "ImageDecoder"]
        cases = [c for c in cases if c.op_type != "ImageDecoder"]
        if held:
            say(f"  {len(held)} ImageDecoder cases held on the CPU only: PIL "
                f"does not import on this machine (the op decodes on the "
                f"host with PIL, as the JAX package does)")
            want = None if want is None else want - len(held)
    say(f"phase 11 (a): {len(cases)} corpus cases through Model.eval on "
        f"the card (tests/torch_corpus.npz"
        f"{', ' + ', '.join(op_types) if op_types else ''})")
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
    if failures or want not in (None, len(cases)):
        fail(f"{len(failures)} of {len(cases)} corpus cases failed on the "
             f"card ({want or len(cases)} expected)")


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
        return fresh_caches(torch, m)

    prompt = step_prompt(np)
    P, n_new = prompt.shape[0], 8
    caches = fresh(model)
    zero(counters)
    calls = CallCounter(("Attention", "DynUpdateSlice"))
    try:
        toks, logits, prefill_ms, decode_ms = greedy_steps(
            np, model.eval, caches, prompt, n_new)
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
    del iface, caches, teacher, mine
    free_memory(torch)
    program = phase21_program(torch, np, model, prompt, toks, logits,
                              layers, counters, shadowed=False)
    del model, entry, srv, logits, program["prog"]
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
    return got, program["launches"]


def phase11(torch, np, ckpt: Path, layers: int, results) -> None:
    """Phase 11: the generic ONNX path; its launches join the kernels'
    line as launches_generic, phase 21 (a)'s as launches_program."""
    phase11_corpus(torch, np)
    free_memory(torch)
    launches = phase11_attention(torch, np)
    free_memory(torch)
    steps, program = phase11_steps(torch, np, ckpt, layers)
    for name, n in steps.items():
        launches[name] = launches.get(name, 0) + n
    for res in results:
        if res["name"] in launches:
            res["launches_generic"] = launches[res["name"]]
        if res["name"] in program:
            res["launches_program"] = program[res["name"]]
    say(f"  phase 11 launches: {launches}; phase 21 (a): {program}")



# ---------------------------------------------------------------------------
# phase 21: the compiler facade and ONNX files as a model source, on phase
# 3's checkpoint: (a) build_program over phase 11 (c)'s Model (default
# run); (b) a .bin export and (c) an origin-referenced export, each loaded
# by the `onnx` loader (--onnx-only)


def fresh_caches(torch, model) -> dict:
    """Zeroed bf16 caches on the card for one row of a step graph."""
    out = {}
    for name, info in model.input_infos().items():
        if name.startswith("cache_"):
            dims = [1] + [int(d.value()) for d in info.dims()[1:]]
            out[name] = torch.zeros(dims, dtype=torch.bfloat16, device=CARD)
    return out


def step_prompt(np):
    """Phase 11 (c)'s 1,900-token prompt."""
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    return np.asarray(ByteTokenizer().encode(long_text(
        np, MAX_LEN - 148, SEED + 12)), np.int64)


def greedy_steps(np, run, caches, prompt, n_new: int):
    """A prefill of `prompt` and `n_new` greedy decode steps through
    `run(feeds) -> host outputs` (Model.eval, CompiledProgram.run) over
    `caches` (on the card, written in place): (tokens, each run's logits
    in f32, the prefill's ms, ms a decode step)."""
    P = prompt.shape[0]
    t0 = time.perf_counter()
    out = run(dict(caches, input_ids=prompt[None],
                   pos=np.asarray([0], np.int64)))
    prefill_ms = (time.perf_counter() - t0) * 1e3
    logits = [out["logits"][0].astype(np.float32)]
    toks = [int(logits[0][-1].argmax())]
    t0 = time.perf_counter()
    for i in range(n_new):
        out = run(dict(caches, input_ids=np.asarray([[toks[-1]]], np.int64),
                       pos=np.asarray([P + i], np.int64)))
        logits.append(out["logits"][0].astype(np.float32))
        toks.append(int(logits[-1][-1].argmax()))
    return toks, logits, prefill_ms, (time.perf_counter() - t0) * 1e3 / n_new


def logits_held(np, got, want, layers: int, what: str) -> str:
    """`got` bit for bit `want`'s (lists of f32 logits), or within phase
    3's bound of max|logit|; says which held, fails if neither."""
    if all(np.array_equal(g, w) for g, w in zip(got, want)):
        return "bit for bit"
    scale = max(float(np.abs(w).max()) for w in want)
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    frac = 0.015 * math.sqrt(layers)
    if not diff <= frac * scale:
        fail(f"{what}: logits off by {diff:.5g} ({diff / scale:.3%} of "
             f"max|logit|), past phase 3's bound {frac:.1%}")
    return (f"within phase 3's bound: max |diff| {diff:.5g}, "
            f"{diff / scale:.3%} of max|logit| {scale:.4g} (bound "
            f"{frac:.1%})")


def program_run(torch, np, model, prompt, n_new: int, layers: int,
                counters: dict, what: str) -> dict:
    """build_program over `model` on the card, its first run (weights
    uploaded, plan built) counted: the launches of flash_attention (the
    prefill's pos-bound calls), decode_attention and ragged_kv_write
    (one a cache a run: no pair pass) equal the lowering's Attention and
    DynUpdateSlice calls, and backend is "torch"."""
    from whisper_tensor_tpu_torch.compiler import (CompilationSubject,
                                                   build_program)

    prog = build_program(CompilationSubject(model=model))
    zero(counters)
    calls = CallCounter(("Attention", "DynUpdateSlice"))
    try:
        toks, logits, prefill_ms, decode_ms = greedy_steps(
            np, prog.run, fresh_caches(torch, model), prompt, n_new)
    finally:
        calls.restore()
    got = {name: fn.launches for name, fn in counters.items()}
    lowered = dict(calls.calls)
    say(f"  {what}: build_program on {prog.device}, backend "
        f"{prog.backend!r} (host RSS {host_rss_gb():.1f} GB); prefill of "
        f"{prompt.shape[0]} tokens "
        f"{prefill_ms:.1f} ms (weights uploaded: "
        f"{prog.stats['weight_bytes_uploaded'] / 1e9:.2f} GB; plan built), "
        f"{n_new} decode steps {decode_ms:.1f} ms a step; launches {got}; "
        f"lowering calls {lowered}")
    if prog.backend != "torch" or "fallback_reason" in prog.stats:
        fail(f"{what}: the program fell back: {prog.stats}")
    if got["flash_attention"] != layers \
            or got["decode_attention"] != n_new * layers \
            or got["flash_attention"] + got["decode_attention"] \
            != lowered["Attention"] \
            or got["ragged_kv_write"] != lowered["DynUpdateSlice"] \
            or got["ragged_kv_write"] != 2 * (1 + n_new) * layers \
            or got["kv_write_pair"] != 0:
        fail(f"{what}: launches {got} do not match the lowering's calls "
             f"{lowered}")
    return {"prog": prog, "toks": toks, "logits": logits, "launches": got}


def phase21_program(torch, np, model, prompt, ref_toks, ref_logits,
                    layers: int, counters: dict, shadowed: bool) -> dict:
    """(a) build_program over `model` against its Model.eval run
    (`ref_toks`, `ref_logits`): tokens equal, logits bit for bit or
    within phase 3's bound; with `shadowed`, a second run holds every
    launch against its plain version (agreement_bound; the cache writes
    bit for bit) and uploads no weight byte."""
    n_new = len(ref_toks) - 1
    run = program_run(torch, np, model, prompt, n_new, layers, counters,
                      "phase 21 (a)")
    if run["toks"] != ref_toks:
        fail(f"phase 21 (a): the program's tokens {run['toks']} are not "
             f"Model.eval's {ref_toks}")
    held = logits_held(np, run["logits"], ref_logits, layers,
                       "phase 21 (a)")
    say(f"  phase 21 (a): tokens equal Model.eval's; logits {held}")
    if shadowed:
        prog = run["prog"]
        uploaded = prog.stats["weight_bytes_uploaded"]
        sh = Shadows()
        try:
            again = greedy_steps(np, prog.run, fresh_caches(torch, model),
                                 prompt, n_new)[0]
        finally:
            sh.close("phase 21 (a)", dict(run["launches"], int8_matmul=0))
        if prog.stats["weight_bytes_uploaded"] != uploaded:
            fail("phase 21 (a): the second run uploaded weights again")
        if again != run["toks"]:
            fail("phase 21 (a): the shadowed rerun's tokens differ")
        say("  phase 21 (a): the second run uploaded no weight byte")
    return run


def phase21(torch, np, ckpt: Path, layers: int) -> dict:
    """Phase 21 (--onnx-only): (a) as in the default run, over its own
    load of phase 3's checkpoint; (b) Model.save_onnx(weights="external")
    of that model, loaded back through the Server's `onnx` loader and run
    by build_program: tokens equal and logits bit for bit (a)'s; (c) the
    llama recipe over SafetensorsStore.lazy getters of the checkpoint
    with WeightStorage.origin_reference(): every checkpoint tensor
    referenced, no weight payload in the ONNX file (only the recipe's
    rope tables), loaded through the `onnx` loader, (a)'s tokens and logits (bit
    for bit or within phase 3's bound). Returns (a)'s launches."""
    import safetensors

    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import WeightStorage
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step)
    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore, load_hf_config)
    from whisper_tensor_tpu_torch.onnx_pb import ModelProto
    from whisper_tensor_tpu_torch.server.main import Server

    counters = {"flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "ragged_kv_write": ragged_kv_write,
                "kv_write_pair": kv_write_pair}
    srv = Server()
    t0 = time.perf_counter()
    (entry,) = srv.models.run_loader("transformers", {
        "path": str(ckpt), "dtype": "bf16", "max_len": MAX_LEN,
        "ragged_decode": True})
    say(f"phase 21: the transformers loader: {time.perf_counter() - t0:.1f}"
        f" s; host RSS {host_rss_gb():.1f} GB")
    model = entry.model
    prompt = step_prompt(np)
    toks, logits, prefill_ms, decode_ms = greedy_steps(
        np, model.eval, fresh_caches(torch, model), prompt, 8)
    say(f"  Model.eval: prefill {prefill_ms:.1f} ms, {decode_ms:.1f} ms a "
        f"decode step; tokens {toks}")
    a = phase21_program(torch, np, model, prompt, toks, logits, layers,
                        counters, shadowed=True)
    del a["prog"]
    free_memory(torch)

    d = ckpt.with_name(ckpt.name + "-onnx")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    try:
        path = d / "model.onnx"
        t0 = time.perf_counter()
        model.save_onnx(str(path), weights="external")
        export_s = time.perf_counter() - t0
        n_params = sum(int(np.prod(model.graph.store.get(n).shape))
                       for n in model.graph.store.names())
        srv.models.unload(entry.id)
        del model, entry
        free_memory(torch)
        t0 = time.perf_counter()
        (loaded,) = srv.models.run_loader("onnx", {"path": str(path)})
        load_s = time.perf_counter() - t0
        say(f"phase 21 (b): save_onnx(weights=\"external\") of "
            f"{n_params / 1e9:.3f} B parameters in {export_s:.1f} s: "
            f"{path.name} {path.stat().st_size / 1e6:.2f} MB, "
            f"{path.name}.bin {(d / (path.name + '.bin')).stat().st_size / 1e9:.3f} GB; "
            f"the `onnx` loader took {load_s:.1f} s; host RSS "
            f"{host_rss_gb():.1f} GB")
        b = program_run(torch, np, loaded.model, prompt, 8, layers,
                        counters, "phase 21 (b)")
        if b["toks"] != a["toks"] or not all(
                np.array_equal(g, w) for g, w in zip(b["logits"],
                                                     a["logits"])):
            fail("phase 21 (b): the .bin export's tokens or logits are not "
                 "(a)'s bit for bit")
        say("  phase 21 (b): tokens equal (a)'s; logits bit for bit")
        del b, loaded
        free_memory(torch)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)

        st = SafetensorsStore.from_dir(str(ckpt))
        hf = load_hf_config(str(ckpt))
        t0 = time.perf_counter()
        data = build_llama_step(st.lazy, LlamaConfig.from_hf(hf),
                                max_len=MAX_LEN, dtype=DType.BF16,
                                pos_per_row=True,
                                storage=WeightStorage.origin_reference())
        build_s = time.perf_counter() - t0
        graph = ModelProto.parse(data).graph
        refs = {dict((e.key, e.value) for e in t.external_data)
                ["tensor_name"] for t in graph.initializer
                if t.data_location == 1}
        embedded = {t.name: len(t.raw_data) for t in graph.initializer
                    if t.raw_data}
        payload = sum(embedded.values())
        path = d / "origin.onnx"
        path.write_bytes(data)
        t0 = time.perf_counter()
        (loaded,) = srv.models.run_loader("onnx", {"path": str(path)})
        load_s = time.perf_counter() - t0
        try:
            from safetensors import safe_open
            with safe_open(str(ckpt / "model.safetensors"),
                           framework="numpy") as f:
                numpy_bf16 = str(f.get_tensor("model.norm.weight").dtype)
        except Exception as e:  # noqa: BLE001 (reported, not relied on)
            numpy_bf16 = f"fails ({type(e).__name__}: {e})"
        say(f"phase 21 (c): the llama recipe over SafetensorsStore.lazy with "
            f"origin_reference in {build_s:.1f} s: {len(data) / 1e3:.1f} kB, "
            f"{len(refs)} of {len(st.names())} checkpoint tensors referenced, "
            f"{payload} bytes of initializer payload (the recipe's own "
            f"tables: {embedded}); the `onnx` loader took "
            f"{load_s:.1f} s, host RSS {host_rss_gb():.1f} GB (safetensors "
            f"{safetensors.__version__}: its "
            f"numpy reader of a bf16 tensor gives {numpy_bf16})")
        if refs != set(st.names()) or set(embedded) - {"rope_cos",
                                                       "rope_sin"}:
            fail("phase 21 (c): the origin-referenced ONNX holds weight "
                 "payload or misses a checkpoint tensor")
        c = program_run(torch, np, loaded.model, prompt, 8, layers,
                        counters, "phase 21 (c)")
        if c["toks"] != a["toks"]:
            fail(f"phase 21 (c): tokens {c['toks']} are not (a)'s "
                 f"{a['toks']}")
        held = logits_held(np, c["logits"], a["logits"], layers,
                           "phase 21 (c)")
        say(f"  phase 21 (c): tokens equal (a)'s; logits {held}")
        del c, loaded
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del srv
    free_memory(torch)
    return a["launches"]


# phase 12: Gemma, Gemma-2, Gemma-3 and Phi-3 at their published widths
# (the config.json of each checkpoint named), depth cut to 2 layers
# (Gemma-2 alternates a local and a global layer) and to 6 for Gemma-3,
# so that its sixth layer, the global one, is in; seeded random weights,
# bf16, max_len 2048; (config, layers or None for --layers, quantize)
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
        max_position_embeddings=8192), 2, "int8"),
    # google/gemma-2b
    "gemma-2b": (dict(
        model_type="gemma", hidden_size=2048, num_attention_heads=8,
        num_key_value_heads=1, head_dim=256, intermediate_size=16384,
        vocab_size=256000, rope_theta=10000.0, rms_norm_eps=1e-6,
        max_position_embeddings=8192), 2, ""),
    # microsoft/Phi-3-mini-4k-instruct
    "phi-3-mini": (dict(
        model_type="phi3", hidden_size=3072, num_attention_heads=32,
        num_key_value_heads=32, intermediate_size=8192, vocab_size=32064,
        rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=4096,
        tie_word_embeddings=False), 2, ""),
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


def phase12(torch, np, root: Path, layers: int, bf16, results,
            gguf: bool = False) -> None:
    """Phase 12: Gemma-3 1B (q4_0), Gemma-2 2B (int8), Gemma 2B and
    Phi-3-mini at their published widths through the port's Server
    (serve_family); with `gguf` (under --gguf-only since phase 20 came)
    only the Gemma-2 weights as a Q8_0 GGUF of arch gemma2."""
    say(f"phase 12: Gemma, Gemma-2, Gemma-3 and Phi-3 at published widths; "
        f"host RSS {host_rss_gb():.1f} GB")
    for name, (cfg, depth, quantize) in FAMILIES.items():
        if gguf and name != "gemma-2-2b":
            continue
        depth = depth or layers
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        try:
            if not gguf:
                nbytes = write_family(d, cfg, depth, np, bf16)
                say(f"  wrote {name} ({depth} layers, {nbytes / 1e9:.2f} "
                    f"GB)")
                serve_family(torch, np, name, "transformers", d, depth,
                             quantize, results)
                free_memory(torch)
            else:
                gg = d / "gemma-2-2b.gguf"
                write_gemma2_gguf(gg, cfg, depth, np, bf16)
                say(f"  wrote it as a Q8_0 GGUF of arch gemma2 "
                    f"({gg.stat().st_size / 1e9:.2f} GB)")
                serve_family(torch, np, "gemma-2-2b GGUF", "gguf", gg, depth,
                             "", results)
                free_memory(torch)
        finally:
            shutil.rmtree(d, ignore_errors=True)


# phase 13: SD-1.5 at its published widths (runwayml/stable-diffusion-v1-5:
# unet/, text_encoder/ and vae/ config.json)
SD15_UNET = {"block_out_channels": [320, 640, 1280, 1280],
             "layers_per_block": 2, "cross_attention_dim": 768,
             "attention_head_dim": 8, "norm_num_groups": 32,
             "sample_size": 64, "in_channels": 4, "out_channels": 4,
             "down_block_types": ["CrossAttnDownBlock2D"] * 3
             + ["DownBlock2D"]}
SD15_CLIP = {"num_hidden_layers": 12, "hidden_size": 768,
             "num_attention_heads": 12, "intermediate_size": 3072,
             "vocab_size": 49408, "max_position_embeddings": 77,
             "hidden_act": "quick_gelu", "bos_token_id": 49406,
             "eos_token_id": 49407,
             "architectures": ["CLIPTextModel"]}
SD15_VAE = {"latent_channels": 4, "out_channels": 3,
            "block_out_channels": [128, 256, 512, 512],
            "layers_per_block": 2, "norm_num_groups": 32,
            "scaling_factor": 0.18215}
SD_PROMPT = "a photograph of an astronaut riding a horse"
SD_HW = 512               # the image's height and width
LDM_STEPS = 2             # phase 18 (d)'s steps (`cli image` of the LDM file)
# one UNet step with the kernels against the same step with the plain
# attention path: each of the step's 32 attention calls rounds its output
# to bf16 in other places (flash rounds the unnormalized probabilities
# against a running maximum), about one bf16 ulp (2^-8) of its output,
# and the residual stream sums 32 such independent differences like a
# random walk: sqrt(32) x 2^-8 = 2.2% of the output's scale; bound 4%
SD_STEP_BOUND = 0.04


def clip_shapes(cfg: dict) -> dict:
    """The HF CLIPTextModel weights' names and shapes."""
    E, F, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    tp = "text_model."
    out = {tp + "embeddings.token_embedding.weight": (cfg["vocab_size"], E),
           tp + "embeddings.position_embedding.weight":
               (cfg["max_position_embeddings"], E),
           tp + "final_layer_norm.weight": (E,),
           tp + "final_layer_norm.bias": (E,)}
    for i in range(L):
        p = f"{tp}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[p + f"self_attn.{n}.weight"] = (E, E)
            out[p + f"self_attn.{n}.bias"] = (E,)
        for n in ("layer_norm1", "layer_norm2"):
            out[p + n + ".weight"] = out[p + n + ".bias"] = (E,)
        out.update({p + "mlp.fc1.weight": (F, E), p + "mlp.fc1.bias": (F,),
                    p + "mlp.fc2.weight": (E, F), p + "mlp.fc2.bias": (E,)})
    return out


def recipe_shapes(build, np, **kw) -> dict:
    """The names and shapes of the weights a diffusion recipe asks its
    getter for (its graph is built against zero arrays and dropped)."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import WeightStorage

    shapes = {}

    def getter(name, shape=None):
        shapes[name] = tuple(shape)
        return np.broadcast_to(np.zeros((), np.float16), shape)

    build(getter, dtype=DType.F16, storage=WeightStorage.to_sink({}), **kw)
    return shapes


def write_sd15(torch, np, d: Path) -> int:
    """SD-1.5's diffusers directory with seeded weights in f16
    safetensors: random_unet_weights' rule (norm weights 1, biases 0,
    the rest normal with std 1/sqrt(fan in)), drawn on the card. Returns
    the bytes written."""
    from safetensors.numpy import save_file

    from whisper_tensor_tpu_torch.importers.recipes.diffusion import (unet,
                                                                      vae)

    gen = torch.Generator(device=CARD).manual_seed(SEED + 13)
    vcfg = vae.VAEConfig.from_hf(SD15_VAE)
    parts = {
        "unet": (SD15_UNET, recipe_shapes(
            unet.build_sd_unet, np, cfg=unet.UNetConfig.from_hf(SD15_UNET),
            batch=2, latent_hw=(8, 8))),
        "text_encoder": (SD15_CLIP, clip_shapes(SD15_CLIP)),
        "vae": (SD15_VAE, {**recipe_shapes(vae.build_vae_decoder, np,
                                           cfg=vcfg, latent_hw=(8, 8)),
                           **recipe_shapes(vae.build_vae_encoder, np,
                                           cfg=vcfg, image_hw=(64, 64))})}
    total = 0
    for sub, (cfg, shapes) in parts.items():
        (d / sub).mkdir(parents=True)
        (d / sub / "config.json").write_text(json.dumps(cfg))
        tensors = {}
        for name, shape in shapes.items():
            if name.endswith(".bias") or ("norm" in name
                                          and name.endswith("weight")):
                t = torch.full(shape, float(name.endswith("weight")),
                               dtype=torch.float16)
            else:
                fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
                t = (torch.randn(shape, generator=gen, device=CARD)
                     / math.sqrt(max(fan_in, 1))).half().cpu()
            tensors[name] = t.numpy()
            total += t.numel() * 2
        save_file(tensors, str(d / sub / "model.safetensors"))
        del tensors
    (d / "scheduler").mkdir()
    (d / "scheduler" / "scheduler_config.json").write_text(
        json.dumps({"prediction_type": "epsilon"}))
    (d / "model_index.json").write_text(
        json.dumps({"_class_name": "StableDiffusionPipeline"}))
    return total


class SdSpy:
    """Wraps the Attention, Conv and GroupNorm lowerings for phase 13:
    counts the Attention calls on the card and those flash_mode sends to
    flash_attention (the unmasked UNet calls at padded head dims, CLIP's
    causal ones), and while `profiling` labels each call with
    record_function so the profiler splits the device time by kind.
    Installed before the first run, so the plans built keep it."""

    KINDS = ("Attention", "Conv", "GroupNorm")

    def __init__(self, torch):
        from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
        from whisper_tensor_tpu_torch.milli.ops.attention import flash_mode

        self.table, self.saved = LOWERINGS, {}
        self.profiling, self.calls, self.eligible = False, 0, 0
        for kind in self.KINDS:
            self.saved[kind] = fn = LOWERINGS[kind]

            def wrapped(op, ins, static, device, fn=fn, kind=kind):
                if kind == "Attention" and device.type == "cuda":
                    self.calls += 1
                    m = ins[3] if len(ins) > 3 else None
                    if flash_mode(op, ins[0], ins[1], ins[2], m,
                                  op.n_out >= 4) is not None:
                        self.eligible += 1
                if self.profiling:
                    with torch.profiler.record_function(f"sd.{kind}"):
                        return fn(op, ins, static, device)
                return fn(op, ins, static, device)

            LOWERINGS[kind] = wrapped

    def zero(self):
        self.calls = self.eligible = 0

    def restore(self):
        self.table.update(self.saved)


def png_image(np, data: bytes, shape) -> None:
    """A PNG that decodes to `shape` and is not one constant color."""
    from whisper_tensor_tpu_torch.utils.image import png_to_array

    px = png_to_array(data)
    if px.shape != tuple(shape) or not float(px.astype(np.float64).std()) > 0:
        fail(f"image {px.shape}, std {px.astype(np.float64).std()}: want "
             f"{shape}, not constant")
    return px


def unet_step_split(torch, iface, spy, feeds) -> str:
    """One UNet step's device time under torch.profiler, split into
    attention, convolution, GroupNorm and the rest (the spy's labels)."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        return getattr(e, name, getattr(e, name.replace("device", "cuda"),
                                        0.0))

    spy.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                iface._run(iface.unet, feeds)
            torch.cuda.synchronize()
    finally:
        spy.profiling = False
    events = prof.key_averages()
    busy = sum(dev_us(e) for e in events) / 2e3
    parts = {k: sum(dev_us(e, True) for e in events if e.key == f"sd.{k}")
             / 2e3 for k in SdSpy.KINDS}
    rest = busy - sum(parts.values())
    return (f"device {busy:.2f} ms a step: attention {parts['Attention']:.2f}"
            f", conv {parts['Conv']:.2f}, GroupNorm {parts['GroupNorm']:.2f}"
            f", the rest {rest:.2f} ms")


def phase13(torch, np, root: Path, results, keep: bool = False) -> None:
    """Phase 13: SD-1.5 at its published widths (seeded weights in f16
    safetensors, loaded in bf16) through the port's Server: a 512 x 512
    text-to-image request over /v1/images/generations at 20 Euler steps
    and CFG 7.5 (the UNet at batch 2), then img2img at strength 0.5 and an
    inpaint with a half-image mask through the interface, then `cli
    image` at 256 x 256 and 4 steps. `keep` (the default run): the
    directory and its image at phase 18 (d)'s size and steps are left
    for (d), whose `cli image` of the same weights as an LDM file stands
    in for this one."""
    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.interfaces.image_gen import ImageGenConfig
    from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
    from whisper_tensor_tpu_torch.milli.ops import attention as att_lowering
    from whisper_tensor_tpu_torch.milli.ops.attention import AttentionMilli
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    card = card_line()
    say(f"phase 13: SD-1.5 at its published widths (UNet 320/640/1280/1280, "
        f"8 heads, CLIP ViT-L/14, VAE 128-512); host RSS "
        f"{host_rss_gb():.1f} GB; {card}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the precision contract wants f32 convolutions and "
             "matmuls at full precision (device.py)")
    d = root / "sd15"
    shutil.rmtree(d, ignore_errors=True)
    spy = SdSpy(torch)
    api = None
    try:
        t0 = time.perf_counter()
        nbytes = write_sd15(torch, np, d)
        say(f"  wrote the diffusers directory ({nbytes / 1e9:.2f} GB of f16 "
            f"safetensors) in {time.perf_counter() - t0:.1f} s")
        srv = Server(device=CARD)
        t0 = time.perf_counter()
        entries = srv.models.run_loader("diffusers", {
            "path": str(d), "dtype": "bf16", "img2img": True,
            "height": SD_HW, "width": SD_HW})
        load_s = time.perf_counter() - t0
        api = OpenAIApi(srv, "127.0.0.1", 0).start()
        body = {"prompt": SD_PROMPT, "steps": 20, "guidance_scale": 7.5,
                "seed": 0}
        # the main path, counted: the first request (the weights go to
        # the card, the plans are built), launches against the lowering's
        # eligible Attention calls, every flash call held against its
        # plain version on the same inputs (no kernel launch)
        shadow = flash_shadow(att_lowering, flash_attention_plain,
                              flash_agreement_bound)
        flash_attention.launches = 0
        spy.zero()
        t0 = time.perf_counter()
        try:
            status, data = request(api.port, "/v1/images/generations", body)
            torch.cuda.synchronize()
        finally:
            att_lowering.flash_attention = shadow.inner
        first_s = time.perf_counter() - t0
        launches, eligible, calls = (flash_attention.launches, spy.eligible,
                                     spy.calls)
        shadowed = [shadow.calls, shadow.worst, shadow.max_err]
        if status != 200:
            fail(f"/v1/images/generations answered {status}: {data[:500]}")
        imgs = json.loads(data)["data"]
        px = png_image(np, base64.b64decode(imgs[0]["b64_json"]),
                       (SD_HW, SD_HW, 3))
        say(f"  loaded in {load_s:.1f} s ({[e.name for e in entries]}); the "
            f"first request took {first_s:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
            f"flash_attention launched {launches} times for {eligible} "
            f"eligible of {calls} Attention calls on the card, each held "
            f"against its plain version ({shadowed[0]} calls, worst "
            f"{shadowed[1]:.3g} of flash_agreement_bound, max |err| "
            f"{shadowed[2]:.4g}); the PNG is {SD_HW} x {SD_HW}, pixel std "
            f"{px.std():.2f}")
        if launches != eligible or launches == 0:
            fail(f"flash_attention launches {launches} != the lowering's "
                 f"{eligible} eligible Attention calls")
        if shadowed[0] != launches or not shadowed[1] <= 1.0:
            fail(f"the first request's flash calls against their plain "
                 f"version: {shadowed[0]} calls, worst {shadowed[1]}")
        for res in results:
            if res["name"] == "flash_attention":
                res["launches_phase13"] = launches
        t0 = time.perf_counter()
        status, data = request(api.port, "/v1/images/generations",
                               dict(body, seed=1))
        image_s = time.perf_counter() - t0
        if status != 200:
            fail(f"the second request answered {status}")
        png_image(np, base64.b64decode(json.loads(data)["data"][0][
            "b64_json"]), (SD_HW, SD_HW, 3))
        say(f"  seconds per image (20 steps, {SD_HW} x {SD_HW}, warm): "
            f"{image_s:.2f} s ({card})")

        iface = srv._image_iface(srv.models.get(entries[0].id))
        # one UNet step: time, device split, kernels against plain
        ctx, _ = iface._encode_cfg(SD_PROMPT, "")
        lat = torch.randn(2, 4, SD_HW // 8, SD_HW // 8, device=CARD,
                          generator=torch.Generator(device=CARD)
                          .manual_seed(SEED))
        feeds = {"sample": lat, "timestep": torch.tensor(500.0, device=CARD),
                 "encoder_hidden_states": ctx}
        step_ms = statistics.median(_timed(lambda: (
            iface._run(iface.unet, feeds), torch.cuda.synchronize()), 5))
        split = unet_step_split(torch, iface, spy, feeds)
        got = iface._run(iface.unet, feeds)["out"].float()
        att_lowering.flash_attention = flash_attention_plain
        try:
            want = iface._run(iface.unet, feeds)["out"].float()
        finally:
            att_lowering.flash_attention = flash_attention
        share = float((got - want).abs().max() / want.abs().max())
        say(f"  UNet step (batch 2, {SD_HW // 8} x {SD_HW // 8} latents): "
            f"{step_ms:.2f} ms "
            f"(host clock, synchronized); {split}; its output with the "
            f"kernels against the plain attention path: max |diff| "
            f"{share:.4%} of the output's scale (bound {SD_STEP_BOUND:.0%})")
        if not share <= SD_STEP_BOUND:
            fail(f"a UNet step with flash_attention parts from the plain "
                 f"path by {share:.4%} of its scale")
        vae_ms = statistics.median(_timed(lambda: (
            iface._run(iface.vae, {"latents": lat[:1]}),
            torch.cuda.synchronize()), 3))
        # the VAE mid block's attention: one head of its 512 channels
        # over the latent's positions (4,096 at 64 x 64)
        n = (SD_HW // 8) ** 2
        q = torch.randn(1, 1, n, 512, device=CARD).bfloat16()
        att512 = time_ms(torch, lambda q: LOWERINGS["Attention"](
            AttentionMilli(scale=512 ** -0.5), [q, q, q], [None] * 3,
            q.device), [(q,), (q.clone(),)], reps=5, inner=3)
        say(f"  VAE decode ({SD_HW} x {SD_HW}): {vae_ms:.2f} ms; its one-head "
            f"D=512 attention at {n} positions on the plain path: {att512:.3f} "
            f"ms a call")

        # img2img and inpaint, every flash call held against its plain
        # version on the same inputs
        init = np.asarray(px)
        mask = np.zeros((SD_HW, SD_HW), np.float32)
        mask[:, SD_HW // 2:] = 1.0
        shadow = flash_shadow(att_lowering, flash_attention_plain,
                              flash_agreement_bound)
        try:
            cfg = ImageGenConfig(steps=20, height=SD_HW, width=SD_HW,
                                 seed=2)
            t0 = time.perf_counter()
            a = iface.run_img2img(SD_PROMPT, init, strength=0.5, cfg=cfg)
            b = iface.run_inpaint(SD_PROMPT, init, mask, cfg=cfg)
            shadow_s = time.perf_counter() - t0
        finally:
            att_lowering.flash_attention = shadow.inner
        for im in (a, b):
            if im.pixels.shape != (SD_HW, SD_HW, 3) or not im.pixels.std() > 0:
                fail(f"img2img/inpaint image {im.pixels.shape}, std "
                     f"{im.pixels.std()}")
        kept = float(np.abs(b.pixels[:, :SD_HW // 4].astype(np.float64)
                            - init[:, :SD_HW // 4]).mean())
        say(f"  img2img (strength 0.5: 10 of 20 steps) and inpaint (right "
            f"half repainted), {shadow_s:.1f} s with every flash call "
            f"shadowed: {shadow.calls} calls, worst {shadow.worst:.3g} of "
            f"flash_agreement_bound (max |err| {shadow.max_err:.4g}); "
            f"inpaint's kept left part is {kept:.1f} of 255 from the init "
            f"image on average")
        if shadow.calls == 0 or not shadow.worst <= 1.0:
            fail(f"phase 13's flash calls against their plain version: "
                 f"{shadow.calls} calls, worst {shadow.worst}")
        if keep:
            # phase 18 (d)'s reference: the directory's image at (d)'s
            # size and steps through this load, in the PNG `cli image`
            # writes; (d)'s `cli image` of the LDM file is then the one
            # further load, and it holds the cli path too
            from whisper_tensor_tpu_torch.utils.image import png_bytes

            ref = iface.run(SD_PROMPT, cfg=ImageGenConfig(
                steps=LDM_STEPS, height=SD_HW, width=SD_HW, seed=0))
            (root / "sd15-ref.png").write_bytes(png_bytes(ref.pixels))
        phase15_preview(torch, np, srv, entries[0].id, spy, results)
        api.stop()
        api = None
        del iface, srv, entries, ctx, feeds, got, want, lat, q
        free_memory(torch)

        if keep:
            return
        out = root / "sd15-cli.png"
        n0 = flash_attention.launches
        t0 = time.perf_counter()
        cli.main(["image", "--model", str(d), "--prompt", SD_PROMPT,
                  "--steps", "4", "--height", str(SD_HW // 2),
                  "--width", str(SD_HW // 2),
                  "--output", str(out), "-c", "dtype=bf16",
                  "--device", CARD])
        cli_s = time.perf_counter() - t0
        png_image(np, out.read_bytes(), (SD_HW // 2, SD_HW // 2, 3))
        say(f"  cli image ({SD_HW // 2} x {SD_HW // 2}, 4 steps, its own "
            f"load): {cli_s:.1f} s, "
            f"{flash_attention.launches - n0} flash launches")
        if flash_attention.launches == n0:
            fail("cli image launched no flash_attention")
    finally:
        if api is not None:
            api.stop()
        spy.restore()
        (root / "sd15-cli.png").unlink(missing_ok=True)
        if not keep:
            shutil.rmtree(d, ignore_errors=True)


# phase 14: training (LMTrainer and the milli training graph)
GPT2_TRAIN = dict(B=8, S=1024, steps=5)
QLORA = dict(B=2, S=512, steps=8, rank=16,
             targets=("wq_", "wk_", "wv_", "wo_", "w_gate_", "w_up_",
                      "w_down_"))
MILLI_TRAIN = dict(layers=2, B=2, S=128)
# the (kind, name pieces) of a training step's CUDA kernels, for its split
KERNEL_KINDS = (("int8 kernels", ("int8_", "dx_mma", "dx_split", "dx_wgmma",
                                   "dx_sum")),
                ("cuBLAS products", ("gemm", "sm90", "cutlass", "xmma",
                                     "cublas", "ampere", "splitk")),
                ("softmax and reductions", ("softmax", "reduce", "logsumexp",
                                            "norm")),
                ("elementwise and copies", ("elementwise", "vectorized",
                                            "unrolled", "copy", "fill",
                                            "cat", "index")))


class LoweringSpy:
    """Counts the calls of some lowerings (for QuantMatMul
    the calls and those whose x requires grad, for Attention the calls
    and those flash_mode sends to flash_attention). Installed before the
    first run, so the plans built keep it."""

    def __init__(self, kinds):
        from whisper_tensor_tpu_torch.milli.ops import LOWERINGS
        from whisper_tensor_tpu_torch.milli.ops.attention import flash_mode

        self.table, self.saved = LOWERINGS, {}
        self.calls = {k: 0 for k in kinds}
        self.grad_x = self.eligible = 0
        for kind in kinds:
            self.saved[kind] = fn = LOWERINGS[kind]

            def wrapped(op, ins, static, device, fn=fn, kind=kind):
                self.calls[kind] += 1
                if kind == "QuantMatMul" and ins[0].requires_grad:
                    self.grad_x += 1
                if kind == "Attention":
                    m = ins[3] if len(ins) > 3 else None
                    if flash_mode(op, ins[0], ins[1], ins[2], m,
                                  op.n_out >= 4) is not None:
                        self.eligible += 1
                return fn(op, ins, static, device)

            LOWERINGS[kind] = wrapped

    def zero(self):
        self.calls = {k: 0 for k in self.calls}
        self.grad_x = self.eligible = 0

    def restore(self):
        self.table.update(self.saved)


def step_profile(torch, run) -> tuple:
    """One training step's device time under torch.profiler, split by the
    names of its CUDA kernels (KERNEL_KINDS), and the three largest: the
    text, and the ms of each kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # the kernels' own events (an op's device time repeats its kernels')
    events = [(e.key, getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
              for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    events = [(k, ms) for k, ms in events if ms > 0]
    busy = sum(ms for _, ms in events)
    parts = {}
    for key, ms in events:
        low = key.lower()
        kind = next((kind for kind, marks in KERNEL_KINDS
                     if any(m in low for m in marks)), "the rest")
        parts[kind] = parts.get(kind, 0.0) + ms
    top = sorted(events, key=lambda e: -e[1])[:3]
    return (f"device {busy:.1f} ms: " + ", ".join(
        f"{k} {ms:.1f}" for k, ms in sorted(parts.items(),
                                             key=lambda p: -p[1]))
        + "; largest: " + ", ".join(f"{k[:60]} {ms:.1f}" for k, ms in top),
        parts)


def phase14a(torch, np, results) -> dict:
    """(a) GPT-2 124M at its published widths and full depth (12 layers of
    768, 12 heads, vocab 50,257, 1,024 positions; seeded weights): LMTrainer
    with AdamW (lr 1e-4) and bf16 compute over f32 masters, B 8 x S 1,024:
    one warm step, then 5 timed steps on a fixed batch. The forward's
    attention runs the plain path by design (kernel_attention_disabled:
    the kernels have no backward), so flash_attention must not launch."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    B, S, steps = GPT2_TRAIN["B"], GPT2_TRAIN["S"], GPT2_TRAIN["steps"]
    say(f"phase 14 (a): GPT-2 124M widths, LMTrainer AdamW, bf16 compute "
        f"over f32 masters, B {B} x S {S}")
    t0 = time.perf_counter()
    cfg = GPT2Config(**GPT2_WIDTHS)
    tr = LMTrainer(Model.new_from_onnx(build_gpt2_train(
        random_gpt2_weights(cfg, SEED), cfg)), optimizer="adamw", lr=1e-4,
        compute_dtype=DType.BF16, device=CARD)
    params = tr.init_params()
    opt = tr.init_opt_state(params)
    n_mm = sum(p.numel() for n, p in params.items() if p.ndim == 2
               and n not in ("wte", "wpe"))
    say(f"  built and uploaded in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in params.values()) / 1e6:.1f} M parameters "
        f"({n_mm / 1e6:.1f} M in products), {len(opt)} optimizer leaves")
    ids = np.random.default_rng(SEED + 20).integers(0, cfg.vocab_size,
                                                     (B, S + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    tr.compute_dtype = None                     # the f32 reference loss
    with torch.no_grad():
        loss32 = float(tr.loss_fn(params, x, y))
    tr.compute_dtype = DType.BF16
    f0 = flash_attention.launches
    t = time.perf_counter()
    params, opt, loss = tr.train_step(params, opt, x, y)
    losses = [float(loss)]
    warm_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        params, opt, loss = tr.train_step(params, opt, x, y)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times)
    flop = 6 * n_mm * B * S + 3 * 4 * B * S * S * cfg.n_embd * cfg.n_layer
    say(f"  losses {[round(v, 4) for v in losses]} (f32 compute, step 1: "
        f"{loss32:.4f}); warm step {warm_s:.2f} s; {step_s * 1e3:.1f} ms a "
        f"step (median of {steps}), {B * S / step_s:.0f} tok/s, "
        f"{flop / 1e12:.2f} TFLOP a step = {flop / step_s / 1e12:.1f} "
        f"TFLOP/s ({flop / step_s / PEAK_BF16_FLOP_S:.1%} of 989); peak "
        f"{peak:.2f} GB on the card")
    prof, _ = step_profile(torch, lambda: tr.train_step(params, opt, x, y))
    say(f"  {prof}")
    say(f"  flash_attention launches in the trainer's steps: "
        f"{flash_attention.launches - f0} (the forward runs dense attention "
        f"by design: the kernels have no backward)")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"phase 14 (a): the loss is not finite or does not fall: "
             f"{losses}")
    if flash_attention.launches != f0:
        fail("phase 14 (a): the trainer's forward launched flash_attention")
    if not abs(losses[0] - loss32) <= 0.02 * abs(loss32):
        fail(f"phase 14 (a): bf16 step 1's loss {losses[0]} is not within "
             f"2% of the f32 step's {loss32}")
    return {"ms": step_s * 1e3, "tok_s": B * S / step_s, "peak_gb": peak}


def readme_batches(np, B: int, S: int, n: int):
    """n batches of this repository's README bytes, as bench.py's
    llama8b_lora_train arm takes them (byte ids are valid llama ids)."""
    corpus = np.frombuffer((ROOT / "README.md").read_bytes(),
                           np.uint8).astype(np.int64)
    corpus = np.tile(corpus, -(-B * (S + 1) * n // corpus.size))
    out = []
    for i in range(n):
        blk = corpus[i * B * (S + 1):(i + 1) * B * (S + 1)].reshape(B, S + 1)
        out.append((blk[:, :-1].copy(), blk[:, 1:].copy()))
    return out


def phase14b(torch, np, layers: int, results) -> dict:
    """(b) QLoRA at Llama-3-8B's widths, `layers` deep (the smoke
    checkpoint's seeded weights, build_llama_train's weight_map): the
    bench arm's rank-16 adapters on the seven projections over an
    int8-frozen base, bf16 compute and adapters, remat, B 2 x S 512, a
    warm step and 8 steps on two batches of README bytes. Launches
    against the lowering's calls; then the same 9 steps again from the
    same adapters with every int8_matmul_dx call held against its plain
    version; the frozen base unchanged; the adapters through a PEFT
    directory and back."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.lora import (
        load_peft_adapter_arrays, save_peft_adapter)
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_train)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    B, S, steps, rank = QLORA["B"], QLORA["S"], QLORA["steps"], QLORA["rank"]
    say(f"phase 14 (b): QLoRA at Llama-3-8B widths, {layers} layers, rank "
        f"{rank} on {len(QLORA['targets'])} projections, int8-frozen base, "
        f"bf16, remat, B {B} x S {S}")
    t0 = time.perf_counter()
    cfg = LlamaConfig(num_hidden_layers=layers, **{
        k: WIDTHS[k] for k in ("hidden_size", "num_attention_heads",
                               "num_key_value_heads", "intermediate_size",
                               "vocab_size", "rope_theta", "rms_norm_eps",
                               "max_position_embeddings")})
    weights = dict(checkpoint_tensors(layers, np))
    wm = {}
    model = Model.new_from_onnx(build_llama_train(
        weights.__getitem__, cfg, max_len=S, dtype=DType.BF16,
        weight_map=wm))
    del weights
    spy = LoweringSpy(("QuantMatMul", "Attention"))
    try:
        tr = LMTrainer(model, lr=2e-4, compute_dtype=DType.BF16,
                       param_dtype=DType.BF16, lora_rank=rank,
                       lora_targets=QLORA["targets"], quantize_base="int8",
                       remat=True, device=CARD)
        start = tr.init_params()
        base = {n: t.clone() for n, t in tr._frozen_params().items()
                if n in tr._quantized_base}
        say(f"  built, quantized and uploaded in "
            f"{time.perf_counter() - t0:.1f} s: {len(start)} adapter "
            f"tensors, {len(tr._quantized_base)} int8 weights "
            f"({sum(t.numel() for t in base.values()) / 1e9:.2f} GB)")
        batches = readme_batches(np, B, S, 2)

        def run(shadow=None):
            params = {k: v.clone() for k, v in start.items()}
            opt = tr.init_opt_state(params)
            losses, times = [], []
            for i in range(steps + 1):
                x, y = batches[i % 2] if i else batches[0]
                t = time.perf_counter()
                params, opt, loss = tr.train_step(params, opt, x, y)
                losses.append(float(loss))
                times.append(time.perf_counter() - t)
            return params, losses, times

        spy.zero()
        n_i8, n_dx = qm.int8_matmul.launches, qm.int8_matmul_dx.launches
        n_tma = qm.int8_matmul_dx.path_launches["tma"]
        n_bw, f0 = qm.Int8MatMul.backward_calls, flash_attention.launches
        torch.cuda.reset_peak_memory_stats()
        params, losses, times = run()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {"int8_matmul": qm.int8_matmul.launches - n_i8,
                    "int8_matmul_dx": qm.int8_matmul_dx.launches - n_dx,
                    "int8_matmul_dx tma":
                        qm.int8_matmul_dx.path_launches["tma"] - n_tma,
                    "flash_attention": flash_attention.launches - f0}
        backward = qm.Int8MatMul.backward_calls - n_bw
        calls, grad_x, eligible = (dict(spy.calls), spy.grad_x,
                                   spy.eligible)
        step_s = statistics.median(times[1:])
        n_mm = sum(w.numel() for w in base.values())
        say(f"  losses {[round(v, 4) for v in losses]}; warm step "
            f"{times[0]:.2f} s; {step_s * 1e3:.1f} ms a step (median of "
            f"{steps}), {B * S / step_s:.0f} tok/s, 6N = "
            f"{6 * n_mm * B * S / step_s / 1e12:.1f} TFLOP/s over the int8 "
            f"base; peak {peak:.2f} GB on the card")
        prof, kinds = step_profile(torch, lambda: tr.train_step(
            dict(params), tr.init_opt_state(params), *batches[0]))
        int8_ms = kinds.get("int8 kernels", 0.0)
        say(f"  {prof}")
        say(f"  the QLoRA step: {step_s * 1e3:.1f} ms, int8 kernels "
            f"{int8_ms:.1f} ms of it on the card (a profiled step)")
        say(f"  launches over the {steps + 1} steps: {launches}; the "
            f"lowering's QuantMatMul calls {calls['QuantMatMul']} (forward "
            f"and remat re-forward; {grad_x} with x requiring grad), "
            f"Int8MatMul backward calls {backward}, Attention calls "
            f"{calls['Attention']} (flash-eligible {eligible})")
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            fail(f"phase 14 (b): the loss is not finite or does not fall: "
                 f"{losses}")
        if launches["int8_matmul"] != calls["QuantMatMul"] or \
                not launches["int8_matmul"]:
            fail(f"phase 14 (b): int8_matmul launched "
                 f"{launches['int8_matmul']} times for "
                 f"{calls['QuantMatMul']} QuantMatMul calls")
        if launches["int8_matmul_dx"] != backward or not backward:
            fail(f"phase 14 (b): int8_matmul_dx launched "
                 f"{launches['int8_matmul_dx']} times for {backward} "
                 f"backward calls of Int8MatMul")
        if launches["int8_matmul_dx tma"] != backward:
            fail(f"phase 14 (b): {launches['int8_matmul_dx tma']} of "
                 f"{backward} int8_matmul_dx calls took the TMA path")
        if launches["flash_attention"] or eligible:
            fail("phase 14 (b): the trainer's attention took a kernel")
        for res in results:
            if res["name"] == "int8_matmul_dx":
                res["launches"] = launches["int8_matmul_dx"]
            elif res["name"] == "int8_matmul":
                res["launches_train"] = launches["int8_matmul"]

        # the same 9 steps, every dx call against the plain version
        kernel_dx = qm.int8_matmul_dx

        def shadowed(dy, w, s):
            got = kernel_dx(dy, w, s)
            err, share = worst_share(
                got, qm.int8_matmul_dx_plain(dy, w, s),
                qm.int8_matmul_dx_plain(dy.float().abs(), w.abs(), s),
                agreement_bound)
            shadowed.calls += 1
            shadowed.worst = max(shadowed.worst, share)
            return got

        # (the wrapper counts its launches on the name it is bound to)
        shadowed.calls, shadowed.worst = 0, 0.0
        shadowed.launches = kernel_dx.launches
        shadowed.path_launches = kernel_dx.path_launches
        qm.int8_matmul_dx = shadowed
        try:
            _, again, _ = run()
        finally:
            qm.int8_matmul_dx = kernel_dx
            kernel_dx.launches = shadowed.launches
        say(f"  shadowed run: {shadowed.calls} int8_matmul_dx calls, worst "
            f"err/tol {shadowed.worst:.4g} (agreement_bound); losses "
            f"{[round(v, 4) for v in again]}")
        if shadowed.calls != backward or not shadowed.worst <= 1.0:
            fail(f"phase 14 (b): {shadowed.calls} shadowed dx calls of "
                 f"{backward}, worst err/tol {shadowed.worst}")

        # the same steps with every dx call on the cp.async path (the
        # design the TMA path replaced)
        tma_plan, n_cp = qm.dx_plan, qm.int8_matmul_dx.path_launches[
            "cp.async"]

        def cp_plan(M, K, N, dy_dtype=torch.bfloat16, device=None):
            return qm._dx_path_plan("cp.async", M, K, N,
                                    dy_dtype == torch.bfloat16, device)

        qm.dx_plan = cp_plan
        try:
            _, _, cp_times = run()
        finally:
            qm.dx_plan = tma_plan
        cp_ms = statistics.median(cp_times[1:]) * 1e3
        say(f"  the same steps with int8_matmul_dx on the cp.async path: "
            f"{cp_ms:.1f} ms a step (on the TMA path {step_s * 1e3:.1f})")
        if qm.int8_matmul_dx.path_launches["cp.async"] - n_cp < backward:
            fail("phase 14 (b): the comparison run did not take the "
                 "cp.async path")
        for n, t in tr._frozen_params().items():
            if n in base and not torch.equal(t, base[n]):
                fail(f"phase 14 (b): the frozen int8 weight {n} changed")
        host = {k: v.float().cpu().numpy() for k, v in params.items()}
        d = ROOT / "build" / "smoke" / "qlora-adapter"
        shutil.rmtree(d, ignore_errors=True)
        try:
            back = load_peft_adapter_arrays(
                save_peft_adapter(host, wm, rank, str(d)), wm)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        if len(back) * 2 != len(host) or any(
                not np.array_equal(a, host[f"{n}::lora_a"])
                or not np.array_equal(b, host[f"{n}::lora_b"])
                for n, (a, b, _) in back.items()):
            fail("phase 14 (b): the adapters did not round-trip through "
                 "save_peft_adapter and load_peft_adapter_arrays")
        say(f"  the int8 base unchanged; {len(back)} adapter pairs through a "
            f"PEFT directory and back")
    finally:
        spy.restore()
    return {"ms": step_s * 1e3, "tok_s": B * S / step_s, "peak_gb": peak,
            "int8_ms": int8_ms, "cp_async_ms": cp_ms}


def phase14c(torch, np, results) -> None:
    """(c) The milli training graph at GPT-2 124M's widths, 2 layers, B 2
    x S 128, AdamW: build_training_graph's one step through the
    executor on the card, its grad::* outputs against autograd's (the
    f32 LMTrainer on the same weights and batch) within 1e-3 of each
    tensor's largest |g|; then the same in bf16, where flash_attention
    takes the forward's causal Attention calls (launches equal to the
    eligible calls) and the bound is 5% of the largest |g| (bf16 rounds
    every node of the forward and the backward)."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (
        GraphExecutor)
    from whisper_tensor_tpu_torch.dtype import DType, to_device
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu_torch.milli.optimizers import (
        OptimizerKind, OptimizerOptions)
    from whisper_tensor_tpu_torch.milli.training_graph import (
        build_training_graph, init_opt_state)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.tensor_info import TensorInfo
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    L, B, S = (MILLI_TRAIN[k] for k in ("layers", "B", "S"))
    say(f"phase 14 (c): the milli training graph, GPT-2 124M widths, {L} "
        f"layers, B {B} x S {S}, AdamW")
    cfg = GPT2Config(**dict(GPT2_WIDTHS, n_layer=L))
    ids = np.random.default_rng(SEED + 21).integers(0, cfg.vocab_size,
                                                     (B, S + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    dev = torch.device(CARD)
    want = None
    for dt, frac in ((DType.F32, 1e-3), (DType.BF16, 5e-2)):
        model = Model.new_from_onnx(build_gpt2_train(
            random_gpt2_weights(cfg, SEED), cfg, dtype=dt))
        if want is None:                 # autograd's gradients, f32
            tr = LMTrainer(model, optimizer="adamw", lr=1e-3, device=CARD)
            leaves = {k: v.requires_grad_(True)
                      for k, v in tr.init_params().items()}
            loss = tr.loss_fn(leaves, x, y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            want = dict(zip(leaves, grads))
            want_loss = float(loss.detach())
            del tr, leaves, grads
        milli, weights = model.graph.to_milli(bake_small_constants=False)
        names = sorted(weights)
        t0 = time.perf_counter()
        g, meta = build_training_graph(
            milli, names, "logits", optimizer=OptimizerOptions(
                OptimizerKind.ADAMW, lr=1e-3, weight_decay=0.01),
            input_infos={"input_ids": TensorInfo.shaped(DType.I64, [B, S])})
        build_s = time.perf_counter() - t0
        params = {n: model.graph.store.get_numeric(n).numpy() for n in names}
        state = {k: v.astype(dt.to_numpy())          # Adam's m, v in dt
                 for k, v in init_opt_state(meta, params).items()}
        feeds = {"input_ids": x, "target": y,
                 "step": np.asarray(1.0, np.float32), **params, **state}
        feeds = {k: to_device(np.asarray(v), dev) for k, v in feeds.items()}
        spy = LoweringSpy(("Attention",))
        try:
            ex = GraphExecutor(g, dev)
            f0 = flash_attention.launches
            t0 = time.perf_counter()
            out = ex(feeds)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            flash = flash_attention.launches - f0
        finally:
            spy.restore()
        worst = 0.0
        for n in names:
            got = out[f"grad::{n}"].float()
            ref = want[n].float()
            share = ((got - ref).abs().max()
                     / ref.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, share)
        say(f"  {dt.name}: {len(g.nodes)} nodes ({sum(n.phase.value == 'backward' for n in g.nodes)} "
            f"backward), built in {build_s:.1f} s, one step through the "
            f"executor in {run_s:.2f} s (plan included); loss "
            f"{float(out['loss']):.5f} (autograd f32 {want_loss:.5f}); "
            f"grad::* against autograd: worst {worst:.3g} of the tensor's "
            f"largest |g| (bound {frac}); Attention calls "
            f"{spy.calls['Attention']}, flash-eligible {spy.eligible}, "
            f"flash_attention launches {flash}")
        if not worst <= frac:
            fail(f"phase 14 (c): {dt.name} grad::* off autograd's by "
                 f"{worst} of the largest |g|")
        if flash != spy.eligible or (dt is DType.BF16 and not flash):
            fail(f"phase 14 (c): {flash} flash launches for {spy.eligible} "
                 f"eligible Attention calls ({dt.name})")
        del g, ex, out, feeds, model


def run_phase14(step, torch, np, layers: int, results) -> None:
    t0 = time.perf_counter()
    a = step("phase 14 (a): GPT-2 124M training", phase14a, torch, np,
             results)
    b = step("phase 14 (b): QLoRA at Llama-3-8B widths", phase14b, torch, np,
             layers, results)
    step("phase 14 (c): the milli training graph", phase14c, torch, np,
         results)
    say(f"phase 14 in {time.perf_counter() - t0:.1f} s: GPT-2 124M "
        f"{a['ms']:.1f} ms a step, {a['tok_s']:.0f} tok/s, {a['peak_gb']:.2f}"
        f" GB; QLoRA {b['ms']:.1f} ms a step (int8 kernels {b['int8_ms']:.1f}"
        f" ms; {b['cp_async_ms']:.1f} with dx on the cp.async path), "
        f"{b['tok_s']:.0f} tok/s, {b['peak_gb']:.2f} GB")


# ---------------------------------------------------------------------------
# phase 15: the introspection path: the super graph over the WebSocket
# server, its capture taps, the inspection messages, export and inspect,
# the training super graph
SG_NEW = 16               # tokens the LLM super-graph job generates
SG_PROMPT = 200           # its prompt's tokens (byte tokenizer)


class SgRecorder:
    """A SuperObserver that keeps the values of the names it subscribes
    to (the port's observers receive snapshots)."""

    def __init__(self, names):
        from whisper_tensor_tpu_torch.super_graph import SuperObserver

        names = set(names)
        self.got = {}

        class Obs(SuperObserver):
            def subscribed(obs, name):
                return name in names

            def on_tensor_assigned(obs, name, value):
                self.got.setdefault(name, []).append(value)

        self.observer = Obs()


def sg_job(ws, msg) -> tuple:
    """Send a super_graph_request or generate_image; its reports up to
    the job's result and the seconds it took. A job_error fails."""
    t0 = time.perf_counter()
    ws.send(msg)
    reports = []
    while True:
        r = ws.recv()
        reports.append(r)
        if r["type"] == "job_error":
            fail(f"the job failed: {r.get('error')}\n{r.get('traceback', '')}")
        if r["type"] == "job_result":
            return reports, time.perf_counter() - t0


def node_ms(reports) -> dict:
    """{node name: (runs, mean host ms)} of a job's node_executed
    reports (the Scan's ms includes its body's)."""
    acc = {}
    for r in reports:
        if r["type"] == "node_executed":
            n, ms = acc.get(r["node"], (0, 0.0))
            acc[r["node"]] = (n + 1, ms + r["ms"])
    return {k: (n, ms / n) for k, (n, ms) in acc.items()}


def phase15_llm(torch, np, ckpt: Path, layers: int, results,
                rates, srv=None) -> dict:
    """(a)-(c): phase 3's checkpoint (int8, bf16) on the port's WebSocket
    server: loaded by run_loader over the WebSocket, or, given phase 3's
    Server `srv`, the model phase 3 loaded there (the checkpoint loads
    once in the whole smoke); its super graph fetched and run unchanged
    as a super_graph_request on a 200-token prompt; launches against the
    lowering's calls, every attention call shadowed, the answer against
    a teacher-forced prefill; then the same job with taps; the taps'
    prefill value against the plain attention path; the inspection
    messages over the same connection. Returns {"entry": the model's
    entry, "launches": ..., "tap_ms": ...}."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention, decode_attention_plain)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import int8_matmul
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.milli.ops import attention as attn_lowering
    from whisper_tensor_tpu_torch.server import protocol as P
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.super_graph import (ExecutionContext,
                                                      SuperGraph)
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    card = card_line()
    t_phase = time.perf_counter()
    say(f"phase 15 (a): the LLM super graph over the WebSocket server, "
        f"{layers} layers, int8, bf16; {card}")
    loaded = srv is not None
    srv = srv or Server()
    port, stop = ws_serve(srv)
    ws = WSClient(port)
    out = {}
    try:
        if loaded:
            (entry,) = [e for e in srv.models._models.values()
                        if (e.interfaces.get("text") or {}).get("quantize")
                        == "int8"]
            mid = entry.id
            say("  the model phase 3 loaded on this Server (no second load)")
        else:
            t0 = time.perf_counter()
            ws.send({"type": "run_loader", "loader": "transformers",
                     "config": {"path": str(ckpt), "dtype": "bf16",
                                "quantize": "int8", "max_len": MAX_LEN}})
            mid = ws.until("models_report")["loaded"][0]
            entry = srv.models.get(mid)
            say(f"  run_loader over the WebSocket: "
                f"{time.perf_counter() - t0:.1f} s")
        ws.send({"type": "get_super_graph", "model_id": mid,
                 "n_new": SG_NEW})
        graph = ws.until("super_graph")["graph"]
        text = long_text(np, SG_PROMPT, SEED + 50)
        msg = {"type": "super_graph_request", "graph": graph,
               "inputs": {"text": text}, "model_ids": [mid]}
        counters = {"decode_attention": decode_attention,
                    "flash_attention": flash_attention,
                    "ragged_kv_write": ragged_kv_write,
                    "kv_write_pair": kv_write_pair,
                    "int8_matmul": int8_matmul}
        zero(counters)
        spy = quant_spy(transforms)
        calls = CallCounter(("Attention", "DynUpdateSlice"))
        dshadow = shadow_checked(attn_lowering, decode_attention_plain,
                                 agreement_bound)
        fshadow = flash_shadow(attn_lowering, flash_attention_plain,
                               flash_agreement_bound)
        try:
            reports, first_s = sg_job(ws, msg)
        finally:
            attn_lowering.flash_attention = fshadow.inner
            attn_lowering.decode_attention = dshadow.inner
            transforms.int8_matmul = spy.inner
            calls.restore()
        got = {name: fn.launches for name, fn in counters.items()}
        result = reports[-1]["result"]
        toks = P.decode_tensor(result["tokens"]).astype(np.int64)
        prompt = np.asarray(ByteTokenizer().encode(text), np.int64)
        P_ = prompt.shape[0]
        say(f"  first job ({P_}-token prompt, {SG_NEW} new tokens; on the "
            f"text interface's int8 graph and weights{'' if loaded else ', made here'}, "
            f"plans included): {first_s:.1f} s; "
            f"launches {got}; lowering calls {calls.calls}, QuantMatMul "
            f"{spy.calls}; shadowed: decode_attention {dshadow.calls} calls "
            f"worst {dshadow.worst:.3g} of agreement_bound, flash "
            f"{fshadow.calls} calls worst {fshadow.worst:.3g} of "
            f"flash_agreement_bound")
        if toks.shape != (SG_NEW,) or toks.min() < 0:
            fail(f"the super-graph job answered tokens {toks}")
        if got["decode_attention"] != (SG_NEW - 1) * layers \
                or got["flash_attention"] != layers \
                or got["decode_attention"] + got["flash_attention"] \
                != calls.calls["Attention"] \
                or got["ragged_kv_write"] != calls.calls["DynUpdateSlice"] \
                or got["ragged_kv_write"] != 2 * SG_NEW * layers \
                or got["kv_write_pair"] != 0:
            fail(f"phase 15 (a): launches {got} against the lowering's "
                 f"calls {calls.calls}")
        check_quant_spy(spy, "phase 15 (a)'s super-graph job")
        if got["int8_matmul"] != spy.calls:
            fail(f"phase 15 (a): {got['int8_matmul']} int8_matmul launches "
                 f"for {spy.calls} QuantMatMul calls")
        if dshadow.calls != got["decode_attention"] \
                or fshadow.calls != got["flash_attention"] \
                or not max(dshadow.worst, fshadow.worst) <= 1.0:
            fail("phase 15 (a): an attention call of the job disagrees with "
                 "its plain version on the same inputs")
        for res in results:
            if res["name"] in got:
                res["launches_super_graph"] = got[res["name"]]
        out["launches"] = got

        # the answer against a teacher-forced prefill over prompt and
        # answer through the same int8 graph and weights (phase 3's
        # bound): the backend the job derived from
        be = srv._score_iface(entry).eval_backend()
        feeds = {"input_ids": torch.from_numpy(np.concatenate(
            [prompt, toks[:-1]])[None]).to(CARD),
            "pos": torch.tensor(0, device=CARD)}
        g = entry.model.graph
        for name, info in entry.model.input_infos().items():
            if name.startswith("cache_"):
                feeds[name] = torch.zeros(
                    [1] + [int(d.value()) for d in info.dims()[1:]],
                    dtype=torch.bfloat16, device=CARD)
        logits = be.run_on_device(g, feeds)["logits"][0].float().cpu().numpy()
        forced = logits[P_ - 1:P_ - 1 + SG_NEW]
        gaps = forced.max(-1) - forced[np.arange(SG_NEW), toks]
        frac = 0.015 * math.sqrt(layers)
        scale = float(np.abs(forced).max())
        say(f"  the answer against a teacher-forced prefill: worst (max "
            f"logit - emitted logit) {float(gaps.max()):.4g}, "
            f"{float(gaps.max()) / (frac * scale):.3g} of the bound "
            f"({frac:.1%} of max|logit| {scale:.4g}); argmax agreement "
            f"{float((gaps == 0).mean()):.3f}")
        if not float(gaps.max()) <= frac * scale:
            fail("phase 15 (a): the super graph's answer does not stand a "
                 "teacher-forced prefill")

        # warm, taps off and on
        warm, warm_s = sg_job(ws, msg)
        again = P.decode_tensor(warm[-1]["result"]["tokens"])
        if not np.array_equal(again, toks):
            fail("phase 15 (a): a second run of the job answered other "
                 "tokens")
        decode_ms = node_ms(warm)["LLMDecodeStepNode"][1]
        label = next(g.tensors[o].name for sop in g.ops
                     if sop.op.OP_TYPE == "Attention"
                     for o in sop.outputs if o is not None)
        subs = ["first_token", label]
        tap_runs = []
        for _i in range(2):
            reports2, s = sg_job(ws, dict(msg, tensor_subscriptions=subs))
            tap_runs.append(s)
        assigned = [r for r in reports2 if r["type"] == "tensor_assigned"]
        n_label = sum(r["link"] == label for r in assigned)
        n_first = sum(r["link"] == "first_token" for r in assigned)
        say(f"  (b) taps on 'first_token' and layer 0's attention output "
            f"{label!r}: {n_first} and {n_label} tensor_assigned reports "
            f"(a run of the step graph each: 1 + {SG_NEW - 1}); the job "
            f"{warm_s:.2f} s warm without taps, {tap_runs[0]:.2f} s with "
            f"them (their executor's plans built), {tap_runs[1]:.2f} s "
            f"again")
        if n_label != SG_NEW or n_first != 1 or len(assigned) != SG_NEW + 1:
            fail(f"phase 15 (b): {n_label} reports of the label, {n_first} "
                 f"of first_token")
        if not np.array_equal(P.decode_tensor(
                reports2[-1]["result"]["tokens"]), toks):
            fail("phase 15 (b): the job with taps answered other tokens")
        t = assigned[1]["tensor"] if assigned[0]["link"] == "first_token" \
            else assigned[0]["tensor"]
        if t["dtype"] != "bfloat16" or t["has_nan"]:
            fail(f"phase 15 (b): the tapped label's report {t}")

        # the tap's prefill value, in process, against the label of a
        # prefill with the attention kernels' plain versions in place
        # (the int8 products stay on their kernel, whose repeats are
        # bit-equal, so layer 0's attention sees the same q, k, v); the
        # magnitude is layer 0's plain attention on |v|
        rec = SgRecorder([label])
        ctx = ExecutionContext(models={entry.name: entry.model}, device=CARD,
                               observer=rec.observer,
                               capture_labels={label},
                               backends={entry.name: be})
        SuperGraph.from_json(graph).run(ctx, {"text": text})
        mine = rec.got[label][0].float()
        taps = {}

        class Keep:
            def on_tensor_assigned(self, graph, name, value):
                taps[name] = value.float()

            def on_loading_weight(self, name):
                pass

        tapped = be.derive(observer=Keep(), capture={label})
        pre = dict(feeds, input_ids=torch.from_numpy(prompt[None]).to(CARD))

        def prefill(fn):
            saved = (attn_lowering.flash_attention,
                     attn_lowering.decode_attention)
            attn_lowering.flash_attention = fn
            attn_lowering.decode_attention = decode_attention_plain
            try:
                tapped.run_on_device(g, {k: (v.zero_() if k.startswith(
                    "cache_") else v) for k, v in pre.items()})
            finally:
                (attn_lowering.flash_attention,
                 attn_lowering.decode_attention) = saved
            return taps[label]

        ref = prefill(flash_attention_plain)
        mag = prefill(lambda q, k, v, scale, **kw: flash_attention_plain(
            q, k, v.abs(), scale, **kw))
        err, share = worst_share(mine, ref, mag, flash_agreement_bound)
        say(f"  (b) the label's prefill value from the job's tap against "
            f"the plain attention path's: max |err| {err:.4g}, worst "
            f"{share:.3g} of flash_agreement_bound")
        if not share <= 1.0:
            fail("phase 15 (b): the tapped prefill value parts from the "
                 "plain path's")
        out["tap_ms"] = (tap_runs[1] - warm_s) * 1e3
        sg_tok_s = 1e3 / decode_ms
        direct = rates.get("tok_s") if rates else None
        say(f"  information: the super-graph job decodes at {sg_tok_s:.1f} "
            f"tok/s (its LLMDecodeStepNode's mean host ms {decode_ms:.2f}: "
            f"a step's inputs fed and its argmax token read back each "
            f"step); the direct path on this checkpoint (phase 3) "
            f"{'%.1f tok/s' % direct if direct else 'not measured in this run'}; "
            f"host ms a node {json.dumps({k: round(v[1], 2) for k, v in node_ms(warm).items()})}; "
            f"the taps cost {out['tap_ms']:.1f} ms a job "
            f"({SG_NEW} runs, two labels) on {card}")

        # (c) the inspection messages over the same connection
        ws.send({"type": "get_model_graph", "model_id": mid})
        gj = ws.until("model_graph")["graph"]
        ws.send({"type": "get_graph_layout", "model_id": mid})
        layout = ws.until("graph_layout")["layout"]
        ops = [n for n in layout["nodes"] if n["kind"] == "op"]
        ys = {n["id"]: n["y"] for n in layout["nodes"]}
        down = all(ys[e["src"]] < ys[e["dst"]] for e in layout["edges"])
        milli = {}
        for kind in ("Attention", "MatMul"):
            op = next(o for o in gj["ops"] if o["op_type"] == kind)
            ws.send({"type": "get_op_milli", "model_id": mid,
                     "op_id": op["id"]})
            milli[kind] = [n["kind"] for n in ws.until("op_milli")["nodes"]]
        row = 1234
        ws.send({"type": "get_tensor_slice", "model_id": mid,
                 "name": "embed_tokens", "fix": [row, None],
                 "max_cols": 512})
        sl = ws.until("tensor_slice")
        want = g.store.get_numeric("embed_tokens").numpy()[row, :512]
        diff = float(np.abs(np.asarray(sl["values"][0], np.float64)
                            - want.astype(np.float64)).max())
        say(f"  (c) get_graph_layout: {len(ops)} of {len(gj['ops'])} ops "
            f"placed, {len(layout['edges'])} edges, all pointing down: "
            f"{down}; get_op_milli: Attention -> {milli['Attention']}, "
            f"MatMul -> {milli['MatMul']}; get_tensor_slice of embedding "
            f"row {row}: {sl['slice_shape']}, max |diff| against the "
            f"checkpoint's {diff:.3g}")
        if len(ops) != len(gj["ops"]) or not down \
                or not milli["Attention"] or not milli["MatMul"] \
                or not diff <= 1e-6:
            fail("phase 15 (c): an inspection reply is wrong")
        ws.close()
        out["entry"] = entry
    finally:
        stop()
    say(f"[phase 15 (a)-(c): {time.perf_counter() - t_phase:.1f} s]")
    return out


def logits_equal(torch, np, a, b, ids, what: str) -> None:
    """One step of two Models on the card (zero bf16 caches, pos 0):
    their logits must be equal bit for bit."""
    outs = []
    for m in (a, b):
        feeds = {"input_ids": ids, "pos": np.asarray(0, np.int64)}
        for name, info in m.input_infos().items():
            if name.startswith("cache_"):
                feeds[name] = torch.zeros(
                    [1] + [int(d.value()) for d in info.dims()[1:]],
                    dtype=torch.bfloat16, device=CARD)
        outs.append(m.eval(feeds)["logits"])
    same = outs[0].shape == outs[1].shape and np.array_equal(
        outs[0].view(np.uint16), outs[1].view(np.uint16))
    say(f"  {what}: one step's logits {outs[0].shape} bit-equal to the "
        f"original model's: {same}")
    if not same:
        fail(f"phase 15 (e): {what}'s logits differ from the original's")


def phase15_export(torch, np, src: Path, weights: str, original=None,
                   inspect: bool = False) -> None:
    """(e) `cli export` of a checkpoint with `weights` (embed, external),
    reloaded by Model.new_from_onnx_file: one step's logits bit-equal to
    `original`'s (a loaded Model), or to the checkpoint loaded afresh
    (GPT-2 124M, max_len 256); with `inspect`, `cli inspect` of it
    first."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.model import Model

    say(f"phase 15 (e): cli export --weights {weights} of {src.name}"
        f"{' and cli inspect' if inspect else ''}")
    ids = np.asarray([list(range(10, 42))], np.int64)
    d = src.with_name(src.name + "-export")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    cfg = ["-c", "dtype=bf16", "-c",
           f"max_len={MAX_LEN if original is not None else 256}"]
    try:
        if inspect:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["inspect", "--model", str(src)] + cfg)
            info = json.loads(buf.getvalue())
            say(f"  cli inspect ({src.name}): {info['ops']} ops, "
                f"{info['weights']} weights ({info['weight_bytes'] / 1e9:.2f}"
                f" GB), op census {json.dumps(info['op_census'])}")
        out = d / f"{src.name}.onnx"
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["export", "--model", str(src), "-o", str(out),
                      "--weights", weights] + cfg)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Model.new_from_onnx_file(str(out))
        say(f"  cli export --weights {weights}: {buf.getvalue().strip()}"
            f" in {export_s:.1f} s; reloaded in "
            f"{time.perf_counter() - t0:.1f} s")
        if original is None:
            (original,) = identify_and_load(
                str(src), dtype="bf16", max_len=256).models.values()
        logits_equal(torch, np, original, back, ids,
                     f"{src.name} ({weights})")
        del back, original
        free_memory(torch)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase15_train(torch, np) -> None:
    """(f) the milli training graph of phase 14 (c) (2-layer GPT-2 at
    124M's widths, B 2 x S 128, AdamW, f32) as a training super graph of
    3 steps on one batch, against 3 steps of the same graph run directly
    through the executor: the losses bit-equal (deterministic algorithms
    on for both), and falling."""
    from whisper_tensor_tpu_torch.backends.torch_exec.compiler import (
        GraphExecutor)
    from whisper_tensor_tpu_torch.dtype import DType, to_device
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu_torch.milli.optimizers import (
        OptimizerKind, OptimizerOptions)
    from whisper_tensor_tpu_torch.milli.training_graph import (
        build_training_graph)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.super_graph import (ExecutionContext,
                                                      SuperGraph)
    from whisper_tensor_tpu_torch.super_graph.training import (
        build_training_supergraph, initial_train_state)
    from whisper_tensor_tpu_torch.tensor_info import TensorInfo

    L, B, S = (MILLI_TRAIN[k] for k in ("layers", "B", "S"))
    steps = 3
    say(f"phase 15 (f): the milli training graph as a super graph, GPT-2 "
        f"124M widths, {L} layers, B {B} x S {S}, AdamW, f32, {steps} steps")
    cfg = GPT2Config(**dict(GPT2_WIDTHS, n_layer=L))
    ids = np.random.default_rng(SEED + 21).integers(0, cfg.vocab_size,
                                                     (B, S + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    model = Model.new_from_onnx(build_gpt2_train(
        random_gpt2_weights(cfg, SEED), cfg, dtype=DType.F32))
    milli, weights = model.graph.to_milli(bake_small_constants=False)
    names = sorted(weights)
    g, meta = build_training_graph(
        milli, names, "logits", optimizer=OptimizerOptions(
            OptimizerKind.ADAMW, lr=1e-3, weight_decay=0.01),
        input_infos={"input_ids": TensorInfo.shaped(DType.I64, [B, S])})
    params = {n: model.graph.store.get_numeric(n).numpy() for n in names}
    state0 = initial_train_state(meta, params)
    sg = SuperGraph.loads(build_training_supergraph(
        g, meta, ["input_ids", "target"]).dumps())
    state_map = dict(meta.param_to_new)
    state_map.update(meta.opt_state_in_to_out)
    dev = torch.device(CARD)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        ex = GraphExecutor(g, dev)
        state = {k: to_device(np.asarray(v), dev) for k, v in state0.items()}
        direct = []
        for _ in range(steps):
            out = ex(dict(state, input_ids=to_device(x, dev),
                          target=to_device(y, dev)))
            direct.append(out["loss"].float().cpu().numpy())
            nxt = {k: out[v] for k, v in state_map.items()}
            nxt["step"] = state["step"] + 1.0
            state = nxt
        direct_s = time.perf_counter() - t0
        del ex, state, out
        t0 = time.perf_counter()
        res = sg.run(ExecutionContext(device=CARD), {
            "init_state": state0,
            "batches_input_ids": np.stack([x] * steps),
            "batches_target": np.stack([y] * steps)})
        job_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    losses = np.asarray(res["losses"], np.float32)
    direct = np.asarray(direct, np.float32)
    say(f"  losses: super graph {losses.tolist()} in {job_s:.2f} s, direct "
        f"{direct.tolist()} in {direct_s:.2f} s (plans included); "
        f"bit-equal: {np.array_equal(losses, direct)}; final step "
        f"{float(res['final_state']['step'])}")
    if not np.array_equal(losses, direct) or not losses[-1] < losses[0] \
            or float(res["final_state"]["step"]) != steps + 1:
        fail("phase 15 (f): the training super graph's losses differ from "
             "the direct run's, or do not fall")


class RunTrace:
    """Records every EvalBackend.run_on_device call while `on`: (the
    graph, the backend, copies of its feeds and of its outputs)."""

    def __init__(self, torch, np):
        from whisper_tensor_tpu_torch.backends.eval_backend import EvalBackend

        self.cls, self.inner = EvalBackend, EvalBackend.run_on_device
        self.calls, self.on = [], False

        def copy(v):
            if isinstance(v, torch.Tensor):
                return v.detach().clone()
            return torch.from_numpy(np.array(v))

        def spy(be, graph, feeds):
            out = self.inner(be, graph, feeds)
            if self.on:
                self.calls.append((graph, be,
                                   {k: copy(v) for k, v in feeds.items()},
                                   {k: copy(v) for k, v in out.items()}))
            return out

        EvalBackend.run_on_device = spy

    def restore(self) -> None:
        self.cls.run_on_device = self.inner


def max_diff(a, b) -> float:
    """max |a - b| over two tensors of one shape (inf if the shapes
    differ), on a's device."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.to(a.device).double()).abs().max())


def phase15_preview(torch, np, srv, mid: int, spy, results) -> None:
    """(d), at the end of phase 13 on its server and its SD-1.5 load
    (whose graphs are fixed at 512 x 512 by the loader): generate_image
    over the WebSocket at 4 steps, plainly and with `preview` (the
    diffusion super graph, one step_preview frame a denoise step):
    flash_attention's launches in the preview job equal the lowering's
    eligible Attention calls. Every model run of both requests is
    recorded (RunTrace): the two make the same 7 runs (CLIP twice, the
    UNet 4 times, the VAE) with bit-equal feeds and outputs, and the
    images are equal byte for byte. Both paths run the same graphs and
    executors, scale the UNet's input with one expression
    (`euler_scaled`) and update the latents with the same f32 arithmetic,
    and the post-processing of a bf16 VAE output gives the same byte in
    the interface's bf16 arithmetic and the job's f32 (every bf16 value in
    [-1.5, 1.5], checked on the CPU); so any difference is a fault."""
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)

    say(f"phase 15 (d): generate_image with preview over the WebSocket "
        f"(SD-1.5, {SD_HW} x {SD_HW}, 4 steps)")
    port, stop = ws_serve(srv)
    ws = WSClient(port)

    def pixels(r):
        res = r[-1]["result"]
        return np.frombuffer(base64.b64decode(res["rgb_b64"]),
                             np.uint8).reshape(res["height"],
                                               res["width"], 3)

    trace = RunTrace(torch, np)
    try:
        msg = {"type": "generate_image", "model_id": mid,
               "prompt": SD_PROMPT, "steps": 4, "height": SD_HW,
               "width": SD_HW, "seed": 5}
        trace.on = True
        plain, plain_s = sg_job(ws, msg)
        n_plain = len(trace.calls)
        flash_attention.launches = 0
        spy.zero()
        prev, prev_s = sg_job(ws, dict(msg, preview=True))
        launches, eligible = flash_attention.launches, spy.eligible
        trace.on = False
    finally:
        trace.restore()
        ws.close()
        stop()
    frames = [r for r in prev if r["type"] == "step_preview"]
    a, b = pixels(plain), pixels(prev)
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    A, B = trace.calls[:n_plain], trace.calls[n_plain:]
    names = [g.name for g, *_ in A]
    worst = 0.0
    for (ga, _, fa, oa), (gb, _, fb, ob) in zip(A, B):
        for x, y in ((fa, fb), (oa, ob)):
            worst = max([worst] + [max_diff(x[n], y[n]) if n in y
                                   else float("inf") for n in x])
    say(f"  {len(frames)} step_preview frames "
        f"({frames[0]['width']} x {frames[0]['height']} each); "
        f"flash_attention launched {launches} times for {eligible} eligible "
        f"Attention calls in the preview job; model runs {names} in both, "
        f"worst |diff| of their feeds and outputs {worst:.3g}; the image "
        f"against the plain request's at the same seed: max |diff| "
        f"{int(d.max())} of 255; {plain_s:.2f} s plain, {prev_s:.2f} s with "
        f"the preview on {card_line()}")
    if len(frames) != 4 or launches != eligible or launches == 0 \
            or a.shape != (SD_HW, SD_HW, 3) or len(A) != 7 \
            or names != [g.name for g, *_ in B] or worst != 0 \
            or int(d.max()) != 0:
        fail("phase 15 (d): the preview job's frames, launches, model runs "
             "or image part from the plain request's")
    for res in results:
        if res["name"] == "flash_attention":
            res["launches_preview"] = launches


def phase15_at_phase3(torch, np, srv, ckpt: Path, layers: int, results,
                      rates) -> None:
    """(a)-(c) and the Llama checkpoint's (e), on phase 3's Server and
    model, the super-graph job beside the direct path's rates."""
    llm = phase15_llm(torch, np, ckpt, layers, results, rates, srv)
    phase15_export(torch, np, ckpt, "external", llm["entry"].model)
    del llm
    free_memory(torch)


def phase15(torch, np, ckpt: Path, gpt2_ckpt: Path, layers: int,
            results) -> None:
    """Phase 15's parts that need no model of phase 3: (e) of GPT-2
    (embedded, with `cli inspect`) and (f); `ckpt`: given (the
    --inspect-only run), (a)-(c) and the Llama export run here too, on a
    model of their own loaded over the WebSocket."""
    if ckpt is not None:
        llm = phase15_llm(torch, np, ckpt, layers, results, None)
        phase15_export(torch, np, ckpt, "external", llm["entry"].model)
        del llm
        free_memory(torch)
    phase15_export(torch, np, gpt2_ckpt, "embed", inspect=True)
    free_memory(torch)
    phase15_train(torch, np)


# ---------------------------------------------------------------------------
# phase 16: the rest of the text family at published widths, seeded weights
# deepseek-ai/DeepSeek-V2-Lite (config.json; its yarn rope_scaling, which
# the recipe does not read, left out), 2 layers: one dense, one MoE
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2", hidden_size=2048, num_attention_heads=16,
    q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64,
    num_experts_per_tok=6, n_shared_experts=2, moe_intermediate_size=1408,
    intermediate_size=10944, first_k_dense_replace=1, moe_layer_freq=1,
    vocab_size=102400, rms_norm_eps=1e-6, rope_theta=10000.0,
    routed_scaling_factor=1.0, norm_topk_prob=False, topk_method="greedy",
    max_position_embeddings=163840, tie_word_embeddings=False,
    num_hidden_layers=2)
# google/flan-t5-base, full depth
FLAN_T5_BASE = dict(
    model_type="t5", d_model=768, d_kv=64, d_ff=2048, num_heads=12,
    num_layers=12, num_decoder_layers=12, vocab_size=32128,
    relative_attention_num_buckets=32, relative_attention_max_distance=128,
    feed_forward_proj="gated-gelu", tie_word_embeddings=False,
    layer_norm_epsilon=1e-6, decoder_start_token_id=0, eos_token_id=1)
# RWKV-7 World 1.5B (n_embd 2048, head size 64, vocab 65536, FFN 4 x
# 2048), 4 layers; the LoRA ranks the RWKV-7 code derives for C = 2048
# (w and a 96, v 64, g 256), which rwkv7_config_from_sd reads back
RWKV7_1B5 = dict(n_layer=4, n_embd=2048, n_head=32, vocab_size=65536,
                 lora_w=96, lora_a=96, lora_v=64, lora_g=256)
# llava-hf/llava-1.5-7b-hf: the CLIP ViT-L/14-336 tower at 4 layers, the
# projector to 4096, the Llama-2-7B text model at 2 layers
LLAVA_15_7B = {
    "model_type": "llava", "vision_feature_layer": -2,
    "image_token_index": 32000,
    "vision_config": dict(model_type="clip_vision_model", hidden_size=1024,
                          intermediate_size=4096, num_attention_heads=16,
                          num_hidden_layers=4, image_size=336,
                          patch_size=14, hidden_act="quick_gelu",
                          layer_norm_eps=1e-5),
    "text_config": dict(model_type="llama", hidden_size=4096,
                        intermediate_size=11008, num_attention_heads=32,
                        num_key_value_heads=32, num_hidden_layers=2,
                        vocab_size=32064, rms_norm_eps=1e-5,
                        rope_theta=10000.0, max_position_embeddings=4096)}
TF_PROMPT, DS_NEW, T5_NEW, RWKV_NEW, LLAVA_NEW = 512, 32, 64, 64, 32
# the C10 rule: the same math in two rounding orders, each step's logits
# within 1/16 of its largest |logit|
C10 = 1 / 16


def tiled_tensors(shapes: dict, seed: int, np, out_rows=(),
                  out_vocab: int = BYTE_VOCAB):
    """(name, f32 array) of `shapes` in order: matrices tile a seeded
    block of 2^20 + 7 normal values scaled 0.02 (as checkpoint_tensors),
    1-D weights are ones (the norms), other 1-D tensors zeros; the rows
    of `out_rows` tensors from `out_vocab` on (the byte tokenizer's ids
    by default) are zero, so greedy text decodes to bytes."""
    rng = np.random.default_rng(seed)
    for n, s in shapes.items():
        if len(s) == 1:
            yield n, np.full(s, float(n.endswith(".weight")), np.float32)
            continue
        base = rng.standard_normal((1 << 20) + 7, dtype=np.float32) * 0.02
        arr = np.resize(base, s)
        if n in out_rows:
            arr[out_vocab:] = 0.0
        yield n, arr


def deepseek_shapes(c: dict) -> dict:
    E, H, L = c["hidden_size"], c["num_attention_heads"], \
        c["num_hidden_layers"]
    qd = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    kvl, V = c["kv_lora_rank"], c["vocab_size"]
    s = {"model.embed_tokens.weight": (V, E), "model.norm.weight": (E,),
         "lm_head.weight": (V, E)}
    for i in range(L):
        p, a = f"model.layers.{i}.", f"model.layers.{i}.self_attn."
        s.update({p + "input_layernorm.weight": (E,),
                  p + "post_attention_layernorm.weight": (E,),
                  a + "q_proj.weight": (H * qd, E),
                  a + "kv_a_proj_with_mqa.weight":
                      (kvl + c["qk_rope_head_dim"], E),
                  a + "kv_a_layernorm.weight": (kvl,),
                  a + "kv_b_proj.weight":
                      (H * (c["qk_nope_head_dim"] + c["v_head_dim"]), kvl),
                  a + "o_proj.weight": (E, H * c["v_head_dim"])})
        mlps = [(p + "mlp.", c["intermediate_size"])]
        if i >= c["first_k_dense_replace"]:
            s[p + "mlp.gate.weight"] = (c["n_routed_experts"], E)
            m = c["moe_intermediate_size"]
            mlps = [(p + f"mlp.experts.{j}.", m)
                    for j in range(c["n_routed_experts"])] + [
                (p + "mlp.shared_experts.", m * c["n_shared_experts"])]
        for q, inter in mlps:
            s.update({q + "gate_proj.weight": (inter, E),
                      q + "up_proj.weight": (inter, E),
                      q + "down_proj.weight": (E, inter)})
    return s


def t5_shapes(c: dict) -> dict:
    E, H, F, V = c["d_model"], c["num_heads"], c["d_ff"], c["vocab_size"]
    HD = H * c["d_kv"]
    s = {"shared.weight": (V, E), "lm_head.weight": (V, E),
         "encoder.final_layer_norm.weight": (E,),
         "decoder.final_layer_norm.weight": (E,)}
    for part, n in (("encoder", c["num_layers"]),
                    ("decoder", c["num_decoder_layers"])):
        s[f"{part}.block.0.layer.0.SelfAttention.relative_attention_bias."
          f"weight"] = (c["relative_attention_num_buckets"], H)
        for i in range(n):
            p = f"{part}.block.{i}.layer."
            atts = ["0.SelfAttention."] + (["1.EncDecAttention."]
                                           if part == "decoder" else [])
            for a in atts:
                s.update({p + a + "q.weight": (HD, E),
                          p + a + "k.weight": (HD, E),
                          p + a + "v.weight": (HD, E),
                          p + a + "o.weight": (E, HD),
                          p + a[:2] + "layer_norm.weight": (E,)})
            f = "2." if part == "decoder" else "1."
            s.update({p + f + "DenseReluDense.wi_0.weight": (F, E),
                      p + f + "DenseReluDense.wi_1.weight": (F, E),
                      p + f + "DenseReluDense.wo.weight": (E, F),
                      p + f + "layer_norm.weight": (E,)})
    return s


def llava_shapes(c: dict) -> dict:
    t, v = c["text_config"], c["vision_config"]
    E, I, V = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
    s = {"language_model.model.embed_tokens.weight": (V, E),
         "language_model.model.norm.weight": (E,),
         "language_model.lm_head.weight": (V, E)}
    for i in range(t["num_hidden_layers"]):
        p = f"language_model.model.layers.{i}."
        s.update({p + "input_layernorm.weight": (E,),
                  p + "post_attention_layernorm.weight": (E,)})
        for n in ("q", "k", "v", "o"):
            s[p + f"self_attn.{n}_proj.weight"] = (E, E)
        s.update({p + "mlp.gate_proj.weight": (I, E),
                  p + "mlp.up_proj.weight": (I, E),
                  p + "mlp.down_proj.weight": (E, I)})
    VE, VF, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n_pos = (v["image_size"] // P) ** 2 + 1
    vp = "vision_tower.vision_model."
    s.update({vp + "embeddings.class_embedding": (VE,),
              vp + "embeddings.patch_embedding.weight": (VE, 3, P, P),
              vp + "embeddings.position_embedding.weight": (n_pos, VE),
              vp + "pre_layrnorm.weight": (VE,),
              vp + "pre_layrnorm.bias": (VE,),
              vp + "post_layernorm.weight": (VE,),
              vp + "post_layernorm.bias": (VE,)})
    for i in range(v["num_hidden_layers"]):
        p = f"{vp}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[p + f"self_attn.{n}.weight"] = (VE, VE)
            s[p + f"self_attn.{n}.bias"] = (VE,)
        for n in ("layer_norm1", "layer_norm2"):
            s[p + n + ".weight"] = s[p + n + ".bias"] = (VE,)
        s.update({p + "mlp.fc1.weight": (VF, VE), p + "mlp.fc1.bias": (VF,),
                  p + "mlp.fc2.weight": (VE, VF), p + "mlp.fc2.bias": (VE,)})
    mp = "multi_modal_projector."
    s.update({mp + "linear_1.weight": (E, VE), mp + "linear_1.bias": (E,),
              mp + "linear_2.weight": (E, E), mp + "linear_2.bias": (E,)})
    return s


def write_hf(d: Path, cfg: dict, shapes: dict, seed: int, np, bf16,
             out_rows, out_vocab: int = BYTE_VOCAB) -> int:
    (d / "config.json").write_text(json.dumps(cfg))
    return write_safetensors(d, shapes, tiled_tensors(
        shapes, seed, np, out_rows, out_vocab), np, bf16)


class RouteSpy:
    """Counts, on the card, the Attention lowering's calls, the cache
    writes (DynUpdateSlice one cache, KVWrite a pair) and what the
    attention routes choose: flash_mode's modes and pos_mode's
    "flash_pos" (flash_attention) and "decode" (decode_attention). The
    lowering kinds are wrapped before the plans are built, which keep
    them; the routes are the lowering module's globals, looked up at
    each call."""

    KINDS = ("Attention", "DynUpdateSlice", "KVWrite")

    def __init__(self):
        from whisper_tensor_tpu_torch.milli.ops import attention as att

        self.calls = CallCounter(self.KINDS)
        self.att, self.routes = att, {}
        self.saved = {n: getattr(att, n) for n in ("flash_mode", "pos_mode")}
        for name, fn in self.saved.items():
            def spy(*a, _fn=fn, **kw):
                mode = _fn(*a, **kw)
                self.routes[mode] = self.routes.get(mode, 0) + 1
                return mode

            setattr(att, name, spy)

    def zero(self):
        self.routes.clear()
        for k in self.KINDS:
            self.calls.calls[k] = 0

    def snapshot(self) -> dict:
        r = self.routes
        return {"Attention calls": self.calls.calls["Attention"],
                "flash-eligible calls": sum(v for k, v in r.items()
                                            if k not in (None, "decode")),
                "decode-eligible calls": r.get("decode", 0),
                "DynUpdateSlice calls": self.calls.calls["DynUpdateSlice"],
                "KVWrite calls": self.calls.calls["KVWrite"]}

    def restore(self):
        self.calls.restore()
        for name, fn in self.saved.items():
            setattr(self.att, name, fn)


def family_kernels():
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_attention)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, ragged_kv_write)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul)

    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "int8_matmul": int8_matmul, "ragged_kv_write": ragged_kv_write,
            "kv_write_pair": kv_write_pair}


def counted(run, spy, qspy, label: str, results,
            key: str = "launches_phase16", attention: bool = True):
    """run() with every kernel counter, spy and QuantMatMul spy at 0 just
    before it and read just after; each launch count must equal the
    lowering's eligible calls, and (`attention`) some Attention call must
    have run. Returns (run's value, launches); each kernel's launches
    also go into its `results` entry under `key`."""
    kernels = family_kernels()
    for fn in kernels.values():
        fn.launches = 0
    spy.zero()
    qspy.calls = qspy.launched = 0
    out = run()
    launches = {n: fn.launches for n, fn in kernels.items()}
    launches.update(spy.snapshot(), **{"QuantMatMul calls": qspy.calls})
    say(f"  {label}: kernel launches {launches}")
    want = {"flash_attention": launches["flash-eligible calls"],
            "decode_attention": launches["decode-eligible calls"],
            "int8_matmul": launches["QuantMatMul calls"],
            "kv_write_pair": launches["KVWrite calls"],
            "ragged_kv_write": launches["KVWrite calls"]
            + launches["DynUpdateSlice calls"]}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad or (attention and launches["Attention calls"] <= 0):
        fail(f"{label}: launches against the lowering's eligible calls "
             f"(launched, eligible): {bad}, or no Attention call ran")
    for res in results:
        if res["name"] in launches:
            d = res.setdefault(key, {})
            d[label] = d.get(label, 0) + launches[res["name"]]
    return out, launches


def kv_shadow(misc, name: str, plain):
    """Install, in the cache-write lowerings' module, a `name`
    (ragged_kv_write or kv_write_pair) that calls the one installed
    before and holds the caches it writes, bit for bit, against `plain`
    on clones of the caches as they were. Returns it; `.inner` is the
    one it wraps, `.worst` 0 while every write was exact, else inf."""
    inner = getattr(misc, name)

    def checked(*a):
        # a: (cache, update, pos) or (cache_k, update_k, cache_v,
        # update_v, pos); the caches are the even places before pos
        want = plain(*(x.clone() if i % 2 == 0 and i < len(a) - 1 else x
                       for i, x in enumerate(a)))
        got = inner(*a)
        want, got = ((want, got) if name == "kv_write_pair"
                     else ((want,), (got,)))
        for g, w in zip(got, want):
            if not g.equal(w):
                checked.worst = float("inf")
                checked.max_err = max(checked.max_err, float(
                    (g.float() - w.float()).abs().max()))
        checked.calls += 1
        return got if name == "kv_write_pair" else got[0]

    checked.inner, checked.calls, checked.worst, checked.max_err = \
        inner, 0, 0.0, 0.0
    setattr(misc, name, checked)
    return checked


class Shadows:
    """flash_attention, decode_attention, int8_matmul and both cache
    writes, each call held against its plain version on its inputs
    while installed (the writes bit for bit)."""

    def __init__(self):
        from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
        from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
            decode_attention_plain)
        from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
            flash_agreement_bound, flash_attention_plain)
        from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
            kv_write_pair_plain, ragged_kv_write_plain)
        from whisper_tensor_tpu_torch.milli import transforms
        from whisper_tensor_tpu_torch.milli.ops import attention as att
        from whisper_tensor_tpu_torch.milli.ops import misc

        self.att, self.tr, self.misc = att, transforms, misc
        self.sh = {
            "flash_attention": flash_shadow(att, flash_attention_plain,
                                            flash_agreement_bound),
            "decode_attention": shadow_checked(att, decode_attention_plain,
                                               agreement_bound),
            "int8_matmul": int8_shadow(transforms, agreement_bound),
            "ragged_kv_write": kv_shadow(misc, "ragged_kv_write",
                                         ragged_kv_write_plain),
            "kv_write_pair": kv_shadow(misc, "kv_write_pair",
                                       kv_write_pair_plain)}

    def close(self, label: str, launches: dict):
        self.att.flash_attention = self.sh["flash_attention"].inner
        self.att.decode_attention = self.sh["decode_attention"].inner
        self.tr.int8_matmul = self.sh["int8_matmul"].inner
        for name in ("ragged_kv_write", "kv_write_pair"):
            setattr(self.misc, name, self.sh[name].inner)
        # the counted run's single-cache launches: ragged_kv_write's
        # counter also counts the pairs
        counted = dict(launches, ragged_kv_write=launches["ragged_kv_write"]
                       - launches["kv_write_pair"])
        for name, sh in self.sh.items():
            exact = name in ("ragged_kv_write", "kv_write_pair")
            say(f"  {label}: {sh.calls} {name} calls of the shadowed rerun "
                f"against the plain version: "
                + (f"{'bit for bit' if sh.worst == 0 else 'DIFFERENT'} "
                   f"(max |err| {sh.max_err:.5g})" if exact else
                   f"worst |err|/bound {sh.worst:.4g} (max |err| "
                   f"{sh.max_err:.5g})"))
            if (sh.calls > 0) != (counted[name] > 0) or not sh.worst <= 1.0:
                fail(f"{label}: the {name} calls of the rerun were not all "
                     f"within the plain version's bound, or ran where the "
                     f"counted run launched none ({counted[name]}), or "
                     f"none where it launched")


def rows_within(np, got, want, frac: float, what: str) -> float:
    """Each logit row of `got` within `frac` of its largest |logit| in
    `want`; returns the worst share of the bound."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = frac * np.abs(want).max(axis=-1, keepdims=True)
    share = float((np.abs(got - want) / lim).max())
    say(f"  {what}: worst |diff| {share:.4g} of the bound ({frac:.4g} of "
        f"each row's max |logit|)")
    if not share <= 1.0:
        fail(f"{what}: logits beyond the bound")
    return share


def mla_attention_ms(torch, absorb: bool) -> str:
    """The plain attention path of one MLA decode call at 2,048 keys
    (V2-Lite's 16 heads), timed through the Attention lowering."""
    from whisper_tensor_tpu_torch.milli.ops import attention as att

    c = DEEPSEEK_V2_LITE
    H, L = c["num_attention_heads"], MAX_LEN
    qd = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    if absorb:
        D, Dv, Hkv = c["kv_lora_rank"] + c["qk_rope_head_dim"], \
            c["kv_lora_rank"], 1
    else:
        D, Dv, Hkv = qd, c["v_head_dim"], H
    gen = torch.Generator(device=CARD).manual_seed(SEED + 16)
    op = att.AttentionMilli(scale=qd ** -0.5)
    args = []
    for _ in range(copies_for(2 * L * Hkv * (D + Dv))):
        args.append(([torch.randn(1, H, 1, D, generator=gen, device=CARD,
                                  dtype=torch.bfloat16),
                      torch.randn(1, Hkv, L, D, generator=gen, device=CARD,
                                  dtype=torch.bfloat16),
                      torch.randn(1, Hkv, L, Dv, generator=gen, device=CARD,
                                  dtype=torch.bfloat16),
                      torch.zeros(1, 1, 1, L, device=CARD,
                                  dtype=torch.bfloat16)],))
    if att.flash_mode(op, *args[0][0], False) is not None:
        fail("an MLA decode call would take a kernel")
    ms = time_ms(torch, lambda ins: att.attention(op, ins, {}, torch.device(
        CARD)), args)
    b_ms, _ = bound(2 * L * Hkv * (D + Dv), 2 * H * L * (D + Dv))
    return (f"{'absorbed' if absorb else 'naive'} (q {H}x{D}, k/v {Hkv} "
            f"head(s) x {L} x {D}/{Dv}): {ms:.4f} ms a call, "
            f"{ms * c['num_hidden_layers']:.4f} ms a decode step at "
            f"{c['num_hidden_layers']} layers; bound {b_ms:.4f} ms")


def moe_layer_products(iface, layer: int) -> int:
    """QuantMatMul nodes of one layer in the graph the interface runs."""
    g = iface._exec.graph
    names = {tid: n for n, tid in g.inputs.items()}
    n = 0
    for node in g.nodes:
        if node.op.KIND == "QuantMatMul":
            m = re.match(r"(?:q|kv_a|wo|router|exp|shexp|mlp)_(\d+)",
                         names.get(node.inputs[1], ""))
            n += bool(m) and int(m.group(1)) == layer
    return n


def phase16_deepseek(torch, np, root: Path, bf16, results,
                     both: bool = True) -> None:
    """(a) DeepSeek-V2-Lite widths, 2 layers, int8, absorbed MLA over
    /v1/completions, and with `both` (--text-family-only since phase 20
    came) the naive build against it."""
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    c = DEEPSEEK_V2_LITE
    d = root / "deepseek-v2-lite"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shapes = deepseek_shapes(c)
    nbytes = write_hf(d, c, shapes, SEED + 161, np, bf16, ("lm_head.weight",))
    say(f"  (a) wrote DeepSeek-V2-Lite at {c['num_hidden_layers']} layers "
        f"({sum(math.prod(s) for s in shapes.values()) / 1e9:.3f} B "
        f"parameters, {nbytes / 1e9:.2f} GB)")
    say("  (a) the plain MLA attention path: " + mla_attention_ms(torch, True)
        + "; " + mla_attention_ms(torch, False))
    text = long_text(np, TF_PROMPT, SEED + 162)
    prompt = np.asarray(ByteTokenizer().encode(text), np.int64)[None]
    kept = {}
    try:
        for absorb in (True, False) if both else (True,):
            label = f"deepseek {'absorbed' if absorb else 'naive'}"
            spy, qspy = RouteSpy(), quant_spy(transforms)
            api = None
            try:
                srv = Server()
                t0 = time.perf_counter()
                (entry,) = srv.models.run_loader("transformers", {
                    "path": str(d), "dtype": "bf16", "quantize": "int8",
                    "max_len": MAX_LEN, "absorb_mla": absorb})
                iface = srv._text_iface(entry)
                iface._weights()
                torch.cuda.synchronize()
                say(f"  (a) {label}: loaded in {time.perf_counter() - t0:.1f}"
                    f" s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
                    f"card")
                api = OpenAIApi(srv, "127.0.0.1", 0).start()
                r, launches = counted(lambda: completion(api.port, {
                    "prompt": text, "max_tokens": DS_NEW, "temperature": 0}),
                    spy, qspy, f"(a) {label}", results)
                if launches["KVWrite calls"] or launches[
                        "flash_attention"] or launches["decode_attention"]:
                    fail(f"{label}: MLA must take the plain attention path "
                         f"and write its two caches unpaired")
                for fn in family_kernels().values():
                    fn.launches = 0
                qspy.calls = 0
                iface.step(torch.zeros((1, 1), dtype=torch.int64,
                                       device=CARD),
                           torch.tensor(TF_PROMPT, device=CARD),
                           iface.fresh_cache(1))
                torch.cuda.synchronize()
                step_launches = family_kernels()["int8_matmul"].launches
                say(f"  (a) {label}: one decode step: {qspy.calls} "
                    f"QuantMatMul calls, {step_launches} int8_matmul "
                    f"launches; the MoE layer's graph holds "
                    f"{moe_layer_products(iface, 1)} of them, the dense "
                    f"layer's {moe_layer_products(iface, 0)}")
                if step_launches != qspy.calls:
                    fail(f"{label}: a decode step's int8 launches are not "
                         f"its QuantMatMul calls")
            finally:
                if api is not None:
                    api.stop()
                spy.restore()
                transforms.int8_matmul = qspy.inner
            direct_rates(torch, iface, prompt, c["num_hidden_layers"])
            sh = Shadows()
            try:
                toks, steps = iface.generate_with_logits(prompt, DS_NEW)
                full = np.concatenate([prompt, toks[:, :-1]], axis=1)
                forced = iface.logits(full)[:, TF_PROMPT - 1:]
            finally:
                sh.close(f"(a) {label}", launches)
            if ByteTokenizer().decode(list(toks[0])) != \
                    r["choices"][0]["text"]:
                fail(f"{label}: the interface's greedy tokens differ from "
                     f"the HTTP text")
            rows_within(np, steps, forced, 0.015 * math.sqrt(
                c["num_hidden_layers"]), f"(a) {label}: decode vs "
                f"teacher-forced prefill")
            kept[absorb] = (toks, steps, forced, None)
            if absorb:
                del iface, srv, entry
            else:
                kept[False] = kept[False][:3] + (
                    lambda ids: iface.logits(ids)[:, TF_PROMPT - 1:],)
            free_memory(torch)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not both:
        return
    # the two builds' teacher-forced logits over the absorbed build's
    # tokens: the same math in another rounding order
    if not np.array_equal(kept[True][0], kept[False][0]):
        say("  (a) the two builds' greedy tokens part (a near tie in bf16)")
    nt = np.concatenate([prompt, kept[True][0][:, :-1]], axis=1)
    rows_within(np, kept[False][3](nt), kept[True][2], C10,
                "(a) naive vs absorbed teacher-forced logits (C10)")


def phase16_t5(torch, np, root: Path, bf16, results) -> None:
    """(b) flan-t5-base widths, full depth: `cli generate`, greedy and
    beams of 4."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.seq2seq import Seq2SeqInterface
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    c = FLAN_T5_BASE
    d = root / "flan-t5-base"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shapes = t5_shapes(c)
    nbytes = write_hf(d, c, shapes, SEED + 163, np, bf16, ("lm_head.weight",))
    n_par = sum(math.prod(s) for s in shapes.values())
    say(f"  (b) wrote flan-t5-base ({n_par / 1e9:.3f} B parameters, "
        f"{nbytes / 1e9:.2f} GB)")
    text = long_text(np, 200, SEED + 164)
    argv = ["generate", "--model", str(d), "--prompt", text,
            "--max-new-tokens", str(T5_NEW), "--max-len", "128", "-c",
            "dtype=bf16"]
    outs = {}
    try:
        for beams in (1, 4):
            spy, qspy = RouteSpy(), quant_spy(transforms)
            buf = io.StringIO()

            def run_cli():
                with contextlib.redirect_stdout(buf):
                    cli.main(argv + ["--num-beams", str(beams)])

            try:
                t0 = time.perf_counter()
                counted(run_cli, spy, qspy,
                        f"(b) cli generate, {beams} beam(s)", results)
                say(f"  (b) cli generate --num-beams {beams}: "
                    f"{time.perf_counter() - t0:.1f} s with the load")
            finally:
                spy.restore()
                transforms.int8_matmul = qspy.inner
            outs[beams] = buf.getvalue().rstrip("\n")
            say(f"  (b) {beams} beam(s): {outs[beams][:60]!r}")
            free_memory(torch)
        t0 = time.perf_counter()
        b = identify_and_load(str(d), dtype="bf16", max_len=128)
        spec = b.interfaces["text2text"]
        s2s = Seq2SeqInterface(b.models[spec["encoder"]],
                               b.models[spec["decoder"]], spec["max_len"],
                               spec["start"], spec["eos"],
                               cache_dtype=DType.BF16)
        tok = ByteTokenizer()
        ids = np.asarray(tok.encode(text), np.int64)[None]
        enc = s2s.encode(ids)
        torch.cuda.synchronize()
        say(f"  (b) loaded in {time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        t0 = time.perf_counter()
        s2s.encode(ids)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        greedy = s2s.generate_tokens(ids, T5_NEW)
        dec_s = time.perf_counter() - t0 - enc_ms / 1e3
        t0 = time.perf_counter()
        beams = s2s.beam_search_tokens(ids, T5_NEW, beam=4)
        beam_s = time.perf_counter() - t0
        say(f"  (b) encoder {enc_ms:.1f} ms (512 positions), greedy decode "
            f"{T5_NEW / dec_s:.1f} tok/s, beams of 4 {beam_s:.2f} s for "
            f"{T5_NEW} steps, on {card_line()}")
        for want, (name, got) in zip((outs[1], outs[4]),
                                     (("greedy", greedy), ("beams", beams))):
            t = [int(x) for x in got[0]]
            if 1 in t:
                t = t[:t.index(1)]
            if tok.decode(t) != want:
                fail(f"(b) the cli's {name} text is not the interface's")
        # the greedy decode's step logits against one teacher-forced pass
        # of the decoder over [start] + the tokens
        steps, caches = [], s2s.fresh_cache(1)
        crosses = [enc[n] for n in s2s.cross_in]
        cur = s2s._prefix(1)
        pos = torch.zeros((), dtype=torch.int64, device=CARD)
        for i in range(T5_NEW):
            lg = s2s._step(cur, pos, caches, crosses)[:, -1]
            steps.append(lg.float())
            cur = torch.from_numpy(greedy[:, i:i + 1]).to(CARD)
            pos = pos + 1
        seq = torch.from_numpy(np.concatenate(
            [[[0]], greedy[:, :-1]], axis=1)).to(CARD)
        forced = s2s._step(seq, torch.zeros((), dtype=torch.int64,
                                            device=CARD),
                           s2s.fresh_cache(1), crosses)[0].float()
        rows_within(np, torch.stack(steps, 1)[0].cpu().numpy(),
                    forced.cpu().numpy(), 0.015 * math.sqrt(24),
                    "(b) greedy decode vs teacher-forced decoder")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def write_world_vocab(path: Path, np) -> None:
    """A seeded RWKV World vocabulary file: the 256 bytes, then 4,096
    lowercase words of 2 to 6 letters (with leading spaces for half)."""
    rng = np.random.default_rng(SEED + 165)
    toks = [bytes([b]) for b in range(256)]
    seen = set(toks)
    while len(toks) < 256 + 4096:
        w = bytes(rng.integers(97, 123, int(rng.integers(2, 7))).tolist())
        if rng.random() < 0.5:
            w = b" " + w
        if w not in seen:
            seen.add(w)
            toks.append(w)
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(toks, 1):
            try:
                rep = repr(t.decode("utf-8"))
            except UnicodeDecodeError:
                rep = repr(t)
            f.write(f"{i} {rep} {len(t)}\n")


def phase16_rwkv(torch, np, root: Path, results,
                 all_layers: bool = True) -> None:
    """(c) RWKV-7 World 1.5B widths, 4 layers (2 in the default run,
    without `all_layers`), a .pth by torch.save: a 512-token scan and 64 tokens of
    step-by-step greedy feedback; then on the prompt's first 32 tokens
    64 tokens of the served greedy loop over the WebSocket and
    /v1/completions against stepwise feedback."""
    from whisper_tensor_tpu_torch.importers.recipes.llm import rwkv7
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import RwkvWorldTokenizer

    d = root / "rwkv7"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    pth, vocab = d / "rwkv7-world-1.5b-widths.pth", d / "rwkv_vocab.txt"
    cfg = rwkv7.Rwkv7Config(**dict(RWKV7_1B5, n_layer=RWKV7_1B5["n_layer"]
                                   if all_layers else 2))
    sd = rwkv7.random_rwkv7_weights(cfg, seed=SEED + 166)
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in sd.items()}, str(pth))
    say(f"  (c) wrote RWKV-7 at 1.5B widths, {cfg.n_layer} layers (LoRA "
        f"ranks w {cfg.lora_w}, a {cfg.lora_a}, v {cfg.lora_v}, g "
        f"{cfg.lora_g}; {sum(v.size for v in sd.values()) / 1e9:.3f} B "
        f"parameters, {pth.stat().st_size / 1e9:.2f} GB bf16)")
    del sd
    write_world_vocab(vocab, np)
    stop = None
    try:
        srv = Server()
        t0 = time.perf_counter()
        (entry,) = srv.models.run_loader("rwkv7", {
            "path": str(pth), "dtype": "bf16", "tokenizer": str(vocab)})
        iface = srv._rnn_iface(entry)
        iface._weights()
        torch.cuda.synchronize()
        g = entry.model.graph
        ranks = {k: int(g.tensors[g.by_name[f"blocks_{i}_att_{k}1"]].info
                        .dims()[1].value())
                 for k, i in (("w", 0), ("a", 0), ("v", 1), ("g", 0))}
        say(f"  (c) loaded in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
            f"the loader's LoRA ranks (rwkv7_config_from_sd) {ranks}")
        if ranks != {"w": cfg.lora_w, "a": cfg.lora_a, "v": cfg.lora_v,
                     "g": cfg.lora_g}:
            fail("(c) the loader read other LoRA ranks")
        tok = RwkvWorldTokenizer(str(vocab))
        text = long_text(np, 4 * TF_PROMPT, SEED + 167)
        ids = np.asarray(tok.encode(text)[:TF_PROMPT], np.int64)
        text = tok.decode(list(ids))
        if len(ids) != TF_PROMPT:
            fail(f"(c) the prompt has {len(ids)} tokens")
        iface._feed(ids[None, :16])            # the executor's plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = iface._feed(ids[None])
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            fail("(c) the scan's logits are not finite")
        # 64 tokens by step-by-step feedback: the decode rate
        t0 = time.perf_counter()
        manual = []
        for _ in range(RWKV_NEW):
            manual.append(torch.argmax(logits, dim=-1))
            logits, st = iface.step(manual[-1], st)
        torch.stack(manual, 1).cpu()
        rate = RWKV_NEW / (time.perf_counter() - t0)
        say(f"  (c) a {TF_PROMPT}-token scan {scan_s * 1e3:.1f} ms "
            f"({TF_PROMPT / scan_s:.0f} tok/s), greedy decode {rate:.1f} "
            f"tok/s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
            f"card, on {card_line()}")
        # the served greedy loop on the prompt's first 32 tokens (each
        # route scans its prompt again) against stepwise feedback
        ids = ids[:32]
        text = tok.decode(list(ids))
        logits, st = iface._feed(ids[None])
        manual = []
        for _ in range(RWKV_NEW):
            manual.append(int(torch.argmax(logits, dim=-1)[0]))
            logits, st = iface.step(torch.tensor([manual[-1]], device=CARD),
                                    st)
        want = tok.decode(manual)
        kernels = family_kernels()
        for fn in kernels.values():
            fn.launches = 0
        port, stop = ws_serve(srv)
        ws = WSClient(port)
        reports, ws_s = sg_job(ws, {"type": "generate_text",
                                    "model_id": entry.id, "prompt": text,
                                    "max_new_tokens": RWKV_NEW})
        ws.close()
        api = OpenAIApi(srv, "127.0.0.1", 0).start()
        try:
            r = completion(api.port, {"prompt": text, "max_tokens": RWKV_NEW,
                                      "temperature": 0})
        finally:
            api.stop()
        got = (reports[-1]["result"]["text"], r["choices"][0]["text"])
        say(f"  (c) WebSocket {ws_s:.2f} s and /v1/completions: {got[0][:60]!r}")
        if got != (want, want):
            fail("(c) the WebSocket or HTTP text (the interface's greedy "
                 "loop) is not the stepwise feedback's")
        launches = {n: fn.launches for n, fn in kernels.items()}
        say(f"  (c) kernel launches over the WebSocket and HTTP: {launches} "
            f"(the step graph holds no attention and no int8 product)")
        for res in results:
            if res["name"] in launches:
                res.setdefault("launches_phase16", {})["(c) rwkv7"] = \
                    launches[res["name"]]
    finally:
        if stop is not None:
            stop()
        shutil.rmtree(d, ignore_errors=True)


def seeded_pixels(np, size: int):
    """Seeded size x size RGB u8 pixels: smooth gradients plus noise."""
    rng = np.random.default_rng(SEED + 168)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([x, y, (x + y) / 2], axis=-1) * 200
    img += rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def png_of(np, size: int) -> bytes:
    """seeded_pixels as a PNG."""
    from whisper_tensor_tpu_torch.utils.image import png_bytes

    return png_bytes(seeded_pixels(np, size))


def phase16_llava(torch, np, root: Path, bf16, results) -> None:
    """(d) LLaVA-1.5-7B widths: generate_multimodal over the WebSocket
    and /v1/chat/completions with an image content part."""
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    c = LLAVA_15_7B
    d = root / "llava-1.5-7b"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shapes = llava_shapes(c)
    nbytes = write_hf(d, c, shapes, SEED + 169, np, bf16,
                      ("language_model.lm_head.weight",))
    say(f"  (d) wrote LLaVA-1.5-7B widths (tower 4 layers, text 2 layers; "
        f"{sum(math.prod(s) for s in shapes.values()) / 1e9:.3f} B "
        f"parameters, {nbytes / 1e9:.2f} GB)")
    png64 = base64.b64encode(png_of(np, 336)).decode()
    items = [{"text": "USER: "}, {"image_b64": png64},
             {"text": "\nDescribe the picture. ASSISTANT:"}]
    chat = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is in this image?"},
        {"type": "image_url", "image_url": {
            "url": "data:image/png;base64," + png64}}]}],
        "max_tokens": LLAVA_NEW, "temperature": 0}
    spy, qspy = RouteSpy(), quant_spy(transforms)
    stop = api = None
    try:
        srv = Server()
        t0 = time.perf_counter()
        entries = srv.models.run_loader("transformers", {
            "path": str(d), "dtype": "bf16", "quantize": "int8",
            "max_len": MAX_LEN})
        entry = next(e for e in entries if not e.name.endswith("-vision"))
        mm, spec = srv._mm_iface(entry)
        mm.text._weights()
        torch.cuda.synchronize()
        say(f"  (d) loaded in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        port, stop = ws_serve(srv)
        api = OpenAIApi(srv, "127.0.0.1", 0).start()

        def serve():
            ws = WSClient(port)
            reports, ws_s = sg_job(ws, {
                "type": "generate_multimodal", "model_id": entry.id,
                "items": items, "max_new_tokens": LLAVA_NEW})
            ws.close()
            status, data = request(api.port, "/v1/chat/completions", chat)
            if status != 200:
                fail(f"(d) /v1/chat/completions answered {status}: "
                     f"{data[:300]!r}")
            return reports[-1]["result"]["text"], json.loads(data), ws_s

        (ws_text, r, ws_s), launches = counted(
            serve, spy, qspy, "(d) llava generate_multimodal + chat",
            results)
        say(f"  (d) WebSocket {ws_s:.2f} s: {ws_text[:60]!r}; chat: "
            f"{r['choices'][0]['message']['content'][:60]!r} "
            f"({r['usage']['prompt_tokens']} prompt positions)")
        if not launches["flash_attention"] or not launches[
                "decode_attention"] or not launches["int8_matmul"]:
            fail("(d) the tower, the prefill or the decode took no kernel")
    finally:
        if api is not None:
            api.stop()
        if stop is not None:
            stop()
        spy.restore()
        transforms.int8_matmul = qspy.inner
    # timing, then the decode held against a teacher-forced embeds
    # prefill, every kernel call shadowed
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    mm.text.tokenizer = ByteTokenizer()
    mitems = srv._mm_items(spec, items)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embeds = mm.embed_items(mitems)
        torch.cuda.synchronize()
        emb_ms = (time.perf_counter() - t0) * 1e3
        L = embeds.shape[1]
        t0 = time.perf_counter()
        mm.generate_from_embeds(embeds, 1)
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        mm.generate_from_embeds(embeds, LLAVA_NEW + 1)
        rate = LLAVA_NEW / (time.perf_counter() - t0 - ttft)
        say(f"  (d) image + text embeds {emb_ms:.1f} ms ({L} positions), "
            f"prefill {ttft * 1e3:.1f} ms, decode {rate:.1f} tok/s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, on "
            f"{card_line()}")
        sh = Shadows()
        embeds = mm.embed_items(mitems)          # the tower, shadowed
        text = mm.text
        caches = text.fresh_cache(1)
        Sb = min(b for b in text.prompt_buckets if b >= L)
        pad = torch.zeros((1, Sb, embeds.shape[2]), dtype=embeds.dtype,
                          device=CARD)
        pad[:, :L] = embeds
        lg = mm.prefill_embeds(pad, caches)[:, L - 1]
        steps, toks = [], []
        pos = torch.full((), L, dtype=torch.int64, device=CARD)
        for _ in range(LLAVA_NEW):
            steps.append(lg.float())
            toks.append(torch.argmax(lg, dim=-1))
            lg = text.step(toks[-1][:, None], pos, caches)[:, -1]
            pos = pos + 1
        seq = torch.cat([embeds, mm._wte()[torch.stack(toks[:-1], 1)]], 1)
        Sb = min(b for b in text.prompt_buckets if b >= seq.shape[1])
        pad = torch.zeros((1, Sb, seq.shape[2]), dtype=seq.dtype,
                          device=CARD)
        pad[:, :seq.shape[1]] = seq
        forced = mm.prefill_embeds(pad, text.fresh_cache(1))[
            0, L - 1:L - 1 + LLAVA_NEW].float()
    finally:
        sh.close("(d) llava", launches)
    got = ByteTokenizer().decode([int(t[0]) for t in toks])
    if got != ws_text:
        fail(f"(d) the WebSocket text {ws_text!r} is not the greedy decode "
             f"{got!r}")
    rows_within(np, torch.stack(steps, 1)[0].cpu().numpy(),
                forced.cpu().numpy(), 0.015 * math.sqrt(2),
                "(d) decode vs teacher-forced embeds prefill")
    shutil.rmtree(d, ignore_errors=True)


def phase16(torch, np, root: Path, bf16, results, full: bool = True) -> None:
    """Phase 16: DeepSeek-V2-Lite (MLA, MoE), flan-t5-base, RWKV-7 World
    1.5B and LLaVA-1.5-7B at published widths through the port's entry
    points. The default run (not `full`, since phase 20 came) leaves
    DeepSeek's naive build out, runs RWKV-7 at 2 of its 4 layers and
    (since phase 22 came) leaves T5 out."""
    say(f"phase 16: the rest of the text family at published widths; host "
        f"RSS {host_rss_gb():.1f} GB")
    for label, fn, args in (
            ("(a) DeepSeek-V2-Lite", phase16_deepseek, (bf16,)),
            ("(b) flan-t5-base", phase16_t5, (bf16,)),
            ("(c) RWKV-7 World 1.5B", phase16_rwkv, ()),
            ("(d) LLaVA-1.5-7B", phase16_llava, (bf16,))):
        if fn is phase16_t5 and not full:
            continue
        t0 = time.perf_counter()
        if fn in (phase16_deepseek, phase16_rwkv):
            fn(torch, np, root, *args, results, full)
        else:
            fn(torch, np, root, *args, results)
        free_memory(torch)
        say(f"  [{label}: {time.perf_counter() - t0:.1f} s]")


# ---------------------------------------------------------------------------
# phase 17: speech at published widths, seeded weights
# openai/whisper-large-v3 (config.json), at WHISPER_LAYERS + WHISPER_LAYERS
# layers, and the generation_config.json of an English transcription
# (start, <|en|>, <|transcribe|>, <|notimestamps|>)
WHISPER_LARGE_V3 = dict(
    model_type="whisper", d_model=1280, encoder_layers=32,
    decoder_layers=32, encoder_attention_heads=20,
    decoder_attention_heads=20, encoder_ffn_dim=5120, decoder_ffn_dim=5120,
    num_mel_bins=128, vocab_size=51866, max_source_positions=1500,
    max_target_positions=448, decoder_start_token_id=50258,
    eos_token_id=50257, pad_token_id=50256)
WHISPER_GENERATION = {"decoder_start_token_id": 50258, "eos_token_id": 50257,
                      "forced_decoder_ids": [[1, 50259], [2, 50360],
                                             [3, 50364]]}
# encoder and decoder layers each: the published 32 under --speech-only,
# 4 in the default run, which must stay inside its time limit (the smoke
# took 1,005 s after phase 2 with 32 on an H100 at 700 W: PERF.md, phase 17)
WHISPER_LAYERS, WHISPER_LAYERS_DEFAULT_RUN = 32, 4
STT_NEW = 24              # tokens a transcription request decodes
SPEECH_CASES = ("LSTM", "GRU", "RNN", "DFT", "STFT")


def whisper_shapes(c: dict) -> dict:
    E, F, V = c["d_model"], c["encoder_ffn_dim"], c["vocab_size"]
    s = {"model.encoder.conv1.weight": (E, c["num_mel_bins"], 3),
         "model.encoder.conv1.bias": (E,),
         "model.encoder.conv2.weight": (E, E, 3),
         "model.encoder.conv2.bias": (E,),
         "model.encoder.embed_positions.weight":
             (c["max_source_positions"], E),
         "model.encoder.layer_norm.weight": (E,),
         "model.encoder.layer_norm.bias": (E,),
         "model.decoder.embed_tokens.weight": (V, E),
         "model.decoder.embed_positions.weight":
             (c["max_target_positions"], E),
         "model.decoder.layer_norm.weight": (E,),
         "model.decoder.layer_norm.bias": (E,)}

    def attn(p):
        for n in ("q", "k", "v", "out"):
            s[f"{p}.{n}_proj.weight"] = (E, E)
            if n != "k":
                s[f"{p}.{n}_proj.bias"] = (E,)

    for part, n in (("encoder", c["encoder_layers"]),
                    ("decoder", c["decoder_layers"])):
        for i in range(n):
            p = f"model.{part}.layers.{i}."
            norms = ["self_attn_layer_norm", "final_layer_norm"]
            attn(p + "self_attn")
            if part == "decoder":
                attn(p + "encoder_attn")
                norms.append("encoder_attn_layer_norm")
            for nm in norms:
                s[f"{p}{nm}.weight"] = (E,)
                s[f"{p}{nm}.bias"] = (E,)
            s.update({p + "fc1.weight": (F, E), p + "fc1.bias": (F,),
                      p + "fc2.weight": (E, F), p + "fc2.bias": (E,)})
    return s


def whisper_tensors(shapes: dict, seed: int, np, out_vocab: int):
    """tiled_tensors, but the tied head's rows from `out_vocab` on are
    each the mean of 4 seeded distinct rows of the ASCII bytes' ids
    (3 to `out_vocab` - 1): inside their hull, no logit there passes the
    bytes' largest (up to rounding; argmax takes the lower id of a tie),
    so greedy tokens are bytes. The decoder's position table is scaled
    30x, so that the hidden state moves with the position and the tokens
    vary: at 1x the layers' drift (each GELU's mean through its fc2)
    holds every step on one token."""
    for n, a in tiled_tensors(shapes, seed, np):
        if n == "model.decoder.embed_tokens.weight":
            rng = np.random.default_rng(seed + 1)
            nb = out_vocab - 3
            pick = 3 + np.argsort(rng.random((a.shape[0] - out_vocab, nb)),
                                  axis=1)[:, :4]
            mix = np.zeros((a.shape[0] - out_vocab, a.shape[1]), np.float32)
            for k in range(4):
                mix += a[pick[:, k]]
            a[out_vocab:] = mix / 4
        elif n == "model.decoder.embed_positions.weight":
            a = a * 30.0
        yield n, a


WHISPER_OUT_VOCAB = 3 + 128       # the byte tokenizer's ASCII ids


def write_whisper(np, d: Path, layers: int, bf16, label: str) -> None:
    """whisper-large-v3's widths at `layers` + `layers` layers, seeded
    (whisper_tensors), written to `d` (made anew) with its generation
    config."""
    c = dict(WHISPER_LARGE_V3, encoder_layers=layers, decoder_layers=layers)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shapes = whisper_shapes(c)
    t0 = time.perf_counter()
    (d / "config.json").write_text(json.dumps(c))
    nbytes = write_safetensors(d, shapes, whisper_tensors(
        shapes, SEED + 171, np, WHISPER_OUT_VOCAB), np, bf16)
    (d / "generation_config.json").write_text(json.dumps(WHISPER_GENERATION))
    n_par = sum(math.prod(s) for s in shapes.values())
    say(f"  {label} wrote whisper-large-v3 widths at {layers} + {layers} "
        f"layers ({n_par / 1e9:.3f} B parameters, {nbytes / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")


def speech_clip(np, seconds: float, seed: int):
    """A seeded synthetic utterance at 16 kHz: a few harmonics under a
    slow syllable envelope, over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.3 * t)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t) ** 2
    s = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000.0) / k
            for k in (1, 2, 3))
    return (0.2 * env * s + 0.01 * rng.standard_normal(t.size)).astype(
        np.float32)


def multipart_wav(wav: bytes, fields: dict):
    bound = "chip-smoke-boundary"
    out = b""
    for k, v in fields.items():
        out += (f"--{bound}\r\nContent-Disposition: form-data; "
                f'name="{k}"\r\n\r\n{v}\r\n').encode()
    out += (f"--{bound}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"clip.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
            ).encode() + wav + f"\r\n--{bound}--\r\n".encode()
    return out, f"multipart/form-data; boundary={bound}"


def post_raw(port: int, path: str, body: bytes, ctype: str):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        c.request("POST", path, body=body, headers={"Content-Type": ctype})
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def whisper_steps(torch, iface, mel):
    """The device loop's greedy decode (as _transcribe_compiled runs it,
    without stopping) with each step's logits: (tokens, (n, V) f32)."""
    dec = iface.dec
    enc = iface.encode(mel)
    cross_in = [n for n in dec.milli.inputs if n.startswith("cross_")]
    caches = dec.fresh_cache(1)

    def step(ids, pos):
        f = dec._feeds(ids, pos, caches)
        f.update({n: enc[n] for n in cross_in})
        return dec._exec(f)["logits"]

    P = len(iface.sot_sequence)
    lg = step(torch.tensor([iface.sot_sequence], device=CARD),
              torch.zeros((), dtype=torch.int64, device=CARD))[0, P - 1]
    pos = torch.full((), P, dtype=torch.int64, device=CARD)
    toks, logits = [], []
    for _ in range(STT_NEW):
        logits.append(lg.float())
        toks.append(torch.argmax(lg))
        lg = step(toks[-1].view(1, 1), pos)[0, -1]
        pos = pos + 1
    return ([int(t) for t in torch.stack(toks).cpu()],
            torch.stack(logits).cpu().numpy())


def whisper_forced(torch, iface, mel, toks):
    """One teacher-forced decoder pass over the start sequence and the
    tokens (the last one's successor not needed): the logits that pick
    each token, (n, V) f32."""
    dec = iface.dec
    enc = iface.encode(mel)
    seq = torch.tensor([iface.sot_sequence + toks[:-1]], device=CARD)
    f = dec._feeds(seq, torch.zeros((), dtype=torch.int64, device=CARD),
                   dec.fresh_cache(1))
    f.update({n: enc[n] for n in enc if n.startswith("cross_")})
    P = len(iface.sot_sequence)
    return dec._exec(f)["logits"][0, P - 1:].float().cpu().numpy()


def phase17_whisper(torch, np, root: Path, bf16, layers: int,
                    results) -> None:
    """(a) Whisper at whisper-large-v3's widths and `layers` + `layers`
    layers (module docstring)."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.milli import transforms
    from whisper_tensor_tpu_torch.milli.ops.attention import (
        kernel_attention_disabled)
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.super_graph.links import AudioClip
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer
    from whisper_tensor_tpu_torch.utils.audio import wav_bytes

    d = root / "whisper-large-v3"
    out_vocab = WHISPER_OUT_VOCAB
    write_whisper(np, d, layers, bf16, "(a)")
    clip30, clip75, clip4 = (speech_clip(np, s, SEED + 172 + i)
                             for i, s in enumerate((30.0, 75.0, 4.0)))
    wav30 = wav_bytes(clip30, 16000)
    wav_path = d / "clip30.wav"
    wav_path.write_bytes(wav30)
    # the route reads the WAV back at 16 bits: every path takes its samples
    from whisper_tensor_tpu_torch.utils.audio import read_wav_bytes

    s30, _ = read_wav_bytes(wav30)
    spy, qspy = RouteSpy(), quant_spy(transforms)
    stop = api = None
    try:
        srv = Server()
        t0 = time.perf_counter()
        (entry, _) = srv.models.run_loader("transformers", {
            "path": str(d), "dtype": "bf16", "max_len": 448})
        iface = srv._stt_iface(entry)
        iface.tokenizer = ByteTokenizer()
        iface.dec._weights()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        say(f"  (a) loaded in {load_s:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
            f"start sequence {iface.sot_sequence}")
        port, stop = ws_serve(srv)
        api = OpenAIApi(srv, "127.0.0.1", 0).start()
        b64 = base64.b64encode(s30.tobytes()).decode()

        def serve():
            body, ctype = multipart_wav(wav30, {"max_new_tokens": STT_NEW})
            status, _, data = post_raw(api.port, "/v1/audio/transcriptions",
                                       body, ctype)
            if status != 200:
                fail(f"(a) /v1/audio/transcriptions answered {status}: "
                     f"{data[:300]!r}")
            http_text = json.loads(data)["text"]
            ws = WSClient(port)
            texts = []
            for beam in (1, 4):
                reports, _ = sg_job(ws, {
                    "type": "transcribe", "model_id": entry.id,
                    "samples_b64": b64, "max_new_tokens": STT_NEW,
                    "beam": beam})
                texts.append(reports[-1]["result"]["text"])
            commits = []
            for off in range(0, len(clip4), 16000):
                ws.send({"type": "transcribe_stream", "model_id": entry.id,
                         "stream_id": "smoke", "max_new_tokens": 8,
                         "samples_b64": base64.b64encode(
                             clip4[off:off + 16000].tobytes()).decode()})
                commits += ws.until("transcribe_stream_update")["tokens"]
            ws.send({"type": "transcribe_stream", "model_id": entry.id,
                     "stream_id": "smoke", "final": True})
            r = ws.until("transcribe_stream_update")
            commits += r["tokens"]
            ws.close()
            long_toks = iface.transcribe_long(AudioClip(clip75, 16000),
                                              max_new_per_chunk=16)
            referee = iface._transcribe_mel(
                iface.mel_from_samples(s30), STT_NEW)
            return http_text, texts, commits, long_toks, referee

        (http_text, (greedy, beams), commits, long_toks, referee), \
            launches = counted(serve, spy, qspy,
                               "(a) whisper routes, stream, long, referee",
                               results, key="launches_phase17")
        attn = launches["Attention calls"]
        plain = attn - launches["flash-eligible calls"] - launches[
            "decode-eligible calls"]
        say(f"  (a) /v1/audio/transcriptions: {http_text[:40]!r}; beams of "
            f"4: {beams[:40]!r}; stream commits {len(commits)} tokens; "
            f"transcribe_long {len(long_toks)} tokens over 3 windows; "
            f"Attention calls {attn}, of them on the plain path {plain}")
        if greedy != http_text:
            fail("(a) the WebSocket greedy text is not the route's")
        if not launches["flash_attention"] or not launches["ragged_kv_write"]:
            fail("(a) flash_attention or ragged_kv_write never launched")
        if launches["decode_attention"] or launches["int8_matmul"]:
            fail("(a) decode_attention or int8_matmul launched")
        mel = iface.mel_from_samples(s30)
        toks = iface._transcribe_compiled(mel, STT_NEW)
        say(f"  (a) greedy tokens {toks} ({http_text!r})")
        if len(toks) != STT_NEW or max(toks) >= out_vocab \
                or len(set(toks)) < 2:
            fail(f"(a) the greedy tokens are not {STT_NEW} tokens below "
                 f"{out_vocab} of more than one id")
        if ByteTokenizer().decode(toks) != http_text:
            fail("(a) the device loop's text is not the route's")
    finally:
        if api is not None:
            api.stop()
        if stop is not None:
            stop()
        spy.restore()
        transforms.int8_matmul = qspy.inner
    # timing, then the decode and a teacher-forced pass on the kernels
    # against a teacher-forced pass on the plain path, every flash call
    # of a rerun shadowed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel = iface.mel_from_samples(s30)
    mel_ms = (time.perf_counter() - t0) * 1e3
    iface.encode(mel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = iface.encode(mel)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    dec = iface.dec
    cross = {n: enc[n] for n in enc if n.startswith("cross_")}
    sot = torch.tensor([iface.sot_sequence], device=CARD)
    zero = torch.zeros((), dtype=torch.int64, device=CARD)

    def prefill():
        f = dec._feeds(sot, zero, dec.fresh_cache(1))
        f.update(cross)
        return dec._exec(f)["logits"]

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    iface._transcribe_compiled(mel, STT_NEW)
    torch.cuda.synchronize()
    rate = STT_NEW / (time.perf_counter() - t0 - (enc_ms + pre_ms) / 1e3)
    say(f"  (a) mel {mel_ms:.1f} ms (host), encoder {enc_ms:.1f} ms "
        f"(1,500 positions), prefill {pre_ms:.1f} ms (4 tokens), decode "
        f"{rate:.1f} tok/s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
        f"the card, load {load_s:.1f} s, on {card_line()}")
    sh = Shadows()
    try:
        st_toks, st_logits = whisper_steps(torch, iface, mel)
        forced = whisper_forced(torch, iface, mel, st_toks)
        iface.transcribe_beam(AudioClip(s30, 16000), max_new=8, beam=4)
        iface._transcribe_mel(mel, 8)         # single-cache writes
    finally:
        sh.close("(a) whisper", launches)
    with kernel_attention_disabled(), PlainVersions():
        plain_forced = whisper_forced(torch, iface, mel, st_toks)
    if st_toks != toks:
        fail(f"(a) the stepped decode {st_toks} is not the loop's {toks}")
    # the referee's tokens equal the loop's up to the first near tie of
    # the plain path's logits (C10's rule)
    n = next((i for i, (a, b) in enumerate(zip(toks, referee)) if a != b),
             None)
    if n is None and len(referee) != len(toks):
        fail(f"(a) the referee's tokens {referee} are not the loop's")
    if n is not None:
        row = plain_forced[n]
        gap = float(np.diff(np.sort(row)[-2:])[0])
        say(f"  (a) the referee's tokens part from the loop's at step {n}: "
            f"top-2 gap {gap:.4g}, near-tie bound "
            f"{C10 * np.abs(row).max():.4g}")
        if not gap <= C10 * np.abs(row).max():
            fail(f"(a) the referee's tokens {referee} part from the "
                 f"loop's {toks} at step {n}, not at a near tie")
    else:
        say("  (a) the referee's tokens equal the loop's")
    rows_within(np, st_logits, plain_forced, C10,
                "(a) decode steps vs teacher-forced pass on the plain path")
    rows_within(np, forced, plain_forced, C10,
                "(a) teacher-forced pass on the kernels vs the plain path")
    # cli stt: its own load, the route's text
    spy, qspy = RouteSpy(), quant_spy(transforms)
    buf = io.StringIO()

    def run_cli():
        with contextlib.redirect_stdout(buf):
            cli.main(["stt", "--model", str(d), "--audio", str(wav_path),
                      "--max-tokens", str(STT_NEW), "-c", "dtype=bf16",
                      "--tokenizer", "bytes"])

    try:
        t0 = time.perf_counter()
        counted(run_cli, spy, qspy, "(a) cli stt", results,
                key="launches_phase17")
        say(f"  (a) cli stt: {time.perf_counter() - t0:.1f} s with the load")
    finally:
        spy.restore()
        transforms.int8_matmul = qspy.inner
    if buf.getvalue().rstrip("\n") != http_text:
        fail(f"(a) cli stt printed {buf.getvalue()[:80]!r}, not the route's "
             f"text {http_text[:80]!r}")
    shutil.rmtree(d, ignore_errors=True)


def phase17_tts(torch, np, root: Path, results) -> None:
    """(b) the synthetic TTS sets through /v1/audio/speech,
    generate_speech and cli tts, against the port on the CPU."""
    import contextlib
    import io
    import wave

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_tts_sets as sets
    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.tts import (F5Synthesizer,
                                                         TextToSpeechInterface)
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.super_graph.links import AudioClip
    from whisper_tensor_tpu_torch.utils.audio import read_wav, write_wav

    text = "tab up at a pub"
    ref = np.sin(np.linspace(0, 20, 400)).astype(np.float32)
    base = root / "tts"
    shutil.rmtree(base, ignore_errors=True)
    dirs = {}
    for name, write in (("piper", sets.write_piper_voice),
                        ("kokoro", sets.write_kokoro_dir),
                        ("f5", sets.write_f5_dir)):
        dirs[name] = base / name
        dirs[name].mkdir(parents=True)
        write(str(dirs[name]))
    ref_wav = base / "ref.wav"
    write_wav(str(ref_wav), ref, 24000)
    ref16, _ = read_wav(str(ref_wav))

    def cpu_samples(name, voice=0, ref_clip=None):
        iface = TextToSpeechInterface.from_bundle(
            identify_and_load(str(dirs[name])), device="cpu")
        if isinstance(iface, F5Synthesizer):
            return iface.run_text_to_audio(
                text, ref_audio=AudioClip(ref_clip, 24000)).samples
        return iface.run_text_to_audio(text, voice=voice).samples

    def pcm(data):
        """A 16-bit WAV's samples, as the writer's float samples."""
        with wave.open(io.BytesIO(data), "rb") as w:
            return np.frombuffer(w.readframes(w.getnframes()),
                                 "<i2").astype(np.float32) / 32767.0

    worst = 0.0

    def same(got, want, what, tol):
        nonlocal worst
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        if got.shape != want.shape:
            fail(f"(b) {what}: {got.shape} samples, the CPU's {want.shape}")
        err = float(np.abs(got - want).max()) if got.size else 0.0
        worst = max(worst, err if tol == 1e-5 else 0.0)
        if not err <= tol:
            fail(f"(b) {what}: |diff| {err:.3g} beyond {tol:g}")

    srv = Server()
    ids = {n: srv.models.run_loader("auto", {"path": str(dirs[n])})[0].id
           for n in ("piper", "kokoro")}
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    port, stop = ws_serve(srv)
    t0 = time.perf_counter()
    try:
        for name, voice in (("piper", 0), ("kokoro", "am_adam")):
            status, data = request(api.port, "/v1/audio/speech", {
                "input": text, "model": str(ids[name]), "voice": voice})
            if status != 200:
                fail(f"(b) /v1/audio/speech on {name} answered {status}")
            want = cpu_samples(name, 1 if voice == "am_adam" else 0)
            # the route sends 16-bit samples: one step of rounding
            same(pcm(data), want, f"/v1/audio/speech {name}", 1.01 / 32767)
            iface = srv._tts_iface(srv.models.get(ids[name]))
            same(iface.run_text_to_audio(
                text, voice=1 if voice == "am_adam" else 0).samples, want,
                f"{name} on the card", 1e-5)
        ws = WSClient(port)
        reports, _ = sg_job(ws, {"type": "generate_speech", "text": text,
                                 "model_id": ids["kokoro"], "voice": 1})
        ws.close()
        same(pcm(base64.b64decode(reports[-1]["result"]["wav_b64"])),
             cpu_samples("kokoro", 1), "generate_speech kokoro", 1.01 / 32767)
        f5 = TextToSpeechInterface.from_bundle(
            identify_and_load(str(dirs["f5"])))
        same(f5.run_text_to_audio(text, ref_audio=AudioClip(
            ref16, 24000)).samples, cpu_samples("f5", ref_clip=ref16),
             "F5 on the card", 1e-5)
        for name, extra in (("piper", []), ("kokoro", ["--voice", "am_adam"]),
                            ("f5", ["--ref-audio", str(ref_wav)])):
            out = base / f"{name}.wav"
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["tts", "--model", str(dirs[name]), "--text", text,
                          "--output", str(out)] + extra)
            same(pcm(out.read_bytes()),
                 cpu_samples(name, 1 if extra[:1] == ["--voice"] else 0,
                             ref16), f"cli tts {name}", 1.01 / 32767)
    finally:
        stop()
        api.stop()
    say(f"  (b) piper, kokoro and F5 through /v1/audio/speech, "
        f"generate_speech and cli tts in {time.perf_counter() - t0:.1f} s: "
        f"samples on the card within {worst:.3g} of the CPU's (bound 1e-5; "
        f"16-bit WAVs within one step)")
    shutil.rmtree(base, ignore_errors=True)


def phase17(torch, np, root: Path, bf16, results, layers: int,
            corpus: bool = False) -> None:
    """Phase 17: Whisper at whisper-large-v3's widths and `layers` +
    `layers` layers, and the TTS sets, through the port's entry points;
    with `corpus`, the recurrent and spectral corpus cases too."""
    say(f"phase 17: speech at published widths; host RSS "
        f"{host_rss_gb():.1f} GB")
    parts = [("(a) Whisper large-v3", phase17_whisper,
              (root, bf16, layers, results)),
             ("(b) TTS", phase17_tts, (root, results))]
    if corpus:
        parts.append(("(c) recurrent and spectral cases", phase11_corpus,
                      (SPEECH_CASES, 34)))
    for label, fn, args in parts:
        t0 = time.perf_counter()
        fn(torch, np, *args)
        free_memory(torch)
        say(f"  [{label}: {time.perf_counter() - t0:.1f} s]")


# phase 18: SDXL, SD3 and Flux at published widths, the LDM single file
# and the vision cases. Published configs: stabilityai/
# stable-diffusion-xl-base-1.0 (unet/, text_encoder/, text_encoder_2/,
# vae/ config.json), stabilityai/stable-diffusion-3-medium-diffusers
# (transformer/, text_encoder{,_2,_3}/, vae/), black-forest-labs/
# FLUX.1-dev (transformer/, text_encoder{,_2}/, vae/)
SDXL_UNET = {"block_out_channels": [320, 640, 1280], "layers_per_block": 2,
             "cross_attention_dim": 2048, "attention_head_dim": [5, 10, 20],
             "transformer_layers_per_block": [1, 2, 10],
             "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                  "CrossAttnDownBlock2D"],
             "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
             "projection_class_embeddings_input_dim": 2816,
             "norm_num_groups": 32, "sample_size": 128, "in_channels": 4,
             "out_channels": 4, "use_linear_projection": True}
CLIP_L = dict(SD15_CLIP, architectures=["CLIPTextModel"], projection_dim=768)
CLIP_L_PROJ = dict(CLIP_L, architectures=["CLIPTextModelWithProjection"])
CLIP_BIGG = {"num_hidden_layers": 32, "hidden_size": 1280,
             "num_attention_heads": 20, "intermediate_size": 5120,
             "vocab_size": 49408, "max_position_embeddings": 77,
             "hidden_act": "gelu", "projection_dim": 1280,
             "bos_token_id": 0, "eos_token_id": 2,
             "architectures": ["CLIPTextModelWithProjection"]}
SDXL_VAE = dict(SD15_VAE, scaling_factor=0.13025, sample_size=1024)
SD3_MMDIT = {"num_layers": 24, "num_attention_heads": 24,
             "attention_head_dim": 64, "caption_projection_dim": 1536,
             "in_channels": 16, "out_channels": 16, "patch_size": 2,
             "pos_embed_max_size": 192, "joint_attention_dim": 4096,
             "pooled_projection_dim": 2048, "sample_size": 128}
# google/t5-v1_1-xxl, the encoder SD3 and Flux ship (depth cut: T5_LAYERS)
T5_XXL = dict(model_type="t5", d_model=4096, d_kv=64, d_ff=10240,
              num_heads=64, num_layers=24, num_decoder_layers=0,
              vocab_size=32128, relative_attention_num_buckets=32,
              relative_attention_max_distance=128,
              feed_forward_proj="gated-gelu", layer_norm_epsilon=1e-6,
              architectures=["T5EncoderModel"])
LATENT16_VAE = dict(SD15_VAE, latent_channels=16, sample_size=1024)
SD3_VAE = dict(LATENT16_VAE, scaling_factor=1.5305, shift_factor=0.0609)
FLUX_VAE = dict(LATENT16_VAE, scaling_factor=0.3611, shift_factor=0.1159)
FLUX_DEV = {"num_layers": 19, "num_single_layers": 38,
            "num_attention_heads": 24, "attention_head_dim": 128,
            "in_channels": 64, "joint_attention_dim": 4096,
            "pooled_projection_dim": 768, "guidance_embeds": True,
            "axes_dims_rope": [16, 56, 56], "patch_size": 1}
T5_LAYERS = 2                 # of T5-XXL's 24 (the smoke's time)
FLUX_DEPTH = (2, 4)           # double and single blocks of FLUX.1-dev's 19 + 38
MEDIA_HW, MEDIA_STEPS = 1024, 4
MEDIA_PROMPT = SD_PROMPT
# the default run's cut: the published widths, one block or transformer
# layer a stage, 512 x 512, 2 steps (--media-only runs the above)
MEDIA_CUT_HW, MEDIA_CUT_STEPS = 512, 2
VISION_CASES = ("DeformConv", "GridSample", "AffineGrid", "RoiAlign",
                "Col2Im", "CenterCropPad", "NonMaxSuppression",
                "ImageDecoder")


def media_pipelines(full: bool) -> dict:
    """{kind: (model_index class, {sub: config.json}, run settings)} at
    the published widths; `full`: SDXL and SD3 at full depth (T5 at
    T5_LAYERS), Flux at FLUX_DEPTH, else one block or layer a stage."""
    def depth(cfg, key, n):
        return dict(cfg, **{key: cfg[key] if full else n})

    unet = dict(SDXL_UNET) if full else dict(
        SDXL_UNET, layers_per_block=1, transformer_layers_per_block=[1, 1, 1])
    vae_cut = {} if full else {"layers_per_block": 1}
    t5 = dict(T5_XXL, num_layers=T5_LAYERS if full else 1)
    hw = MEDIA_HW if full else MEDIA_CUT_HW
    steps = MEDIA_STEPS if full else MEDIA_CUT_STEPS
    flux = dict(FLUX_DEV, num_layers=FLUX_DEPTH[0] if full else 1,
                num_single_layers=FLUX_DEPTH[1] if full else 1)
    return {
        "sdxl": ("StableDiffusionXLPipeline", {
            "unet": unet,
            "text_encoder": depth(CLIP_L, "num_hidden_layers", 1),
            "text_encoder_2": depth(CLIP_BIGG, "num_hidden_layers", 1),
            "vae": dict(SDXL_VAE, **vae_cut)},
            dict(hw=hw, steps=steps, guidance=7.5, schedule="euler",
                 loader={"img2img": True})),
        "sd3": ("StableDiffusion3Pipeline", {
            "transformer": depth(SD3_MMDIT, "num_layers", 1),
            "text_encoder": depth(CLIP_L_PROJ, "num_hidden_layers", 1),
            "text_encoder_2": depth(CLIP_BIGG, "num_hidden_layers", 1),
            "text_encoder_3": t5, "vae": dict(SD3_VAE, **vae_cut)},
            dict(hw=hw, steps=steps, guidance=7.5, schedule="rectified_flow",
                 loader={"t5_seq_len": 256})),
        "flux": ("FluxPipeline", {
            "transformer": flux,
            "text_encoder": depth(CLIP_L, "num_hidden_layers", 1),
            "text_encoder_2": t5, "vae": dict(FLUX_VAE, **vae_cut)},
            dict(hw=hw, steps=steps, guidance=3.5, schedule="rectified_flow",
                 loader={"t5_seq_len": 512}))}


def component_shapes(np, sub: str, cfg: dict) -> dict:
    """The weight names and shapes a pipeline component's recipe asks
    its getter for."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import WeightStorage
    from whisper_tensor_tpu_torch.importers.recipes.diffusion import (
        flux, mmdit, unet, vae)

    if sub == "unet":
        return recipe_shapes(unet.build_sd_unet, np,
                             cfg=unet.UNetConfig.from_hf(cfg), batch=2,
                             latent_hw=(8, 8))
    if sub == "vae":
        v = vae.VAEConfig.from_hf(cfg)
        return {**recipe_shapes(vae.build_vae_decoder, np, cfg=v,
                                latent_hw=(8, 8)),
                **recipe_shapes(vae.build_vae_encoder, np, cfg=v,
                                image_hw=(64, 64))}
    if sub == "transformer":
        if "num_single_layers" in cfg:
            c, shape_of, build, kw = (flux.FluxConfig.from_hf(cfg),
                                      flux.flux_weight_shape, flux.build_flux,
                                      dict(batch=1, context_len=8,
                                           latent_hw=(16, 16)))
        else:
            c, shape_of, build, kw = (mmdit.SD3Config.from_hf(cfg),
                                      mmdit.sd3_weight_shape,
                                      mmdit.build_sd3_mmdit,
                                      dict(batch=2, context_len=8,
                                           latent_hw=(16, 16)))
        shapes = {}

        def getter(name):
            shapes[name] = tuple(shape_of(c, name))
            return np.broadcast_to(np.zeros((), np.float16), shapes[name])

        build(getter, c, dtype=DType.F16, storage=WeightStorage.to_sink({}),
              **kw)
        return shapes
    if cfg.get("model_type") == "t5":
        return {n: s for n, s in t5_shapes(cfg).items()
                if not n.startswith(("decoder.", "lm_head."))}
    shapes = clip_shapes(cfg)
    if "CLIPTextModelWithProjection" in cfg["architectures"]:
        shapes["text_projection.weight"] = (cfg["projection_dim"],
                                            cfg["hidden_size"])
    return shapes


def write_seeded(torch, d: Path, shapes: dict, seed: int) -> int:
    """d/model.safetensors: f16 weights by random_unet_weights' rule
    (norm weights 1, biases 0, the rest normal with std 1/sqrt(fan in)),
    drawn on the card. Returns the bytes written."""
    from safetensors.numpy import save_file

    gen = torch.Generator(device=CARD).manual_seed(seed)
    tensors, total = {}, 0
    for name, shape in shapes.items():
        if name.endswith(".bias") or ("norm" in name
                                      and name.endswith("weight")):
            t = torch.full(shape, float(name.endswith("weight")),
                           dtype=torch.float16)
        else:
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
            t = (torch.randn(shape, generator=gen, device=CARD)
                 / math.sqrt(max(fan_in, 1))).half().cpu()
        tensors[name] = t.numpy()
        total += t.numel() * 2
    save_file(tensors, str(d / "model.safetensors"))
    return total


def write_pipeline(torch, np, d: Path, cls: str, parts: dict,
                   seed: int) -> int:
    """A diffusers directory of seeded f16 weights at `parts`' configs."""
    total = 0
    for i, (sub, cfg) in enumerate(parts.items()):
        (d / sub).mkdir(parents=True)
        (d / sub / "config.json").write_text(json.dumps(cfg))
        total += write_seeded(torch, d / sub,
                              component_shapes(np, sub, cfg), seed + i)
    (d / "scheduler").mkdir()
    (d / "scheduler" / "scheduler_config.json").write_text(
        json.dumps({"prediction_type": "epsilon"}))
    (d / "model_index.json").write_text(json.dumps({"_class_name": cls}))
    return total


class MediaSpy(SdSpy):
    """SdSpy's counts (the Attention calls on the card, those flash_mode
    sends to flash_attention), with each other call named by why it runs
    the plain path: a head dim past the kernel's (the VAE's one head of
    512, B6) or a per-head additive bias (T5's relative positions)."""

    def __init__(self, torch):
        from whisper_tensor_tpu_torch.milli.ops.attention import flash_mode

        super().__init__(torch)
        self.plain = {}
        counted = self.table["Attention"]          # SdSpy's counting wrapper

        def wrapped(op, ins, static, device):
            if device.type == "cuda":
                m = ins[3] if len(ins) > 3 else None
                if flash_mode(op, ins[0], ins[1], ins[2], m,
                              op.n_out >= 4) is None:
                    D = ins[0].shape[-1]
                    why = (f"head dim {D} (one head: the VAE, B6)"
                           if D > 256 else
                           "a per-head bias (T5)" if m is not None
                           and m.dim() == 4 and m.shape[1] > 1 else
                           f"other (D {D}, mask "
                           f"{None if m is None else tuple(m.shape)})")
                    self.plain[why] = self.plain.get(why, 0) + 1
            return counted(op, ins, static, device)

        self.table["Attention"] = wrapped

    def zero(self):
        super().zero()
        self.plain = {}


def denoiser_feeds(torch, iface, kind: str, cfg) -> dict:
    """One denoise step's feeds, built as the interface builds them."""
    h8, w8 = cfg.height // 8, cfg.width // 8
    gen = torch.Generator(device=CARD).manual_seed(SEED + 18)
    if kind == "flux":
        ctx, pooled = iface._encode(MEDIA_PROMPT)
        return {"hidden_states": torch.randn(1, iface.latent_channels, h8, w8,
                                             device=CARD, generator=gen),
                "timestep": torch.ones(1, device=CARD),
                "pooled_projections": pooled, "encoder_hidden_states": ctx,
                "guidance": torch.full((1,), cfg.guidance_scale,
                                       device=CARD)}
    ctx, extra = iface._encode_cfg(MEDIA_PROMPT, "", cfg)
    sample = torch.randn(2, iface.latent_channels, h8, w8, device=CARD,
                         generator=gen)
    return iface._unet_feeds(sample, torch.tensor(500.0, device=CARD), ctx,
                             extra)


def phase18_pipeline(torch, np, root: Path, kind: str, full: bool,
                     spy) -> dict:
    """(a) SDXL, (b) SD3 or (c) Flux: the seeded directory through the
    port's Server, /v1/images/generations counted, the interface's image
    for the same seed, one denoise step timed and shadowed, the VAE
    decode timed; SDXL's img2img and `cli image` too."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain)
    from whisper_tensor_tpu_torch.interfaces.image_gen import ImageGenConfig
    from whisper_tensor_tpu_torch.milli.ops import attention as att_lowering
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi

    cls, parts, run = media_pipelines(full)[kind]
    hw, steps = run["hw"], run["steps"]
    card = card_line()
    d = root / f"media-{kind}"
    shutil.rmtree(d, ignore_errors=True)
    api, out = None, {}
    try:
        t0 = time.perf_counter()
        nbytes = write_pipeline(torch, np, d, cls, parts,
                                SEED + 18 * 10 + len(kind))
        write_s = time.perf_counter() - t0
        srv = Server(device=CARD)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        entries = srv.models.run_loader("diffusers", {
            "path": str(d), "dtype": "bf16", "height": hw, "width": hw,
            **run["loader"]})
        load_s = time.perf_counter() - t0
        api = OpenAIApi(srv, "127.0.0.1", 0).start()
        body = {"prompt": MEDIA_PROMPT, "steps": steps,
                "guidance_scale": run["guidance"], "seed": 0}
        # the main path, counted: every kernel counter 0 just before
        kernels = family_kernels()
        for fn in kernels.values():
            fn.launches = 0
        spy.zero()
        t0 = time.perf_counter()
        status, data = request(api.port, "/v1/images/generations", body)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = {n: fn.launches for n, fn in kernels.items()}
        launches, eligible, calls, plain = (launched.pop("flash_attention"),
                                            spy.eligible, spy.calls,
                                            dict(spy.plain))
        route_gb = torch.cuda.max_memory_allocated() / 1e9
        if any(launched.values()):
            fail(f"({kind}) kernels off the image path launched: {launched}")
        if status != 200:
            fail(f"({kind}) /v1/images/generations answered {status}: "
                 f"{data[:500]}")
        px = png_image(np, base64.b64decode(json.loads(data)["data"][0][
            "b64_json"]), (hw, hw, 3))
        if launches != eligible or launches == 0:
            fail(f"({kind}) flash_attention launches {launches} != the "
                 f"lowering's {eligible} eligible Attention calls")
        if any(w.startswith("other") for w in plain):
            fail(f"({kind}) Attention calls on the plain path outside the "
                 f"kernel's domain rule: {plain}")
        iface = srv._image_iface(srv.models.get(entries[0].id))
        cfg = ImageGenConfig(steps=steps, guidance_scale=run["guidance"],
                             height=hw, width=hw, schedule=run["schedule"],
                             seed=0)
        t0 = time.perf_counter()
        img = iface.run(MEDIA_PROMPT, cfg=cfg)
        torch.cuda.synchronize()
        image_s = time.perf_counter() - t0
        if not np.array_equal(img.pixels, px):
            fail(f"({kind}) the route's image differs from the interface's "
                 f"for the same seed")
        # one denoise step: timed, then every flash call of it shadowed
        feeds = denoiser_feeds(torch, iface, kind, cfg)
        step_ms = statistics.median(_timed(lambda: (
            iface._run(iface.unet, feeds), torch.cuda.synchronize()), 3))
        shadow = flash_shadow(att_lowering, flash_attention_plain,
                              flash_agreement_bound)
        try:
            got = iface._run(iface.unet, feeds)["out"]
            torch.cuda.synchronize()
        finally:
            att_lowering.flash_attention = shadow.inner
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"({kind}) a denoise step's output is not finite")
        if shadow.calls == 0 or not shadow.worst <= 1.0:
            fail(f"({kind}) a denoise step's flash calls against their "
                 f"plain version: {shadow.calls} calls, worst "
                 f"{shadow.worst}")
        lat = feeds["hidden_states" if kind != "sdxl" else "sample"][:1]
        vae_ms = statistics.median(_timed(lambda: (
            iface._run(iface.vae, {"latents": lat}),
            torch.cuda.synchronize()), 3))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out = {"launches": launches, "eligible": eligible, "calls": calls,
               "plain": plain, "shadow_calls": shadow.calls,
               "shadow_worst": shadow.worst, "load_s": load_s,
               "step_ms": step_ms, "image_s": image_s, "vae_ms": vae_ms,
               "route_gb": route_gb, "peak_gb": peak_gb}
        say(f"  ({kind}) {cls} at {hw} x {hw}, {steps} {run['schedule']} "
            f"steps, guidance {run['guidance']}: wrote {nbytes / 1e9:.2f} GB "
            f"in {write_s:.1f} s, loaded in {load_s:.1f} s; the first "
            f"request {first_s:.1f} s; flash_attention launched {launches} "
            f"times for {eligible} eligible of {calls} Attention calls on the"
            f" card; plain-path calls {plain or 'none'}; the route's PNG "
            f"equals the interface's image (pixel std {px.std():.2f}); "
            f"{image_s:.2f} s an image (warm); a denoise step "
            f"{step_ms:.2f} ms, its {shadow.calls} flash calls shadowed "
            f"(worst {shadow.worst:.3g} of flash_agreement_bound, max |err| "
            f"{shadow.max_err:.4g}); VAE decode {vae_ms:.2f} ms; peak "
            f"{route_gb:.2f} GB on the card through the load and the first "
            f"request, {peak_gb:.2f} GB with the shadowed step's plain "
            f"versions ({card})")
        if kind == "sdxl":
            shadow = flash_shadow(att_lowering, flash_attention_plain,
                                  flash_agreement_bound)
            try:
                a = iface.run_img2img(MEDIA_PROMPT, px, strength=0.5,
                                      cfg=cfg)
            finally:
                att_lowering.flash_attention = shadow.inner
            if a.pixels.shape != (hw, hw, 3) or not a.pixels.std() > 0:
                fail(f"(sdxl) img2img image {a.pixels.shape}, std "
                     f"{a.pixels.std()}")
            if not shadow.worst <= 1.0:
                fail(f"(sdxl) img2img's flash calls: worst {shadow.worst}")
            say(f"  (sdxl) img2img at strength 0.5: {shadow.calls} flash "
                f"calls shadowed (worst {shadow.worst:.3g})")
        api.stop()
        api = None
        del iface, srv, entries, feeds, got, lat, img
        free_memory(torch)
        if kind == "sdxl":
            png = root / "media-sdxl-cli.png"
            n0 = flash_attention.launches
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["image", "--model", str(d), "--prompt",
                          MEDIA_PROMPT, "--steps", str(steps), "--height",
                          str(hw), "--width", str(hw), "--output", str(png),
                          "-c", "dtype=bf16", "--device", CARD])
            cli_px = png_image(np, png.read_bytes(), (hw, hw, 3))
            png.unlink()
            if flash_attention.launches == n0:
                fail("(sdxl) cli image launched no flash_attention")
            if not np.array_equal(cli_px, px):
                fail("(sdxl) cli image's image differs from the route's")
            say(f"  (sdxl) cli image: {time.perf_counter() - t0:.1f} s (its "
                f"own load), {flash_attention.launches - n0} flash launches, "
                f"the route's image")
    finally:
        if api is not None:
            api.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


def write_ldm_file(np, sd15: Path, path: Path) -> None:
    """SD-1.5's diffusers weights (phase 13's directory) renamed into one
    CompVis-layout file by the port's own maps (importers/ldm.py): the
    UNet, the VAE (its attention as 1x1 convs, as LDM stores them) and
    CLIP."""
    from safetensors.numpy import load_file, save_file

    from whisper_tensor_tpu_torch.importers import ldm
    from whisper_tensor_tpu_torch.importers.recipes.diffusion import unet

    ucfg = unet.UNetConfig.from_hf(SD15_UNET)
    sd = {}
    for n, a in load_file(str(sd15 / "unet" / "model.safetensors")).items():
        sd[ldm.UNET_PREFIX + ldm.unet_diffusers_to_ldm(
            n, ucfg.layers_per_block, ucfg.down_has_attn)] = a
    nb = len(SD15_VAE["block_out_channels"])
    for n, a in load_file(str(sd15 / "vae" / "model.safetensors")).items():
        key = (ldm.vae_encoder_diffusers_to_ldm(n)
               if n.startswith(("encoder.", "quant_conv"))
               else ldm.vae_decoder_diffusers_to_ldm(n, nb))
        if "attentions" in n and n.endswith(".weight") and a.ndim == 2:
            a = a[:, :, None, None]
        sd[ldm.VAE_PREFIX + key] = a
    for n, a in load_file(str(sd15 / "text_encoder" /
                               "model.safetensors")).items():
        sd[ldm.CLIP_PREFIX + n] = a
    save_file(sd, str(path))


def phase18_ldm(torch, np, root: Path) -> None:
    """(d) SD-1.5's seeded weights as one LDM file through `cli image`
    (512 x 512, 2 steps): its image equals, bit for bit, the image of
    the same weights loaded as a diffusers directory."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import \
        flash_attention

    sd15 = root / "sd15"
    kept = root / "sd15-ref.png"       # phase 13's image of the directory
    path = root / "sd15-ldm.safetensors"
    try:
        if not (sd15 / "model_index.json").exists():
            # --media-only: phase 13 kept no directory
            shutil.rmtree(sd15, ignore_errors=True)
            kept.unlink(missing_ok=True)
            write_sd15(torch, np, sd15)
        t0 = time.perf_counter()
        write_ldm_file(np, sd15, path)
        conv_s = time.perf_counter() - t0
        pngs, secs = {}, {"diffusers": None}
        if kept.exists():
            pngs["diffusers"] = kept.read_bytes()
        n0 = flash_attention.launches
        for label, model in (("ldm", path), ("diffusers", sd15)):
            if label in pngs:
                continue
            out = root / f"sd15-{label}.png"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["image", "--model", str(model), "--prompt",
                          SD_PROMPT, "--steps", str(LDM_STEPS), "--height",
                          str(SD_HW), "--width", str(SD_HW), "--output",
                          str(out), "-c", "dtype=bf16", "--device", CARD])
            secs[label] = time.perf_counter() - t0
            pngs[label] = out.read_bytes()
            out.unlink()
        px = png_image(np, pngs["ldm"], (SD_HW, SD_HW, 3))
        if pngs["ldm"] != pngs["diffusers"]:
            fail("(d) the LDM file's image differs from the diffusers "
                 "directory's")
        if flash_attention.launches == n0:
            fail("(d) cli image launched no flash_attention")
        ref = ("phase 13's" if secs["diffusers"] is None
               else f"{secs['diffusers']:.1f} s")
        say(f"  (d) SD-1.5 as one LDM file ({path.stat().st_size / 1e9:.2f} "
            f"GB, renamed in {conv_s:.1f} s): cli image {secs['ldm']:.1f} s, "
            f"the diffusers directory's ({ref}); the PNGs are equal byte "
            f"for byte (pixel std {px.std():.2f})")
    finally:
        path.unlink(missing_ok=True)
        kept.unlink(missing_ok=True)
        shutil.rmtree(sd15, ignore_errors=True)


def phase18_vision(torch, np) -> None:
    """(e) the 66 vision corpus cases on the card (phase 11 (a)'s run
    of tests/torch_corpus.npz for these op types)."""
    phase11_corpus(torch, np, VISION_CASES, 66)


def phase18(torch, np, root: Path, results, full: bool) -> None:
    """Phase 18: SDXL, SD3 and Flux (`full`: at --media-only's depth and
    size, else the default run's cut), the LDM single file and, with
    `full`, the vision corpus cases."""
    say(f"phase 18: SDXL, SD3 and Flux at published widths "
        f"({'full' if full else 'the default run cut'}); host RSS "
        f"{host_rss_gb():.1f} GB")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the precision contract wants f32 convolutions and "
             "matmuls at full precision (device.py)")
    spy = MediaSpy(torch)
    seen = {}
    try:
        t_all = time.perf_counter()
        for label, kind in (("(a)", "sdxl"), ("(b)", "sd3"),
                            ("(c)", "flux")):
            t0 = time.perf_counter()
            seen[kind] = phase18_pipeline(torch, np, root, kind, full, spy)
            free_memory(torch)
            say(f"  [{label} {kind}: {time.perf_counter() - t0:.1f} s]")
        say(f"  [(a)-(c): {time.perf_counter() - t_all:.1f} s]")
    finally:
        spy.restore()
    entry = next(r for r in results if r["name"] == "flash_attention")
    entry["launches_phase18"] = {k: v["launches"] for k, v in seen.items()}
    entry["shadow_phase18"] = {k: v["shadow_worst"] for k, v in seen.items()}
    t0 = time.perf_counter()
    phase18_ldm(torch, np, root)
    say(f"  [(d) LDM: {time.perf_counter() - t0:.1f} s]")
    if full:
        t0 = time.perf_counter()
        phase18_vision(torch, np)
        say(f"  [(e) vision cases: {time.perf_counter() - t0:.1f} s]")


# ---------------------------------------------------------------------------
# phase 19: parallelism (parallel/: the mesh over torch.distributed)
PAR_NEW = 16
PAR_TP = 2
PAR_TIMEOUT_S = 900


def par_prompts(np, full: bool) -> dict:
    """Phase 19's prompts as byte-tokenizer ids: 24 tokens, and with
    `full` phase 5's 1,900-token prompt."""
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    out = {"24-token": long_text(np, 24, SEED + 19)}
    if full:
        out["1,900-token"] = long_text(np, 1900, SEED + 5)
    return {k: np.asarray(tok.encode(v), np.int64) for k, v in out.items()}


def forced_rows(torch, np, iface, ids, toks):
    """The f32 logits of a prefill over prompt + answer[:-1] (one row,
    its bucket) at the rows that predict each answer token."""
    padded, _ = iface._prompt(np.concatenate([ids, toks[:-1]])[None])
    logits = iface.step(padded, torch.zeros((), dtype=torch.int64,
                                            device=iface.device),
                        iface.fresh_cache(1))
    P = len(ids)
    return logits[0, P - 1:P - 1 + len(toks)].float().cpu().numpy()


def par_reference(torch, np, iface, prompts) -> dict:
    """{prompt: (greedy tokens, teacher-forced logits)} of the single-rank
    port."""
    out = {}
    for name, ids in prompts.items():
        toks = iface.generate_tokens(ids[None], PAR_NEW)[0]
        out[name] = (toks, forced_rows(torch, np, iface, ids, toks))
    return out


def par_load(torch, ckpt: Path, quantize: str, mesh=None, device=None):
    """Phase 3's checkpoint through the port's loader into a
    TextInferenceInterface (bf16, a bf16 cache, max_len 2048, `quantize`;
    over `mesh` with LLAMA_RULES), weights uploaded; (interface, s)."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import identify_and_load
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.parallel.mesh import LLAMA_RULES

    t0 = time.perf_counter()
    b = identify_and_load(str(ckpt), dtype="bf16", max_len=MAX_LEN)
    text = b.interfaces["text"]
    iface = TextInferenceInterface(
        b.models[text["model"]], MAX_LEN, cache_dtype=DType.BF16,
        eos_token_id=text.get("eos_token_id"), quantize=quantize, mesh=mesh,
        shard_rules=None if mesh is None else LLAMA_RULES, device=device)
    iface._weights()
    if iface.device.type == "cuda":
        torch.cuda.synchronize()
    return iface, time.perf_counter() - t0


def par_child(rank, n, store, backend, device, task, args, outq):
    """A rank of one of phase 19's spawned worlds: joins it and puts
    (rank, True, task's result) or (rank, False, the traceback) on outq."""
    import traceback

    sys.path.insert(0, str(ROOT))
    try:
        import datetime

        import numpy as np
        import torch
        import torch.distributed as dist

        from whisper_tensor_tpu_torch.parallel.mesh import distributed_init

        distributed_init(f"file://{store}", n, rank, backend=backend,
                         device=device, timeout=datetime.timedelta(
                             seconds=PAR_TIMEOUT_S // 2))
        try:
            outq.put((rank, True, task(torch, np, rank, n, device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:       # the parent fails the phase with it
        outq.put((rank, False, traceback.format_exc()))


def par_start(n: int, backend: str, device, task, *args) -> tuple:
    """Start task(torch, np, rank, n, device, *args) on every rank of a
    new world of n spawned processes (sharing the card); par_collect
    waits for it."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    procs = [ctx.Process(target=par_child, daemon=True, args=(
        r, n, str(tmp / "store"), backend, device, task, args, outq))
        for r in range(n)]
    for p in procs:
        p.start()
    return task, procs, outq, tmp


def par_collect(world: tuple) -> list:
    """The ranks' results of a par_start world, in rank order. A rank
    that fails, or does not answer, fails the phase; every process is
    stopped before this returns."""
    import queue

    task, procs, outq, tmp = world
    n = len(procs)
    got = {}
    deadline = time.perf_counter() + PAR_TIMEOUT_S
    try:
        while len(got) < n:
            try:
                rank, ok, res = outq.get(timeout=5)
                got[rank] = (ok, res)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            try:        # a rank that answered and ended: its answer waits
                while dead:
                    rank, ok, res = outq.get(timeout=2)
                    got[rank] = (ok, res)
            except queue.Empty:
                pass
            dead = [r for r in dead if r not in got]
            if dead or time.perf_counter() > deadline:
                fail(f"{task.__name__}: ranks {sorted(got)} of {n} answered; "
                     f"ranks {dead} ended without an answer (exit codes "
                     f"{[procs[r].exitcode for r in dead]})")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [f"rank {r}:\n{res}" for r, (ok, res) in sorted(got.items())
           if not ok]
    if bad:
        say("\n".join(bad))
        fail(f"{task.__name__} failed on a rank of {n}")
    return [got[r][1] for r in range(n)]


def par_kernels():
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)

    return {**family_kernels(), "packed_matmul": packed_matmul}


def par_serve(torch, np, mesh, ckpt: Path, quantize: str, prompts,
              ref_toks: dict) -> dict:
    """(a) on one rank: the checkpoint at tp over the mesh; each prompt's
    time to first token and greedy decode with every kernel counter 0
    before and read after, beside the lowering's eligible calls; a rerun
    with every kernel call held against its plain version; the logits
    teacher-forced on the single rank's answer (`ref_toks`)."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.milli import transforms

    iface, load_s = par_load(torch, ckpt, quantize, mesh)
    cuda = iface.device.type == "cuda"
    say(f"  [rank {mesh.rank}: {quantize} loaded in {load_s:.1f} s]")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {"load_s": load_s, "fallbacks": list(iface._tp.fallbacks),
           "card_gb": torch.cuda.memory_allocated() / 1e9 if cuda else 0.0,
           "shapes": {n: tuple(t.shape) for n, t in iface._weights().items()
                      if n in ("wq_0", "wo_0", "embed_tokens", "lm_head")},
           "cache": tuple(iface.fresh_cache(1)[0].shape), "runs": {}}
    kernels = par_kernels()
    spy, qspy, pspy = RouteSpy(), quant_spy(transforms), packed_spy(
        transforms)
    try:
        for fn in kernels.values():
            fn.launches = 0
        spy.zero()
        qspy.calls = qspy.launched = pspy.calls = 0
        for name, ids in prompts.items():
            iface.generate_tokens(ids[None], 2)   # the plans of both steps
            sync()
            t0 = time.perf_counter()
            iface.generate_tokens(ids[None], 1)
            ttft = time.perf_counter() - t0
            c0, k0 = mesh.comm_seconds, mesh.comm_calls
            t0 = time.perf_counter()
            toks = iface.generate_tokens(ids[None], PAR_NEW)[0]
            total = time.perf_counter() - t0
            say(f"  [rank {mesh.rank}: {quantize}, the {name} prompt "
                f"decoded]")
            out["runs"][name] = {
                "tokens": toks, "ttft_ms": ttft * 1e3,
                "tok_s": (PAR_NEW - 1) / max(total - ttft, 1e-9),
                "comm_ms_step": (mesh.comm_seconds - c0) * 1e3 / PAR_NEW,
                "comm_calls_step": (mesh.comm_calls - k0) / PAR_NEW}
        launches = {n: fn.launches for n, fn in kernels.items()}
        launches.update(spy.snapshot(), **{
            "QuantMatMul calls": qspy.calls, "PackedMatMul calls":
            pspy.calls})
    finally:
        spy.restore()
        transforms.int8_matmul = qspy.inner
        transforms.packed_matmul = pspy.inner
    out["launches"] = launches
    out["packed_shadow"] = (0, 0.0, 0.0)
    if cuda:        # (a CPU rehearsal launches no kernel to hold)
        sh = Shadows()
        psh = packed_shadow(torch, transforms, agreement_bound)
        try:
            for name, ids in prompts.items():
                iface.generate_tokens(ids[None], 1)
                iface.generate_tokens(ids[None], PAR_NEW)
        finally:
            transforms.packed_matmul = psh.inner
            sh.close(f"(a) {quantize} rank {mesh.rank}", launches)
        out["packed_shadow"] = (psh.calls, psh.worst, psh.max_err)
        if (psh.calls > 0) != (launches["packed_matmul"] > 0) \
                or not psh.worst <= 1.0:
            raise RuntimeError(f"packed_matmul's rerun calls ({psh.calls}) "
                               f"against the plain version: worst "
                               f"{psh.worst:.4g} of the bound")
    for name, ids in prompts.items():
        out["runs"][name]["forced"] = forced_rows(torch, np, iface, ids,
                                                  ref_toks[name])
    del iface
    free_memory(torch)
    return out


GLOO_CASE = r"""
import sys, torch, torch.distributed as dist
rank, store, op, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, world_size=2,
                        rank=rank)
x = (torch.arange(n, device="cuda") % 7 + 10 * rank).to(torch.bfloat16)
try:
    if op == "all_reduce":
        dist.all_reduce(x.clone())
    elif op == "broadcast":
        dist.broadcast(x.clone(), src=0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    else:
        y = torch.empty_like(x)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                         dist.P2POp(dist.irecv, y, 1 - rank)]):
            r.wait()
    torch.cuda.synchronize()
    print("TAKES", flush=True)
except RuntimeError as e:
    print("REFUSES", str(e).splitlines()[0][-60:], flush=True)
dist.destroy_process_group()
"""


def gloo_table() -> dict:
    """What gloo does with bf16 CUDA tensors on this machine, asked of
    torch.distributed directly, each collective and size in its own
    two-process world (a crash stays in its world). parallel/comm.py
    stages every gloo collective on CUDA tensors through host memory."""
    import tempfile

    cases = [(op, n) for op in ("all_reduce", "broadcast", "all_gather",
                                "send/recv") for n in (4, 1 << 24)]
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    runs = [(op, n, [subprocess.Popen(
        [sys.executable, "-c", GLOO_CASE, str(r), str(tmp / f"{k}"), op,
         str(n)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]) for k, (op, n) in enumerate(cases)]
    table = {}
    try:
        for op, n, procs in runs:
            outs = []
            for p in procs:
                try:
                    out = p.communicate(timeout=120)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + "\nno answer in 120 s"
                last = [ln for ln in out.splitlines()
                        if ln.startswith(("TAKES", "REFUSES"))]
                outs.append(last[0] if last and p.returncode == 0 else
                            f"ended with code {p.returncode}: "
                            f"{out.strip().splitlines()[-1:]}")
            table[f"{op} of {n} bf16"] = outs[0] if outs[0] == outs[1] \
                else " / ".join(outs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return table


def par_primitives(torch, np, rank, n, device) -> dict:
    """(c) on one rank: ring attention (causal and not), moe_ffn under
    ep = n and pipeline_apply at pp = n with its gradients, each against
    the single-rank result on the same inputs (f32), and their times."""
    from whisper_tensor_tpu_torch.parallel.mesh import (
        Mesh, Sharding, local_block, make_mesh)
    from whisper_tensor_tpu_torch.parallel.moe import (moe_ffn,
                                                       shard_moe_params)
    from whisper_tensor_tpu_torch.parallel.pipeline import pipeline_apply
    from whisper_tensor_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)

    dev = torch.device(device) if device else torch.device("cuda")
    cuda = dev.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 190)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    def share(got, want):
        return float((got - want).abs().max() / want.abs().max())

    out = {}
    sp = Mesh(("sp",), (n,), device=device)
    B, H, S, D = 1, 8, 2048, 128
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    for causal in (False, True):
        mask = (torch.ones(S, S, dtype=torch.bool, device=dev).tril()
                if causal else None)
        want, plain_ms = timed(lambda: torch.softmax(
            (q @ k.transpose(-1, -2) * D ** -0.5).masked_fill(
                ~mask, -torch.inf) if causal else
            q @ k.transpose(-1, -2) * D ** -0.5, dim=-1) @ v)
        got, ms = timed(lambda: ring_attention_sharded(q, k, v, sp,
                                                       causal=causal))
        out[f"ring {'causal' if causal else 'full'}"] = (
            share(got, want), ms, plain_ms)
    T, Dm, F, E, kk = 256, 1024, 512, 16, 2
    p = {"router_w": randn(E, Dm), "w_gate": randn(E, Dm, F, scale=Dm ** -0.5),
         "w_up": randn(E, Dm, F, scale=Dm ** -0.5),
         "w_down": randn(E, F, Dm, scale=F ** -0.5)}
    x = randn(T, Dm)
    ep = make_mesh(ep=n, device=device)
    mine = shard_moe_params(p, ep)
    for cap in (T, 48):
        want, plain_ms = timed(lambda: moe_ffn(x, *p.values(), k=kk,
                                               capacity=cap))
        got, ms = timed(lambda: moe_ffn(x, *mine.values(), k=kk,
                                        capacity=cap, mesh=ep))
        out[f"moe ep={n} capacity {cap}"] = (share(got, want), ms, plain_ms)
    L, Dp, Bp, M = 2 * n, 1024, 64, 4
    stack = {"w": randn(L, Dp, Dp, scale=Dp ** -0.5),
             "b": randn(L, Dp, scale=0.1)}
    xp = randn(Bp, Dp)

    def stage(prm, h):
        return torch.tanh(h @ prm["w"] + prm["b"])

    def sequential(ps):
        h = xp
        for i in range(L):
            h = stage({"w": ps["w"][i], "b": ps["b"][i]}, h)
        return h

    pp = Mesh(("pp",), (n,), device=device)
    ps = {k2: t.clone().requires_grad_(True) for k2, t in stack.items()}
    got, ms = timed(lambda: pipeline_apply(
        stage, {k2: local_block(t, Sharding(pp, ("pp",)), k2)
                for k2, t in ps.items()}, xp, pp, microbatches=M))
    (got ** 2).sum().backward()
    rs = {k2: t.clone().requires_grad_(True) for k2, t in stack.items()}
    want, plain_ms = timed(lambda: sequential(rs))
    (want ** 2).sum().backward()
    lay = slice(rank * L // n, (rank + 1) * L // n)
    grad = max(share(ps[k2].grad[lay], rs[k2].grad[lay]) for k2 in ps)
    out[f"pipeline pp={n}"] = (share(got.detach(), want.detach()), ms,
                               plain_ms)
    out[f"pipeline pp={n} gradients"] = (grad, None, None)
    return out


def phase19_rank(torch, np, rank, n, device, ckpt, ref_toks, full,
                 cfg=None):
    """(a) then (c) on one rank of the two-rank gloo world; ref_toks:
    {build: {prompt: the single rank's greedy tokens}}. The cut (not
    `full`) then runs phase 20 (e)'s cut in the same world."""
    from whisper_tensor_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tp=n, device=device)
    prompts = par_prompts(np, full)
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "serving": {q: par_serve(torch, np, mesh, ckpt, q, prompts, t)
                       for q, t in ref_toks.items()}}
    say(f"  [rank {rank}: (a) done]")
    out["primitives"] = par_primitives(torch, np, rank, n, device)
    say(f"  [rank {rank}: (c) done]")
    if not full:
        free_memory(torch)
        out["train"] = phase20_rank(torch, np, rank, n, device, False, 1,
                                    cfg)
    return out


def phase19_nccl(torch, np, rank, n, device, ckpt, ref_toks,
                 cfg=None):
    """(b) in a world of one: the mesh path at tp=1 on phase 3's
    checkpoint (int8), the 24-token prompt (teacher-forced on the single
    rank's answer, `ref_toks`). With `train`, then phase 20 (g)'s cut."""
    from whisper_tensor_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tp=1, device=device)
    iface, load_s = par_load(torch, ckpt, "int8", mesh)
    ids = par_prompts(np, False)["24-token"]
    toks = iface.generate_tokens(ids[None], PAR_NEW)[0]
    out = {"backend": mesh.backend, "load_s": load_s, "tokens": toks,
           "forced": forced_rows(torch, np, iface, ids, ref_toks),
           "comm_calls": mesh.comm_calls,
           "fallbacks": list(iface._tp.fallbacks)}
    if cfg is not None:
        globals().update(cfg)
        del iface
        free_memory(torch)
        out["train"] = pt_case_g(torch, np, device, PT_CUT["g_B"],
                                 PT_CUT["g_S"])
    return out


def par_agree(np, toks, forced, ref, what: str) -> None:
    """Greedy tokens equal to the single-rank port's up to the first near
    tie (where the reference's top two logits lie within C10 of its
    largest |logit|), and the logits teacher-forced on the single rank's
    answer within C10 of each step's largest |logit| (C10's rule: bf16
    rounds in other places)."""
    rtoks, rforced = ref
    differ = np.nonzero(toks != rtoks)[0]
    if differ.size:
        i = int(differ[0])
        row = rforced[i]
        gap = float(np.diff(np.sort(row)[-2:])[0])
        say(f"  {what}: tokens part from the single rank's at step {i}: "
            f"top-2 gap {gap:.4g}, near-tie bound "
            f"{C10 * np.abs(row).max():.4g}")
        if not gap <= C10 * np.abs(row).max():
            fail(f"{what}: tokens {toks.tolist()} part from the single "
                 f"rank's {rtoks.tolist()} at step {i}, not at a near tie")
    else:
        say(f"  {what}: the {len(toks)} greedy tokens equal the single "
            f"rank's")
    rows_within(np, forced, rforced, C10,
                f"{what}: teacher-forced logits against the single rank's")


def par_check_launches(launches: dict, what: str) -> None:
    """Every kernel's launches equal the lowering's eligible calls of the
    counted run (`counted`'s rule, plus packed_matmul's)."""
    want = {"flash_attention": launches["flash-eligible calls"],
            "decode_attention": launches["decode-eligible calls"],
            "int8_matmul": launches["QuantMatMul calls"],
            "packed_matmul": launches["PackedMatMul calls"],
            "kv_write_pair": launches["KVWrite calls"],
            "ragged_kv_write": launches["KVWrite calls"]
            + launches["DynUpdateSlice calls"]}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    say(f"  {what}: kernel launches {launches}")
    if bad or min(launches[k] for k in ("flash_attention",
                                         "decode_attention",
                                         "kv_write_pair")) <= 0 or max(
            launches["int8_matmul"], launches["packed_matmul"]) <= 0:
        fail(f"{what}: launches against the lowering's eligible calls "
             f"(launched, eligible): {bad}, or a kernel of the path never "
             f"launched")


def phase19(torch, np, ckpt: Path, results, refs: dict, full: bool,
            device=None, nccl: str = "nccl") -> None:
    """Phase 19: (a) two ranks sharing the card over gloo serve phase 3's
    checkpoint at tp=2 (int8; with `full` also q4_0 and the 1,900-token
    prompt), held to the single-rank port's tokens and teacher-forced
    logits (`refs`: {build: par_reference}), each kernel's launches to
    the lowering's eligible calls per rank and every call to its plain
    version; (c) ring attention, moe_ffn and pipeline_apply over the
    same world against their single-rank results; (b) a world of one
    under NCCL: the mesh path at tp=1, its tokens the single rank's."""
    builds = tuple(refs)
    ref_toks = {q: {name: t for name, (t, _) in r.items()}
                for q, r in refs.items()}
    say(f"phase 19: parallelism: {PAR_TP} ranks sharing the card over "
        f"gloo (NCCL refuses two ranks on one device), builds {builds}, "
        f"prompts {list(par_prompts(np, full))}")
    # the cut starts (b) beside (a) and (c), whose timings it then
    # shares the card and host with; the full phase runs them in turn
    b_world = None if full else par_start(
        1, nccl, device, phase19_nccl, ckpt, ref_toks["int8"]["24-token"],
        pt_config())
    world = par_start(PAR_TP, "gloo", device, phase19_rank, ckpt, ref_toks,
                      full, pt_config())
    # the cut's phase 20 (e) reference, here while the worlds run
    t0 = time.perf_counter()
    e_ref = None if full else pt_qlora_reference(
        torch, np, PT_CUT["qlora_layers"], PT_CUT["qlora_steps"], device)
    free_memory(torch)
    say(f"  [phase 20 (e)'s single-rank reference in this process: "
        f"{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    outs = par_collect(world)
    say(f"  [the worlds answered {time.perf_counter() - t0:.1f} s later]")
    for rank, o in enumerate(outs):
        say(f"  rank {rank} on {o['device']} ({o['backend']})")
        for q, s in o["serving"].items():
            what = f"(a) {q} rank {rank}"
            if s["fallbacks"]:
                fail(f"{what}: the tp pass fell back to gathers at "
                     f"{s['fallbacks']}")
            say(f"  {what}: load {s['load_s']:.1f} s, "
                f"{s['card_gb']:.2f} GB on the card, local shapes "
                f"{s['shapes']}, cache {s['cache']}")
            for name, r in s["runs"].items():
                say(f"  {what}, {name} prompt: TTFT {r['ttft_ms']:.1f} ms, "
                    f"decode {r['tok_s']:.1f} tok/s, collectives "
                    f"{r['comm_ms_step']:.3f} host ms a step "
                    f"({r['comm_calls_step']:.1f} calls)")
                par_agree(np, r["tokens"], r["forced"], refs[q][name],
                          f"{what}, {name} prompt")
            par_check_launches(s["launches"], what)
            pc, pw, pe = s["packed_shadow"]
            say(f"  {what}: {pc} packed_matmul calls of the shadowed rerun "
                f"against the plain version: worst |err|/bound {pw:.4g} "
                f"(max |err| {pe:.5g})")
            for res in results:
                if res["name"] in s["launches"]:
                    res.setdefault("launches_phase19", {})[
                        f"{q} rank {rank}"] = s["launches"][res["name"]]
        for name, (err, ms, plain_ms) in o["primitives"].items():
            say(f"  (c) rank {rank}, {name}: max |diff| {err:.3g} of the "
                f"single-rank result's largest |value|"
                + ("" if ms is None else
                   f", {ms:.1f} ms (single rank {plain_ms:.1f} ms)"))
            if not err <= 1e-4:
                fail(f"(c) {name} on rank {rank} differs from the "
                     f"single-rank result by {err:.3g} of its scale")
    for o in outs[1:]:
        for q in builds:
            for name in outs[0]["serving"][q]["runs"]:
                if not np.array_equal(o["serving"][q]["runs"][name]["tokens"],
                                      outs[0]["serving"][q]["runs"][name][
                                          "tokens"]):
                    fail(f"(a) the ranks returned different tokens ({q}, "
                         f"{name})")
    (b,) = par_collect(b_world if b_world is not None else par_start(
        1, nccl, device, phase19_nccl, ckpt, ref_toks["int8"]["24-token"]))
    if full:
        say(f"  gloo's own answer to CUDA tensors (each in a world of "
            f"two processes): {gloo_table()}")
    say(f"  (b) a world of one under {b['backend']}: load {b['load_s']:.1f} "
        f"s, {b['comm_calls']} collectives launched, fallbacks "
        f"{b['fallbacks']}")
    if b["backend"] != nccl or b["comm_calls"] <= 0 or b["fallbacks"]:
        fail("(b) the NCCL world of one launched no collective, or fell "
             "back")
    par_agree(np, b["tokens"], b["forced"], refs["int8"]["24-token"],
              "(b) tp=1 under NCCL")
    if not full:
        say("phase 20's cut (the same worlds): (e) QLoRA at dp=2, "
            f"{PT_CUT['qlora_layers']} layer, {PT_CUT['qlora_steps']} "
            f"steps; (g) a world of one under {b['backend']}")
        phase20_check_qlora(np, [o["train"] for o in outs], results, e_ref)
        phase20_check_g(np, b["train"])


# ---------------------------------------------------------------------------
# phase 20: training across ranks (LMTrainer's dp, sp, tp and fsdp, sharded
# checkpoints, PipelinedLMTrainer)
PT_GPT2 = dict(B=8, S=1024, f32_steps=3, bf16_steps=4)
PT_LLAMA = dict(layers=2, B=1, S=1024, steps=2)
PT_QLORA = dict(steps=4)
PT_PIPE = dict(B=8, S=1024, microbatches=4, steps=2)
# the default run's cut: (e) at one layer for 2 steps, (g) at this batch
PT_CUT = dict(qlora_layers=1, qlora_steps=2, g_B=2, g_S=512)
# (e)'s gates on the gradient sum over dp (phase20_check_qlora)
PT_E = dict(grad=0.05, adam=0.1)
# the settings a spawned rank takes from its parent (a rehearsal on the
# CPU shrinks them in the parent)
PT_CONFIG = ("GPT2_WIDTHS", "WIDTHS", "QLORA", "PT_GPT2", "PT_LLAMA",
             "PT_QLORA", "PT_PIPE", "PT_CUT")


def pt_config() -> dict:
    return {k: globals()[k] for k in PT_CONFIG}


def pt_gpt2_model():
    """Phase 14 (a)'s model: GPT-2 124M's training graph on seeded
    weights, and the weights by HF name (the layered model's source)."""
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, build_gpt2_train, random_gpt2_weights)
    from whisper_tensor_tpu_torch.model import Model

    cfg = GPT2Config(**GPT2_WIDTHS)
    wg = random_gpt2_weights(cfg, SEED)
    return cfg, wg, Model.new_from_onnx(build_gpt2_train(wg, cfg))


def pt_llama_model(layers: int, dtype_name: str):
    """The smoke checkpoint's seeded weights (checkpoint_tensors) as
    Llama-3-8B widths' training graph, `layers` deep, max_len 1,024."""
    import numpy as np

    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_train)
    from whisper_tensor_tpu_torch.model import Model

    cfg = LlamaConfig(num_hidden_layers=layers, **{
        k: WIDTHS[k] for k in ("hidden_size", "num_attention_heads",
                               "num_key_value_heads", "intermediate_size",
                               "vocab_size", "rope_theta", "rms_norm_eps",
                               "max_position_embeddings")})
    weights = dict(checkpoint_tensors(layers, np))
    model = Model.new_from_onnx(build_llama_train(
        weights.__getitem__, cfg, max_len=PT_LLAMA["S"],
        dtype=getattr(DType, dtype_name)))
    del weights
    return model


def pt_batches(np, B: int, S: int, n: int, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, S + 1)) for _ in range(n)]


def pt_steps(torch, mesh, cuda: bool, step, batches):
    """Run `step(batch) -> loss` on each of `batches`: the losses, and
    the median past the first step of its ms and of its collectives'
    calls and host ms. Both medians are over the same steps, so the
    collectives' share of a step reads off them; the first step, with
    the ranks' wait for each other to arrive, is left out of both."""
    losses, rows = [], []
    for b in batches:
        c0 = (mesh.comm_calls, mesh.comm_seconds) if mesh else (0, 0.0)
        t = time.perf_counter()
        losses.append(float(step(b)))
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        c1 = (mesh.comm_calls, mesh.comm_seconds) if mesh else (0, 0.0)
        rows.append((dt * 1e3, c1[0] - c0[0], (c1[1] - c0[1]) * 1e3))
    ms, calls, comm_ms = (statistics.median(col)
                          for col in zip(*(rows[1:] or rows)))
    return losses, {"ms": ms, "comm_calls": calls, "comm_ms": comm_ms}


def pt_run(torch, make, mesh, batches, steps=None, start=None):
    """Build a trainer (`make(mesh)`) and step it on `batches` (whole on
    every rank): load s, losses, ms a step and the collectives' calls
    and host ms a step (pt_steps), tok/s, this rank's peak card GB, the
    bytes of its masters and optimizer state; `trainer`, `params`,
    `opt` for the caller. start: (params, opt) to step from."""
    cuda = torch.cuda.is_available() and (mesh is None
                                          or mesh.device.type == "cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = make(mesh)
    if start is None:
        params = tr.init_params()
        opt = tr.init_opt_state(params)
    else:
        params, opt = start
    sync()
    load_s = time.perf_counter() - t0
    state = [params, opt]

    def step(b):
        state[0], state[1], loss = tr.train_step(*state, b[:, :-1],
                                                 b[:, 1:])
        return loss

    losses, timing = pt_steps(torch, mesh, cuda, step, batches[:steps])
    params, opt = state
    B, S = batches[0].shape[0], batches[0].shape[1] - 1
    out = {"load_s": load_s, "losses": losses, **timing,
           "tok_s": B * S / timing["ms"] * 1e3,
           "gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.values()),
           "opt_bytes": sum(x.numel() * x.element_size() for x in opt),
           "fallbacks": (None if getattr(tr, "tp_plan", None) is None
                         else list(tr.tp_plan.fallbacks)),
           "trainer": tr, "params": params, "opt": opt}
    return out


def pt_public(r: dict) -> dict:
    """A pt_run result without the live objects (for the parent)."""
    return {k: v for k, v in r.items() if k not in ("trainer", "params",
                                                    "opt")}


def pt_free(torch, *results) -> None:
    for r in results:
        for k in ("trainer", "params", "opt"):
            r.pop(k, None)
    free_memory(torch)


def pt_case_gpt2(torch, np, rank, mesh_dp, device, out) -> None:
    """(a) dp=2 in f32 (against rank 0's single-rank run) and bf16
    (timing, beside rank 0's single rank), (b) the same under FSDP."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    cfg, _, model = pt_gpt2_model()
    f32 = pt_batches(np, PT_GPT2["B"], PT_GPT2["S"], 1, cfg.vocab_size,
                     SEED + 200) * PT_GPT2["f32_steps"]
    bf16 = pt_batches(np, PT_GPT2["B"], PT_GPT2["S"], 1, cfg.vocab_size,
                      SEED + 201) * PT_GPT2["bf16_steps"]

    def make(compute=None, **kw):
        return lambda mesh: LMTrainer(
            model, optimizer="adamw", lr=1e-4, compute_dtype=compute,
            mesh=mesh, device=None if mesh else device, **kw)

    if rank == 0:
        r = pt_run(torch, make(), None, f32)
        out["a_ref"] = pt_public(r)
        pt_free(torch, r)
        r = pt_run(torch, make(DType.BF16), None, bf16)
        out["a_ref_bf16"] = pt_public(r)
        pt_free(torch, r)
    say(f"  [rank {rank}: (a) the single-rank runs done]")
    r = pt_run(torch, make(), mesh_dp, f32)
    out["a"] = pt_public(r)
    pt_free(torch, r)
    r = pt_run(torch, make(DType.BF16), mesh_dp, bf16)
    out["a_bf16"] = pt_public(r)
    pt_free(torch, r)
    r = pt_run(torch, make(fsdp=True), mesh_dp, f32)
    out["b"] = pt_public(r)
    pt_free(torch, r)
    say(f"  [rank {rank}: (a), (b) done: {pt_line('dp=2', out['a'])}; "
        f"{pt_line('fsdp', out['b'])}]")


def pt_case_llama(torch, np, rank, n, device, out) -> None:
    """(c) tp=2 against rank 0's single rank, the sharded checkpoint
    into rank 0's single-rank trainer, (d) sp=2 with SGD against rank
    0's single rank (sp keeps the whole model on each rank, and two
    copies of it with AdamW's state and the update's temporaries, ~48 GB
    a rank, do not fit one card)."""
    from whisper_tensor_tpu_torch.parallel.mesh import LLAMA_RULES, make_mesh
    from whisper_tensor_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    t0 = time.perf_counter()
    model = pt_llama_model(PT_LLAMA["layers"], "F32")
    out["c_build_s"] = time.perf_counter() - t0
    batches = pt_batches(np, PT_LLAMA["B"], PT_LLAMA["S"],
                         PT_LLAMA["steps"] + 1, WIDTHS["vocab_size"],
                         SEED + 202)
    steps = PT_LLAMA["steps"]

    def make(mesh, optimizer="adamw"):
        return LMTrainer(model, optimizer=optimizer, lr=1e-4, mesh=mesh,
                         rules=LLAMA_RULES if mesh else None,
                         device=None if mesh else device)

    def make_sgd(mesh):
        return make(mesh, "sgd")

    if rank == 0:
        r = pt_run(torch, make, None, batches, steps)
        out["c_ref"] = pt_public(r)
        pt_free(torch, r)
    say(f"  [rank {rank}: (c) the single-rank run done]")
    mesh = make_mesh(tp=n, device=device)
    r = pt_run(torch, make, mesh, batches, steps)
    tr = r["trainer"]
    (ROOT / "build" / "smoke").mkdir(parents=True, exist_ok=True)
    ckpt = str(ROOT / "build" / "smoke" / "phase20-tp.npz")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, r["params"], r["opt"], steps, mesh=mesh,
                    param_shardings=tr.param_shardings,
                    param_order=tr.weight_names)
    out["c_save_s"] = time.perf_counter() - t0
    nxt = batches[steps]
    _, _, loss = tr.train_step(r["params"], r["opt"], nxt[:, :-1],
                               nxt[:, 1:])
    r["next_loss"] = float(loss)
    out["c"] = pt_public(r)
    out["c"]["shapes"] = {k: tuple(v.shape) for k, v in r["params"].items()
                          if k in ("embed_tokens", "wq_0", "wo_0",
                                   "lm_head")}
    pt_free(torch, r)
    if rank == 0:
        t0 = time.perf_counter()
        single = make(None)
        fresh = single.init_opt_state(single.init_params())
        p, s, step, _ = load_checkpoint(ckpt, opt_state_like=fresh)
        del fresh
        free_memory(torch)
        out["c_load_s"] = time.perf_counter() - t0
        _, _, loss = single.train_step(p, s, nxt[:, :-1], nxt[:, 1:])
        out["c_resumed"] = {"step": step, "next_loss": float(loss)}
        del single, p, s
        Path(ckpt).unlink(missing_ok=True)
        free_memory(torch)
    say(f"  [rank {rank}: (c) done: {pt_line('tp=2', out['c'])}]")
    if rank == 0:
        r = pt_run(torch, make_sgd, None, batches, steps)
        out["d_ref"] = pt_public(r)
        pt_free(torch, r)
    r = pt_run(torch, make_sgd, make_mesh(sp=n, device=device), batches,
               steps)
    out["d"] = pt_public(r)
    pt_free(torch, r)
    del model
    free_memory(torch)
    say(f"  [rank {rank}: (d) done: {pt_line('sp=2', out['d'])}]")


class Int8Shadow:
    """int8_matmul (both names the QuantMatMul paths call it by) and
    int8_matmul_dx, each call held against its plain version on its
    inputs (agreement_bound) while installed."""

    def __init__(self):
        from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
        from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm
        from whisper_tensor_tpu_torch.milli import transforms

        self.qm, self.tr = qm, transforms
        self.kernel, self.kernel_dx = qm.int8_matmul, qm.int8_matmul_dx
        self.calls = {"int8_matmul": 0, "int8_matmul_dx": 0}
        self.worst = {"int8_matmul": 0.0, "int8_matmul_dx": 0.0}

        def check(name, got, want, mag):
            _, share = worst_share(got, want, mag, agreement_bound)
            self.calls[name] += 1
            self.worst[name] = max(self.worst[name], share)
            return got

        def fwd(x, w, s):
            return check("int8_matmul", self.kernel(x, w, s),
                         qm.int8_matmul_plain(x, w, s),
                         qm.int8_matmul_plain(x.float().abs(), w.abs(), s))

        def dx(dy, w, s):
            return check("int8_matmul_dx", self.kernel_dx(dy, w, s),
                         qm.int8_matmul_dx_plain(dy, w, s),
                         qm.int8_matmul_dx_plain(dy.float().abs(), w.abs(),
                                                 s))

        # (a wrapper counts its launches on the name it is bound to)
        fwd.launches, dx.launches = (self.kernel.launches,
                                     self.kernel_dx.launches)
        dx.path_launches = self.kernel_dx.path_launches
        self.fwd, self.dx = fwd, dx
        qm.int8_matmul = transforms.int8_matmul = fwd
        qm.int8_matmul_dx = dx

    def close(self):
        self.qm.int8_matmul = self.tr.int8_matmul = self.kernel
        self.qm.int8_matmul_dx = self.kernel_dx
        self.kernel.launches = self.fwd.launches
        self.kernel_dx.launches = self.dx.launches


def pt_qlora_setup(np, layers: int, steps: int, device):
    """(e)'s model (phase 14 (b)'s setup, `layers` deep), its batches of
    README bytes and its trainer maker (a mesh, or None: `device`)."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    model = pt_llama_model(layers, "BF16")
    batches = [np.concatenate([x, y[:, -1:]], axis=1)
               for x, y in readme_batches(np, QLORA["B"], QLORA["S"], steps)]

    def make(mesh):
        return LMTrainer(model, lr=2e-4, compute_dtype=DType.BF16,
                         param_dtype=DType.BF16, lora_rank=QLORA["rank"],
                         lora_targets=QLORA["targets"], quantize_base="int8",
                         remat=True, mesh=mesh,
                         device=None if mesh else device)

    return batches, make


def pt_host(params) -> dict:
    return {k: v.float().cpu().numpy() for k, v in params.items()}


def pt_qlora_grads(torch, np, tr, b) -> dict:
    """tr's adapter gradients (value_and_grad) on batch `b` at a point
    both runs can make: the adapters' start plus seeded noise (the B
    adapters start at 0, which would zero the A adapters' gradients)."""
    rng = np.random.default_rng(SEED + 205)
    p = {}
    for k, v in tr.init_params().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        p[k] = (v.float() + torch.from_numpy(noise).to(v.device) * 1e-2
                ).to(v.dtype)
    _, g = tr.value_and_grad(p, b[:, :-1], b[:, 1:])
    return pt_host(g)


def pt_qlora_single(torch, np, batches, make) -> dict:
    """(e)'s single-rank run: losses, timings, the adapters before and
    after the steps, the gradients on the first batch (pt_qlora_grads)
    and, to show what the gradient gate reads on a fault, those of its
    first half alone (the rows rank 0 of dp=2 takes)."""
    r = pt_run(torch, make, None, batches)
    tr, b = r["trainer"], batches[0]
    out = dict(pt_public(r), adapters=pt_host(r["params"]),
               start=pt_host(tr.init_params()),
               grads=pt_qlora_grads(torch, np, tr, b),
               grads_half=pt_qlora_grads(torch, np, tr, b[:len(b) // 2]))
    pt_free(torch, r)
    return out


def pt_qlora_reference(torch, np, layers: int, steps: int, device) -> dict:
    """(e)'s single-rank run (pt_qlora_single) on its own setup."""
    batches, make = pt_qlora_setup(np, layers, steps, device)
    return pt_qlora_single(torch, np, batches, make)


def pt_case_qlora(torch, np, rank, mesh_dp, device, layers: int,
                  steps: int, out, reference: bool = True) -> None:
    """(e) QLoRA at dp=2 (phase 14 (b)'s setup, `layers` deep, `steps`
    steps): launches against the lowering's calls on this rank, every
    int8 call of a rerun against its plain version; with `reference`,
    rank 0's single-rank run first (the default run's cut has its
    parent run it beside the worlds)."""
    from whisper_tensor_tpu_torch.backends.cuda import quant_matmul as qm

    t0 = time.perf_counter()
    batches, make = pt_qlora_setup(np, layers, steps, device)
    build_s = time.perf_counter() - t0
    if reference and rank == 0:
        out["e_ref"] = pt_qlora_single(torch, np, batches, make)
    cuda = mesh_dp.device.type == "cuda"
    spy = LoweringSpy(("QuantMatMul",))
    try:
        n_i8, n_dx = qm.int8_matmul.launches, qm.int8_matmul_dx.launches
        n_tma = qm.int8_matmul_dx.path_launches["tma"]
        n_bw = qm.Int8MatMul.backward_calls
        spy.zero()
        r = pt_run(torch, make, mesh_dp, batches)
        launches = {"int8_matmul": qm.int8_matmul.launches - n_i8,
                    "int8_matmul_dx": qm.int8_matmul_dx.launches - n_dx,
                    "int8_matmul_dx tma":
                        qm.int8_matmul_dx.path_launches["tma"] - n_tma,
                    "QuantMatMul calls": spy.calls["QuantMatMul"],
                    "Int8MatMul backward calls":
                        qm.Int8MatMul.backward_calls - n_bw}
    finally:
        spy.restore()
    tr = r["trainer"]
    res = dict(pt_public(r), adapters=pt_host(r["params"]), build_s=build_s,
               grads=pt_qlora_grads(torch, np, tr, batches[0]),
               launches=launches, layers=layers, steps=steps,
               int8_weights=len(tr._quantized_base),
               shadow={"int8_matmul": (0, 0.0), "int8_matmul_dx": (0, 0.0)})
    if cuda:        # (a CPU rehearsal launches no kernel to hold)
        sh = Int8Shadow()
        try:
            p = tr.init_params()
            o = tr.init_opt_state(p)
            for b in batches:
                p, o, _ = tr.train_step(p, o, b[:, :-1], b[:, 1:])
        finally:
            sh.close()
        res["shadow"] = {k: (sh.calls[k], sh.worst[k]) for k in sh.calls}
        # one more step on every rank (the collectives pair up), profiled:
        # the int8 kernels' device ms in it
        b = batches[0]
        res["int8_ms"] = step_profile(torch, lambda: tr.train_step(
            p, o, b[:, :-1], b[:, 1:]))[1].get("int8 kernels", 0.0)
    out["e"] = res
    pt_free(torch, r)
    del make
    free_memory(torch)
    say(f"  [rank {rank}: (e) done: {pt_line('qlora', res)}, launches "
        f"{res['launches']}, shadows {res['shadow']}]")


def pt_pipe_trainer(mesh, lr: float = 1e-4):
    """PipelinedLMTrainer over layered_gpt2 at GPT-2 124M's widths
    (seeded weights), tp inside the block, AdamW."""
    from whisper_tensor_tpu_torch.importers.recipes.llm.gpt2 import (
        GPT2Config, random_gpt2_weights)
    from whisper_tensor_tpu_torch.parallel.pipeline_trainer import (
        PipelinedLMTrainer, layered_gpt2)

    cfg = GPT2Config(**GPT2_WIDTHS)
    return PipelinedLMTrainer(
        layered_gpt2(cfg, random_gpt2_weights(cfg, SEED), tp_axis="tp"),
        mesh, microbatches=PT_PIPE["microbatches"], lr=lr)


def pt_case_pipe(torch, np, mesh, out, key: str) -> None:
    """(f) PipelinedLMTrainer over GPT-2 124M on `mesh` (pp=2, or pp=1
    for the reference)."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = pt_pipe_trainer(mesh)
    p = tr.init_params()
    o = tr.init_opt_state(p)
    load_s = time.perf_counter() - t0
    (b,) = pt_batches(np, PT_PIPE["B"], PT_PIPE["S"], 1,
                      GPT2_WIDTHS["vocab_size"], SEED + 203)
    state = [p, o]

    def step(b):
        state[0], state[1], loss = tr.train_step(*state, b[:, :-1],
                                                 b[:, 1:])
        return loss

    losses, timing = pt_steps(torch, mesh, cuda, step,
                              [b] * PT_PIPE["steps"])
    out[key] = {"load_s": load_s, "losses": losses, **timing,
                "tok_s": PT_PIPE["B"] * PT_PIPE["S"] / timing["ms"] * 1e3,
                "gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
                else 0.0,
                "block_local": {k: tuple(v.shape)
                                for k, v in state[0]["block"].items()
                                if k in ("wqkv", "wproj")}}
    del tr, p, o, state
    free_memory(torch)


def phase20_rank(torch, np, rank, n, device, full: bool, layers: int,
                 cfg: dict):
    """Phase 20 on one rank of the two-rank gloo world: (a)-(f) with
    `full`, else (e)'s cut. cfg: the parent's pt_config()."""
    from whisper_tensor_tpu_torch.parallel.mesh import Mesh, make_mesh

    globals().update(cfg)
    out = {"device": device or "cuda"}
    if full:
        pt_case_gpt2(torch, np, rank, make_mesh(dp=n, device=device),
                     device, out)
        pt_case_llama(torch, np, rank, n, device, out)
    pt_case_qlora(torch, np, rank, make_mesh(dp=n, device=device), device,
                  layers if full else PT_CUT["qlora_layers"],
                  PT_QLORA["steps"] if full else PT_CUT["qlora_steps"], out,
                  reference=full)
    if full:
        pt_case_pipe(torch, np, Mesh(("dp", "pp", "tp"), (1, n, 1),
                                     device=device), out, "f")
    return out


def pt_case_g(torch, np, device, B: int, S: int) -> dict:
    """(g) in a world of one: LMTrainer(mesh=make_mesh()) steps against
    the trainer without a mesh on phase 14 (a)'s model (f32, AdamW, two
    steps of B x S)."""
    from whisper_tensor_tpu_torch.parallel.mesh import make_mesh
    from whisper_tensor_tpu_torch.training.trainer import LMTrainer

    cfg, _, model = pt_gpt2_model()
    batches = pt_batches(np, B, S, 2, cfg.vocab_size, SEED + 204)
    mesh = make_mesh(device=device)

    def make(m):
        return LMTrainer(model, optimizer="adamw", lr=1e-4, mesh=m,
                         device=None if m else device)

    out = {"backend": mesh.backend}
    for key, m in (("g_plain", None), ("g", mesh)):
        r = pt_run(torch, make, m, batches)
        out[key] = dict(pt_public(r), params={
            k: v.float().cpu().numpy() for k, v in r["params"].items()})
        pt_free(torch, r)
    del model
    free_memory(torch)
    return out


def phase20_nccl(torch, np, rank, n, device, cfg: dict):
    """(g) and (f)'s pp=1 reference in a world of one."""
    from whisper_tensor_tpu_torch.parallel.mesh import Mesh

    globals().update(cfg)
    out = pt_case_g(torch, np, device, PT_GPT2["B"], PT_GPT2["S"])
    mesh = Mesh(("dp", "pp", "tp"), (1, 1, 1), device=device)
    pt_case_pipe(torch, np, mesh, out, "f_ref")
    out["nccl_calls"] = mesh.comm_calls
    return out


def pt_line(label: str, r: dict) -> str:
    return (f"{label}: load {r['load_s']:.1f} s, {r['ms']:.1f} ms a step, "
            f"{r['tok_s']:.0f} tok/s, {r['gb']:.2f} GB on the card, "
            f"collectives {r['comm_calls']:.1f} calls and "
            f"{r['comm_ms']:.1f} host ms a step")


def pt_losses_agree(np, got, want, what: str, rtol=2e-4, atol=1e-5):
    ok = len(got) == len(want) and np.allclose(got, want, rtol=rtol,
                                               atol=atol)
    say(f"  {what}: losses {[round(v, 5) for v in got]} against "
        f"{[round(v, 5) for v in want]} (rtol {rtol}, atol {atol}): "
        f"{'agree' if ok else 'DIFFER'}")
    if not ok:
        fail(f"phase 20 {what}: the losses differ")


def pt_ratio(np, got: dict, want: dict, base=None) -> float:
    """|got - want| / |want - base| over all the leaves (base: zeros)."""
    num = sum(float(((got[k] - v) ** 2).sum()) for k, v in want.items())
    den = sum(float(((v - (0 if base is None else base[k])) ** 2).sum())
              for k, v in want.items())
    return math.sqrt(num / max(den, 1e-30))


def phase20_check_qlora(np, outs, results, ref: dict) -> None:
    """(e) on every rank: launches equal the lowering's calls, shadows
    within agreement_bound, losses at (a)'s bf16 tolerance of the single
    rank's (`ref`, pt_qlora_single's), and two gates on the gradient
    sum over dp:
      * the gradients at one point, against the single rank's on the
        whole batch: |difference| / |gradient| within PT_E["grad"]. A
        gradient scaled by 2 or by 1/2 reads 1 and 0.5, and one rank's
        rows alone read what the single rank's first half reads
        (printed beside it): AdamW's steps would hide a scale;
      * the adapters after the steps: |difference| / |the single rank's
        update| within PT_E["adam"] (sound runs read 0.029-0.030 in the
        logs this limit was set from), and every element within 2 x
        steps x lr + a bf16 ulp, a sanity bound: Adam moves an element
        by about lr a step whatever its gradient."""
    g, half = ref["grads"], ref["grads_half"]
    faults = {"a rank's rows alone": pt_ratio(np, half, g),
              "a rank's share, not summed": pt_ratio(
                  np, {k: v / 2 for k, v in half.items()}, g)}
    for rank, o in enumerate(outs):
        e = o["e"]
        L = e["launches"]
        what = f"(e) QLoRA at dp=2, {e['layers']} layer(s), rank {rank}"
        say(f"  {pt_line(what, e)}, int8 kernels {e.get('int8_ms', 0.0):.1f}"
            f" ms of a step on the card; build {e['build_s']:.1f} s, "
            f"{e['int8_weights']} int8 weights")
        say(f"  {what}: launches {L}; shadowed rerun (calls, worst "
            f"err/tol): {e['shadow']}")
        if L["int8_matmul"] != L["QuantMatMul calls"] or \
                not L["int8_matmul"] or \
                L["int8_matmul_dx"] != L["Int8MatMul backward calls"] or \
                not L["int8_matmul_dx"] or \
                L["int8_matmul_dx tma"] != L["int8_matmul_dx"]:
            fail(f"phase 20 {what}: launches against the lowering's "
                 f"calls: {L}")
        for k, (calls, worst) in e["shadow"].items():
            if calls != L[k] or not worst <= 1.0:
                fail(f"phase 20 {what}: {calls} shadowed {k} calls of "
                     f"{L[k]}, worst {worst}")
        pt_losses_agree(np, e["losses"], ref["losses"], what, rtol=2e-2,
                        atol=0)
        grad = pt_ratio(np, e["grads"], g)
        say(f"  {what}: gradients at one point against the single rank's: "
            f"|difference| / |gradient| {grad:.4g} (limit {PT_E['grad']}; "
            f"faults read: a scale of 2 1.0, of 1/2 0.5, "
            + ", ".join(f"{k} {v:.4g}" for k, v in faults.items()) + ")")
        if not grad <= PT_E["grad"]:
            fail(f"phase 20 {what}: the gradients summed over dp differ "
                 f"from the single rank's")
        worst = 0.0
        for k, want in ref["adapters"].items():
            lim = 2 * e["steps"] * 2e-4 + np.abs(want) * 2.0 ** -8
            worst = max(worst, float((np.abs(e["adapters"][k] - want)
                                      / lim).max()))
        adam = pt_ratio(np, e["adapters"], ref["adapters"], ref["start"])
        say(f"  {what}: adapters after the steps against the single "
            f"rank's: |difference| / |the single rank's update| "
            f"{adam:.4g} (limit {PT_E['adam']}); worst element {worst:.3g} "
            f"of 2 x steps x lr + a bf16 ulp")
        if not adam <= PT_E["adam"] or not worst <= 1.0:
            fail(f"phase 20 {what}: the adapters part from the single "
                 f"rank's")
        for res in results:
            if res["name"] in ("int8_matmul", "int8_matmul_dx"):
                res.setdefault("launches_phase20", {})[f"rank {rank}"] = \
                    L[res["name"]]
    say(f"  (e) single rank: {pt_line('', ref)[2:]}")


def phase20_check_g(np, g: dict) -> None:
    plain, meshed = g["g_plain"], g["g"]
    say(f"  (g) a world of one under {g['backend']}: "
        f"{pt_line('mesh', meshed)}; without a mesh {plain['ms']:.1f} ms "
        f"a step")
    same = plain["losses"] == meshed["losses"] and all(
        np.array_equal(plain["params"][k], meshed["params"][k])
        for k in plain["params"])
    worst = max(float(np.abs(meshed["params"][k] - v).max()
                      / max(np.abs(v).max(), 1e-30))
                for k, v in plain["params"].items())
    say(f"  (g) losses {meshed['losses']} against {plain['losses']}; "
        f"params bit for bit: {same} (worst {worst:.3g} of a tensor's "
        f"largest |p|; bound 1e-6)")
    if not np.allclose(meshed["losses"], plain["losses"], rtol=1e-6,
                       atol=0) or not worst <= 1e-6:
        fail("phase 20 (g): the mesh of one's steps differ from the "
             "trainer without a mesh")


def phase20(torch, np, results, layers: int, device=None,
            nccl: str = "nccl") -> None:
    """Phase 20 (`--train-parallel-only`): (g) and (f)'s pp=1 reference in
    a world of one under NCCL, then (a)-(f) in two ranks sharing the card
    over gloo, each held against the single rank on the same card."""
    say(f"phase 20: training across ranks: (g) a world of one under "
        f"{nccl}, then two ranks sharing the card over gloo (a) GPT-2 124M "
        f"dp=2, (b) FSDP, (c) Llama-3-8B widths ({PT_LLAMA['layers']} "
        f"layers) tp=2 with a sharded checkpoint, (d) sp=2, (e) QLoRA dp=2 "
        f"({layers} layers), (f) PipelinedLMTrainer pp=2")
    (g,) = par_collect(par_start(1, nccl, device, phase20_nccl,
                                 pt_config()))
    phase20_check_g(np, g)
    outs = par_collect(par_start(PAR_TP, "gloo", device, phase20_rank, True,
                                 layers, pt_config()))
    ref, ref16 = outs[0]["a_ref"], outs[0]["a_ref_bf16"]
    say(f"  (a) single rank f32: {pt_line('', ref)[2:]}")
    say(f"  (a) single rank bf16: {pt_line('', ref16)[2:]}")
    for rank, o in enumerate(outs):
        what = f"rank {rank}"
        say(f"  {pt_line(f'(a) dp=2 f32, {what}', o['a'])}")
        pt_losses_agree(np, o["a"]["losses"], ref["losses"],
                        f"(a) dp=2, {what}")
        say(f"  {pt_line(f'(a) dp=2 bf16, {what}', o['a_bf16'])}")
        pt_losses_agree(np, o["a_bf16"]["losses"], ref16["losses"],
                        f"(a) dp=2 bf16, {what}", rtol=2e-2, atol=0)
        say(f"  {pt_line(f'(b) FSDP dp=2, {what}', o['b'])}")
        pt_losses_agree(np, o["b"]["losses"], ref["losses"],
                        f"(b) FSDP, {what}")
        say(f"  (b) {what}: masters {o['b']['param_bytes'] / 1e9:.3f} GB "
            f"and AdamW state {o['b']['opt_bytes'] / 1e9:.3f} GB, against "
            f"(a)'s {o['a']['param_bytes'] / 1e9:.3f} and "
            f"{o['a']['opt_bytes'] / 1e9:.3f} GB")
        if not o["b"]["param_bytes"] < 0.6 * o["a"]["param_bytes"]:
            fail(f"phase 20 (b) {what}: the masters are not cut over dp")
    cref, dref = outs[0]["c_ref"], outs[0]["d_ref"]
    say(f"  (c) single rank: {pt_line('', cref)[2:]}")
    say(f"  (d) single rank, SGD: {pt_line('', dref)[2:]}")
    for rank, o in enumerate(outs):
        what = f"rank {rank}"
        c = o["c"]
        say(f"  {pt_line(f'(c) tp=2, {what}', c)}; build "
            f"{o['c_build_s']:.1f} s, local shapes {c['shapes']}, "
            f"fallbacks {c['fallbacks']}, checkpoint written in "
            f"{o['c_save_s']:.1f} s")
        if c["fallbacks"]:
            fail(f"phase 20 (c) {what}: the tp pass fell back at "
                 f"{c['fallbacks']}")
        pt_losses_agree(np, c["losses"], cref["losses"], f"(c) tp=2, {what}")
        say(f"  {pt_line(f'(d) sp=2, {what}', o['d'])}")
        pt_losses_agree(np, o["d"]["losses"], dref["losses"],
                        f"(d) sp=2 (SGD), {what}")
    res = outs[0]["c_resumed"]
    say(f"  (c) the sharded checkpoint into the single-rank trainer: "
        f"loaded in {outs[0]['c_load_s']:.1f} s at step {res['step']}")
    pt_losses_agree(np, [res["next_loss"]],
                    [o["c"]["next_loss"] for o in outs][:1],
                    "(c) the resumed step against the world's")
    phase20_check_qlora(np, outs, results, outs[0]["e_ref"])
    fref = g["f_ref"]
    say(f"  {pt_line('(f) pp=1 (the world of one)', fref)}")
    for rank, o in enumerate(outs):
        say(f"  {pt_line(f'(f) pp=2, rank {rank}', o['f'])}; local block "
            f"shapes {o['f']['block_local']}")
        pt_losses_agree(np, o["f"]["losses"], fref["losses"],
                        f"(f) pp=2, rank {rank}")
    say(f"  (g)'s world launched {g['nccl_calls']} {g['backend']} "
        f"collectives (the pp=1 reference's)")
    if g["backend"] != nccl or g["nccl_calls"] <= 0:
        fail("phase 20: the world of one launched no collective")


# ---------------------------------------------------------------------------
# phase 22: the port's examples (examples/torch_port/*.py) on the card
EXAMPLES_DIR = ROOT / "examples" / "torch_port"
# (example, the line it must print, the kernels its run must launch).
# ragged_kv_write counts every launch of the cache-write kernel, paired or
# not. speculative_decode's and super_graph_llm's GPT-2s decode over f32
# caches, which neither attention kernel takes (pos_mode, as the JAX
# package's ragged_decode_attention takes bf16 only): the cache write is
# their path's only kernel. Every run's launches must also equal the
# lowering's eligible calls (counted).
EXAMPLE_RUNS = (
    ("serve_clients", "aggregate", ("decode_attention", "kv_write_pair")),
    ("speculative_decode", "token-exact", ("ragged_kv_write",)),
    ("gpt2_train", "done in", ()),
    ("lora_train", "done in", ()),
    ("mnist_train", "accuracy:", ()),
    ("mnist_train_supergraph", "accuracy:", ()),
    ("super_graph_llm", "identical tokens", ("ragged_kv_write",)),
    ("rwkv_lora_train", "OK: adapters trained", ()),
    ("multihost_train", "both workers finished", ()),
    ("sd_image", "wrote", ("flash_attention",)),
    ("llava_chat", '"response"',
     ("flash_attention", "decode_attention", "kv_write_pair")),
    ("whisper_stt", '"text"', ("flash_attention", "ragged_kv_write")),
    ("tts_speak", '"sample_rate"', ()),
)


def phase22_args(torch, np, name: str, d: Path, layers: int, bf16) -> list:
    """The arguments phase 22 runs `name` with: its defaults, and for the
    examples that read a model, a seeded one at published widths written
    into `d` by the writers of phases 3, 13, 16 and 17 (with a seeded
    input to read)."""
    from whisper_tensor_tpu_torch.utils.audio import wav_bytes

    if name == "serve_clients":
        write_checkpoint(d, layers, np, bf16)
        return ["--model", str(d), "--clients", "8", "--tokens", "32",
                "--prefix", "64", "--prefill-chunk", "128"]
    if name == "sd_image":
        write_sd15(torch, np, d)
        return ["--model", str(d), "--steps", "4", "--out",
                str(d / "out.ppm")]
    if name == "llava_chat":
        write_hf(d, LLAVA_15_7B, llava_shapes(LLAVA_15_7B), SEED + 169, np,
                 bf16, ("language_model.lm_head.weight",))
        px = seeded_pixels(np, 336)
        (d / "image.ppm").write_bytes(b"P6\n336 336\n255\n" + px.tobytes())
        return ["--model", str(d), "--image", str(d / "image.ppm")]
    if name == "whisper_stt":
        write_whisper(np, d, WHISPER_LAYERS_DEFAULT_RUN, bf16, "phase 22:")
        (d / "clip.wav").write_bytes(
            wav_bytes(speech_clip(np, 30.0, SEED + 172), 16000))
        return ["--model", str(d), "--audio", str(d / "clip.wav")]
    if name == "tts_speak":
        sys.path.insert(0, str(ROOT / "tests"))
        import torch_tts_sets as sets

        return ["--model", sets.write_piper_voice(str(d)), "--out",
                str(d / "out.wav")]
    return []


def phase22(torch, np, root: Path, layers: int, bf16, results) -> list:
    """Every port example through its main(argv), on the card, with every
    kernel counter at 0 just before and read just after; returns one
    row an example (module docstring)."""
    import contextlib
    import importlib
    import io
    import traceback

    from whisper_tensor_tpu_torch.milli import transforms

    say("phase 22: the port's examples on the card")
    sys.path.insert(0, str(EXAMPLES_DIR))
    rows = []
    for name, want, rises in EXAMPLE_RUNS:
        d = root / f"example-{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            argv = phase22_args(torch, np, name, d, layers, bf16)
            write_s = time.perf_counter() - t0
            mod = importlib.import_module(name)
            buf, wall = io.StringIO(), {}

            def run():
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    out = mod.main(argv)
                torch.cuda.synchronize()
                wall["s"] = time.perf_counter() - t0
                return out

            spy, qspy = RouteSpy(), quant_spy(transforms)
            torch.cuda.reset_peak_memory_stats()
            try:
                out, launches = counted(run, spy, qspy, f"phase 22 {name}",
                                        results, key="launches_phase22",
                                        attention=False)
            except (Exception, SystemExit):
                say(buf.getvalue()[-3000:])
                traceback.print_exc()
                fail(f"phase 22: {name} {' '.join(argv)} failed")
            finally:
                spy.restore()
                transforms.int8_matmul = qspy.inner
        finally:
            shutil.rmtree(d, ignore_errors=True)
        line = next((ln[:160] for ln in buf.getvalue().splitlines()
                     if want in ln), None)
        kern = {k: launches[k] for k in family_kernels()}
        row = {"example": name, "argv": argv, "device": out["device"],
               "seconds": round(wall["s"], 2),
               "inputs_written_s": round(write_s, 1),
               "peak_card_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                     2), "launches": kern, "line": line}
        say(f"  phase 22 {name}: exited without error on {out['device']} in "
            f"{wall['s']:.2f} s (inputs written in {write_s:.1f} s), peak "
            f"{row['peak_card_gb']} GB on the card, printed {line!r}; "
            f"kernel launches {kern}")
        if line is None:
            fail(f"phase 22: {name} did not print its line {want!r}")
        if not str(out["device"]).startswith("cuda"):
            fail(f"phase 22: {name} ran on {out['device']}, not the card")
        if any(kern[k] <= 0 for k in rises):
            fail(f"phase 22: {name} launched none of {rises}: {kern}")
        rows.append(row)
        free_memory(torch)
    return rows


# ---------------------------------------------------------------------------
# phase 23: the long-context path on one card (--long-context-only).
# Llama-3-8B's widths at LC_LAYERS layers (depth cut for host time only),
# int8 weights, a bf16 cache, B = 2 prompts that fill their bucket of S,
# max_len S + 512 (the JAX package's long-context bench, bench.py:804-877)
LC_LAYERS = 4
LC_SEQS = (8192, 16384)
LC_BATCH = 2
LC_NEW = 32               # greedy decode steps timed at pos ~ S
LC_EDGE = 128             # flash's held query rows at each end of a prompt
LC_BLOCK = 4096           # the 16k lm_head's rows a block, held and timed
LC_SHADOW_NEW = 8         # decode steps of the shadowed rerun


def flash_edges_shadow(lowering, plain, bound, edge: int):
    """Install, in the Attention lowering, a flash_attention that calls
    the one installed before and holds the first and the last `edge`
    query rows of each result against `plain` on those rows over every
    key (a pos-bound call: the slice starting at row r sees key j iff
    j <= pos + r + s), since the plain version's (B, H, Sq, Skv) f32
    scores of a whole long prompt do not fit the card. Returns it;
    `.inner` is the one it wraps, `.rows` the rows it held."""
    inner = lowering.flash_attention

    def checked(q, k, v, scale, **kw):
        got = inner(q, k, v, scale, **kw)
        Sq = q.shape[2]
        for r0 in sorted({0, max(Sq - edge, 0)}):
            r1 = min(r0 + edge, Sq)
            kw_r = dict(kw)
            if kw.get("pos_bound") is not None:
                kw_r["pos_bound"] = kw["pos_bound"] + r0
            elif kw.get("mask") is not None or kw.get("causal"):
                raise RuntimeError("flash_edges_shadow holds pos-bound "
                                   "calls only")
            qs = q[:, :, r0:r1]
            err, share = worst_share(
                got[:, :, r0:r1], plain(qs, k, v, scale, **kw_r),
                plain(qs, k, v.abs(), scale, **kw_r), bound)
            checked.worst = max(checked.worst, share)
            checked.max_err = max(checked.max_err, err)
            checked.rows += r1 - r0
        checked.calls += 1
        return got

    checked.inner, checked.calls, checked.worst, checked.max_err = \
        inner, 0, 0.0, 0.0
    checked.rows = 0
    lowering.flash_attention = checked
    return checked


def lc_kernels(torch, results) -> None:
    """(a) The kernels at the long-context path's new shapes, each held
    against its plain version and timed against its bound and the library
    call: flash_attention pos-bound over S + 512 keys at S 8,192 and
    16,384 (rows held at each end, LC_EDGE), decode_attention over 16,896
    slots at pos past 16,384, the full graph's 16k lm_head (int8_matmul at
    M 32,768 x N 128,256: 4.2e9 outputs, past 2^31) and the prefill's
    cache-write pair of 16,384 rows."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention, decode_attention_plain, decode_splits)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain,
        flash_splits)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, kv_write_pair_plain)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul, int8_matmul_plain)

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    B, Hq, Hkv, D = (LC_BATCH, WIDTHS["num_attention_heads"],
                     WIDTHS["num_key_value_heads"], 128)
    scale = 1.0 / math.sqrt(D)
    rows = {}
    for S in LC_SEQS:
        Skv = S + 512
        q = torch.randn(B, S, Hq, D, generator=gen,
                        device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn(B, Hkv, Skv, D, generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        lowering = types.SimpleNamespace(flash_attention=flash_attention)
        sh = flash_edges_shadow(lowering, flash_attention_plain,
                                flash_agreement_bound, LC_EDGE)
        lowering.flash_attention(q, k, v, scale, pos_bound=pos)

        def kernel():
            return flash_attention(q, k, v, scale, pos_bound=pos)

        def edges_plain():
            for r0 in (0, S - LC_EDGE):
                flash_attention_plain(q[:, :, r0:r0 + LC_EDGE], k, v, scale,
                                      pos_bound=pos + r0)

        ms = time_ms(torch, kernel, [()], reps=3, inner=2)
        dev_ms = device_time_ms(torch, kernel, [()], reps=3, inner=2)
        plain_ms = time_ms(torch, edges_plain, [()], reps=3, inner=1)
        dense = (torch.arange(Skv, device=dev)
                 <= torch.arange(S, device=dev)[:, None])[None, None]
        lib = sdpa_gqa(torch, q, k, v, dense, scale)
        try:
            lib_ms = time_ms(torch, lib, [()], reps=3, inner=1)
            lib_dev = device_time_ms(torch, lib, [()], reps=3, inner=1)
        except torch.cuda.OutOfMemoryError:
            lib_ms = lib_dev = float("nan")     # printed as such
        del dense, lib
        pairs = B * S * (S + 1) // 2
        bms, bby = bound(2 * B * Hq * S * D * 2 + B * S * Hkv * D * 2 * 2,
                         4 * D * Hq * pairs)
        splits, _ = flash_splits(B, Hq, Hkv, S, Skv, D, card)
        say(f"  flash_attention pos-bound B={B} Hq/Hkv={Hq}/{Hkv} Sq={S} "
            f"Skv={Skv} D={D} pos=0 ({splits} key splits): the first and "
            f"last {LC_EDGE} rows against the plain version: max_abs_err="
            f"{sh.max_err:.6g}, worst err/tol {sh.worst:.4g}; kernel "
            f"{ms:.4f} ms, device {dev_ms:.4f} ms "
            f"({4 * D * Hq * pairs / (dev_ms * 1e-3) / 1e12:.1f} TFLOP/s "
            f"over visible keys, {bms / dev_ms:.1%} of the bound), plain on "
            f"the {2 * LC_EDGE} held rows {plain_ms:.4f} ms, SDPA (a boolean "
            f"mask) {lib_ms:.4f} ms, device {lib_dev:.4f} (kernel/SDPA "
            f"{dev_ms / lib_dev:.2f}), bound {bms:.4f} ms ({bby})")
        if not sh.worst <= 1.0:
            fail(f"flash_attention at Sq={S} disagrees with its plain "
                 f"version on the held rows: err/tol {sh.worst}")
        rows[f"flash S={S}"] = {
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_rows": 2 * LC_EDGE, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "bound_ms": bms, "bound_by": bby,
            "max_abs_err": sh.max_err, "splits": splits}
        del q, k, v
        torch.cuda.empty_cache()

    # decode over the 16k sibling's cache, past 16,384 keys
    L = LC_SEQS[-1] + 512
    pos_list = [LC_SEQS[-1], L - 1]
    sets = []
    for _ in range(copies_for(2 * B * Hkv * L * D * 2)):
        sets.append((torch.randn(B, Hq, 1, D, generator=gen,
                                 device=dev).bfloat16(),
                     *(torch.randn(B, Hkv, L, D, generator=gen,
                                   device=dev).bfloat16() for _ in range(2)),
                     torch.tensor(pos_list, device=dev), scale))
    q, k, v, pos, _ = sets[0]
    err, share = worst_share(
        decode_attention(*sets[0]), decode_attention_plain(*sets[0]),
        decode_attention_plain(q.float(), k, v.abs(), pos, scale),
        agreement_bound)
    ms = time_ms(torch, decode_attention, sets)
    dev_ms = device_time_ms(torch, decode_attention, sets)
    plain_ms = time_ms(torch, decode_attention_plain, sets)
    live = torch.arange(L, device=dev) <= pos[:, None]
    calls = [(sdpa_gqa(torch, q, k, v, live[:, None, None, :], scale),)
             for q, k, v, _, _ in sets]
    lib_ms = time_ms(torch, lambda f: f(), calls)
    lib_dev = device_time_ms(torch, lambda f: f(), calls)
    n_live = int(live.sum())
    bms, bby = bound(2 * B * Hq * D * 2 + 2 * Hkv * n_live * D * 2,
                     4 * Hq * D * n_live)
    splits, chunk = decode_splits(B, Hq, Hkv, L, D, card)
    say(f"  decode_attention B={B} Hq/Hkv={Hq}/{Hkv} D={D} L={L} pos="
        f"{pos_list} ({splits} splits of {chunk} keys): max_abs_err="
        f"{err:.6g}, worst err/tol {share:.4g}; kernel {ms:.4f} ms, device "
        f"{dev_ms:.4f} ms ({bms / dev_ms:.1%} of the bound), plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, device {lib_dev:.4f} "
        f"(kernel/SDPA {dev_ms / lib_dev:.2f}), bound {bms:.4f} ms ({bby})")
    if not share <= 1.0:
        fail(f"decode_attention at L={L} disagrees with its plain version: "
             f"err/tol {share}")
    rows[f"decode L={L}"] = {
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "library_device_ms": lib_dev,
        "bound_ms": bms, "bound_by": bby, "max_abs_err": err,
        "splits": splits}
    del sets, calls, q, k, v, live
    torch.cuda.empty_cache()

    # the full graph's lm_head at S = 16,384: 4.2e9 outputs
    M, K, N = B * LC_SEQS[-1], WIDTHS["hidden_size"], WIDTHS["vocab_size"]
    x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, generator=gen, device=dev) * 1e-3 + 1e-4
    got = int8_matmul(x, w, s)
    ms = time_ms(torch, int8_matmul, [(x, w, s)], reps=3, inner=1)
    dev_ms = device_time_ms(torch, int8_matmul, [(x, w, s)], reps=3,
                            inner=1)
    worst, max_err = 0.0, 0.0
    for r0 in range(0, M, LC_BLOCK):
        xs = x[r0:r0 + LC_BLOCK]
        err, share = worst_share(got[r0:r0 + LC_BLOCK], int8_matmul_plain(
            xs, w, s), int8_matmul_plain(xs.float().abs(), w.abs(), s),
            agreement_bound)
        worst, max_err = max(worst, share), max(max_err, err)
    del got
    plain_ms = time_ms(torch, int8_matmul_plain, [(x, w, s)], reps=1,
                       inner=1)
    # the library call over the same rows, one call a block of the hold
    # (4,096 rows: 5.3e8 outputs each, under 2^31), after one warm call;
    # library_ms is the blocks' sum, the function over all M rows
    lib_ms = lib_block = None
    try:
        mm = torch.ops.aten._weight_int8pack_mm
        wt, sb = w.t().contiguous(), s.bfloat16()    # as int8pack_call
        mm(x[:LC_BLOCK], wt, sb)                     # a warm call
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for r0 in range(0, M, LC_BLOCK):
            mm(x[r0:r0 + LC_BLOCK], wt, sb)
        end.record()
        torch.cuda.synchronize()
        lib_ms = start.elapsed_time(end)
        lib_block = lib_ms / (M // LC_BLOCK)
        del wt, sb
        lib = (f"_weight_int8pack_mm {lib_ms:.4f} ms over {M // LC_BLOCK} "
               f"calls of {LC_BLOCK:,} rows ({lib_block:.4f} a call; "
               f"kernel/library {ms / lib_ms:.3f})")
    except (RuntimeError, NotImplementedError) as e:
        lib = (f"_weight_int8pack_mm raised: {type(e).__name__}: "
               f"{str(e)[:200]}")
    bms, bby = bound(M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N)
    say(f"  int8_matmul M={M} K={K} N={N} ({M * N / 2 ** 31:.2f} x 2^31 "
        f"outputs): max_abs_err={max_err:.6g}, worst err/tol {worst:.4g} "
        f"(row blocks of {LC_BLOCK:,} against the plain version); kernel "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms "
        f"({2 * M * K * N / (dev_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{bms / dev_ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
        f"{lib}, bound {bms:.4f} ms ({bby})")
    if not worst <= 1.0:
        fail(f"int8_matmul at M={M} N={N} disagrees with its plain version: "
             f"err/tol {worst}")
    rows[f"int8 lm_head M={M}"] = {
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "library_block_ms": lib_block,
        "library_calls": M // LC_BLOCK, "bound_ms": bms, "bound_by": bby,
        "max_abs_err": max_err}
    del x, w, s
    torch.cuda.empty_cache()

    # the prefill's cache-write pair: 16,384 rows into 16,896 slots
    S = LC_SEQS[-1]
    ck, cv = (torch.randn(B, Hkv, L, D, generator=gen, device=dev).bfloat16()
              for _ in range(2))
    uk, uv = (torch.randn(B, Hkv, S, D, generator=gen, device=dev).bfloat16()
              for _ in range(2))
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    want = kv_write_pair_plain(ck.clone(), uk, cv.clone(), uv, pos)
    got = kv_write_pair(ck, uk, cv, uv, pos)
    exact = all(torch.equal(g.view(torch.int16), w_.view(torch.int16))
                for g, w_ in zip(got, want))
    del want, got
    args = [(ck, uk, cv, uv, pos)]
    ms = time_ms(torch, kv_write_pair, args)
    plain_ms = time_ms(torch, kv_write_pair_plain, args)

    def two_copies(ck, uk, cv, uv, pos):
        ck[:, :, :S].copy_(uk)
        cv[:, :, :S].copy_(uv)

    lib_ms = time_ms(torch, two_copies, args)
    bms, bby = bound(2 * 2 * B * Hkv * S * D * 2, 0)
    say(f"  kv_write_pair B={B} H={Hkv} S={S} into L={L}: "
        f"{'bit for bit' if exact else 'DIFFERENT'} against the plain "
        f"version over both caches; kernel {ms:.4f} ms ({bms / ms:.1%} of "
        f"the bound), plain {plain_ms:.4f} ms, two slice copies "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({bby})")
    if not exact:
        fail("kv_write_pair at the 16k prefill is not its plain version's "
             "write")
    rows[f"kv pair S={S}"] = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bms,
                              "bound_by": bby, "max_abs_err": 0.0}
    del ck, cv, uk, uv
    torch.cuda.empty_cache()
    for name, key, source, replaces in (
            ("flash_attention", f"flash S={LC_SEQS[-1]}",
             "whisper_tensor_tpu_torch/csrc/flash_attention.cu",
             "whisper_tensor_tpu/backends/pallas/attention.py:175"),
            ("decode_attention", f"decode L={L}",
             "whisper_tensor_tpu_torch/csrc/decode_attention.cu",
             "whisper_tensor_tpu/backends/pallas/decode_attention.py:179"),
            ("int8_matmul", f"int8 lm_head M={M}",
             "whisper_tensor_tpu_torch/csrc/int8_matmul.cu",
             "whisper_tensor_tpu/backends/pallas/quant_matmul.py:68"),
            ("kv_write_pair", f"kv pair S={S}",
             "whisper_tensor_tpu_torch/csrc/kv_write.cu",
             "whisper_tensor_tpu/backends/pallas/kv_write.py:104")):
        r = rows[key]
        results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": key, "shapes": {k_: v_ for k_, v_ in rows.items()
                                     if k_.split()[0] == key.split()[0]}})


def lc_models(tensors: dict, S: int) -> dict:
    """{last_only: the llama recipe's Model at max_len S + 512}, both
    built from one weight getter (`tensors`, the checkpoint_tensors
    arrays), the weights kept out of the ONNX bytes (a sink) and put in
    each model's store."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import WeightStorage
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step)
    from whisper_tensor_tpu_torch.model import Model
    from whisper_tensor_tpu_torch.tensor import NumericTensor

    cfg = LlamaConfig(num_hidden_layers=LC_LAYERS, **WIDTHS)
    out = {}
    for last in (True, False):
        sink = {}
        model = Model.new_from_onnx(build_llama_step(
            tensors.__getitem__, cfg, max_len=S + 512, dtype=DType.BF16,
            storage=WeightStorage.to_sink(sink), logits_last_only=last))
        for name, val in sink.items():
            model.graph.store.put(name, NumericTensor(val))
        out[last] = model
    return out


def lc_interface(torch, model, S: int, shared=None):
    """A TextInferenceInterface over `model` (int8, a bf16 cache, the one
    bucket S, max_len S + 512), its weights uploaded: (interface, its
    constructor's s, the card bytes its upload added)."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)

    t0 = time.perf_counter()
    iface = TextInferenceInterface(
        model, S + 512, cache_dtype=DType.BF16,
        prompt_buckets=(S,), quantize="int8", quantize_precomputed=shared,
        device=CARD)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    iface._weights()
    torch.cuda.synchronize()
    return iface, build_s, torch.cuda.memory_allocated() - before


def lc_run(torch, np, iface, prompt, label: str, spy, qspy, results) -> dict:
    """One interface on `prompt`: TTFT (the median of 3 prefills), the
    rate of LC_NEW greedy decode steps from the prefill's caches at pos S
    (decode_tokens, the median of 3), the card's peak GB, and a counted
    run of the prefill and LC_NEW steps (every kernel's launches against
    the lowering's eligible calls)."""
    B, S = prompt.shape
    iface.generate_tokens(prompt, 2)      # the plans of both step shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    caches = iface.fresh_cache(B)
    ttft, dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        first = iface.generate_tokens(prompt, 1, caches=caches)[:, 0]
        torch.cuda.synchronize()
        ttft.append(time.perf_counter() - t0)
    for _ in range(3):
        t0 = time.perf_counter()
        iface.decode_tokens(first, S, caches, LC_NEW)
        dec.append(time.perf_counter() - t0)
    del caches
    toks, launches = counted(lambda: iface.generate_tokens(
        prompt, 1 + LC_NEW), spy, qspy, label, results,
        key="launches_phase23")
    out = {"ttft_ms": statistics.median(ttft) * 1e3,
           "step_ms": statistics.median(dec) * 1e3 / LC_NEW,
           "tok_s": B * LC_NEW / statistics.median(dec),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "tokens": toks}
    say(f"  {label}: TTFT {out['ttft_ms']:.1f} ms (3 runs "
        f"{', '.join(f'{t * 1e3:.1f}' for t in ttft)}), {LC_NEW} decode "
        f"steps at pos {S}+ {out['step_ms']:.2f} ms a step, "
        f"{out['tok_s']:.1f} tok/s ({B} rows), peak {out['peak_gb']:.2f} "
        f"GB on the card")
    return out


def phase23(torch, np, results) -> dict:
    """Phase 23 (--long-context-only): (a) lc_kernels; (b) Llama-3-8B
    widths at LC_LAYERS layers built twice from one getter, with
    logits_last_only=True and without, at S 8,192 and 16,384 (max_len
    S + 512, B 2, the bucket S, int8 shared: the first interface's
    `_quantized` serves the other three as quantize_precomputed). For
    each S and graph that fits: TTFT, decode rate, peak card GB, the
    kernels' launches; the 16k sibling's constructor s and the card bytes
    its upload added; the last-only and full graphs' greedy tokens equal
    at 8,192; a profiled 16k prefill; a shadowed rerun at 16,384; a
    shorter prompt refused."""
    from whisper_tensor_tpu_torch.milli import transforms

    lc_kernels(torch, results)
    out = {"card": card_line(), "runs": {}}
    spy, qspy = RouteSpy(), quant_spy(transforms)
    try:
        t0 = time.perf_counter()
        tensors = dict(checkpoint_tensors(LC_LAYERS, np))
        say(f"phase 23: {LC_LAYERS}-layer Llama-3-8B-width weights made "
            f"in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(SEED + 23)
        shared, first, ifaces = None, None, {}
        for S in LC_SEQS:
            prompt = rng.integers(3, BYTE_VOCAB, (LC_BATCH, S)
                                  ).astype(np.int64)
            t0 = time.perf_counter()
            models = lc_models(tensors, S)
            say(f"  S={S}: both graphs built in "
                f"{time.perf_counter() - t0:.1f} s; host RSS "
                f"{host_rss_gb():.1f} GB")
            for last in (True, False):
                label = f"S={S} {'last-only' if last else 'full'}"
                try:
                    iface, build_s, up = lc_interface(torch, models[last], S,
                                                      shared)
                    if shared is None:
                        shared, first = iface._quantized, iface
                    how = ("quantized" if iface is first else
                           "the int8 weights taken from the first interface")
                    say(f"  {label}: built in {build_s:.1f} s ({how}), its "
                        f"upload added {up / 1e9:.3f} GB to the card")
                    if iface is not first:
                        mine, theirs = iface._weights(), first._weights()
                        names = [n for q in first._quantized
                                 for n in (q, q + "::scale")]
                        if not all(mine[n].data_ptr() == theirs[n].data_ptr()
                                   for n in names):
                            fail(f"{label}: an int8 weight is not the first "
                                 f"interface's device tensor")
                    if iface.logits_last_only != last:
                        fail(f"{label}: the interface misreads the graph's "
                             f"logits")
                    run = lc_run(torch, np, iface, prompt, label, spy, qspy,
                                 results)
                    cache_gb = sum(c.numel() * c.element_size() for c in
                                   iface.fresh_cache(LC_BATCH)) / 1e9
                    run.update(build_s=build_s, upload_gb=up / 1e9,
                               cache_gb=cache_gb)
                    out["runs"][label] = run
                    ifaces[S, last] = iface
                except torch.cuda.OutOfMemoryError as e:
                    say(f"  {label}: does not fit the card: "
                        f"{str(e).splitlines()[0][:160]}")
                    out["runs"][label] = {"oom": True}
                    iface = None
                    free_memory(torch)
            del models
        del tensors
        S = LC_SEQS[0]
        a, b = (out["runs"][f"S={S} {k}"] for k in ("last-only", "full"))
        if "oom" in a or "oom" in b:
            fail(f"S={S}: a graph did not fit the card")
        if not np.array_equal(a["tokens"], b["tokens"]):
            fail(f"S={S}: the last-only graph's greedy tokens "
                 f"{a['tokens'][:, :8]} are not the full graph's "
                 f"{b['tokens'][:, :8]}")
        say(f"  S={S}: the last-only and full graphs give equal greedy "
            f"tokens ({1 + LC_NEW} a row); the full graph's extra: "
            f"{b['ttft_ms'] - a['ttft_ms']:.1f} ms of TTFT, "
            f"{b['peak_gb'] - a['peak_gb']:.2f} GB of peak")
        S = LC_SEQS[-1]
        sib = ifaces[S, True]
        r = out["runs"][f"S={S} last-only"]
        first_s = out["runs"][f"S={LC_SEQS[0]} last-only"]["build_s"]
        int8_gb = sum(t.numel() * t.element_size()
                      for n, t in first._weights().items()
                      if n in first._quantized or n.endswith("::scale")) / 1e9
        out["int8_gb"] = int8_gb
        say(f"  the S={S} sibling: built in {r['build_s']:.1f} s against the "
            f"first's {first_s:.1f} s; its upload added {r['upload_gb']:.3f} "
            f"GB (the int8 set, {int8_gb:.3f} GB, shared), its caches take "
            f"{r['cache_gb']:.3f} GB")
        prompt = rng.integers(3, BYTE_VOCAB, (LC_BATCH, S)).astype(np.int64)
        t0 = time.perf_counter()
        text, parts = step_profile(torch, lambda: sib.generate_tokens(
            prompt, 1))
        out["prefill_profile"] = dict(parts, wall_ms=(
            time.perf_counter() - t0) * 1e3)
        say(f"  S={S} last-only, one prefill under torch.profiler "
            f"({out['prefill_profile']['wall_ms']:.1f} ms wall with the "
            f"profiler): {text}")
        sh = Shadows()
        full = sh.att.flash_attention
        sh.att.flash_attention = full.inner
        from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
            flash_agreement_bound, flash_attention_plain)
        sh.sh["flash_attention"] = edges = flash_edges_shadow(
            sh.att, flash_attention_plain, flash_agreement_bound, LC_EDGE)
        try:
            sib.generate_tokens(prompt, 1 + LC_SHADOW_NEW)
        finally:
            sh.close(f"S={S} last-only, shadowed (flash: {edges.rows} "
                     f"held rows)", r["launches"])
        try:
            sib.generate_tokens(prompt[:, :S - 1], 2)
            fail("a prompt shorter than its bucket was not refused by the "
                 "last-only graph")
        except ValueError as e:
            if "logits_last_only" not in str(e):
                raise
            say(f"  a {S - 1}-token prompt in the bucket of {S}: "
                f"refused ({str(e)[:80]}...)")
    finally:
        spy.restore()
        transforms.int8_matmul = qspy.inner
    for run in out["runs"].values():
        run.pop("tokens", None)
    return out


# ---------------------------------------------------------------------------
# phase 24: windowed decode on one card (--windows-only). Llama-3-8B's
# published widths (WIDTHS) at WIN_LAYERS layers (depth cut for host
# time only), int8 weights, a bf16 cache, seeded weights (write_checkpoint)
WIN_LAYERS = 4
WIN_MAX_LEN = 16384          # (a), (c), (d): the flat interface's cache
WIN_WINDOWS = (256, 1024)    # the loader option decode_windows=256,1024
WIN_BATCH, WIN_PROMPT, WIN_NEW = 8, 100, 200
# (b): bench.py:544-562's serving arm, pos_per_row graphs at max_len
# 8,192 and bucket-sized window graphs for the admission
WIN_SERVE_LEN = 8192
WIN_BUCKETS = (16, 32, 64, 128, 256, 512)
WIN_REQUESTS, WIN_SERVE_NEW = 16, 32
WIN_TEXT = "The capital of France is"


def win_kernels(torch, results) -> None:
    """(e) The five kernels at the windowed path's shapes, each held
    against its plain version on the same inputs and timed beside its
    bound and a library call: flash_attention pos-bound as the prefill
    inside the first window (B 8 x 128 rows over 256 keys), decode_attention
    over the 256 and 1,024 windows and, at the same positions, over the
    flat interface's 16,384 slots, int8_matmul and packed_matmul (Q4_K)
    at B 8 on the fused gate/up shape, the decode step's cache-write
    pair into a 1,024 window (bit for bit) and an admission's pair of 16
    rows x 512 (a bucket-512 window's caches), ragged_kv_write at the
    decode shape."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.decode_attention import (
        decode_attention, decode_attention_plain, decode_splits)
    from whisper_tensor_tpu_torch.backends.cuda.flash_attention import (
        flash_agreement_bound, flash_attention, flash_attention_plain,
        flash_splits)
    from whisper_tensor_tpu_torch.backends.cuda.kv_write import (
        kv_write_pair, kv_write_pair_plain, ragged_kv_write,
        ragged_kv_write_plain)
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul, packed_matmul_plain)
    from whisper_tensor_tpu_torch.backends.cuda.quant_matmul import (
        int8_matmul, int8_matmul_plain)

    dev = torch.device("cuda")
    card = torch.cuda.current_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    B, Hq, Hkv, D = (WIN_BATCH, WIDTHS["num_attention_heads"],
                     WIDTHS["num_key_value_heads"], 128)
    scale = 1.0 / math.sqrt(D)
    rows = {}
    say("phase 24 (e): the kernels at the windowed path's shapes "
        "(tolerance per element: agreement_bound, flash_agreement_bound; "
        "the writes bit for bit)")

    # the prefill inside the first window: 128 rows (the bucket of a
    # 100-token prompt) over the 256 window's keys
    Sq, Skv = 128, WIN_WINDOWS[0]
    sets = []
    for _ in range(copies_for(2 * B * Hkv * Skv * D * 2)):
        sets.append((torch.randn(B, Sq, Hq, D, generator=gen,
                                 device=dev).bfloat16().transpose(1, 2),
                     *(torch.randn(B, Hkv, Skv, D, generator=gen,
                                   device=dev).bfloat16() for _ in range(2)),
                     torch.zeros((), dtype=torch.int64, device=dev)))

    def flash(q, k, v, pos):
        return flash_attention(q, k, v, scale, pos_bound=pos)

    def flash_plain(q, k, v, pos):
        return flash_attention_plain(q, k, v, scale, pos_bound=pos)

    q, k, v, pos = sets[0]
    err, share = worst_share(flash(*sets[0]), flash_plain(*sets[0]),
                             flash_attention_plain(q, k, v.abs(), scale,
                                                   pos_bound=pos),
                             flash_agreement_bound)
    ms = time_ms(torch, flash, sets)
    plain_ms = time_ms(torch, flash_plain, sets)
    dense = (torch.arange(Skv, device=dev)
             <= torch.arange(Sq, device=dev)[:, None])[None, None]
    libs = [(sdpa_gqa(torch, q_, k_, v_, dense, scale),)
            for q_, k_, v_, _ in sets]
    lib_ms = time_ms(torch, lambda f: f(), libs)
    pairs, kv_bytes = flash_work(torch, "pos", B, Hq, Hkv, Sq, Skv, D,
                                 {"pos_bound": pos})
    bms, bby = bound(2 * B * Hq * Sq * D * 2 + kv_bytes, 4 * D * Hq * pairs)
    splits, _ = flash_splits(B, Hq, Hkv, Sq, Skv, D, card)
    say(f"  flash_attention pos-bound B={B} Hq/Hkv={Hq}/{Hkv} Sq={Sq} "
        f"Skv={Skv} D={D} ({splits} key splits): max_abs_err={err:.6g}, "
        f"worst err/tol {share:.4g}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA (a boolean mask) {lib_ms:.4f} ms, bound "
        f"{bms:.5f} ms ({bby})")
    if not share <= 1.0:
        fail(f"flash_attention at the first window's prefill disagrees with "
             f"its plain version: err/tol {share}")
    rows["flash_attention"] = dict(
        shape=f"pos-bound B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D}",
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=bby, max_abs_err=err)
    del sets, libs, q, k, v, dense
    torch.cuda.empty_cache()

    # decode in each window, the rows at positions inside the window,
    # and at the same positions in the flat interface's 16,384 slots
    # (decode_splits cuts keys by the cache's length)
    shapes = {}
    for L in WIN_WINDOWS + (WIN_MAX_LEN,):
        pos_list = [min(L - 1, WIN_PROMPT + 37 * b) for b in range(B)]
        sets = []
        for _ in range(copies_for(2 * B * Hkv * L * D * 2)):
            sets.append((torch.randn(B, Hq, 1, D, generator=gen,
                                     device=dev).bfloat16(),
                         *(torch.randn(B, Hkv, L, D, generator=gen,
                                       device=dev).bfloat16()
                           for _ in range(2)),
                         torch.tensor(pos_list, device=dev), scale))
        q, k, v, pos, _ = sets[0]
        err, share = worst_share(
            decode_attention(*sets[0]), decode_attention_plain(*sets[0]),
            decode_attention_plain(q.float(), k, v.abs(), pos, scale),
            agreement_bound)
        ms = time_ms(torch, decode_attention, sets)
        plain_ms = time_ms(torch, decode_attention_plain, sets)
        live = torch.arange(L, device=dev) <= pos[:, None]
        libs = [(sdpa_gqa(torch, q_, k_, v_, live[:, None, None, :],
                          scale),) for q_, k_, v_, _, _ in sets]
        lib_ms = time_ms(torch, lambda f: f(), libs)
        n_live = int(live.sum())
        bms, bby = bound(2 * B * Hq * D * 2 + 2 * Hkv * n_live * D * 2,
                         4 * Hq * D * n_live)
        splits, chunk = decode_splits(B, Hq, Hkv, L, D, card)
        say(f"  decode_attention B={B} Hq/Hkv={Hq}/{Hkv} D={D} L={L} "
            f"pos={pos_list} ({splits} splits of {chunk} keys): "
            f"max_abs_err={err:.6g}, worst err/tol {share:.4g}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {bms:.5f} ms ({bby})")
        if not share <= 1.0:
            fail(f"decode_attention over {L} slots disagrees with its "
                 f"plain version: err/tol {share}")
        shapes[f"L={L}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bms, bound_by=bby,
                                max_abs_err=err, splits=splits)
        del sets, libs, q, k, v, live
        torch.cuda.empty_cache()
    rows["decode_attention"] = dict(
        shapes[f"L={WIN_WINDOWS[-1]}"], shapes=shapes,
        shape=f"B={B} Hq={Hq} Hkv={Hkv} D={D} L={WIN_WINDOWS[-1]}")

    # the products at B 8 on the fused gate/up shape
    K, N = WIDTHS["hidden_size"], 2 * WIDTHS["intermediate_size"]
    sets = [(torch.randn(B, K, generator=gen, device=dev).bfloat16(),
             torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                           dtype=torch.int8),
             torch.rand(N, generator=gen, device=dev) * 1e-3 + 1e-4)
            for _ in range(copies_for(K * N))]
    x, w, s = sets[0]
    err, share = worst_share(int8_matmul(x, w, s), int8_matmul_plain(x, w, s),
                             int8_matmul_plain(x.float().abs(), w.abs(), s),
                             agreement_bound)
    ms = time_ms(torch, int8_matmul, sets)
    plain_ms = time_ms(torch, int8_matmul_plain, sets)
    try:
        libs = [(int8pack_call(torch, *a),) for a in sets]
        lib_ms = time_ms(torch, lambda f: f(), libs)
        del libs
    except (RuntimeError, NotImplementedError):
        lib_ms = None
    bms, bby = bound(B * K * 2 + K * N + N * 4 + B * N * 2, 2 * B * K * N)
    say(f"  int8_matmul M={B} K={K} N={N}: max_abs_err={err:.6g}, worst "
        f"err/tol {share:.4g}; kernel {ms:.4f} ms ({bms / ms:.1%} of the "
        f"bound), plain {plain_ms:.4f} ms, _weight_int8pack_mm {lib_ms} ms, "
        f"bound {bms:.5f} ms ({bby})")
    if not share <= 1.0:
        fail(f"int8_matmul at M={B} disagrees with its plain version")
    rows["int8_matmul"] = dict(shape=f"M={B} K={K} N={N}", ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bms, bound_by=bby, max_abs_err=err)
    del sets, x, w, s
    sets = [(torch.randn(B, K, generator=gen, device=dev).bfloat16(),
             *random_packed(torch, gen, 4, 32, True, K, N), 4, True)
            for _ in range(copies_for(K * N // 2))]
    x, q, s, o, bits, has_off = sets[0]
    err, share = worst_share(
        packed_matmul(*sets[0]), packed_matmul_plain(*sets[0]),
        packed_magnitude(torch, x, q, s, o, bits, has_off), agreement_bound)
    ms = time_ms(torch, packed_matmul, sets)
    plain_ms = time_ms(torch, packed_matmul_plain, sets)
    try:
        libs = [(int4pack_call(torch, a[0], a[1], a[2], a[3], 32),)
                for a in sets]
        lib_ms = time_ms(torch, lambda f: f(), libs)
        del libs
    except (RuntimeError, NotImplementedError):
        lib_ms = None
    bms, bby = bound(B * K * 2 + K * N // 2 + 2 * (K // 32) * N * 4
                     + B * N * 2, 2 * B * K * N)
    say(f"  packed_matmul Q4_K layout (bits 4, groups of 32, offsets) M={B} "
        f"K={K} N={N}: max_abs_err={err:.6g}, worst err/tol {share:.4g}; "
        f"kernel {ms:.4f} ms ({bms / ms:.1%} of the bound), plain "
        f"{plain_ms:.4f} ms, _weight_int4pack_mm {lib_ms} ms, bound "
        f"{bms:.5f} ms ({bby})")
    if not share <= 1.0:
        fail(f"packed_matmul at M={B} disagrees with its plain version")
    rows["packed_matmul"] = dict(shape=f"Q4_K M={B} K={K} N={N}", ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bms, bound_by=bby,
                                 max_abs_err=err)
    del sets, x, q, s, o
    torch.cuda.empty_cache()

    # the cache writes: a decode step's pair into the 1,024 window (the
    # direct path's scalar start), an admission's 16 rows x 512 into a
    # bucket window (per-row starts), one cache at the decode shape
    L = WIN_WINDOWS[-1]
    for label, k_, S, Lc, start in (
            ("decode pair", B, 1, L,
             torch.tensor(WIN_PROMPT + 57, device=dev)),
            ("admission pair", WIN_REQUESTS, 512, 512,
             torch.zeros(WIN_REQUESTS, dtype=torch.int64, device=dev))):
        sets = [tuple(torch.randn(k_, Hkv, n, D, generator=gen,
                                  device=dev).bfloat16()
                      for n in (Lc, S, Lc, S)) + (start,)
                for _ in range(copies_for(2 * k_ * Hkv * Lc * D * 2))]
        ck, uk, cv, uv, pos = sets[0]
        want = kv_write_pair_plain(ck.clone(), uk, cv.clone(), uv, pos)
        got = kv_write_pair(ck, uk, cv, uv, pos)
        exact = all(torch.equal(g.view(torch.int16), w_.view(torch.int16))
                    for g, w_ in zip(got, want))
        del want, got
        ms = time_ms(torch, kv_write_pair, sets)
        plain_ms = time_ms(torch, kv_write_pair_plain, sets)
        p0 = int(start.reshape(-1)[0])

        def two_copies(ck, uk, cv, uv, pos, p0=p0, S=S):
            ck[:, :, p0:p0 + S].copy_(uk)
            cv[:, :, p0:p0 + S].copy_(uv)

        lib_ms = time_ms(torch, two_copies, sets)
        bms, bby = bound(2 * 2 * k_ * Hkv * S * D * 2, 0)
        say(f"  kv_write_pair {label} B={k_} H={Hkv} S={S} into L={Lc}: "
            f"{'bit for bit' if exact else 'DIFFERENT'} against the plain "
            f"version over both caches; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, two slice copies {lib_ms:.4f} ms, bound "
            f"{bms:.5f} ms ({bby})")
        if not exact:
            fail(f"kv_write_pair ({label}) is not its plain version's write")
        rows.setdefault("kv_write_pair", dict(
            shape=f"{label} B={k_} H={Hkv} S={S} L={Lc}", ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
            bound_by=bby, max_abs_err=0.0, shapes={}))
        rows["kv_write_pair"]["shapes"][label] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms)
        del sets, ck, uk, cv, uv
        torch.cuda.empty_cache()
    sets = [(torch.randn(B, Hkv, L, D, generator=gen, device=dev).bfloat16(),
             torch.randn(B, Hkv, 1, D, generator=gen, device=dev).bfloat16(),
             torch.tensor([WIN_PROMPT + 7 * b for b in range(B)],
                          device=dev))
            for _ in range(copies_for(B * Hkv * L * D * 2))]
    c, u, pos = sets[0]
    exact = torch.equal(ragged_kv_write(c.clone(), u, pos).view(torch.int16),
                        ragged_kv_write_plain(c.clone(), u, pos).view(
                            torch.int16))
    ms = time_ms(torch, ragged_kv_write, sets)
    plain_ms = time_ms(torch, ragged_kv_write_plain, sets)
    # the library call: one scatter_ along the cache axis, its index
    # (B, H, 1, D) built first (the positions are inside the window)
    lsets = [(c_, p_[:, None, None, None].expand(B, Hkv, 1, D).contiguous(),
              u_) for c_, u_, p_ in sets]
    lib_ms = time_ms(torch, lambda c_, i_, u_: c_.scatter_(2, i_, u_),
                     lsets)
    bms, bby = bound(2 * B * Hkv * D * 2, 0)
    say(f"  ragged_kv_write B={B} H={Hkv} S=1 into L={L}: "
        f"{'bit for bit' if exact else 'DIFFERENT'}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, scatter_ {lib_ms:.4f} ms, bound "
        f"{bms:.5f} ms ({bby})")
    if not exact:
        fail("ragged_kv_write at the window's decode shape is not its plain "
             "version's write")
    rows["ragged_kv_write"] = dict(
        shape=f"B={B} H={Hkv} S=1 L={L}", ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=bby, max_abs_err=0.0)
    del sets, lsets, c, u
    torch.cuda.empty_cache()
    sources = {
        "flash_attention": ("flash_attention.cu",
                            "backends/pallas/attention.py:175"),
        "decode_attention": ("decode_attention.cu",
                             "backends/pallas/decode_attention.py:179"),
        "int8_matmul": ("int8_matmul.cu",
                        "backends/pallas/quant_matmul.py:68"),
        "packed_matmul": ("packed_matmul.cu",
                          "backends/pallas/packed_matmul.py:278"),
        "kv_write_pair": ("kv_write.cu", "backends/pallas/kv_write.py:104"),
        "ragged_kv_write": ("kv_write.cu",
                            "backends/pallas/kv_write.py:104")}
    for name, (src, rep) in sources.items():
        results.append({"name": name, "route": "cuda",
                        "source": "whisper_tensor_tpu_torch/csrc/" + src,
                        "replaces": "whisper_tensor_tpu/" + rep,
                        "launches": None, **rows[name]})


def win_agree(torch, np, what: str, flat, prompt, got, want) -> dict:
    """Windowed greedy tokens `got` against the flat interface's `want`,
    row by row. The kernels split a row's keys by the cache's length
    (decode_splits, flash_splits), so the windowed and the flat decode
    add the same terms in different orders and round apart in bf16; they
    can pick different tokens where two logits nearly tie. So, as
    spec_agreement holds speculative decoding: the tokens equal up to
    each row's first difference, where the flat run (its per-step
    logits) must rate the windowed token within twice the decode bound
    (1.5% of max|logit| per sqrt(layer)) of its own pick; and every
    windowed token must stand a teacher-forced prefill over prompt and
    answer through the flat interface (its logit within the bound of
    the step's largest). A window graph that read or wrote the caches
    at a wrong place breaks both. Returns the readings."""
    frac = 0.015 * math.sqrt(WIN_LAYERS)
    first = []
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        first.append(int(diff[0]) if diff.size else got.shape[1])
    out = {"equal": sum(f == got.shape[1] for f in first),
           "rows": got.shape[0], "first": first, "tie": 0.0,
           "teacher": 0.0}
    if out["equal"] != out["rows"]:
        _, logits = flat.generate_with_logits(prompt, got.shape[1])
        for b, i in enumerate(first):
            if i < got.shape[1]:
                row = logits[b, i]
                out["tie"] = max(out["tie"], float(
                    row[want[b, i]] - row[got[b, i]]) / (
                    2 * frac * float(np.abs(logits[b]).max())))
        del logits
    for b in range(got.shape[0]):
        gaps, scale = teacher_gaps(torch, np, flat, prompt[b], got[b])
        out["teacher"] = max(out["teacher"],
                             float(gaps.max()) / (frac * scale))
    say(f"  {what}: windowed tokens equal to the flat interface's in "
        f"{out['equal']} of {out['rows']} rows ({got.shape[1]} tokens a "
        f"row; each row's first difference at {first}); at the first "
        f"difference the flat run's margin over the windowed token "
        f"{out['tie']:.4g} of its bound (2 x {frac:.1%} of max|logit|); "
        f"against teacher-forced prefills worst {out['teacher']:.4g} of "
        f"the bound ({frac:.1%})")
    if not (out["tie"] <= 1.0 and out["teacher"] <= 1.0):
        fail(f"{what}: windowed greedy tokens part from the flat decode "
             f"away from a near tie, or do not stand a teacher-forced "
             f"prefill")
    return out


def win_run(torch, np, iface, prompt, n_new: int, label: str, spy, qspy,
            results) -> dict:
    """One interface on `prompt`: a warm run (every step graph's plan),
    TTFT (the median of 3 runs of generate_tokens(prompt, 1)), 3 timed
    runs of n_new tokens (decode ms a step: their median less the TTFT
    over n_new - 1 steps) with the card's peak GB above what was
    allocated before them, then a counted run (every kernel's launches
    against the lowering's eligible calls)."""
    iface.generate_tokens(prompt, n_new)
    ttft, totals = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        iface.generate_tokens(prompt, 1)
        ttft.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        toks = iface.generate_tokens(prompt, n_new)
        totals.append(time.perf_counter() - t0)
    total = statistics.median(totals)
    peak = torch.cuda.max_memory_allocated()
    _, launches = counted(lambda: iface.generate_tokens(prompt, n_new), spy,
                          qspy, label, results, key="launches_phase24")
    out = {"ttft_ms": statistics.median(ttft) * 1e3,
           "step_ms": (total - statistics.median(ttft)) * 1e3
           / max(n_new - 1, 1),
           "tok_s": prompt.shape[0] * n_new / total,
           "peak_gb": peak / 1e9, "peak_above_gb": (peak - base) / 1e9,
           "launches": launches, "tokens": toks}
    say(f"  {label}: TTFT {out['ttft_ms']:.1f} ms (3 runs "
        f"{', '.join(f'{t * 1e3:.1f}' for t in ttft)}), decode "
        f"{out['step_ms']:.2f} ms a step (runs of {n_new} tokens "
        f"{', '.join(f'{t * 1e3:.1f}' for t in totals)} ms), "
        f"{out['tok_s']:.1f} tok/s "
        f"({prompt.shape[0]} rows x {n_new}); peak {out['peak_gb']:.3f} GB "
        f"on the card, {out['peak_above_gb']:.3f} GB above the "
        f"{base / 1e9:.3f} GB allocated before the run")
    return out


def win_models(bundle) -> tuple:
    """(the text spec's main Model, {window: Model}) of a bundle."""
    spec = bundle.interfaces["text"]
    wins = {int(w): bundle.models[m] for w, m in spec["windows"].items()}
    return bundle.models[spec["model"]], wins


def window_plan_bytes(iface) -> int:
    """Card bytes the window executors hold in their plans (their
    graphs' folded constants)."""
    return sum(c.numel() * c.element_size()
               for ex in iface._window_exec.values()
               for plan in ex._plans.values() for c in plan.consts.values())


def phase24_direct(torch, np, ckpt: Path, results) -> dict:
    """(a) The direct path through the transformers loader with
    decode_windows=256,1024 at max_len 16,384: the windowed interface and
    a flat one on the same int8 weights (it takes the windowed one's
    device tensors, share_weights), B 8 prompts of 100 tokens, 200 greedy
    tokens: tokens (win_agree), TTFT, decode ms a step, peak card GB, the
    card bytes
    each upload added, launches; then a rerun with every kernel call held
    against its plain version (Shadows)."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import loader_registry
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.milli import transforms

    out = {"card": card_line()}
    t0 = time.perf_counter()
    bundle = loader_registry()["transformers"].load({
        "path": str(ckpt), "dtype": "bf16", "max_len": WIN_MAX_LEN,
        "quantize": "int8",
        "decode_windows": ",".join(map(str, WIN_WINDOWS))})
    main, wins = win_models(bundle)
    out["load_s"] = time.perf_counter() - t0
    say(f"phase 24 (a): the transformers loader with decode_windows="
        f"{','.join(map(str, WIN_WINDOWS))} at max_len {WIN_MAX_LEN}: "
        f"{out['load_s']:.1f} s, windows {sorted(wins)}; host RSS "
        f"{host_rss_gb():.1f} GB")
    if sorted(wins) != list(WIN_WINDOWS):
        fail(f"decode_windows built the windows {sorted(wins)}")
    kw = dict(cache_dtype=DType.BF16, quantize="int8", device=CARD)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    win = TextInferenceInterface(main, WIN_MAX_LEN, window_models=wins, **kw)
    win._weights()
    torch.cuda.synchronize()
    out["windowed_build_s"] = time.perf_counter() - t0
    out["windowed_upload_gb"] = (torch.cuda.memory_allocated()
                                 - before) / 1e9
    before = torch.cuda.memory_allocated()
    flat = TextInferenceInterface(main, WIN_MAX_LEN,
                                  quantize_precomputed=win._quantized, **kw)
    flat.share_weights(win)
    torch.cuda.synchronize()
    out["flat_upload_gb"] = (torch.cuda.memory_allocated() - before) / 1e9
    mine, theirs = win._weights(), flat._weights()
    out["flat_set_gb"] = sum(t.numel() * t.element_size()
                             for t in theirs.values()) / 1e9
    rope = [n for n in mine if n.startswith("rope_")]
    out["rope_gb"] = sum(mine[n].numel() * mine[n].element_size()
                         for n in rope) / 1e9
    shared = all(mine[n].data_ptr() == theirs[n].data_ptr() for n in mine)
    say(f"  the windowed interface: built and uploaded in "
        f"{out['windowed_build_s']:.1f} s, its upload added "
        f"{out['windowed_upload_gb']:.4f} GB to the card; the flat "
        f"interface's weight set {out['flat_set_gb']:.4f} GB (its rope "
        f"tables {out['rope_gb']:.4f} GB, {rope}), its upload added "
        f"{out['flat_upload_gb']:.4f} GB (every weight the windowed one's "
        f"device tensor: {shared})")
    if (sorted(mine) != sorted(theirs) or not shared
            or out["windowed_upload_gb"] > out["flat_set_gb"]
            + out["rope_gb"] + 1e-3):
        fail("the windowed interface uploaded more than the flat "
             "interface's weight set, or the two do not share it")
    rng = np.random.default_rng(SEED + 24)
    prompt = rng.integers(3, BYTE_VOCAB, (WIN_BATCH, WIN_PROMPT)).astype(
        np.int64)
    spy, qspy = RouteSpy(), quant_spy(transforms)
    try:
        runs = {}
        for label, iface in (("windowed", win), ("flat", flat)):
            runs[label] = win_run(torch, np, iface, prompt, WIN_NEW,
                                  f"(a) {label}", spy, qspy, results)
            free_memory(torch)
        out["window_plan_gb"] = window_plan_bytes(win) / 1e9
        say(f"  the window executors' plans hold "
            f"{out['window_plan_gb'] * 1e3:.3f} MB of folded constants")
        out["agree"] = win_agree(torch, np, "(a)", flat, prompt,
                                 runs["windowed"]["tokens"],
                                 runs["flat"]["tokens"])
        sh = Shadows()
        try:
            win.generate_tokens(prompt, WIN_NEW)
        finally:
            sh.close("(a) windowed, shadowed", runs["windowed"]["launches"])
        out["shadowed_calls"] = {n: s.calls for n, s in sh.sh.items()}
    finally:
        spy.restore()
        transforms.int8_matmul = qspy.inner
    for label, r in runs.items():
        out[label] = {k: v for k, v in r.items() if k != "tokens"}
    w, f = runs["windowed"], runs["flat"]
    say(f"  (a) windowed against flat: peak {w['peak_gb']:.3f} against "
        f"{f['peak_gb']:.3f} GB ({w['peak_above_gb']:.3f} against "
        f"{f['peak_above_gb']:.3f} GB above the weights), TTFT "
        f"{w['ttft_ms']:.1f} against {f['ttft_ms']:.1f} ms, decode "
        f"{w['step_ms']:.2f} against {f['step_ms']:.2f} ms a step on "
        f"{card_line()}")
    out["text"] = win.generate_tokens(
        np.frombuffer(WIN_TEXT.encode(), np.uint8).astype(np.int64)[None]
        + 3, WIN_SERVE_NEW)[0].tolist()
    del win, flat, bundle, main, wins
    free_memory(torch)
    return out


def serve_window_models(ckpt: Path, buckets) -> dict:
    """bench.py:544-562's bucket windows: the llama recipe at max_len =
    each bucket under max_len, pos_per_row, structure-only (zeros from
    the checkpoint's headers), sharing no store yet."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.onnx_builder import WeightStorage
    from whisper_tensor_tpu_torch.importers.recipes.llm.llama import (
        LlamaConfig, build_llama_step)
    from whisper_tensor_tpu_torch.importers.safetensors_io import (
        SafetensorsStore)
    from whisper_tensor_tpu_torch.model import Model

    cfg = LlamaConfig(num_hidden_layers=WIN_LAYERS, **WIDTHS)
    zeros = SafetensorsStore.from_dir(str(ckpt)).zeros_getter()
    return {b: Model.new_from_onnx(build_llama_step(
        zeros, cfg, max_len=b, dtype=DType.BF16, pos_per_row=True,
        storage=WeightStorage.none()), name=f"llama-w{b}")
        for b in buckets if b < WIN_SERVE_LEN}


def serve_batch(torch, np, iface, prompts, label: str, spy, qspy,
                results) -> dict:
    """The prompts through a ContinuousBatcher over `iface` (16 slots,
    one admission of all after a warm request): answers, tok/s, the
    card's peak GB above the weights and slot caches, launches."""
    from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher

    bat = ContinuousBatcher(None, max_len=WIN_SERVE_LEN,
                            max_batch=WIN_REQUESTS, chunk=16, iface=iface,
                            max_admit=64).start()
    try:
        bat.submit(prompts[0], 4).result(timeout=900)   # slot caches, plans
        for p in prompts:                               # every bucket's plan
            bat.submit(p, 2).result(timeout=900)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def run():
            t0 = time.perf_counter()
            futs = [bat.submit(p, WIN_SERVE_NEW) for p in prompts]
            res = [f.result(timeout=900) for f in futs]
            return res, time.perf_counter() - t0

        (answers, secs), launches = counted(run, spy, qspy, label, results,
                                            key="launches_phase24")
        peak = torch.cuda.max_memory_allocated()
        st = bat.stats()
    finally:
        bat.stop()
    out = {"tok_s": len(prompts) * WIN_SERVE_NEW / secs, "secs": secs,
           "peak_above_gb": (peak - base) / 1e9, "peak_gb": peak / 1e9,
           "launches": launches, "chunks": st["chunks_dispatched"],
           "answers": answers}
    say(f"  {label}: {len(prompts)} requests x {WIN_SERVE_NEW} tokens in "
        f"{secs:.2f} s = {out['tok_s']:.1f} tok/s; peak {peak / 1e9:.3f} GB "
        f"on the card, {out['peak_above_gb']:.3f} GB above the "
        f"{base / 1e9:.3f} GB of weights and slot caches")
    return out


def phase24_batcher(torch, np, ckpt: Path, results) -> dict:
    """(b) The batcher's window admission, built as bench.py:544-562
    builds it: the checkpoint loaded with ragged_decode at max_len 8,192
    (int8), bucket windows 16-512, 16 requests of 10-500 tokens submitted
    at once, 32 greedy tokens each; the same requests through a batcher
    over an interface without windows (admission caches k x 8,192) on
    the same device weights, and each request alone on the direct path
    (sequential). Every answer is held to a teacher-forced prefill."""
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import loader_registry
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.milli import transforms

    t0 = time.perf_counter()
    bundle = loader_registry()["transformers"].load({
        "path": str(ckpt), "dtype": "bf16", "max_len": WIN_SERVE_LEN,
        "quantize": "int8", "ragged_decode": True})
    model = bundle.models[bundle.interfaces["text"]["model"]]
    wins = serve_window_models(ckpt, WIN_BUCKETS)
    for wm in wins.values():
        wm.graph.store = model.graph.store
    kw = dict(cache_dtype=DType.BF16, prompt_buckets=WIN_BUCKETS,
              quantize="int8", device=CARD)
    win = TextInferenceInterface(model, WIN_SERVE_LEN, window_models=wins,
                                 **kw)
    win._weights()
    flat = TextInferenceInterface(model, WIN_SERVE_LEN,
                                  quantize_precomputed=win._quantized, **kw)
    flat.share_weights(win)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "windows": sorted(win._window_millis)}
    say(f"phase 24 (b): the batcher's window admission; loader, "
        f"{len(wins)} bucket windows {out['windows']} and both interfaces "
        f"in {out['build_s']:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB on the card")
    rng = np.random.default_rng(SEED + 240)
    lengths = np.linspace(10, WIN_BUCKETS[-1] - 12, WIN_REQUESTS).astype(int)
    prompts = [rng.integers(3, BYTE_VOCAB, (n,)).astype(np.int64)
               for n in lengths]
    spy, qspy = RouteSpy(), quant_spy(transforms)
    admitted = []
    inner = win.step

    def step(ids, pos, caches, lora_idx=None, window=None):
        if ids.shape[1] > 1:
            admitted.append((ids.shape[0], ids.shape[1], window,
                             caches[0].shape[2]))
        return inner(ids, pos, caches, lora_idx, window)

    win.step = step
    try:
        runs = {}
        for label, iface in (("window admission", win),
                             ("full-length admission", flat)):
            runs[label] = serve_batch(torch, np, iface, prompts,
                                      f"(b) {label}", spy, qspy, results)
            free_memory(torch)
        seq = [flat.generate_tokens(p[None], WIN_SERVE_NEW)[0]
               for p in prompts]
    finally:
        del win.step
        spy.restore()
        transforms.int8_matmul = qspy.inner
    say(f"  (b) the window admission's prefills (rows, bucket, window, "
        f"cache length): {sorted(set(admitted))}")
    if not any(w is not None and w == s and length == s
               for _, s, w, length in admitted):
        fail("(b) no admission prefilled in a bucket window")
    a, f = runs["window admission"], runs["full-length admission"]
    same_flat = sum(np.array_equal(x, y) for x, y in zip(a["answers"],
                                                         f["answers"]))
    same_seq = sum(np.array_equal(x, y) for x, y in zip(a["answers"], seq))
    frac = 0.015 * math.sqrt(WIN_LAYERS)
    worst = 0.0
    for p, toks in zip(prompts, a["answers"]):
        gaps, scale = teacher_gaps(torch, np, flat, p, toks)
        worst = max(worst, float(gaps.max()) / (frac * scale))
    out.update(same_as_full_admission=same_flat, same_as_sequential=same_seq,
               teacher_worst=worst, admitted=sorted(set(admitted)))
    for label, r in runs.items():
        out[label] = {k: v for k, v in r.items() if k != "answers"}
    say(f"  (b) answers with window admission: {same_flat} of "
        f"{len(prompts)} equal to the full-length admission's, {same_seq} "
        f"to the sequential direct path's; against teacher-forced prefills "
        f"worst (max logit - emitted logit) {worst:.4g} of the bound "
        f"({frac:.1%} of max|logit|); peak above the weights and slots "
        f"{a['peak_above_gb']:.3f} GB with windows against "
        f"{f['peak_above_gb']:.3f} GB without; {a['tok_s']:.1f} against "
        f"{f['tok_s']:.1f} tok/s on {card_line()}")
    if not worst <= 1.0:
        fail("(b) a window-admitted answer disagrees with its "
             "teacher-forced prefill")
    del win, flat, bundle, model, wins
    free_memory(torch)
    return out


def phase24_served(torch, np, ckpt: Path, want: list) -> dict:
    """(c) One OpenAI completion and one `cli generate` from the
    checkpoint loaded with decode_windows (the Server's text interface
    takes the bundle's windows): the greedy text of (a)'s windowed
    interface for WIN_TEXT."""
    import contextlib
    import io

    from whisper_tensor_tpu_torch import cli
    from whisper_tensor_tpu_torch.server.main import Server
    from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    toks = list(want)
    if ByteTokenizer.EOS in toks:
        toks = toks[:toks.index(ByteTokenizer.EOS)]
    text = ByteTokenizer().decode(toks)
    srv = Server()
    t0 = time.perf_counter()
    (entry, *rest) = srv.models.run_loader("transformers", {
        "path": str(ckpt), "dtype": "bf16", "quantize": "int8",
        "max_len": WIN_MAX_LEN,
        "decode_windows": ",".join(map(str, WIN_WINDOWS))})
    iface = srv._text_iface(entry)
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    try:
        body = completion(api.port, {"prompt": WIN_TEXT, "temperature": 0,
                                     "max_tokens": WIN_SERVE_NEW,
                                     "model": entry.name})
    finally:
        api.stop()
    got = body["choices"][0]["text"]
    out = {"served_s": time.perf_counter() - t0,
           "windows": sorted(iface._window_millis),
           "models": [e.name for e in (entry, *rest)],
           "http_equal": got == text}
    say(f"phase 24 (c): the Server over the windowed bundle "
        f"({out['models']}): its text interface's windows "
        f"{out['windows']}; /v1/completions answered "
        f"{body['usage']['completion_tokens']} tokens in "
        f"{out['served_s']:.1f} s (load included), equal to (a)'s windowed "
        f"text: {out['http_equal']}")
    del iface, srv, entry, rest
    free_memory(torch)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["generate", "--model", str(ckpt), "--prompt", WIN_TEXT,
                  "--max-len", str(WIN_MAX_LEN), "--max-new-tokens",
                  str(WIN_SERVE_NEW), "-c", "quantize=int8", "-c",
                  "decode_windows=" + ",".join(map(str, WIN_WINDOWS))])
    printed = buf.getvalue()
    out["cli_s"] = time.perf_counter() - t0
    out["cli_equal"] = printed.rstrip("\n") == text
    say(f"  `cli generate -c decode_windows=...`: {out['cli_s']:.1f} s "
        f"(load included), its text equal to (a)'s windowed text: "
        f"{out['cli_equal']}")
    if sorted(out["windows"]) != list(WIN_WINDOWS) or not (
            out["http_equal"] and out["cli_equal"]):
        fail(f"(c) the served windowed bundle answered {got!r} over HTTP "
             f"and {printed!r} from the CLI for (a)'s {text!r}, or its "
             f"windows are {out['windows']}")
    free_memory(torch)
    return out


def phase24_gguf(torch, np, path: Path, results) -> dict:
    """(d) Phase 6b's smoke GGUF (Q4_K/Q6_K, llama.cpp's Q/K order)
    through the gguf loader with decode_windows at max_len 16,384,
    packed: the windowed and the flat interface (sharing the packed
    device weights) on B 8 prompts of 100 tokens, their greedy tokens
    held by win_agree; packed_matmul launches equal the lowering's
    calls; a rerun
    with every kernel call, packed_matmul's too, held against its plain
    version."""
    from whisper_tensor_tpu_torch.backends.cuda import agreement_bound
    from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (
        packed_matmul)
    from whisper_tensor_tpu_torch.dtype import DType
    from whisper_tensor_tpu_torch.importers.loaders import loader_registry
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)
    from whisper_tensor_tpu_torch.milli import transforms

    t0 = time.perf_counter()
    bundle = loader_registry()["gguf"].load({
        "path": str(path), "dtype": "bf16", "max_len": WIN_MAX_LEN,
        "decode_windows": ",".join(map(str, WIN_WINDOWS))})
    main, wins = win_models(bundle)
    win = TextInferenceInterface(main, WIN_MAX_LEN, cache_dtype=DType.BF16,
                                 window_models=wins, device=CARD)
    win._weights()
    flat = TextInferenceInterface(main, WIN_MAX_LEN, cache_dtype=DType.BF16,
                                  device=CARD)
    flat.share_weights(win)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "windows": sorted(wins),
           "packed": len(win._packed)}
    say(f"phase 24 (d): the smoke GGUF with decode_windows: windows "
        f"{out['windows']}, {out['packed']} packed weights, built and "
        f"uploaded in {out['build_s']:.1f} s")
    if sorted(wins) != list(WIN_WINDOWS) or not win._packed:
        fail("(d) the GGUF bundle has no windows or no packed weights")
    rng = np.random.default_rng(SEED + 2400)
    prompt = rng.integers(3, BYTE_VOCAB, (WIN_BATCH, WIN_PROMPT)).astype(
        np.int64)
    spy, qspy, pspy = RouteSpy(), quant_spy(transforms), packed_spy(
        transforms)
    try:
        toks = {}
        for label, iface in (("windowed", win), ("flat", flat)):
            iface.generate_tokens(prompt, WIN_NEW)
            packed_matmul.launches, pspy.calls = 0, 0
            toks[label], launches = counted(
                lambda iface=iface: iface.generate_tokens(prompt, WIN_NEW),
                spy, qspy, f"(d) GGUF {label}", results,
                key="launches_phase24")
            say(f"  (d) GGUF {label}: packed_matmul {packed_matmul.launches} "
                f"launches for {pspy.calls} PackedMatMul calls of the "
                f"lowering")
            if pspy.calls <= 0 or packed_matmul.launches != pspy.calls:
                fail(f"(d) {label}: packed_matmul launches against the "
                     f"lowering's calls")
            for res in results:
                if res["name"] == "packed_matmul":
                    d = res.setdefault("launches_phase24", {})
                    d[f"(d) GGUF {label}"] = packed_matmul.launches
            out[label] = {"launches": dict(
                launches, packed_matmul=packed_matmul.launches)}
        out["agree"] = win_agree(torch, np, "(d)", flat, prompt,
                                 toks["windowed"], toks["flat"])
        sh = Shadows()
        psh = packed_shadow(torch, transforms, agreement_bound)
        try:
            win.generate_tokens(prompt, WIN_NEW)
        finally:
            transforms.packed_matmul = psh.inner
            sh.close("(d) GGUF windowed, shadowed",
                     out["windowed"]["launches"])
        say(f"  (d) GGUF windowed, shadowed: {psh.calls} packed_matmul calls "
            f"against the plain version: worst |err|/bound {psh.worst:.4g} "
            f"(max |err| {psh.max_err:.5g})")
        out["packed_shadow"] = {"calls": psh.calls, "worst": psh.worst,
                                "max_err": psh.max_err}
        if psh.calls <= 0 or not psh.worst <= 1.0:
            fail("(d) a packed_matmul call of the shadowed rerun disagrees "
                 "with its plain version")
    finally:
        transforms.packed_matmul = pspy.inner
        spy.restore()
        transforms.int8_matmul = qspy.inner
    del win, flat, bundle, main, wins
    free_memory(torch)
    return out


def phase24(torch, np, root: Path, bf16, results) -> dict:
    """Phase 24 (--windows-only): (e) win_kernels, then on a
    WIN_LAYERS-layer checkpoint at Llama-3-8B's widths (a) the direct
    path, (b) the batcher's window admission, (c) HTTP and the CLI, then
    (d) the smoke GGUF."""
    win_kernels(torch, results)
    out = {"card": card_line()}
    ckpt = root / f"llama3-8b-widths-{WIN_LAYERS}L-windows"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        write_checkpoint(ckpt, WIN_LAYERS, np, bf16)
        say(f"phase 24: wrote a {WIN_LAYERS}-layer Llama-3-8B-width "
            f"checkpoint in {time.perf_counter() - t0:.1f} s")
        out["a"] = phase24_direct(torch, np, ckpt, results)
        out["b"] = phase24_batcher(torch, np, ckpt, results)
        out["c"] = phase24_served(torch, np, ckpt, out["a"].pop("text"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    path = root / f"llama3-8b-widths-{WIN_LAYERS}L-windows.gguf"
    try:
        t0 = time.perf_counter()
        write_smoke_gguf(path, WIN_LAYERS, np, bf16)
        say(f"phase 24: wrote the smoke GGUF in "
            f"{time.perf_counter() - t0:.1f} s")
        out["d"] = phase24_gguf(torch, np, path, results)
    finally:
        path.unlink(missing_ok=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="transformer layers of the smoke model (32 = full "
                         "Llama-3-8B depth; 2 by default since phase 16 "
                         "came, 4 before, to keep the run well inside its "
                         "time limit)")
    ap.add_argument("--plant-fault", action="store_true",
                    help="phase 4 writes every decode step's K/V one "
                         "position early; check (d) must fail")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (no result line)")
    ap.add_argument("--generic-only", action="store_true",
                    help="write the checkpoint and run phase 11 alone (no "
                         "result line)")
    ap.add_argument("--image-only", action="store_true",
                    help="run phase 13 (SD-1.5) alone after the build (no "
                         "result line)")
    ap.add_argument("--train-only", action="store_true",
                    help="run phase 14 (training) alone after the build "
                         "(no result line)")
    ap.add_argument("--inspect-only", action="store_true",
                    help="write the checkpoints, run phase 13 (with 15 (d)) "
                         "and phase 15 (the introspection path) after the "
                         "build (no result line)")
    ap.add_argument("--text-family-only", action="store_true",
                    help="run phase 16 (DeepSeek, T5, RWKV-7, LLaVA; in "
                         "full: DeepSeek's naive build too, T5, RWKV-7 at "
                         "4 layers) alone after the build (no result line)")
    ap.add_argument("--speech-only", action="store_true",
                    help="run phase 17 (Whisper, TTS) and the recurrent and "
                         "spectral corpus cases alone after the build (no "
                         "result line)")
    ap.add_argument("--media-only", action="store_true",
                    help="run phase 2's flash cases at the media shapes and "
                         "phase 18 (SDXL, SD3 and Flux at full size, the LDM "
                         "file, the vision corpus cases) alone after the "
                         "build (no result line)")
    ap.add_argument("--gguf-only", action="store_true",
                    help="write the checkpoint's weights as a Q4_K/Q6_K GGUF "
                         "and run phase 6b (the GGUF through the batcher), "
                         "then phase 12's Gemma-2 2B as a Q8_0 GGUF, alone "
                         "after the build (no result line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="write the checkpoint and run phase 19 (tp=2 over "
                         "gloo on the card: int8 and q4_0, the 24- and "
                         "1,900-token prompts; NCCL at tp=1; ring "
                         "attention, MoE, pipeline) alone after the build "
                         "(no result line)")
    ap.add_argument("--train-parallel-only", action="store_true",
                    help="run phase 20 (training across ranks: GPT-2 124M "
                         "at dp=2 and FSDP, Llama-3-8B widths at tp=2 with "
                         "a sharded checkpoint and at sp=2, QLoRA at dp=2, "
                         "the pipelined trainer at pp=2, a world of one "
                         "under NCCL) alone after the build (no result "
                         "line)")
    ap.add_argument("--onnx-only", action="store_true",
                    help="write the checkpoint and run phase 21 (the "
                         "compiler facade over phase 11 (c)'s Model, a .bin "
                         "and an origin-referenced ONNX export loaded by the "
                         "`onnx` loader) alone after the build")
    ap.add_argument("--examples-only", action="store_true",
                    help="run phase 22 (every examples/torch_port example "
                         "through its main on the card, the --model ones "
                         "on seeded checkpoints at published widths) alone "
                         "after the build")
    ap.add_argument("--long-context-only", action="store_true",
                    help="run phase 23 (the long-context path: the "
                         "kernels at S 8,192 and 16,384, then a 4-layer "
                         "Llama-3-8B-width int8 model with "
                         "logits_last_only and without, sibling "
                         "interfaces sharing the int8 weights) alone "
                         "after the build")
    ap.add_argument("--windows-only", action="store_true",
                    help="run phase 24 (windowed decode: the kernels at "
                         "the window shapes, then a 4-layer "
                         "Llama-3-8B-width int8 model with "
                         "decode_windows=256,1024 direct, the batcher's "
                         "window admission, HTTP and the CLI, the smoke "
                         "GGUF) alone after the build")
    ap.add_argument("--lora-only", action="store_true",
                    help="write the checkpoints and run phase 10 (l) "
                         "multi-LoRA serving, (n) the profiler and cli "
                         "generate --draft-model alone after the build (no "
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
        say(f"  ml_dtypes {ml_dtypes.__version__} imports (numpy "
            f"{np.__version__})")
    except ImportError:
        say("  ml_dtypes does not import: bf16 crosses as f32 on the host")
    try:
        import PIL
        say(f"  PIL {PIL.__version__} imports (ImageDecoder's host decode)")
    except ImportError:
        say("  PIL does not import: the ImageDecoder cases are held on the "
            "CPU only")

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
    if args.onnx_only:
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
            launches = step("phase 21 (build_program, ONNX sources)",
                            phase21, torch, np, ckpt, args.layers)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        say(json.dumps({"phase21_launches": launches}))
        say(f"{card_line()} (--onnx-only: phases 2-20 not run)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.examples_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        rows = step("phase 22 (the port's examples)", phase22, torch, np,
                    ROOT / "build" / "smoke", args.layers, bf16, results)
        say(json.dumps({"phase22": rows}))
        say(f"{card_line()} (--examples-only: phases 2-21 not run)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.long_context_only:
        out = step("phase 23 (the long-context path)", phase23, torch, np,
                   results)
        for res in results:
            res["launches"] = sum(res.get("launches_phase23", {}).values())
        say(json.dumps({"phase23": out}))
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--long-context-only: phases 2-22 not run)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.windows_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        out = step("phase 24 (windowed decode)", phase24, torch, np,
                   ROOT / "build" / "smoke", bf16, results)
        step("phase 2: int8_matmul_dx (not on this path: its row of the "
             "kernels' line)", phase2_int8_dx, torch, results)
        for res in results:
            res["launches"] = sum(res.get("launches_phase24", {}).values())
        say(json.dumps({"phase24": out}, default=str))
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--windows-only: phases 2-23 not run)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.lora_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        smoke = ROOT / "build" / "smoke"
        ckpt = smoke / f"llama3-8b-widths-{args.layers}L"
        gpt2_ckpt = smoke / "gpt2-124m-widths"
        for d in (ckpt, gpt2_ckpt):
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
        try:
            step("write the checkpoint", write_checkpoint, ckpt, args.layers,
                 np, bf16)
            step("write the GPT-2 checkpoint", write_gpt2_checkpoint,
                 gpt2_ckpt, np, bf16)
            step("phase 10 (multi-LoRA, the profiler, cli --draft-model)",
                 phase10, torch, np, ckpt, gpt2_ckpt, args.layers, bf16,
                 results)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
            shutil.rmtree(gpt2_ckpt, ignore_errors=True)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--lora-only: phases 2-9 and 11-22 not run)")
        return
    if args.image_only:
        step("phase 13 (SD-1.5 image generation)", phase13, torch, np,
             ROOT / "build" / "smoke", results)
        say(f"{card_line()} (--image-only: phases 2-12 not run)")
        return
    if args.train_only:
        run_phase14(step, torch, np, args.layers, results)
        say(f"{card_line()} (--train-only: phases 2-13 not run)")
        return
    if args.text_family_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        step("phase 16 (DeepSeek, T5, RWKV-7, LLaVA)", phase16, torch, np,
             ROOT / "build" / "smoke", bf16, results)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--text-family-only: phases 2-15 not run)")
        return
    if args.speech_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        step("phase 17 (Whisper, TTS, recurrent and spectral cases)",
             phase17, torch, np, ROOT / "build" / "smoke", bf16, results,
             WHISPER_LAYERS, True)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--speech-only: phases 2-16 not run)")
        return
    if args.media_only:
        step("phase 2: flash_attention at the media shapes",
             phase2_flash_media, torch, results)
        step("phase 18 (SDXL, SD3, Flux, the LDM file, the vision cases)",
             phase18, torch, np, ROOT / "build" / "smoke", results, True)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--media-only: phases 3-17 not run)")
        return
    if args.gguf_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        gguf_path = (ROOT / "build" / "smoke"
                     / f"llama3-8b-widths-{args.layers}L.gguf")
        gguf_path.parent.mkdir(parents=True, exist_ok=True)
        try:
            step("write the GGUF", write_smoke_gguf, gguf_path, args.layers,
                 np, bf16)
            say(f"wrote the checkpoint as a Q4_K/Q6_K GGUF "
                f"({gguf_path.stat().st_size / 1e9:.2f} GB)")
            step("phase 6b (GGUF batched)", phase6b, torch, np, gguf_path,
                 args.layers, results)
        finally:
            gguf_path.unlink(missing_ok=True)
        step("phase 12's Gemma-2 2B as a Q8_0 GGUF", phase12, torch, np,
             ROOT / "build" / "smoke", args.layers, bf16, results, True)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--gguf-only: phases 2-6a, 7-11 and 13-20 "
            f"not run)")
        return
    if args.train_parallel_only:
        step("phase 20 (training across ranks)", phase20, torch, np,
             results, args.layers)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--train-parallel-only: phases 2-19 not run)")
        return
    if args.parallel_only:
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
            refs = {}
            for q in ("int8", "q4_0"):
                def reference(q=q):
                    iface, load_s = par_load(torch, ckpt, q)
                    say(f"  the single-rank {q} reference: load {load_s:.1f}"
                        f" s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
                        f"on the card")
                    refs[q] = par_reference(torch, np, iface,
                                            par_prompts(np, True))
                step(f"phase 19's single-rank {q} reference", reference)
            step("phase 19 (parallelism)", phase19, torch, np, ckpt, results,
                 refs, True)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        say(json.dumps({"kernels": results}))
        say(f"{card_line()} (--parallel-only: phases 2-18 not run)")
        return
    if args.inspect_only:
        try:
            import ml_dtypes
            bf16 = np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            bf16 = None
        smoke = ROOT / "build" / "smoke"
        ckpt = smoke / f"llama3-8b-widths-{args.layers}L"
        gpt2_ckpt = smoke / "gpt2-124m-widths"
        for d in (ckpt, gpt2_ckpt):
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
        try:
            step("write the checkpoint", write_checkpoint, ckpt, args.layers,
                 np, bf16)
            step("write the GPT-2 checkpoint", write_gpt2_checkpoint,
                 gpt2_ckpt, np, bf16)
            step("phase 13 (SD-1.5 image generation, with 15 (d))", phase13,
                 torch, np, smoke, results)
            step("phase 15 (the introspection path)", phase15, torch, np,
                 ckpt, gpt2_ckpt, args.layers, results)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
            shutil.rmtree(gpt2_ckpt, ignore_errors=True)
        say(f"{card_line()} (--inspect-only: phases 2-12 and 14 not run)")
        return
    step("phase 2: decode_attention, int8_matmul", phase2, torch, results)
    step("phase 2: ragged_kv_write", phase2_kv_write, torch, results)
    step("phase 2: flash_attention", phase2_flash, torch, results)
    step("phase 2: flash_attention at the SD UNet's shapes", phase2_flash_sd,
         torch, results)
    step("phase 2: flash_attention at the media shapes", phase2_flash_media,
         torch, results)
    step("phase 2: packed_matmul", phase2_packed, torch, results)
    step("phase 2: int8_matmul_dx", phase2_int8_dx, torch, results)
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
        par_ref = {}
        int8 = step("phases 3, 5 and 15 (a)-(c), (e) (direct)", phase3,
                    torch, np, ckpt, args.layers, results, par_ref)
        step("phases 19 and 20 (parallelism, cut: the 24-token prompt, "
             "int8; training: QLoRA at dp=2, a world of one)",
             phase19, torch, np, ckpt, results, par_ref, False)
        step("phases 4 and 5 (batched)", phase4, torch, np, ckpt,
             args.layers, results, args.plant_fault)
        q4_0 = step("phase 6a (q4_0 direct)", phase6a, torch, np, ckpt,
                    args.layers, results, int8)
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
        step("phase 11 (the generic ONNX path)", phase11, torch, np, ckpt,
             args.layers, results)
        step("phase 12 (Gemma, Gemma-2, Gemma-3, Phi-3)", phase12, torch, np,
             ROOT / "build" / "smoke", args.layers, bf16, results)
        step("phase 13 (SD-1.5 image generation, with 15 (d))", phase13,
             torch, np, ROOT / "build" / "smoke", results, True)
        run_phase14(step, torch, np, args.layers, results)
        step("phase 15 (e) GPT-2 and (f) (with (a)-(c) at phase 3, (d) "
             "at phase 13)", phase15, torch, np, None, gpt2_ckpt,
             args.layers, results)
        step("phase 16 (DeepSeek, RWKV-7, LLaVA; cut)", phase16, torch,
             np, ROOT / "build" / "smoke", bf16, results, False)
        step("phase 17 (Whisper, TTS)", phase17, torch, np,
             ROOT / "build" / "smoke", bf16, results,
             WHISPER_LAYERS_DEFAULT_RUN)
        step("phase 18 (SDXL, SD3, Flux cut; the LDM file)", phase18, torch,
             np, ROOT / "build" / "smoke", results, False)
    finally:
        shutil.rmtree(ROOT / "build" / "smoke" / "sd15", ignore_errors=True)
        (ROOT / "build" / "smoke" / "sd15-ref.png").unlink(missing_ok=True)
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(gpt2_ckpt, ignore_errors=True)
        shutil.rmtree(gptq_ckpt, ignore_errors=True)
    say(json.dumps({"kernels": results}))
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
