"""Command-line interface of the port: `generate`, `embed` and `serve`.

Counterpart of whisper_tensor_tpu/cli.py:41 (generate), :171 (embed)
and :445 (serve), on a torch device chosen with --device (CUDA by
default, the CPU only when asked for). The reference's other
subcommands are not ported yet.

Usage:
  python -m whisper_tensor_tpu_torch.cli generate --model DIR \
      --prompt "..." [--max-new-tokens 64] [-c quantize=int8] [--device cuda]
      [--regex RE | --json-schema JSON | --num-beams W
       | --draft-model DIR [--draft-k 4]] [-c lora=PEFT_DIR]
  python -m whisper_tensor_tpu_torch.cli embed --model DIR \
      [--pooling last|mean] [--device cuda] TEXT [TEXT ...]
  python -m whisper_tensor_tpu_torch.cli serve --model DIR \
      --http-port 8000 [-c quantize=int8] [--device cuda]
      [-c ragged_decode=1 -c serve_batch=16 -c prefill_chunk=128]

--model takes a transformers checkpoint dir (a GPTQ/AWQ one too: its
quantized Linears stay packed on the device) or a llama-family GGUF
file (its blocks stay packed on the device; -c packed_weights=0 loads
them dequantized). -c quantize=q4_0|q8_0|q5_0|q4_k|q6_k quantizes a
dense checkpoint's matmul weights into GGUF blocks on the host.
-c lora=PEFT_DIR merges a PEFT LoRA adapter into the weights at load.
`generate --draft-model` decodes speculatively: the draft model (loaded
with the same -c options, sharing the target's vocabulary) proposes
--draft-k - 1 tokens a round and the target verifies them in one
forward; greedy output equals plain greedy decoding token for token.

`serve -c ragged_decode=1` serves the model through the port's
ContinuousBatcher; the loader (importers/loaders.py) maps serve_batch,
serve_chunk, serve_chunk_max, prefill_chunk and serve_auto_prefix onto
it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List


def _parse_kv(pairs: List[str]) -> Dict[str, object]:
    """`key=value` strings -> typed config values: int, then float,
    then true/false, else the string (the reference CLI's parsing)."""
    out: Dict[str, object] = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"bad config entry {p!r}; expected key=value")
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def _load_text(args, path=None):
    """--model (or `path`) through the loader -> (the text interface on
    --device, with its tokenizer, and the model's name)."""
    from .importers.loaders import identify_and_load, loader_registry
    from .interfaces.text import TextInferenceInterface
    from .tokenizer import AnyTokenizer

    cfg = _parse_kv(args.config)
    cfg.setdefault("max_len", args.max_len)
    path = path or args.model
    if args.loader == "auto":
        bundle = identify_and_load(path, **cfg)
    else:
        bundle = loader_registry()[args.loader].load({"path": path, **cfg})
    iface_cfg = bundle.interfaces.get("text")
    if iface_cfg is None:
        raise SystemExit("the port runs causal LMs only; this bundle has "
                         "no text interface")
    if iface_cfg.get("windows"):
        raise SystemExit("decode_windows is not ported to PyTorch yet")
    model = bundle.models[iface_cfg.get("model") or next(iter(bundle.models))]
    # the KV cache keeps the element type the step graph declares for it
    g = model.graph
    cache_dtype = next(g.tensors[g.by_name[n]].info.dtype
                       for n in g.by_name if n.startswith("cache_"))
    iface = TextInferenceInterface(
        model, max_len=int(iface_cfg.get("max_len", args.max_len)),
        cache_dtype=cache_dtype, eos_token_id=iface_cfg.get("eos_token_id"),
        quantize=iface_cfg.get("quantize") or None, device=args.device)
    iface.tokenizer = AnyTokenizer.load(args.tokenizer
                                        or bundle.tokenizer_source or "bytes")
    return iface, model.name


def cmd_generate(args) -> None:
    import numpy as np

    from .interfaces.text import SamplingParams
    from .tokenizer import apply_chat_template

    if (args.regex or args.json_schema) and (args.num_beams > 1
                                             or args.draft_model):
        raise SystemExit("--regex/--json-schema are not supported with "
                         "--num-beams or --draft-model")
    t0 = time.time()
    iface, name = _load_text(args)
    draft = _load_text(args, args.draft_model)[0] if args.draft_model else None
    print(f"loaded {name} in {time.time() - t0:.1f}s", file=sys.stderr)
    if args.chat:
        messages = ([{"role": "system", "content": args.system}]
                    if args.system else [])
        messages.append({"role": "user", "content": args.prompt})
        args.prompt = apply_chat_template(iface.tokenizer, messages)
    sampling = None
    if (args.temperature > 0 or args.repetition_penalty != 1.0
            or args.presence_penalty != 0.0 or args.frequency_penalty != 0.0):
        sampling = SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            min_p=args.min_p, repetition_penalty=args.repetition_penalty,
            presence_penalty=args.presence_penalty,
            frequency_penalty=args.frequency_penalty, seed=args.seed)
    t1 = time.time()
    if args.num_beams > 1:
        ids = np.asarray(iface.tokenizer.encode(args.prompt),
                         dtype=np.int64)[None]
        toks = iface.beam_search_tokens(ids, args.max_new_tokens,
                                        beam=args.num_beams)[0]
        text = iface.tokenizer.decode([int(t) for t in toks])
    elif draft is not None:
        from .interfaces.speculative import SpeculativeDecoder

        dec = SpeculativeDecoder(iface, draft, k=args.draft_k)
        ids = np.asarray(iface.tokenizer.encode(args.prompt), np.int64)
        toks = dec.generate_tokens(ids, args.max_new_tokens,
                                   sampling=sampling)[0]
        text = iface.tokenizer.decode([int(t) for t in toks])
        n = args.max_new_tokens
        print(f"[speculative: {dec.last_rounds} rounds of k={args.draft_k}, "
              f"acceptance {(n / dec.last_rounds - 1) / (args.draft_k - 1):.3f}]",
              file=sys.stderr)
    else:
        schema = json.loads(args.json_schema) if args.json_schema else None
        text = iface.run_string_in_string_out(
            args.prompt, args.max_new_tokens, sampling=sampling,
            regex=args.regex, json_schema=schema)
    for s in args.stop:
        i = text.find(s)
        if i >= 0:
            text = text[:i]
    dt = time.time() - t1
    print(text)
    print(f"[{args.max_new_tokens} tokens in {dt:.2f}s "
          f"({args.max_new_tokens / dt:.1f} tok/s) on {iface.device}]",
          file=sys.stderr)


def cmd_embed(args) -> None:
    """Text embeddings from a causal LM through the hidden-state tap
    (the pooling of /v1/embeddings), one JSON line per input."""
    import numpy as np

    iface, _ = _load_text(args)
    ids_list = [np.asarray(iface.tokenizer.encode(t), np.int64)
                for t in args.text]
    for i, v in enumerate(iface.embed(ids_list, pooling=args.pooling)):
        print(json.dumps({"index": i, "embedding":
                          [round(float(x), 7) for x in v]}))


def cmd_serve(args) -> None:
    import asyncio

    from .server.main import Server

    srv = Server(device=args.device)
    if args.model:
        # typed values, as `generate` parses them: "ragged_decode=0"
        # must read as off, where the string "0" is true
        cfg = _parse_kv(args.config)
        cfg["path"] = args.model
        for e in srv.models.run_loader(args.loader, cfg):
            print(f"loaded model #{e.id} {e.name}", file=sys.stderr)
    if args.http_port is not None:
        from .server.openai_api import OpenAIApi

        api = OpenAIApi(srv, args.host, args.http_port).start()
        print(f"OpenAI-compatible API on http://{args.host}:{api.port}/v1",
              flush=True)
    print(f"whisper-tensor-tpu (PyTorch, {srv.device}) server on "
          f"ws://{args.host}:{args.port}", flush=True)
    asyncio.run(srv.run(args.host, args.port))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("whisper-tensor-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="LLM text generation")
    g.add_argument("--model", required=True)
    g.add_argument("--prompt", required=True)
    g.add_argument("--loader", default="auto")
    g.add_argument("--tokenizer")
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.add_argument("--max-len", type=int, default=1024)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--min-p", type=float, default=0.0)
    g.add_argument("--repetition-penalty", type=float, default=1.0)
    g.add_argument("--presence-penalty", type=float, default=0.0)
    g.add_argument("--frequency-penalty", type=float, default=0.0)
    g.add_argument("--num-beams", type=int, default=1)
    g.add_argument("--draft-model",
                   help="speculative decoding: a small draft model sharing "
                        "the target's vocabulary")
    g.add_argument("--draft-k", type=int, default=4,
                   help="speculation block length (k-1 proposals a round)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--regex",
                   help="constrain output to match this regex "
                        "(token-DFA guided decoding)")
    g.add_argument("--json-schema",
                   help="constrain output to a JSON document matching "
                        "this schema (JSON string)")
    g.add_argument("--stop", action="append", default=[],
                   help="stop sequence: truncate the output at its first "
                        "occurrence (repeatable)")
    g.add_argument("--chat", action="store_true",
                   help="treat --prompt as a user message and render the "
                        "tokenizer's chat template")
    g.add_argument("--system", help="system message for --chat")
    g.add_argument("-c", "--config", action="append", default=[],
                   help="loader config key=value")
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.set_defaults(fn=cmd_generate)

    e = sub.add_parser("embed", help="text embeddings from a causal LM "
                       "(hidden-state tap, one JSON line per input)")
    e.add_argument("--model", required=True)
    e.add_argument("--loader", default="auto")
    e.add_argument("--tokenizer", default=None)
    e.add_argument("--max-len", type=int, default=1024)
    e.add_argument("--pooling", choices=["last", "mean"], default="last")
    e.add_argument("-c", "--config", action="append", default=[],
                   help="loader config key=value")
    e.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    e.add_argument("text", nargs="+", help="input text(s)")
    e.set_defaults(fn=cmd_embed)

    s = sub.add_parser("serve", help="run the WebSocket server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=3000)
    s.add_argument("--http-port", type=int,
                   help="also serve the OpenAI-compatible HTTP API on this "
                        "port (0 = auto-pick)")
    s.add_argument("--model", help="preload a model at startup")
    s.add_argument("--loader", default="auto")
    s.add_argument("-c", "--config", action="append", default=[],
                   help="loader config key=value (repeatable)")
    s.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    s.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
