"""Command-line interface of the port: `generate`, `embed`, `image`,
`serve`, `inspect` and `export`.

Counterpart of whisper_tensor_tpu/cli.py:41 (generate), :171 (embed),
:201 (image), :445 (serve), :292 (inspect) and :313 (export), on a
torch device chosen with --device (CUDA by default, the CPU only when
asked for); `inspect` and `export` load on the host and touch no
device. The reference's other subcommands are not ported yet.

Usage:
  python -m whisper_tensor_tpu_torch.cli generate --model DIR \
      --prompt "..." [--max-new-tokens 64] [-c quantize=int8] [--device cuda]
      [--regex RE | --json-schema JSON | --num-beams W
       | --draft-model DIR [--draft-k 4]] [-c lora=PEFT_DIR]
      (a T5 `text2text` checkpoint: the prompt through its encoder, the
      answer greedy, sampled or by --num-beams W)
  python -m whisper_tensor_tpu_torch.cli embed --model DIR \
      [--pooling last|mean] [--device cuda] TEXT [TEXT ...]
  python -m whisper_tensor_tpu_torch.cli image --model SD_DIR \
      --prompt "..." [--steps 20] [--cfg 7.5] [--height 512 --width 512]
      [--init-image IMG [--strength 0.6] [--mask-image IMG]]
      [--output out.png] [--device cuda]
  python -m whisper_tensor_tpu_torch.cli serve --model DIR \
      --http-port 8000 [-c quantize=int8] [--device cuda]
      [-c ragged_decode=1 -c serve_batch=16 -c prefill_chunk=128]
  python -m whisper_tensor_tpu_torch.cli inspect --model DIR [-c k=v]
  python -m whisper_tensor_tpu_torch.cli export --model DIR -o out.onnx \
      [--weights embed|external|none] [--name MODEL] [--loader auto]

`inspect` prints each model of the loaded bundle as JSON (op census,
weights, inputs, outputs, interfaces). `export` writes each model as
ONNX, the bytes the JAX package's `export` writes: `external` (the
default) puts the weights in `<out>.bin` beside it, 64-byte aligned.

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

`image` takes a diffusers `sd` pipeline dir (SD-1.5, SD-2.x) or the
three ONNX files (--text-encoder, --unet, --vae); --init-image runs
img2img, with --mask-image (white = repaint) inpainting. Images are PPM
(P6) or PNG, by the signature when read and by the --output suffix when
written.

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


def _load_bundle(args, path=None):
    """--model (or `path`) through --loader with the -c settings."""
    from .importers.loaders import identify_and_load, loader_registry

    cfg = _parse_kv(args.config)
    cfg.setdefault("max_len", args.max_len)
    path = path or args.model
    if args.loader == "auto":
        return identify_and_load(path, **cfg)
    return loader_registry()[args.loader].load({"path": path, **cfg})


def _cache_dtype(model):
    """The element type the step graph declares for its KV cache."""
    g = model.graph
    return next(g.tensors[g.by_name[n]].info.dtype
                for n in g.by_name if n.startswith("cache_"))


def _load_text(args, path=None, bundle=None):
    """--model (or `path`, or a loaded bundle) -> (the text interface on
    --device, with its tokenizer, and the model's name)."""
    from .interfaces.text import TextInferenceInterface
    from .tokenizer import AnyTokenizer

    bundle = bundle or _load_bundle(args, path)
    iface_cfg = bundle.interfaces.get("text")
    if iface_cfg is None:
        raise SystemExit("the port runs causal LMs only; this bundle has "
                         "no text interface")
    if iface_cfg.get("windows"):
        raise SystemExit("decode_windows is not ported to PyTorch yet")
    model = bundle.models[iface_cfg.get("model") or next(iter(bundle.models))]
    iface = TextInferenceInterface(
        model, max_len=int(iface_cfg.get("max_len", args.max_len)),
        cache_dtype=_cache_dtype(model),
        eos_token_id=iface_cfg.get("eos_token_id"),
        quantize=iface_cfg.get("quantize") or None, device=args.device)
    iface.tokenizer = AnyTokenizer.load(args.tokenizer
                                        or bundle.tokenizer_source or "bytes")
    return iface, model.name


def _sampling(args):
    from .interfaces.text import SamplingParams

    if (args.temperature > 0 or args.repetition_penalty != 1.0
            or args.presence_penalty != 0.0 or args.frequency_penalty != 0.0):
        return SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            min_p=args.min_p, repetition_penalty=args.repetition_penalty,
            presence_penalty=args.presence_penalty,
            frequency_penalty=args.frequency_penalty, seed=args.seed)
    return None


def _generate_text2text(args, bundle, t0: float) -> None:
    """A `text2text` (T5) bundle, as the reference's cli runs it
    (cli.py:55-70): the prompt through the encoder, the answer from the
    decoder; --num-beams W > 1 takes beam search."""
    import numpy as np

    from .interfaces.seq2seq import Seq2SeqInterface
    from .tokenizer import AnyTokenizer

    if args.regex or args.json_schema or args.draft_model or args.chat:
        raise SystemExit("a text2text model takes no --regex, "
                         "--json-schema, --draft-model or --chat")
    spec = bundle.interfaces["text2text"]
    dec = bundle.models[spec["decoder"]]
    s2s = Seq2SeqInterface(bundle.models[spec["encoder"]], dec,
                           max_len=spec["max_len"],
                           start_token=spec.get("start", 0),
                           eos_token=spec.get("eos", 1),
                           cache_dtype=_cache_dtype(dec),
                           device=args.device)
    s2s.tokenizer = AnyTokenizer.load(
        args.tokenizer or bundle.tokenizer_source or "bytes")
    print(f"loaded {spec['decoder']} in {time.time() - t0:.1f}s",
          file=sys.stderr)
    t1 = time.time()
    if args.num_beams > 1:
        ids = np.asarray(s2s.tokenizer.encode(args.prompt), np.int64)[None]
        toks = [int(t) for t in s2s.beam_search_tokens(
            ids, args.max_new_tokens, beam=args.num_beams)[0]]
        if s2s.eos_token in toks:
            toks = toks[:toks.index(s2s.eos_token)]
        text = s2s.tokenizer.decode(toks)
    else:
        text = s2s.run_string_in_string_out(args.prompt, args.max_new_tokens,
                                            sampling=_sampling(args))
    print(text)
    print(f"[{args.max_new_tokens} tokens in {time.time() - t1:.2f}s]",
          file=sys.stderr)


def cmd_generate(args) -> None:
    import numpy as np

    from .tokenizer import apply_chat_template

    if (args.regex or args.json_schema) and (args.num_beams > 1
                                             or args.draft_model):
        raise SystemExit("--regex/--json-schema are not supported with "
                         "--num-beams or --draft-model")
    t0 = time.time()
    bundle = _load_bundle(args)
    if "text2text" in bundle.interfaces and "text" not in bundle.interfaces:
        return _generate_text2text(args, bundle, t0)
    iface, name = _load_text(args, bundle=bundle)
    draft = _load_text(args, args.draft_model)[0] if args.draft_model else None
    print(f"loaded {name} in {time.time() - t0:.1f}s", file=sys.stderr)
    if args.chat:
        messages = ([{"role": "system", "content": args.system}]
                    if args.system else [])
        messages.append({"role": "user", "content": args.prompt})
        args.prompt = apply_chat_template(iface.tokenizer, messages)
    sampling = _sampling(args)
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


def cmd_image(args) -> None:
    """Text-to-image, img2img or inpainting (reference cli.py:201-252)."""
    from .interfaces.image_gen import (ImageGenConfig,
                                       ImageGenerationInterface,
                                       image_interface_from_bundle)
    from .model import Model
    from .tokenizer import AnyTokenizer
    from .utils.image import png_bytes, read_image, write_ppm

    if args.model:
        from .importers.loaders import identify_and_load

        extra = _parse_kv(args.config)
        if args.init_image:
            extra.setdefault("img2img", "1")
        bundle = identify_and_load(args.model, height=args.height,
                                   width=args.width, **extra)
        if "image" not in bundle.interfaces:
            raise SystemExit(f"{args.model} is not an image pipeline "
                             f"(got: {sorted(bundle.interfaces) or 'none'})")
        iface = image_interface_from_bundle(bundle, device=args.device)
    else:
        if not (args.text_encoder and args.unet and args.vae):
            raise SystemExit("need --model <diffusers dir> OR all of "
                             "--text-encoder/--unet/--vae")
        te = Model.new_from_onnx_file(args.text_encoder)
        unet = Model.new_from_onnx_file(args.unet)
        vae = Model.new_from_onnx_file(args.vae)
        tok = AnyTokenizer.load(args.tokenizer) if args.tokenizer else None
        iface = ImageGenerationInterface(te, unet, vae, tokenizer=tok,
                                         device=args.device)
    gcfg = ImageGenConfig(steps=args.steps, guidance_scale=args.cfg,
                          height=args.height, width=args.width,
                          seed=args.seed,
                          schedule="euler_karras" if args.karras else "euler")
    if args.init_image and args.mask_image:
        init = read_image(args.init_image)[..., :3]
        mask = read_image(args.mask_image)[..., :3].mean(axis=-1) / 255.0
        img = iface.run_inpaint(args.prompt, init, mask,
                                negative_prompt=args.negative_prompt,
                                cfg=gcfg)
    elif args.init_image:
        init = read_image(args.init_image)[..., :3]
        img = iface.run_img2img(args.prompt, init, strength=args.strength,
                                negative_prompt=args.negative_prompt,
                                cfg=gcfg)
    else:
        img = iface.run(args.prompt, args.negative_prompt, gcfg)
    if args.output.lower().endswith(".png"):
        with open(args.output, "wb") as f:
            f.write(png_bytes(img.pixels))
    else:
        write_ppm(args.output, img.pixels)
    print(f"wrote {args.output} ({img.pixels.shape[1]}x{img.pixels.shape[0]})")


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


def cmd_inspect(args) -> None:
    from .importers.loaders import identify_and_load

    bundle = identify_and_load(args.model, **_parse_kv(args.config))
    for name, model in bundle.models.items():
        g = model.graph
        census: Dict[str, int] = {}
        for sop in g.ops:
            census[sop.op.OP_TYPE] = census.get(sop.op.OP_TYPE, 0) + 1
        print(json.dumps({
            "name": name, "ops": len(g.ops),
            "weights": len(g.store),
            "weight_bytes": g.store.total_bytes(),
            "inputs": [g.tensors[t].name for t in g.inputs],
            "outputs": [g.tensors[t].name for t in g.outputs],
            "op_census": dict(sorted(census.items(), key=lambda kv: -kv[1])),
            "interfaces": {k: {kk: vv for kk, vv in v.items()
                               if isinstance(vv, (str, int, float, bool))}
                           for k, v in bundle.interfaces.items()},
        }, indent=2))


def cmd_export(args) -> None:
    """Convert any checkpoint the port loads to ONNX (reference
    identify_and_load -> ONNX bytes, crates/whisper-tensor-import/src/
    lib.rs:38)."""
    import os

    from .importers.loaders import identify_and_load, loader_registry

    cfg = _parse_kv(args.config)
    if args.loader == "auto":
        bundle = identify_and_load(args.model, **cfg)
    else:
        bundle = loader_registry()[args.loader].load(
            {"path": args.model, **cfg})
    names = list(bundle.models)
    if args.name:
        if args.name not in bundle.models:
            raise SystemExit(f"no model {args.name!r}; have {names}")
        names = [args.name]
    multi = len(names) > 1
    for name in names:
        out = args.output
        if multi:
            stem, ext = os.path.splitext(out)
            out = f"{stem}.{name}{ext or '.onnx'}"
        bundle.models[name].save_onnx(out, weights=args.weights)
        size = os.path.getsize(out)
        extra = ""
        if args.weights == "external":
            extra = f" + {os.path.getsize(out + '.bin')} B weights"
        print(f"{name}: wrote {out} ({size} B{extra})")


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

    i = sub.add_parser("image", help="text-to-image generation")
    i.add_argument("--model", help="diffusers pipeline dir (sd; "
                                   "model_index.json)")
    i.add_argument("-c", "--config", action="append", default=[])
    i.add_argument("--text-encoder")
    i.add_argument("--unet")
    i.add_argument("--vae")
    i.add_argument("--tokenizer")
    i.add_argument("--prompt", required=True)
    i.add_argument("--negative-prompt", default="")
    i.add_argument("--steps", type=int, default=20)
    i.add_argument("--cfg", type=float, default=7.5)
    i.add_argument("--height", type=int, default=512)
    i.add_argument("--width", type=int, default=512)
    i.add_argument("--seed", type=int, default=0)
    i.add_argument("--output", default="out.ppm")
    i.add_argument("--init-image",
                   help="PPM or PNG image for img2img/inpaint")
    i.add_argument("--strength", type=float, default=0.6,
                   help="img2img strength (1.0 = full txt2img noise)")
    i.add_argument("--mask-image",
                   help="PPM or PNG mask (white = repaint) -> inpainting")
    i.add_argument("--karras", action="store_true",
                   help="Karras rho-spaced sigmas (euler pipelines)")
    i.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    i.set_defaults(fn=cmd_image)

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

    n = sub.add_parser("inspect", help="load a model and print its structure")
    n.add_argument("--model", required=True)
    n.add_argument("-c", "--config", action="append", default=[])
    n.set_defaults(fn=cmd_inspect)

    x = sub.add_parser("export",
                       help="convert any supported checkpoint to ONNX")
    x.add_argument("--model", required=True)
    x.add_argument("--loader", default="auto")
    x.add_argument("-o", "--output", required=True,
                   help="output .onnx path (per-model suffix added when "
                        "the bundle has several models)")
    x.add_argument("--weights", default="external",
                   choices=["embed", "external", "none"])
    x.add_argument("--name", default=None,
                   help="export only this model from the bundle")
    x.add_argument("-c", "--config", action="append", default=[])
    x.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
