"""WebSocket server of the port: routes protocol messages to ModelServer
and Scheduler and streams reports back, with the port's interfaces and
ContinuousBatcher on a chosen torch device.

The port's own copy of whisper_tensor_tpu/server/main.py, trimmed to
the text flows it serves:
  * model registry: ping, list_loaders, run_loader, unload_model,
    list_models, get_model_graph, get_stored_tensor, get_tokenizer,
    compile_model;
  * generate_text, through the batcher for a `ragged_decode` model
    (`_batcher`, `_generate_text_ragged`, with a served LoRA `adapter`),
    else on the direct path (`_score_iface`: the model's `_text_iface`,
    or a ragged model's batcher interface for `with_probs`, `regex` /
    `json_schema` constrained decoding, `num_beams` beam search and
    `draft_model_id` speculative decoding), with sampling, stop strings
    and chat messages;
  * load_adapter: a PEFT adapter added to a batcher-served model at run
    time, by a replacement batcher (reference :379-416);
  * start_profiler / stop_profiler on torch.profiler: a Chrome trace of
    the host's ops and the card's kernels, written into the message's
    `dir` (default WT_PROFILE_DIR, else wt_profile in the temp dir);
  * cancel_request, update_observer_settings, get_batcher_stats;
  * `_score_iface`, which the OpenAI front end's logprobs, echo,
    embeddings, best_of reranking and constrained requests use.
  * inspection (reference :150-213, :293-352): get_graph_layout (the
    server-side layered layout of graph_layout.py, into control-flow
    bodies by `subgraph_path`), get_tensor_slice (exact values of a
    weight's 2-D slice with its statistics), get_op_milli (one symbolic
    op lowered to its milli ops), get_super_graph (a text model's
    tokenize -> prefill -> Scan(decode) -> detokenize job as JSON);
  * super_graph_request (reference :1137-1165): a SuperGraph job run on
    the Server's device, its node timings, progress and the tensors the
    client subscribed to (`tensor_subscriptions`: the graph's link names,
    and labels of tensors inside a model's graph, which become taps of
    that model's executor) streamed as reports. `backend_mode` defaults
    to "torch", the card: the numpy interpreter runs only when the
    client names "oracle" (the reference defaults to "oracle"); "xla"
    runs as "torch". A model with quantized weights (a `quantize`
    setting, or a GGUF's packed blocks) runs on its text interface's
    graph and device weights (`_score_iface`), int8 or packed as its
    text path runs them; another model on the Model's own backend. Each
    model's lowered graph and device weights are made once and shared by
    later jobs;
  * generate_image (reference :1023-1135): text to image, img2img and
    inpainting on the bundle's ImageGenerationInterface, and with
    `preview` the diffusion super graph, which streams one
    `step_preview` frame a denoise step (`_latent_preview_rgb`).
  * generate_text on a constant-state (RWKV) model (reference
    :833-858): greedy decoding on the RnnTextInterface (`_rnn_iface`);
  * generate_multimodal (reference :453-540): interleaved text and
    image items (`_mm_items`: PNG base64 or raw RGB, resized to the
    vision encoder's input) through a LLaVA bundle's
    MultimodalLanguageInterface (`_mm_iface`), which shares the text
    entry's interface.
  * transcribe (reference :565-602): f32 samples through the entry's
    SpeechToTextInterface (`_stt_iface`, one an entry), greedy on the
    device loop or beams, with a per-request `language`/`task` start
    sequence on a shallow copy that shares the device weights;
  * transcribe_stream (reference :604-648): a StreamingTranscriber a
    `stream_id`, answered in the reply;
  * generate_speech (reference :354-377): text to WAV through the
    bundle's TextToSpeechInterface or F5Synthesizer (`_tts_iface`, one a
    bundle).
The OpenAI front end's `/v1/images/generations` runs on `_image_iface`,
its chat with image content parts on `_mm_iface`, the audio routes on
`_stt_iface` and `_tts_iface`. `python -m whisper_tensor_tpu_torch.server.main
[--host H] [--port P] [--device cpu]` starts the server (`main`, the
reference's flags and --device; the card unless it says cpu).
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Set

import numpy as np

from ..device import resolve_device
from ..dtype import DType
from ..interfaces.text import SamplingParams, TextInferenceInterface
from ..super_graph import image as _sg_image  # noqa: F401  (node kinds)
from ..super_graph import llm as _sg_llm  # noqa: F401
from ..super_graph import training as _sg_training  # noqa: F401
from ..super_graph.graph import ExecutionContext, SuperGraph
from . import protocol as P
from .batching import ContinuousBatcher
from .model_server import ModelServer
from .scheduler import ObserverSettings, Scheduler
from .ws import WebSocketConnection, serve_websocket

def _latent_preview_rgb(lat) -> dict:
    """(1,C,H,W) latents -> small RGB frame dict for the live SD
    preview stream (no VAE decode — the standard cheap latent->RGB
    linear approximation, normalized per frame). The reference's
    (:27-41); device latents are downloaded first."""
    import base64

    from ..super_graph.nodes import host_value

    a = np.asarray(host_value(lat), dtype=np.float32)[0]
    rgb = a[:3] if a.shape[0] >= 3 else np.repeat(a[:1], 3, axis=0)
    lo, hi = float(rgb.min()), float(rgb.max())
    u8 = ((rgb - lo) / ((hi - lo) or 1.0) * 255).astype(np.uint8)
    u8 = u8.transpose(1, 2, 0)                      # (H, W, 3)
    return {"width": int(u8.shape[1]), "height": int(u8.shape[0]),
            "rgb_b64": base64.b64encode(
                np.ascontiguousarray(u8).tobytes()).decode()}


class Server:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.models = ModelServer()
        self.scheduler = Scheduler()
        self._conns: Set[WebSocketConnection] = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._text_ifaces: dict = {}      # entry id -> direct interface
        self._image_ifaces: dict = {}     # bundle id -> image interface
        self._mm_ifaces: dict = {}        # bundle id -> multimodal iface
        self._stt_ifaces: dict = {}       # entry id -> speech-to-text iface
        self._stt_streams: dict = {}      # stream_id -> StreamingTranscriber
        self._tts_ifaces: dict = {}       # bundle id -> text-to-speech iface
        self._image_lock = threading.Lock()   # one generation at a time
        self._batchers: dict = {}         # entry id -> ContinuousBatcher
        self._batch_jobs: dict = {}       # job_id -> (batcher, future)
        self._spec_decoders: dict = {}    # (target, draft, k) -> decoder
        self._profiler = None             # (torch.profiler.profile, dir)
        # the profiler starts and stops on one thread of its own (the
        # WebSocket handler runs each message on any executor thread)
        self._profiler_thread = None
        # guards get-then-create on the caches above: the HTTP front end
        # is a ThreadingHTTPServer, so two concurrent first requests
        # would otherwise both build (and upload) a batcher or interface
        self._cache_lock = threading.RLock()

    # -- report pump: scheduler queue -> all sockets ----------------------
    def _start_report_pump(self):
        def pump():
            while True:
                report = self.scheduler.reports.get()
                if report is None:
                    return
                data = json.dumps(_json_safe(report))
                loop = self._loop
                if loop is None:
                    continue
                for conn in list(self._conns):
                    asyncio.run_coroutine_threadsafe(conn.send_text(data), loop)

        threading.Thread(target=pump, daemon=True).start()

    # -- message handling ----------------------------------------------------
    async def handle(self, conn: WebSocketConnection):
        self._conns.add(conn)
        try:
            while True:
                raw = await conn.recv()
                if raw is None:
                    return
                try:
                    msg = P.parse_message(raw)
                    reply = await asyncio.get_event_loop().run_in_executor(
                        None, self._dispatch, msg)
                except Exception as e:  # noqa: BLE001
                    reply = {"type": P.JOB_ERROR, "error": str(e)}
                if reply is not None:
                    await conn.send_text(json.dumps(_json_safe(reply)))
        finally:
            self._conns.discard(conn)

    def _dispatch(self, msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        t = msg["type"]
        if t == P.PING:
            return {"type": P.PONG}
        if t == P.LIST_LOADERS:
            from ..importers.loaders import loader_registry

            return {"type": P.LOADERS_REPORT, "loaders": {
                name: {"description": ld.DESCRIPTION,
                       "config": [f.to_json() for f in ld.config_schema()]}
                for name, ld in loader_registry().items()}}
        if t == P.RUN_LOADER:
            entries = self.models.run_loader(msg["loader"], msg.get("config", {}))
            return {"type": P.MODELS_REPORT, "models": self.models.list_models(),
                    "loaded": [e.id for e in entries]}
        if t == P.UNLOAD_MODEL:
            mid = int(msg["model_id"])
            bid = (self.models.get(mid).meta.get("bundle_id")
                   if mid in self.models._models else None)
            with self._cache_lock:
                bat = self._batchers.pop(mid, None)
                self._text_ifaces.pop(mid, None)
                self._text_ifaces.pop(("rnn", mid), None)
                self._image_ifaces.pop(bid, None)
                self._mm_ifaces.pop(bid, None)
                self._stt_ifaces.pop(mid, None)
                self._tts_ifaces.pop(bid, None)
                # a decoder holds its models' interfaces (device weights)
                self._spec_decoders = {k: v for k, v in
                                       self._spec_decoders.items()
                                       if mid not in k[:2]}
            if bat is not None:
                bat.stop()
            self.models.unload(mid)
            return {"type": P.MODELS_REPORT, "models": self.models.list_models()}
        if t == P.LIST_MODELS:
            return {"type": P.MODELS_REPORT, "models": self.models.list_models()}
        if t == "get_batcher_stats":
            bat = self._batchers.get(int(msg["model_id"]))
            return {"type": "batcher_stats", "model_id": msg["model_id"],
                    "stats": bat.stats() if bat is not None else None}
        if t == P.GET_MODEL_GRAPH:
            return {"type": P.MODEL_GRAPH,
                    "graph": self.models.graph_json(int(msg["model_id"]))}
        if t == "get_graph_layout":
            # server-side layered layout (graph_layout.py)
            from .graph_layout import build_layout

            g = self.models.graph_json(int(msg["model_id"]))
            for key in msg.get("subgraph_path", ()):
                oid, attr = key
                op = next(o for o in g["ops"] if o["id"] == int(oid))
                g = op["subgraphs"][attr]
            return {"type": "graph_layout", "model_id": msg["model_id"],
                    "layout": build_layout(
                        g, max_ops=msg.get("max_ops"))}
        if t == "get_tensor_slice":
            return self._get_tensor_slice(msg)
        if t == "get_op_milli":
            return self._get_op_milli(msg)
        if t == "get_super_graph":
            return self._get_super_graph(msg)
        if t == P.SUPER_GRAPH_REQUEST:
            return self._super_graph_request(msg)
        if t == P.GENERATE_IMAGE:
            return self._generate_image(msg)
        if t == P.GET_STORED_TENSOR:
            entry = self.models.get(int(msg["model_id"]))
            arr = entry.model.graph.store.get_numeric(msg["name"]).numpy()
            if msg.get("abbreviated", True):
                return {"type": P.STORED_TENSOR, "name": msg["name"],
                        "tensor": P.AbbreviatedTensor.from_array(arr).__dict__}
            return {"type": P.STORED_TENSOR, "name": msg["name"],
                    "tensor": P.encode_tensor(arr)}
        if t == P.CANCEL_REQUEST:
            jid = int(msg["job"])
            batched = self._batch_jobs.get(jid)
            if batched is not None:
                bat, fut = batched
                ok = bat.cancel(fut)
            else:
                ok = self.scheduler.cancel(jid)
            return {"type": "cancel_ack", "job": msg["job"], "ok": ok}
        if t == P.UPDATE_OBSERVER_SETTINGS:
            ok = self.scheduler.update_settings(int(msg["job"]),
                                                **msg.get("settings", {}))
            return {"type": "settings_ack", "job": msg["job"], "ok": ok}
        if t == P.COMPILE_MODEL:
            # one warm-up generate, so the first request finds the
            # kernels built and the executor's plans recorded
            entry = self.models.get(int(msg["model_id"]))
            if entry.interfaces.get("text") is None:
                raise ValueError("model has no text interface to compile")
            t0 = time.time()
            iface = self._text_iface(entry)
            B = int(msg.get("batch", 1))
            n_new = int(msg.get("max_new_tokens", 32))
            iface.generate_tokens(np.zeros((B, 8), dtype=np.int64), n_new)
            entry.meta["compiled"] = True
            return {"type": P.MODEL_COMPILED, "model_id": msg["model_id"],
                    "seconds": round(time.time() - t0, 2)}
        if t == P.GET_TOKENIZER:
            import os

            entry = self.models.get(int(msg["model_id"]))
            src = entry.tokenizer_source
            if not src:
                raise ValueError("model has no tokenizer source")
            path = (src if os.path.isfile(src)
                    else os.path.join(src, "tokenizer.json"))
            with open(path, encoding="utf-8") as f:
                return {"type": P.TOKENIZER_FILE,
                        "model_id": msg["model_id"], "json": f.read()}
        if t == P.START_PROFILER:
            return self._start_profiler(msg)
        if t == P.STOP_PROFILER:
            return self._stop_profiler()
        if t == P.GENERATE_TEXT:
            return self._generate_text(msg)
        if t == P.LOAD_ADAPTER:
            return self._load_adapter(msg)
        if t == "generate_multimodal":
            return self._generate_multimodal(msg)
        if t == "generate_speech":
            return self._generate_speech(msg)
        if t == "transcribe":
            return self._transcribe(msg)
        if t == "transcribe_stream":
            return self._transcribe_stream(msg)
        raise ValueError(f"unknown message type {t!r}")

    # -- inspection and super graphs ---------------------------------------------
    def _get_tensor_slice(self, msg) -> dict:
        """Exact-value N-D slicing for the UI inspect windows (reference
        inspect_windows.rs value tables): `fix` pins an index per axis;
        nulls mark the (up to 2) display axes."""
        entry = self.models.get(int(msg["model_id"]))
        a = np.asarray(entry.model.graph.store.get_numeric(
            msg["name"]).numpy())
        af = a.astype(np.float32, copy=False)
        finite = af[np.isfinite(af)] if af.size else af
        stats = {"min": float(finite.min()) if finite.size else 0.0,
                 "max": float(finite.max()) if finite.size else 0.0,
                 "mean": float(finite.mean()) if finite.size else 0.0,
                 "std": float(finite.std()) if finite.size else 0.0,
                 "nan": int(np.isnan(af).sum()) if af.size else 0}
        fix = msg.get("fix") or [None] * a.ndim
        if len(fix) != a.ndim:
            raise ValueError(f"fix has {len(fix)} entries for a "
                             f"{a.ndim}-d tensor")
        free = [d for d, v in enumerate(fix) if v is None]
        if len(free) > 2:       # display the trailing two free axes
            for d in free[:-2]:
                fix[d] = 0
            free = free[-2:]
        idx = tuple(slice(None) if v is None else
                    int(v) % max(int(a.shape[d]), 1)
                    for d, v in enumerate(fix))
        sl = np.atleast_2d(af[idx])     # 0 free axes -> (1,1); 1 -> (1,N)
        ro = min(max(int(msg.get("row_off", 0)), 0), max(sl.shape[0] - 1, 0))
        co = min(max(int(msg.get("col_off", 0)), 0), max(sl.shape[1] - 1, 0))
        mr = min(int(msg.get("max_rows", 64)), 512)
        mc = min(int(msg.get("max_cols", 64)), 512)
        view = sl[ro:ro + mr, co:co + mc]
        return {"type": "tensor_slice", "name": msg["name"],
                "shape": list(a.shape), "dtype": str(a.dtype),
                "slice_shape": list(sl.shape),
                "row_off": ro, "col_off": co,
                "free_axes": free, "fix": fix,
                "values": [[(None if not np.isfinite(v) else
                             round(float(v), 6)) for v in row]
                           for row in view],
                "stats": stats}

    def _get_op_milli(self, msg) -> dict:
        """Lower ONE symbolic op to its milli ops (the nested
        symbolic->milli graph navigation of the reference UI,
        crates/whisper-tensor-ui/src/graph_explorer/)."""
        import dataclasses

        from ..milli.ir import MilliGraph
        from ..symbolic_graph.ops.base import LowerCtx

        entry = self.models.get(int(msg["model_id"]))
        g = entry.model.graph
        sop = next((o for o in g.ops if o.id == int(msg["op_id"])), None)
        if sop is None:
            raise ValueError(f"no op {msg['op_id']}")
        milli = MilliGraph(f"op:{sop.op.OP_TYPE}")
        ctx = LowerCtx(milli)
        in_ids = [milli.add_input(g.tensors[i].name) if i is not None
                  else None for i in sop.inputs]
        outs = sop.op.lower(ctx, in_ids, len(sop.outputs))
        for k, o in enumerate(outs):
            name = (g.tensors[sop.outputs[k]].name
                    if sop.outputs[k] is not None else f"o{k}")
            milli.mark_output(name, o)
        nodes = []
        for node in milli.nodes:
            params = {}
            if dataclasses.is_dataclass(node.op):
                for f in dataclasses.fields(node.op):
                    v = getattr(node.op, f.name)
                    if isinstance(v, np.ndarray):
                        v = f"ndarray{list(v.shape)}"
                    params[f.name] = v
            nodes.append({"kind": node.op.KIND, "params": params,
                          "inputs": node.inputs, "outputs": node.outputs})
        return {"type": "op_milli", "op_id": sop.id,
                "op_type": sop.op.OP_TYPE,
                "inputs": {n: tid for n, tid in milli.inputs.items()},
                "outputs": {n: tid for n, tid in milli.outputs.items()},
                "nodes": nodes}

    def _get_super_graph(self, msg) -> dict:
        """The SuperGraph-level view of a loaded text model: the full
        tokenize -> prefill -> Scan(decode) -> detokenize job as JSON,
        with nested Scan bodies included — the top layer of the
        reference UI's SuperGraph -> Symbolic -> Milli navigation."""
        from ..super_graph.llm import build_llm_supergraph

        entry = self.models.get(int(msg["model_id"]))
        cfg = entry.interfaces.get("text")
        if cfg is None:
            raise ValueError("model has no text interface")
        sg = build_llm_supergraph(
            entry.name, entry.tokenizer_source or "bytes",
            n_layers=int(cfg["n_layers"]),
            n_kv_heads=int(cfg["n_kv_heads"]), max_len=int(cfg["max_len"]),
            head_dim=int(cfg["head_dim"]),
            n_new=int(msg.get("n_new", 16)))
        return {"type": "super_graph", "model_id": int(msg["model_id"]),
                "graph": sg.to_json()}

    def _super_graph_request(self, msg) -> None:
        """Run a SuperGraph job on the Server's device (see the module
        docstring); its result answers the graph's outputs as the
        reference's JSON."""
        graph = SuperGraph.from_json(msg["graph"])

        def decode_value(v):
            if isinstance(v, dict) and "data_b64" in v:
                return P.decode_tensor(v)
            if isinstance(v, dict):  # tensor map
                return {k: decode_value(x) for k, x in v.items()}
            return v

        feeds: Dict[str, Any] = {name: decode_value(v)
                                 for name, v in msg.get("inputs", {}).items()}
        entries = [self.models.get(int(i)) for i in msg.get("model_ids", [])]
        models = {e.name: e.model for e in entries}
        backend_mode = msg.get("backend_mode", "torch")
        settings = ObserverSettings(
            tensor_subscriptions=set(msg.get("tensor_subscriptions", [])))

        def job(obs):
            # a model with quantized weights runs on its text interface's
            # graph and weights
            backends = {e.name: self._score_iface(e).eval_backend()
                        for e in entries if backend_mode != "oracle"
                        and "text" in e.interfaces
                        and (e.interfaces["text"].get("quantize")
                             or e.model.graph.store.packed_sources)}
            ctx = ExecutionContext(models=models, backend_mode=backend_mode,
                                   observer=obs,
                                   capture_labels=settings.tensor_subscriptions,
                                   device=self.device, backends=backends)
            out = graph.run(ctx, feeds)
            return {k: (P.encode_tensor(v) if isinstance(v, np.ndarray) else
                        v if isinstance(v, (str, int, float, bool, list)) else
                        repr(v))
                    for k, v in out.items()}

        self.scheduler.submit(job, settings)
        return None  # job_accepted is emitted via the report pump

    def _generate_image(self, msg) -> None:
        """Run an image pipeline bundle (diffusers loader) on the Server's
        device; the result carries raw RGB bytes + dims (canvas-ready).
        With `preview` the diffusion super graph runs instead and streams
        one `step_preview` frame a denoise step."""
        import base64

        from ..interfaces.image_gen import ImageGenConfig

        bid = msg.get("bundle_id")
        if bid is None:
            bid = self.models.get(int(msg["model_id"])).meta.get("bundle_id")
        bundle = self.models.bundle(int(bid))
        if "image" not in bundle.interfaces:
            raise ValueError("bundle has no image interface")
        iface = self._image_iface_of(int(bid))
        spec = bundle.interfaces["image"]
        cfg = ImageGenConfig(
            steps=int(msg.get("steps", 20)),
            guidance_scale=float(msg.get("guidance_scale", 7.5)),
            height=int(msg.get("height", spec.get("height", 512))),
            width=int(msg.get("width", spec.get("width", 512))),
            schedule=("rectified_flow" if spec["pipeline"] in ("sd3", "flux")
                      else "euler"),
            seed=int(msg.get("seed", 0)))
        settings = ObserverSettings(report_progress=True)

        def rgb(img) -> dict:
            return {"width": img.pixels.shape[1],
                    "height": img.pixels.shape[0],
                    "rgb_b64": base64.b64encode(
                        img.pixels.tobytes()).decode()}

        if msg.get("preview") and spec["pipeline"] == "sd":
            # live per-step latent previews (reference sd_explorer.rs):
            # the introspectable SuperGraph job, each denoise step a node
            # whose latents the observer turns into a small RGB frame
            from ..super_graph.image import build_diffusion_supergraph

            te = bundle.models[spec["text_encoder"]]
            unet = bundle.models[spec["unet"]]
            vae = bundle.models[spec["vae"]]
            sg = build_diffusion_supergraph(
                te.name, unet.name, vae.name, steps=cfg.steps,
                guidance_scale=cfg.guidance_scale,
                latent_channels=spec["latent_channels"],
                latent_hw=(cfg.height // 8, cfg.width // 8),
                seed=cfg.seed,
                prediction_type=spec.get("prediction_type", "epsilon"),
                bos_token_id=spec.get("bos_token_id", 49406),
                eos_token_id=spec.get("eos_token_id", 49407),
                seq_len=spec.get("seq_len", 77))
            ids = iface.encode_prompt(msg.get("prompt", ""))
            nids = iface.encode_prompt(msg.get("negative_prompt", ""))

            def preview_job(obs):
                out_q, job_id = obs.out, obs.job_id
                orig_assign, orig_subscribed = (obs.on_tensor_assigned,
                                                obs.subscribed)

                def on_assign(link_name, value):
                    if link_name == "step_latents":
                        out_q.put({"type": "step_preview", "job": job_id,
                                   **_latent_preview_rgb(value)})
                    if orig_subscribed(link_name):
                        orig_assign(link_name, value)

                obs.on_tensor_assigned = on_assign
                obs.subscribed = lambda name: (name == "step_latents"
                                               or orig_subscribed(name))
                ctx = ExecutionContext(
                    models={te.name: te, unet.name: unet, vae.name: vae},
                    backend_mode="torch", observer=obs, device=self.device)
                with self._image_lock:
                    out = sg.run(ctx, {"prompt_ids": ids,
                                       "negative_ids": nids})
                return rgb(out["image"])

            self.scheduler.submit(preview_job, settings)
            return None

        init = msg.get("init_image")     # {rgb_b64, width, height}
        mask = msg.get("mask_image")
        strength = float(msg.get("strength", 0.6))

        def _decode_rgb(d):
            raw = base64.b64decode(d["rgb_b64"])
            return np.frombuffer(raw, np.uint8).reshape(
                int(d["height"]), int(d["width"]), 3)

        def job(obs):
            with self._image_lock:
                if init is not None and mask is not None:
                    m = _decode_rgb(mask).astype(np.float32).mean(-1) / 255.0
                    img = iface.run_inpaint(
                        msg.get("prompt", ""), _decode_rgb(init), m,
                        negative_prompt=msg.get("negative_prompt", ""),
                        cfg=cfg, observer=obs)
                elif init is not None:
                    img = iface.run_img2img(
                        msg.get("prompt", ""), _decode_rgb(init),
                        strength=strength,
                        negative_prompt=msg.get("negative_prompt", ""),
                        cfg=cfg, observer=obs)
                else:
                    img = iface.run(msg.get("prompt", ""),
                                    msg.get("negative_prompt", ""), cfg,
                                    observer=obs)
            return rgb(img)

        self.scheduler.submit(job, settings)
        return None  # job_accepted is emitted via the report pump

    # -- the profiler ----------------------------------------------------------
    def _start_profiler(self, msg) -> dict:
        """torch.profiler over the host's ops and, on the card, its
        kernels (CUPTI), until stop_profiler (reference :255-264)."""
        import torch

        pdir = (msg.get("dir") or os.environ.get("WT_PROFILE_DIR")
                or os.path.join(tempfile.gettempdir(), "wt_profile"))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with self._cache_lock:
            if self._profiler is not None:
                raise ValueError("the profiler is already running")
            if self._profiler_thread is None:
                from concurrent.futures import ThreadPoolExecutor

                self._profiler_thread = ThreadPoolExecutor(
                    1, thread_name_prefix="wt-profiler")
            # every thread's ops (the batcher's and the job worker's),
            # as jax.profiler traces the whole process
            prof = torch.profiler.profile(
                activities=acts, experimental_config=torch._C._profiler.
                _ExperimentalConfig(profile_all_threads=True))
            self._profiler_thread.submit(prof.start).result()
            self._profiler = (prof, pdir)
        return {"type": P.PROFILER_ACK, "started": True, "dir": pdir}

    def _stop_profiler(self) -> dict:
        """Stop the trace and write it into the start message's dir as a
        Chrome trace (chrome://tracing, Perfetto)."""
        with self._cache_lock:
            if self._profiler is None:
                raise ValueError("the profiler is not running")
            (prof, pdir), self._profiler = self._profiler, None
        self._profiler_thread.submit(prof.stop).result()
        os.makedirs(pdir, exist_ok=True)
        path = os.path.join(pdir, f"trace_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return {"type": P.PROFILER_ACK, "started": False, "dir": pdir,
                "trace": path}

    # -- interfaces and batchers ---------------------------------------------
    def _text_iface(self, entry) -> TextInferenceInterface:
        with self._cache_lock:
            iface = self._text_ifaces.get(entry.id)
            if iface is None:
                cfg = entry.interfaces["text"]
                iface = TextInferenceInterface(
                    entry.model, max_len=int(cfg["max_len"]),
                    cache_dtype=DType.BF16,
                    eos_token_id=cfg.get("eos_token_id"),
                    quantize=cfg.get("quantize") or None,
                    device=self.device)
                self._text_ifaces[entry.id] = iface
            return iface

    def _rnn_iface(self, entry):
        """The RnnTextInterface of a constant-state (RWKV) model, built
        on the Server's device at the first request."""
        from ..interfaces.rnn_text import RnnTextInterface

        with self._cache_lock:
            iface = self._text_ifaces.get(("rnn", entry.id))
            if iface is None:
                iface = RnnTextInterface(entry.model, device=self.device)
                self._text_ifaces[("rnn", entry.id)] = iface
            return iface

    def _mm_iface(self, entry):
        """The MultimodalLanguageInterface of a LLaVA-style bundle and
        its spec: one a bundle, on the text entry's interface."""
        from ..interfaces.multimodal import MultimodalLanguageInterface

        bid = int(entry.meta["bundle_id"])
        bundle = self.models.bundle(bid)
        if "multimodal" not in bundle.interfaces:
            raise ValueError("model has no multimodal interface")
        spec = bundle.interfaces["multimodal"]
        with self._cache_lock:
            mm = self._mm_ifaces.get(bid)
            if mm is None:
                text_entry = next(
                    e for e in self.models._models.values()
                    if e.name == spec["model"]
                    and int(e.meta.get("bundle_id", -1)) == bid)
                mm = MultimodalLanguageInterface(
                    self._text_iface(text_entry),
                    embed_weight_name=spec["embed_weight"],
                    vision_encoder=bundle.models[spec["vision"]])
                self._mm_ifaces[bid] = mm
            return mm, spec

    @staticmethod
    def _mm_items(spec, items):
        """Wire items [{text} | {image_b64: PNG} | {rgb_b64, width,
        height}] -> MultimodalItems; images are resized to the vision
        encoder's square input."""
        import base64

        from ..super_graph.links import Image as ImageLink
        from ..super_graph.links import MultimodalItem
        from ..utils.image import png_to_array, resize_bilinear

        size = int(spec.get("image_size", 224))

        def fit(px):
            if px.ndim == 2:
                px = px[:, :, None]
            if px.shape[2] == 2:     # PNG color type 4: gray + alpha
                px = px[:, :, :1]
            if px.shape[2] == 1:
                px = np.repeat(px, 3, axis=2)
            if px.shape[2] == 4:
                px = px[:, :, :3]
            if px.shape[:2] != (size, size):
                px = resize_bilinear(px, size, size)
            return px

        out = []
        for it in items:
            if it.get("text"):
                out.append(MultimodalItem(text=it["text"]))
            elif it.get("image_b64"):
                px = png_to_array(base64.b64decode(it["image_b64"]))
                out.append(MultimodalItem(image=ImageLink(fit(px))))
            elif it.get("rgb_b64"):
                raw = base64.b64decode(it["rgb_b64"])
                px = np.frombuffer(raw, np.uint8).reshape(
                    int(it["height"]), int(it["width"]), 3)
                out.append(MultimodalItem(image=ImageLink(fit(px))))
            else:
                raise ValueError("item needs text, image_b64, or rgb_b64")
        if not out:
            raise ValueError("no items")
        return out

    def _generate_multimodal(self, msg) -> None:
        """Interleaved image and text generation through the
        inputs_embeds prefill (reference :519-540), as a scheduler job."""
        entry = self.models.get(int(msg["model_id"]))
        mm, spec = self._mm_iface(entry)
        if mm.text.tokenizer is None:
            from ..tokenizer import AnyTokenizer

            mm.text.tokenizer = AnyTokenizer.load(
                entry.tokenizer_source or "bytes")
        items = self._mm_items(spec, msg.get("items") or [])
        n_new = int(msg.get("max_new_tokens", 32))
        sampling = self._sampling_from_msg(msg)

        def job(obs):
            return {"text": mm.run_items_in_string_out(
                items, n_new, sampling=sampling)}

        self.scheduler.submit(job, ObserverSettings())
        return None

    # -- speech --------------------------------------------------------------
    def _stt_iface(self, entry):
        """The entry's SpeechToTextInterface, built on the Server's device
        at the first request and kept: its fused decoder step and device
        weights serve every later transcription."""
        from ..interfaces.stt import SpeechToTextInterface

        with self._cache_lock:
            iface = self._stt_ifaces.get(entry.id)
            if iface is None:
                bundle = self.models.bundle(int(entry.meta["bundle_id"]))
                if "stt" not in bundle.interfaces:
                    raise ValueError("model has no STT interface")
                tok = None
                if entry.tokenizer_source:
                    from ..tokenizer import AnyTokenizer

                    tok = AnyTokenizer.load(entry.tokenizer_source)
                iface = SpeechToTextInterface.from_bundle(
                    bundle, tokenizer=tok, device=self.device)
                # the fused decoder step, built here: the copies
                # _with_sot makes share it and its device weights
                _ = iface.dec
                self._stt_ifaces[entry.id] = iface
            return iface

    @staticmethod
    def _with_sot(iface, language, task):
        """A shallow copy of `iface` with the request's start sequence
        (it shares the fused decoder step `_stt_iface` built, and its
        device weights), or `iface` itself."""
        if not (language or task):
            return iface
        import copy

        sot = iface.sot_with(language=language or None, task=task or None)
        iface = copy.copy(iface)
        iface.sot_sequence = sot
        return iface

    def _transcribe(self, msg) -> None:
        """STT: f32 samples -> text, as a scheduler job."""
        import base64

        from ..super_graph.links import AudioClip

        entry = self.models.get(int(msg["model_id"]))
        iface = self._with_sot(self._stt_iface(entry), msg.get("language"),
                               msg.get("task"))
        samples = np.frombuffer(base64.b64decode(msg["samples_b64"]),
                                dtype=np.float32)
        clip = AudioClip(samples, int(msg.get("sample_rate", 16000)))
        beam = int(msg.get("beam", 1))
        max_new = int(msg.get("max_new_tokens", 64))

        def job(obs):
            if beam > 1:
                if iface.tokenizer is None:
                    raise ValueError("no tokenizer configured for "
                                     "text output")
                toks = iface.transcribe_beam(clip, max_new=max_new,
                                             beam=beam)
                return {"text": iface.tokenizer.decode(toks)}
            return {"text": iface.run_audio_in_text_out(clip,
                                                        max_new=max_new)}

        self.scheduler.submit(job, ObserverSettings())
        return None

    def _transcribe_stream(self, msg) -> dict:
        """Streaming STT: audio chunks under a stream_id; text comes back
        in the reply as it stabilizes (LocalAgreement-2, or window-
        boundary commits with local_agreement=null); `final` flushes
        and closes the stream."""
        import base64

        from ..interfaces.stt import StreamingTranscriber

        sid = str(msg.get("stream_id", "default"))
        st = self._stt_streams.get(sid)
        if st is None:
            entry = self.models.get(int(msg["model_id"]))
            iface = self._with_sot(self._stt_iface(entry),
                                   msg.get("language"), msg.get("task"))
            st = StreamingTranscriber(
                iface, local_agreement=msg.get("local_agreement", 2),
                max_new_per_window=int(msg.get("max_new_tokens", 224)))
            self._stt_streams[sid] = st
        new = []
        if msg.get("samples_b64") is not None:
            # an empty chunk still re-decodes the buffer (it advances
            # the LocalAgreement hypothesis window)
            samples = np.frombuffer(base64.b64decode(msg["samples_b64"]),
                                    dtype=np.float32)
            new = st.feed(samples, int(msg.get("sample_rate", 16000)))
        final = bool(msg.get("final"))
        if final:
            new = new + st.flush()
            self._stt_streams.pop(sid, None)
        tok = st.iface.tokenizer
        return {"type": "transcribe_stream_update", "stream_id": sid,
                "tokens": [int(x) for x in new],
                "text": (tok.decode(new) if tok is not None else None),
                "pending": (tok.decode(st.pending)
                            if tok is not None and not final else ""),
                "final": final}

    def _tts_iface(self, entry):
        """The bundle's TextToSpeechInterface (or F5Synthesizer), built on
        the Server's device at the first request."""
        from ..interfaces.tts import TextToSpeechInterface

        bid = int(entry.meta["bundle_id"])
        with self._cache_lock:
            iface = self._tts_ifaces.get(bid)
            if iface is None:
                bundle = self.models.bundle(bid)
                if "tts" not in bundle.interfaces:
                    raise ValueError("model has no TTS interface")
                iface = TextToSpeechInterface.from_bundle(bundle,
                                                          device=self.device)
                self._tts_ifaces[bid] = iface
            return iface

    def _generate_speech(self, msg) -> None:
        """TTS: text -> WAV bytes, as a scheduler job."""
        import base64

        from ..utils.audio import wav_bytes

        iface = self._tts_iface(self.models.get(int(msg["model_id"])))
        voice = int(msg.get("voice", 0))

        def job(obs):
            clip = iface.run_text_to_audio(msg["text"], voice=voice)
            return {"wav_b64": base64.b64encode(
                wav_bytes(clip.samples, clip.sample_rate)).decode(),
                "sample_rate": clip.sample_rate,
                "seconds": round(len(clip.samples) / clip.sample_rate, 3)}

        self.scheduler.submit(job, ObserverSettings())
        return None

    def _image_iface(self, entry):
        """The image interface of an entry's bundle (its text encoder,
        UNet and VAE entries share one), built on the Server's device at
        the first request."""
        return self._image_iface_of(int(entry.meta["bundle_id"]))

    def _image_iface_of(self, bid: int):
        from ..interfaces.image_gen import image_interface_from_bundle

        with self._cache_lock:
            iface = self._image_ifaces.get(bid)
            if iface is None:
                iface = image_interface_from_bundle(
                    self.models.bundle(bid), device=self.device)
                self._image_ifaces[bid] = iface
            return iface

    def _score_iface(self, entry) -> TextInferenceInterface:
        """Interface for teacher-forced scoring (logprobs / echo).
        Batcher-served models reuse the batcher's own interface: its
        weights are already on the device."""
        if (entry.interfaces.get("text") or {}).get("ragged"):
            return self._batcher(entry).iface
        return self._text_iface(entry)

    def _batcher(self, entry) -> ContinuousBatcher:
        """Shared ContinuousBatcher for ragged-decode models: concurrent
        generate_text requests batch into one decode instead of
        serializing through the job worker."""
        with self._cache_lock:
            bat = self._batchers.get(entry.id)
            if bat is None:
                bat = self._make_batcher(entry).start()
                self._batchers[entry.id] = bat
            return bat

    def _make_batcher(self, entry, share=None) -> ContinuousBatcher:
        """Construct (not start) the batcher from the entry's text spec:
        install_adapters runs here, so an invalid adapter set fails
        before any registry mutation. `share`: a batcher of the same
        model whose device weights the new one takes where they match
        (load_adapter's replacement)."""
        from ..importers.lora import load_peft_adapter_arrays

        cfg = entry.interfaces["text"]
        pc = cfg.get("prefill_chunk")
        adapters = {aname: load_peft_adapter_arrays(apath, cfg["weight_map"])
                    for aname, apath in (cfg.get("adapters") or {}).items()}
        bat = ContinuousBatcher(
            entry.model, max_len=int(cfg["max_len"]),
            max_batch=int(cfg.get("max_batch", 8)),
            chunk=int(cfg.get("chunk", 16)),
            chunk_max=(int(cfg["chunk_max"]) if cfg.get("chunk_max")
                       else None),
            admit_coalesce_s=float(cfg.get("admit_coalesce_s", 0.05)),
            auto_prefix=int(cfg.get("auto_prefix", 0) or 0),
            cache_dtype=DType.BF16,
            prefill_chunk=int(pc) if pc else None,
            quantize=cfg.get("quantize") or None,
            eos_token_id=cfg.get("eos_token_id"),
            adapters=adapters or None,
            device=self.device)
        if share is not None:
            bat.iface.share_weights(share.iface)
        return bat

    def _load_adapter(self, msg) -> dict:
        """Add a PEFT adapter to a batcher-served model at run time
        (reference :379-416): the replacement batcher, carrying the
        extended adapter set, is built eagerly (its weights are the old
        batcher's device tensors where they match, the new adapter
        stacks uploaded) and takes new requests at once, while the old
        one drains its in-flight requests in a thread. A bad adapter
        fails before the registry changes."""
        from ..importers.lora import load_peft_adapter_arrays

        entry = self.models.get(int(msg["model_id"]))
        cfg = entry.interfaces.get("text") or {}
        if not cfg.get("ragged"):
            raise ValueError("load_adapter needs a ragged-decode "
                             "(batcher-served) model")
        if not cfg.get("weight_map"):
            raise ValueError("this model family has no weight map for "
                             "adapter serving")
        name, path = str(msg["name"]), str(msg["path"])
        old_ads = dict(cfg.get("adapters") or {})
        if name in old_ads:
            raise ValueError(f"adapter {name!r} already loaded")
        load_peft_adapter_arrays(path, cfg["weight_map"])  # fail fast
        with self._cache_lock:
            cfg["adapters"] = {**old_ads, name: path}
            try:
                new = self._make_batcher(entry, self._batchers.get(entry.id))
            except Exception:
                cfg["adapters"] = old_ads
                raise
            old = self._batchers.pop(entry.id, None)
            self._batchers[entry.id] = new.start()
            self._spec_decoders = {k: v for k, v in
                                   self._spec_decoders.items()
                                   if entry.id not in k[:2]}
        if old is not None:
            threading.Thread(target=old.drain, daemon=True).start()
        return {"type": P.ADAPTER_LOADED, "model_id": entry.id,
                "name": name, "adapters": sorted(cfg["adapters"])}

    # -- text generation -------------------------------------------------------
    @staticmethod
    def _sampling_from_msg(msg) -> Optional[SamplingParams]:
        """Message sampling knobs -> SamplingParams (None = greedy). A
        penalties-only message stays penalized-greedy."""
        temp = float(msg.get("temperature", 0.0))
        if (temp <= 0.0 and float(msg.get("repetition_penalty", 1.0)) == 1.0
                and float(msg.get("presence_penalty", 0.0)) == 0.0
                and float(msg.get("frequency_penalty", 0.0)) == 0.0):
            return None
        return SamplingParams(
            temperature=max(temp, 0.0),
            top_k=int(msg.get("top_k", 0)),
            top_p=float(msg.get("top_p", 1.0)),
            min_p=float(msg.get("min_p", 0.0)),
            repetition_penalty=float(msg.get("repetition_penalty", 1.0)),
            presence_penalty=float(msg.get("presence_penalty", 0.0)),
            frequency_penalty=float(msg.get("frequency_penalty", 0.0)),
            seed=int(msg.get("seed", 0)))

    def _generate_text_ragged(self, msg, entry, tok, n_new,
                              sampling=None) -> None:
        bat = self._batcher(entry)
        ids = np.asarray(tok.encode(msg["prompt"]), dtype=np.int64)
        adapter = msg.get("adapter") or None
        if adapter is not None and adapter not in bat.iface.adapter_slots:
            # refused before JOB_ACCEPTED, which would strand the job
            raise ValueError(
                f"unknown adapter {adapter!r} (loaded: "
                f"{[n for n in bat.iface.adapter_slots if n]})")
        job_id = next(self.scheduler._next)
        self.scheduler.reports.put({"type": P.JOB_ACCEPTED, "job": job_id})
        stops = [s for s in (msg.get("stop") or []) if s]
        # incremental detokenization: on_tok runs on the batcher's
        # single scheduler thread, so per-token work must stay O(1)
        from ..tokenizer import IncrementalDecoder

        dec = IncrementalDecoder(tok) if stops else None
        max_stop = max((len(s) for s in stops), default=0)
        state = {"hit": None, "fut": None, "prev": 0}

        def on_tok(t):
            self.scheduler.reports.put({"type": P.PROGRESS, "job": job_id,
                                        "token": int(t)})
            if stops and state["hit"] is None:
                dec.push(int(t))
                # a stop can only newly appear within max_stop chars of
                # the previous end: search that window, not all text
                start = max(0, state["prev"] - max_stop)
                ctx = dec.text_from(start)
                state["prev"] = dec.length
                best = None
                for s in stops:
                    i = ctx.find(s)
                    if i >= 0 and (best is None or start + i < best):
                        best = start + i
                if best is not None:
                    state["hit"] = dec.text[:best]
                    # a hit also frees the row on the device
                    if state["fut"] is not None:
                        bat.cancel(state["fut"])

        fut = bat.submit(ids, n_new, on_token=on_tok, sampling=sampling,
                         adapter=adapter)
        state["fut"] = fut
        if state["hit"] is not None:       # hit during the race window
            bat.cancel(fut)
        self._batch_jobs[job_id] = (bat, fut)

        def done(f):
            self._batch_jobs.pop(job_id, None)
            try:
                toks = [int(x) for x in f.result()]
                if bat.eos_token_ids:
                    hits = [toks.index(e) for e in bat.eos_token_ids
                            if e in toks]
                    if hits:
                        toks = toks[:min(hits)]
                if state["hit"] is not None:
                    text = state["hit"]
                else:
                    text = tok.decode(toks)
                    for s in stops:
                        i = text.find(s)
                        if i >= 0:
                            text = text[:i]
                            break
                self.scheduler.reports.put({"type": P.JOB_RESULT,
                                            "job": job_id,
                                            "result": {"text": text}})
            except Exception as e:  # noqa: BLE001
                self.scheduler.reports.put({"type": P.JOB_ERROR,
                                            "job": job_id,
                                            "error": f"{type(e).__name__}: {e}"})

        fut.add_done_callback(done)

    def _generate_text(self, msg) -> None:
        entry = self.models.get(int(msg["model_id"]))
        iface_cfg = entry.interfaces.get("text")
        if iface_cfg is None:
            raise ValueError("model has no text interface")
        from ..tokenizer import AnyTokenizer, apply_chat_template

        tok = AnyTokenizer.load(msg.get("tokenizer")
                                or entry.tokenizer_source or "bytes")
        if msg.get("messages") and not msg.get("prompt"):
            # chat form: render the tokenizer's chat template (or the
            # ChatML fallback) into the prompt every path below uses
            msg["prompt"] = apply_chat_template(tok, msg["messages"])
        n_new = int(msg.get("max_new_tokens", 32))
        if iface_cfg.get("rnn_state"):
            return self._generate_text_rnn(msg, entry, tok, n_new)
        regex, json_schema = msg.get("regex"), msg.get("json_schema")
        constrained = regex is not None or json_schema is not None
        beams = int(msg.get("num_beams", 1))
        draft_id = msg.get("draft_model_id")
        with_probs = bool(msg.get("with_probs"))
        if constrained and (beams > 1 or draft_id is not None):
            raise ValueError("regex/json_schema constraints are not "
                             "supported with num_beams or draft_model_id")
        if msg.get("adapter") and (
                not iface_cfg.get("ragged") or constrained or with_probs
                or beams > 1 or draft_id is not None):
            # only the batcher selects adapters; the direct path would
            # answer from the base model
            raise ValueError("adapter is served by the batcher alone: "
                             "not on a direct-path model, nor with "
                             "regex/json_schema, with_probs, num_beams or "
                             "draft_model_id")
        if draft_id is not None:
            self._generate_speculative(msg, entry, tok, n_new,
                                       int(draft_id))
            return None
        if beams > 1:
            iface = self._score_iface(entry)

            def beam_job(obs):
                ids = np.asarray(tok.encode(msg["prompt"]),
                                 dtype=np.int64)[None]
                toks = iface.beam_search_tokens(
                    ids, n_new, beam=beams,
                    length_penalty=float(msg.get("length_penalty", 0.0)),
                    eos_token_id=msg.get("eos_token_id"))[0]
                return {"text": tok.decode([int(t) for t in toks])}

            self.scheduler.submit(beam_job, ObserverSettings())
            return None
        sampling = self._sampling_from_msg(msg)
        if iface_cfg.get("ragged") and not with_probs and not constrained:
            # with_probs needs the direct path's teacher-forced rescore,
            # and a constraint the direct path's per-step mask
            self._generate_text_ragged(msg, entry, tok, n_new,
                                       sampling=sampling)
            return None
        iface = self._score_iface(entry)
        iface.tokenizer = tok
        settings = ObserverSettings(
            tensor_subscriptions=set(msg.get("tensor_subscriptions", [])))
        stops = [s for s in (msg.get("stop") or []) if s]

        def _trim(text):
            for s in stops:
                i = text.find(s)
                if i >= 0:
                    return text[:i]
            return text

        def job(obs):
            if not with_probs:
                return {"text": _trim(iface.run_string_in_string_out(
                    msg["prompt"], n_new, sampling=sampling, regex=regex,
                    json_schema=json_schema))}
            constraint = (iface.compile_constraint(regex, json_schema)
                          if constrained else None)
            ids = np.asarray(tok.encode(msg["prompt"]), dtype=np.int64)[None]
            toks = iface.generate_tokens(ids, n_new, sampling=sampling,
                                         constraint=constraint)[0]
            # a constraint emits its own eos once the pattern completes:
            # trim so text and table cover only the match
            eos_ids = ((constraint.eos_token_id,) if constraint is not None
                       else iface.eos_token_ids)
            if eos_ids:
                eos = np.nonzero(np.isin(toks, np.asarray(eos_ids)))[0]
                if eos.size:
                    toks = toks[:int(eos[0])]
            toks = [int(t) for t in toks]
            if stops:
                # trim the token list at the first stop hit so the
                # probability table matches the returned text
                kept, acc = [], ""
                for t in toks:
                    nxt = tok.decode(kept + [t])
                    if any(s in nxt for s in stops):
                        break
                    kept.append(t)
                    acc = nxt
                toks = kept
                text = _trim(acc)
            else:
                text = tok.decode(toks)
            # token probabilities: one teacher-forced prefill over
            # prompt + generated scores every emitted token
            full = np.concatenate([ids[0], np.asarray(toks, np.int64)])[None]
            logits = iface.logits(full[:, :-1]).astype(np.float32)
            start = ids.shape[1] - 1
            token_info = []
            for k, t in enumerate(toks):
                lg = logits[0, start + k]
                lg = lg - lg.max()
                p = float(np.exp(lg[t]) / np.exp(lg).sum())
                token_info.append({"id": t, "text": tok.decode([t]),
                                   "p": round(p, 4)})
            return {"text": text, "tokens": token_info}

        self.scheduler.submit(job, settings)
        return None  # job_accepted is emitted via the report pump

    def _generate_text_rnn(self, msg, entry, tok, n_new: int) -> None:
        """A constant-state (RWKV) model: greedy decoding only, as the
        reference serves it (:833-858)."""
        if float(msg.get("temperature", 0.0)) > 0.0:
            raise ValueError("rnn models serve greedy decoding "
                             "only (set temperature 0)")
        iface = self._rnn_iface(entry)
        iface.tokenizer = tok
        stops = [s for s in (msg.get("stop") or []) if s]

        def rnn_job(obs):
            ids = np.asarray(tok.encode(msg["prompt"]), dtype=np.int64)
            toks = iface.generate_tokens(ids[None], n_new)[0]
            text = tok.decode([int(t) for t in toks])
            for s in stops:
                i = text.find(s)
                if i >= 0:
                    text = text[:i]
            return {"text": text}

        self.scheduler.submit(rnn_job, ObserverSettings())
        return None

    def _generate_speculative(self, msg, entry, tok, n_new: int,
                              draft_id: int) -> None:
        """Speculative decoding with a second loaded model as the draft
        (reference :880-920): greedy output is token-exact against plain
        greedy decoding; sampled output is distributed as the target's.
        The decoder is cached per (target, draft, k). History penalties
        are refused by the decoder."""
        from ..interfaces.speculative import SpeculativeDecoder

        dentry = self.models.get(draft_id)
        if dentry.interfaces.get("text") is None:
            raise ValueError("draft model has no text interface")
        key = (entry.id, dentry.id, int(msg.get("draft_k", 4)))
        with self._cache_lock:
            dec = self._spec_decoders.get(key)
            if dec is None:
                dec = SpeculativeDecoder(self._score_iface(entry),
                                         self._score_iface(dentry), k=key[2])
                self._spec_decoders[key] = dec
        sampling = self._sampling_from_msg(msg)

        def spec_job(obs):
            ids = np.asarray(tok.encode(msg["prompt"]), dtype=np.int64)
            toks = dec.generate_tokens(ids, n_new, sampling=sampling)[0]
            return {"text": tok.decode([int(t) for t in toks]),
                    "rounds": dec.last_rounds}

        self.scheduler.submit(spec_job, ObserverSettings())

    # -- lifecycle ---------------------------------------------------------------
    async def run(self, host: str = "127.0.0.1", port: int = 3000):
        self._loop = asyncio.get_event_loop()
        self._start_report_pump()
        server = await serve_websocket(self.handle, host, port)
        async with server:
            await server.serve_forever()


def _json_safe(v):
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return P.encode_tensor(v)
    return v


def main():
    """`python -m whisper_tensor_tpu_torch.server.main`: the WebSocket
    server (the reference's :1190-1201), on the card unless --device
    cpu."""
    import argparse

    ap = argparse.ArgumentParser("whisper-tensor-tpu server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=3000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args()
    srv = Server(device=args.device)
    print(f"whisper-tensor-tpu (PyTorch, {srv.device}) server on "
          f"ws://{args.host}:{args.port}", flush=True)
    asyncio.run(srv.run(args.host, args.port))


__all__ = ["Server", "main"]


if __name__ == "__main__":
    main()
