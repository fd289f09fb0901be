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
Every other message of the reference (super graphs, images, speech,
transcription, multimodal generation, graph layout, tensor slices) and
the unported generate_text variant (RNN models) answer with an error
naming them as not ported.
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
from ..interfaces.text import (SamplingParams, TextInferenceInterface,
                               _not_ported)
from . import protocol as P
from .batching import ContinuousBatcher
from .model_server import ModelServer
from .scheduler import ObserverSettings, Scheduler
from .ws import WebSocketConnection, serve_websocket

# messages of the reference's protocol that the port does not serve
_UNPORTED_MESSAGES = {
    "get_graph_layout": "graph layout",
    "get_tensor_slice": "tensor slices",
    P.GENERATE_IMAGE: "image generation",
    "generate_multimodal": "multimodal generation",
    "generate_speech": "speech generation",
    "transcribe": "transcription",
    "transcribe_stream": "streaming transcription",
    "get_op_milli": "per-op milli lowering views",
    "get_super_graph": "super graphs",
    P.SUPER_GRAPH_REQUEST: "super graphs",
}


class Server:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.models = ModelServer()
        self.scheduler = Scheduler()
        self._conns: Set[WebSocketConnection] = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._text_ifaces: dict = {}      # entry id -> direct interface
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
            with self._cache_lock:
                bat = self._batchers.pop(mid, None)
                self._text_ifaces.pop(mid, None)
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
        if t in _UNPORTED_MESSAGES:
            raise _not_ported(f"{_UNPORTED_MESSAGES[t]} ({t!r})")
        raise ValueError(f"unknown message type {t!r}")

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
        if iface_cfg.get("rnn_state"):
            raise _not_ported("constant-state (RNN) models")
        from ..tokenizer import AnyTokenizer, apply_chat_template

        tok = AnyTokenizer.load(msg.get("tokenizer")
                                or entry.tokenizer_source or "bytes")
        if msg.get("messages") and not msg.get("prompt"):
            # chat form: render the tokenizer's chat template (or the
            # ChatML fallback) into the prompt every path below uses
            msg["prompt"] = apply_chat_template(tok, msg["messages"])
        n_new = int(msg.get("max_new_tokens", 32))
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


__all__ = ["Server"]
