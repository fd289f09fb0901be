"""OpenAI-compatible HTTP API over the port's serving stack.

The port's copy of whisper_tensor_tpu/server/openai_api.py, trimmed to
the text routes the port serves: `/v1/completions` and
`/v1/chat/completions` (with `stream`, `logprobs`, `echo`, `n`,
`best_of` reranking, `seed`, `stop`, `logit_bias`, `response_format`
and the `regex` extension for constrained decoding, and `tools` for
guided function calls), `/v1/embeddings`, `GET /v1/models` and `GET
/metrics`, on the Python stdlib (`http.server`), and
`/v1/images/generations` (reference :759, `_images`: an `sd` diffusers
pipeline's images as base64 PNGs, one request at a time on the
Server's image interface). Chat messages with image content parts
(data: URLs) run a LLaVA bundle's inputs_embeds path
(`_chat_multimodal`, reference :997-1080), and completions on a
constant-state (RWKV) model its greedy decoding (reference :546-565).
The audio routes are the reference's: `/v1/audio/speech` (:805-836, a
TTS bundle's WAV or s16le PCM) and `/v1/audio/transcriptions` and
`/translations` (:837-880, a multipart or JSON WAV upload through the
Server's SpeechToTextInterface, as JSON or text).

Routing mirrors the WebSocket server: unconstrained requests against a
ragged-decode model go through the ContinuousBatcher (per-request
sampling params batch greedy and sampled traffic together); constrained
requests, and everything against other models, through the direct
interface (for a ragged model, the batcher's own, `_score_iface`).
`stream: true` answers with server-sent events. `logprobs` (legacy int
form, or chat's bool + `top_logprobs`) reports per-token
log-probabilities from one teacher-forced rescoring prefill. The
`adapter` extension selects a served LoRA adapter (models loaded with
`serve_adapters=name=peft_dir,...`) for the request, and so does a
model named `<model>:<adapter>` or a bare adapter name that one model
serves; `/v1/models` lists those names too. Different adapters batch
together in the batcher's decode.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

# a permissive JSON-document regex for response_format json_object
_JSON_VALUE = (
    r'\s*(-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?|true|false|null'
    r'|"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*")\s*')
_JSON_OBJECT_REGEX = (
    r'\s*\{(\s*"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"\s*:'
    + _JSON_VALUE +
    r'(,\s*"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"\s*:'
    + _JSON_VALUE + r')*)?\s*\}\s*')


class ApiError(Exception):
    def __init__(self, status: int, message: str, etype: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.etype = etype


def _parse_multipart(raw: bytes, content_type: str) -> Dict[str, Any]:
    """multipart/form-data -> {name: str | bytes}. File parts (those
    with a filename) stay bytes; plain fields decode to str. The stdlib
    email parser does the boundary and header work (reference :186)."""
    from email import policy
    from email.parser import BytesParser

    msg = BytesParser(policy=policy.default).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + raw)
    if not msg.is_multipart():
        raise ApiError(400, "malformed multipart body")
    out: Dict[str, Any] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True) or b""
        if part.get_filename() is None:
            try:
                payload = payload.decode()
            except UnicodeDecodeError:
                pass
        out[name] = payload
    return out


def _sampling_from(body: Dict[str, Any]):
    """OpenAI request fields -> SamplingParams (None = greedy).
    temperature=0 is greedy; extensions: top_k, min_p,
    repetition_penalty (common llama.cpp/vLLM extensions)."""
    from ..interfaces.text import SamplingParams

    temp = float(body.get("temperature", 1.0))
    pres = float(body.get("presence_penalty", 0.0))
    freq = float(body.get("frequency_penalty", 0.0))
    rep = float(body.get("repetition_penalty", 1.0))
    if temp <= 0.0 and pres == 0.0 and freq == 0.0 and rep == 1.0:
        return None
    return SamplingParams(
        temperature=max(temp, 0.0),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=rep,
        presence_penalty=pres,
        frequency_penalty=freq,
        seed=int(body.get("seed", 0)))


def _stops_from(body: Dict[str, Any]) -> List[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop] if stop else []
    return [s for s in stop if s]


def _constraint_from(body: Dict[str, Any]):
    """-> (regex, json_schema) from response_format / regex extension."""
    if body.get("regex") is not None:
        return body["regex"], None
    rf = body.get("response_format")
    if not rf:
        return None, None
    kind = rf.get("type")
    if kind in (None, "text"):
        return None, None
    if kind == "json_object":
        return _JSON_OBJECT_REGEX, None
    if kind == "json_schema":
        js = rf.get("json_schema") or {}
        schema = js.get("schema", js if "type" in js else None)
        if schema is None:
            raise ApiError(400, "response_format.json_schema.schema missing")
        return None, schema
    raise ApiError(400, f"unsupported response_format type {kind!r}")


def _normalize_messages(messages):
    """Tool-protocol message shapes -> renderable content: an assistant
    tool_calls turn (content null) serializes its calls; bare null
    content becomes empty. Tool-result messages (role 'tool') render
    as-is — ChatML roles are free-form."""
    out = []
    for m in messages:
        if m.get("content") is None:
            if m.get("tool_calls"):
                calls = [{"name": f.get("name", ""),
                          "arguments": f.get("arguments", "{}")}
                         for t in m["tool_calls"]
                         for f in [t.get("function") or {}]]
                m = {**m, "content": json.dumps(calls)}
            else:
                m = {**m, "content": ""}
        out.append(m)
    return out


def _tools_schema(body: Dict[str, Any]):
    """tools + tool_choice -> a JSON schema forcing one function call
    `{"name": ..., "arguments": {...}}` (guided function calling through
    the token-DFA constrained decoder). tool_choice "none" disables;
    "auto"/"required"/a named function force a call."""
    tools = body.get("tools")
    if not tools:
        return None
    tc = body.get("tool_choice", "auto")
    if tc in (None, "none"):
        return None
    chosen = None
    if isinstance(tc, dict):
        chosen = (tc.get("function") or {}).get("name")
        if not chosen:
            raise ApiError(400, "tool_choice.function.name required")
    fns = [t.get("function") or {} for t in tools
           if t.get("type", "function") == "function"]
    if not all(f.get("name") for f in fns):
        raise ApiError(400, "every tool needs function.name")
    if chosen is not None:
        fns = [f for f in fns if f["name"] == chosen]
        if not fns:
            raise ApiError(404, f"tool {chosen!r} not in tools",
                           "not_found_error")
    variants = [{"type": "object",
                 "properties": {
                     "name": {"const": f["name"]},
                     "arguments": f.get("parameters")
                     or {"type": "object"}},
                 "required": ["name", "arguments"]}
                for f in fns]
    return variants[0] if len(variants) == 1 else {"anyOf": variants}


def _resolve_entry(server, name, iface_kind: str):
    """Find a loaded model entry by name/id that exposes `iface_kind`
    (reference :165-183).

    With no name: unique by bundle (several entries can share one
    bundle — e.g. a diffusers pipeline loads te/unet/vae entries)."""
    models = [e for e in server.models._models.values()
              if iface_kind in (e.interfaces or {})]
    if not models:
        raise ApiError(404, f"no loaded model has a {iface_kind!r} "
                            "interface", "not_found_error")
    if name is None:
        bundles = {e.meta.get("bundle_id") for e in models}
        if len(bundles) == 1:
            return models[0]
        raise ApiError(400, "model field required (several loaded)")
    for e in models:
        if e.name == name or str(e.id) == str(name):
            return e
    raise ApiError(404, f"model {name!r} not found", "not_found_error")


def _resolve_model(server, name, body=None):
    """The loaded model entry named `name` (by name or id); with no name,
    the one model loaded. With a request `body`, the served adapters'
    aliases resolve too (reference :269-292): "<model>:<adapter>", or a
    bare adapter name that only one model serves, set body["adapter"]."""
    models = server.models._models
    if name is None:
        if len(models) == 1:
            return next(iter(models.values()))
        raise ApiError(400, "model field required (several loaded)")
    for e in models.values():
        if e.name == name or str(e.id) == str(name):
            return e
    matches = []
    for e in models.values() if body is not None else ():
        ads = (e.interfaces.get("text") or {}).get("adapters") or {}
        for aname in ads:
            if name in (f"{e.name}:{aname}", aname):
                matches.append((e, aname))
    if len(matches) == 1:
        e, body["adapter"] = matches[0]
        return e
    if len(matches) > 1:
        raise ApiError(400, f"adapter name {name!r} is ambiguous: use "
                            "'<model>:<adapter>'")
    raise ApiError(404, f"model {name!r} not found", "not_found_error")


class _Generator:
    """One request's execution: resolves the model, runs through the
    batcher (ragged, unconstrained) or the direct interface, and yields
    text deltas for streaming."""

    def __init__(self, server, body: Dict[str, Any], prompt: str):
        from ..tokenizer import AnyTokenizer

        self.server = server
        self.body = body
        self.entry = _resolve_model(server, body.get("model"), body)
        self.cfg = self.entry.interfaces.get("text")
        if self.cfg is None:
            raise ApiError(400, f"model {self.entry.name!r} has no text "
                                "interface")
        self.tok = AnyTokenizer.load(self.entry.tokenizer_source or "bytes")
        self.prompt = prompt
        self.n_new = int(body.get("max_tokens",
                                  body.get("max_completion_tokens", 16)))
        self.n = int(body.get("n", 1))
        if not 1 <= self.n <= 64:
            raise ApiError(400, "n must be in 1..64")
        self.sampling = _sampling_from(body)
        self.stops = _stops_from(body)
        self.regex, self.schema = _constraint_from(body)
        # logprobs: the handler normalizes chat's bool+top_logprobs and
        # completions' int into one Optional[int] (N top alternatives)
        lp = body.get("logprobs")
        # identity checks: logprobs=0 is a VALID request (chosen-token
        # logprob, no alternatives) and 0 == False would eat it
        self.want_logprobs = (None if lp is None or lp is False
                              else int(lp))
        # echo (completions only): prepend the prompt to the output and
        # score its tokens too — with max_tokens=0 this is the pure
        # sequence-scoring mode eval harnesses (lm-eval) drive
        self.echo = bool(body.get("echo"))
        if self.echo and self.want_logprobs is None:
            self.want_logprobs = 0
        lb = body.get("logit_bias")
        if lb is not None and not isinstance(lb, dict):
            raise ApiError(400, "logit_bias must be a {token_id: bias} "
                                "object")
        self.logit_bias = lb or None
        self.adapter = body.get("adapter") or None
        if self.adapter:
            if not self.cfg.get("ragged"):
                raise ApiError(400, "adapter requires a ragged-decode "
                                    "(batcher-served) model")
            if self.regex is not None or self.schema is not None:
                raise ApiError(400, "adapter is not supported with "
                                    "constrained decoding")
            if self.want_logprobs is not None or self.echo:
                # the rescoring prefill runs the base model, which would
                # score an adapter's tokens under the wrong weights
                raise ApiError(400, "adapter is not supported with "
                                    "logprobs/echo")
            if self.logit_bias is not None:
                # logit_bias runs on the direct path, which serves the
                # base model (the reference silently drops the adapter)
                raise ApiError(400, "adapter is not supported with "
                                    "logit_bias")
        self.prompt_ids = np.asarray(self.tok.encode(prompt), np.int64)

    # ------------------------------------------------------------------
    def run(self, on_delta=None) -> Dict[str, Any]:
        """Generate to completion. on_delta(text_piece) streams decoded
        increments. Returns {"text", "finish_reason", "usage"}."""
        constrained = self.regex is not None or self.schema is not None
        if self.n_new == 0:
            toks, finish = [], "length"
        elif (self.cfg.get("ragged") and not constrained
              and self.logit_bias is None):
            toks, finish = self._run_batched(on_delta)
        else:
            toks, finish = self._run_direct(on_delta)
        logprobs = None
        if self.want_logprobs is not None:
            # token-level stop trim so the table aligns with the text
            toks, finish = self._stop_trim_tokens(toks, finish)
            text = self.tok.decode([int(t) for t in toks])
            logprobs = self._rescore(toks)
            if self.echo:
                text = self.prompt + text
        else:
            text = self.tok.decode([int(t) for t in toks])
            for s in self.stops:
                i = text.find(s)
                if i >= 0:
                    text, finish = text[:i], "stop"
        return {"text": text, "finish_reason": finish,
                "logprobs": logprobs,
                "usage": {"prompt_tokens": int(self.prompt_ids.shape[0]),
                          "completion_tokens": len(toks),
                          "total_tokens": int(self.prompt_ids.shape[0])
                          + len(toks)}}

    def run_many(self) -> List[Dict[str, Any]]:
        """n>1 / best_of: independent sampled completions in ONE batch.
        Direct models tile the prompt to the candidate count (the draw
        is independent per row); ragged models submit batcher requests
        with staggered seeds. best_of > n reranks the candidates by mean
        token logprob (one scoring prefill, sequence_scores) and returns
        the top n."""
        import dataclasses as _dc

        best_of = int(self.body.get("best_of") or self.n)
        if best_of < self.n:
            raise ApiError(400, "best_of must be >= n")
        if not 1 <= best_of <= 64:
            raise ApiError(400, "best_of must be in 1..64")
        if self.sampling is None:
            raise ApiError(400, "n>1 / best_of requires temperature > 0")
        if (self.regex is not None or self.schema is not None
                or self.want_logprobs is not None or self.echo):
            raise ApiError(400, "n>1 / best_of is not supported "
                                "together with logprobs/echo/"
                                "response_format")
        if self.cfg.get("ragged") and self.logit_bias is None:
            bat = self.server._batcher(self.entry)
            try:
                futs = [bat.submit(self.prompt_ids, self.n_new,
                                   sampling=_dc.replace(
                                       self.sampling,
                                       seed=self.sampling.seed + i),
                                   adapter=self.adapter)
                        for i in range(best_of)]
            except ValueError as e:   # unknown adapter name
                raise ApiError(400, str(e))
            timeout = float(self.body.get("timeout", 600))
            rows = [f.result(timeout=timeout) for f in futs]
            eos = bat.eos_token_ids
        else:
            iface = self.server._text_iface(self.entry)
            iface.tokenizer = self.tok
            tiled = np.tile(self.prompt_ids[None], (best_of, 1))
            rows = iface.generate_tokens(
                tiled, self.n_new, sampling=self.sampling,
                logit_bias=self._bias_vec(iface))
            eos = getattr(iface, "eos_token_ids", None)
        results = []
        trimmed: List[List[int]] = []
        for r in rows:
            toks, finish = self._trim_eos(r, eos)
            toks = [int(t) for t in toks]
            if self.stops:
                toks, finish = self._stop_trim_tokens(toks, finish)
            trimmed.append(toks)
            results.append({"text": self.tok.decode(toks),
                            "finish_reason": finish,
                            "n_tokens": len(toks)})
        if best_of > self.n:
            if self.adapter:
                raise ApiError(400, "best_of reranking is not supported "
                                    "with adapter")
            P = int(self.prompt_ids.shape[0])
            Lmax = P + max((len(t) for t in trimmed), default=0)
            full = np.zeros((best_of, max(Lmax, P + 1)), np.int64)
            lens = np.zeros(best_of, np.int64)
            for i, t in enumerate(trimmed):
                full[i, :P] = self.prompt_ids
                full[i, P:P + len(t)] = t
                lens[i] = P + len(t)
            iface = self.server._score_iface(self.entry)
            scores = iface.sequence_scores(full, np.full(best_of, P), lens)
            # a zero-token completion scores 0.0 from the masked mean,
            # above every real candidate's negative mean logprob: rank
            # empty candidates last instead
            scores = np.where(lens > P, scores, -np.inf)
            order = np.argsort(-scores)[:self.n]
            results = [results[int(i)] for i in order]
        return results

    def _stop_trim_tokens(self, toks, finish):
        if not self.stops:
            return toks, finish
        from ..tokenizer import IncrementalDecoder

        dec = IncrementalDecoder(self.tok)
        max_stop = max(len(s) for s in self.stops)
        kept: List[int] = []
        prev = 0
        for t in toks:
            dec.push(int(t))
            start = max(0, prev - max_stop)
            prev = dec.length
            if any(s in dec.text_from(start) for s in self.stops):
                return kept, "stop"
            kept.append(int(t))
        return kept, finish

    def _rescore(self, toks):
        """One teacher-forced prefill over prompt+generated scores every
        emitted token under the model: logprob + top-N alternatives
        (same rescore the WS server's with_probs path uses). With echo,
        prompt tokens are scored too (first one has no context: None)."""
        toks = [int(t) for t in toks]
        pids = [int(t) for t in self.prompt_ids]
        first_row = ([{"token": self.tok.decode([pids[0]]),
                       "logprob": None, "top_logprobs": []}]
                     if self.echo and pids else [])
        if not toks and (not self.echo or len(pids) <= 1):
            return first_row
        iface = self.server._score_iface(self.entry)
        full = np.concatenate(
            [self.prompt_ids, np.asarray(toks, np.int64)])[None]
        try:
            logits = iface.logits(full[:, :-1]).astype(np.float32)[0]
        except ValueError as e:   # sequence beyond the prompt buckets
            raise ApiError(400, f"sequence too long to rescore for "
                                f"logprobs: {e}")
        n_top = self.want_logprobs or 0

        def row(pos, tid):
            lg = logits[pos] - logits[pos].max()
            lp = lg - np.log(np.exp(lg).sum())
            top = ([{"token": self.tok.decode([int(i)]),
                     "logprob": round(float(lp[i]), 5)}
                    for i in np.argsort(-lp)[:n_top]] if n_top > 0 else [])
            return {"token": self.tok.decode([tid]),
                    "logprob": round(float(lp[tid]), 5),
                    "top_logprobs": top}

        out = first_row
        if self.echo:
            out += [row(i - 1, pids[i]) for i in range(1, len(pids))]
        start = len(pids) - 1
        out += [row(start + k, t) for k, t in enumerate(toks)]
        return out

    def _trim_eos(self, toks, eos_id):
        """eos_id may be a single id or a list of ids (HF checkpoints
        like Llama-3 declare several end tokens)."""
        toks = [int(t) for t in toks]
        eos_ids = ([] if eos_id is None
                   else [int(eos_id)] if isinstance(eos_id, int)
                   else [int(e) for e in eos_id])
        hits = [toks.index(e) for e in eos_ids if e in toks]
        if hits:
            return toks[:min(hits)], "stop"
        return toks, ("length" if len(toks) >= self.n_new else "stop")

    def _run_batched(self, on_delta):
        from ..tokenizer import IncrementalDecoder

        bat = self.server._batcher(self.entry)
        # incremental detokenization: on_tok runs on the batcher's
        # scheduler thread; full re-decode per token is O(n^2) there
        dec = IncrementalDecoder(self.tok)
        max_stop = max((len(s) for s in self.stops), default=0)
        state = {"decoded": 0, "prev": 0, "hit": False, "fut": None}
        lock = threading.Lock()

        eos_ids = bat.eos_token_ids or ()

        def on_tok(t):
            with lock:
                if state["hit"]:
                    return
                if int(t) in eos_ids:
                    # the batcher emits the eos token itself before
                    # deactivating the row; it must not reach the
                    # delta stream (the final result is trimmed too)
                    state["hit"] = True
                    return
                dec.push(int(t))
                start = max(0, state["prev"] - max_stop)
                state["prev"] = dec.length
                if self.stops and any(s in dec.text_from(start)
                                      for s in self.stops):
                    state["hit"] = True
                    if state["fut"] is not None:
                        bat.cancel(state["fut"])
                    return
                if on_delta is not None and dec.length > state["decoded"]:
                    on_delta(dec.text_from(state["decoded"]))
                    state["decoded"] = dec.length

        try:
            fut = bat.submit(self.prompt_ids, self.n_new,
                             on_token=None if on_delta is None
                             and not self.stops else on_tok,
                             sampling=self.sampling, adapter=self.adapter)
        except ValueError as e:       # unknown adapter name
            raise ApiError(400, str(e))
        with lock:
            state["fut"] = fut
        if state["hit"]:
            bat.cancel(fut)
        toks = fut.result(timeout=float(self.body.get("timeout", 600)))
        return self._trim_eos(toks, bat.eos_token_ids)

    def _bias_vec(self, iface):
        """OpenAI logit_bias {token_id: bias} -> (V,) f32, clipped to
        ±100; None when the request carries no bias."""
        if not self.logit_bias:
            return None
        V = iface._vocab_size()
        bias = np.zeros((V,), np.float32)
        for k, v in self.logit_bias.items():
            try:
                t = int(k)
            except (TypeError, ValueError):
                raise ApiError(400, f"logit_bias key {k!r} is not a "
                                    "token id")
            if not 0 <= t < V:
                raise ApiError(400, f"logit_bias token {t} out of "
                                    f"vocab range [0, {V})")
            bias[t] = float(np.clip(float(v), -100.0, 100.0))
        return bias

    def _run_direct(self, on_delta):
        if self.cfg.get("rnn_state"):
            # constant-state (RWKV) models: greedy decoding only
            if (self.sampling is not None or self.regex is not None
                    or self.schema is not None or self.logit_bias
                    or self.want_logprobs is not None or self.echo):
                raise ApiError(400, "rnn models serve greedy text only "
                                    "(no sampling/logprobs/echo/"
                                    "constraints)")
            iface = self.server._rnn_iface(self.entry)
            iface.tokenizer = self.tok
            toks = [int(t) for t in iface.generate_tokens(
                self.prompt_ids[None], self.n_new)[0]]
            if on_delta is not None:
                text = self.tok.decode(toks)
                if text:
                    on_delta(text)
            return toks, "length"
        iface = self.server._score_iface(self.entry)
        iface.tokenizer = self.tok
        constraint = None
        if self.regex is not None or self.schema is not None:
            constraint = iface.compile_constraint(self.regex, self.schema)
        toks = iface.generate_tokens(self.prompt_ids[None], self.n_new,
                                     sampling=self.sampling,
                                     constraint=constraint,
                                     logit_bias=self._bias_vec(iface))[0]
        eos = (constraint.eos_token_id if constraint is not None
               else iface.eos_token_ids)
        toks, finish = self._trim_eos(toks, eos)
        if on_delta is not None:
            # the direct decode reads its tokens back once, at the end:
            # stream the decoded pieces after
            text = self.tok.decode(toks)
            if text:
                on_delta(text)
        return toks, finish


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "whisper-tensor-tpu"

    # quiet request logging (tests / production both prefer silence here)
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def api(self):
        return self.server.api     # type: ignore[attr-defined]

    def _json(self, status: int, obj: Dict[str, Any]):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _binary(self, status: int, ctype: str, data: bytes, headers=()):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, e: Exception):
        if isinstance(e, ApiError):
            self._json(e.status, {"error": {"message": str(e),
                                            "type": e.etype}})
        else:
            self._json(500, {"error": {"message": f"{type(e).__name__}: {e}",
                                       "type": "server_error"}})

    def do_GET(self):  # noqa: N802
        if self.path.split("?")[0] == "/metrics":
            return self._metrics()
        if self.path.split("?")[0] == "/v1/models":
            models = []
            for e in self.api.server.models._models.values():
                models.append({"id": e.name, "object": "model",
                               "owned_by": "whisper-tensor-tpu",
                               "created": 0})
                # served LoRA adapters list as models "<base>:<adapter>"
                ads = (e.interfaces.get("text") or {}).get("adapters") \
                    or {}
                for aname in ads:
                    models.append({"id": f"{e.name}:{aname}",
                                   "object": "model",
                                   "owned_by": "whisper-tensor-tpu",
                                   "parent": e.name, "created": 0})
            return self._json(200, {"object": "list", "data": models})
        self._json(404, {"error": {"message": f"no route {self.path}",
                                   "type": "not_found_error"}})

    def _metrics(self):
        """Prometheus text exposition of the serving counters: one
        gauge/counter set per live batcher plus registry totals."""
        server = self.api.server
        lines = [
            "# HELP wt_models_loaded Loaded model entries.",
            "# TYPE wt_models_loaded gauge",
            f"wt_models_loaded {len(server.models._models)}",
        ]
        metas = [
            ("wt_batcher_slots", "gauge", "slots", "Decode slots."),
            ("wt_batcher_active", "gauge", "active",
             "Slots with a live request."),
            ("wt_batcher_queued", "gauge", "queued",
             "Requests waiting for a slot."),
            ("wt_batcher_chunks_dispatched_total", "counter",
             "chunks_dispatched", "Decode chunk programs dispatched."),
            ("wt_batcher_steps_dispatched_total", "counter",
             "steps_dispatched", "Decode scan steps dispatched."),
            ("wt_batcher_tokens_emitted_total", "counter",
             "tokens_emitted", "Tokens emitted to requests."),
            ("wt_batcher_admit_seconds_total", "counter",
             "time_admit_s", "Wall seconds in admission prefills."),
            ("wt_batcher_dispatch_seconds_total", "counter",
             "time_dispatch_s", "Wall seconds in chunk dispatch calls."),
            ("wt_batcher_fetch_seconds_total", "counter",
             "time_fetch_s", "Wall seconds blocked on token drains."),
        ]
        # snapshot first: ThreadingHTTPServer scrapes race load_adapter
        # swaps / first-request inserts on this dict
        stats = {mid: bat.stats()
                 for mid, bat in list(server._batchers.items())}
        for name, kind, key, help_ in metas:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for mid, st in stats.items():
                lines.append(f'{name}{{model_id="{mid}"}} {st[key]}')
        self._binary(200, "text/plain; version=0.0.4; charset=utf-8",
                     ("\n".join(lines) + "\n").encode())

    def do_POST(self):  # noqa: N802
        path = self.path.split("?")[0]
        try:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            if path in ("/v1/audio/transcriptions", "/v1/audio/translations"):
                return self._transcriptions(
                    raw, self.headers.get("Content-Type", ""),
                    task="translate" if path.endswith("translations")
                    else None)
            body = json.loads(raw or b"{}")
            if path == "/v1/completions":
                return self._completions(body, chat=False)
            if path == "/v1/chat/completions":
                return self._completions(body, chat=True)
            if path == "/v1/embeddings":
                return self._embeddings(body)
            if path == "/v1/images/generations":
                return self._images(body)
            if path == "/v1/audio/speech":
                return self._speech(body)
            raise ApiError(404, f"no route {path}", "not_found_error")
        except Exception as e:  # noqa: BLE001
            try:
                self._error(e)
            except (BrokenPipeError, ConnectionError):
                pass

    # ------------------------------------------------------------------
    def _speech(self, body: Dict[str, Any]):
        """/v1/audio/speech: TTS bundle -> WAV (or s16le PCM) bytes."""
        from ..utils.audio import wav_bytes

        server = self.api.server
        text = body.get("input")
        if not isinstance(text, str) or not text:
            raise ApiError(400, "input must be a non-empty string")
        rf = body.get("response_format", "wav")
        if rf not in ("wav", "pcm"):
            raise ApiError(400, f"unsupported response_format {rf!r} "
                                "(wav|pcm)")
        entry = _resolve_entry(server, body.get("model"), "tts")
        iface = server._tts_iface(entry)
        voice = body.get("voice", 0)
        if isinstance(voice, str) and not voice.isdigit():
            # OpenAI's named voices have no analogue; kokoro-style
            # bundles carry their own names
            names = getattr(iface, "voice_names", []) or []
            voice = names.index(voice) if voice in names else 0
        clip = iface.run_text_to_audio(text, voice=int(voice))
        sr = [("X-Sample-Rate", str(clip.sample_rate))]
        if rf == "pcm":
            pcm = np.clip(np.asarray(clip.samples, np.float32), -1.0, 1.0)
            self._binary(200, "audio/pcm",
                         (pcm * 32767.0).astype("<i2").tobytes(), sr)
        else:
            self._binary(200, "audio/wav",
                         wav_bytes(clip.samples, clip.sample_rate), sr)

    def _transcriptions(self, raw: bytes, ctype: str,
                        task: Optional[str] = None):
        """/v1/audio/transcriptions (and /translations, task forced to
        'translate'): multipart (or JSON + audio_b64) WAV upload -> text
        through the STT interface. `language` substitutes the whisper
        `<|lang|>` start token on multilingual checkpoints."""
        import base64

        from ..super_graph.links import AudioClip
        from ..tokenizer import AnyTokenizer
        from ..utils.audio import read_wav_bytes

        if "multipart/form-data" in (ctype or ""):
            fields = _parse_multipart(raw, ctype)
        else:
            fields = json.loads(raw or b"{}")
            if "audio_b64" in fields:
                fields["file"] = base64.b64decode(fields.pop("audio_b64"))
        wav = fields.get("file")
        if not isinstance(wav, (bytes, bytearray)):
            raise ApiError(400, "file field required (WAV bytes)")
        try:
            samples, rate = read_wav_bytes(bytes(wav))
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"could not read WAV: {e}")
        server = self.api.server
        entry = _resolve_entry(server, fields.get("model") or None, "stt")
        iface = server._stt_iface(entry)
        if iface.tokenizer is None:
            iface.tokenizer = AnyTokenizer.load(
                entry.tokenizer_source or "bytes")
        try:
            iface = server._with_sot(iface, fields.get("language"),
                                     fields.get("task") or task)
        except ValueError as e:
            raise ApiError(400, str(e))
        text = iface.run_audio_in_text_out(
            AudioClip(samples, rate),
            max_new=int(fields.get("max_new_tokens", 64) or 64))
        if fields.get("response_format") == "text":
            return self._binary(200, "text/plain; charset=utf-8",
                                text.encode())
        self._json(200, {"text": text})

    def _images(self, body: Dict[str, Any]):
        """/v1/images/generations (reference :759-806): an image bundle
        (sd, sdxl, sd3, flux; a diffusers dir or an LDM file) -> b64
        PNGs, rectified flow for sd3 and flux, Euler for the others. The Server keeps one interface a bundle, its
        weights on the card, and runs one generation at a time."""
        import base64

        from ..interfaces.image_gen import ImageGenConfig
        from ..utils.image import png_bytes

        server = self.api.server
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ApiError(400, "prompt must be a non-empty string")
        rf = body.get("response_format", "b64_json")
        if rf != "b64_json":
            raise ApiError(400, "only response_format='b64_json' is "
                                "supported (no URL hosting)")
        entry = _resolve_entry(server, body.get("model"), "image")
        spec = entry.interfaces["image"]
        size = body.get("size")
        if size:
            try:
                w, h = (int(p) for p in str(size).lower().split("x"))
            except ValueError:
                raise ApiError(400, f"bad size {size!r} (want 'WxH')")
        else:
            w, h = spec.get("width", 512), spec.get("height", 512)
        if (w, h) != (spec["width"], spec["height"]):
            # the UNet and VAE graphs are built for the loaded size
            raise ApiError(400, f"size {w}x{h}: this pipeline was loaded "
                                f"at {spec['width']}x{spec['height']}")
        seed = int(body.get("seed", 0))
        iface = server._image_iface(entry)
        data = []
        for i in range(int(body.get("n", 1))):
            cfg = ImageGenConfig(
                steps=int(body.get("steps", 20)),
                guidance_scale=float(body.get("guidance_scale", 7.5)),
                height=h, width=w,
                schedule=("rectified_flow"
                          if spec["pipeline"] in ("sd3", "flux")
                          else "euler"),
                seed=seed + i)
            with server._image_lock:
                img = iface.run(prompt,
                                negative_prompt=body.get("negative_prompt",
                                                         ""), cfg=cfg)
            data.append({"b64_json": base64.b64encode(
                png_bytes(img.pixels)).decode()})
        self._json(200, {"created": int(time.time()), "data": data})

    def _embeddings(self, body: Dict[str, Any]):
        """/v1/embeddings (reference :701-756): final-hidden-state
        pooling over a causal LM, `pooling` last (default) or mean,
        L2-normalized; one batched prefill that stops at the hidden-state
        tap serves the whole input list (right-padding is exact under
        the causal mask)."""
        from ..tokenizer import AnyTokenizer

        server = self.api.server
        inputs = body.get("input")
        if isinstance(inputs, str):
            items: List[Any] = [inputs]
        elif isinstance(inputs, list):
            items = ([inputs] if inputs
                     and all(isinstance(x, int) for x in inputs)
                     else inputs)
        else:
            raise ApiError(400, "input must be a string or an array")
        if not items:
            raise ApiError(400, "input is empty")
        if body.get("encoding_format", "float") != "float":
            raise ApiError(400, "only encoding_format='float' is supported")
        pooling = body.get("pooling", "last")
        if pooling not in ("last", "mean"):
            raise ApiError(400, f"unknown pooling {pooling!r} (last|mean)")
        entry = _resolve_model(server, body.get("model"))
        if "text" not in entry.interfaces:
            raise ApiError(400, f"model {entry.name!r} has no text "
                                "interface")
        tok = AnyTokenizer.load(entry.tokenizer_source or "bytes")
        iface = server._score_iface(entry)
        ids_list = [np.asarray(tok.encode(it) if isinstance(it, str)
                               else it, np.int64).reshape(-1)
                    for it in items]
        try:
            vecs = iface.embed(ids_list, pooling=pooling)
        except ValueError as e:
            raise ApiError(400, str(e))
        total = sum(int(a.size) for a in ids_list)
        data = [{"object": "embedding", "index": i,
                 "embedding": [float(x) for x in v]}
                for i, v in enumerate(vecs)]
        self._json(200, {"object": "list", "data": data,
                         "model": entry.name,
                         "usage": {"prompt_tokens": total,
                                   "total_tokens": total}})

    def _completions(self, body: Dict[str, Any], chat: bool):
        from ..tokenizer import apply_chat_template

        tool_schema = None
        if chat:
            messages = body.get("messages")
            if not messages:
                raise ApiError(400, "messages required")
            messages = body["messages"] = _normalize_messages(messages)
            has_image = any(
                isinstance(m.get("content"), list)
                and any(p.get("type") == "image_url"
                        for p in m["content"])
                for m in messages)
            if has_image:
                return self._chat_multimodal(body)
            # text-only content arrays flatten to plain strings
            for m in messages:
                if isinstance(m.get("content"), list):
                    m["content"] = "".join(p.get("text", "")
                                           for p in m["content"])
            # chat API: logprobs is a bool + top_logprobs count; fold
            # into the completions-style Optional[int] the generator uses
            body["logprobs"] = (int(body.get("top_logprobs", 0) or 0)
                                if body.get("logprobs") else None)
            body["echo"] = False            # completions-only field
            tool_schema = _tools_schema(body)
            if tool_schema is not None:
                if body.get("stream"):
                    raise ApiError(400, "stream is not supported with "
                                        "tool calls")
                if body.get("response_format"):
                    raise ApiError(400, "tools and response_format are "
                                        "mutually exclusive")
                body["response_format"] = {
                    "type": "json_schema",
                    "json_schema": {"schema": tool_schema}}
            # render AFTER model resolution needs the tokenizer; build
            # the generator with a placeholder then re-render
            gen = _Generator(self.api.server, body, "")
            gen.prompt = apply_chat_template(gen.tok, messages)
            gen.prompt_ids = np.asarray(gen.tok.encode(gen.prompt), np.int64)
        else:
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                if len(prompt) != 1:
                    raise ApiError(400, "only a single prompt is supported")
                prompt = prompt[0]
            if not isinstance(prompt, str):
                raise ApiError(400, "prompt must be a string")
            gen = _Generator(self.api.server, body, prompt)

        kind = "chat.completion" if chat else "text_completion"
        rid = f"cmpl-{int(time.time() * 1000):x}"
        if gen.n > 1 or int(body.get("best_of") or 0) > 1:
            if body.get("stream"):
                raise ApiError(400, "n>1 / best_of with stream is not "
                                    "supported")
            results = gen.run_many()
            choices = []
            for i, r in enumerate(results):
                c: Dict[str, Any] = {"index": i, "logprobs": None,
                                     "finish_reason": r["finish_reason"]}
                if chat:
                    c["message"] = {"role": "assistant",
                                    "content": r["text"]}
                else:
                    c["text"] = r["text"]
                choices.append(c)
            p = int(gen.prompt_ids.shape[0])
            comp = sum(r["n_tokens"] for r in results)
            return self._json(200, {
                "id": rid, "object": kind, "created": int(time.time()),
                "model": gen.entry.name, "choices": choices,
                "usage": {"prompt_tokens": p, "completion_tokens": comp,
                          "total_tokens": p + comp}})
        if body.get("stream"):
            return self._stream(gen, rid, kind, chat)
        res = gen.run()
        choice: Dict[str, Any] = {"index": 0,
                                  "finish_reason": res["finish_reason"],
                                  "logprobs": self._fmt_logprobs(
                                      res["logprobs"], chat)}
        if chat and tool_schema is not None:
            try:
                call = json.loads(res["text"])
                choice["message"] = {
                    "role": "assistant", "content": None,
                    "tool_calls": [{
                        "id": f"call_{rid[5:]}", "type": "function",
                        "function": {
                            "name": call["name"],
                            "arguments": json.dumps(call["arguments"])}}]}
                choice["finish_reason"] = "tool_calls"
            except (ValueError, KeyError):
                # the constraint hit the token cap mid-document: the raw
                # text with its own finish_reason
                choice["message"] = {"role": "assistant",
                                     "content": res["text"]}
        elif chat:
            choice["message"] = {"role": "assistant",
                                 "content": res["text"]}
        else:
            choice["text"] = res["text"]
        self._json(200, {"id": rid, "object": kind,
                         "created": int(time.time()),
                         "model": gen.entry.name,
                         "choices": [choice], "usage": res["usage"]})

    def _chat_multimodal(self, body: Dict[str, Any]):
        """Chat messages carrying image_url parts (data: URIs) run the
        LLaVA-style inputs_embeds path: render the chat template with
        image sentinels, split, and interleave text/image items (the
        reference's, :997-1080)."""
        import re as _re

        from ..tokenizer import AnyTokenizer, apply_chat_template

        if body.get("stream"):
            raise ApiError(400, "stream is not supported with image "
                                "inputs")
        if body.get("tools") and body.get("tool_choice") not in (None,
                                                                 "none"):
            # refusing beats silently dropping the forced-call contract
            raise ApiError(400, "tools are not supported together with "
                                "image inputs")
        server = self.api.server
        entry = _resolve_entry(server, body.get("model"), "multimodal")
        try:
            mm, spec = server._mm_iface(entry)
        except ValueError as e:
            raise ApiError(400, str(e))
        tok = AnyTokenizer.load(entry.tokenizer_source or "bytes")
        mm.text.tokenizer = tok
        imgs: List[str] = []
        msgs = []
        for m in _normalize_messages(body["messages"]):
            c = m.get("content")
            if not isinstance(c, list):
                if isinstance(c, str) and "\x00" in c:
                    m = {**m, "content": c.replace("\x00", "")}
                msgs.append(m)
                continue
            parts = []
            for p in c:
                kind = p.get("type")
                if kind == "text":
                    # NUL can't reach the model anyway; stripping it
                    # keeps user text from forging image sentinels
                    parts.append(p.get("text", "").replace("\x00", ""))
                elif kind == "image_url":
                    url = (p.get("image_url") or {}).get("url", "")
                    if not url.startswith("data:image/") \
                            or "," not in url:
                        raise ApiError(400, "only data:image/...;base64 "
                                            "URLs are supported "
                                            "(no outbound fetches)")
                    imgs.append(url.split(",", 1)[1])
                    parts.append(f"\x00IMG{len(imgs) - 1}\x00")
                else:
                    raise ApiError(400, f"unsupported content part "
                                        f"{kind!r}")
            msgs.append({**m, "content": "".join(parts)})
        rendered = apply_chat_template(tok, msgs)
        wire_items, pos = [], 0
        for hit in _re.finditer(r"\x00IMG(\d+)\x00", rendered):
            if hit.start() > pos:
                wire_items.append({"text": rendered[pos:hit.start()]})
            wire_items.append({"image_b64": imgs[int(hit.group(1))]})
            pos = hit.end()
        if pos < len(rendered):
            wire_items.append({"text": rendered[pos:]})
        try:
            items = server._mm_items(spec, wire_items)
        except ValueError as e:
            raise ApiError(400, f"bad image payload: {e}")
        n_new = int(body.get("max_tokens",
                             body.get("max_completion_tokens", 16)))
        try:
            embeds = mm.embed_items(items)
            toks = [int(t) for t in mm.generate_from_embeds(
                embeds, n_new, sampling=_sampling_from(body))[0]]
        except ValueError as e:    # fused sequence beyond the buckets
            raise ApiError(400, str(e))
        finish = "length"
        eos_ids = getattr(mm.text, "eos_token_ids", None) or ()
        hits = [toks.index(e) for e in eos_ids if e in toks]
        if hits:
            toks, finish = toks[:min(hits)], "stop"
        text = tok.decode(toks)
        for s in _stops_from(body):
            i = text.find(s)
            if i >= 0:
                text, finish = text[:i], "stop"
        prompt_toks = int(embeds.shape[1])   # fused text+image length
        rid = f"cmpl-{int(time.time() * 1000):x}"
        self._json(200, {
            "id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": entry.name,
            "choices": [{"index": 0, "logprobs": None,
                         "finish_reason": finish,
                         "message": {"role": "assistant",
                                     "content": text}}],
            "usage": {"prompt_tokens": prompt_toks,
                      "completion_tokens": len(toks),
                      "total_tokens": prompt_toks + len(toks)}})

    @staticmethod
    def _fmt_logprobs(lp, chat: bool):
        """Per-token rescore rows -> the chat (content list) or legacy
        completions (parallel arrays) logprobs shape."""
        if lp is None:
            return None
        if chat:
            return {"content": [
                {"token": r["token"], "logprob": r["logprob"],
                 "bytes": list(r["token"].encode()),
                 "top_logprobs": [
                     t | {"bytes": list(t["token"].encode())}
                     for t in r["top_logprobs"]]}
                for r in lp]}
        offsets, pos = [], 0
        for r in lp:
            offsets.append(pos)
            pos += len(r["token"])
        return {"tokens": [r["token"] for r in lp],
                "token_logprobs": [r["logprob"] for r in lp],
                "top_logprobs": [
                    {t["token"]: t["logprob"] for t in r["top_logprobs"]}
                    for r in lp] if any(r["top_logprobs"] for r in lp)
                else None,
                "text_offset": offsets}

    def _stream(self, gen: _Generator, rid: str, kind: str, chat: bool):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(payload: bytes):
            self.wfile.write(f"{len(payload):x}\r\n".encode()
                             + payload + b"\r\n")

        def emit(obj):
            write_chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")

        def delta_obj(piece: Optional[str], finish=None):
            d: Dict[str, Any] = {"index": 0, "finish_reason": finish}
            if chat:
                d["delta"] = ({"content": piece} if piece is not None
                              else {})
            else:
                d["text"] = piece or ""
            return {"id": rid, "object": kind + ".chunk",
                    "created": int(time.time()),
                    "model": gen.entry.name, "choices": [d]}

        q: "_queue.Queue" = _queue.Queue()
        done: Dict[str, Any] = {}

        def work():
            try:
                done["res"] = gen.run(on_delta=lambda s: q.put(s))
            except Exception as e:  # noqa: BLE001
                done["err"] = e
            finally:
                q.put(None)

        threading.Thread(target=work, daemon=True).start()
        try:
            if chat:
                emit(delta_obj(None) | {"choices": [{
                    "index": 0, "finish_reason": None,
                    "delta": {"role": "assistant", "content": ""}}]})
            while True:
                piece = q.get()
                if piece is None:
                    break
                emit(delta_obj(piece))
            if "err" in done:
                emit({"error": {"message": str(done["err"]),
                                "type": "server_error"}})
            else:
                res = done["res"]
                emit(delta_obj(None, finish=res["finish_reason"])
                     | {"usage": res["usage"]})
            write_chunk(b"data: [DONE]\n\n")
            write_chunk(b"")               # terminating chunk
        except (BrokenPipeError, ConnectionError):
            pass


class OpenAIApi:
    """The OpenAI-compatible HTTP front end. Shares the WebSocket
    Server's model registry, interfaces, and batchers — load models over
    the WS protocol (or CLI `serve --load`) and query them over HTTP."""

    # connections the listening socket queues while the accept loop is
    # busy: http.server's default of 5 resets clients of a burst, such as
    # the batcher's 64 slots filled at once
    BACKLOG = 128

    def __init__(self, server, host: str = "127.0.0.1", port: int = 8000):
        self.server = server
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "OpenAIApi":
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler,
                                          bind_and_activate=False)
        self._httpd.request_queue_size = self.BACKLOG
        try:
            self._httpd.server_bind()
            self._httpd.server_activate()
        except BaseException:
            self._httpd.server_close()
            raise
        self._httpd.api = self           # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
