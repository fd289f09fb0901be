"""The reference server, with the port's interfaces behind it.

Counterpart of whisper_tensor_tpu/server/main.py:43-66 and :650-695.
`Server` subclasses the reference's, so its protocol handling, model
registry, scheduler and the OpenAI HTTP front end
(whisper_tensor_tpu/server/openai_api.py) run unchanged; what differs
is where text runs:
  * `__init__` sets the reference's fields on a chosen torch device and
    enables no XLA compile cache;
  * `_text_iface` builds the port's TextInferenceInterface on that
    device (`_score_iface`, inherited, returns it for direct models);
  * `_make_batcher` builds the port's ContinuousBatcher on that device
    for a `ragged_decode` model; the inherited `_batcher`,
    `_score_iface` (the batcher's own interface) and
    `_generate_text_ragged` run on it unchanged. Served LoRA adapters
    (`serve_adapters`) raise "not ported".
"""

from __future__ import annotations

import threading
from typing import Set

from whisper_tensor_tpu.dtype import DType
from whisper_tensor_tpu.server.main import Server as _ReferenceServer
from whisper_tensor_tpu.server.model_server import ModelServer
from whisper_tensor_tpu.server.scheduler import Scheduler

from ..device import resolve_device
from ..interfaces.text import TextInferenceInterface, _not_ported
from .batching import ContinuousBatcher


class Server(_ReferenceServer):
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.models = ModelServer()
        self.scheduler = Scheduler()
        self._conns: Set = set()
        self._loop = None
        self._text_ifaces: dict = {}
        self._batchers: dict = {}
        self._batch_jobs: dict = {}
        self._spec_decoders: dict = {}
        self._mm_ifaces: dict = {}
        self._stt_streams: dict = {}
        self._stt_ifaces: dict = {}
        # guards get-then-create on the caches above (the HTTP front end
        # is a ThreadingHTTPServer)
        self._cache_lock = threading.RLock()

    def _text_iface(self, entry) -> TextInferenceInterface:
        with self._cache_lock:
            iface = self._text_ifaces.get(entry.id)
            if iface is None:
                cfg = entry.interfaces["text"]
                if cfg.get("windows"):
                    raise _not_ported("windowed decode (decode_windows)")
                iface = TextInferenceInterface(
                    entry.model, max_len=int(cfg["max_len"]),
                    cache_dtype=DType.BF16,
                    eos_token_id=cfg.get("eos_token_id"),
                    quantize=cfg.get("quantize") or None,
                    device=self.device)
                self._text_ifaces[entry.id] = iface
            return iface

    def _make_batcher(self, entry) -> ContinuousBatcher:
        """Construct (not start) the batcher from the entry's text spec,
        as the reference does (server/main.py:697-727)."""
        cfg = entry.interfaces["text"]
        if cfg.get("adapters"):
            raise _not_ported("LoRA adapters (serve_adapters)")
        pc = cfg.get("prefill_chunk")
        return ContinuousBatcher(
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
            device=self.device)


__all__ = ["Server"]
