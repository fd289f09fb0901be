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
  * `_batcher` raises: the ContinuousBatcher (`ragged_decode`) is not
    ported yet.
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

    def _batcher(self, entry):
        raise _not_ported("ragged_decode serving (the ContinuousBatcher)")


__all__ = ["Server"]
