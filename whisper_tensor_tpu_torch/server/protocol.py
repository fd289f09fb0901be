"""WebSocket wire protocol: typed client<->server messages.

Reference equivalent: crates/whisper-tensor-server/src/lib.rs:115-131,
397-413 (WebsocketClientServerMessage / WebsocketServerClientMessage)
and the abbreviated tensor reports (AbbreviatedTensorValue/ScaleMode,
lib.rs:148-365): tensors stream to the UI as downsampled, u8-quantized
previews to bound bandwidth.

The port's copy of whisper_tensor_tpu/server/protocol.py, without
its unused imports (the port imports nothing of the JAX package), and
with constants for the adapter and profiler messages, which the
reference spells out where it uses them.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass
from typing import List

import numpy as np

# -- abbreviated tensor previews ---------------------------------------------

ABBREV_MAX_ELEMENTS = 4096


@dataclass
class AbbreviatedTensor:
    shape: List[int]
    dtype: str
    lo: float
    hi: float
    data_u8_b64: str          # u8-quantized downsampled values
    downsampled: bool
    has_nan: bool

    @staticmethod
    def from_array(arr: np.ndarray, max_elements: int = ABBREV_MAX_ELEMENTS
                   ) -> "AbbreviatedTensor":
        a = np.asarray(arr)
        shape = list(a.shape)
        flat = a.reshape(-1)
        if flat.dtype == np.dtype(object):
            flat = np.zeros(1, dtype=np.float32)
        flat = flat.astype(np.float32, copy=False)
        has_nan = bool(np.isnan(flat).any()) if flat.size else False
        down = flat.size > max_elements
        if down:
            stride = int(np.ceil(flat.size / max_elements))
            flat = flat[::stride]
        finite = flat[np.isfinite(flat)]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 0.0
        scale = (hi - lo) or 1.0
        q = np.clip((np.nan_to_num(flat, nan=lo) - lo) / scale * 255, 0, 255)
        return AbbreviatedTensor(shape, str(a.dtype), lo, hi,
                                 base64.b64encode(q.astype(np.uint8).tobytes()).decode(),
                                 down, has_nan)

    def to_array(self) -> np.ndarray:
        q = np.frombuffer(base64.b64decode(self.data_u8_b64), dtype=np.uint8)
        return (q.astype(np.float32) / 255.0 * (self.hi - self.lo) + self.lo)


# -- full tensor payloads (request/response) -----------------------------------


def encode_tensor(arr: np.ndarray) -> dict:
    a = np.asarray(arr)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "data_b64": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()}


def decode_tensor(d: dict) -> np.ndarray:
    import ml_dtypes  # noqa: F401  (registers custom dtypes with numpy)

    raw = base64.b64decode(d["data_b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


# -- messages --------------------------------------------------------------------

# client -> server types
RUN_LOADER = "run_loader"
UNLOAD_MODEL = "unload_model"
LIST_MODELS = "list_models"
LIST_LOADERS = "list_loaders"
GET_MODEL_GRAPH = "get_model_graph"
GET_STORED_TENSOR = "get_stored_tensor"
SUPER_GRAPH_REQUEST = "super_graph_request"
CANCEL_REQUEST = "cancel_request"
GENERATE_TEXT = "generate_text"
UPDATE_OBSERVER_SETTINGS = "update_observer_settings"
PING = "ping"
COMPILE_MODEL = "compile_model"
GET_TOKENIZER = "get_tokenizer"
LOAD_ADAPTER = "load_adapter"
START_PROFILER = "start_profiler"
STOP_PROFILER = "stop_profiler"

# server -> client types
MODELS_REPORT = "models_report"
GENERATE_IMAGE = "generate_image"
LOADERS_REPORT = "loaders_report"
MODEL_GRAPH = "model_graph"
STORED_TENSOR = "stored_tensor"
JOB_ACCEPTED = "job_accepted"
NODE_EXECUTED = "node_executed"
TENSOR_ASSIGNED = "tensor_assigned"
PROGRESS = "progress"
JOB_RESULT = "job_result"
JOB_ERROR = "job_error"
PONG = "pong"
MODEL_COMPILED = "model_compiled"
TOKENIZER_FILE = "tokenizer_file"
ADAPTER_LOADED = "adapter_loaded"
PROFILER_ACK = "profiler_ack"


def message(msg_type: str, **payload) -> str:
    return json.dumps({"type": msg_type, **payload})


def parse_message(raw: str) -> dict:
    d = json.loads(raw)
    if "type" not in d:
        raise ValueError("message missing 'type'")
    return d
