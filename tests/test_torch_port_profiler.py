"""The port's profiler messages on the CPU: start_profiler and
stop_profiler (torch.profiler) around a served completion write a Chrome
trace into the message's dir; the WebSocket protocol answers
profiler_ack, as the JAX package's server does (server/main.py:255-270).
"""

import json
import os

import numpy as np
import pytest

from whisper_tensor_tpu_torch.server.main import Server

from tests.test_torch_port_slice import checkpoint  # noqa: F401 (fixture)


def test_profiler_start_stop_writes_a_trace(checkpoint, tmp_path):  # noqa: F811
    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("transformers", {
        "path": checkpoint, "dtype": "f32", "max_len": 64})
    pdir = str(tmp_path / "prof")
    with pytest.raises(ValueError, match="not running"):
        srv._dispatch({"type": "stop_profiler"})
    ack = srv._dispatch({"type": "start_profiler", "dir": pdir})
    assert ack == {"type": "profiler_ack", "started": True, "dir": pdir}
    with pytest.raises(ValueError, match="already running"):
        srv._dispatch({"type": "start_profiler", "dir": pdir})
    srv._text_iface(entry).generate_tokens(np.arange(5)[None], 4)
    ack = srv._dispatch({"type": "stop_profiler"})
    assert ack["type"] == "profiler_ack" and ack["started"] is False
    assert ack["dir"] == pdir and os.path.dirname(ack["trace"]) == pdir
    with open(ack["trace"], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    # the profiler can run again
    srv._dispatch({"type": "start_profiler", "dir": pdir})
    assert len(os.listdir(pdir)) == 1
    srv._dispatch({"type": "stop_profiler"})
    assert len(os.listdir(pdir)) == 2
