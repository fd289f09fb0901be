"""The port's Server serving a ragged_decode checkpoint through its
ContinuousBatcher, over the port's OpenAI HTTP API and WebSocket
protocol, on the CPU.

The tiny llama checkpoint of tests/test_torch_port_slice.py (2 layers,
hidden 256, 2 query heads and 1 KV head of 128, vocab 512, max_len 64,
weights from numpy with fixed seeds) is loaded with ragged_decode, so
every unconstrained request goes to the batcher. The server keeps a
bf16 KV cache, as on the card; each answer must carry the batcher's
own interface's greedy tokens for that prompt (the direct path over the
same weights and cache type).
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from whisper_tensor_tpu_torch.server.batching import ContinuousBatcher
from whisper_tensor_tpu_torch.server.main import Server
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi
from whisper_tensor_tpu_torch.tokenizer import (ByteTokenizer,
                                                IncrementalDecoder,
                                                apply_chat_template)

from tests.test_torch_port_slice import ROOT, _post
from tests.test_torch_port_slice import checkpoint  # noqa: F401 (fixture)

TOK = ByteTokenizer()


@pytest.fixture(scope="module")
def served(checkpoint):  # noqa: F811
    srv = Server(device="cpu")
    (entry,) = srv.models.run_loader("transformers", {
        "path": checkpoint, "dtype": "f32", "max_len": 64,
        "ragged_decode": True, "serve_batch": 4, "serve_chunk": 3,
        "prefill_chunk": 16})
    api = OpenAIApi(srv, "127.0.0.1", 0).start()
    yield srv, entry, api
    api.stop()
    for bat in srv._batchers.values():
        bat.stop()


def _own(srv, entry, text, n):
    """The batcher interface's direct-path greedy tokens, as text."""
    ids = np.asarray(TOK.encode(text), np.int64)[None]
    return TOK.decode(list(
        srv._batcher(entry).iface.generate_tokens(ids, n)[0]))


def test_concurrent_completions_go_through_the_batcher(served):
    """Six concurrent /v1/completions through four slots: each returns
    200 with its tokens, equal to the direct path's."""
    srv, entry, api = served
    prompts = ["hello there", "a", "the quick brown fox jumps",
               "x" * 30, "12345", "why?"]
    n_tok = [5, 9, 4, 7, 6, 8]
    out = {}

    def go(i):
        out[i] = _post(api.port, "/v1/completions", {
            "model": str(entry.id), "prompt": prompts[i],
            "max_tokens": n_tok[i], "temperature": 0})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    bat = srv._batchers[entry.id]
    assert isinstance(bat, ContinuousBatcher) and bat.max_batch == 4
    for i in range(6):
        status, data = out[i]
        assert status == 200, data
        r = json.loads(data)
        assert r["usage"]["completion_tokens"] == n_tok[i]
        assert r["choices"][0]["text"] == _own(srv, entry, prompts[i],
                                               n_tok[i])


def test_a_burst_of_connections_is_queued_not_reset(served):
    """64 clients connect at once (the batcher's 64 slots filled in one
    burst): the listening socket queues them all (http.server's default
    backlog of 5 reset some), and every /v1/models answers 200."""
    _, _, api = served
    assert api._httpd.request_queue_size == OpenAIApi.BACKLOG >= 64
    n = 64
    start, out = threading.Barrier(n), [None] * n

    def go(i):
        start.wait()
        c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=120)
        try:
            c.request("GET", "/v1/models")
            r = c.getresponse()
            out[i] = (r.status, r.read())
        finally:
            c.close()

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None and o[0] == 200 for o in out), out


def test_stream_logprobs_and_metrics(served):
    """A streamed chat ends with [DONE] and carries the direct path's
    text; logprobs are rescored by the batcher's own interface; GET
    /metrics reports the batcher's counters."""
    srv, entry, api = served
    msgs = [{"role": "user", "content": "hi"}]
    status, raw = _post(api.port, "/v1/chat/completions", {
        "model": str(entry.id), "messages": msgs, "max_tokens": 6,
        "temperature": 0, "stream": True})
    assert status == 200
    events = [ln[6:] for ln in raw.split(b"\n") if ln.startswith(b"data: ")]
    assert events[-1] == b"[DONE]"
    assert json.loads(events[-2])["usage"]["completion_tokens"] == 6
    text = "".join(json.loads(e)["choices"][0].get("delta", {})
                   .get("content") or "" for e in events[:-1])
    # the deltas the front end cuts from the direct path's tokens (an
    # incremental decode: bytes of one character split over tokens may
    # decode otherwise than the whole text)
    ids = np.asarray(TOK.encode(apply_chat_template(TOK, msgs)), np.int64)
    dec, want = IncrementalDecoder(TOK), ""
    for t in srv._batcher(entry).iface.generate_tokens(ids[None], 6)[0]:
        dec.push(int(t))
        want += dec.text_from(len(want)) if dec.length > len(want) else ""
    assert text == want

    status, data = _post(api.port, "/v1/completions", {
        "model": str(entry.id), "prompt": "hello there", "max_tokens": 4,
        "temperature": 0, "logprobs": 2})
    assert status == 200, data
    lp = json.loads(data)["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == 4
    for chosen, top in zip(lp["token_logprobs"], lp["top_logprobs"]):
        # greedy picked the argmax (bf16 cache: within 1e-3 of the best)
        assert chosen <= 0 and abs(max(top.values()) - chosen) < 1e-3

    c = http.client.HTTPConnection("127.0.0.1", api.port, timeout=60)
    c.request("GET", "/metrics")
    body = c.getresponse().read().decode()
    c.close()
    stats = srv._batchers[entry.id].stats()
    assert f'wt_batcher_slots{{model_id="{entry.id}"}} 4' in body
    line = next(ln for ln in body.splitlines() if ln.startswith(
        f'wt_batcher_tokens_emitted_total{{model_id="{entry.id}"}}'))
    assert 10 <= int(line.split()[-1]) <= stats["tokens_emitted"]


def test_websocket_cancel_and_batcher_stats(checkpoint):  # noqa: F811
    """cancel_request on a batched generation returns the partial text
    as job_result; get_batcher_stats reads stats() (reference
    tests/test_batching.py:282)."""
    import asyncio
    import socket

    from tests.test_server_cli import _WSClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = Server(device="cpu")
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(srv.run(port=port))
        except RuntimeError:
            pass   # teardown stops the loop mid-serve

    threading.Thread(target=run, daemon=True).start()
    time.sleep(0.3)
    c = _WSClient("127.0.0.1", port)
    try:
        c.send({"type": "run_loader", "loader": "transformers",
                "config": {"path": checkpoint, "dtype": "f32", "max_len": 64,
                           "ragged_decode": True, "serve_chunk": 2}})
        mid = c.recv()["loaded"][0]
        c.send({"type": "generate_text", "model_id": mid, "prompt": "hi",
                "max_new_tokens": 50, "tokenizer": "bytes"})
        job, seen, result = None, 0, None
        for _ in range(400):
            r = c.recv()
            if r["type"] == "job_accepted":
                job = r["job"]
            elif r["type"] == "progress" and r.get("job") == job:
                seen += 1
                if seen == 3:
                    c.send({"type": "cancel_request", "job": job})
            elif r["type"] == "cancel_ack":
                assert r["ok"] is True
            elif r["type"] == "job_result":
                result = r
                break
            assert r["type"] != "job_error", r
        assert result is not None
        assert 0 < len(result["result"]["text"]) < 50
        c.send({"type": "get_batcher_stats", "model_id": mid})
        st = c.recv()
        assert st["type"] == "batcher_stats"
        assert st["stats"]["slots"] == 8 and st["stats"]["active"] == 0
        assert 3 <= st["stats"]["tokens_emitted"] < 50
    finally:
        c.close()
        for bat in srv._batchers.values():
            bat.stop()
        loop.call_soon_threadsafe(loop.stop)


def test_cli_serve_reaches_the_batcher(checkpoint):  # noqa: F811
    """`cli serve -c ragged_decode=1 -c serve_batch=2 ...` on the CPU: a
    completion returns 200, and /metrics lists the batcher with two
    slots."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_tensor_tpu_torch.cli", "serve",
         "--model", checkpoint, "--device", "cpu", "--http-port", "0",
         "--port", "0", "-c", "ragged_decode=1", "-c", "serve_batch=2",
         "-c", "prefill_chunk=16", "-c", "max_len=64", "-c", "dtype=f32"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        port = None
        for line in proc.stdout:
            if "OpenAI-compatible API on" in line:
                port = int(line.rsplit(":", 1)[1].split("/")[0])
                break
        assert port is not None, proc.stderr.read()[-3000:]
        status, data = _post(port, "/v1/completions", {
            "prompt": "hi", "max_tokens": 3, "temperature": 0})
        assert status == 200, data
        assert json.loads(data)["usage"]["completion_tokens"] == 3
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/metrics")
        body = c.getresponse().read().decode()
        c.close()
        assert 'wt_batcher_slots{model_id="1"} 2' in body, body
    finally:
        proc.kill()
        proc.wait(30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("path,body,what", [
    ("/v1/audio/transcriptions", {}, "/v1/audio/transcriptions"),
    # (/v1/images/generations is served since the image slice:
    # tests/test_torch_port_diffusion.py; the ids below keep their names)
    pytest.param("/v1/audio/speech", {"input": "hi"}, "/v1/audio/speech",
                 id="/v1/audio/speech-body2-/v1/audio/speech"),
    pytest.param("/v1/audio/translations", {}, "/v1/audio/translations",
                 id="/v1/audio/translations-body3-/v1/audio/translations")])
    # (image content parts are served since the text family's last
    # slice: tests/test_torch_port_llava.py)
def test_unported_routes_answer_not_ported(served, path, body, what):
    """The reference's routes and request features the port does not
    serve answer 501 with an OpenAI-style error that names them."""
    srv, entry, api = served
    status, data = _post(api.port, path, dict(body, model=str(entry.id)))
    assert status == 501, data
    err = json.loads(data)["error"]
    assert err["type"] == "not_implemented_error"
    assert what in err["message"] and "not ported" in err["message"]


@pytest.mark.parametrize("msg,what", [
    ({"type": "transcribe_stream", "model_id": 1}, "streaming transcription"),
    ({"type": "transcribe", "model_id": 1}, "transcription"),
    # (generate_multimodal is served: tests/test_torch_port_llava.py)
    ({"type": "generate_speech", "model_id": 1}, "speech generation")])
def test_unported_messages_raise_not_ported(served, msg, what):
    srv, entry, _ = served
    msg = dict(msg, model_id=entry.id) if "model_id" in msg else msg
    with pytest.raises(NotImplementedError, match=f"{what}.*not ported"):
        srv._dispatch(msg)


@pytest.mark.parametrize("config,error,match", [
    ({"lora": "/nowhere"}, FileNotFoundError, "adapter_config.json"),
    ({"serve_adapters": "a=/nowhere"}, ValueError, "needs ragged_decode"),
    ({"decode_windows": "32"}, NotImplementedError,
     "'decode_windows' is not ported")])
def test_loader_options_left_out_raise(checkpoint, config, error, match):  # noqa: F811
    """The port's transformers loader names the option it leaves out
    (decode_windows), and refuses a `lora` dir that is no PEFT adapter
    and `serve_adapters` on a model the batcher does not serve."""
    with pytest.raises(error, match=match):
        Server(device="cpu").models.run_loader(
            "transformers", dict(config, path=checkpoint, max_len=64))


def test_loader_rejects_a_model_type_it_lacks(tmp_path):
    d = tmp_path / "neox"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "gpt_neox"}))
    from safetensors.numpy import save_file

    save_file({"w": np.zeros(2, np.float32)}, str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="gpt_neox"):
        Server(device="cpu").models.run_loader("transformers",
                                               {"path": str(d)})
