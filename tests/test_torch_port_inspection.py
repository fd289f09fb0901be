"""The port's inspection front end against the JAX package's, on the CPU.

* The WebSocket messages on a port `Server(device="cpu")` beside the JAX
  package's `Server()`, each loading the tiny llama checkpoint of
  tests/test_torch_port_slice.py (f32 and bf16) and a small If model:
  get_super_graph, super_graph_request (reports only for subscribed
  links; a step-graph label reported once per run of the step graph,
  from the port's taps; a bf16 label and a device-style tensor reach the
  client), get_graph_layout (with `subgraph_path` into the If),
  get_tensor_slice and get_op_milli: each reply equals the JAX server's
  reply to the same message on the same model, with the packages'
  global ids of ops and tensors replaced by their order. Tolerances:
  tokens and integer reports exact; f32 report ranges rtol 1e-5, atol
  1e-6; bf16 report ranges within 2^-7 of their magnitude (one bf16
  ulp: each package rounds an f32 result to bf16 once).
* One live WebSocket session: get_super_graph, then super_graph_request
  of that JSON unchanged, on the port's server; the web UI over HTTP.
* generate_image on the tiny f32 `sd` pipeline, plain and with
  `preview` (one step_preview frame a step); the speech messages,
  served since the speech slice, name the interface a text model lacks.
* `build_layout` equal to the JAX package's on the same graph JSON.
* Export: `to_onnx_bytes` / `save_onnx` of the tiny GPT-2, the tiny
  llama, and an If and a Scan graph give the JAX package's bytes for
  `embed`, `external` (the `.bin` too) and `none`; a round trip gives
  equal outputs; `cli inspect` prints the JAX CLI's JSON and `cli
  export` writes its bytes.
* The port's `webui.html`: the checks of tests/test_webui.py against the
  port's server (sent types dispatched, handled report types emitted,
  brackets, DOM ids).
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import io
import os
import re
import socket
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from whisper_tensor_tpu.cli import main as jax_cli  # noqa: E402
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.onnx_builder import (  # noqa: E402
    OnnxBuilder as JaxOnnxBuilder, WeightStorage)
from whisper_tensor_tpu.importers.recipes.llm.gpt2 import (  # noqa: E402
    GPT2Config, build_gpt2_step, random_gpt2_weights)
from whisper_tensor_tpu.importers.recipes.llm.llama import (  # noqa: E402
    build_llama_step)
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu.server.graph_layout import (  # noqa: E402
    build_layout as jax_build_layout)
from whisper_tensor_tpu.server.main import Server as JaxServer  # noqa: E402
from whisper_tensor_tpu.server.model_server import (  # noqa: E402
    LoadedModelEntry as JaxEntry)
from whisper_tensor_tpu.symbolic_graph.export import (  # noqa: E402
    ExternalSink as JaxSink)
from whisper_tensor_tpu_torch.cli import main as port_cli  # noqa: E402
from whisper_tensor_tpu_torch.model import Model  # noqa: E402
from whisper_tensor_tpu_torch.server import main as port_main  # noqa: E402
from whisper_tensor_tpu_torch.server.graph_layout import (  # noqa: E402
    build_layout)
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.model_server import (  # noqa: E402
    LoadedModelEntry)
from whisper_tensor_tpu_torch.symbolic_graph.export import (  # noqa: E402
    ExternalSink)

from tests.test_torch_port_slice import (  # noqa: E402
    CFG as LLAMA_CFG, MAX_LEN, _weights as llama_weights)
from tests.test_torch_port_slice import checkpoint  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
UI = os.path.join(os.path.dirname(port_main.__file__), "webui.html")


def _if_model_bytes() -> bytes:
    """An If over two branches of one Mul each (the reference's
    tests/test_onnx_export.py:97)."""
    inner_t = JaxOnnxBuilder("it")
    inner_t.node("Mul", ["x", inner_t.const(np.float32(10))], outputs=["iv"])
    inner_t.output("iv", JaxDType.F32, [2])
    inner_e = JaxOnnxBuilder("ie")
    inner_e.node("Mul", ["x", inner_e.const(np.float32(100))],
                 outputs=["iv"])
    inner_e.output("iv", JaxDType.F32, [2])
    b = JaxOnnxBuilder("if_rt")
    b.input("c", JaxDType.BOOL, [])
    b.input("x", JaxDType.F32, [2])
    b.node("If", ["c"], outputs=["y"],
           then_branch=inner_t.build_graph_proto(WeightStorage.embed()),
           else_branch=inner_e.build_graph_proto(WeightStorage.embed()))
    b.output("y", JaxDType.F32, [2])
    return b.build()


def _scan_model_bytes() -> bytes:
    body = JaxOnnxBuilder("body")
    body.input("acc", JaxDType.F32, [1])
    body.input("el", JaxDType.F32, [1])
    body.node("Add", ["acc", "el"], outputs=["acc_o"])
    body.node("Identity", ["acc_o"], outputs=["sc_o"])
    body.output("acc_o", JaxDType.F32, [1])
    body.output("sc_o", JaxDType.F32, [1])
    b = JaxOnnxBuilder("scan_rt")
    b.input("init", JaxDType.F32, [1])
    b.input("seq", JaxDType.F32, [4, 1])
    b.node("Scan", ["init", "seq"], outputs=["fin", "outs"],
           num_scan_inputs=1, scan_input_directions=[1],
           body=body.build_graph_proto(WeightStorage.embed()))
    b.output("fin", JaxDType.F32, [1])
    b.output("outs", JaxDType.F32, [4, 1])
    return b.build()


@pytest.fixture(scope="module")
def servers(checkpoint):  # noqa: F811
    """(JAX server, port server), each with model 1 the f32 checkpoint,
    2 the bf16 one and 3 the If model."""
    jsrv, psrv = JaxServer(), Server(device="cpu")
    data = _if_model_bytes()
    for srv, model, entry in ((jsrv, JaxModel, JaxEntry),
                              (psrv, Model, LoadedModelEntry)):
        for dt in ("f32", "bf16"):
            srv.models.run_loader("transformers", {
                "path": checkpoint, "dtype": dt, "max_len": MAX_LEN})
        srv.models._models[3] = entry(3, "if", model.new_from_onnx(
            data, name="if"))
    yield jsrv, psrv
    jsrv.scheduler.shutdown()
    psrv.scheduler.shutdown()


def _run_job(srv, msg):
    """Dispatch a job message; its reports through job_result/job_error."""
    assert srv._dispatch(msg) is None
    reports = []
    while True:
        r = srv.scheduler.reports.get(timeout=300)
        reports.append(r)
        if r["type"] in ("job_result", "job_error"):
            assert r["type"] == "job_result", r.get("error")
            return reports


def _ranks(graph_json) -> dict:
    """{global id of an op or tensor: its place among the graph's ids,
    nested graphs included}: the packages number both from one global
    counter, in the same order."""
    ids = set()

    def walk(g):
        ids.update(int(t) for t in g["tensors"])
        for op in g["ops"]:
            ids.add(op["id"])
            for sub in op.get("subgraphs", {}).values():
                walk(sub)
    walk(graph_json)
    return {i: k for k, i in enumerate(sorted(ids))}


def _norm_layout(layout, ranks):
    out = dict(layout)
    out["nodes"] = [dict(n, ref=ranks.get(n["ref"], n["ref"])
                         if isinstance(n["ref"], int) else n["ref"])
                    for n in layout["nodes"]]
    out["edges"] = [dict(e, tensor=ranks.get(e.get("tensor"),
                                             e.get("tensor")))
                    for e in layout["edges"]]
    return out


# -- inspection messages ---------------------------------------------------------

@pytest.mark.parametrize("msg", [
    {"type": "get_super_graph", "model_id": 1},
    {"type": "get_super_graph", "model_id": 2, "n_new": 5}],
    ids=["default", "n_new_5"])
def test_get_super_graph_equals_the_jax_servers_reply(servers, msg):
    jsrv, psrv = servers
    assert psrv._dispatch(dict(msg)) == jsrv._dispatch(dict(msg))


def test_super_graph_request_equals_the_jax_servers_job(servers):
    """The same job JSON with subscriptions to two links: result, node
    sequence and the subscribed links' reports (only those) equal; the
    port runs it on its device path (the default), the JAX server in its
    default oracle."""
    jsrv, psrv = servers
    graph = jsrv._dispatch({"type": "get_super_graph", "model_id": 1,
                            "n_new": 6})["graph"]
    msg = {"type": "super_graph_request", "graph": graph,
           "inputs": {"text": "hello"}, "model_ids": [1],
           "tensor_subscriptions": ["first_token", "generated_tokens",
                                    "prefill_state"]}
    want = _run_job(jsrv, dict(msg))
    got = _run_job(psrv, dict(msg))
    assert got[-1]["result"] == want[-1]["result"]
    assert got[-1]["result"]["tokens"]["shape"] == [6]

    def nodes(rs):
        return [r["node"] for r in rs if r["type"] == "node_executed"]

    assert nodes(got) == nodes(want)

    def assigned(rs):
        return [r for r in rs if r["type"] == "tensor_assigned"]

    ga, wa = assigned(got), assigned(want)
    assert [r["link"] for r in ga] == [r["link"] for r in wa] == [
        "prefill_state", "first_token", "generated_tokens"]
    for g, w in zip(ga, wa):
        assert g["tensor"] == w["tensor"], g["link"]
    # the tensor map's entries, which the reference cannot encode
    caches = ga[0]["tensors"]
    assert {f"cache_{kv}_{i}" for kv in "kv" for i in range(2)} <= \
        set(caches)
    assert caches["cache_k_0"]["shape"] == [1, 1, MAX_LEN, 128]
    assert caches["cache_k_0"]["hi"] > 0


def _attention_label(srv, model_id):
    g = srv.models.get(model_id).model.graph
    return next(g.tensors[o].name for sop in g.ops if sop.op.OP_TYPE ==
                "Attention" for o in sop.outputs if o is not None)


def test_a_subscribed_step_graph_label_reaches_the_client(servers):
    """A bf16 model's layer-0 attention output, subscribed: the JAX
    server reports it from its compiled taps (mode xla), the port from
    its executor's taps as a device-style bf16 tensor; both once per run
    of the step graph (the prefill and n_new - 1 decode steps)."""
    jsrv, psrv = servers
    n_new = 4
    label = _attention_label(psrv, 2)
    assert label == _attention_label(jsrv, 2)
    graph = jsrv._dispatch({"type": "get_super_graph", "model_id": 2,
                            "n_new": n_new})["graph"]
    msg = {"type": "super_graph_request", "graph": graph,
           "inputs": {"text": "hey"}, "model_ids": [2],
           "backend_mode": "xla",
           "tensor_subscriptions": [label, "first_token"]}
    want = _run_job(jsrv, dict(msg))
    got = _run_job(psrv, dict(msg))
    assert got[-1]["result"]["text"] == want[-1]["result"]["text"]
    ga = [r for r in got if r["type"] == "tensor_assigned"]
    wa = [r for r in want if r["type"] == "tensor_assigned"]
    assert [r["link"] for r in ga] == [r["link"] for r in wa]
    assert sum(r["link"] == label for r in ga) == n_new
    assert sum(r["link"] == "first_token" for r in ga) == 1
    for g, w in zip(ga, wa):
        gt, wt = g["tensor"], w["tensor"]
        assert gt["shape"] == wt["shape"] and gt["dtype"] == wt["dtype"]
        if g["link"] == label:
            assert gt["dtype"] == "bfloat16"
            mag = max(abs(wt["lo"]), abs(wt["hi"]))
            assert abs(gt["lo"] - wt["lo"]) <= 2 ** -7 * mag
            assert abs(gt["hi"] - wt["hi"]) <= 2 ** -7 * mag
        else:
            assert gt == wt


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_a_quantized_models_job_runs_on_its_text_interfaces_weights(
        checkpoint, quantize):  # noqa: F811
    """A model loaded with quantize=int8 or q4_0: its super_graph_request
    runs the text interface's quantized graph over that interface's
    device weights (nothing quantized or uploaded a second time), answers
    the interface's greedy tokens, and a subscribed step-graph label is
    reported from that graph once a run."""
    from whisper_tensor_tpu_torch.server import protocol as P
    from whisper_tensor_tpu_torch.tokenizer import ByteTokenizer

    psrv = Server(device="cpu")
    (entry,) = psrv.models.run_loader("transformers", {
        "path": checkpoint, "dtype": "f32", "max_len": MAX_LEN,
        "quantize": quantize})
    try:
        n_new, label = 5, _attention_label(psrv, entry.id)
        graph = psrv._dispatch({"type": "get_super_graph",
                                "model_id": entry.id,
                                "n_new": n_new})["graph"]
        got = _run_job(psrv, {
            "type": "super_graph_request", "graph": graph,
            "inputs": {"text": "hello"}, "model_ids": [entry.id],
            "tensor_subscriptions": [label]})
        iface = psrv._score_iface(entry)
        be, g = iface.eval_backend(), entry.model.graph
        assert iface._quantized if quantize == "int8" else iface._packed
        assert be._executor(g)[0].graph is iface.milli
        assert be._device_weights(g, ()) is iface._weights()
        assert sum(r["type"] == "tensor_assigned" and r["link"] == label
                   for r in got) == n_new
        prompt = np.asarray(ByteTokenizer().encode("hello"), np.int64)[None]
        np.testing.assert_array_equal(
            P.decode_tensor(got[-1]["result"]["tokens"]),
            iface.generate_tokens(prompt, n_new)[0])
    finally:
        psrv.scheduler.shutdown()


@pytest.mark.parametrize("case", ["llama", "if_body"])
def test_get_graph_layout_equals_the_jax_servers_reply(servers, case):
    jsrv, psrv = servers
    replies = []
    for srv in servers:
        if case == "llama":
            msg = {"type": "get_graph_layout", "model_id": 1,
                   "max_ops": 60}
        else:
            g = srv.models.graph_json(3)
            (op,) = g["ops"]
            msg = {"type": "get_graph_layout", "model_id": 3,
                   "subgraph_path": [[op["id"], "else_branch"]]}
        reply = srv._dispatch(msg)
        replies.append(dict(reply, layout=_norm_layout(
            reply["layout"], _ranks(srv.models.graph_json(msg["model_id"])))))
    assert replies[1] == replies[0]
    layout = replies[1]["layout"]
    ys = {n["id"]: n["y"] for n in layout["nodes"]}
    assert layout["nodes"] and all(ys[e["src"]] < ys[e["dst"]]
                                   for e in layout["edges"])
    if case == "if_body":
        assert sorted(n["label"] for n in layout["nodes"]
                      if n["kind"] == "op") == ["Constant", "mul"]


@pytest.mark.parametrize("msg", [
    {"name": "embed_tokens", "fix": [7, None]},
    {"name": "wq_1", "row_off": 5, "col_off": 100, "max_rows": 3,
     "max_cols": 9},
    {"name": "final_norm"}], ids=["row", "window", "1d"])
def test_get_tensor_slice_equals_the_jax_servers_reply(servers, msg):
    jsrv, psrv = servers
    msg = dict(msg, type="get_tensor_slice", model_id=1)
    got, want = psrv._dispatch(dict(msg)), jsrv._dispatch(dict(msg))
    assert got == want
    if msg.get("fix"):
        # the checkpoint's own row, rounded to 6 places as the reply is
        row = llama_weights("model.embed_tokens.weight")[7]
        np.testing.assert_allclose(got["values"][0], row[:64], atol=5e-7)


@pytest.mark.parametrize("op_type", ["Attention", "MatMul", "If"])
def test_get_op_milli_equals_the_jax_servers_reply(servers, op_type):
    replies = []
    for srv in servers:
        mid = 3 if op_type == "If" else 1
        g = srv.models.get(mid).model.graph
        sop = next(o for o in g.ops if o.op.OP_TYPE == op_type)
        msg = {"type": "get_op_milli", "model_id": mid, "op_id": sop.id}
        if op_type == "If":
            with pytest.raises(Exception) as e:
                srv._dispatch(msg)
            replies.append(type(e.value).__name__)
            continue
        reply = srv._dispatch(msg)
        reply["op_id"] = _ranks(srv.models.graph_json(mid))[reply["op_id"]]
        replies.append(reply)
    assert replies[1] == replies[0]
    if op_type != "If":
        assert replies[1]["nodes"]


def test_media_messages_still_answer_not_ported(servers):
    """(Named when the speech messages answered "not ported": since the
    speech slice the port serves every message of the JAX server, and a
    speech message on a model without speech names what it lacks.)"""
    _, psrv = servers
    assert not hasattr(port_main, "_UNPORTED_MESSAGES")
    mid = psrv.models.list_models()[0]["id"]
    for t, what in (("generate_speech", "no TTS interface"),
                    ("transcribe", "no STT interface"),
                    ("transcribe_stream", "no STT interface")):
        with pytest.raises(ValueError, match=what):
            psrv._dispatch({"type": t, "model_id": mid, "text": "hi",
                            "samples_b64": "", "stream_id": t})


def test_build_layout_equals_the_jax_packages():
    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=211,
                     n_positions=64)
    m = JaxModel.new_from_onnx(build_gpt2_step(
        random_gpt2_weights(cfg), cfg, max_len=64))
    from whisper_tensor_tpu.server.model_server import ModelServer

    g = ModelServer()._graph_json(m.graph)
    for kw in ({}, {"max_ops": 25}):
        assert build_layout(g, **kw) == jax_build_layout(g, **kw)


# -- a live WebSocket session ----------------------------------------------------------

def test_websocket_super_graph_session_and_the_web_ui(checkpoint):  # noqa: F811
    from tests.test_server_cli import _WSClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = Server(device="cpu")
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        with contextlib.suppress(RuntimeError):   # stopped mid-serve
            loop.run_until_complete(srv.run(port=port))

    threading.Thread(target=run, daemon=True).start()
    time.sleep(0.3)
    c = _WSClient("127.0.0.1", port)
    try:
        c.send({"type": "run_loader", "loader": "transformers",
                "config": {"path": checkpoint, "dtype": "f32",
                           "max_len": MAX_LEN}})
        mid = c.recv()["loaded"][0]
        c.send({"type": "get_super_graph", "model_id": mid, "n_new": 4})
        graph = c.recv()["graph"]
        c.send({"type": "super_graph_request", "graph": graph,
                "inputs": {"text": "hi"}, "model_ids": [mid],
                "tensor_subscriptions": ["generated_tokens"]})
        seen = []
        while not seen or seen[-1]["type"] not in ("job_result",
                                                    "job_error"):
            seen.append(c.recv())
        assert seen[-1]["type"] == "job_result", seen[-1]
        assert seen[0]["type"] == "job_accepted"
        assert sum(r["type"] == "node_executed" for r in seen) >= 10
        (tok,) = [r for r in seen if r["type"] == "tensor_assigned"]
        assert tok["link"] == "generated_tokens"
        assert tok["tensor"]["shape"] == [4]
        # the page the browser fetches: the port's own copy of the UI
        with socket.create_connection(("127.0.0.1", port), timeout=10) as h:
            h.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
            page = b""
            while b"</html>" not in page:
                chunk = h.recv(65536)
                if not chunk:
                    break
                page += chunk
        with open(UI, "rb") as f:
            assert f.read() in page
    finally:
        c.close()
        loop.call_soon_threadsafe(loop.stop)


# -- generate_image ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_server(tmp_path_factory):
    from test_diffusers_loader import _write_sd_pipeline

    d = _write_sd_pipeline(str(tmp_path_factory.mktemp("sd")))
    srv = Server(device="cpu")
    entries = srv.models.run_loader("diffusers", {
        "path": d, "dtype": "f32", "height": 128, "width": 128})
    yield srv, entries[0].id
    srv.scheduler.shutdown()


def _pixels(result):
    return np.frombuffer(base64.b64decode(result["rgb_b64"]),
                         np.uint8).reshape(result["height"],
                                           result["width"], 3)


def test_generate_image_plain_and_with_preview(sd_server):
    import torch

    from whisper_tensor_tpu_torch.interfaces.image_gen import ImageGenConfig

    srv, mid = sd_server
    msg = {"type": "generate_image", "model_id": mid, "prompt": "a cube",
           "steps": 2, "height": 128, "width": 128, "seed": 4}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = _run_job(srv, dict(msg))
        preview = _run_job(srv, dict(msg, preview=True))
    finally:
        torch.set_num_threads(n)
    a, b = _pixels(plain[-1]["result"]), _pixels(preview[-1]["result"])
    ref = srv._image_iface(srv.models.get(mid)).run(
        "a cube", cfg=ImageGenConfig(steps=2, height=128, width=128, seed=4))
    np.testing.assert_array_equal(a, ref.pixels)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    frames = [r for r in preview if r["type"] == "step_preview"]
    assert len(frames) == 2
    assert (frames[0]["width"], frames[0]["height"]) == (16, 16)
    assert sum(r["type"] == "progress" for r in plain) == 2


# -- export ----------------------------------------------------------------------------

def _export_sources():
    cfg = GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=300,
                     n_positions=64)
    return {
        "gpt2": build_gpt2_step(random_gpt2_weights(cfg), cfg, max_len=64),
        "llama_bf16": build_llama_step(llama_weights, LLAMA_CFG,
                                       max_len=MAX_LEN, dtype=JaxDType.BF16),
        "if": _if_model_bytes(), "scan": _scan_model_bytes()}


@pytest.mark.parametrize("weights", ["embed", "external", "none"])
@pytest.mark.parametrize("src", ["gpt2", "llama_bf16", "if", "scan"])
def test_export_gives_the_jax_packages_bytes(src, weights, tmp_path):
    data = _export_sources()[src]
    jm, pm = JaxModel.new_from_onnx(data), Model.new_from_onnx(data)
    if weights == "external":
        js, ps = JaxSink("w.bin"), ExternalSink("w.bin")
        assert pm.graph.to_onnx_bytes(weights, ps) == \
            jm.graph.to_onnx_bytes(weights, js)
        assert b"".join(ps.chunks) == b"".join(js.chunks)
    else:
        assert pm.graph.to_onnx_bytes(weights) == \
            jm.graph.to_onnx_bytes(weights)
    pm.save_onnx(str(tmp_path / "p.onnx"), weights=weights)
    jm.save_onnx(str(tmp_path / "j.onnx"), weights=weights)
    for ext in ((".onnx", ".onnx.bin") if weights == "external"
                else (".onnx",)):
        assert (tmp_path / f"p{ext}").read_bytes().replace(b"p.onnx.bin",
                                                           b"j.onnx.bin") \
            == (tmp_path / f"j{ext}").read_bytes()


@pytest.mark.parametrize("weights", ["embed", "external"])
def test_export_round_trip_gives_equal_outputs(weights, tmp_path):
    src = _export_sources()
    m = Model.new_from_onnx(src["gpt2"])
    m.save_onnx(str(tmp_path / "g.onnx"), weights=weights)
    m2 = Model.new_from_onnx_file(str(tmp_path / "g.onnx"))
    feeds = {"input_ids": np.asarray([[5, 6, 7]], np.int64),
             "pos": np.asarray(0, np.int64)}
    for i in range(2):
        for kv in "kv":
            feeds[f"cache_{kv}_{i}"] = np.zeros((1, 2, 64, 16), np.float32)
    a = m.eval(dict(feeds), device="cpu")
    b = m2.eval(dict(feeds), device="cpu")
    np.testing.assert_array_equal(a["logits"], b["logits"])
    cf = Model.new_from_onnx(src["if"])
    cf2 = Model.new_from_onnx(cf.graph.to_onnx_bytes())
    x = np.asarray([1.0, 2.0], np.float32)
    for c in (True, False):
        np.testing.assert_array_equal(
            cf2.eval({"c": np.asarray(c), "x": x}, device="cpu")["y"],
            cf.eval({"c": np.asarray(c), "x": x}, device="cpu")["y"])


def _cli_out(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_cli_inspect_and_export_equal_the_jax_cli(checkpoint, tmp_path):  # noqa: F811
    cfg = ["-c", "dtype=f32", "-c", f"max_len={MAX_LEN}"]
    got = _cli_out(port_cli, ["inspect", "--model", checkpoint] + cfg)
    want = _cli_out(jax_cli, ["inspect", "--model", checkpoint] + cfg)
    assert got == want
    assert '"op_census"' in got and '"Attention": 2' in got
    for weights in ("embed", "external"):
        outs = {}
        for who, main in (("p", port_cli), ("j", jax_cli)):
            d = tmp_path / f"{who}-{weights}"
            d.mkdir()
            text = _cli_out(main, ["export", "--model", checkpoint, "-o",
                                   str(d / "m.onnx"), "--weights",
                                   weights] + cfg)
            outs[who] = (text.replace(str(d), ""),
                         (d / "m.onnx").read_bytes(),
                         (d / "m.onnx.bin").read_bytes()
                         if weights == "external" else b"")
        assert outs["p"] == outs["j"]


# -- the port's web UI -------------------------------------------------------------------

def _ui_js():
    from tests.test_webui import _scripts

    with open(UI, encoding="utf-8") as f:
        html = f.read()
    return html, "\n".join(_scripts(html))


def test_port_webui_js_brackets_balance():
    from tests.test_webui import _strip_js

    _, js = _ui_js()
    stack = []
    for ch in _strip_js(js):
        if ch in "([{":
            stack.append(ch)
        elif ch in ")]}":
            assert stack and stack.pop() == {")": "(", "]": "[",
                                             "}": "{"}[ch]
    assert not stack


def _port_sources():
    d = os.path.dirname(port_main.__file__)
    return {n: open(os.path.join(d, n), encoding="utf-8").read()
            for n in ("main.py", "protocol.py", "scheduler.py")}


def test_port_webui_sends_only_types_the_port_serves_or_refuses():
    from tests.test_webui import _sent_types

    _, js = _ui_js()
    src = _port_sources()
    consts = dict(re.findall(r"""^([A-Z_]+)\s*=\s*['"]([a-z_]+)['"]""",
                             src["protocol.py"], re.M))
    served = set(re.findall(r"""if t == ['"]([a-z_]+)['"]""", src["main.py"]))
    served |= {consts[n] for n in re.findall(r"if t == P\.([A-Z_]+)",
                                             src["main.py"]) if n in consts}
    unknown = sorted(_sent_types(js) - served)
    assert not unknown, unknown
    assert {"get_super_graph", "get_graph_layout", "get_tensor_slice",
            "get_op_milli", "generate_image"} <= _sent_types(js)


def test_port_webui_handles_the_report_types_the_port_emits():
    """The UI's handlers cover every report a job streams and every reply
    of the inspection messages; the one type it handles that the port
    never emitted was the streaming transcription's, which the port has
    emitted since the speech slice."""
    _, js = _ui_js()
    handled = set(re.findall(r"""\bm\.type\s*===?\s*['"]([a-z_]+)['"]""",
                             js))
    text = "\n".join(_port_sources().values())
    emitted = set(re.findall(r"""['"]type['"]\s*:\s*['"]([a-z_]+)['"]""",
                             text))
    emitted |= set(re.findall(r"""^[A-Z_]+\s*=\s*['"]([a-z_]+)['"]""",
                              text, re.M))
    reports = {"node_executed", "tensor_assigned", "progress", "job_result",
               "job_error", "step_preview", "graph_layout", "tensor_slice",
               "op_milli", "super_graph", "model_graph", "stored_tensor",
               "models_report", "loaders_report"}
    assert reports <= emitted
    assert reports <= handled, sorted(reports - handled)
    assert sorted(handled - emitted) == []


def test_port_webui_dom_ids_resolve_and_it_names_no_tpu_tool():
    html, js = _ui_js()
    ids = set(re.findall(r"""id=["']([\w-]+)["']""", html))
    looked = set(re.findall(r"""\$\(["']([\w-]+)["']\)""", js))
    assert not sorted(looked - ids)
    assert "jax" not in html.lower()
