"""Whisper speech-to-text on the port, against the JAX package, on the CPU.

A tiny Whisper written by transformers (the JAX package's
tests/test_whisper_stt.py sizes: seeded torch init, 2 + 2 layers, 4
heads of 8, d_model 32, 16 mel bins over 200 frames, a decoder cache of
64, a vocabulary of 120) with a generation_config.json whose
`forced_decoder_ids` leave the language slot null, and a word-level
tokenizer.json that knows `<|en|>`, `<|de|>`, `<|transcribe|>`,
`<|translate|>` and `<|notimestamps|>`, so the start sequence is
[5, <|en|>, <|transcribe|>, <|notimestamps|>].

* The recipes write the JAX recipe's ONNX bytes; both loaders give the
  same `stt` spec.
* f32: the encoder's outputs and cross K/V within 1e-5 of the largest
  |value| of the JAX package's (and transformers' encoder within 1e-4);
  teacher-forced decoder logits within 1e-4 of each step's largest
  |logit| (and transformers' within 1e-3); greedy tokens of the device
  loop, of the referee loop and of the JAX interface's compiled program
  equal.
* bf16 (ROADMAP C10's rule): logits within 1/16 of each step's largest
  |logit|, tokens equal up to the first step where the JAX package's two
  best logits are nearer than that.
* transcribe_long over 2.5 windows, beams of 3 (on inputs whose first
  candidates do not tie), the start sequence's null slots and
  `sot_with`, both streaming modes' commits: equal to the JAX package's.
  A mel encoder feed is never padded or masked (ROADMAP C28 concerns
  token encoders).
* The HTTP routes' JSON and text bodies, the WebSocket replies and `cli
  stt` equal the JAX package's for the same checkpoint.
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

from whisper_tensor_tpu import cli as jax_cli  # noqa: E402
from whisper_tensor_tpu.backends.eval_backend import (  # noqa: E402
    EvalBackend as JaxEval)
from whisper_tensor_tpu.dtype import DType as JaxDType  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    loader_registry as jax_loaders)
from whisper_tensor_tpu.importers.recipes.speech import (  # noqa: E402
    whisper as jax_whisper)
from whisper_tensor_tpu.interfaces import stt as jax_stt  # noqa: E402
from whisper_tensor_tpu.server.main import Server as JaxServer  # noqa: E402
from whisper_tensor_tpu.server.openai_api import (  # noqa: E402
    OpenAIApi as JaxApi)
from whisper_tensor_tpu.super_graph.links import (  # noqa: E402
    AudioClip as JaxClip)
from whisper_tensor_tpu_torch import cli  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    loader_registry)
from whisper_tensor_tpu_torch.importers.recipes.speech import (  # noqa: E402
    whisper)
from whisper_tensor_tpu_torch.interfaces import stt  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.seq2seq import (  # noqa: E402
    Seq2SeqInterface)
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi  # noqa: E402
from whisper_tensor_tpu_torch.super_graph.links import AudioClip  # noqa: E402
from whisper_tensor_tpu_torch.utils.audio import wav_bytes  # noqa: E402

N_FRAMES, MAX_LEN, V = 200, 64, 120
WINDOW = N_FRAMES * 160                   # samples of one mel window
SPECIAL = {"<|en|>": 100, "<|de|>": 101, "<|transcribe|>": 102,
           "<|translate|>": 103, "<|notimestamps|>": 104}
SOT = [5, 100, 102, 104]
CFG = dict(d_model=32, encoder_layers=2, decoder_layers=2,
           encoder_attention_heads=4, decoder_attention_heads=4,
           encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
           max_source_positions=N_FRAMES // 2, max_target_positions=MAX_LEN,
           vocab_size=V)


def _hf():
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    torch.manual_seed(0)
    return WhisperForConditionalGeneration(WhisperConfig(
        **CFG, dropout=0.0, attention_dropout=0.0, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=5)).eval()


def _write_tokenizer(d):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit

    vocab = {f"w{i}": i for i in range(V)}
    for k, v in SPECIAL.items():
        del vocab[f"w{v}"]
        vocab[k] = v
    tok = Tokenizer(WordLevel(vocab, unk_token="w0"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.save(os.path.join(d, "tokenizer.json"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("whisper"))
    _hf().save_pretrained(d, safe_serialization=True)
    gp = os.path.join(d, "generation_config.json")
    with open(gp) as f:
        gen = json.load(f)
    gen["forced_decoder_ids"] = [[1, None], [2, 102], [3, 104]]
    with open(gp, "w") as f:
        json.dump(gen, f)
    _write_tokenizer(d)
    return d


def _bundles(path, dtype="f32"):
    cfg = {"path": path, "dtype": dtype, "max_len": MAX_LEN}
    return (loader_registry()["transformers"].load(dict(cfg)),
            jax_loaders()["transformers"].load(dict(cfg)))


@pytest.fixture(scope="module")
def ifaces(ckpt):
    pb, jb = _bundles(ckpt)
    return (stt.SpeechToTextInterface.from_bundle(pb, device="cpu"),
            jax_stt.SpeechToTextInterface.from_bundle(jb))


def _mel(seed):
    return np.random.default_rng(seed).standard_normal(
        (1, 16, N_FRAMES)).astype(np.float32)


def _clip(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    s = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    return s.astype(np.float32)


def _close(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


def _as_graph_type(jax_iface, mel):
    """The mel in the JAX encoder graph's declared type: its XLA path
    does not cast an f32 feed for a bf16 graph's convolution."""
    g = jax_iface.encoder.graph
    dt = g.tensors[g.inputs[0]].info.dtype
    return mel if dt is JaxDType.F32 else mel.astype(dt.to_numpy())


def _steps(port, jax_iface, mel, seq):
    """Teacher-forced logits of `seq` a token a step: the port's fused
    decoder step and the JAX package's decoder graph through XLA."""
    dec = port.dec
    enc = port.encode(mel)
    cross_in = [n for n in dec.milli.inputs if n.startswith("cross_")]
    caches = dec.fresh_cache(1)
    jenc = JaxEval("xla").run(jax_iface.encoder.graph,
                              {"mel": _as_graph_type(jax_iface, mel)})
    jbe = JaxEval("xla")
    feeds = {n: jenc[n] for n in cross_in}
    for n in dec.cache_in_names:
        feeds[n] = np.zeros(tuple(caches[0].shape), np.float32)
    got, want = [], []
    for t, tok in enumerate(seq):
        ids = torch.tensor([[tok]])
        f = dec._feeds(ids, torch.tensor(t), caches)
        f.update({n: enc[n] for n in cross_in})
        got.append(dec._exec(f)["logits"][0, 0].float().numpy())
        out = jbe.run(jax_iface.decoder.graph, {
            **feeds, "input_ids": ids.numpy(),
            "pos": np.asarray(t, np.int64)})
        for n in dec.cache_in_names:
            feeds[n] = np.asarray(out["new_" + n], np.float32)
        want.append(np.asarray(out["logits"], np.float32)[0, 0])
    return np.stack(got), np.stack(want)


# -- recipes and loaders ------------------------------------------------------

@pytest.mark.parametrize("dt", ["F32", "BF16"])
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_recipes_write_the_references_onnx_bytes(part, dt):
    sd = {k: v.float().numpy() for k, v in _hf().state_dict().items()}
    outs = []
    for pkg, dtype in ((whisper, DType[dt]), (jax_whisper, JaxDType[dt])):
        cfg = pkg.WhisperConfig(**CFG)
        build = (pkg.build_whisper_encoder if part == "encoder" else
                 lambda *a, **k: pkg.build_whisper_decoder_step(
                     *a, max_len=MAX_LEN, **k))
        outs.append(build(sd.__getitem__, cfg, n_frames=N_FRAMES,
                          dtype=dtype))
    assert outs[0] == outs[1]


def test_loaders_give_the_references_stt_spec(ckpt):
    pb, jb = _bundles(ckpt)
    assert pb.interfaces == jb.interfaces
    assert pb.interfaces["stt"]["sot_sequence"] == [5, None, 102, 104]
    assert pb.tokenizer_source == jb.tokenizer_source == ckpt


# -- f32 parity ---------------------------------------------------------------

def test_encoder_matches_jax_and_transformers(ckpt, ifaces):
    port, ref = ifaces
    mel = _mel(0)
    got = port.encode(mel)
    want = JaxEval("xla").run(ref.encoder.graph, {"mel": mel})
    assert set(got) == set(want)
    for n in want:
        _close(got[n].numpy(), want[n], 1e-5)
    with torch.no_grad():
        hf = _hf().model.encoder(torch.from_numpy(mel)).last_hidden_state
    _close(got["encoder_states"].numpy(), hf.numpy(), 1e-4)


def test_teacher_forced_decoder_logits_match(ckpt, ifaces):
    port, ref = ifaces
    mel = _mel(1)
    seq = SOT + [42, 17, 88, 3, 64, 9]
    got, want = _steps(port, ref, mel, seq)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    with torch.no_grad():
        hf = _hf()(torch.from_numpy(mel),
                   decoder_input_ids=torch.tensor([seq])).logits[0].numpy()
    for g, h in zip(got, hf):
        _close(g, h, 1e-3)


@pytest.mark.parametrize("seed", [1, 2])
def test_greedy_tokens_equal_the_jax_packages(ifaces, seed):
    port, ref = ifaces
    mel = _mel(seed)
    loop = port._transcribe_compiled(mel, 40)
    assert loop == port._transcribe_mel(mel, 40)
    assert loop == ref._transcribe_compiled(mel, 40)
    assert len(loop) > 0


def test_the_device_loop_stops_at_the_end_of_the_transcript(ifaces):
    """An end-of-transcript token ends the loop within CHECK_EVERY steps
    and the transcript before it; the referee agrees."""
    port, _ = ifaces
    mel = _mel(3)
    toks = port._transcribe_mel(mel, 12)
    eot = port.eot_token
    try:
        port.eot_token = toks[5]
        want = port._transcribe_mel(mel, 40)
        assert port._transcribe_compiled(mel, 40) == want
        assert len(want) < 40
    finally:
        port.eot_token = eot


def test_bf16_logits_and_tokens_follow_c10(ckpt):
    pb, jb = _bundles(ckpt, "bf16")
    port = stt.SpeechToTextInterface.from_bundle(pb, device="cpu")
    ref = jax_stt.SpeechToTextInterface.from_bundle(jb)
    assert port.cache_dtype is DType.BF16
    assert all(c.dtype == torch.bfloat16 for c in port.dec.fresh_cache(1))
    mel = _mel(4)
    toks = port._transcribe_compiled(mel, 20)
    want = ref._transcribe_compiled(_as_graph_type(ref, mel), 20)
    got_l, want_l = _steps(port, ref, mel, SOT + want)
    bound = np.abs(want_l).max(axis=-1) / 16
    assert (np.abs(got_l - want_l).max(axis=-1) <= bound).all()
    n = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b),
             None)
    if n is None:
        assert toks == want
    else:        # a near tie of the JAX package's logits at that step
        top2 = np.sort(want_l[len(SOT) - 1 + n])[-2:]
        assert top2[1] - top2[0] <= bound[len(SOT) - 1 + n]


# -- the interface ------------------------------------------------------------

def test_transcribe_long_over_two_and_a_half_windows(ifaces):
    port, ref = ifaces
    s = _clip(2.5 * WINDOW / 16000, 5)
    got = port.transcribe_long(AudioClip(s, 16000), max_new_per_chunk=10)
    assert got == ref.transcribe_long(JaxClip(s, 16000),
                                      max_new_per_chunk=10)
    assert got == port.transcribe_long(AudioClip(s, 16000), 10,
                                       compiled=False)
    assert len(got) > 20


def test_beams_equal_the_jax_packages(ifaces):
    port, ref = ifaces
    s = _clip(1.2, 6)
    mel = port.mel_from_audio(AudioClip(s, 16000))
    enc = port.encode(mel)
    lg = port.dec._exec({
        **port.dec._feeds(torch.tensor([SOT]), torch.tensor(0),
                          port.dec.fresh_cache(1)),
        **{n: enc[n] for n in enc if n.startswith("cross_")}})["logits"]
    top = torch.topk(torch.log_softmax(lg[0, -1].float(), -1), 4).values
    assert (top[:-1] - top[1:]).min() > 1e-6
    got = port.transcribe_beam(AudioClip(s, 16000), max_new=8, beam=3)
    assert got == ref.transcribe_beam(JaxClip(s, 16000), max_new=8, beam=3)
    s2s = port._s2s
    assert s2s.start_sequence == SOT and s2s.dec is port.dec


def test_start_sequence_slots_and_sot_with(ifaces):
    port, ref = ifaces
    assert port.sot_template == ref.sot_template == [5, None, 102, 104]
    assert port.sot_sequence == ref.sot_sequence == SOT
    for lang, task in ((None, None), ("de", None), (None, "translate"),
                       ("en", "translate")):
        assert port.sot_with(lang, task) == ref.sot_with(lang, task)
    for bad in (("fr", None), (None, "summarize")):
        with pytest.raises(ValueError, match="not in this model"):
            port.sot_with(*bad)
        with pytest.raises(ValueError, match="not in this model"):
            ref.sot_with(*bad)


def test_a_mel_feed_is_never_padded_or_masked(ifaces):
    """The padding mask of ROADMAP C28 belongs to token encoders: a mel
    encoder takes no attention_mask, its feed goes through as given,
    and the decoder gets no cross_mask."""
    port, _ = ifaces
    s2s = Seq2SeqInterface(port.encoder, port.decoder, MAX_LEN,
                           start_sequence=SOT, eos_token=2,
                           encoder_feed="mel", device="cpu")
    assert s2s.masked is None and s2s.enc_len is None
    assert "cross_mask" not in s2s.cross_in
    mel = _mel(7)
    feeds = s2s._enc_feeds(mel)
    assert list(feeds) == ["mel"]
    np.testing.assert_array_equal(feeds["mel"], mel)
    np.testing.assert_array_equal(s2s._enc_feeds(mel[0])["mel"], mel)


def test_seq2seq_takes_a_mel_feed_and_a_start_sequence(ifaces):
    """Seq2SeqInterface with `encoder_feed="mel"` and a four-token
    `start_sequence` (the JAX constructor's arguments, restored): greedy
    tokens and beams equal the JAX interface's, and the greedy ones the
    STT device loop's up to its end of transcript."""
    from whisper_tensor_tpu.interfaces.seq2seq import (
        Seq2SeqInterface as JaxSeq2Seq)

    port, ref = ifaces
    mel = _mel(12)
    s2s = Seq2SeqInterface(port.encoder, port.decoder, MAX_LEN,
                           start_sequence=SOT, eos_token=2,
                           encoder_feed="mel", device="cpu", dec=port.dec)
    js2s = JaxSeq2Seq(ref.encoder, ref.decoder, MAX_LEN, start_sequence=SOT,
                      eos_token=2, encoder_feed="mel")
    greedy = s2s.generate_tokens(mel, 12)
    np.testing.assert_array_equal(greedy, js2s.generate_tokens(mel, 12))
    loop = port._transcribe_compiled(mel, 12)
    assert list(greedy[0, :len(loop)]) == loop
    np.testing.assert_array_equal(s2s.beam_search_tokens(mel, 6, beam=2),
                                  js2s.beam_search_tokens(mel, 6, beam=2))


@pytest.mark.parametrize("agreement", [None, 2])
def test_streaming_commits_equal_the_jax_packages(ifaces, agreement):
    port, ref = ifaces
    s = _clip(1.5 * WINDOW / 16000, 8)
    pst = stt.StreamingTranscriber(port, local_agreement=agreement,
                                   max_new_per_window=8)
    jst = jax_stt.StreamingTranscriber(ref, local_agreement=agreement,
                                       max_new_per_window=8)
    step = 8000
    for off in range(0, len(s), step):
        assert pst.feed(s[off:off + step]) == jst.feed(s[off:off + step])
        assert pst.pending == jst.pending
    assert pst.flush() == jst.flush()
    assert pst.committed == jst.committed and pst.committed
    if agreement is None:
        assert pst.committed == port.transcribe_long(AudioClip(s, 16000), 8)


# -- serving and the cli ------------------------------------------------------

def _servers(ckpt):
    psrv, jsrv = Server(device="cpu"), JaxServer()
    for srv in (psrv, jsrv):
        srv.models.run_loader("transformers", {"path": ckpt, "dtype": "f32",
                                               "max_len": MAX_LEN})
    return psrv, jsrv


def _multipart(fields, wav):
    bound = "wt-speech-boundary"
    out = b""
    for k, v in fields.items():
        out += (f"--{bound}\r\nContent-Disposition: form-data; "
                f'name="{k}"\r\n\r\n{v}\r\n').encode()
    out += (f"--{bound}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
            ).encode() + wav + f"\r\n--{bound}--\r\n".encode()
    return out, f"multipart/form-data; boundary={bound}"


def _post(port, path, body, ctype):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", path, body=body, headers={"Content-Type": ctype})
    r = c.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def test_audio_routes_answer_as_the_jax_servers(ckpt):
    s = _clip(1.0, 9)
    wav = wav_bytes(s, 16000)
    requests = [
        ("/v1/audio/transcriptions", *_multipart({"max_new_tokens": 6},
                                                 wav)),
        ("/v1/audio/transcriptions",
         *_multipart({"response_format": "text", "language": "de",
                      "max_new_tokens": 6}, wav)),
        ("/v1/audio/translations", *_multipart({"max_new_tokens": 6}, wav)),
        ("/v1/audio/transcriptions", json.dumps(
            {"audio_b64": base64.b64encode(wav).decode(),
             "max_new_tokens": 6}).encode(), "application/json"),
        ("/v1/audio/transcriptions", *_multipart({"language": "fr"}, wav)),
        ("/v1/audio/transcriptions", b"{}", "application/json")]
    answers = []
    for srv_cls, api_cls in ((Server, OpenAIApi), (JaxServer, JaxApi)):
        srv = srv_cls(device="cpu") if srv_cls is Server else srv_cls()
        srv.models.run_loader("transformers", {"path": ckpt, "dtype": "f32",
                                               "max_len": MAX_LEN})
        api = api_cls(srv, "127.0.0.1", 0).start()
        try:
            answers.append([_post(api.port, p, b, c)
                            for p, b, c in requests])
        finally:
            api.stop()
    assert answers[0] == answers[1]
    statuses = [a[0] for a in answers[0]]
    assert statuses == [200, 200, 200, 200, 400, 400]
    assert answers[0][1][1].startswith("text/plain")
    assert json.loads(answers[0][0][2])["text"]


def _job(srv, msg):
    assert srv._dispatch(msg) is None
    while True:
        r = srv.scheduler.reports.get(timeout=300)
        if r["type"] in ("job_result", "job_error"):
            assert r["type"] == "job_result", r
            return r["result"]


def test_websocket_replies_equal_the_jax_servers(ckpt):
    psrv, jsrv = _servers(ckpt)
    s = _clip(1.5 * WINDOW / 16000, 10)
    b64 = base64.b64encode(s.astype(np.float32).tobytes()).decode()
    replies = []
    for srv in (psrv, jsrv):
        mid = srv.models.list_models()[0]["id"]
        got = [_job(srv, {"type": "transcribe", "model_id": mid,
                          "samples_b64": b64, "max_new_tokens": 8}),
               _job(srv, {"type": "transcribe", "model_id": mid,
                          "samples_b64": b64, "max_new_tokens": 8,
                          "beam": 3, "language": "de"})]
        for i, off in enumerate(range(0, len(s), 12000)):
            chunk = base64.b64encode(s[off:off + 12000].tobytes()).decode()
            got.append(srv._dispatch({
                "type": "transcribe_stream", "model_id": mid,
                "stream_id": "a", "samples_b64": chunk,
                "max_new_tokens": 6, "local_agreement": 2}))
        got.append(srv._dispatch({"type": "transcribe_stream",
                                  "model_id": mid, "stream_id": "a",
                                  "final": True}))
        replies.append(got)
    assert replies[0] == replies[1]
    assert replies[0][-1]["final"] and replies[0][0]["text"]


def test_requests_with_a_task_or_a_language_share_the_decoder(
        ckpt, monkeypatch):
    """A translation, or a language, asks for another start sequence:
    the request's copy of the cached interface shares its fused decoder
    step (no second TextInferenceInterface, no second upload)."""
    from whisper_tensor_tpu_torch.interfaces.text import (
        TextInferenceInterface)

    built = []
    init = TextInferenceInterface.__init__

    def counted(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(TextInferenceInterface, "__init__", counted)
    psrv, _ = _servers(ckpt)
    mid = psrv.models.list_models()[0]["id"]
    b64 = base64.b64encode(_clip(1.0, 11).tobytes()).decode()
    for extra in ({"task": "translate"}, {"language": "de"},
                  {"language": "de", "beam": 2}):
        _job(psrv, {"type": "transcribe", "model_id": mid,
                    "samples_b64": b64, "max_new_tokens": 4, **extra})
    psrv._dispatch({"type": "transcribe_stream", "model_id": mid,
                    "stream_id": "t", "samples_b64": b64, "task": "translate",
                    "max_new_tokens": 4, "final": True})
    api = OpenAIApi(psrv, "127.0.0.1", 0).start()
    try:
        status, _, _ = _post(api.port, "/v1/audio/translations",
                             *_multipart({"max_new_tokens": 4},
                                         wav_bytes(_clip(1.0, 11), 16000)))
    finally:
        api.stop()
    assert status == 200
    cached = psrv._stt_iface(psrv.models.get(mid))
    assert len(built) == 1 and cached._dec is built[0]


@pytest.mark.parametrize("mode", [[], ["--beam", "3"], ["--stream", "0.5"]],
                         ids=["greedy", "beam", "stream"])
def test_cli_stt_prints_the_jax_clis_text(ckpt, tmp_path, capsys, mode):
    wav = str(tmp_path / "a.wav")
    with open(wav, "wb") as f:
        f.write(wav_bytes(_clip(2.5, 11), 16000))
    argv = ["stt", "--model", ckpt, "--audio", wav, "--max-tokens", "8",
            "-c", "dtype=f32", "-c", f"max_len={MAX_LEN}"] + mode
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    jax_cli.main(argv)
    want = capsys.readouterr().out
    assert got == want and got.strip()
