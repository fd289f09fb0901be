"""Text-to-speech and phonemization on the port, against the JAX package,
on the CPU.

The synthetic piper, kokoro and F5-TTS sets of tests/test_tts_loaders.py
(the port's copies of its builders, tests/torch_tts_sets.py, which write
the same bytes) keep the engines' real I/O contracts at a tiny size.

* The loaders give the JAX package's bundles (specs, voices), and `auto`
  picks them.
* Each engine's samples within 1e-5 of the JAX package's (both kokoro
  voices); F5's ODE on the device equals its per-step referee.
* `cli tts` writes the JAX cli's WAV (header and samples); the
  `/v1/audio/speech` route (WAV, s16le PCM, a named kokoro voice) and
  the WebSocket `generate_speech` answer as the JAX server does.
* `phonemization`: the port's copy gives the JAX module's IPA and ids on
  the sentences of tests/test_phonemization.py; `WT_PHONEMIZER=auto`
  takes the builtin rules where espeak-ng is missing.
"""

import base64
import io
import json
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tests import torch_tts_sets as sets  # noqa: E402
from whisper_tensor_tpu import cli as jax_cli  # noqa: E402
from whisper_tensor_tpu import phonemization as jax_ph  # noqa: E402
from whisper_tensor_tpu.importers.loaders import (  # noqa: E402
    identify_and_load as jax_load)
from whisper_tensor_tpu.interfaces import tts as jax_tts  # noqa: E402
from whisper_tensor_tpu.server.main import Server as JaxServer  # noqa: E402
from whisper_tensor_tpu.server.openai_api import (  # noqa: E402
    OpenAIApi as JaxApi)
from whisper_tensor_tpu.super_graph.links import (  # noqa: E402
    AudioClip as JaxClip)
from whisper_tensor_tpu_torch import cli  # noqa: E402
from whisper_tensor_tpu_torch import phonemization as ph  # noqa: E402
from whisper_tensor_tpu_torch.importers.loaders import (  # noqa: E402
    identify_and_load)
from whisper_tensor_tpu_torch.interfaces import tts  # noqa: E402
from whisper_tensor_tpu_torch.server.main import Server  # noqa: E402
from whisper_tensor_tpu_torch.server.openai_api import OpenAIApi  # noqa: E402
from whisper_tensor_tpu_torch.super_graph.links import AudioClip  # noqa: E402
from whisper_tensor_tpu_torch.utils.audio import write_wav  # noqa: E402

TEXT = "tab up at a pub"
REF = np.sin(np.linspace(0, 20, 400)).astype(np.float32)
SENTENCES = ["the", "one two three", "through enough",
             "they were with you", "city cat gem gap make time hope cube",
             "knee write nation night sight sing lights working",
             "i have 3 cats and 105 dogs in 2026", "hello, world!",
             "A quick brown fox; 42 jumps?"]


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts")
    out = {}
    for name, write in (("piper", sets.write_piper_voice),
                        ("kokoro", sets.write_kokoro_dir),
                        ("f5", sets.write_f5_dir)):
        d = root / name
        d.mkdir()
        write(str(d))
        out[name] = str(d)
    return out


def _synth(iface, text, voice=0):
    if isinstance(iface, (tts.F5Synthesizer, jax_tts.F5Synthesizer)):
        clip_cls = AudioClip if isinstance(iface, tts.F5Synthesizer) \
            else JaxClip
        return iface.run_text_to_audio(text, ref_audio=clip_cls(REF, 24000))
    return iface.run_text_to_audio(text, voice=voice)


@pytest.mark.parametrize("engine", ["piper", "kokoro", "f5"])
def test_loaders_give_the_jax_packages_bundles(voices, engine):
    pb, jb = identify_and_load(voices[engine]), jax_load(voices[engine])
    assert pb.interfaces == jb.interfaces
    assert pb.meta.get("architecture") == jb.meta.get("architecture")
    pv, jv = (b.meta.get("voice_embeddings") or {} for b in (pb, jb))
    assert sorted(pv) == sorted(jv)
    for k in jv:
        np.testing.assert_array_equal(pv[k], jv[k])


@pytest.mark.parametrize("engine,voice", [("piper", 0), ("kokoro", 0),
                                          ("kokoro", 1), ("f5", 0)])
def test_samples_equal_the_jax_packages(voices, engine, voice):
    port = tts.TextToSpeechInterface.from_bundle(
        identify_and_load(voices[engine]), device="cpu")
    ref = jax_tts.TextToSpeechInterface.from_bundle(jax_load(voices[engine]))
    got, want = _synth(port, TEXT, voice), _synth(ref, TEXT, voice)
    assert got.sample_rate == want.sample_rate
    assert got.samples.shape == want.samples.shape and got.samples.size
    np.testing.assert_allclose(got.samples, want.samples, rtol=0, atol=1e-5)


def test_f5_ode_on_the_device_equals_the_per_step_referee(voices):
    f5 = tts.TextToSpeechInterface.from_bundle(identify_and_load(
        voices["f5"]), device="cpu")
    pre = f5.prepare("hello", AudioClip(REF, 24000))
    progress = []

    class Obs:
        def on_progress(self, node, f):
            progress.append(f)

    got = f5.ode(pre, Obs()).numpy()
    np.testing.assert_allclose(got, f5.ode_plain(pre), rtol=0, atol=1e-6)
    assert len(progress) == f5.nfe_steps == 32 and progress[-1] == 1.0
    assert not np.allclose(got, pre["noise"].numpy())
    with pytest.raises(ValueError, match="reference"):
        f5.run_text_to_audio("hello")


def _wav(path):
    with wave.open(path, "rb") as w:
        return w.getparams(), np.frombuffer(w.readframes(w.getnframes()),
                                            "<i2").astype(np.int32)


@pytest.mark.parametrize("engine,extra", [
    ("piper", []), ("kokoro", ["--voice", "am_adam"]), ("f5", ["ref"])])
def test_cli_tts_writes_the_jax_clis_wav(voices, tmp_path, capsys, engine,
                                         extra):
    if extra == ["ref"]:
        ref = str(tmp_path / "ref.wav")
        write_wav(ref, REF, 24000)
        extra = ["--ref-audio", ref]
    outs = []
    for main, tail in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        out = str(tmp_path / f"{len(outs)}.wav")
        main(["tts", "--model", voices[engine], "--text", TEXT,
              "--output", out] + extra + tail)
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs.append((rep["samples"], rep["sample_rate"], _wav(out)))
    (n, sr, (pp, ps)), (jn, jsr, (jp, js)) = outs
    assert (n, sr, pp) == (jn, jsr, jp) and n > 0
    assert np.abs(ps - js).max() <= 1        # one step of 16-bit rounding


def _post(port, body):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("POST", "/v1/audio/speech", body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, r.getheader("Content-Type"), \
        r.getheader("X-Sample-Rate"), r.read()


def _pcm(ctype, data):
    if ctype == "audio/wav":
        with wave.open(io.BytesIO(data), "rb") as w:
            return w.getparams(), np.frombuffer(
                w.readframes(w.getnframes()), "<i2").astype(np.int32)
    if ctype == "audio/pcm":
        return None, np.frombuffer(data, "<i2").astype(np.int32)
    return data, None


def test_speech_route_and_message_answer_as_the_jax_servers(voices):
    reqs = [("piper", {"input": TEXT}),
            ("piper", {"input": TEXT, "response_format": "pcm"}),
            ("kokoro", {"input": TEXT, "voice": "am_adam"}),
            ("kokoro", {"input": TEXT, "voice": "nobody"}),
            ("piper", {"input": ""}),
            ("piper", {"input": TEXT, "response_format": "mp3"})]
    answers = []
    for srv_cls, api_cls in ((Server, OpenAIApi), (JaxServer, JaxApi)):
        srv = srv_cls(device="cpu") if srv_cls is Server else srv_cls()
        ids = {}
        for name in ("piper", "kokoro"):
            (e,) = srv.models.run_loader("auto", {"path": voices[name]})
            ids[name] = e.id
        api = api_cls(srv, "127.0.0.1", 0).start()
        try:
            got = [_post(api.port, dict(b, model=str(ids[n])))
                   for n, b in reqs]
        finally:
            api.stop()
        assert srv._dispatch({"type": "generate_speech", "text": TEXT,
                              "model_id": ids["kokoro"], "voice": 1}) is None
        while True:
            r = srv.scheduler.reports.get(timeout=120)
            if r["type"] in ("job_result", "job_error"):
                break
        assert r["type"] == "job_result", r
        got.append(("ws", "audio/wav", r["result"]["sample_rate"],
                    base64.b64decode(r["result"]["wav_b64"])))
        answers.append(got)
    for (ps, pc, pr, pd), (js, jc, jr, jd) in zip(*answers):
        assert (ps, pc, pr) == (js, jc, jr)
        (pm, pa), (jm, ja) = _pcm(pc, pd), _pcm(jc, jd)
        assert pm == jm
        if pa is not None:
            assert pa.shape == ja.shape and np.abs(pa - ja).max() <= 1
    assert [a[0] for a in answers[0]] == [200, 200, 200, 200, 400, 400, "ws"]


@pytest.mark.parametrize("text", SENTENCES)
def test_phonemization_equals_the_jax_modules(text, monkeypatch):
    monkeypatch.setenv("WT_PHONEMIZER", "builtin")
    ipa = ph.phonemize(text)
    assert ipa == jax_ph.phonemize(text) == ph._builtin_phonemize(text)
    pmap = {c: [i + 3] for i, c in enumerate(sorted(set(ipa)))}
    pmap.update({"^": [1], "$": [2], "_": [0]})
    vocab = {c: i for i, c in enumerate(sorted(set(ipa)))}
    assert ph.piper_phoneme_ids(ipa, pmap) == \
        jax_ph.piper_phoneme_ids(ipa, pmap)
    assert ph.kokoro_phoneme_ids(ipa, vocab) == \
        jax_ph.kokoro_phoneme_ids(ipa, vocab)
    for tok in text.split():
        if tok.isdigit():
            assert ph._expand_number(tok) == jax_ph._expand_number(tok)


def test_auto_phonemizer_takes_the_builtin_rules_without_espeak(monkeypatch):
    import shutil

    monkeypatch.setenv("WT_PHONEMIZER", "auto")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert ph.phonemize("they were with you") == "ðeɪ wɚ wɪθ juː"


def test_a_tts_iface_runs_its_model_on_its_device(voices):
    """Feeds are made on the host; the model runs through
    EvalBackend.run_on_device (a torch tensor comes back)."""
    iface = tts.TextToSpeechInterface.from_bundle(
        identify_and_load(voices["piper"]), device="cpu")
    out = iface._backend.run_on_device(iface.model.graph,
                                       iface.feeds(TEXT))
    assert isinstance(out["output"], torch.Tensor)
    assert out["output"].device.type == "cpu"
