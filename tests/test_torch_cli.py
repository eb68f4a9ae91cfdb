"""The port's CLI (``python -m thunder_tpu_torch``) against the JAX package's (CPU).

Both CLIs run in this process on ``tests/fixtures/tiny_quartznet.nemo``; the port's with ``--device cpu``.
Each ``transcribe`` prints the same JSON records as the JAX CLI: greedy (module and ``--engine``), the host and
the device beam, the long-clip path past ``--chunk-seconds`` (greedy and both beams), ``--timestamps`` (tokens
and their spans rounded to milliseconds) and the LM flags (``--hotword``, ``--word-score``,
``--lm-transcripts``, ``--arpa``). ``eval`` prints the JAX CLI's utterances, audio seconds, WER and CER (its
``rtf`` is a clock reading); ``train`` runs an epoch; ``export`` writes a bundle that serves the fixture's
transcripts, and with ``--aot`` also ``predict.pt2``, whose ``aot_load`` serves the bundle's predictions. A run
without a card and without ``--device cpu`` exits with its error.
"""

import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from thunder_tpu.__main__ import main as jax_main
from thunder_tpu_torch.__main__ import main

torch.set_num_threads(2)

FIXTURE = str(Path(__file__).parent / "fixtures" / "tiny_quartznet.nemo")
CPU = ["--device", "cpu"]


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A 0.75 s tone (``tests/test_cli.py``'s clip) and 1.2 s of noise."""
    tmp = tmp_path_factory.mktemp("clips")
    t = np.arange(12000) / 16000.0
    tone = _write_wav(tmp / "tone.wav", 0.3 * np.sin(2 * np.pi * 440 * t))
    noise = _write_wav(tmp / "noise.wav", np.random.default_rng(0).standard_normal(19200) * 0.2)
    return [tone, noise]


def _records(fn, argv, capsys):
    fn(argv)
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines() if line.startswith("{")]


def _both(argv, capsys):
    return _records(main, argv + CPU, capsys), _records(jax_main, argv, capsys)


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    transcripts = tmp / "lines.txt"
    transcripts.write_text("the cat sat\na cat ran\nthe dog sat on the mat\n")
    arpa = tmp / "words.arpa"
    arpa.write_text("\\data\\\nngram 1=4\nngram 2=2\n\n\\1-grams:\n-0.5 the -0.2\n-0.8 cat -0.1\n-1.0 dog\n"
                    "-2.0 <unk>\n\n\\2-grams:\n-0.2 the cat\n-0.4 the dog\n\n\\end\\\n")
    return {"transcripts": str(transcripts), "arpa": str(arpa)}


@pytest.mark.parametrize("flags", [
    [],
    ["--engine"],
    ["--beam-width", "4"],
    ["--beam-width", "4", "--beam-backend", "device"],
    ["--chunk-seconds", "0.3"],
    ["--chunk-seconds", "0.3", "--beam-width", "4"],
    ["--chunk-seconds", "0.3", "--beam-width", "4", "--beam-backend", "device"],
    ["--timestamps"],
    ["--timestamps", "--chunk-seconds", "1.0"],
], ids=["greedy", "engine", "beam", "device_beam", "long", "long_beam", "long_device_beam",
        "timestamps", "timestamps_long_skipped"])
def test_transcribe_matches_jax(clips, flags, capsys):
    got, want = _both(["transcribe", "--checkpoint", FIXTURE, *flags, *clips], capsys)
    assert got == want and len(got) == len(clips)
    if "--timestamps" in flags and "--chunk-seconds" not in flags:
        assert all("tokens" in r for r in got if r["text"])


@pytest.mark.parametrize("lm_flags", [
    ["--hotword", "cat:3"],
    ["--lm-transcripts", "{transcripts}", "--lm-order", "2", "--word-score", "-0.5", "--lm-weight", "0.7"],
    ["--arpa", "{arpa}", "--beam-backend", "device"],
], ids=["hotword", "lm_transcripts", "arpa_device"])
def test_transcribe_lm_flags_match_jax(clips, lm_files, lm_flags, capsys):
    flags = [f.format(**lm_files) for f in lm_flags]
    got, want = _both(["transcribe", "--checkpoint", FIXTURE, *flags, *clips], capsys)
    assert got == want


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("manifest")
    t = np.arange(8000) / 16000.0
    entries = []
    for i in range(3):
        path = _write_wav(tmp / f"e{i}.wav", 0.3 * np.sin(2 * np.pi * (300 + 100 * i) * t))
        entries.append({"audio_filepath": path, "duration": 0.5, "text": "tu ta"})
    man = tmp / "eval.json"
    man.write_text("\n".join(json.dumps(e) for e in entries))
    return str(man)


@pytest.mark.parametrize("flags", [["--engine"], ["--hotword", "tu:3"]], ids=["engine", "hotword"])
def test_eval_matches_jax(manifest, flags, capsys):
    argv = ["eval", "--checkpoint", FIXTURE, "--manifest", manifest, "--batch-size", "2", "--num-workers", "0",
            *flags]
    (got,), (want,) = _both(argv, capsys)
    assert got.pop("rtf") > 0 and want.pop("rtf") > 0
    assert got == want and got["utterances"] == 3 and got["audio_seconds"] == pytest.approx(1.5, abs=0.01)


def test_train_runs_an_epoch(manifest, tmp_path, capsys):
    main(["train", "--checkpoint", FIXTURE, "--train-manifest", manifest, "--epochs", "1", "--batch-size", "2",
          "--num-workers", "2", "--log-every", "1", "--checkpoint-dir", str(tmp_path / "ckpt"), *CPU])
    assert "loss/train_loss" in capsys.readouterr().err  # ConsoleLogger writes to stderr
    assert any((tmp_path / "ckpt").iterdir())


def test_export_writes_a_bundle_that_serves_the_fixture(clips, tmp_path, capsys):
    from thunder_tpu_torch import load_inference_bundle, load_pretrained

    main(["export", "--checkpoint", FIXTURE, "--output", str(tmp_path / "bundle"), *CPU])
    assert "bundle:" in capsys.readouterr().out
    restored, source = load_inference_bundle(str(tmp_path / "bundle"), device="cpu"), load_pretrained(FIXTURE,
                                                                                                      device="cpu")
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    assert torch.equal(restored.forward(audio, [16000, 9000])[0], source.forward(audio, [16000, 9000])[0])


def test_export_aot_writes_a_predict_graph_that_serves_the_fixture(tmp_path, capsys):
    from thunder_tpu_torch import load_inference_bundle
    from thunder_tpu_torch.export import aot_load

    bundle = tmp_path / "bundle"
    main(["export", "--checkpoint", FIXTURE, "--output", str(bundle), "--aot", "--batch-size", "2", "--seconds", "1",
          *CPU])
    out = capsys.readouterr().out
    assert f"aot: {bundle}/predict.pt2" in out and (bundle / "predict.pt2").exists() and (bundle / "config.json").exists()
    audio = (np.random.default_rng(1).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    preds, out_lengths = aot_load(str(bundle / "predict.pt2")).call(audio, lengths)
    _, want, want_lengths = load_inference_bundle(str(bundle), device="cpu").infer(audio, lengths)
    assert torch.equal(preds, want) and torch.equal(out_lengths, want_lengths)


def test_no_card_and_no_device_cpu_refuses(clips, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        main(["transcribe", "--checkpoint", FIXTURE, clips[0]])


def test_beam_backend_requires_beam_width(clips):
    with pytest.raises(SystemExit, match="beam-width"):
        main(["transcribe", "--checkpoint", FIXTURE, "--beam-backend", "device", clips[0], *CPU])
