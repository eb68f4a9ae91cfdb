"""The harness on the CPU: it finds new files by name, imports nothing of JAX, and a run whose timed path is
broken underneath comes out not correct."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from asrbench import core
from asrbench.tests import tiny

FORBIDDEN = ("jax", "jaxlib", "flax", "thunder_tpu")


def _fresh(code: str, cwd=core.ROOT) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(cwd), str(core.ROOT)]))  # a copy's asrbench first
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_the_harness_imports_no_jax():
    out = _fresh("""
        import sys
        import asrbench.core, asrbench.trace, asrbench.compare
        import asrbench.traffic.serve_batch, asrbench.traffic.train, asrbench.checks.limits
        import asrbench.families.quartznet, asrbench.families.wav2vec2
        import asrbench.readers.roofline, asrbench.readers.mfu, asrbench.readers.idle_share
        print(sorted({n.split('.')[0] for n in sys.modules}))
    """)
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert not loaded & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    out = _fresh("""
        import sys
        import asrbench.reference.frontend, asrbench.reference.quartznet, asrbench.reference.wav2vec2
        import asrbench.reference.train, asrbench.work.dropout_hash, asrbench.work.flops, asrbench.work.bounds
        print(sorted({n.split('.')[0] for n in sys.modules}))
    """)
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert not loaded & {*FORBIDDEN, "thunder_tpu_torch"}


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "asrbench/run.py", "--workload", "quartznet15x5.serve", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a cell and a metric added as files (and entries of BENCHMARK.json) run with no edit of
    the harness."""
    shutil.copytree(core.BENCH, tmp_path / "asrbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((core.BENCH / "configs" / "quartznet15x5.json").read_text())
    (tmp_path / "asrbench" / "configs" / "quartznet15x5-copy.json").write_text(json.dumps(cfg))
    wl = json.loads((core.BENCH / "workloads" / "quartznet15x5.serve.json").read_text())
    wl["config"] = "quartznet15x5-copy"
    (tmp_path / "asrbench" / "workloads" / "quartznet15x5-copy.serve.json").write_text(json.dumps(wl))
    (tmp_path / "asrbench" / "metrics" / "audio_per_call_s.json").write_text(
        json.dumps({"reader": "window_rate", "quantity": "audio_s"}))
    bench["configs"].append({**bench["configs"][0], "name": "quartznet15x5-copy",
                             "file": "asrbench/configs/quartznet15x5-copy.json"})
    bench["workloads"].append({**bench["workloads"][0], "name": "quartznet15x5-copy.serve",
                               "config": "quartznet15x5-copy"})
    bench["end_to_end"].append({"name": "audio_per_call_s", "unit": "audio_s/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["quartznet15x5-copy.serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _fresh("""
        import json
        from pathlib import Path
        from asrbench import core
        from asrbench.families import quartznet
        from asrbench.tests import tiny
        assert core.BENCH == Path.cwd() / "asrbench"
        quartznet.CALIBRATION_ROWS, quartznet.CALIBRATION_SECONDS = 2, 2
        ctx = tiny.ctx("quartznet15x5-copy.serve", seconds=1, root=Path.cwd())
        print(json.dumps(core.run_cell(ctx)))
    """, cwd=tmp_path)
    result = json.loads(out.strip().splitlines()[-1])
    assert {"audio_per_call_s", "setup_s"} <= set(result["metrics"])


def _serve_result(monkeypatch, cell="quartznet15x5.serve"):
    tiny.small_calibration(monkeypatch)
    return core.run_cell(tiny.ctx(cell, seconds=3))


def test_a_sound_serving_run_is_correct(monkeypatch):
    result = _serve_result(monkeypatch)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from thunder_tpu_torch.engine import InferenceEngine

    decode = InferenceEngine._decode

    def altered(self, x):
        logits, preds = decode(self, x)
        preds = preds.clone()
        preds[:, 0] = logits[:, 0].argmin(-1)  # the first frame of every row gets its worst token
        return logits, preds

    monkeypatch.setattr(InferenceEngine, "_decode", altered)
    result = _serve_result(monkeypatch)
    assert not result["correct"] and result["checks"]["widest_gap"]["value"] > result["checks"]["widest_gap"]["limit"]


def test_an_answer_altered_after_its_tokens_fails(monkeypatch):
    import thunder_tpu_torch.module as module

    decode = module.decode_greedy
    monkeypatch.setattr(module, "decode_greedy", lambda tt, preds, n: [t + "x" for t in decode(tt, preds, n)])
    result = _serve_result(monkeypatch)
    assert not result["correct"] and result["checks"]["texts_not_their_tokens"]["value"] > 0


def _train_result(monkeypatch, cell):
    tiny.small_calibration(monkeypatch)
    return core.run_cell(tiny.ctx(cell))


@pytest.mark.parametrize("cell", ["wav2vec2-base-960h.finetune", "quartznet15x5.train"])
def test_a_sound_training_run_is_correct(monkeypatch, cell):
    result = _train_result(monkeypatch, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["wav2vec2-base-960h.finetune", "quartznet15x5.train"])
def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch, cell):
    import thunder_tpu_torch.training.trainer as trainer

    monkeypatch.setattr(trainer, "apply_update", lambda *args, **kwargs: None)
    result = _train_result(monkeypatch, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["wav2vec2-base-960h.finetune", "quartznet15x5.train"])
def test_half_the_batch_left_out_fails(monkeypatch, cell):
    import thunder_tpu_torch.training.trainer as trainer

    ctc = trainer.calculate_ctc

    def half(logits, targets, logit_lengths, target_lengths, blank, sample_weights=None):
        h = logits.shape[0] // 2
        return ctc(logits[:h], targets[:h], logit_lengths[:h], target_lengths[:h], blank)

    monkeypatch.setattr(trainer, "calculate_ctc", half)
    result = _train_result(monkeypatch, cell)
    assert not result["correct"], result["checks"]
