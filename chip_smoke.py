"""Smoke run of the PyTorch/CUDA port (``thunder_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a Hopper card (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
2. build the CUDA kernels from ``thunder_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card
   (``thunder_tpu_torch.kernels.selftest``), one JSON line per check;
4. QuartzNet15x5 greedy serving through ``CTCModule.create`` and
   ``InferenceEngine.predict`` at 64 rows x 15 s of speech-like audio, with
   random weights (seed 0) and random BN statistics: the launch counts of
   one forward must be 1 log-mel and 77 separable repeats; rows 0-1 are held
   against the port's float32 CPU path (bf16-vs-f32 bound 0.1 of the logits'
   scale); RTF = audio seconds per second of device time; one forward under
   torch.profiler gives the device time by kernel and the device's idle
   share between the forward's first and last device event;
5. each kernel's time and its plain version's at the main path's shapes.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

VOCAB = list("abcdefghijklmnopqrstuvwxyz '")
BATCH, SECONDS, SAMPLE_RATE = 64, 15.0, 16000
LOGIT_BOUND = 0.1  # max|bf16 card - f32 CPU| / max|f32 CPU| over valid frames


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def speech_like(samples: int, rng: np.random.Generator) -> np.ndarray:
    """A speech-like harmonic series with pitch and amplitude modulation plus noise."""
    t = np.arange(samples) / SAMPLE_RATE
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)  # pitch contour
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t))  # syllable-rate AM
    return (0.15 * envelope * voiced + 0.01 * rng.standard_normal(samples)).astype(np.float32)


def randomize_bn(module, seed: int = 0) -> None:
    """Non-trivial BN statistics and affines, so that BN folding is exercised."""
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.model.state_dict().items():
            if name.endswith(".var"):
                t.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, t.shape).astype(np.float32)))
            elif name.endswith((".mean", ".bn.scale", ".bn.bias")):
                t.copy_(torch.as_tensor((rng.standard_normal(t.shape) * 0.3).astype(np.float32)))


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int) -> tuple[float, float]:
    """Kernel and plain times taken in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = cuda_ms(plain, iters), cuda_ms(kernel, iters), cuda_ms(kernel, iters), cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_profile(fn) -> dict:
    """Device activity of one call of ``fn`` under torch.profiler: busy and idle
    time between its first and last device event, and the top kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return {"device_events": 0, "idle_share": "not measured"}
    span_us = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name: dict = {}
    for e in events:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "device_events": len(events),
        "span_ms": span_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / span_us),
        "top": [{"name": n[:80], "ms": t / 1e3, "calls": c} for n, (t, c) in top],
    }


def gpu_line() -> str:
    cmd = ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device", file=sys.stderr)
        return 1

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import _build, reset_launch_counts
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference
    from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, exact_float32, run_selftests, ulp_bf16_error
    from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat, separable_repeat_reference
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    card = gpu_line()
    print(card, flush=True)
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    exact_float32()

    # ---- build
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": _build.library_path().name})

    # ---- kernel checks
    checks = run_selftests()
    for r in checks:
        emit({"kernel_check": r})
    bad = [r["name"] for r in checks if not r["ok"]]
    if bad:
        print(f"chip_smoke: kernel checks failed: {bad}", file=sys.stderr)
        return 1

    # ---- main path: QuartzNet15x5 greedy serving at B=64 x 15 s
    tt = BatchTextTransformer(VOCAB)
    module = CTCModule.create(
        torch.Generator().manual_seed(0),
        FilterbankFeatures(),
        QuartznetEncoder(repeat_blocks=3),
        Conv1dDecoder(29),
        tt,
        device="cuda",
    )
    randomize_bn(module)
    engine = InferenceEngine(module)
    rng = np.random.default_rng(0)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)])
    lengths = np.full((BATCH,), samples, dtype=np.int32)
    engine.warmup([BATCH], [SECONDS])

    reset_launch_counts()
    texts = engine.predict(audio, lengths)
    launches = {"log_mel": fused_log_mel.launches, "separable_repeat": fused_separable_repeat.launches}
    emit({"phase": "launches_per_forward", **launches})
    if launches != {"log_mel": 1, "separable_repeat": 77}:
        print(f"chip_smoke: expected 1 log-mel and 77 separable launches, got {launches}", file=sys.stderr)
        return 1
    if len(texts) != BATCH or not all(isinstance(t, str) and set(t) <= set(VOCAB) for t in texts):
        print(f"chip_smoke: transcripts outside the vocabulary: {texts[:4]}", file=sys.stderr)
        return 1

    audio_d = torch.as_tensor(audio, device="cuda")
    lengths_d = torch.as_tensor(lengths, device="cuda")
    logits, preds, out_lengths = engine.infer(audio_d, lengths_d)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 751, len(VOCAB) + 1):
        print(f"chip_smoke: logits not finite or of shape {tuple(logits.shape)}", file=sys.stderr)
        return 1

    iters = 10
    forward_ms = cuda_ms(lambda: engine.infer(audio_d, lengths_d), iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(audio, lengths)
    predict_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "serving", "batch": BATCH, "seconds": SECONDS, "forward_ms": forward_ms,
          "rtf": BATCH * SECONDS / (forward_ms / 1e3), "predict_ms_host_clock": predict_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    emit({"phase": "profile", **device_profile(lambda: engine.infer(audio_d, lengths_d))})

    # rows 0-1 through the port's float32 CPU path (plain versions of both kernels)
    torch.set_num_threads(8)
    t0 = time.perf_counter()
    ref_logits, ref_lengths = InferenceEngine(module.to("cpu"))(audio[:2], lengths[:2])
    cpu_seconds = time.perf_counter() - t0
    if not torch.equal(ref_lengths, out_lengths[:2].cpu()):
        print(f"chip_smoke: lengths differ from the CPU path: {ref_lengths} vs {out_lengths[:2]}", file=sys.stderr)
        return 1
    got = logits[:2].float().cpu()
    valid = torch.arange(got.shape[1])[None, :] < ref_lengths[:, None]
    rel = ((got - ref_logits).abs()[valid].max() / ref_logits.abs()[valid].max()).item()
    agree = (got.argmax(-1) == ref_logits.argmax(-1))[valid].float().mean().item()
    emit({"phase": "vs_cpu_f32", "rows": 2, "max_rel_dev": rel, "bound": LOGIT_BOUND, "argmax_agreement": agree,
          "cpu_seconds": cpu_seconds})
    if not rel < LOGIT_BOUND:
        print(f"chip_smoke: bf16 card vs f32 CPU deviation {rel} >= {LOGIT_BOUND}", file=sys.stderr)
        return 1

    # ---- each kernel against its plain version at the main path's shapes
    kernels = []
    k_ms, p_ms = paired_ms(lambda: fused_log_mel(audio_d), lambda: log_mel_reference(audio_d), 20)
    err = (fused_log_mel(audio_d) - log_mel_reference(audio_d)).abs().max().item()
    log_mel_tol = KERNEL_CHECKS["frontend_log_mel"][1]
    if not err <= log_mel_tol:
        print(f"chip_smoke: log-mel at the main path's shape off by {err} > {log_mel_tol}", file=sys.stderr)
        return 1
    kernels.append({"name": "log_mel", "route": "cuda", "source": "thunder_tpu_torch/csrc/log_mel.cu",
                    "replaces": "thunder_tpu/kernels/frontend_pallas.py:105", "launches": launches["log_mel"],
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms})

    feats, feat_lengths = engine.frontend(audio_d, lengths_d)
    shapes = {}
    t_in, c_in = feats.shape[1], feats.shape[2]
    for block in engine._plan:
        for rp in block.repeats:
            if rp.kind == "separable":
                key = (t_in, c_in, rp.pw.shape[1], rp.kernel_size, rp.stride, rp.dilation)
                shapes.setdefault(key, [rp, 0])[1] += 1
            c_in = rp.pw.shape[1]
            t_in = -(-t_in // rp.stride)
    total_k = total_p = max_err = max_ulp = 0.0
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (t, c, co, k, s, d), (rp, count) in shapes.items():
        x = torch.randn((BATCH, t, c), device="cuda", generator=gen).to(torch.bfloat16)
        t_out = -(-t // s)
        out_len = torch.full((BATCH,), t_out, dtype=torch.int32, device="cuda")
        args = (x, out_len, rp.dw, rp.pw, rp.bias, k)
        kw = dict(stride=s, dilation=d, relu=rp.relu)
        got, want = fused_separable_repeat(*args, **kw), separable_repeat_reference(*args, **kw)
        e_abs = (got.float() - want.float()).abs().max().item()
        e_ulp = ulp_bf16_error(got, want)
        km, pm = paired_ms(lambda: fused_separable_repeat(*args, **kw), lambda: separable_repeat_reference(*args, **kw), 10)
        emit({"separable_shape": {"t_in": t, "c_in": c, "c_out": co, "k": k, "stride": s, "dilation": d,
                                  "count": count, "ms": km, "plain_ms": pm, "max_abs_err": e_abs, "ulp": e_ulp}})
        total_k, total_p = total_k + count * km, total_p + count * pm
        max_err, max_ulp = max(max_err, e_abs), max(max_ulp, e_ulp)
        if e_ulp > 8.0:
            print(f"chip_smoke: separable repeat at {(t, c, co, k, s, d)} off by {e_ulp} bf16 ULP", file=sys.stderr)
            return 1
    kernels.append({"name": "separable_repeat", "route": "cuda", "source": "thunder_tpu_torch/csrc/separable_repeat.cu",
                    "replaces": "thunder_tpu/kernels/separable_conv.py:56",
                    "also_replaces": "thunder_tpu/kernels/repeat_tm.py:162",
                    "launches": launches["separable_repeat"], "max_abs_err": max_err, "max_ulp": max_ulp,
                    "ms": total_k, "plain_ms": total_p, "ms_is": "sum over the 77 launches of one forward"})

    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
