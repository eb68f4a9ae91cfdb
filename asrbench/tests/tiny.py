"""Cells at sizes a CPU test can hold: the harness's own code on the CPU (the program runs its kernels' plain
versions there), with the cell's traffic kind, family and limits."""

from __future__ import annotations

import argparse
import time

from asrbench import core
from asrbench.families import quartznet

QUARTZNET = dict(repeat_blocks=1, repeat=2)
WAV2VEC2 = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=160,
                conv_dim=[32] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
SERVE = dict(lengths=dict(clips=24, median_s=1.5, sigma=0.5, min_s=0.5, max_s=3.0), max_batch_s=12, check_rows=4)
TRAIN = dict(batch=2, bucket_s=2, min_s=1.0, max_s=2.0, pool_batches=5, steps_per_execution=2, chars_per_s=5.0)


def ctx(cell: str, seed: int = 2**31 + 12345, seconds: int = 2, root=core.ROOT) -> core.Ctx:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=0)
    c = core.Ctx(args, time.perf_counter(), root=root)
    c.device = "cpu"
    c.config.update(QUARTZNET if c.config["family"] == "quartznet" else WAV2VEC2)
    c.params = dict(c.params, **(SERVE if c.workload["traffic"] == "serve_batch" else TRAIN))
    return c


def small_calibration(monkeypatch) -> None:
    monkeypatch.setattr(quartznet, "CALIBRATION_ROWS", 2)
    monkeypatch.setattr(quartznet, "CALIBRATION_SECONDS", 2)
