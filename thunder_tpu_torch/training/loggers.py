"""Pluggable metric loggers for the Trainer.

Port of ``thunder_tpu/training/loggers.py``: loggers are plain callables
receiving metric dicts; compose them with ``MultiLogger``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["JsonlLogger", "ConsoleLogger", "MultiLogger"]


class JsonlLogger:
    """Append one JSON line per metric dict (with a wall-clock timestamp)."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, metrics: Dict[str, float]):
        entry = {"time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")


class ConsoleLogger:
    """Single-line human-readable metric prints."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def __call__(self, metrics: Dict[str, float]):
        parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()]
        print("  ".join(parts), file=self.stream)


class MultiLogger:
    def __init__(self, loggers: Iterable):
        self.loggers = list(loggers)

    def __call__(self, metrics: Dict[str, float]):
        for logger in self.loggers:
            logger(metrics)
