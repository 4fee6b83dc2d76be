"""Observability: structured operator/throughput metrics and tracing hooks.

SURVEY.md §5: the reference has no tracing, counters, or logging of any kind
(its only knob is the manual `opt` A/B switch). The rebuild logs operator
statistics (filter size, nnz, dedup ratio, table bytes) at build time and
provides a throughput meter reporting px/s and nnz/s against the analytic
roofline, plus a thin wrapper around jax.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import json
import logging
import subprocess
import time
from dataclasses import dataclass, field

logger = logging.getLogger("jincresize_tpu")


def log_operator_stats(op, label: str = "operator") -> dict:
    """Log (and return) the operator statistics dict (SURVEY C-metrics)."""
    st = op.stats()
    logger.info("%s stats: %s", label, json.dumps(st))
    return st


@dataclass
class ThroughputMeter:
    """Accumulates frame timings and reports px/s and nnz/s."""

    dst_pixels: int
    logical_nnz: int
    times_s: list = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.times_s.append(seconds)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0)

    def report(self) -> dict:
        if not self.times_s:
            return {}
        best = min(self.times_s)
        rep = {
            "frames": len(self.times_s),
            "best_s": best,
            "mean_s": sum(self.times_s) / len(self.times_s),
            "px_per_s": self.dst_pixels / best,
            "nnz_per_s": self.logical_nnz / best,
        }
        logger.info("throughput: %s", json.dumps(rep))
        return rep


def gpu_cards() -> list[str]:
    """``name, power.limit`` of each NVIDIA GPU, as nvidia-smi prints them.

    A card set below its power limit runs slower under load, so every time
    the benchmark and the smoke script print names the card beside it.
    Raises OSError or subprocess.SubprocessError when nvidia-smi is missing
    or fails.
    """
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return [ln.strip() for ln in r.stdout.strip().splitlines()]


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace scope (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
