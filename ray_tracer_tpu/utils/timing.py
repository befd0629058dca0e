"""Timing, throughput reporting and profiling hooks.

The reference's only instrumentation is a pair of cudaEvent_t spans
printed to stdout (Parallel/raytracer.cu:549-556, 697-706).  Here:
device-fenced wall-clock timers, a Mrays/s reporter (the BASELINE.md
primary metric), and a jax.profiler trace context for per-stage
inspection in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import jax


@dataclass
class Timer:
    """Wall-clock spans fenced by block_until_ready."""

    spans: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, result=None):
        start = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - start


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-clock seconds of fn(*args), each call ended by
    jax.block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def measure_mrays(
    fn: Callable,
    *args,
    rays_per_call: float,
    warmup: int = 1,
    iters: int = 3,
) -> Dict[str, float]:
    """Primary benchmark reporter: Mrays/s (primary+shadow counted by the
    caller via rays_per_call) and per-chip normalization."""
    sec = time_fn(fn, *args, warmup=warmup, iters=iters)
    n_dev = jax.device_count()
    mrays = rays_per_call / sec / 1e6
    return {
        "seconds": sec,
        "mrays_per_s": mrays,
        "mrays_per_s_per_chip": mrays / n_dev,
        "devices": n_dev,
    }


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """jax.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield
