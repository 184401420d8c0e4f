"""Solver profiling: the dyn/IK/total solve-time triptych + device tracing.

JAX twin of the reference's profiling hooks (reference
src/motion_planner/kino_dyn.cpp:66-79 ``compute_solve_times`` and
examples/analysis/solve_times_test.py:66-118): named wall-clock phases plus
``jax.profiler`` trace capture for per-kernel inspection on device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class SolveTimer:
    """Accumulates named phase durations; mirrors the reference's
    dyn/kin/total breakdown. Use ``block=True`` phases around device work so
    async dispatch doesn't hide the cost."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            self.times[name].append(time.perf_counter() - t0)

    def summary(self):
        return {
            k: {
                "mean": sum(v) / len(v),
                "min": min(v),
                "max": max(v),
                "count": len(v),
            }
            for k, v in self.times.items()
        }

    def report(self):
        lines = []
        for k, s in self.summary().items():
            lines.append(
                f"{k:>12}: mean {s['mean']*1e3:8.2f} ms  min {s['min']*1e3:8.2f}"
                f"  max {s['max']*1e3:8.2f}  (n={s['count']})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (open with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def solve_times_sweep(solve_fn, make_args, horizons, n_rep: int = 3):
    """Solve-time vs collocation points sweep (reference
    analysis/solve_times_test.py:66-118). ``solve_fn(horizon)`` must return a
    jitted callable; ``make_args(horizon)`` its inputs."""
    out = {}
    for h in horizons:
        fn = solve_fn(h)
        args = make_args(h)
        jax.block_until_ready(fn(*args))  # compile
        t0 = time.perf_counter()
        for _ in range(n_rep):
            res = jax.block_until_ready(fn(*args))
        out[h] = (time.perf_counter() - t0) / n_rep
        del res
    return out
