"""Headline benchmark: batched Solo12 trot MPC solves/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}, with
the device it ran on (JAX's platform and device kind, the card's name and
power limit from nvidia-smi). It fails when JAX finds no GPU.

Baseline: the reference BiConMP solves ONE MPC at a time inside a 50 ms
replanning budget on a desktop CPU, i.e. ~20 solves/s per process
(reference simulation.py:44, BASELINE.md). ``vs_baseline`` reports our
batched solves/s against that 20/s figure.

Measurement protocol:

* One process owns the card. A second JAX process on the same card competes
  for its memory and its time and spoils the measurement.
* Per-rep wall times are measured individually, each ending in
  ``block_until_ready``, and reported (``rep_times``), along with their
  max/min spread ratio (``rep_spread``).
* If the spread across reps exceeds 2x, the whole timed section re-runs
  once; the faster run (by median rep) is reported, ``reran`` is set and the
  discarded run's times stay in the output.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B = 512
N_REP = 5


def make_spec():
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu.robots.solo12 import Solo12Config

    return KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0())


def make_inputs(batch: int = B, seed: int = 0):
    """Random Solo12 trot commands: joint and velocity noise around q0, a
    random gait clock and random (vx, vy, wz) commands; float32."""
    import jax.numpy as jnp

    from bunmpc_tpu.robots.solo12 import Solo12Config

    dtype = jnp.float32
    rng = np.random.default_rng(seed)
    q = np.tile(Solo12Config.q0(), (batch, 1))
    q[:, 7:] += rng.normal(size=(batch, 12)) * 0.05
    v = rng.normal(size=(batch, 18)) * 0.05
    t = rng.uniform(0, 0.5, size=batch)
    v_des = np.stack(
        [rng.uniform(-0.3, 0.5, batch), rng.uniform(-0.2, 0.2, batch), np.zeros(batch)], -1
    )
    w_des = rng.uniform(-0.3, 0.3, size=batch)
    return tuple(jnp.asarray(a, dtype) for a in (q, v, t, v_des, w_des))


def admm_config():
    """The timed ADMM settings. The defaults carry the accelerated outer
    schedule (dual over-relaxation + rho escalation with divergence backoff).
    x_solver="thomas" is the exact block-tridiagonal X-subproblem solve
    (solvers/block_thomas.py); fista_max_iters=30 caps the F-subproblem
    FISTA, validated at conv@1e-3 = 1.0 across the B=512 Solo12 command
    envelope with trajectory drift within the ADMM's own tolerance."""
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu.solvers.biconvex import BiconvexConfig

    return BiconvexConfig(rho=trot.rho, x_solver="thomas", fista_max_iters=30)


def make_solve(spec, admm_cfg):
    """The jitted batched solve that is timed."""
    import jax

    from bunmpc_tpu.mpc import kino_dyn as KD

    return jax.jit(
        lambda q, v, t, vd, wd: KD.solve_mpc_batch(spec, q, v, t, vd, wd, admm_cfg=admm_cfg)
    )


def converged_frac(plans) -> float:
    """Share of lanes at the solver's own exit tolerance (reference exit_tol
    1e-3, biconvex.hpp:160), not a looser headline gate."""
    return float(np.mean(np.asarray(plans.dyn_violation) < 1e-3))


def timed_reps(solve, args):
    import jax

    times = []
    for _ in range(N_REP):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(*args))
        times.append(time.perf_counter() - t0)
    return times


def main():
    from bunmpc_tpu.utils.device import card_record, require_gpu
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()
    dev = require_gpu()
    import jax

    solve = make_solve(make_spec(), admm_config())
    args = make_inputs()

    plans = jax.block_until_ready(solve(*args))  # compile + warm-up
    ok = converged_frac(plans)

    times = timed_reps(solve, args)
    spread = max(times) / max(min(times), 1e-12)
    times_discarded = None
    if spread > 2.0:
        # unstable timing: re-run once and keep the faster (by median) run
        times2 = timed_reps(solve, args)
        if statistics.median(times2) < statistics.median(times):
            times, times_discarded = times2, times
        else:
            times_discarded = times2
        spread = max(times) / max(min(times), 1e-12)

    dt = statistics.median(times)
    solves_per_sec = B / dt
    out = {
        "metric": "trot_mpc_solves_per_sec",
        "value": solves_per_sec,
        "unit": "solves/s",
        "vs_baseline": solves_per_sec / 20.0,
        "batch": B,
        "sec_per_batch": dt,
        "converged_frac": ok,
        "device": card_record(dev),
        "rep_times": times,
        "rep_spread": spread,
        "reran": times_discarded is not None,
    }
    if times_discarded is not None:
        out["rep_times_discarded"] = times_discarded
    print(json.dumps(out))


if __name__ == "__main__":
    main()
