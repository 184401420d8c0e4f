"""Solve-time and convergence sweeps vs collocation points.

Twin of the reference analysis harness (reference
examples/analysis/solve_times_test.py:66-118 and dyn_violation.py:80-87):
sweep the trot/jump/bound gaits over horizon lengths, timing the batched
solve and recording the ADMM dyn-violation convergence curve.

    python scripts/solve_times_sweep.py [gait=trot] [batch=64]
"""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.solvers import biconvex
    from bunmpc_tpu.utils.profiling import SolveTimer

    args = dict(a.split("=", 1) for a in sys.argv[1:])
    gait_name = args.get("gait", "trot")
    B = int(args.get("batch", 64))
    params = GAITS[gait_name]
    model = Solo12Config.load_model()

    results = {}
    timer = SolveTimer()
    for gait_horizon in (1.0, 1.5, 2.0, 2.5):
        p = dataclasses.replace(params, gait_horizon=gait_horizon)
        spec = KD.make_cyclic_spec(model, p, Solo12Config.q0())
        q = jnp.asarray(np.tile(Solo12Config.q0(), (B, 1)), jnp.float32)
        v = jnp.zeros((B, 18), jnp.float32)
        t = jnp.zeros(B, jnp.float32)
        vd = jnp.tile(jnp.asarray([0.2, 0.0, 0.0], jnp.float32), (B, 1))
        wd = jnp.zeros(B, jnp.float32)
        admm = biconvex.BiconvexConfig(rho=p.rho, log_statistics=True)
        solve = jax.jit(
            jax.vmap(lambda *a: KD.solve_mpc(spec, *a, admm_cfg=admm))
        )
        plans = jax.block_until_ready(solve(q, v, t, vd, wd))  # compile
        with timer.phase(f"H={spec.horizon}", block_on=None):
            plans = jax.block_until_ready(solve(q, v, t, vd, wd))
        results[spec.horizon] = {
            "sec_per_batch": timer.times[f"H={spec.horizon}"][-1],
            "solves_per_sec": B / timer.times[f"H={spec.horizon}"][-1],
            "mean_admm_iters": float(jnp.mean(plans.admm_iters)),
            "mean_viol": float(jnp.mean(plans.dyn_violation)),
        }
        print(f"H={spec.horizon}: {results[spec.horizon]}")

    out = args.get("out", f"solve_times_{gait_name}.json")
    with open(out, "w") as fh:
        json.dump(results, fh, indent=2)
    print(f"-> {out}")


if __name__ == "__main__":
    main()
