"""Per-stage timing breakdown of the batched MPC solve on the current device.

Times (a) problem assembly, (b) centroidal ADMM, (c) kinematic GN-DDP IK plus
interpolation, (d) the full batched solve, each as its own jitted program on
the inputs ``bench.py`` times. Stages timed on their own do not add up to the
full solve exactly; a device trace of the full solve is the per-layer source.

    python scripts/profile_breakdown.py [batch=512]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

import bench  # noqa: E402
from bunmpc_tpu.mpc import kino_dyn as KD  # noqa: E402
from bunmpc_tpu.solvers import biconvex, ddp  # noqa: E402


def timeit(fn, *args, n=5):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / n, out


def main():
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    B = int(args.get("batch", bench.B))
    spec = bench.make_spec()
    admm_cfg = bench.admm_config()
    inputs = bench.make_inputs(B)
    m = spec.model.total_mass

    # (a) problem assembly
    prep = jax.jit(jax.vmap(lambda *a: KD._prepare_problem(spec, *a)))
    dt_prep, prob = timeit(prep, *inputs)

    # (b) centroidal ADMM
    def admm_one(pr):
        return biconvex.solve(
            pr["plan"], m, pr["x_init"], biconvex.CostX(W=pr["W"], X_ref=pr["X_ref"]),
            pr["W_F"], pr["X_wm"], pr["F_wm"], 0.0 * pr["X_wm"], admm_cfg,
            x_bounds=pr["x_bounds"], F_ref=pr.get("F_ref"),
        )

    dt_admm, dyn = timeit(jax.jit(jax.vmap(admm_one)), prob)

    # (c) IK + 1 kHz interpolation from the fixed dynamics solution
    ik = jax.jit(jax.vmap(lambda pr, d: KD._finish_solve(spec, pr, d, ddp.DdpConfig())))
    dt_ik, _ = timeit(ik, prob, dyn)

    # (d) the full batched solve
    dt_full, plans = timeit(bench.make_solve(spec, admm_cfg), *inputs)

    print(f"B={B}  device={jax.devices()[0].device_kind}")
    print(f"prep      : {dt_prep*1e3:8.2f} ms")
    print(f"admm      : {dt_admm*1e3:8.2f} ms")
    print(f"ik+interp : {dt_ik*1e3:8.2f} ms")
    print(f"full      : {dt_full*1e3:8.2f} ms  ({B/dt_full:.0f} solves/s, "
          f"conv@1e-3={bench.converged_frac(plans):.2f})")


if __name__ == "__main__":
    main()
