"""f32-vs-f64 sensitivity sweep of the centroidal ADMM (ROADMAP numerics item).

For each gait (and both robots' trots) solve the same MPC problem in float32
and float64 on CPU and report: dynamics-violation at exit, ADMM iterations,
and the X/F solution deltas. The product path is f32 (GPU); this quantifies
what that costs vs the reference's f64 Eigen solver, and flags gaits whose
exit tolerance should be mass-normalized.

Usage: JAX_PLATFORMS=cpu python scripts/f32_sensitivity.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_enable_x64", True)  # allow f64 islands; inputs pick dtype
from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.solvers import biconvex, ddp


def run_case(name, model, params, q0, spec_kwargs):
    spec = KD.make_cyclic_spec(model, params, q0, **spec_kwargs)
    rows = []
    for dtype in (jnp.float32, jnp.float64):
        q = jnp.asarray(q0, dtype)
        v = jnp.zeros(model.nv, dtype)
        plan = jax.jit(
            lambda q, v: KD.solve_mpc(
                spec, q, v, jnp.asarray(0.0, dtype),
                jnp.asarray([0.2, 0.0, 0.0], dtype), jnp.asarray(0.0, dtype),
                admm_cfg=biconvex.BiconvexConfig(rho=params.rho),
                ddp_cfg=ddp.DdpConfig(n_iters=4),
            )
        )(q, v)
        rows.append(plan)
    p32, p64 = rows
    dX = float(jnp.max(jnp.abs(p32.X_opt.astype(jnp.float64) - p64.X_opt)))
    dF = float(jnp.max(jnp.abs(p32.F_opt.astype(jnp.float64) - p64.F_opt)))
    dxs = float(jnp.max(jnp.abs(p32.xs_int.astype(jnp.float64) - p64.xs_int)))
    print(
        f"{name:14s} viol f32={float(p32.dyn_violation):.3e} f64={float(p64.dyn_violation):.3e} "
        f"iters {int(p32.admm_iters)}/{int(p64.admm_iters)} | "
        f"max|dX|={dX:.2e} max|dF|={dF:.2e} max|dxs|={dxs:.2e}"
    )
    return dX, dF


def main():
    from bunmpc_tpu.mpc.motions import go2_cyclic, solo12_cyclic
    from bunmpc_tpu.robots.go2 import Go2Config
    from bunmpc_tpu.robots.solo12 import Solo12Config

    s12 = Solo12Config.load_model()
    for gait in ("trot", "jump", "bound"):
        run_case(f"solo12/{gait}", s12, solo12_cyclic.GAITS[gait], Solo12Config.q0(), {})

    go2 = Go2Config.load_model()
    run_case(
        "go2/trot", go2, go2_cyclic.trot, Go2Config.q0(),
        dict(
            eff_frames=tuple(Go2Config.eff_names),
            hip_frames=tuple(Go2Config.hip_names),
            foot_size=Go2Config.foot_size,
        ),
    )


if __name__ == "__main__":
    main()
