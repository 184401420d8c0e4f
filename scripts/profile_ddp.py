"""Micro-breakdown of the batched DDP IK on the real chip: Jacobians vs
backward sweep vs line-search forward vs full solve, analytic vs autodiff."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

from bunmpc_tpu.mpc import ik as IK
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.solvers import ddp


def timeit(fn, *args, n=5):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / n, out


def main():
    model = Solo12Config.load_model()
    eff = Solo12Config.eff_names
    B, H = 256, 10
    nq, nv = model.nq, model.nv
    rng = np.random.default_rng(0)
    dtype = jnp.float32

    x_reg = np.concatenate([Solo12Config.q0(), np.zeros(nv)])
    tasks = IK.IkTasks(
        ee_targets=jnp.asarray(rng.normal(size=(H, 4, 3)) * 0.05, dtype),
        ee_wts=jnp.asarray(rng.uniform(0.5, 2.0, size=(H, 4)), dtype),
        com_ref=jnp.asarray(rng.normal(size=(H + 1, 3)) * 0.02, dtype),
        mom_ref=jnp.asarray(rng.normal(size=(H + 1, 6)) * 0.02, dtype),
        com_wt=jnp.asarray(3.0, dtype),
        mom_wt=jnp.asarray(2.0, dtype),
        state_wt=jnp.asarray(rng.uniform(0.1, 1.0, size=2 * nv), dtype),
        x_reg=jnp.asarray(x_reg, dtype),
        reg_wt_state=0.7,
        reg_wt_ctrl=1e-4,
        ctrl_wt=jnp.asarray(rng.uniform(0.1, 1.0, size=nv), dtype),
        dts=jnp.full(H, 0.05, dtype),
    )
    q0 = np.tile(Solo12Config.q0(), (B, 1))
    q0[:, 7:] += rng.normal(size=(B, 12)) * 0.05
    x0 = jnp.asarray(np.concatenate([q0, rng.normal(size=(B, nv)) * 0.1], axis=1), dtype)

    def solve_n(x0b, analytic, n_iters):
        cfg = ddp.DdpConfig(n_iters=n_iters)
        return jax.vmap(
            lambda x: IK.solve_ik(model, eff, x, tasks, cfg, analytic_jacobians=analytic)
        )(x0b).cost

    for label, analytic in [("analytic", True), ("autodiff", False)]:
        f6 = jax.jit(lambda x, a=analytic: solve_n(x, a, 6))
        f1 = jax.jit(lambda x, a=analytic: solve_n(x, a, 1))
        f0 = jax.jit(lambda x, a=analytic: solve_n(x, a, 0))
        dt6, _ = timeit(f6, x0)
        dt1, _ = timeit(f1, x0)
        dt0, _ = timeit(f0, x0)
        print(
            f"{label:9s}: 6it={dt6*1e3:7.2f} ms  1it={dt1*1e3:7.2f} ms  "
            f"0it={dt0*1e3:7.2f} ms  per-extra-it={(dt6-dt1)/5*1e3:6.2f} ms"
        )

    # jacobians alone (vmapped over batch & knots)
    sj, tj = IK.build_jacobian_fns(model, eff, tasks)
    stage_r, term_r, ctrl_w = IK.build_residual_fns(model, eff, tasks)
    us = jnp.zeros((B, H, nv), dtype)

    def jacs_only(x0b, usb):
        def per_sample(x, us_s):
            xs = jnp.tile(x[None], (H, 1))
            return jax.vmap(sj)(xs, us_s, jnp.arange(H))[0]

        return jax.vmap(per_sample)(x0b, usb)

    jx = jax.jit(jacs_only)
    dtj, _ = timeit(jx, x0, us)
    print(f"analytic jacobians x1 (B={B}, H={H}): {dtj*1e3:7.2f} ms")


if __name__ == "__main__":
    main()
