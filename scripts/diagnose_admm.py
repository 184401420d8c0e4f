"""ADMM/FISTA convergence diagnostics for the trot QPs.

Reports the outer-iteration distribution, the dyn-violation decay curve, and
per-subproblem FISTA iteration counts along the ADMM trajectory — the data
that decides whether kernel time goes to outer iterations, inner FISTA
iterations (conditioning), or the power-iteration step sizing
(ROADMAP: ADMM now dominates the fused solve).

Usage: [JAX_PLATFORMS=cpu] python scripts/diagnose_admm.py [batch=16]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

from bunmpc_tpu.mpc import centroidal as cd
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.solvers import biconvex, fista


def main():
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    B = int(args.get("batch", 16))

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    dtype = jnp.float32
    rng = np.random.default_rng(0)
    q = jnp.asarray(np.tile(Solo12Config.q0(), (B, 1)), dtype)
    q = q.at[:, 7:].add(jnp.asarray(rng.normal(size=(B, 12)) * 0.05, dtype))
    v = jnp.asarray(rng.normal(size=(B, 18)) * 0.05, dtype)
    t = jnp.asarray(rng.uniform(0, 0.5, size=B), dtype)
    v_des = jnp.asarray(
        np.stack([rng.uniform(-0.3, 0.5, B), rng.uniform(-0.2, 0.2, B), np.zeros(B)], -1),
        dtype,
    )
    w_des = jnp.asarray(rng.uniform(-0.3, 0.3, size=B), dtype)

    prob = jax.jit(
        jax.vmap(lambda *a: KD._prepare_problem(spec, *a))
    )(q, v, t, v_des, w_des)

    m = spec.model.total_mass
    plan = prob["plan"]
    cost_x = biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"])

    for precond in (False, True):
        cfg = biconvex.BiconvexConfig(
            rho=spec.params.rho, log_statistics=True, precondition=precond
        )
        res = jax.jit(
            lambda cfg=cfg: biconvex.solve(
                plan, m, prob["x_init"], cost_x, prob["W_F"], prob["X_wm"], prob["F_wm"],
                jnp.zeros_like(prob["X_wm"]), cfg, x_bounds=prob["x_bounds"],
            )
        )()
        iters = np.asarray(res.admm_iters)
        hist = np.asarray(res.viol_hist)
        viol = np.asarray(res.viol_norm)
        print(f"[precondition={precond}] B={B} outer iters: mean={iters.mean():.1f} "
              f"median={np.median(iters):.0f} max={iters.max()} (cap {cfg.max_admm_iters}); "
              f"final viol mean={viol.mean():.2e} max={viol.max():.2e}")
        med = np.nanmedian(np.where(hist > 0, hist, np.nan), axis=0)
        show = [0, 1, 2, 4, 8, 16, 32, 64, 99]
        print("  median dyn violation by outer iter:")
        for i in show:
            if i < len(med) and np.isfinite(med[i]):
                print(f"    iter {i:3d}: {med[i]:.4e}")
    cfg = biconvex.BiconvexConfig(rho=spec.params.rho, precondition=False)

    # FISTA iteration counts along the ADMM trajectory: re-run the two
    # subproblems at the converged iterates (worst case: fresh Hessians)
    rho = cfg.rho
    X, F, P = res.X, res.F, res.P

    def f_sub(X, F, P):
        b = cd.bx_vec(plan, X)
        bP = P - b

        def quad_op(y):
            return 2.0 * (prob["W_F"] * y + rho * cd.ax_applyT(plan, m, X, cd.ax_apply(plan, m, X, y)))

        def grad(y):
            return 2.0 * (
                prob["W_F"] * y + rho * cd.ax_applyT(plan, m, X, cd.ax_apply(plan, m, X, y) + bP)
            )

        L = fista.power_iteration_L(quad_op, F.shape, F.dtype, 3, cfg.power_iters)
        proj = fista.soc_projector(cfg.mu, cfg.soc_mode)
        r = fista.solve_fixed_step(jnp.zeros_like(F), grad, proj, L, cfg.fista_cfg(True), n_var_dims=3)
        return r.iters, L

    def x_sub(X, F, P):
        b = cd.bf_vec(plan, m, F, prob["x_init"])
        bP = P - b
        q_x = -2.0 * cost_x.W * cost_x.X_ref

        def quad_op(y):
            return 2.0 * (cost_x.W * y + rho * cd.af_applyT(plan, m, F, cd.af_apply(plan, m, F, y)))

        def grad(y):
            return (
                2.0 * (cost_x.W * y + rho * cd.af_applyT(plan, m, F, cd.af_apply(plan, m, F, y) + bP))
                + q_x
            )

        L = fista.power_iteration_L(quad_op, X.shape, X.dtype, 2, cfg.power_iters)
        proj = fista.box_projector(*prob["x_bounds"])
        r = fista.solve_fixed_step(jnp.zeros_like(X), grad, proj, L, cfg.fista_cfg(False), n_var_dims=2)
        return r.iters, L

    fi, Lf = jax.jit(f_sub)(X, F, P)
    xi, Lx = jax.jit(x_sub)(X, F, P)
    print(f"F-subproblem (cold x0): FISTA iters mean={np.mean(fi):.1f} max={np.max(fi)} "
          f"(cap {cfg.fista_max_iters}); L mean={np.mean(Lf):.3e}")
    print(f"X-subproblem (cold x0): FISTA iters mean={np.mean(xi):.1f} max={np.max(xi)} "
          f"(cap {cfg.fista_max_iters}); L mean={np.mean(Lx):.3e}")
    # diagonal spread of the X Hessian: how much a Jacobi preconditioner buys
    Wd = np.asarray(cost_x.W)
    print(f"X diag cost W: min={Wd.min():.1e} max={Wd.max():.1e}")


if __name__ == "__main__":
    main()
