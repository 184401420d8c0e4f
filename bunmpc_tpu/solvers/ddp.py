"""Gauss-Newton DDP on the free-flyer configuration manifold (single sample;
``jax.vmap`` the solve for batching — XLA turns the Riccati matrix blocks into
batched matmuls).

JAX replacement for ``crocoddyl::SolverDDP`` as the reference uses it
for its kinematic IK (reference src/ik/inverse_kinematics.cpp:54-71): the
"dynamics" is a pure double integrator on (q, v) with control u = v̇
(reference src/ik/action_model.cpp:43-90 sets Fx=0, Fu=I on the acceleration
level), integrated with crocoddyl's semi-implicit Euler:

    v⁺ = v + u·dt ,   q⁺ = integrate(q, v⁺·dt)

Costs are weighted-quadratic residuals (crocoddyl CostModelResidual semantics:
Gauss-Newton derivatives, running costs scaled by dt). All cost/dynamics
derivatives come from JAX autodiff in the *tangent space* of the manifold, so
the quaternion is handled exactly; the Riccati sweep is a ``lax.scan`` over
the (short) horizon.

Solve strategy: fixed number of GN/DDP iterations (static shape; the problem
is nearly LQR — a handful suffice), parallel line search over a fixed alpha
grid with best-accepted selection instead of crocoddyl's sequential
backtracking.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..kin import algorithms as K
from ..robots.model import RobotModel


@dataclasses.dataclass(frozen=True)
class DdpConfig:
    n_iters: int = 6
    alphas: tuple = (1.0, 0.7, 0.3, 0.1, 0.03)
    reg: float = 1e-9  # Quu Levenberg regularization (crocoddyl regInit)


class DdpResult(NamedTuple):
    xs: jnp.ndarray  # (H+1, nq+nv) state trajectory
    us: jnp.ndarray  # (H, nv) accelerations
    cost: jnp.ndarray  # () final total cost


def _step(model: RobotModel, x, u, dt):
    """Semi-implicit Euler on (q, v); x = [q(nq), v(nv)]."""
    nq = model.nq
    q, v = x[..., :nq], x[..., nq:]
    v_next = v + u * dt
    q_next = K.integrate(model, q, v_next * dt)
    return jnp.concatenate([q_next, v_next], axis=-1)


def _perturb(model: RobotModel, x, dx):
    """x ⊕ dx with dx in the 2*nv tangent space."""
    nq, nv = model.nq, model.nv
    q = K.integrate(model, x[..., :nq], dx[..., :nv])
    v = x[..., nq:] + dx[..., nv:]
    return jnp.concatenate([q, v], axis=-1)


def _state_diff(model: RobotModel, x1, x2):
    """Tangent difference x2 ⊖ x1 (2*nv,)."""
    nq = model.nq
    dq = K.difference(model, x1[..., :nq], x2[..., :nq])
    return jnp.concatenate([dq, x2[..., nq:] - x1[..., nq:]], axis=-1)


def solve(
    model: RobotModel,
    x0: jnp.ndarray,  # (nq+nv,)
    us0: jnp.ndarray,  # (H, nv) initial accelerations
    dts: jnp.ndarray,  # (H,)
    residuals_fn: Callable,  # (x, k) -> (r, w): stage residuals + diag weights
    ctrl_weight: jnp.ndarray,  # (H, nv) diagonal Luu weights (already * reg_wt)
    term_residuals_fn: Callable,  # (x) -> (r, w)
    cfg: DdpConfig = DdpConfig(),
    stage_jac_fn: Callable | None = None,  # (x, u, k) -> (Jr, w, Fx, Fu)
    term_jac_fn: Callable | None = None,  # (x) -> Jt
) -> DdpResult:
    """Minimize sum_k dt_k*[0.5 r_k' W_k r_k + 0.5 u' Wu u] + 0.5 r_N' W_N r_N.

    The whole solve is traced under full-f32 matmul precision: reduced
    precision dots (TF32 on the GPU) corrupt the Riccati Gauss-Newton blocks
    on heavier robots — Quu loses positive-definiteness, the Cholesky NaNs,
    every line-search candidate is rejected and the returned trajectory
    silently freezes at the warm start (the round-2 Go2 in-sim collapse).
    """
    return _solve_f32(
        model, x0, us0, dts, residuals_fn, ctrl_weight, term_residuals_fn,
        cfg, stage_jac_fn, term_jac_fn,
    )


def _solve_f32(
    model, x0, us0, dts, residuals_fn, ctrl_weight, term_residuals_fn, cfg,
    stage_jac_fn, term_jac_fn,
) -> DdpResult:
    with jax.default_matmul_precision("float32"):
        return _solve_impl(
            model, x0, us0, dts, residuals_fn, ctrl_weight, term_residuals_fn,
            cfg, stage_jac_fn, term_jac_fn,
        )


def _solve_impl(
    model, x0, us0, dts, residuals_fn, ctrl_weight, term_residuals_fn, cfg,
    stage_jac_fn, term_jac_fn,
) -> DdpResult:
    nv = model.nv
    ndx = 2 * nv
    H = us0.shape[0]
    dtype = x0.dtype

    def rollout(us):
        def f(x, ku):
            k, u = ku
            x_next = _step(model, x, u, dts[k])
            return x_next, x_next

        _, xs_tail = jax.lax.scan(f, x0, (jnp.arange(H), us))
        return jnp.concatenate([x0[None], xs_tail], axis=0)

    def stage_cost(x, u, k):
        r, w = residuals_fn(x, k)
        wu = ctrl_weight[k]
        return dts[k] * 0.5 * (jnp.sum(w * r * r) + jnp.sum(wu * u * u))

    def term_cost(x):
        r, w = term_residuals_fn(x)
        return 0.5 * jnp.sum(w * r * r)

    def total_cost(xs, us):
        costs = jax.vmap(stage_cost)(xs[:H], us, jnp.arange(H))
        return jnp.sum(costs) + term_cost(xs[H])

    def stage_jacobians(x, u, k):
        """Residual/dynamics Jacobians at (x, u) — the expensive autodiff part."""

        def r_of_dx(dx):
            r, w = residuals_fn(_perturb(model, x, dx), k)
            return r, w

        Jr, w = jax.jacfwd(r_of_dx, has_aux=True)(jnp.zeros(ndx, dtype))  # (nr, ndx)
        x_next = _step(model, x, u, dts[k])

        def f_of_dxu(dxu):
            return _state_diff(
                model, x_next, _step(model, _perturb(model, x, dxu[:ndx]), u + dxu[ndx:], dts[k])
            )

        Jf = jax.jacfwd(f_of_dxu)(jnp.zeros(ndx + nv, dtype))  # (ndx, ndx+nv)
        return Jr, w, Jf[:, :ndx], Jf[:, ndx:]

    def term_jacobian(x):
        def r_of_dx(dx):
            return term_residuals_fn(_perturb(model, x, dx))[0]

        return jax.jacfwd(r_of_dx)(jnp.zeros(ndx, dtype))

    def all_jacobians(xs, us):
        """Knot-vectorized Jacobians (hoisted out of the Riccati scan: one
        batched autodiff dispatch instead of H sequential ones). When the
        caller provides structured/analytic Jacobian functions (mpc/ik.py
        build_jacobian_fns) those replace the brute-force tangent jacfwd —
        the dominant cost of the whole MPC solve."""
        sj = stage_jac_fn if stage_jac_fn is not None else stage_jacobians
        Jr, w, Fx, Fu = jax.vmap(sj)(xs[:H], us, jnp.arange(H))
        Jt = (term_jac_fn if term_jac_fn is not None else term_jacobian)(xs[H])
        return Jr, w, Fx, Fu, Jt

    def backward(xs, us, jac):
        """Riccati sweep: Gauss-Newton curvature from the Jacobians at
        (xs, us), gradients from the residuals there."""
        Jr, w, Fx_all, Fu_all, Jt = jac
        r_all = jax.vmap(lambda x, k: residuals_fn(x, k)[0])(xs[:H], jnp.arange(H))
        rt, wt = term_residuals_fn(xs[H])
        Vx = Jt.T @ (wt * rt)
        Vxx = (Jt.T * wt) @ Jt

        def bwd(carry, k):
            Vx, Vxx = carry
            Jk, wk, rk = Jr[k], w[k], r_all[k]
            dt = dts[k]
            Lx = dt * Jk.T @ (wk * rk)
            Lxx = dt * (Jk.T * wk) @ Jk
            wu = ctrl_weight[k]
            Lu = dt * wu * us[k]
            Luu = dt * jnp.diag(wu)
            Fx, Fu = Fx_all[k], Fu_all[k]
            Qx = Lx + Fx.T @ Vx
            Qu = Lu + Fu.T @ Vx
            Qxx = Lxx + Fx.T @ Vxx @ Fx
            Qux = Fu.T @ Vxx @ Fx
            Quu = Luu + Fu.T @ Vxx @ Fu + cfg.reg * jnp.eye(nv, dtype=dtype)
            chol = jnp.linalg.cholesky(Quu)
            kff = -jax.scipy.linalg.cho_solve((chol, True), Qu[:, None])[:, 0]
            Kfb = -jax.scipy.linalg.cho_solve((chol, True), Qux)
            Vx_new = Qx + Kfb.T @ Qu
            Vxx_new = Qxx + Kfb.T @ Qux
            Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
            return (Vx_new, Vxx_new), (kff, Kfb)

        _, (kffs, Kfbs) = jax.lax.scan(bwd, (Vx, Vxx), jnp.arange(H - 1, -1, -1))
        return jnp.flip(kffs, axis=0), jnp.flip(Kfbs, axis=0)

    def forward(xs, us, kffs, Kfbs, alpha):
        def f(x, inp):
            k, x_ref, u_ref, kff, Kfb = inp
            dx = _state_diff(model, x_ref, x)
            u = u_ref + alpha * kff + Kfb @ dx
            x_next = _step(model, x, u, dts[k])
            return x_next, (x_next, u)

        _, (xs_tail, us_new) = jax.lax.scan(f, x0, (jnp.arange(H), xs[:H], us, kffs, Kfbs))
        return jnp.concatenate([x0[None], xs_tail], axis=0), us_new

    def iteration(_, carry):
        xs, us, cost = carry
        kffs, Kfbs = backward(xs, us, all_jacobians(xs, us))

        def try_alpha(alpha):
            xs_a, us_a = forward(xs, us, kffs, Kfbs, alpha)
            return xs_a, us_a, total_cost(xs_a, us_a)

        xs_c, us_c, cost_c = jax.vmap(try_alpha)(jnp.asarray(cfg.alphas, dtype))
        best = jnp.argmin(cost_c)
        xs_b = xs_c[best]
        us_b = us_c[best]
        cost_b = cost_c[best]
        improved = cost_b < cost
        xs = jnp.where(improved, xs_b, xs)
        us = jnp.where(improved, us_b, us)
        cost = jnp.minimum(cost, cost_b)
        return xs, us, cost

    xs, us = rollout(us0), us0
    # a loop, not a Python unroll: one iteration is a large program (FK,
    # Jacobians, Riccati and line-search scans), and unrolling n_iters of
    # them multiplies trace and compile time by n_iters
    xs, us, cost = jax.lax.fori_loop(
        0, cfg.n_iters, iteration, (xs, us, total_cost(xs, us))
    )
    return DdpResult(xs=xs, us=us, cost=cost)
