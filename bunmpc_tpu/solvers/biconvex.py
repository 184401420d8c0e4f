"""Batched biconvex ADMM for centroidal dynamics (the "dyn" half of the MPC).

JAX twin of the reference ``BiConvexMP`` (reference
src/motion_planner/biconvex.cpp:6-151, include/motion_planner/biconvex.hpp:21-193):
alternate a force QP and a state QP — each solved by projected FISTA with the
bilinear constraint enforced as a quadratic penalty — and update the scaled
dual ``P_k`` with the dynamics violation until ``||A_f x - b_f|| < exit_tol``.

All matrices stay matrix-free (see ``mpc/centroidal.py``); the ADMM loop is a
``lax.while_loop`` with a per-problem convergence mask so thousands of solves
retire together in one compiled program. Defaults mirror biconvex.hpp:148-160
and the ctor seeds at biconvex.cpp:20-24 (L0_x=2.25e6, L0_f=506.25, SoC on
for forces).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..mpc import centroidal as cd
from . import fista


@dataclasses.dataclass(frozen=True)
class BiconvexConfig:
    rho: float = 1e5
    max_admm_iters: int = 100
    fista_max_iters: int = 150
    fista_tol: float = 1e-5
    exit_tol: float = 1e-3
    beta: float = 1.5
    L0_x: float = 2.25e6
    L0_f: float = 506.25
    mu: float = 1.0  # friction coefficient (fista.hpp:60)
    use_soc: bool = True  # SoC projection for forces (biconvex.cpp:24)
    soc_mode: str = "exact"
    momentum: str = "reference"
    log_statistics: bool = False  # dyn-violation history (biconvex.hpp:127-139)
    # "power": fixed FISTA step from a power-iteration Lipschitz estimate
    # (hot-path default — no nested line-search loop); "linesearch": the
    # reference's backtracking (fista.cpp:6-27), kept for parity testing.
    step_mode: str = "power"
    power_iters: int = 8
    # Jacobi preconditioning (power mode only): diagonal-metric FISTA with
    # D = lam_max * safety * diag-estimate of the subproblem Hessian (exact
    # closed form from the constraint stencils, per-contact isotropic for the
    # cone). Identical fixed points. No faster on the trot QPs (both variants
    # saturate the iteration caps; the conditioning is in the temporal-chain
    # off-diagonal, not the diagonal), so default OFF to keep scalar-step
    # trajectory parity.
    precondition: bool = False
    # Outer-loop acceleration (round-2, DEFAULT-ON since round 3): dual
    # over-relaxation P += alpha*viol and geometric rho escalation with dual
    # rescaling (P /= growth when rho *= growth; the scaled dual P ~ y/rho).
    # Same constrained fixed point, same exit_tol — reached in ~2.5x fewer
    # outer iterations. The round-2 Go2 divergence (fixed escalation
    # outrunning the capped inner FISTA) is gone with the exact
    # x_solver="thomas" X-solve + the divergence backoff below; measured
    # round-3 (B=512 Solo12 / B=128 Go2 random commands): Solo12
    # conv@1e-3 = 1.00 @ ~29 iters, Go2 conv@1e-3 = 0.93+ with
    # max_admm_iters=200. Reference schedule = dual_relax=1, rho_growth=1
    # (parity tests pin that).
    dual_relax: float = 1.8
    rho_growth: float = 3.0
    rho_growth_every: int = 10
    rho_max_scale: float = 81.0  # cap: rho <= rho * rho_max_scale
    # Stall-gated escalation + divergence backoff (round-3): at each growth check a lane escalates
    # only if its violation failed to improve by rho_stall_improve since
    # the last check, and de-escalates one step if it GREW by more than
    # rho_backoff_thresh. Makes the accelerated schedule self-limiting on
    # robots where fixed-cadence escalation outruns the inner solves.
    rho_stall_gate: bool = True
    rho_stall_improve: float = 0.0  # 0 = always escalate on cadence unless diverged
    rho_backoff_thresh: float = 2.0
    # X-subproblem backend: "thomas" (DEFAULT) = EXACT block-tridiagonal
    # solve (solvers/block_thomas.py) + clip to the kinematic box — the
    # normal matrix is block tridiagonal in the knot index, so one ~H-step
    # Cholesky sweep replaces up to 150 capped FISTA iterations (exact
    # whenever the (+-0.45 m) CoM box is inactive, the nominal gait
    # regime), and is what makes the accelerated schedule above safe on
    # heavy robots. "fista" = the reference's projected FISTA
    # (biconvex.cpp:90-96); iterate-level parity tests against the native
    # C++ twin pin it.
    x_solver: str = "thomas"

    def fista_cfg(self, soc: bool):
        return fista.FistaConfig(
            max_iters=self.fista_max_iters,
            tol=self.fista_tol,
            beta=self.beta,
            momentum=self.momentum,
            soc_mode=self.soc_mode,
        )


class CostX(NamedTuple):
    """Diagonal state cost: rows 0..H-1 weighted by W_X against X_nom, row H by
    W_X_ter against X_ter (reference create_cost_X, biconvex.cpp:60-72)."""

    W: jnp.ndarray  # (..., H+1, 9)
    X_ref: jnp.ndarray  # (..., H+1, 9)


class BiconvexResult(NamedTuple):
    X: jnp.ndarray  # (..., H+1, 9)
    F: jnp.ndarray  # (..., H, n_eff, 3)
    P: jnp.ndarray  # (..., H+1, 9) scaled dual
    viol_norm: jnp.ndarray  # (...,) final ||A_f X - b_f||
    admm_iters: jnp.ndarray  # (...,)
    viol_hist: jnp.ndarray | None  # (..., max_admm_iters) if log_statistics


def kinematic_box_bounds(plan: cd.ContactPlan, b_lo, b_hi):
    """CoM box around the support polygon (reference create_bound_constraints,
    biconvex.cpp:48-56): active at knots with any contact, +-inf otherwise.
    ``b_lo``/``b_hi``: (..., H, 3) or (3,) margins (e.g. [-bx,-by,0], [bx,by,bz])."""
    any_cnt = jnp.sum(plan.cnt, axis=-1) > 0  # (..., H)
    r_max = jnp.max(plan.r, axis=-2)  # (..., H, 3) over feet
    r_min = jnp.min(plan.r, axis=-2)
    inf = jnp.asarray(jnp.inf, plan.r.dtype)
    lb_com = jnp.where(any_cnt[..., None], r_max + b_lo, -inf)
    ub_com = jnp.where(any_cnt[..., None], r_min + b_hi, inf)
    # only the CoM rows are bounded; velocities/momenta are free
    H = plan.cnt.shape[-2]
    shape = lb_com.shape[:-2] + (H + 1, 9)
    lb = jnp.full(shape, -jnp.inf, plan.r.dtype)
    ub = jnp.full(shape, jnp.inf, plan.r.dtype)
    lb = lb.at[..., :H, 0:3].set(lb_com)
    ub = ub.at[..., :H, 0:3].set(ub_com)
    return lb, ub


def solve(
    plan: cd.ContactPlan,
    m: float,
    x_init: jnp.ndarray,  # (..., 9) current centroidal state
    cost_x: CostX,
    W_F: jnp.ndarray,  # (..., H, n_eff, 3) force weights
    X_wm: jnp.ndarray,  # warm starts (..., H+1, 9)
    F_wm: jnp.ndarray,  # (..., H, n_eff, 3)
    P_wm: jnp.ndarray,  # (..., H+1, 9)
    cfg: BiconvexConfig,
    x_bounds=None,  # optional (lb, ub) from kinematic_box_bounds
    f_bounds=None,  # optional (lb, ub) for forces when use_soc=False
    F_ref=None,  # optional (..., H, n_eff, 3) force regularization reference
    # point (mass-normalized f_reg_style="weight", params.py): the F cost
    # becomes (F - F_ref)' W_F (F - F_ref); None = the reference's
    # pull-to-zero (biconvex.cpp:60-72)
) -> BiconvexResult:
    batch_shape = x_init.shape[:-1]

    if cfg.use_soc:
        proj_f = fista.soc_projector(cfg.mu, cfg.soc_mode)
    else:
        lb_f, ub_f = f_bounds
        proj_f = fista.box_projector(lb_f, ub_f)
    if x_bounds is not None:
        proj_x = fista.box_projector(*x_bounds)
    else:
        proj_x = lambda z: z  # noqa: E731

    q_x = -2.0 * cost_x.W * cost_x.X_ref

    def solve_f(X, F0, P, L0, rho_k):
        """Force subproblem: min F'W_F F + rho ||A_x F - b_x + P||^2."""
        rho = rho_k.reshape(rho_k.shape + (1, 1, 1))
        b = cd.bx_vec(plan, X)
        bP = P - b

        def Ax(F):
            return cd.ax_apply(plan, m, X, F)

        def quad_op(y):  # linear part of the gradient (PSD)
            return 2.0 * (W_F * y + rho * cd.ax_applyT(plan, m, X, Ax(y)))

        if F_ref is None:
            def grad(y):
                return 2.0 * (W_F * y + rho * cd.ax_applyT(plan, m, X, Ax(y) + bP))
        else:
            def grad(y):
                return 2.0 * (
                    W_F * (y - F_ref) + rho * cd.ax_applyT(plan, m, X, Ax(y) + bP)
                )

        if cfg.step_mode == "power":
            if cfg.precondition:
                # per-contact isotropic diag of 2(W_F + rho A_x^T A_x)
                wf_iso = jnp.mean(W_F, axis=-1, keepdims=True)
                d0 = 2.0 * (wf_iso + rho * cd.ax_diag_iso(plan, m, X)) + 1e-12
                sq = jnp.sqrt(d0)

                def pre_op(z):
                    return quad_op(z / sq) / sq

                lam = fista.power_iteration_L(pre_op, F0.shape, F0.dtype, 3, cfg.power_iters)
                D = lam.reshape(lam.shape + (1, 1, 1)) * d0
                res = fista.solve_diag_step(F0, grad, proj_f, D, cfg.fista_cfg(True), n_var_dims=3)
                return res.x, L0
            L = fista.power_iteration_L(quad_op, F0.shape, F0.dtype, 3, cfg.power_iters)
            res = fista.solve_fixed_step(F0, grad, proj_f, L, cfg.fista_cfg(True), n_var_dims=3)
            return res.x, L0

        def obj_diff(y1, y0):
            ctr = (y1 + y0) if F_ref is None else (y1 + y0 - 2.0 * F_ref)
            quad = jnp.sum(ctr * W_F * (y1 - y0), axis=(-3, -2, -1))
            r1 = Ax(y1) + bP
            r0 = Ax(y0) + bP
            pen = jnp.sum(r1 * r1, axis=(-2, -1)) - jnp.sum(r0 * r0, axis=(-2, -1))
            return quad + rho_k * pen

        res = fista.solve(F0, grad, obj_diff, proj_f, L0, cfg.fista_cfg(True), n_var_dims=3)
        return res.x, res.L

    def solve_x(F, X0, P, L0, rho_k):
        """State subproblem: min (X-ref)'W(X-ref) + rho ||A_f X - b_f + P||^2."""
        if cfg.x_solver == "thomas":
            from . import block_thomas as bt

            X_exact = bt.solve_x_exact(
                plan, m, F, cost_x.W, cost_x.X_ref, P, rho_k, x_init
            )
            return proj_x(X_exact), L0
        rho = rho_k.reshape(rho_k.shape + (1, 1))
        b = cd.bf_vec(plan, m, F, x_init)
        bP = P - b

        def Af(X):
            return cd.af_apply(plan, m, F, X)

        def quad_op(y):
            return 2.0 * (cost_x.W * y + rho * cd.af_applyT(plan, m, F, Af(y)))

        def grad(y):
            return 2.0 * (cost_x.W * y + rho * cd.af_applyT(plan, m, F, Af(y) + bP)) + q_x

        if cfg.step_mode == "power":
            if cfg.precondition:
                d0 = 2.0 * (cost_x.W + rho * cd.af_diag(plan, F)) + 1e-12
                sq = jnp.sqrt(d0)

                def pre_op(z):
                    return quad_op(z / sq) / sq

                lam = fista.power_iteration_L(pre_op, X0.shape, X0.dtype, 2, cfg.power_iters)
                D = lam.reshape(lam.shape + (1, 1)) * d0
                res = fista.solve_diag_step(X0, grad, proj_x, D, cfg.fista_cfg(False), n_var_dims=2)
                return res.x, L0
            L = fista.power_iteration_L(quad_op, X0.shape, X0.dtype, 2, cfg.power_iters)
            res = fista.solve_fixed_step(X0, grad, proj_x, L, cfg.fista_cfg(False), n_var_dims=2)
            return res.x, L0

        def obj_diff(y1, y0):
            d = y1 - y0
            quad = jnp.sum((y1 + y0) * cost_x.W * d, axis=(-2, -1))
            lin = jnp.sum(q_x * d, axis=(-2, -1))
            r1 = Af(y1) + bP
            r0 = Af(y0) + bP
            pen = jnp.sum(r1 * r1, axis=(-2, -1)) - jnp.sum(r0 * r0, axis=(-2, -1))
            return quad + lin + rho_k * pen

        res = fista.solve(X0, grad, obj_diff, proj_x, L0, cfg.fista_cfg(False), n_var_dims=2)
        return res.x, res.L

    def violation(F, X):
        v = cd.af_apply(plan, m, F, X) - cd.bf_vec(plan, m, F, x_init)
        return v, jnp.sqrt(jnp.sum(v * v, axis=(-2, -1)))

    hist0 = (
        jnp.zeros(batch_shape + (cfg.max_admm_iters,), x_init.dtype)
        if cfg.log_statistics
        else None
    )

    def cond(carry):
        it, done = carry[-2], carry[-1]
        return jnp.logical_and(~jnp.all(done), it < cfg.max_admm_iters)

    def body(carry):
        X, F, P, rho_k, L_x, L_f, viol_n, viol_chk, iters, hist, it, done = carry
        F_new, L_f_new = solve_f(X, F, P, L_f, rho_k)
        X_new, L_x_new = solve_x(F_new, X, P, L_x, rho_k)
        v, vn = violation(F_new, X_new)
        P_new = P + cfg.dual_relax * v

        m2 = ~done
        mx = m2[..., None, None]
        mf = m2[..., None, None, None]
        X = jnp.where(mx, X_new, X)
        F = jnp.where(mf, F_new, F)
        P = jnp.where(mx, P_new, P)
        L_x = jnp.where(m2, L_x_new, L_x)
        L_f = jnp.where(m2, L_f_new, L_f)
        viol_n = jnp.where(m2, vn, viol_n)
        iters = jnp.where(m2, it + 1, iters)
        if hist is not None:
            hist = hist.at[..., it].set(jnp.where(m2, vn, 0.0))
        # NaN divergence guard (biconvex.cpp:106-109) + convergence exit
        done = done | (vn < cfg.exit_tol) | jnp.isnan(vn)
        # geometric rho escalation with dual rescaling (unconverged only)
        if cfg.rho_growth != 1.0:
            at_check = (jnp.mod(it + 1, cfg.rho_growth_every) == 0) & ~done
            capok = rho_k * cfg.rho_growth <= cfg.rho * cfg.rho_max_scale
            if cfg.rho_stall_gate:
                stalled = viol_n > cfg.rho_stall_improve * viol_chk
                diverged = viol_n > cfg.rho_backoff_thresh * viol_chk
                flook = rho_k >= cfg.rho * cfg.rho_growth * 0.999
                grow = at_check & stalled & ~diverged & capok
                back = at_check & diverged & flook
                g = jnp.where(grow, cfg.rho_growth, 1.0)
                g = jnp.where(back, 1.0 / cfg.rho_growth, g).astype(x_init.dtype)
                viol_chk = jnp.where(at_check, vn, viol_chk)
            else:
                g = jnp.where(at_check & capok, cfg.rho_growth, 1.0).astype(
                    x_init.dtype
                )
            rho_k = rho_k * g
            P = P / g[..., None, None]
        # seed the stall checkpoint with the first measured violation
        viol_chk = jnp.where(it == 0, vn, viol_chk)
        return X, F, P, rho_k, L_x, L_f, viol_n, viol_chk, iters, hist, it + 1, done

    L_x0 = jnp.full(batch_shape, cfg.L0_x, x_init.dtype)
    L_f0 = jnp.full(batch_shape, cfg.L0_f, x_init.dtype)
    viol0 = jnp.full(batch_shape, jnp.inf, x_init.dtype)
    iters0 = jnp.zeros(batch_shape, jnp.int32)
    done0 = jnp.zeros(batch_shape, bool)
    rho0 = jnp.full(batch_shape, cfg.rho, x_init.dtype)

    carry = (
        X_wm, F_wm, P_wm, rho0, L_x0, L_f0, viol0, viol0, iters0, hist0,
        jnp.zeros((), jnp.int32), done0,
    )
    X, F, P, rho_k, _, _, viol_n, _, iters, hist, _, _ = jax.lax.while_loop(cond, body, carry)
    # The loop's P is the *scaled* dual y/rho_k relative to the (possibly
    # escalated) final rho_k. Warm-start consumers restart a fresh solve at the
    # base cfg.rho, so rescale to keep the implied dual y = P*rho consistent
    # (advisor round-2: without this, rho_growth!=1 understates y by up to
    # rho_max_scale when combined with warm_start_carry).
    if cfg.rho_growth != 1.0:
        P = P * (rho_k / cfg.rho)[..., None, None]
    return BiconvexResult(X=X, F=F, P=P, viol_norm=viol_n, admm_iters=iters, viol_hist=hist)
