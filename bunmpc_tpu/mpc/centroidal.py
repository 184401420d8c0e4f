"""Batched centroidal-dynamics constraint operators for the biconvex MPC.

JAX twin of the reference ``CentroidalDynamics`` (reference
src/dynamics/centroidal.cpp:57-127, include/dynamics/centroidal.hpp:14-58).

The reference builds sparse Eigen matrices ``A_x (9(H+1) x 3*ne*H)`` and
``A_f (9(H+1) x 9(H+1))`` coefficient-by-coefficient. We never
materialize them: both are structured stencils (block-bidiagonal in the knot
index with 3-vector cross-product blocks), so each matvec/rmatvec is a handful
of fused elementwise ops on ``(..., H, n_eff, 3)`` tensors, with no
device-memory traffic beyond the operands. The batch axis carries the parallelism.

State layout  X: (..., H+1, 9)  = [com(3), vcom(3), amom(3)] per knot
Force layout  F: (..., H, n_eff, 3)
Contact plan: cnt (..., H, n_eff) in {0,1};  r (..., H, n_eff, 3);  dt (..., H)

Constraint semantics (bilinear split of the centroidal dynamics):
  F-subproblem (X fixed):  A_x(X) F = b_x(X)   rows = Delta-vcom / Delta-amom
  X-subproblem (F fixed):  A_f(F) X = b_f(F)   rows = Euler-step recursions
                                               + initial-state pinning row
both enforced as quadratic penalties rho*||A z - b + P||^2 inside FISTA
(reference src/solvers/problem.cpp:31-56).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_G = 9.81


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ContactPlan:
    """Dense contact plan tensor, the exact layout the reference feeds
    knot-by-knot via ``set_contact_arrays`` (centroidal.cpp:39-49)."""

    cnt: jnp.ndarray  # (..., H, n_eff) contact flags
    r: jnp.ndarray  # (..., H, n_eff, 3) contact locations (world)
    dt: jnp.ndarray  # (..., H) knot durations


# --- F-subproblem operators:  A_x(X) F  and  b_x(X) ---


def ax_apply(plan: ContactPlan, m: float, X, F):
    """A_x(X) @ F -> residual-space (..., H+1, 9).

    Rows per knot t < H: [0(3), dt/m * sum_n c f_n, dt * sum_n c (r_n - com_t) x f_n];
    terminal row block is zero (centroidal.cpp:57-84).
    """
    cF = plan.cnt[..., None] * F  # (..., H, ne, 3)
    dt = plan.dt[..., None]
    lin = dt * jnp.sum(cF, axis=-2) / m
    arm = plan.r - X[..., :-1, None, 0:3]  # r_n - com_t
    ang = dt * jnp.sum(jnp.cross(arm, cF), axis=-2)
    zeros3 = jnp.zeros_like(lin)
    rows = jnp.concatenate([zeros3, lin, ang], axis=-1)  # (..., H, 9)
    pad = jnp.zeros_like(rows[..., :1, :])
    return jnp.concatenate([rows, pad], axis=-2)


def ax_applyT(plan: ContactPlan, m: float, X, Y):
    """A_x(X)^T @ Y -> force-space (..., H, n_eff, 3)."""
    y_lin = Y[..., :-1, 3:6]  # (..., H, 3)
    y_ang = Y[..., :-1, 6:9]
    dt = plan.dt[..., None, None]
    arm = plan.r - X[..., :-1, None, 0:3]
    # d/df [y_ang . ((r - com) x f)] = y_ang x (r - com)
    out = dt * (
        y_lin[..., None, :] / m + jnp.cross(y_ang[..., None, :], arm)
    )
    return plan.cnt[..., None] * out


def bx_vec(plan: ContactPlan, X):
    """b_x(X): Delta-state targets for the force subproblem (centroidal.cpp:60-65)."""
    dX = X[..., 1:, :] - X[..., :-1, :]
    grav = jnp.zeros_like(dX[..., 3:9])
    grav = grav.at[..., 2].set(_G * plan.dt)
    rows = jnp.concatenate([jnp.zeros_like(dX[..., 0:3]), dX[..., 3:9] + grav], axis=-1)
    pad = jnp.zeros_like(rows[..., :1, :])
    return jnp.concatenate([rows, pad], axis=-2)


# --- X-subproblem operators:  A_f(F) X  and  b_f(F) ---


def af_apply(plan: ContactPlan, m: float, F, X):
    """A_f(F) @ X -> residual-space (..., H+1, 9).

    Rows t < H (centroidal.cpp:14-25, 86-101):
      com rows : com_t - com_{t+1} + dt * vcom_{t+1}
      vel rows : vcom_t - vcom_{t+1}
      ang rows : L_t - L_{t+1} + dt * (sum_n c f_n) x com_t
    Row H pins the initial state: X_0 (update_x_init, centroidal.hpp:22-27).
    """
    Xt, Xt1 = X[..., :-1, :], X[..., 1:, :]
    dt = plan.dt[..., None]
    cF_tot = jnp.sum(plan.cnt[..., None] * F, axis=-2)  # (..., H, 3)
    com_rows = Xt[..., 0:3] - Xt1[..., 0:3] + dt * Xt1[..., 3:6]
    vel_rows = Xt[..., 3:6] - Xt1[..., 3:6]
    ang_rows = Xt[..., 6:9] - Xt1[..., 6:9] + dt * jnp.cross(cF_tot, Xt[..., 0:3])
    rows = jnp.concatenate([com_rows, vel_rows, ang_rows], axis=-1)
    pin = X[..., 0:1, :]
    return jnp.concatenate([rows, pin], axis=-2)


def af_applyT(plan: ContactPlan, m: float, F, Y):
    """A_f(F)^T @ Y -> state-space (..., H+1, 9)."""
    yt = Y[..., :-1, :]  # (..., H, 9) knot-row blocks
    dt = plan.dt[..., None]
    cF_tot = jnp.sum(plan.cnt[..., None] * F, axis=-2)

    out = jnp.zeros_like(Y)
    # contributions to X_t from row block t (t < H)
    contrib_t = jnp.concatenate(
        [
            # d/dcom_t [y_ang . (g x com_t)] = g x y_ang ... y.(g x c) = c.(y x g)
            yt[..., 0:3] + dt * jnp.cross(yt[..., 6:9], cF_tot),
            yt[..., 3:6],
            yt[..., 6:9],
        ],
        axis=-1,
    )
    out = out.at[..., :-1, :].add(contrib_t)
    # contributions to X_{t+1} from row block t
    contrib_t1 = jnp.concatenate(
        [
            -yt[..., 0:3],
            dt * yt[..., 0:3] - yt[..., 3:6],
            -yt[..., 6:9],
        ],
        axis=-1,
    )
    out = out.at[..., 1:, :].add(contrib_t1)
    # pinning row -> X_0
    out = out.at[..., 0, :].add(Y[..., -1, :])
    return out


def bf_vec(plan: ContactPlan, m: float, F, x_init):
    """b_f(F): force-driven increments + initial state (centroidal.cpp:102-125)."""
    cF = plan.cnt[..., None] * F
    dt = plan.dt[..., None]
    lin = -dt * jnp.sum(cF, axis=-2) / m
    lin = lin.at[..., 2].add(_G * plan.dt)
    ang = dt * jnp.sum(jnp.cross(cF, plan.r), axis=-2)
    rows = jnp.concatenate([jnp.zeros_like(lin), lin, ang], axis=-1)
    return jnp.concatenate([rows, x_init[..., None, :]], axis=-2)


# --- constraint-operator diagonals (Jacobi preconditioners) ---


def af_diag(plan: ContactPlan, F):
    """diag(A_f(F)^T A_f(F)) -> (..., H+1, 9), closed form from the stencil.

    Per knot k and component group (com/vel/ang):
      com_i: 1_{k<H} (1 + dt_k^2 (|cF_k|^2 - cF_{k,i}^2)) + 1_{k>=1} + 1_{k=0}
      vel_i: 1_{k<H} + 1_{k>=1} (1 + dt_{k-1}^2) + 1_{k=0}
      ang_i: 1_{k<H} + 1_{k>=1} + 1_{k=0}
    (the cross-term columns are those of skew(cF_k); the k=0 extra 1 is the
    initial-state pinning row, which pins the FULL 9-vector X_0, so every
    component group gets it). Feeds the diagonal-metric FISTA step — the
    X-Hessian diag 2(W + rho*af_diag) spans ~1e-5..1e6 through W, which is
    exactly why the unpreconditioned step saturates its iteration cap."""
    cnt, dt = plan.cnt, plan.dt
    H = cnt.shape[-2]
    cF_tot = jnp.sum(cnt[..., None] * F, axis=-2)  # (..., H, 3)
    cf2 = jnp.sum(cF_tot * cF_tot, axis=-1, keepdims=True)  # (..., H, 1)
    dt2 = (dt * dt)[..., None]  # (..., H, 1)

    batch = cnt.shape[:-2]
    one = jnp.ones(batch + (H + 1, 3), dt.dtype)
    k_lt_H = jnp.concatenate([one[..., :H, :], jnp.zeros_like(one[..., :1, :])], -2)
    k_ge_1 = jnp.concatenate([jnp.zeros_like(one[..., :1, :]), one[..., :H, :]], -2)
    k_eq_0 = jnp.concatenate([one[..., :1, :], jnp.zeros_like(one[..., :H, :])], -2)

    cross_sq = dt2 * (cf2 - cF_tot * cF_tot)  # (..., H, 3)
    cross_sq = jnp.concatenate([cross_sq, jnp.zeros_like(cross_sq[..., :1, :])], -2)
    d_com = k_lt_H * (1.0 + cross_sq) + k_ge_1 + k_eq_0

    dt2_prev = jnp.concatenate([jnp.zeros_like(dt2[..., :1, :]), dt2], -2)
    d_vel = k_lt_H + k_ge_1 * (1.0 + dt2_prev) + k_eq_0
    d_ang = k_lt_H + k_ge_1 + k_eq_0
    return jnp.concatenate([d_com, d_vel, d_ang], axis=-1)


def ax_diag_iso(plan: ContactPlan, m: float, X):
    """Per-contact isotropic diag(A_x(X)^T A_x(X)) -> (..., H, n_eff, 1).

    Exact per-component diag is cnt * dt^2 (1/m^2 + |arm|^2 - arm_i^2);
    averaging over i keeps the metric isotropic within each 3-vector so the
    friction-cone projection stays exact in the scaled space."""
    arm = plan.r - X[..., :-1, None, 0:3]
    arm2 = jnp.sum(arm * arm, axis=-1, keepdims=True)
    dt2 = (plan.dt * plan.dt)[..., None, None]
    d = plan.cnt[..., None] * dt2 * (1.0 / (m * m) + 2.0 * arm2 / 3.0)
    return d


# --- dense materialization (for golden tests against the numpy/C++ twins) ---


def ax_dense(plan: ContactPlan, m: float, X):
    """Materialize A_x exactly as the reference lays it out (row-major knot
    blocks of 9, column-major force index 3*ne*t + 3*n + axis). Test-only."""
    import numpy as np

    cnt = np.asarray(plan.cnt)
    r = np.asarray(plan.r)
    dt = np.asarray(plan.dt)
    Xn = np.asarray(X)
    H, ne = cnt.shape[-2], cnt.shape[-1]
    A = np.zeros((9 * (H + 1), 3 * ne * H))
    for t in range(H):
        for n in range(ne):
            c = cnt[t, n]
            col = 3 * ne * t + 3 * n
            for k in range(3):
                A[9 * t + 3 + k, col + k] = c * dt[t] / m
            arm = Xn[t, 0:3] - r[t, n]
            A[9 * t + 6, col + 1] = c * arm[2] * dt[t]
            A[9 * t + 6, col + 2] = -c * arm[1] * dt[t]
            A[9 * t + 7, col + 0] = -c * arm[2] * dt[t]
            A[9 * t + 7, col + 2] = c * arm[0] * dt[t]
            A[9 * t + 8, col + 0] = c * arm[1] * dt[t]
            A[9 * t + 8, col + 1] = -c * arm[0] * dt[t]
    return A


def af_dense(plan: ContactPlan, m: float, F):
    """Materialize A_f in the reference layout. Test-only."""
    import numpy as np

    cnt = np.asarray(plan.cnt)
    dt = np.asarray(plan.dt)
    Fn = np.asarray(F)
    H, ne = cnt.shape[-2], cnt.shape[-1]
    A = np.zeros((9 * (H + 1), 9 * (H + 1)))
    for t in range(H):
        for l in range(9):
            A[9 * t + l, 9 * t + l] = 1.0
            A[9 * t + l, 9 * (t + 1) + l] = -1.0
        for k in range(3):
            A[9 * t + k, 9 * (t + 1) + 3 + k] = dt[t]
        ftot = (cnt[t][:, None] * Fn[t]).sum(0)
        A[9 * t + 6, 9 * t + 1] += -ftot[2] * dt[t]
        A[9 * t + 6, 9 * t + 2] += ftot[1] * dt[t]
        A[9 * t + 7, 9 * t + 0] += ftot[2] * dt[t]
        A[9 * t + 7, 9 * t + 2] += -ftot[0] * dt[t]
        A[9 * t + 8, 9 * t + 0] += -ftot[1] * dt[t]
        A[9 * t + 8, 9 * t + 1] += ftot[0] * dt[t]
    for l in range(9):
        A[9 * H + l, l] = 1.0
    return A
