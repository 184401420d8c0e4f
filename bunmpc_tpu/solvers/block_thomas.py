"""Exact block-tridiagonal solve of the ADMM X-subproblem.

The X-subproblem of the biconvex ADMM (reference biconvex.cpp:90-96 solves it
with up to 150 projected-FISTA iterations) is an equality-free QP

    min_X  (X-X_ref)' W (X-X_ref) + rho ||A_f(F) X - (b_f - P)||^2

whose normal matrix  M = 2 W + 2 rho A_f' A_f  is **block tridiagonal** in the
knot index: A_f is block *bidiagonal* (each constraint row couples knots t and
t+1, centroidal.cpp:14-25) plus one pinning row that touches only X_0
(update_x_init, centroidal.hpp:22-27). A single block-Thomas sweep — H+1
forward Cholesky factorizations of 9x9 blocks + a back-substitution — solves
it **exactly**, replacing the iteration-depth-bound FISTA inner loop (the
round-2 roofline showed the whole solve at <5% of chip peaks precisely because
of that sequential depth).

Block structure (X_k = [com, vcom, amom], G_k = dt_k * skew(sum_n c f_n)):

    row-block t (t<H):  D_t = [[I,0,0],[0,I,0],[G_t,0,I]]   at column t
                        E_t = [[-I, dt_t I, 0],[0,-I,0],[0,0,-I]] at column t+1
    pin row:            I at column 0

    M_k = 2 W_k + 2 rho ( 1_{k<H} D_k'D_k + 1_{k>0} E_{k-1}'E_{k-1} + 1_{k=0} I )
    U_k = 2 rho D_k'E_k          (coupling k -> k+1)

      D'D = [[I+G'G, 0, G'],[0,I,0],[G,0,I]]
      E'E = [[I, -dt I, 0],[-dt I, (1+dt^2) I, 0],[0,0,I]]
      D'E = [[-I, dt I, -G'],[0,-I,0],[0,0,-I]]

The kinematic CoM box (create_bound_constraints, biconvex.cpp:48-56) is a
+-0.45 m corridor around the support polygon and is inactive on nominal gait
problems; callers clip the exact solution to the box (see biconvex.solve
x_solver="thomas") which is exact whenever no bound is active.

All functions are single-sample over the knot axis and broadcast over leading
batch axes; `jax.vmap` is NOT required.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..mpc import centroidal as cd


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], -1),
            jnp.stack([v[..., 2], z, -v[..., 0]], -1),
            jnp.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        -2,
    )


def x_normal_blocks(plan: cd.ContactPlan, F, W, rho):
    """Blocks of M = 2W + 2 rho A_f'A_f and U (super-diagonal couplings).

    Returns (M, U): M (..., H+1, 9, 9), U (..., H, 9, 9) with
    M[k] = M_k, U[k] = 2 rho D_k' E_k. ``rho`` broadcasts over batch axes
    ((...,) or scalar); W is the (..., H+1, 9) diagonal cost.
    """
    cnt, dt = plan.cnt, plan.dt
    H = cnt.shape[-2]
    dtype = F.dtype
    batch = jnp.broadcast_shapes(cnt.shape[:-2], F.shape[:-3])

    cF = jnp.sum(cnt[..., None] * F, axis=-2)  # (..., H, 3)
    G = dt[..., None, None] * _skew(cF)  # (..., H, 3, 3)
    I3 = jnp.eye(3, dtype=dtype)
    Z3 = jnp.zeros(batch + (H, 3, 3), dtype)
    I3h = jnp.broadcast_to(I3, batch + (H, 3, 3))

    def b9(b00, b01, b02, b10, b11, b12, b20, b21, b22):
        top = jnp.concatenate([b00, b01, b02], axis=-1)
        mid = jnp.concatenate([b10, b11, b12], axis=-1)
        bot = jnp.concatenate([b20, b21, b22], axis=-1)
        return jnp.concatenate([top, mid, bot], axis=-2)

    GtG = jnp.einsum("...ji,...jk->...ik", G, G)
    Gt = jnp.swapaxes(G, -1, -2)
    dtI = dt[..., None, None] * I3h

    DtD = b9(I3h + GtG, Z3, Gt, Z3, I3h, Z3, G, Z3, I3h)  # (..., H, 9, 9)
    EtE = b9(
        I3h, -dtI, Z3,
        -dtI, (1.0 + (dt * dt)[..., None, None]) * I3h, Z3,
        Z3, Z3, I3h,
    )
    DtE = b9(-I3h, dtI, -Gt, Z3, -I3h, Z3, Z3, Z3, -I3h)

    rho_b = jnp.asarray(rho, dtype)[..., None, None, None]
    zpad = jnp.zeros(batch + (1, 9, 9), dtype)
    # 1_{k<H} D'D  +  1_{k>0} E'E  +  1_{k=0} I
    AtA = (
        jnp.concatenate([DtD, zpad], axis=-3)
        + jnp.concatenate([zpad, EtE], axis=-3)
    )
    AtA = AtA.at[..., 0, :, :].add(jnp.eye(9, dtype=dtype))
    Wdiag = W[..., None] * jnp.eye(9, dtype=dtype)
    M = 2.0 * Wdiag + 2.0 * rho_b * AtA
    U = 2.0 * rho_b * DtE
    return M, U


def solve_block_tridiag(M, U, rhs):
    """Solve the SPD block-tridiagonal system  diag(M) + super/sub-diag(U, U')
    against ``rhs``.

    M: (..., K, n, n), U: (..., K-1, n, n) couplings k->k+1, rhs (..., K, n).
    Block-Thomas with per-block Cholesky; the knot scan is sequential (K ~ 21
    for the trot window), everything else broadcasts over the batch axes.

    All matmuls are pinned to full float32 precision: a reduced-precision
    f32 dot (TF32 on the GPU) is catastrophic here — the 9x9 Cholesky
    factors lose positive-definiteness and the "exact" solve (and with it the
    whole ADMM) diverges to NaN on heavy robots while the same f32 program
    converges at full precision.
    """
    K = M.shape[-3]
    prec = jax.lax.Precision.HIGHEST

    def fwd(carry, inp):
        Cprev_chol, dprev = carry  # chol(C_{k-1}), C_{k-1}^{-1}-applied y
        Mk, Uk_prev, rk = inp
        # C_k = M_k - U' C^{-1} U ; y_k = r_k - U' C^{-1} y_{k-1}
        CiU = jax.scipy.linalg.cho_solve((Cprev_chol, True), Uk_prev)
        Ck = Mk - jnp.einsum("...ji,...jk->...ik", Uk_prev, CiU, precision=prec)
        yk = rk - jnp.einsum("...ji,...j->...i", Uk_prev, dprev, precision=prec)
        Ck_chol = jnp.linalg.cholesky(Ck)
        dk = jax.scipy.linalg.cho_solve((Ck_chol, True), yk)
        return (Ck_chol, dk), (Ck_chol, dk)

    C0_chol = jnp.linalg.cholesky(M[..., 0, :, :])
    d0 = jax.scipy.linalg.cho_solve((C0_chol, True), rhs[..., 0, :])

    # scan over the knot axis: move it to the front
    Ms = jnp.moveaxis(M, -3, 0)[1:]
    Us = jnp.moveaxis(U, -3, 0)
    rs = jnp.moveaxis(rhs, -2, 0)[1:]
    (_, _), (chols, ds) = jax.lax.scan(fwd, (C0_chol, d0), (Ms, Us, rs))
    chols = jnp.concatenate([C0_chol[None], chols], axis=0)  # (K, ..., n, n)
    ds = jnp.concatenate([d0[None], ds], axis=0)  # (K, ..., n)

    def bwd(x_next, inp):
        chol_k, dk, Uk = inp
        # x_k = d_k - C_k^{-1} U_k x_{k+1}
        xk = dk - jax.scipy.linalg.cho_solve(
            (chol_k, True), jnp.einsum("...ij,...j->...i", Uk, x_next, precision=prec)
        )
        return xk, xk

    xK = ds[K - 1]
    _, xs_rev = jax.lax.scan(
        bwd, xK, (chols[: K - 1][::-1], ds[: K - 1][::-1], Us[::-1])
    )
    X = jnp.concatenate([xs_rev[::-1], xK[None]], axis=0)
    return jnp.moveaxis(X, 0, -2)


def solve_x_exact(plan: cd.ContactPlan, m, F, W, X_ref, P, rho, x_init):
    """Exact minimizer of the (unbounded) X-subproblem.

    rhs = 2 W X_ref + 2 rho A_f'(b_f - P); returns (..., H+1, 9).
    """
    M, U = x_normal_blocks(plan, F, W, rho)
    b = cd.bf_vec(plan, m, F, x_init)
    rho_b = jnp.asarray(rho, F.dtype)[..., None, None]
    rhs = 2.0 * W * X_ref + 2.0 * rho_b * cd.af_applyT(plan, m, F, b - P)
    return solve_block_tridiag(M, U, rhs)
