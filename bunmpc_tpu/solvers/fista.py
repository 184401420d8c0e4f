"""Batched projected FISTA (accelerated proximal gradient) in JAX.

JAX twin of the reference solver (reference src/solvers/fista.cpp:6-70,
include/solvers/fista.hpp:15-61): backtracking line search with monotone
Lipschitz growth ``L <- beta*L``, Nesterov momentum, box projection, optional
per-3-vector friction-cone (second-order cone) projection for contact forces.

Batched semantics: every quantity that is a scalar in the reference (L, t_k,
convergence flag) becomes a per-problem array over the leading batch
dimensions; data-dependent loops become ``lax.while_loop`` with convergence
masks so a whole batch retires together (fixed shapes, one XLA program).

Conscious deviations from the reference (SURVEY.md §7.5):
* momentum: the reference computes ``t_{k+1} = 1 + sqrt(1+4t_k^2)/2``
  (fista.cpp:34) — the textbook Nesterov rule is ``(1+sqrt(1+4t_k^2))/2``.
  Both converge to the same fixed point; we default to the reference variant
  for trajectory parity and expose ``momentum='textbook'``.
* SoC projection: the reference projects with the *squared* tangential norm
  (fista.cpp:59 uses ``squaredNorm``) which is dimensionally inconsistent; we
  default to the mathematically correct Euclidean-norm cone projection and
  expose ``soc_mode='reference'`` for bit-parity experiments.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FistaConfig:
    max_iters: int = 150
    tol: float = 1e-5
    beta: float = 1.5
    max_linesearch: int = 30
    momentum: str = "reference"  # or "textbook"
    soc_mode: str = "exact"  # or "reference"


class FistaResult(NamedTuple):
    x: jnp.ndarray  # solution, batch_shape + var_shape
    L: jnp.ndarray  # final per-problem Lipschitz estimates
    iters: jnp.ndarray  # per-problem iterations used
    g_norm: jnp.ndarray  # final proximal-gradient norms


def _vdot(a, b, n_var_dims):
    axes = tuple(range(-n_var_dims, 0))
    return jnp.sum(a * b, axis=axes)


def box_projector(lb, ub):
    """Projection onto [lb, ub] (reference fista.cpp:10)."""

    def proj(z):
        return jnp.clip(z, lb, ub)

    return proj


def soc_projector(mu: float, mode: str = "exact"):
    """Per-3-vector projection onto the friction cone ||f_xy|| <= mu * f_z.

    Operates on the trailing axis of a (..., 3) force layout
    (reference fista.cpp:52-70). ``mode='reference'`` replicates the
    squared-norm quirk of the reference implementation.
    """

    def proj(z):
        fxy = z[..., 0:2]
        fz = z[..., 2]
        sq = jnp.sum(fxy * fxy, axis=-1)
        s = sq if mode == "reference" else jnp.sqrt(sq)
        # region 1: inside the cone -> identity
        inside = s <= mu * fz
        # region 2: inside the polar cone -> project to origin. The reference
        # additionally zeroes any fz<0 point (fista.cpp:62) — that is part of
        # its squared-norm quirk, only reproduced in mode='reference'.
        polar = (mu * s <= -fz) if mode == "exact" else ((mu * s <= -fz) | (fz < 0))
        # region 3: project onto the cone surface
        s_safe = jnp.where(s > 0, s, 1.0)
        coef = ((mu * mu) * s + mu * fz) / (((mu * mu) + 1.0) * s_safe)
        fxy_proj = fxy * coef[..., None]
        fz_proj = (mu * s + fz) / (mu * mu + 1.0)
        proj_surface = jnp.concatenate([fxy_proj, fz_proj[..., None]], axis=-1)
        zero = jnp.zeros_like(z)
        out = jnp.where(inside[..., None], z, proj_surface)
        out = jnp.where((polar & ~inside)[..., None], zero, out)
        return out

    return proj


def power_iteration_L(matvec: Callable, shape, dtype, n_var_dims: int, iters: int = 8, safety: float = 1.25):
    """Largest-eigenvalue estimate of a PSD operator via power iteration.

    Replaces the reference's backtracking line search (fista.cpp:6-27) with a
    direct Lipschitz estimate: one bounded ``fori_loop`` of operator
    applications instead of a data-dependent nested loop — the same fixed
    point, dramatically cheaper XLA compile and a fixed, predictable step
    size. ``matvec`` must be linear PSD; batch dims = shape[:-n_var_dims].
    """
    z0 = jnp.ones(shape, dtype)

    def body(_, z):
        w = matvec(z)
        nrm = jnp.sqrt(_vdot(w, w, n_var_dims))
        return (w / (nrm.reshape(nrm.shape + (1,) * n_var_dims) + 1e-30)).astype(dtype)

    z = jax.lax.fori_loop(0, iters, body, z0)
    w = matvec(z)
    lam = _vdot(z, w, n_var_dims) / (_vdot(z, z, n_var_dims) + 1e-30)
    return safety * lam


def solve_diag_step(
    x0: jnp.ndarray,
    grad_fn: Callable,
    proj_fn: Callable,
    D,  # per-coordinate step metric, broadcastable to x0 (D >= Hessian)
    cfg: FistaConfig,
    n_var_dims: int = 1,
) -> FistaResult:
    """Projected FISTA in a diagonal metric: y <- proj(y - grad / D).

    With D = lam_max(D0^{-1/2} H D0^{-1/2}) * safety * D0 for a Jacobi
    estimate D0 of diag(H), this is plain FISTA on the variable z = D^{1/2} x
    — valid for box projections (separable per coordinate) and for friction
    cones when D is isotropic within each 3-vector (cone invariant under a
    uniform scaling). Cuts the effective condition number by the diagonal
    spread of H (~1e6 for the X subproblem, which is why the scalar-step
    variant saturates its iteration cap)."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    dtype = x0.dtype
    D = jnp.broadcast_to(jnp.asarray(D, dtype), x0.shape)

    def expand(s):
        return s.reshape(s.shape + (1,) * n_var_dims)

    def cond(carry):
        it, done = carry[-2], carry[-1]
        return jnp.logical_and(~jnp.all(done), it < cfg.max_iters)

    def body(carry):
        x_k, y_k, t_k, g_norm, iters, it, done = carry
        grad = grad_fn(y_k)
        y_next = proj_fn(y_k - grad / D)
        g = jnp.sqrt(_vdot(y_next - y_k, y_next - y_k, n_var_dims))
        diff = y_next - x_k
        if cfg.momentum == "reference":
            t_next = 1.0 + jnp.sqrt(1.0 + 4.0 * t_k * t_k) / 2.0
        else:
            t_next = (1.0 + jnp.sqrt(1.0 + 4.0 * t_k * t_k)) / 2.0
        y_mom = y_next + expand((t_k - 1.0) / t_next) * diff

        upd = expand(~done)
        x_k = jnp.where(upd, y_next, x_k)
        y_k = jnp.where(upd, y_mom, y_k)
        t_k = jnp.where(~done, t_next, t_k)
        g_norm = jnp.where(~done, g, g_norm)
        iters = jnp.where(~done, it + 1, iters)
        done = done | (g_norm < cfg.tol)
        return x_k, y_k, t_k, g_norm, iters, it + 1, done

    t0 = jnp.ones(batch_shape, dtype)
    g0 = jnp.full(batch_shape, jnp.inf, dtype)
    done0 = jnp.zeros(batch_shape, bool)
    iters0 = jnp.zeros(batch_shape, jnp.int32)
    x, _, _, g_norm, iters, _, _ = jax.lax.while_loop(
        cond, body, (x0, x0, t0, g0, iters0, jnp.zeros((), jnp.int32), done0)
    )
    return FistaResult(x=x, L=jnp.max(D, axis=tuple(range(-n_var_dims, 0))), iters=iters, g_norm=g_norm)


def solve_fixed_step(
    x0: jnp.ndarray,
    grad_fn: Callable,
    proj_fn: Callable,
    L,
    cfg: FistaConfig,
    n_var_dims: int = 1,
) -> FistaResult:
    """Projected FISTA with a fixed step 1/L (L from ``power_iteration_L``).

    Single bounded ``while_loop`` with per-problem convergence masks — the
    accelerator-friendly variant of :func:`solve` (no nested line-search
    loop)."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    dtype = x0.dtype
    L = jnp.broadcast_to(jnp.asarray(L, dtype), batch_shape)

    def expand(s):
        return s.reshape(s.shape + (1,) * n_var_dims)

    def cond(carry):
        it, done = carry[-2], carry[-1]
        return jnp.logical_and(~jnp.all(done), it < cfg.max_iters)

    def body(carry):
        x_k, y_k, t_k, g_norm, iters, it, done = carry
        grad = grad_fn(y_k)
        y_next = proj_fn(y_k - grad / expand(L))
        g = jnp.sqrt(_vdot(y_next - y_k, y_next - y_k, n_var_dims))
        diff = y_next - x_k
        if cfg.momentum == "reference":
            t_next = 1.0 + jnp.sqrt(1.0 + 4.0 * t_k * t_k) / 2.0
        else:
            t_next = (1.0 + jnp.sqrt(1.0 + 4.0 * t_k * t_k)) / 2.0
        y_mom = y_next + expand((t_k - 1.0) / t_next) * diff

        upd = expand(~done)
        x_k = jnp.where(upd, y_next, x_k)
        y_k = jnp.where(upd, y_mom, y_k)
        t_k = jnp.where(~done, t_next, t_k)
        g_norm = jnp.where(~done, g, g_norm)
        iters = jnp.where(~done, it + 1, iters)
        done = done | (g_norm < cfg.tol)
        return x_k, y_k, t_k, g_norm, iters, it + 1, done

    t0 = jnp.ones(batch_shape, dtype)
    g0 = jnp.full(batch_shape, jnp.inf, dtype)
    done0 = jnp.zeros(batch_shape, bool)
    iters0 = jnp.zeros(batch_shape, jnp.int32)
    x, _, _, g_norm, iters, _, _ = jax.lax.while_loop(
        cond, body, (x0, x0, t0, g0, iters0, jnp.zeros((), jnp.int32), done0)
    )
    return FistaResult(x=x, L=L, iters=iters, g_norm=g_norm)


def solve(
    x0: jnp.ndarray,
    grad_fn: Callable,
    obj_diff_fn: Callable,
    proj_fn: Callable,
    L0,
    cfg: FistaConfig,
    n_var_dims: int = 1,
) -> FistaResult:
    """Minimize f(x) over the projection set, batched.

    ``grad_fn(y)`` -> gradient of the smooth objective at y,
    ``obj_diff_fn(y1, y0)`` -> f(y1) - f(y0) per problem (the reference's
    objective-difference trick, problem.cpp:46-51),
    ``proj_fn(z)`` -> projection of z.
    Batch dims = x0.shape[:-n_var_dims].
    """
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    dtype = x0.dtype
    L0 = jnp.broadcast_to(jnp.asarray(L0, dtype), batch_shape)

    def expand(s):
        return s.reshape(s.shape + (1,) * n_var_dims)

    def line_search(y_k, L, skip):
        """Per-problem backtracking (reference compute_step_length, fista.cpp:6-27).
        ``skip`` marks already-converged problems whose L must not keep growing."""
        grad = grad_fn(y_k)

        def trial(L):
            y_try = proj_fn(y_k - grad / expand(L))
            diff = y_try - y_k
            rhs = _vdot(grad, diff, n_var_dims) + 0.5 * L * _vdot(diff, diff, n_var_dims)
            ok = obj_diff_fn(y_try, y_k) <= rhs
            return y_try, ok

        y_first, ok_first = trial(L)
        ok_first = ok_first | skip

        def cond(carry):
            _, _, accepted, it = carry
            return jnp.logical_and(~jnp.all(accepted), it < cfg.max_linesearch)

        def body(carry):
            y_best, L, accepted, it = carry
            L_new = jnp.where(accepted, L, L * cfg.beta)
            y_try, ok = trial(L_new)
            y_best = jnp.where(expand(accepted), y_best, y_try)
            return y_best, L_new, accepted | ok, it + 1

        y_best, L, accepted, _ = jax.lax.while_loop(
            cond, body, (y_first, L, ok_first, jnp.zeros((), jnp.int32))
        )
        return y_best, L, grad

    def cond(carry):
        it, done = carry[-2], carry[-1]
        return jnp.logical_and(~jnp.all(done), it < cfg.max_iters)

    def body(carry):
        x_k, y_k, L, t_k, g_norm, iters, it, done = carry
        y_next, L_new, _ = line_search(y_k, L, done)
        x_next = y_next
        diff = x_next - x_k
        g = jnp.sqrt(_vdot(y_next - y_k, y_next - y_k, n_var_dims))
        if cfg.momentum == "reference":
            t_next = 1.0 + jnp.sqrt(1.0 + 4.0 * t_k * t_k) / 2.0
        else:
            t_next = (1.0 + jnp.sqrt(1.0 + 4.0 * t_k * t_k)) / 2.0
        y_mom = x_next + expand((t_k - 1.0) / t_next) * diff

        upd = expand(~done)
        x_k = jnp.where(upd, x_next, x_k)
        y_k = jnp.where(upd, y_mom, y_k)
        L = jnp.where(~done, L_new, L)
        t_k = jnp.where(~done, t_next, t_k)
        g_norm = jnp.where(~done, g, g_norm)
        iters = jnp.where(~done, it + 1, iters)
        it = it + 1
        done = done | (g_norm < cfg.tol)
        return x_k, y_k, L, t_k, g_norm, iters, it, done

    t0 = jnp.ones(batch_shape, dtype)
    g0 = jnp.full(batch_shape, jnp.inf, dtype)
    done0 = jnp.zeros(batch_shape, bool)
    iters0 = jnp.zeros(batch_shape, jnp.int32)
    x, _, L, _, g_norm, iters, _, _ = jax.lax.while_loop(
        cond, body, (x0, x0, L0, t0, g0, iters0, jnp.zeros((), jnp.int32), done0)
    )
    return FistaResult(x=x, L=L, iters=iters, g_norm=g_norm)
