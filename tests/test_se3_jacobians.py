"""Closed-form SE(3) Jacobians (utils/quat.py) vs autodiff of the chart maps.

These closed-form blocks are what an autodiff-free Riccati (a fused DDP
kernel) is built from, so their correctness is what would make it exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bunmpc_tpu.utils import quat as Q


def _exp(xi):
    p, q = Q.se3_integrate(
        jnp.zeros(3, xi.dtype),
        jnp.asarray([0.0, 0.0, 0.0, 1.0], xi.dtype),
        xi[0:3],
        xi[3:6],
    )
    return p, q


def _log(p, q):
    dv, dw = Q.se3_difference(
        jnp.zeros(3, p.dtype), jnp.asarray([0.0, 0.0, 0.0, 1.0], p.dtype), p, q
    )
    return jnp.concatenate([dv, dw])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_left_jacobian_matches_autodiff(seed):
    rng = np.random.default_rng(seed)
    xi = jnp.asarray(rng.normal(size=6) * (0.7 if seed else 1e-5))

    # Log(Exp(xi + d) * Exp(xi)^-1) = Jl6(xi) d + O(d^2)
    def g(d):
        p2, q2 = _exp(xi + d)
        p1, q1 = _exp(xi)
        # relative transform Exp(xi+d) * Exp(xi)^{-1}: X2 X1^{-1}
        q_rel = Q.quat_mul(q2, Q.quat_conj(q1))
        p_rel = p2 - Q.quat_to_rot(q_rel) @ p1  # X2 X1^{-1} = (R2 R1', p2 - R2 R1' p1)
        return _log(p_rel, q_rel)

    J_auto = jax.jacfwd(g)(jnp.zeros(6))
    J_closed = Q.se3_left_jacobian(xi[0:3], xi[3:6])
    np.testing.assert_allclose(np.asarray(J_closed), np.asarray(J_auto), atol=1e-7)


@pytest.mark.parametrize("seed", [0, 3])
def test_right_jacobian_matches_autodiff(seed):
    rng = np.random.default_rng(seed)
    xi = jnp.asarray(rng.normal(size=6) * 0.6)

    # Log(Exp(xi)^-1 Exp(xi + d)) = Jr6(xi) d + O(d^2)
    def g(d):
        p1, q1 = _exp(xi)
        p2, q2 = _exp(xi + d)
        dv, dw = Q.se3_difference(p1, q1, p2, q2)
        return jnp.concatenate([dv, dw])

    J_auto = jax.jacfwd(g)(jnp.zeros(6))
    J_closed = Q.se3_right_jacobian(xi[0:3], xi[3:6])
    np.testing.assert_allclose(np.asarray(J_closed), np.asarray(J_auto), atol=1e-7)


def test_jacobian_inverses():
    rng = np.random.default_rng(7)
    for scale in (1e-6, 0.3, 1.4):
        xi = jnp.asarray(rng.normal(size=6) * scale)
        Jl = Q.se3_left_jacobian(xi[0:3], xi[3:6])
        Jli = Q.se3_left_jacobian_inv(xi[0:3], xi[3:6])
        np.testing.assert_allclose(np.asarray(Jl @ Jli), np.eye(6), atol=1e-8)
        Jr = Q.se3_right_jacobian(xi[0:3], xi[3:6])
        Jri = Q.se3_right_jacobian_inv(xi[0:3], xi[3:6])
        np.testing.assert_allclose(np.asarray(Jr @ Jri), np.eye(6), atol=1e-8)


def test_adjoint_exp():
    """Ad(Exp(xi)) transports twists: Exp(-xi) Exp(d) Exp(xi) = Exp(Ad(Exp(-xi)) d)."""
    rng = np.random.default_rng(11)
    xi = jnp.asarray(rng.normal(size=6) * 0.8)

    def g(d):
        pm, qm = _exp(-xi)
        pd, qd = _exp(d)
        pp, qp = _exp(xi)
        # compose X = Exp(-xi) * Exp(d) * Exp(xi)
        def comp(pa, qa, pb, qb):
            Ra = Q.quat_to_rot(qa)
            return pa + Ra @ pb, Q.quat_mul(qa, qb)

        p1, q1 = comp(pm, qm, pd, qd)
        p2, q2 = comp(p1, q1, pp, qp)
        return _log(p2, q2)

    J_auto = jax.jacfwd(g)(jnp.zeros(6))
    Ad = Q.se3_adjoint_exp(-xi[0:3], -xi[3:6])
    np.testing.assert_allclose(np.asarray(Ad), np.asarray(J_auto), atol=1e-7)
