"""JAX-vs-native (C++) golden parity tests for the solver core.

The modern incarnation of the reference's C++-vs-Python twin checks
(reference examples/dynamics/cpp_centroidal.py:27-31): the independent
dependency-free C++17 library in bunmpc_tpu/native must agree with the
batched JAX kernels on operators exactly and on full ADMM solves to solver
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bunmpc_tpu.mpc import centroidal as cd
from bunmpc_tpu.native import bindings as nat
from bunmpc_tpu.solvers import biconvex, fista

pytestmark = pytest.mark.skipif(not nat.available(), reason="no C++ toolchain")

H, NE, M = 12, 4, 2.5


@pytest.fixture()
def problem():
    rng = np.random.default_rng(3)
    cnt = (rng.random((H, NE)) > 0.4).astype(float)
    r = rng.normal(size=(H, NE, 3)) * 0.2
    dts = np.full(H, 0.05)
    X = rng.normal(size=(H + 1, 9))
    F = rng.normal(size=(H, NE, 3))
    return cnt, r, dts, X, F


def test_operator_parity(problem):
    cnt, r, dts, X, F = problem
    plan = cd.ContactPlan(cnt=jnp.asarray(cnt), r=jnp.asarray(r), dt=jnp.asarray(dts))
    np.testing.assert_allclose(
        np.asarray(cd.ax_apply(plan, M, jnp.asarray(X), jnp.asarray(F))),
        nat.ax_apply(cnt, r, dts, M, X, F),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(cd.af_apply(plan, M, jnp.asarray(F), jnp.asarray(X))),
        nat.af_apply(cnt, r, dts, M, F, X),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(cd.bx_vec(plan, jnp.asarray(X))),
        nat.bx_vec(cnt, r, dts, M, X),
        atol=1e-12,
    )
    x_init = X[0]
    np.testing.assert_allclose(
        np.asarray(cd.bf_vec(plan, M, jnp.asarray(F), jnp.asarray(x_init))),
        nat.bf_vec(cnt, r, dts, M, F, x_init),
        atol=1e-12,
    )


def test_soc_projection_parity():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(64, 3)) * 10
    mine = np.asarray(fista.soc_projector(0.7, "exact")(jnp.asarray(z)))
    theirs = nat.soc_project(z, 0.7)
    np.testing.assert_allclose(mine, theirs, atol=1e-12)


def test_admm_solve_parity(problem):
    """Full biconvex solves from both implementations must agree on the
    optimized trajectory within solver tolerance (BASELINE.md: <1e-3
    deviation target at matched configs)."""
    cnt, r, dts, X, F = problem
    rng = np.random.default_rng(11)
    x_init = np.array([0.0, 0.0, 0.2, 0, 0, 0, 0, 0, 0])
    X_ref = np.tile(np.array([0.0, 0.0, 0.2, 0, 0, 0, 0, 0, 0]), (H + 1, 1))
    W = np.tile(np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]), (H + 1, 1))
    W[-1] = 10 * np.array([1e5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5])
    W_F = np.full((H, NE, 3), 1e1)
    X_wm = np.tile(x_init, (H + 1, 1))
    F_wm = np.zeros((H, NE, 3))

    Xn, Fn, vn, itn = nat.biconvex_solve(
        cnt, r, dts, M, x_init, W.reshape(-1), X_ref.reshape(-1), W_F.reshape(-1),
        5e4, X_wm.reshape(-1), F_wm.reshape(-1),
    )
    assert vn < 1e-3

    plan = cd.ContactPlan(cnt=jnp.asarray(cnt), r=jnp.asarray(r), dt=jnp.asarray(dts))
    # reference schedule (the C++ golden implements plain dual ascent)
    cfg = biconvex.BiconvexConfig(
        rho=5e4, step_mode="linesearch", dual_relax=1.0, rho_growth=1.0, x_solver="fista"
    )
    res = biconvex.solve(
        plan,
        M,
        jnp.asarray(x_init),
        biconvex.CostX(W=jnp.asarray(W), X_ref=jnp.asarray(X_ref)),
        jnp.asarray(W_F),
        jnp.asarray(X_wm),
        jnp.asarray(F_wm),
        jnp.zeros((H + 1, 9)),
        cfg,
    )
    assert float(res.viol_norm) < 1e-3
    # both converge to the same biconvex fixed point
    np.testing.assert_allclose(
        np.asarray(res.X), Xn.reshape(H + 1, 9), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res.F), Fn.reshape(H, NE, 3), atol=5e-2
    )

    # the power-iteration (hot path) mode reaches the same solution
    res2 = biconvex.solve(
        plan,
        M,
        jnp.asarray(x_init),
        biconvex.CostX(W=jnp.asarray(W), X_ref=jnp.asarray(X_ref)),
        jnp.asarray(W_F),
        jnp.asarray(X_wm),
        jnp.asarray(F_wm),
        jnp.zeros((H + 1, 9)),
        biconvex.BiconvexConfig(
            rho=5e4, step_mode="power", dual_relax=1.0, rho_growth=1.0, x_solver="fista"
        ),
    )
    np.testing.assert_allclose(np.asarray(res2.X), Xn.reshape(H + 1, 9), atol=2e-3)


def test_gait_planner_parity():
    """JAX gait phase machine vs the native twin over a dense time grid."""
    import jax.numpy as jnp

    from bunmpc_tpu.mpc import gait as G

    g = G.GaitParams(0.5, (0.6, 0.6, 0.6, 0.6), (0.0, 0.5, 0.5, 0.0), 0.05, 0.075)
    ts = np.linspace(0.0, 1.5, 301)
    mine = np.asarray(G.in_stance(g, jnp.asarray(ts))).astype(int)
    for j in range(4):
        theirs = np.array(
            [nat.gait_phase(t, 0.5, g.phase_offset[j], 0.6) for t in ts]
        )
        np.testing.assert_array_equal(mine[:, j], theirs)
    # horizon plan
    plan_nat = nat.gait_contact_plan(0.12, 0.05, 20, 0.5, g.phase_offset, g.stance_percent)
    plan_jax = np.asarray(G.contact_phase_plan(g, jnp.asarray(0.12), 20, 0.05)).astype(int)
    np.testing.assert_array_equal(plan_jax, plan_nat)
