"""Golden tests: structured/analytic IK Gauss-Newton Jacobians
(mpc/ik.py::build_jacobian_fns) vs the brute-force tangent-space autodiff
oracle (the original ddp.solve path). Equivalence here guarantees the fast
path computes the exact same DDP steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bunmpc_tpu.mpc import ik as IK
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.solvers import ddp


@pytest.fixture(scope="module")
def setup():
    model = Solo12Config.load_model()
    eff = Solo12Config.eff_names
    H = 5
    rng = np.random.default_rng(3)
    nq, nv = model.nq, model.nv
    x_reg = np.concatenate([Solo12Config.q0(), np.zeros(nv)])
    tasks = IK.IkTasks(
        ee_targets=jnp.asarray(rng.normal(size=(H, 4, 3)) * 0.1),
        ee_wts=jnp.asarray(rng.uniform(0.5, 2.0, size=(H, 4))),
        com_ref=jnp.asarray(rng.normal(size=(H + 1, 3)) * 0.05),
        mom_ref=jnp.asarray(rng.normal(size=(H + 1, 6)) * 0.05),
        com_wt=jnp.asarray(3.0),
        mom_wt=jnp.asarray(2.0),
        state_wt=jnp.asarray(rng.uniform(0.1, 1.0, size=2 * nv)),
        x_reg=jnp.asarray(x_reg),
        reg_wt_state=0.7,
        reg_wt_ctrl=1e-4,
        ctrl_wt=jnp.asarray(rng.uniform(0.1, 1.0, size=nv)),
        dts=jnp.full(H, 0.05),
    )
    q = np.asarray(Solo12Config.q0()).copy()
    q[0:3] += rng.normal(size=3) * 0.1
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)
    q[7:] += rng.normal(size=12) * 0.3
    v = rng.normal(size=nv) * 0.5
    x = jnp.asarray(np.concatenate([q, v]))
    u = jnp.asarray(rng.normal(size=nv))
    return model, eff, tasks, x, u


def _oracle_jacobians(model, eff, tasks, x, u, k):
    """Replicates ddp.solve's internal autodiff Jacobians."""
    stage, term, _ = IK.build_residual_fns(model, eff, tasks)
    nv = model.nv
    ndx = 2 * nv
    dt = tasks.dts[k]

    def r_of_dx(dx):
        r, w = stage(ddp._perturb(model, x, dx), k)
        return r, w

    Jr, w = jax.jacfwd(r_of_dx, has_aux=True)(jnp.zeros(ndx, x.dtype))
    x_next = ddp._step(model, x, u, dt)

    def f_of_dxu(dxu):
        return ddp._state_diff(
            model, x_next, ddp._step(model, ddp._perturb(model, x, dxu[:ndx]), u + dxu[ndx:], dt)
        )

    Jf = jax.jacfwd(f_of_dxu)(jnp.zeros(ndx + nv, x.dtype))

    def rt_of_dx(dx):
        return term(ddp._perturb(model, x, dx))[0]

    Jt = jax.jacfwd(rt_of_dx)(jnp.zeros(ndx, x.dtype))
    return Jr, w, Jf[:, :ndx], Jf[:, ndx:], Jt


def test_stage_jacobians_match_autodiff(setup):
    model, eff, tasks, x, u = setup
    sj, tj = IK.build_jacobian_fns(model, eff, tasks)
    for k in [0, 2, 4]:
        Jr_a, w_a, Fx_a, Fu_a = sj(x, u, jnp.asarray(k))
        Jr_o, w_o, Fx_o, Fu_o, Jt_o = _oracle_jacobians(model, eff, tasks, x, u, k)
        np.testing.assert_allclose(np.asarray(Jr_a), np.asarray(Jr_o), atol=1e-9)
        np.testing.assert_allclose(np.asarray(w_a), np.asarray(w_o), atol=1e-12)
        np.testing.assert_allclose(np.asarray(Fx_a), np.asarray(Fx_o), atol=1e-9)
        np.testing.assert_allclose(np.asarray(Fu_a), np.asarray(Fu_o), atol=1e-9)
    Jt_a = tj(x)
    np.testing.assert_allclose(np.asarray(Jt_a), np.asarray(Jt_o), atol=1e-9)


@pytest.mark.slow
def test_solve_ik_same_solution_both_paths(setup):
    model, eff, tasks, x, u = setup
    x0 = jnp.asarray(np.concatenate([Solo12Config.q0(), np.zeros(model.nv)]))
    res_fast = IK.solve_ik(model, eff, x0, tasks, analytic_jacobians=True)
    res_oracle = IK.solve_ik(model, eff, x0, tasks, analytic_jacobians=False)
    np.testing.assert_allclose(
        np.asarray(res_fast.xs), np.asarray(res_oracle.xs), atol=1e-8
    )
    np.testing.assert_allclose(float(res_fast.cost), float(res_oracle.cost), rtol=1e-10)


def test_dense_weights_match_residual_fns(setup):
    """dense_weights (the native twin's weight layout) reproduces
    build_residual_fns' per-row weights."""
    model, eff, tasks, x, _ = setup
    stage, term, ctrl_w_ref = IK.build_residual_fns(model, eff, tasks)
    w_stage, w_term, ctrl_w, _ = IK.dense_weights(model, eff, tasks)
    for k in range(tasks.dts.shape[0]):
        _, w_k = stage(x, k)
        np.testing.assert_allclose(np.asarray(w_stage[k]), np.asarray(w_k), rtol=1e-6)
    _, w_t = term(x)
    np.testing.assert_allclose(np.asarray(w_term), np.asarray(w_t), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ctrl_w), np.asarray(ctrl_w_ref), rtol=1e-6)
