"""Independent problem-assembly parity: native C++ twin vs the JAX layer.

VERDICT round-3 task 4: the e2e golden test chains both solver
implementations through the SAME ``KD._prepare_problem``/``_build_ik_tasks``,
so a shared misreading of the reference's contact planner / cost builder
(reference abstract_cyclic_gen.py:159-414 create_cnt_plan, :532-614
create_costs, src/motion_planner/biconvex.cpp:27-57 bounds) would pass every
test. This module closes that hole: ``bunmpc_prepare_problem``
(native/src/bunmpc_plan.cpp) re-implements the WHOLE assembly layer straight
from the reference's loops — offsets and composite inertia computed natively
from q0, FK/centroidal state from the native kinematics — and is compared
against the JAX layer from raw ``(q, v, t, v_des, w_des)`` at several
(t, cmd) points including mid-swing t and w_des != 0.

Two documented JAX deviations are exercised explicitly:
* np.round(...,3) on com/feet/ft (JAX does not round): native ``round3=0``
  matches exactly; ``round3=1`` must stay within the 5e-4 rounding bound.
* X_nom's y row anchor (reference: stale buffer = 0.0 on first call; JAX:
  current CoM y like the x row): the test measures the effect and asserts
  it is below the 1e-3 materiality bound claimed in kino_dyn.py.

Finally the full chain raw -> plan -> costs -> ADMM -> IK runs through the
native pipeline ONLY (prepare_problem + kinodyn_solve) and is compared to
the JAX ``solve_mpc`` outputs at the <1e-3 north-star gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bunmpc_tpu.mpc import ik as IK
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.solvers import biconvex, ddp

native = pytest.importorskip("bunmpc_tpu.native.bindings")
if not native.available():
    pytest.skip("native library unavailable", allow_module_level=True)

HIPS = ("FL_HFE", "FR_HFE", "HL_HFE", "HR_HFE")

# several (t, v_des, w_des) points: gait start, mid-swing t (t=0.31 puts the
# diagonal pair deep in swing), non-knot-aligned t (first-knot dt shrink),
# and a turning command (yaw-momentum path)
CASES = [
    (0.0, (0.2, 0.0, 0.0), 0.0),
    (0.31, (0.3, -0.1, 0.0), 0.0),
    (0.13, (0.1, 0.05, 0.0), 0.0),
    (0.22, (0.25, 0.0, 0.0), 0.4),
]


@pytest.fixture(scope="module")
def setup():
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    rng = np.random.default_rng(11)
    q = np.asarray(Solo12Config.q0(), np.float64).copy()
    q[7:] += rng.normal(size=12) * 0.05
    q[0:2] = [0.3, -0.2]  # nonzero world xy: exercises the origin reset
    v = rng.normal(size=18) * 0.1
    return model, spec, q, v


def _jax_prob(spec, q, v, t, v_des, w_des):
    prob = KD._prepare_problem(
        spec,
        jnp.asarray(q, jnp.float64),
        jnp.asarray(v, jnp.float64),
        jnp.asarray(t, jnp.float64),
        jnp.asarray(v_des, jnp.float64),
        jnp.asarray(w_des, jnp.float64),
    )
    tasks, x0 = KD._build_ik_tasks(spec, prob, prob["X_wm"])
    return prob, tasks, x0


@pytest.mark.parametrize("case", CASES)
def test_assembly_parity_unrounded(setup, case):
    """Exact parity (round3 off, JAX y anchor) on every assembled quantity."""
    model, spec, q, v = setup
    t, v_des, w_des = case
    prob, tasks, _ = _jax_prob(spec, q, v, t, v_des, w_des)

    com_y = float(prob["x_init"][1])
    nat = native.prepare_problem(
        model, spec.eff_frames, HIPS, Solo12Config.q0(), trot,
        q, v, t, np.asarray(v_des), w_des,
        use_hip_nudges=True, foot_size=0.018, round3=False, y_anchor=com_y,
    )
    plan = prob["plan"]
    np.testing.assert_array_equal(nat["cnt"], np.asarray(plan.cnt))
    np.testing.assert_allclose(nat["dts"], np.asarray(plan.dt), atol=1e-12)
    np.testing.assert_allclose(nat["x_init"], np.asarray(prob["x_init"]), atol=1e-9)
    # contact locations: identical Raibert/centrifugal/carry chain. The only
    # remaining numeric difference is the spec's offsets (computed once in
    # float32 by make_cyclic_spec, natively in float64) -> allow 1e-5.
    np.testing.assert_allclose(nat["r"], np.asarray(plan.r), atol=2e-5)
    np.testing.assert_allclose(nat["W"], np.asarray(prob["W"]), atol=1e-12)
    np.testing.assert_allclose(
        nat["W_F"], np.asarray(prob["W_F"]), atol=1e-12
    )
    np.testing.assert_allclose(nat["X_ref"], np.asarray(prob["X_ref"]), atol=1e-8)
    lb, ub = prob["x_bounds"]
    np.testing.assert_allclose(nat["lb_x"], np.asarray(lb), atol=2e-5)
    np.testing.assert_allclose(nat["ub_x"], np.asarray(ub), atol=2e-5)
    np.testing.assert_allclose(
        nat["ee_wts"], np.asarray(tasks.ee_wts), atol=1e-12
    )
    np.testing.assert_allclose(
        nat["ee_targets"], np.asarray(tasks.ee_targets), atol=2e-5
    )


def test_assembly_reference_rounding_bound(setup):
    """round3=1 (the reference's np.round(...,3)) must stay within the
    rounding bound of the unrounded plan — the documented JAX deviation is
    bounded by 5e-4 + offset noise on every contact location."""
    model, spec, q, v = setup
    t, v_des, w_des = CASES[1]
    prob, _, _ = _jax_prob(spec, q, v, t, v_des, w_des)
    com_y = float(prob["x_init"][1])
    nat = native.prepare_problem(
        model, spec.eff_frames, HIPS, Solo12Config.q0(), trot,
        q, v, t, np.asarray(v_des), w_des, round3=True, y_anchor=com_y,
    )
    np.testing.assert_array_equal(nat["cnt"], np.asarray(prob["plan"].cnt))
    d_r = np.abs(nat["r"] - np.asarray(prob["plan"].r)).max()
    assert d_r < 1.2e-3, d_r  # <= 2 rounded xy terms (com + location) + eps


def test_y_anchor_deviation_immaterial(setup):
    """The reference's stale y anchor (0.0 on first call) vs the JAX CoM-y
    anchor changes the solution by < 1e-3 (the claim in kino_dyn.py:12-14)."""
    model, spec, q, v = setup
    t, v_des, w_des = CASES[0]
    prob, _, _ = _jax_prob(spec, q, v, t, v_des, w_des)
    com_y = float(prob["x_init"][1])
    ref = native.prepare_problem(
        model, spec.eff_frames, HIPS, Solo12Config.q0(), trot,
        q, v, t, np.asarray(v_des), w_des, round3=False, y_anchor=0.0,
    )
    ours = native.prepare_problem(
        model, spec.eff_frames, HIPS, Solo12Config.q0(), trot,
        q, v, t, np.asarray(v_des), w_des, round3=False, y_anchor=com_y,
    )
    d = np.abs(ref["X_ref"] - ours["X_ref"]).max()
    assert d == pytest.approx(abs(com_y), abs=1e-9)
    # weight on the y row is 1e-5 -> contribution to the solution is O(1e-8)
    assert abs(com_y) * float(trot.W_X[1]) < 1e-3


@pytest.mark.slow
def test_raw_to_solution_native_chain_parity(setup):
    """THE closing check: raw (q, v, t, v_des, w_des) -> (X, F, xs, us)
    through the FULLY native pipeline (prepare_problem + kinodyn_solve, no
    JAX-assembled inputs anywhere) vs the JAX solve_mpc, at the <1e-3
    north-star gate on forces and joint trajectories."""
    model, spec, q, v = setup
    # CASES[0]: t=0 standing-phase window. The aggressive mid-swing CASES[1]
    # leaves the 6-iteration GN-DDP short of its fixed point, and two
    # unconverged GN paths (autodiff vs finite-difference Jacobians) are not
    # comparable; both solvers here get a 12-iteration budget so the
    # comparison is between CONVERGED optima (same policy as the frozen e2e
    # fixture, tests/test_e2e_parity.py).
    t, v_des, w_des = CASES[0]
    n_gn = 12

    # --- JAX chain at tight tolerance (reference-schedule ADMM) ---
    cfg = biconvex.BiconvexConfig(
        rho=trot.rho, dual_relax=1.0, rho_growth=1.0, x_solver="fista",
        exit_tol=1e-6, max_admm_iters=4000,
    )
    prob, _, _ = _jax_prob(spec, q, v, t, v_des, w_des)
    dyn = biconvex.solve(
        prob["plan"], spec.model.total_mass, prob["x_init"],
        biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"]), prob["W_F"],
        prob["X_wm"], prob["F_wm"], jnp.zeros((spec.horizon + 1, 9), jnp.float64),
        cfg, x_bounds=prob["x_bounds"],
    )
    tasks, x0 = KD._build_ik_tasks(spec, prob, dyn.X)
    res = IK.solve_ik(
        model, spec.eff_frames, x0, tasks, ddp.DdpConfig(n_iters=n_gn)
    )
    assert float(dyn.viol_norm) < 5e-6

    # --- fully native chain from the same raw inputs ---
    nat = native.solve_raw(
        model, spec.eff_frames, HIPS, Solo12Config.q0(), trot,
        q, v, t, v_des, w_des, max_admm=4000, exit_tol=1e-6, n_iters=n_gn,
    )
    assert nat["viol"] < 1e-5

    dX = np.abs(nat["X"] - np.asarray(dyn.X)).max()
    dF = np.abs(nat["F"] - np.asarray(dyn.F)).max()
    dxs = np.abs(nat["xs"] - np.asarray(res.xs)).max()
    dus = np.abs(nat["us"] - np.asarray(res.us)).max()
    print(f"raw-chain parity: |dX| {dX:.2e} |dF| {dF:.2e} |dxs| {dxs:.2e} |dus| {dus:.2e}")
    assert dX < 1e-3, dX
    assert dF < 1e-3, dF  # forces: north-star gate
    assert dxs < 1e-3, dxs  # joint trajectories: north-star gate
    # accelerations amplify state differences by ~1/dt^2 (see
    # tests/test_e2e_parity.py); 1e-2 here is ~2e-4 of the |us| scale
    assert dus < 1e-2, dus
