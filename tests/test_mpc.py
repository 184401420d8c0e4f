"""End-to-end MPC tests — the JAX twin of the reference's canonical
"does the whole stack run" check (reference
examples/iterative_algorithm/test_mpc.py:1-100), plus quantitative physics
assertions the reference never had.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bunmpc_tpu.mpc import gait as G
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import GAITS, trot, walk
from bunmpc_tpu.robots.solo12 import Solo12Config


@pytest.fixture(scope="module")
def spec():
    model = Solo12Config.load_model()
    return KD.make_cyclic_spec(model, trot, Solo12Config.q0())


@pytest.fixture(scope="module")
def solve(spec):
    return jax.jit(lambda q, v, t, vd, wd: KD.solve_mpc(spec, q, v, t, vd, wd))


def _solve_once(solve, v_des=(0.2, 0.0, 0.0), w_des=0.0, t=0.0):
    q = jnp.asarray(Solo12Config.q0())
    v = jnp.asarray(Solo12Config.v0())
    return solve(q, v, jnp.asarray(t), jnp.asarray(v_des), jnp.asarray(w_des))


def test_gait_phases_trot():
    """Trot: diagonal pairs share phase; 60% duty cycle (solo12_trot.py:16-19)."""
    g = G.GaitParams(0.5, (0.6,) * 4, (0.0, 0.5, 0.5, 0.0), 0.05, 0.075)
    t = jnp.asarray(0.0)
    st = np.asarray(G.in_stance(g, t))
    np.testing.assert_array_equal(st, [1, 1, 1, 1])  # offsets 0.5*0.5=0.25<=0.3
    st = np.asarray(G.in_stance(g, jnp.asarray(0.32)))
    np.testing.assert_array_equal(st, [0, 1, 1, 0])  # FL/HR swing after 0.3
    # duty cycle over one period
    ts = jnp.linspace(0.0, 0.499, 500)
    frac = np.asarray(G.in_stance(g, ts)).mean(axis=0)
    np.testing.assert_allclose(frac, 0.6, atol=0.01)


def test_first_knot_dt():
    g = G.GaitParams(0.5, (0.6,) * 4, (0.0, 0.5, 0.5, 0.0), 0.05, 0.075)
    assert float(G.first_knot_dt(g, jnp.asarray(0.0))) == pytest.approx(0.05)
    assert float(G.first_knot_dt(g, jnp.asarray(0.02))) == pytest.approx(0.03)
    assert float(G.first_knot_dt(g, jnp.asarray(0.049))) == pytest.approx(0.05, abs=1e-6)


def test_contact_plan_structure(spec):
    """Contact locations persist while in stance; swing feet land ahead of the
    hips when walking forward."""
    model = Solo12Config.load_model()
    q = jnp.asarray(Solo12Config.q0())
    from bunmpc_tpu.kin import algorithms as K

    com = K.com(model, q)
    ee = K.frame_positions(model, q, Solo12Config.eff_names)
    plan, swing = G.create_cnt_plan(
        spec.gait,
        spec.planner,
        spec.horizon,
        q,
        jnp.asarray(0.0),
        jnp.asarray([0.3, 0.0, 0.0]),
        jnp.asarray(0.0),
        com,
        ee,
    )
    cnt = np.asarray(plan.cnt)
    r = np.asarray(plan.r)
    # knot 0 keeps measured foot positions
    np.testing.assert_allclose(r[0], np.asarray(ee), atol=1e-9)
    # stance persistence: consecutive contact knots share the location
    for j in range(4):
        for i in range(1, spec.horizon):
            if cnt[i, j] == 1 and cnt[i - 1, j] == 1:
                np.testing.assert_allclose(r[i, j], r[i - 1, j], atol=1e-12)
    # walking forward: every later touchdown is further ahead in x
    for j in range(4):
        tds = [i for i in range(1, spec.horizon) if cnt[i, j] == 1 and cnt[i - 1, j] == 0]
        xs = [r[i, j, 0] for i in tds]
        assert all(b > a for a, b in zip(xs, xs[1:]))
        for i in tds:
            assert r[i, j, 2] == pytest.approx(spec.planner.foot_size)


def test_mpc_solve_standing(solve):
    plan = _solve_once(solve, v_des=(0.0, 0.0, 0.0))
    assert float(plan.dyn_violation) < 1e-3
    F = np.asarray(plan.F_opt)
    cnt = np.asarray(plan.cnt_plan[..., 0])
    # total vertical force over a full gait period supports the weight
    fz_mean = (cnt * F[..., 2]).sum(-1).mean()
    assert abs(fz_mean - 2.5 * 9.81) < 6.0
    # friction cone feasible
    fxy = np.linalg.norm(F[..., :2], axis=-1)
    assert np.all(fxy <= 1.0 * F[..., 2] + 1e-6)
    # CoM stays near nominal height
    assert np.all(np.abs(np.asarray(plan.X_opt[:, 2]) - 0.2) < 0.1)


def test_mpc_solve_walking(solve):
    plan = _solve_once(solve, v_des=(0.3, 0.0, 0.0))
    assert float(plan.dyn_violation) < 1e-3
    X = np.asarray(plan.X_opt)
    # CoM advances in x across the horizon, roughly tracking v_des
    assert X[-1, 0] > X[0, 0] + 0.1
    # vcom x tracks the command in the bulk of the horizon
    assert abs(X[5:15, 3].mean() - 0.3) < 0.15
    # interpolated plan has the right shapes and starts at the current state
    assert plan.xs_int.shape == (150, 37)
    np.testing.assert_allclose(
        np.asarray(plan.xs_int[0, 7:19]), Solo12Config.q0()[7:], atol=1e-6
    )


def test_mpc_swing_tracking(solve):
    """IK must lift swing feet toward the via height (step_ht)."""
    plan = _solve_once(solve, v_des=(0.2, 0.0, 0.0), t=0.32)  # FL/HR in swing
    from bunmpc_tpu.kin import algorithms as K

    model = Solo12Config.load_model()
    xs = np.asarray(plan.xs)
    heights = []
    for k in range(xs.shape[0]):
        ee = K.frame_positions(model, jnp.asarray(xs[k, :19]), Solo12Config.eff_names)
        heights.append(np.asarray(ee)[:, 2])
    heights = np.stack(heights)
    # swing feet (FL=0, HR=3) rise above their start within the ik horizon
    assert heights[:, 0].max() > heights[0, 0] + 0.01
    assert heights[:, 3].max() > heights[0, 3] + 0.01


@pytest.mark.slow
def test_mpc_vmap_batch(spec):
    """The flagship property: vmapped MPC — many commands solved in one
    program, matching single solves."""
    B = 3
    q = jnp.tile(jnp.asarray(Solo12Config.q0()), (B, 1))
    v = jnp.zeros((B, 18))
    t = jnp.zeros(B)
    v_des = jnp.asarray([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.0, 0.1, 0.0]])
    w_des = jnp.asarray([0.0, 0.0, 0.3])
    batched = jax.jit(jax.vmap(lambda q, v, t, vd, wd: KD.solve_mpc(spec, q, v, t, vd, wd)))
    plans = batched(q, v, t, v_des, w_des)
    assert plans.X_opt.shape == (B, 21, 9)
    assert np.all(np.asarray(plans.dyn_violation) < 1e-3)
    single = KD.solve_mpc(
        spec, q[1], v[1], t[1], v_des[1], w_des[1]
    )
    np.testing.assert_allclose(
        np.asarray(plans.X_opt[1]), np.asarray(single.X_opt), atol=1e-8
    )


def test_all_gait_specs_build():
    """Every registered gait (incl. still/gallop/walk from solo12_wip.py)
    yields a consistent spec: horizon math and weight table shapes."""
    model = Solo12Config.load_model()
    q0 = Solo12Config.q0()
    for name, g in GAITS.items():
        spec = KD.make_cyclic_spec(model, g, q0)
        assert g.horizon == int(np.round(g.gait_horizon * g.gait_period / g.gait_dt, 2)), name
        assert g.state_wt.shape == (36,), name
        assert g.ctrl_wt.shape == (18,), name
        assert g.W_X.shape == (9,) and g.W_F.shape == (12,), name
        assert spec is not None


def test_walk_gait_solves():
    """The short-horizon walk gait (6 knots, gait_horizon 0.5) solves and
    keeps the CoM near its nominal height."""
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, walk, Solo12Config.q0())
    q = jnp.asarray(Solo12Config.q0())
    plan = jax.jit(lambda q, v, t, vd, wd: KD.solve_mpc(spec, q, v, t, vd, wd))(
        q, jnp.zeros(18), jnp.asarray(0.0), jnp.asarray([0.15, 0.0, 0.0]), jnp.asarray(0.0)
    )
    assert float(plan.dyn_violation) < 1e-2
    X = np.asarray(plan.X_opt)
    assert np.all(np.abs(X[:, 2] - walk.nom_ht) < 0.08)


@pytest.mark.parametrize("name", ["bound_turn", "air_bound"])
def test_bound_variants_solve(name):
    """bound_turn / air_bound (reference solo12_bound.py:49-120) converge and
    hold the CoM near nom_ht; bound_turn additionally under a yaw command
    (its raison d'etre — gait_horizon 1.0 + softened yaw tracking)."""
    g = GAITS[name]
    model = Solo12Config.load_model()
    spec2 = KD.make_cyclic_spec(model, g, Solo12Config.q0())
    q = jnp.asarray(Solo12Config.q0())
    wd = 0.5 if name == "bound_turn" else 0.0
    plan = jax.jit(lambda q, v, t, vd, wd: KD.solve_mpc(spec2, q, v, t, vd, wd))(
        q, jnp.zeros(18), jnp.asarray(0.0), jnp.asarray([0.2, 0.0, 0.0]), jnp.asarray(wd)
    )
    assert float(plan.dyn_violation) < 1e-3, name
    X = np.asarray(plan.X_opt)
    assert np.all(np.abs(X[:, 2] - g.nom_ht) < 0.08), name
    assert np.all(np.isfinite(np.asarray(plan.xs_int))), name
    if name == "air_bound":
        # 0.4 stance percent: the continuous-time gait has full-flight gaps
        # (phase 0.4-0.5 and 0.9-1.0). At gait_dt=0.05 on a 0.3 s period the
        # 0.03 s gaps fall BETWEEN knots, so assert the phase machine itself
        # (the knot grid never samples a flight instant; reference gait
        # planner semantics, gait_planner.cpp:46-58)
        st = np.asarray(
            jax.vmap(lambda tt: G.in_stance(spec2.gait, tt))(
                jnp.asarray([0.42 * 0.3, 0.95 * 0.3])
            )
        )
        assert not st.any(), "air_bound phase machine missing flight gaps"


@pytest.mark.slow
def test_warm_start_accelerates_admm(spec):
    """Receding-horizon warm start (previous solution + dual, shifted one
    window) must converge in no more ADMM iterations than the reference's
    cold start and land on the same trajectory. Pinned to the reference's
    plain dual-ascent schedule so the iteration-count comparison isolates
    the warm start (the accelerated default converges in ~30 iters with or
    without one)."""
    from bunmpc_tpu.solvers import biconvex

    plain = biconvex.BiconvexConfig(rho=trot.rho, dual_relax=1.0, rho_growth=1.0)
    solve_p = jax.jit(
        lambda q, v, t, vd, wd: KD.solve_mpc(spec, q, v, t, vd, wd, admm_cfg=plain)
    )
    q = jnp.asarray(Solo12Config.q0())
    v = jnp.asarray(Solo12Config.v0())
    vd, wd = jnp.asarray([0.2, 0.0, 0.0]), jnp.asarray(0.0)
    cold0 = solve_p(q, v, jnp.asarray(0.0), vd, wd)
    # warm-start the t=0.05 solve with the t=0 solution shifted one knot
    shX = jnp.concatenate([cold0.X_opt[1:], cold0.X_opt[-1:]])
    shF = jnp.concatenate([cold0.F_opt[1:], cold0.F_opt[-1:]])
    shP = jnp.concatenate([cold0.P_opt[1:], cold0.P_opt[-1:]])
    cold = solve_p(q, v, jnp.asarray(0.05), vd, wd)
    warm = jax.jit(
        lambda q, v, t, vd, wd, ws: KD.solve_mpc(
            spec, q, v, t, vd, wd, admm_cfg=plain, warm_start=ws
        )
    )(q, v, jnp.asarray(0.05), vd, wd, (shX, shF, shP))
    assert float(warm.dyn_violation) <= max(1e-3, float(cold.dyn_violation) * 1.05)
    assert int(warm.admm_iters) <= int(cold.admm_iters)
    np.testing.assert_allclose(
        np.asarray(warm.X_opt), np.asarray(cold.X_opt), atol=5e-2
    )


@pytest.mark.slow
def test_rollout_mpc_warm_start_carry(spec):
    """warm_start_carry=True rollout: stays alive, matches the cold-start
    rollout closely over a short horizon."""
    from bunmpc_tpu.sim import physics, rollout
    from bunmpc_tpu.solvers import biconvex, ddp

    sp = physics.SimParams(contact=physics.ContactParams(mu=1.0))
    cfg = rollout.RolloutConfig(
        episode_length=300, kp=trot.kp, kd=trot.kd, gait_period=trot.gait_period
    )
    s0 = physics.SimState(q=jnp.asarray(Solo12Config.q0()), v=jnp.zeros(18))
    fast_admm = biconvex.BiconvexConfig(rho=trot.rho, max_admm_iters=60)
    fast_ddp = ddp.DdpConfig(n_iters=4)
    run = jax.jit(
        lambda s, vd, wd, carry: rollout.rollout_mpc(
            spec, sp, cfg, s, vd, wd, admm_cfg=fast_admm, ddp_cfg=fast_ddp,
            warm_start_carry=carry,
        ),
        static_argnums=3,
    )
    vd, wd = jnp.asarray([0.2, 0.0, 0.0]), jnp.asarray(0.0)
    res_w = run(s0, vd, wd, True)
    res_c = run(s0, vd, wd, False)
    assert not bool(res_w.failed)
    # same controller trajectory to within solver-tolerance noise
    db = np.abs(np.asarray(res_w.base) - np.asarray(res_c.base)).max()
    assert db < 0.05
