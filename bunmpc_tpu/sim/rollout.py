"""Batched rollout engine: MPC / policy / DAgger-style episodes in-graph.

JAX twin of the reference ``Simulation`` class (reference
examples/iterative_algorithm/simulation.py:22-2094). The reference runs one
PyBullet episode per process with a Python 1 kHz loop; here an episode is a
``lax.scan`` over replanning windows (outer) and 1 ms control steps (inner),
with the MPC solve, the inverse-dynamics controller, the physics step, the
featurization, and the failure predicates all fused into one XLA program.
``jax.vmap`` over the episode gives thousands of simultaneous rollouts.

Rate structure matches the reference: 1 kHz sim/control, replanning every
``plan_freq`` (20 Hz -> 50 steps; simulation.py:44, 498-500).

Data captured per step mirrors the reference exactly:
* state features, n_state=43: [v(18), base_wrt_foot(8), q[2:](17)]
  (simulation.py:487-489)
* vc goal, 5: [phase %, v_des_xy, w_des, gait id] (simulation.py:492-495)
* action: torque / pd_target / structured (simulation.py:525-531)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..kin import algorithms as K
from ..mpc import gait as G
from ..mpc import kino_dyn as KD
from ..robots.model import RobotModel
from ..utils.quat import quat_to_rot, rot_to_rpy
from . import controllers, physics


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    episode_length: int  # total 1 ms steps
    plan_freq: float = 0.05  # s between replans (20 Hz)
    sim_dt: float = 0.001
    action_type: str = "pd_target"  # torque | pd_target | structured
    kp: float = 3.0  # PD gains of the action parametrization (cfg kp/kd)
    kd: float = 0.05
    gait_id: float = 1.0  # vc-goal gait indicator (utils.get_vc_gait_value)
    fail_angle_deg: float = 30.0
    gait_period: float = 0.5

    @property
    def steps_per_plan(self) -> int:
        return int(round(self.plan_freq / self.sim_dt))

    @property
    def n_windows(self) -> int:
        return self.episode_length // self.steps_per_plan


class RolloutResult(NamedTuple):
    states: jnp.ndarray  # (T, 43) state features
    actions: jnp.ndarray  # (T, 12)
    vc_goals: jnp.ndarray  # (T, 5)
    base: jnp.ndarray  # (T, 3) base positions
    com: jnp.ndarray  # (T, 3)
    contact_forces: jnp.ndarray  # (T, n_eff, 3) measured ground reactions
    contact_pos: jnp.ndarray  # (T, n_eff, 3)
    in_contact: jnp.ndarray  # (T, n_eff)
    failed: jnp.ndarray  # () True if the failure predicate fired
    fail_step: jnp.ndarray  # () first failing step (episode_length if none)
    final_state: physics.SimState
    mpc_usage: jnp.ndarray  # (T,) 1.0 where the expert (MPC) was in control


def state_features(model: RobotModel, eff_frames, q, v):
    """n_state=43 featurization (simulation.py:487-489)."""
    feet = K.frame_positions(model, q, eff_frames)
    base_wrt_foot = (q[..., None, 0:2] - feet[..., 0:2]).reshape(q.shape[:-1] + (-1,))
    return jnp.concatenate([v, base_wrt_foot, q[..., 2:]], axis=-1)


def vc_goal(cfg: RolloutConfig, step, v_des, w_des):
    """[phase %, v_des_x, v_des_y, w_des, gait id] (simulation.py:492-495).
    Phase uses the absolute sim step — start_time shifts phase, a reference
    quirk we keep (SURVEY.md §7.5)."""
    phase = jnp.mod(step * cfg.sim_dt, cfg.gait_period) / cfg.gait_period
    return jnp.stack([phase, v_des[..., 0], v_des[..., 1], w_des, jnp.asarray(cfg.gait_id)])


def failed_state(cfg: RolloutConfig, q, time_elapsed):
    """Height/attitude failure envelope (simulation.py:189-220)."""
    rpy = rot_to_rpy(quat_to_rot(q[..., 3:7]))
    ang = jnp.deg2rad(cfg.fail_angle_deg)
    bad = (
        (q[..., 2] < 0.1)
        | (q[..., 2] > 2.0)
        | (jnp.abs(rpy[..., 0]) > ang)
        | (jnp.abs(rpy[..., 1]) > ang)
    )
    grace = time_elapsed > (cfg.gait_period / cfg.sim_dt)
    return bad & grace


_SAFE_HAA_L = (-0.8, 1.5)
_SAFE_HAA_R = (-1.5, 0.8)
_SAFE_HFE = (-2.0, 2.0)
_SAFE_KFE = (-3.0, 3.0)


def state_is_dangerous(q, z_bounds=(0.15, 1.0), body_angle_deg=25.0):
    """SafeDAgger safety box (simulation.py:222-297): attitude + height +
    per-joint limit boxes (left/right HAA asymmetric)."""
    rpy = rot_to_rpy(quat_to_rot(q[..., 3:7]))
    ang = jnp.deg2rad(body_angle_deg)
    bad = (
        (q[..., 2] < z_bounds[0])
        | (q[..., 2] > z_bounds[1])
        | (jnp.abs(rpy[..., 0]) > ang)
        | (jnp.abs(rpy[..., 1]) > ang)
    )
    lo = jnp.asarray(
        [_SAFE_HAA_L[0], _SAFE_HFE[0], _SAFE_KFE[0], _SAFE_HAA_R[0], _SAFE_HFE[0], _SAFE_KFE[0]]
        * 2,
        q.dtype,
    )
    hi = jnp.asarray(
        [_SAFE_HAA_L[1], _SAFE_HFE[1], _SAFE_KFE[1], _SAFE_HAA_R[1], _SAFE_HFE[1], _SAFE_KFE[1]]
        * 2,
        q.dtype,
    )
    joints = q[..., 7:]
    bad = bad | jnp.any((joints < lo) | (joints > hi), axis=-1)
    return bad


def leg_joint_mask(model: RobotModel, eff_frames):
    """Static (n_eff, n_joints) incidence matrix: 1 where the actuated joint
    lies on the kinematic path from the base to that end-effector frame."""
    import numpy as np

    mask = np.zeros((len(eff_frames), model.nv - 6), np.float32)
    for e, name in enumerate(eff_frames):
        for j in model.ancestors(model.frames[name].body):
            mask[e, j] = 1.0
    return mask


def swing_blend_scale(leg_mask_j, planned_st, meas_cnt, sb):
    """Per-joint PD-feedback scale for contact-adaptive swing release.

    Legs whose foot the gait plans as SWINGING (``planned_st == 0``) but that
    is MEASURED still in contact get their joints' feedback scaled by ``sb``
    (0 = release the leg, 1 = reference behavior); all other joints get 1.

    Args: leg_mask_j (n_eff, nj) from :func:`leg_joint_mask`; planned_st
    (n_eff,) 0/1 planned stance; meas_cnt (n_eff,) bool measured contact;
    sb scalar. Returns (nj,) scale.
    """
    gate = (planned_st == 0) & meas_cnt  # (ne,) bool
    dt = leg_mask_j.dtype
    return 1.0 - (1.0 - sb) * jnp.einsum(
        "ej,e->j", leg_mask_j, gate.astype(dt)
    ).clip(0.0, 1.0)


def settle_state(
    model: RobotModel,
    eff_frames,
    sim_params: physics.SimParams,
    state0: physics.SimState,
    kp: float,
    kd: float,
    ms: int = 500,
    gain_scale: float = 6.0,
) -> physics.SimState:
    """PD-hold the initial pose for ``ms`` steps so episodes start from a
    physically consistent standing state (feet settled into the contact
    model) instead of the raw configuration dropped onto the ground.

    The reference's PyBullet episodes effectively start settled (the robot
    spawns in ground contact); in the in-graph soft-contact sim the raw q0
    begins ~foot_radius above equilibrium and the drop transient pollutes the
    first gait cycle. Used by the gait-quality gates, the learning drivers,
    and the demo scripts.
    """
    q0j = state0.q[..., 7:]

    def step(s, _):
        tau = -gain_scale * kp * (s.q[..., 7:] - q0j) - gain_scale * kd * s.v[..., 6:]
        s2, _ = physics.step(model, eff_frames, sim_params, s, tau)
        return s2, None

    s, _ = jax.lax.scan(step, state0, None, length=ms)
    return s


def _measure(q, v, q_noise, v_noise):
    """Apply constant sensor bias to the measured state (quat renormalized,
    simulation.py:471-477)."""
    if q_noise is None and v_noise is None:
        return q, v
    qm = q if q_noise is None else q + q_noise
    if q_noise is not None:
        qm = qm.at[..., 3:7].set(qm[..., 3:7] / jnp.linalg.norm(qm[..., 3:7], axis=-1, keepdims=True))
    vm = v if v_noise is None else v + v_noise
    return qm, vm


def _decode_action(cfg: RolloutConfig, action, q, v):
    """Policy action -> joint torques, per action_type (reference
    simulation.py:760-777):
    * torque:     tau = action
    * pd_target:  tau = kp (a - q_j) - kd v_j
    * structured: action = [tau_ff(12), q_des(12), dq_des(12)],
                  tau = tau_ff + kp (q_des - q_j) + kd (dq_des - v_j)
    """
    nj = q.shape[-1] - 7
    if cfg.action_type == "torque":
        return action
    if cfg.action_type == "pd_target":
        return cfg.kp * (action - q[..., 7:]) - cfg.kd * v[..., 6:]
    if cfg.action_type == "structured":
        tau_ff = action[..., :nj]
        q_des = action[..., nj : 2 * nj]
        dq_des = action[..., 2 * nj : 3 * nj]
        return tau_ff + cfg.kp * (q_des - q[..., 7:]) + cfg.kd * (dq_des - v[..., 6:])
    raise ValueError(f"unsupported action_type {cfg.action_type!r}")


def _extract_action(cfg: RolloutConfig, tau, q, v, tau_ff=None, q_des=None, v_des_traj=None):
    """Action encodings (simulation.py:525-531); pd_target recovers the
    implied PD setpoint from the torque; "structured" captures
    [tau_ff, q_des_joints, v_des_joints] (SURVEY.md §7.5)."""
    if cfg.action_type == "torque":
        return tau
    if cfg.action_type == "pd_target":
        return (tau + cfg.kd * v[..., 6:]) / cfg.kp + q[..., 7:]
    if cfg.action_type == "structured":
        return jnp.concatenate([tau_ff, q_des[..., 7:], v_des_traj[..., 6:]], axis=-1)
    raise ValueError(f"unsupported action_type {cfg.action_type!r}")


def rollout_mpc(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,  # (3,)
    w_des,  # ()
    start_time: float = 0.0,
    push_force=None,  # optional (T, 3) per-step external base force
    terrain=None,  # optional physics.Terrain (uneven ground)
    q_noise=None,  # optional (nq,) constant sensor bias on measured q
    v_noise=None,  # optional (nv,) constant sensor bias on measured v
    admm_cfg=None,
    ddp_cfg=None,
    gains: controllers.IdControllerGains | None = None,  # PD override (vmappable)
    warm_start_carry: bool | None = None,
    swing_blend=None,  # optional scalar (traced/vmappable): see below
    force_gate=None,  # optional scalar (traced/vmappable): see below
) -> RolloutResult:
    """MPC expert rollout (reference Simulation.rollout_mpc, simulation.py:340).

    Single sample; vmap over (state0, v_des, w_des) for batches — and, since
    ``gains``/``sim_params`` are pytrees, over gain/physics batches too
    (domain randomization). Sensor noise follows the reference's scheme
    (simulation.py:56-61,471-477): a constant per-episode bias added to the
    *measured* state the controller sees, while the physics integrates the
    true state.

    ``warm_start_carry`` (None -> ON for "tiled" warm-start specs — default
    ON since round 3, measured +7.5% rollout throughput at equal stability —
    and OFF for "vdes" specs like the Go2) feeds each window's ADMM the
    previous window's (X, F, dual) shifted one window and translated into
    the new plan frame — a receding-horizon accelerator the reference lacks
    (its F/P warm starts stay zero forever, kino_dyn.cpp:20-23): the masked
    ADMM while_loop exits earlier, identical fixed points when the biconvex
    basin is unique. On "vdes" specs the carried solution drags the next
    solve back toward the degenerate stay-put basin the vdes start exists
    to avoid (round-4 Go2 diagnosis), hence the per-spec default. A health
    gate drops carried solutions that are non-finite or physically insane
    instead of re-seeding the solver with junk. Pass ``False`` for the
    reference's cold-start behavior.

    ``swing_blend`` (contact-adaptive swing handling, beyond the reference):
    when a foot the gait plans as SWINGING is measured still in contact, the
    PD feedback on that leg's joints is scaled by this factor (0 = release
    the leg entirely, 1/None = reference behavior). Without it the
    controller tracks the planned swing trajectory *against* the grounded
    foot — on heavy robots (Go2) the resulting ground push ratchets the
    base upward and rolls the trot over (ROADMAP round-2 diagnosis:
    measured contact duty 0.90 vs planned 0.60).

    ``force_gate`` (contact-adaptive force gating, beyond the reference):
    when a foot is measured airborne, that leg's feed-forward J^T f_ff
    compensation is scaled by this factor (0 = drop the force entirely
    until touchdown, 1/None = reference behavior). The gate applies to
    EVERY measured-airborne leg regardless of planned phase — planned-swing
    legs carry ~0 plan force, so in practice it bites only on planned-stance
    legs that have not touched down yet.
    Pushing a planned-stance force against air just accelerates the leg
    downward into an impact — on the Go2 the resulting bounce loop shows
    up as measured contact duty ~0.1 vs planned 0.6 with ~9x-bodyweight
    touchdown spikes (round-3 diagnosis).
    """
    model = spec.model
    eff = spec.eff_frames
    if gains is None:
        gains = controllers.IdControllerGains(kp=spec.params.kp, kd=spec.params.kd)
    spp = cfg.steps_per_plan
    kwargs = {}
    if admm_cfg is not None:
        kwargs["admm_cfg"] = admm_cfg
    if ddp_cfg is not None:
        kwargs["ddp_cfg"] = ddp_cfg
    H = spec.horizon
    if warm_start_carry is None:
        warm_start_carry = spec.warm_start_style == "tiled"
    n_shift = max(1, int(round(cfg.plan_freq / spec.params.gait_dt)))
    if swing_blend is not None:
        leg_mask_j = jnp.asarray(leg_joint_mask(model, eff))

    def window(carry, w_idx):
        state, failed, fail_step, ws_prev, prev_cnt = carry
        sim_t = start_time + w_idx * cfg.plan_freq * 1.0
        qm0, vm0 = _measure(state.q, state.v, q_noise, v_noise)
        if warm_start_carry:
            prevX, prevF, prevP, prev_xy, have_prev = ws_prev
            # default = the spec's cold start: tiled current centroidal state
            # ("tiled") or the command ramp ("vdes", kino_dyn._prepare_problem)
            q_reset = qm0.at[0:2].set(0.0)
            com, h_lin, h_ang = K.centroidal_momentum(model, q_reset, vm0)
            x_init = jnp.concatenate([com, h_lin / model.total_mass, h_ang])
            defX = jnp.tile(x_init, (H + 1, 1))
            if spec.warm_start_style == "vdes":
                # same time grid as _prepare_problem's vdes start: the plan's
                # dt schedule with the shrunk first knot (advisor round-4) —
                # at non-knot-aligned replanning times an arange grid lands
                # the fallback in a slightly different point than the
                # solver's own cold start
                gd = jnp.asarray(spec.params.gait_dt, defX.dtype)
                t_pl = jnp.round(jnp.asarray(sim_t, defX.dtype), 3)
                dts = jnp.full((H,), gd).at[0].set(
                    G.first_knot_dt(spec.gait, t_pl).astype(defX.dtype)
                )
                tg = jnp.concatenate([jnp.zeros(1, defX.dtype), jnp.cumsum(dts)])
                Rfull = quat_to_rot(q_reset[3:7])
                vdw = Rfull @ v_des
                defX = defX.at[:, 0:2].add(tg[:, None] * vdw[None, 0:2])
                defX = defX.at[:, 3:6].set(vdw[None, :])
            # shift previous solution one window and translate xy into the
            # new plan frame (plan frames are origin-reset at the base xy)
            dxy = prev_xy - qm0[0:2]
            shX = jnp.concatenate([prevX[n_shift:], jnp.tile(prevX[-1:], (n_shift, 1))])
            shX = shX.at[:, 0:2].add(dxy)
            shF = jnp.concatenate([prevF[n_shift:], jnp.tile(prevF[-1:], (n_shift, 1, 1))])
            shP = jnp.concatenate([prevP[n_shift:], jnp.tile(prevP[-1:], (n_shift, 1))])
            # health gate (round 4): only reuse a previous solution that is
            # finite and physically sane — carrying a diverged window's
            # (X, F, dual) re-seeds the next solve with junk and the rollout
            # NaN-aborts within a few windows (observed on Go2)
            f_sane = 10.0 * model.total_mass * 9.81
            healthy = (
                have_prev
                & jnp.all(jnp.isfinite(shX))
                & jnp.all(jnp.isfinite(shF))
                & (jnp.max(jnp.abs(shF)) < f_sane)
            )
            kwargs["warm_start"] = (
                jnp.where(healthy, shX, defX),
                jnp.where(healthy, shF, jnp.zeros_like(shF)),
                jnp.where(healthy, shP, jnp.zeros_like(shP)),
            )
        plan = KD.solve_mpc(
            spec,
            qm0,
            vm0,
            jnp.round(sim_t, 3),
            v_des,
            w_des,
            terrain=terrain,  # terrain-aware touchdown/height planning
            **kwargs,
        )
        if warm_start_carry:
            ws_prev = (plan.X_opt, plan.F_opt, plan.P_opt, qm0[0:2], jnp.asarray(True))
        mpc_bad = jnp.any(jnp.isnan(plan.f_int)) | jnp.any(jnp.isnan(plan.xs_int))

        def substep(inner, i):
            state, failed, fail_step, prev_cnt = inner
            step_idx = (w_idx * spp + i).astype(jnp.int32)
            q, v = _measure(state.q, state.v, q_noise, v_noise)
            feat = state_features(model, eff, q, v)
            goal = vc_goal(cfg, start_time / cfg.sim_dt + step_idx, v_des, w_des)
            q_des = plan.xs_int[i, : model.nq]
            v_des_traj = plan.xs_int[i, model.nq :]
            a_des = plan.us_int[i]
            f_ff = plan.f_int[i]
            if force_gate is not None:
                # drop/scale planned-stance forces on legs measured airborne
                fg = jnp.asarray(force_gate, q.dtype)
                f_scale = jnp.where(prev_cnt, 1.0, fg).astype(q.dtype)
            else:
                f_scale = None
            tau_ff, tau_fb = controllers.id_joint_torques(
                model, eff, gains, q, v, q_des, v_des_traj, a_des, f_ff,
                f_scale=f_scale,
            )
            if swing_blend is not None:
                # release legs whose planned-swing foot is still grounded
                t_ms = jnp.asarray(sim_t, q.dtype) + i * cfg.sim_dt
                planned_st = G.in_stance(spec.gait, t_ms)  # (ne,)
                scale_j = swing_blend_scale(
                    leg_mask_j.astype(q.dtype), planned_st, prev_cnt,
                    jnp.asarray(swing_blend, q.dtype),
                )
                tau_fb = scale_j * tau_fb
            # actuator saturation BEFORE recording: the physics clips
            # internally, but the recorded expert action must be the torque
            # the actuator can actually apply — near-failure states otherwise
            # log 1000x-limit outliers that poison BC training (round-4
            # learning-demo diagnosis: |action| up to 1e4 with a 2.7 N m
            # limit -> L1 loss diverges at scale)
            tau = jnp.clip(
                tau_ff + tau_fb,
                -sim_params.torque_limit,
                sim_params.torque_limit,
            )
            action = _extract_action(
                cfg, tau, q, v, tau_ff=tau_ff, q_des=q_des, v_des_traj=v_des_traj
            )
            fe = None if push_force is None else push_force[step_idx]
            new_state, cinfo = physics.step(
                model, eff, sim_params, state, tau, f_ext=fe, terrain=terrain
            )
            now_failed = failed | failed_state(cfg, q, step_idx) | mpc_bad
            fail_step = jnp.where(
                now_failed & ~failed, step_idx, fail_step
            )
            # freeze the state once failed (the reference breaks the loop)
            new_state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(now_failed, a, b), state, new_state
            )
            com = K.com(model, q)
            out = (feat, action, goal, q[0:3], com, cinfo.forces, cinfo.positions,
                   cinfo.in_contact)
            return (new_state, now_failed, fail_step, cinfo.in_contact), out

        (state, failed, fail_step, prev_cnt), outs = jax.lax.scan(
            substep, (state, failed, fail_step, prev_cnt), jnp.arange(spp)
        )
        return (state, failed, fail_step, ws_prev, prev_cnt), outs

    if warm_start_carry:
        f32 = state0.q.dtype
        ws0 = (
            jnp.zeros((H + 1, 9), f32),
            jnp.zeros((H, spec.n_eff, 3), f32),
            jnp.zeros((H + 1, 9), f32),
            jnp.zeros(2, f32),
            jnp.asarray(False),
        )
    else:
        ws0 = jnp.zeros(())  # inert carry slot
    cnt0 = jnp.ones(spec.n_eff, bool)  # standing start: all feet grounded
    init = (
        state0, jnp.asarray(False), jnp.asarray(cfg.episode_length, jnp.int32),
        ws0, cnt0,
    )
    (final_state, failed, fail_step, _, _), outs = jax.lax.scan(
        window, init, jnp.arange(cfg.n_windows)
    )
    flat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), outs)
    feat, action, goal, base, com, forces, cpos, incnt = flat
    T = cfg.n_windows * spp
    return RolloutResult(
        states=feat,
        actions=action,
        vc_goals=goal,
        base=base,
        com=com,
        contact_forces=forces,
        contact_pos=cpos,
        in_contact=incnt,
        failed=failed,
        fail_step=fail_step,
        final_state=final_state,
        mpc_usage=jnp.ones(T),
    )


def _gated_rollout(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn: Callable,
    gate_fn: Callable,  # (q, window_gate_rng, prev_use_mpc, steps_blocked, step) -> (use_mpc, steps_blocked)
    start_time: float = 0.0,
    admm_cfg=None,
    ddp_cfg=None,
) -> RolloutResult:
    """Shared skeleton for expert-gated rollouts (SafeDAgger/DAgger): the MPC
    solves at every window boundary (fixed shapes — the plan is at most one
    window stale at a mid-window takeover, a documented deviation from the
    reference's solve-on-takeover), and a per-step gate picks MPC or policy
    torques. Recorded actions are whatever acted (the drivers aggregate the
    MPC-labeled segments)."""
    model = spec.model
    eff = spec.eff_frames
    gains = controllers.IdControllerGains(kp=spec.params.kp, kd=spec.params.kd)
    spp = cfg.steps_per_plan
    kwargs = {}
    if admm_cfg is not None:
        kwargs["admm_cfg"] = admm_cfg
    if ddp_cfg is not None:
        kwargs["ddp_cfg"] = ddp_cfg

    def window(carry, w_idx):
        state, failed, fail_step, use_mpc, steps_blocked = carry
        sim_t = start_time + w_idx * cfg.plan_freq
        plan = KD.solve_mpc(
            spec, state.q, state.v, jnp.round(sim_t, 3), v_des, w_des, **kwargs
        )
        # MPC divergence abort (reference simulation.py:513-516) — without it
        # a NaN plan feeds NaN torques into the physics and the failure
        # predicate (NaN comparisons are False) never fires, so the episode
        # records NaN garbage instead of failing (round-5 hardening; the
        # ungated rollout_mpc has carried this guard since round 1)
        mpc_bad = jnp.any(jnp.isnan(plan.f_int)) | jnp.any(jnp.isnan(plan.xs_int))

        def substep(inner, i):
            state, failed, fail_step, use_mpc, steps_blocked = inner
            step_idx = (w_idx * spp + i).astype(jnp.int32)
            q, v = state
            feat = state_features(model, eff, q, v)
            goal = vc_goal(cfg, start_time / cfg.sim_dt + step_idx, v_des, w_des)
            use_mpc, steps_blocked = gate_fn(q, w_idx, i, use_mpc, steps_blocked)

            # expert torques from the window plan
            q_des = plan.xs_int[i, : model.nq]
            v_des_traj = plan.xs_int[i, model.nq :]
            tau_ff, tau_fb = controllers.id_joint_torques(
                model, eff, gains, q, v, q_des, v_des_traj, plan.us_int[i], plan.f_int[i]
            )
            # actuator saturation before recording (see rollout_mpc): the
            # DAgger-aggregated expert labels must be applicable torques
            tau_mpc = jnp.clip(
                tau_ff + tau_fb, -sim_params.torque_limit, sim_params.torque_limit
            )
            # policy torques
            action_pol = policy_fn(feat, goal)
            tau_pol = _decode_action(cfg, action_pol, q, v)

            tau = jnp.where(use_mpc, tau_mpc, tau_pol)
            action_mpc = _extract_action(
                cfg, tau_mpc, q, v, tau_ff=tau_ff, q_des=q_des, v_des_traj=v_des_traj
            )
            action = jnp.where(use_mpc, action_mpc, action_pol)
            new_state, cinfo = physics.step(model, eff, sim_params, state, tau)
            now_failed = failed | failed_state(cfg, q, step_idx) | mpc_bad
            fail_step = jnp.where(now_failed & ~failed, step_idx, fail_step)
            new_state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(now_failed, a, b), state, new_state
            )
            com = K.com(model, q)
            out = (feat, action, goal, q[0:3], com, cinfo.forces, cinfo.positions,
                   cinfo.in_contact, use_mpc.astype(feat.dtype))
            return (new_state, now_failed, fail_step, use_mpc, steps_blocked), out

        (state, failed, fail_step, use_mpc, steps_blocked), outs = jax.lax.scan(
            substep, (state, failed, fail_step, use_mpc, steps_blocked), jnp.arange(spp)
        )
        return (state, failed, fail_step, use_mpc, steps_blocked), outs

    init = (
        state0,
        jnp.asarray(False),
        jnp.asarray(cfg.episode_length, jnp.int32),
        jnp.asarray(False),
        jnp.zeros((), jnp.int32),
    )
    (final_state, failed, fail_step, _, _), outs = jax.lax.scan(
        window, init, jnp.arange(cfg.n_windows)
    )
    flat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), outs)
    feat, action, goal, base, com, forces, cpos, incnt, usage = flat
    return RolloutResult(
        states=feat,
        actions=action,
        vc_goals=goal,
        base=base,
        com=com,
        contact_forces=forces,
        contact_pos=cpos,
        in_contact=incnt,
        failed=failed,
        fail_step=fail_step,
        final_state=final_state,
        mpc_usage=usage,
    )


def rollout_safedagger(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn: Callable,
    num_steps_to_block: int = 150,
    start_time: float = 0.0,
    admm_cfg=None,
    ddp_cfg=None,
) -> RolloutResult:
    """Safety-gated rollout (reference Simulation.rollout_safedagger,
    simulation.py:1097, gating at :1290-1323): the MPC takes over when the
    state enters the danger box and keeps control for at least
    ``num_steps_to_block`` steps after it is safe again."""

    def gate(q, w_idx, i, use_mpc, steps_blocked):
        dangerous = state_is_dangerous(q)
        # dangerous -> MPC, reset block counter on fresh takeover
        steps_blocked = jnp.where(
            dangerous & ~use_mpc, 0, jnp.where(use_mpc, steps_blocked + 1, steps_blocked)
        )
        release = use_mpc & ~dangerous & (steps_blocked >= num_steps_to_block)
        new_use = jnp.where(dangerous, True, jnp.where(release, False, use_mpc))
        steps_blocked = jnp.where(release, 0, steps_blocked)
        return new_use, steps_blocked

    return _gated_rollout(
        spec, sim_params, cfg, state0, v_des, w_des, policy_fn, gate,
        start_time=start_time, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
    )


def rollout_dagger(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn: Callable,
    rng_key,
    mpc_usage_percentage: float = 0.5,
    start_time: float = 0.0,
    admm_cfg=None,
    ddp_cfg=None,
) -> RolloutResult:
    """Classic DAgger rollout (reference Simulation.rollout_dagger,
    simulation.py:1450, mixing at :1584-1589): each replanning window flips a
    Bernoulli(mpc_usage_percentage) coin for expert vs policy control."""
    coins = jax.random.uniform(rng_key, (cfg.n_windows,)) < mpc_usage_percentage

    def gate(q, w_idx, i, use_mpc, steps_blocked):
        return coins[w_idx], steps_blocked

    return _gated_rollout(
        spec, sim_params, cfg, state0, v_des, w_des, policy_fn, gate,
        start_time=start_time, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
    )


def cc_goal_fn(model, eff_frames, contact_schedule, goal_horizon: int = 1):
    """In-graph contact-conditioned goal builder for policy rollouts.

    ``contact_schedule``: (n_eff, n_events, 4) rows [step, x, y, z] from
    :class:`learning.contact_planner.ContactPlanner` — the desired schedule.
    Returns ``goal(step_idx, q) -> (3*n_eff*goal_horizon,)`` computing
    [steps-to-contact, com_x - cx, com_y - cy] per foot per horizon slot,
    matching utils.construct_cc_goal (reference utils.py:36-102) and the
    online recomputation in rollout_policy_with_cc_replanning
    (simulation.py:991-1073)."""
    sched = jnp.asarray(contact_schedule)
    ne, n_events, _ = sched.shape

    def goal(step_idx, q):
        com = K.com(model, q)
        outs = []
        for gh in range(goal_horizon):
            for ee in range(ne):
                times = sched[ee, :, 0]
                idx = jnp.clip(
                    jnp.searchsorted(times, step_idx.astype(times.dtype), side="right") + gh,
                    0,
                    n_events - 1,
                )
                row = sched[ee, idx]
                outs.append(
                    jnp.stack([row[0] - step_idx, com[0] - row[1], com[1] - row[2]])
                )
        return jnp.concatenate(outs)

    return goal


def rollout_policy_cc(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn: Callable,
    contact_schedule,  # (n_eff, n_events, 4) desired schedule
    goal_horizon: int = 1,
    **kwargs,
) -> RolloutResult:
    """Contact-conditioned policy rollout (reference
    Simulation.rollout_policy_with_cc_replanning, simulation.py:834): the
    policy consumes cc goals computed online against the desired contact
    schedule instead of vc goals."""
    gfn = cc_goal_fn(spec.model, spec.eff_frames, contact_schedule, goal_horizon)

    def goal_with_state(step_idx, q):
        return gfn(step_idx, q)

    return rollout_policy(
        spec, sim_params, cfg, state0, v_des, w_des, policy_fn,
        goal_fn=goal_with_state, **kwargs,
    )


def rollout_policy(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn: Callable,  # (obs (43+goal,),) -> action (12,)
    goal_fn: Callable = None,  # optional (step, q) -> goal vec; default vc goal
    start_time: float = 0.0,
    push_force=None,
    terrain=None,
    q_noise=None,
    v_noise=None,
) -> RolloutResult:
    """Policy rollout (reference Simulation.rollout_policy, simulation.py:582):
    the policy runs at 1 kHz on normalized [state, goal] inputs; its action is
    decoded to torques per ``cfg.action_type`` (torque / pd_target /
    structured, simulation.py:760-777)."""
    model = spec.model
    eff = spec.eff_frames

    def substep(carry, step_idx):
        step_idx = step_idx.astype(jnp.int32)
        state, failed, fail_step = carry
        q, v = _measure(state.q, state.v, q_noise, v_noise)
        feat = state_features(model, eff, q, v)
        if goal_fn is None:
            goal = vc_goal(cfg, start_time / cfg.sim_dt + step_idx, v_des, w_des)
        else:
            goal = goal_fn(step_idx, q)
        action = policy_fn(feat, goal)
        tau = _decode_action(cfg, action, q, v)
        fe = None if push_force is None else push_force[step_idx]
        new_state, cinfo = physics.step(
            model, eff, sim_params, state, tau, f_ext=fe, terrain=terrain
        )
        now_failed = failed | failed_state(cfg, q, step_idx)
        fail_step = jnp.where(now_failed & ~failed, step_idx, fail_step)
        new_state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(now_failed, a, b), state, new_state
        )
        com = K.com(model, q)
        out = (feat, action, goal, q[0:3], com, cinfo.forces, cinfo.positions, cinfo.in_contact)
        return (new_state, now_failed, fail_step), out

    init = (state0, jnp.asarray(False), jnp.asarray(cfg.episode_length, jnp.int32))
    (final_state, failed, fail_step), outs = jax.lax.scan(
        substep, init, jnp.arange(cfg.episode_length)
    )
    feat, action, goal, base, com, forces, cpos, incnt = outs
    return RolloutResult(
        states=feat,
        actions=action,
        vc_goals=goal,
        base=base,
        com=com,
        contact_forces=forces,
        contact_pos=cpos,
        in_contact=incnt,
        failed=failed,
        fail_step=fail_step,
        final_state=final_state,
        mpc_usage=jnp.zeros(cfg.episode_length),
    )
