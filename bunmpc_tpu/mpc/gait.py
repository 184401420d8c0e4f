"""Cyclic gait phase machine + vectorized Raibert contact planner.

JAX twins of the reference ``GaitPlanner`` (reference
src/gait_planner/gait_planner.cpp:31-121) and ``SoloMpcGaitGen.create_cnt_plan``
(reference examples/mpc/abstract_cyclic_gen.py:159-414).

The reference builds the plan with a Python double loop over
(horizon x feet), feeding C++ one knot at a time. Here the whole plan is one
fused array program: phases for all (knot, foot) pairs come from a broadcast
modulo, and the only true sequential dependency — a foot in contact keeps the
location planned at its touchdown — is a tiny ``lax.scan`` over the horizon
(H ~ 20) with all feet and batch elements in parallel.

Reference quirks preserved (SURVEY.md §7.5):
* first-knot dt shrink ``dt0 = gait_dt - (t mod gait_dt)`` (rounded to 2
  decimals, abstract_cyclic_gen.py:385-390),
* hip projection uses the knot index ``i * gait_dt`` (not cumulative dt),
* stance tolerance ``phi <= stance_time + 1e-4`` (gait_planner.cpp:48-49),
* the swing via-point flag fires for the whole first half of swing
  (``per_ph - 0.5 < 0.02``, abstract_cyclic_gen.py:367).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

from ..utils.quat import quat_to_rot, yaw_quat
from .centroidal import ContactPlan

_G = 9.81


@dataclasses.dataclass(frozen=True)
class GaitParams:
    """Static cyclic-gait timing (reference BiconvexMotionParams contact block,
    examples/motions/weight_abstract.py:15-22)."""

    gait_period: float
    stance_percent: tuple  # per foot
    phase_offset: tuple  # per foot
    gait_dt: float
    step_height: float


def phi(params: GaitParams, t, foot_offsets=None):
    """Phase time for each foot: fmod(t + offset*period, period) (..., n_eff)."""
    t = jnp.asarray(t)
    off = (
        jnp.asarray(params.phase_offset, t.dtype) if foot_offsets is None else foot_offsets
    )
    return jnp.mod(t[..., None] + off * params.gait_period, params.gait_period)


def in_stance(params: GaitParams, t):
    """1 if the foot is in stance at time t (..., n_eff); includes the
    reference's 1e-4 boundary tolerance (gait_planner.cpp:46-58)."""
    st = jnp.asarray(params.stance_percent, jnp.asarray(t).dtype) * params.gait_period
    ph = phi(params, t)
    return (ph <= st + 1e-4).astype(ph.dtype)


def percent_in_phase(params: GaitParams, t):
    """Fraction of the current (stance or swing) phase elapsed (..., n_eff)."""
    st = jnp.asarray(params.stance_percent, jnp.asarray(t).dtype) * params.gait_period
    ph = phi(params, t)
    stance = ph <= st + 1e-4
    return jnp.where(stance, ph / st, (ph - st) / (params.gait_period - st))


def contact_phase_plan(params: GaitParams, t, horizon: int, dt: float):
    """Batched stance flags over a horizon (gait_planner.cpp:96-102)."""
    ts = t[..., None] + jnp.arange(horizon) * dt
    return in_stance(params, ts)


@dataclasses.dataclass(frozen=True)
class RaibertPlannerParams:
    """Static planner constants derived from the robot at q0
    (abstract_cyclic_gen.py:51-76)."""

    hip_offsets: jnp.ndarray  # (n_eff, 3) hip positions relative to CoM at q0
    foot_size: float


def first_knot_dt(params: GaitParams, t):
    """dt of the first knot (abstract_cyclic_gen.py:385-390)."""
    dt0 = params.gait_dt - jnp.round(jnp.mod(t, params.gait_dt), 2)
    return jnp.where(dt0 == 0.0, params.gait_dt, dt0)


def create_cnt_plan(
    gait: GaitParams,
    planner: RaibertPlannerParams,
    horizon: int,
    q,  # (..., nq)
    t,  # (...,)
    v_des,  # (..., 3) desired CoM velocity (already in the heading frame)
    w_des,  # (...,)
    com,  # (..., 3) current CoM (world)
    ee_pos,  # (..., n_eff, 3) current foot positions (world)
    noise_xy=None,  # optional (..., H, n_eff, 2) touchdown-location noise
    terrain=None,  # optional sim.physics.Terrain (uneven-ground planning)
    terrain_offset=None,  # (..., 2) world xy of the plan origin (q is origin-reset)
):
    """Build the dense contact plan (ContactPlan + swing-via mask).

    Returns ``(plan, swing_mask)`` where ``swing_mask`` marks knots where the
    step-height via cost applies in the IK (abstract_cyclic_gen.py:366-368).

    With ``terrain`` set, touchdown/swing heights come from the heightfield at
    the planned xy (the reference plans flat ground only; its terrain
    generator is broken, pybullet_env.py:154-201). The plan frame is
    origin-reset, so ``terrain_offset`` maps plan xy back to world xy.
    """
    ne = planner.hip_offsets.shape[0]
    dtype = q.dtype
    # heading (yaw-only) frame of the base (abstract_cyclic_gen.py:172-177)
    R = quat_to_rot(yaw_quat(q[..., 3:7]))
    vtrack = v_des[..., 0:2]
    z_h = com[..., 2]

    hip_world = jnp.einsum("...ij,nj->...ni", R, planner.hip_offsets.astype(dtype))  # (..., ne, 3)
    raibert = (
        0.5
        * vtrack[..., None, :]
        * gait.gait_period
        * jnp.asarray(gait.stance_percent, dtype)[:, None]
    )  # (..., ne, 2); the -0.05*(vtrack - v_des) term vanishes since vtrack==v_des
    ang = 0.5 * jnp.sqrt(z_h / _G)[..., None] * vtrack  # (..., 2)
    # np.cross([ax, ay, 0], [0, 0, w]) = [ay*w, -ax*w, 0]
    ang_step = jnp.stack(
        [ang[..., 1] * w_des, -ang[..., 0] * w_des], axis=-1
    )  # (..., 2)

    knot_idx = jnp.arange(horizon, dtype=dtype)
    knot_t = t[..., None] + knot_idx * gait.gait_dt  # (..., H)

    # stance flags and phase percents for every (knot, foot)
    cnt = in_stance(gait, knot_t)  # (..., H, ne) via broadcasting on t
    per_ph = percent_in_phase(gait, knot_t)

    # hip projection per knot: com_xy + R*offset + i*gait_dt*vtrack
    drift = knot_idx[:, None] * gait.gait_dt * vtrack[..., None, :]  # (..., H, 2)
    hip_xy = com[..., None, None, 0:2] + hip_world[..., None, :, 0:2] + drift[..., :, None, :]
    touchdown_xy = hip_xy + raibert[..., None, :, :] + ang_step[..., None, None, :]
    if noise_xy is not None:
        # contact-location fault injection (abstract_cyclic_gen.py:376-384):
        # scaled by the norm of the planned location
        nrm = jnp.linalg.norm(touchdown_xy, axis=-1, keepdims=True)
        touchdown_xy = touchdown_xy + nrm * noise_xy
    swing_early_xy = hip_xy + ang_step[..., None, None, :]
    swing_late_xy = touchdown_xy

    if terrain is None:
        z_td = jnp.full(touchdown_xy.shape[:-1], planner.foot_size, dtype)
        z_sw_early = z_td
    else:
        off = 0.0 if terrain_offset is None else terrain_offset[..., None, None, :]
        z_td = terrain.height_at(touchdown_xy + off) + planner.foot_size
        z_sw_early = terrain.height_at(swing_early_xy + off) + planner.foot_size
    touchdown = jnp.concatenate([touchdown_xy, z_td[..., None]], axis=-1)  # (..., H, ne, 3)
    swing_loc = jnp.where(
        (per_ph < 0.5)[..., None],
        jnp.concatenate([swing_early_xy, z_sw_early[..., None]], axis=-1),
        jnp.concatenate([swing_late_xy, z_td[..., None]], axis=-1),
    )

    # swing via-point mask (quirk: first half of swing); never on knot 0,
    # which always keeps the measured foot pose (abstract_cyclic_gen.py:205-255)
    swing_mask = (cnt == 0) & (per_ph - 0.5 < 0.02)
    swing_mask = swing_mask.at[..., 0, :].set(False)

    # sequential location carry: while in contact, keep the touchdown location
    def scan_body(carry, inp):
        prev_cnt, prev_r = carry
        c_i, td_i, sw_i = inp
        landed = (c_i == 1) & (prev_cnt == 0)
        r_i = jnp.where(
            c_i[..., None] == 1,
            jnp.where(landed[..., None], td_i, prev_r),
            sw_i,
        )
        return (c_i, r_i), r_i

    # knot 0: current foot positions regardless of phase (abstract_cyclic_gen.py:205-255)
    r0 = ee_pos
    cnt0 = cnt[..., 0, :]

    xs = (
        jnp.moveaxis(cnt[..., 1:, :], -2, 0),
        jnp.moveaxis(touchdown[..., 1:, :, :], -3, 0),
        jnp.moveaxis(swing_loc[..., 1:, :, :], -3, 0),
    )
    (_, _), r_rest = lax.scan(scan_body, (cnt0, r0), xs)
    r_rest = jnp.moveaxis(r_rest, 0, -3)  # back to (..., H-1, ne, 3)
    r = jnp.concatenate([r0[..., None, :, :], r_rest], axis=-3)

    dt0 = first_knot_dt(gait, t)
    dts = jnp.broadcast_to(
        jnp.asarray(gait.gait_dt, dtype), knot_t.shape
    ).at[..., 0].set(dt0)

    return ContactPlan(cnt=cnt, r=r, dt=dts), swing_mask
