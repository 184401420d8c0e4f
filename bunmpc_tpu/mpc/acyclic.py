"""Acyclic motion planner: jumps, cartwheels, rearing, stand.

JAX twin of the reference ``SoloAcyclicGen`` (reference
examples/mpc/abstract_acyclic_gen.py:13-468): the contact plan, nominal
states, CoM bounds, swing via-points and state/ctrl regularization all come
from *time-stamped segments* in an :class:`ACyclicMotionParams` motion file;
each MPC cycle looks up the segment active at every knot time.

The reference's per-knot Python segment search becomes a ``searchsorted``
over precomputed segment boundaries (host-side ``make_acyclic_spec`` turns
the Python lists into dense arrays once).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..solvers import biconvex, ddp
from . import ik as IK
from .centroidal import ContactPlan
from .kino_dyn import MpcPlan, _interp_1khz
from .motions.params import ACyclicMotionParams


@dataclasses.dataclass(frozen=True)
class AcyclicMpcSpec:
    model: RobotModel
    params: ACyclicMotionParams
    eff_frames: tuple
    horizon: int  # n_col
    ik_hor: int
    dt_arr: np.ndarray  # (n_col,)
    # dense segment tables (host-side constants)
    cnt_starts: np.ndarray  # (n_seg,)
    cnt_vals: np.ndarray  # (n_seg, n_eff, 4)
    xnom_starts: np.ndarray
    xnom_vals: np.ndarray  # (n_seg, 9)
    x_ter: np.ndarray  # (9,)
    bounds_starts: np.ndarray
    bounds_vals: np.ndarray  # (n_seg, 6)
    swing_starts: np.ndarray  # (n_seg,) via-point windows ([] allowed)
    swing_ends: np.ndarray
    swing_vals: np.ndarray  # (n_seg, n_eff, 4) [wt, x, y, z]
    sreg_starts: np.ndarray
    sreg_wt: np.ndarray  # (n_seg, 2nv)
    sreg_x: np.ndarray  # (n_seg, nq+nv)
    sreg_scale: np.ndarray  # (n_seg,)
    creg_starts: np.ndarray
    creg_wt: np.ndarray  # (n_seg, nv)
    creg_scale: np.ndarray  # (n_seg,)
    size: int
    n_int: int
    plan_freq: float
    bx_max: tuple = (15.0, 15.0, 15.0)

    @property
    def n_eff(self):
        return len(self.eff_frames)


def _segments(rows, n_take):
    """rows: list of [..., t_start, t_end] -> (starts, values)."""
    arr = np.asarray(rows, dtype=float)
    return arr[:, -2], arr[:, :n_take]


def make_acyclic_spec(
    model: RobotModel,
    params: ACyclicMotionParams,
    eff_frames=("FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"),
    ik_hor_ratio: float = 1.0,
    plan_freq: float | None = None,
) -> AcyclicMpcSpec:
    nv = model.nv
    n_col = int(params.n_col)
    ik_hor = int(round(ik_hor_ratio * n_col))
    dt_arr = np.asarray(params.dt_arr, float)

    cnt = np.asarray(params.cnt_plan, float)  # (n_seg, n_eff, 6)
    cnt_starts = cnt[:, 0, 4]
    cnt_vals = cnt[:, :, 0:4]

    xnom = np.asarray(params.X_nom, float)  # (n_seg, 11)
    sw = params.swing_wt
    if sw is not None and len(sw):
        sw = np.asarray(sw, float)  # (n_seg, n_eff, 6)
        swing_starts, swing_ends = sw[:, 0, 4], sw[:, 0, 5]
        swing_vals = sw[:, :, 0:4]
    else:
        swing_starts = np.array([np.inf])
        swing_ends = np.array([np.inf])
        swing_vals = np.zeros((1, len(eff_frames), 4))

    sreg_x_rows = np.asarray(params.state_reg, float)
    sreg_wt_rows = np.asarray(params.state_wt, float)
    sreg_scale = np.asarray(params.state_scale, float)
    creg_wt_rows = np.asarray(params.ctrl_wt, float)
    creg_scale = np.asarray(params.ctrl_scale, float)

    pf = plan_freq if plan_freq is not None else (
        params.plan_freq if np.isscalar(params.plan_freq) else params.plan_freq[0][0]
    )
    size = min(ik_hor, int(pf / dt_arr[0]) + 2)
    if pf > dt_arr[0]:
        size += 1
    size = min(size, ik_hor)
    n_int = size * int(round(dt_arr[0] / 0.001))

    bounds = np.asarray(params.bounds, float)
    return AcyclicMpcSpec(
        model=model,
        params=params,
        eff_frames=tuple(eff_frames),
        horizon=n_col,
        ik_hor=ik_hor,
        dt_arr=dt_arr,
        cnt_starts=cnt_starts,
        cnt_vals=cnt_vals,
        xnom_starts=xnom[:, 9],
        xnom_vals=xnom[:, 0:9],
        x_ter=np.asarray(params.X_ter, float),
        bounds_starts=bounds[:, -2],
        bounds_vals=bounds[:, 0:6],
        swing_starts=swing_starts,
        swing_ends=swing_ends,
        swing_vals=swing_vals,
        sreg_starts=sreg_scale[:, 1],
        sreg_wt=sreg_wt_rows[:, : 2 * nv],
        sreg_x=sreg_x_rows[:, : model.nq + nv],
        sreg_scale=sreg_scale[:, 0],
        creg_starts=creg_scale[:, 1],
        creg_wt=creg_wt_rows[:, :nv],
        creg_scale=creg_scale[:, 0],
        size=size,
        n_int=n_int,
        plan_freq=pf,
    )


def _lookup(starts, vals, ft):
    """Segment lookup: last segment whose start <= ft (clamps beyond-end to
    the final segment like the reference's make_cyclic=False path)."""
    idx = jnp.clip(jnp.searchsorted(jnp.asarray(starts), ft, side="right") - 1, 0, len(starts) - 1)
    return jnp.asarray(vals)[idx]


def solve_acyclic_mpc(
    spec: AcyclicMpcSpec,
    q: jnp.ndarray,
    v: jnp.ndarray,
    t: jnp.ndarray,  # time into the motion
    admm_cfg: biconvex.BiconvexConfig | None = None,
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
) -> MpcPlan:
    """One acyclic MPC solve (reference SoloAcyclicGen.optimize, :299-370)."""
    p = spec.params
    m = spec.model.total_mass
    dtype = q.dtype
    H, ik_h = spec.horizon, spec.ik_hor
    dt_arr = jnp.asarray(spec.dt_arr, dtype)
    if admm_cfg is None:
        admm_cfg = biconvex.BiconvexConfig(rho=p.rho, x_solver="thomas")

    # knot times (reference: ft advances by dt_arr from t - dt0; :86-88)
    knot_t = jnp.round(t - dt_arr[0] + jnp.cumsum(dt_arr), 3)
    dt0 = dt_arr[0] - jnp.round(jnp.mod(t, dt_arr[0]), 2)
    dt0 = jnp.where(dt0 == 0.0, dt_arr[0], dt0)
    dts = dt_arr.at[0].set(dt0)

    # contact plan from segments
    cnt4 = _lookup(spec.cnt_starts, spec.cnt_vals, knot_t)  # (H, ne, 4)
    plan = ContactPlan(cnt=cnt4[..., 0], r=cnt4[..., 1:4], dt=dts)

    # current centroidal state
    com, h_lin, h_ang = K.centroidal_momentum(spec.model, q, v)
    x_init = jnp.concatenate([com, h_lin / m, h_ang])

    X_nom = _lookup(spec.xnom_starts, spec.xnom_vals, knot_t).astype(dtype)
    X_nom = X_nom.at[0].set(x_init)  # reference :187
    X_ter = jnp.asarray(spec.x_ter, dtype)
    W = jnp.concatenate(
        [jnp.tile(jnp.asarray(p.W_X, dtype), (H, 1)), jnp.asarray(p.W_X_ter, dtype)[None]]
    )
    X_ref = jnp.concatenate([X_nom, X_ter[None]], axis=0)
    W_F = jnp.tile(jnp.asarray(p.W_F, dtype).reshape(spec.n_eff, 3), (H, 1, 1))

    bounds6 = _lookup(spec.bounds_starts, spec.bounds_vals, knot_t).astype(dtype)
    x_bounds = biconvex.kinematic_box_bounds(plan, bounds6[:, 0:3], bounds6[:, 3:6])

    X_wm = jnp.tile(x_init, (H + 1, 1))
    F_wm = jnp.zeros((H, spec.n_eff, 3), dtype)
    P_wm = jnp.zeros((H + 1, 9), dtype)
    dyn = biconvex.solve(
        plan, m, x_init, biconvex.CostX(W=W, X_ref=X_ref), W_F,
        X_wm, F_wm, P_wm, admm_cfg, x_bounds=x_bounds,
    )

    # --- IK ---
    knot_t_ik = knot_t[:ik_h]
    cnt_ik = plan.cnt[:ik_h]
    cnt_targets = plan.r[:ik_h]
    swing = _lookup(spec.swing_starts, spec.swing_vals, knot_t_ik)  # (ik_h, ne, 4)
    in_window = (knot_t_ik[:, None] >= jnp.asarray(spec.swing_starts)[0]) & (
        knot_t_ik[:, None] < jnp.asarray(spec.swing_ends)[-1]
    )
    swing_active = (swing[..., 0] > 0) & in_window & (cnt_ik == 0)
    ee_targets = jnp.where(swing_active[..., None], swing[..., 1:4], cnt_targets)
    ee_wts = jnp.where(
        cnt_ik == 1.0,
        jnp.asarray(getattr(p, "cnt_wt", 5e4), dtype),
        jnp.where(swing_active, swing[..., 0], 0.0),
    )

    com_ref = dyn.X[: ik_h + 1, 0:3]
    mom_ref = jnp.concatenate(
        [m * dyn.X[: ik_h + 1, 3:6], dyn.X[: ik_h + 1, 6:9]], axis=-1
    )
    knot_t_full = jnp.concatenate([knot_t_ik, knot_t_ik[-1:] + dt_arr[ik_h - 1]])
    state_wt = _lookup(spec.sreg_starts, spec.sreg_wt, knot_t_full).astype(dtype)
    x_reg = _lookup(spec.sreg_starts, spec.sreg_x, knot_t_full).astype(dtype)
    sscale = _lookup(spec.sreg_starts, spec.sreg_scale, knot_t_full).astype(dtype)
    ctrl_wt = _lookup(spec.creg_starts, spec.creg_wt, knot_t_ik).astype(dtype)
    cscale = _lookup(spec.creg_starts, spec.creg_scale, knot_t_ik).astype(dtype)

    tasks = IK.IkTasks(
        ee_targets=ee_targets,
        ee_wts=ee_wts,
        com_ref=com_ref,
        mom_ref=mom_ref,
        com_wt=jnp.asarray(p.cent_wt[0], dtype),
        mom_wt=jnp.asarray(p.cent_wt[1], dtype),
        state_wt=state_wt,
        x_reg=x_reg,
        reg_wt_state=sscale,
        reg_wt_ctrl=cscale,
        ctrl_wt=ctrl_wt,
        dts=dts[:ik_h],
    )
    x0 = jnp.concatenate([q, v])
    ik_res = IK.solve_ik(spec.model, spec.eff_frames, x0, tasks, ddp_cfg)

    sz = spec.size
    dts_sz = dts[:sz]

    class _S:
        size = sz
        n_int = spec.n_int

    xs_int = _interp_1khz(_S, dts_sz, ik_res.xs[: sz + 1])
    us_int = _interp_1khz(_S, dts_sz, jnp.concatenate([ik_res.us, ik_res.us[-1:]])[: sz + 1])
    f_int = _interp_1khz(_S, dts_sz, dyn.F[: sz + 1].reshape(sz + 1, -1))

    return MpcPlan(
        xs_int=xs_int,
        us_int=us_int,
        f_int=f_int,
        X_opt=dyn.X,
        F_opt=dyn.F,
        xs=ik_res.xs,
        us=ik_res.us,
        cnt_plan=cnt4,
        dyn_violation=dyn.viol_norm,
        admm_iters=dyn.admm_iters,
        ik_cost=ik_res.cost,
        P_opt=dyn.P,
    )
