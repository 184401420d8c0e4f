"""Kino-dynamic MPC orchestrator: one fused, jittable whole-body solve.

JAX twin of the reference pipeline
``SoloMpcGaitGen.optimize -> KinoDynMP::optimize`` (reference
examples/mpc/abstract_cyclic_gen.py:629-698, src/motion_planner/kino_dyn.cpp:
39-99): contact plan -> cost assembly -> centroidal ADMM -> kinematic DDP ->
1 kHz interpolation, all inside a single XLA program. ``jax.vmap(solve_mpc)``
turns it into thousands of simultaneous MPC solves — the reference's
one-solve-per-process architecture (SURVEY.md §2.9) becomes the batch axis.

Conscious deviations (documented in SURVEY.md §7.5 terms):
* X_nom's y-row anchors at the current CoM like the x-row instead of the
  reference's stale-buffer 0 anchor (abstract_cyclic_gen.py:574-578); the xy
  weights are 1e-5 so the effect is negligible.
* contact locations are not rounded to 3 decimals.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..solvers import biconvex, ddp
from ..utils import quat as Q
from . import gait as G
from . import ik as IK
from .motions.params import BiconvexMotionParams


@dataclasses.dataclass(frozen=True)
class CyclicMpcSpec:
    """Static, host-side precomputation for one (robot, gait) pair — the twin
    of SoloMpcGaitGen.__init__ + update_gait_params (abstract_cyclic_gen.py:
    17-156)."""

    model: RobotModel
    params: BiconvexMotionParams
    eff_frames: tuple
    horizon: int
    ik_hor: int
    gait: G.GaitParams
    planner: G.RaibertPlannerParams
    hip_offsets: np.ndarray  # (n_eff, 3)
    I_comp: np.ndarray  # (3, 3) composite inertia at q0 (yaw-momentum target)
    x_reg: np.ndarray  # (nq+nv,) regularization state
    size: int  # interpolation knot count (abstract_cyclic_gen.py:151-153)
    n_int: int  # 1 kHz samples produced per solve
    # kinematic CoM box + force limits (abstract_cyclic_gen.py:92-97)
    bx: float = 0.45
    by: float = 0.45
    bz: float = 0.45
    f_max: float = 15.0
    # ADMM default warm start: "tiled" = the reference's stay-put start
    # (current centroidal state tiled over the horizon, kino_dyn.cpp:83-99);
    # "vdes" = the same start with the xy/velocity rows riding the COMMAND
    # (x_init + v_des*t). The biconvex alternation is warm-start dependent:
    # on the Go2 the tiled start lands in a degenerate "procrastinating"
    # basin (plan idles ~0.6 s then overshoots; executed receding-horizon
    # slice never accelerates -> trots in place), while the vdes start lands
    # on a front-loaded plan that tracks the command (round-4 diagnosis,
    # scripts/probe_gait_trace.py).
    warm_start_style: str = "tiled"

    @property
    def n_eff(self) -> int:
        return len(self.eff_frames)


def make_cyclic_spec(
    model: RobotModel,
    params: BiconvexMotionParams,
    q0: np.ndarray,
    eff_frames=("FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"),
    hip_frames=("FL_HFE", "FR_HFE", "HL_HFE", "HR_HFE"),
    ik_hor_ratio: float = 0.5,
    foot_size: float = 0.018,
    x_reg: np.ndarray | None = None,
    offset_style: str | None = None,
    warm_start_style: str | None = None,
) -> CyclicMpcSpec:
    """Host-side setup: Raibert planning offsets relative to the CoM at q0,
    composite inertia for the yaw-momentum target (abstract_cyclic_gen.py:
    46-47).

    ``offset_style`` mirrors the reference's generator pairing:
    * "solo12_hip": hip - com with the Solo12-specific hand-tuned lateral
      nudges (SoloMpcGaitGen, abstract_cyclic_gen.py:51-76). The nudge signs
      assume Solo12's frame layout (FL at +y) — applying them to another
      robot can *narrow* the stance (this collapsed the round-2 Go2 trot:
      Go2's FL sits at -y, so the +-0.04 nudges cut the support width 8 cm).
    * "generic": foot - com, no nudges (AbstractGaitGen, the reference's
      Go2-capable path, abstract_cyclic_gen1.py:50-65).
    * None (default): "solo12_hip" for the solo family, else "generic".

    ``warm_start_style`` (None -> "tiled" for the solo family — reference
    parity, the frozen e2e fixtures depend on it — else "vdes"): see
    CyclicMpcSpec.warm_start_style.
    """
    if offset_style is None:
        offset_style = "solo12_hip" if model.name.startswith("solo") else "generic"
    if warm_start_style is None:
        warm_start_style = "tiled" if model.name.startswith("solo") else "vdes"
    if warm_start_style not in ("tiled", "vdes"):
        raise ValueError(f"unknown warm_start_style {warm_start_style!r}")
    q0j = jnp.asarray(q0)
    com0 = np.asarray(K.com(model, q0j))
    if offset_style == "solo12_hip":
        hips = np.asarray(K.frame_positions(model, q0j, hip_frames))
        offsets = np.round(hips - com0, 3)
        # contact-planning nudges: widen the stance laterally (:58-69)
        offsets[:, 1] += np.array([0.04, -0.04, 0.04, -0.04])
    elif offset_style == "generic":
        feet = np.asarray(K.frame_positions(model, q0j, eff_frames))
        offsets = np.round(feet - com0, 3)
    else:
        raise ValueError(f"unknown offset_style {offset_style!r}")
    R0 = np.asarray(Q.quat_to_rot(q0j[3:7]))
    offsets = offsets @ R0  # rotate into the base frame (:72-76)

    I_comp = np.asarray(K.composite_inertia_about_com(model, q0j))

    horizon = params.horizon
    ik_hor = params.ik_horizon(ik_hor_ratio)
    plan_freq = params.plan_freq
    size = min(ik_hor, int(plan_freq / params.gait_dt) + 2)
    if plan_freq > params.gait_dt:
        size -= 1
    n_int = size * int(round(params.gait_dt / 0.001))

    if x_reg is None:
        x_reg = np.concatenate([np.asarray(q0), np.zeros(model.nv)])

    return CyclicMpcSpec(
        model=model,
        params=params,
        eff_frames=tuple(eff_frames),
        horizon=horizon,
        ik_hor=ik_hor,
        gait=G.GaitParams(
            gait_period=params.gait_period,
            stance_percent=tuple(params.stance_percent),
            phase_offset=tuple(params.phase_offset),
            gait_dt=params.gait_dt,
            step_height=params.step_ht,
        ),
        planner=G.RaibertPlannerParams(
            hip_offsets=jnp.asarray(offsets), foot_size=foot_size
        ),
        hip_offsets=offsets,
        I_comp=I_comp,
        x_reg=np.asarray(x_reg),
        size=size,
        n_int=n_int,
        warm_start_style=warm_start_style,
    )


class MpcPlan(NamedTuple):
    """One MPC solve's outputs, interpolated to 1 kHz like the reference
    (abstract_cyclic_gen.py:677-698) plus solver diagnostics."""

    xs_int: jnp.ndarray  # (n_int, nq+nv) desired states
    us_int: jnp.ndarray  # (n_int, nv) desired accelerations
    f_int: jnp.ndarray  # (n_int, n_eff*3) feed-forward forces
    X_opt: jnp.ndarray  # (H+1, 9) centroidal trajectory
    F_opt: jnp.ndarray  # (H, n_eff, 3)
    xs: jnp.ndarray  # (ik_hor+1, nq+nv) IK knots
    us: jnp.ndarray  # (ik_hor, nv)
    cnt_plan: jnp.ndarray  # (H, n_eff, 4) [flag, x, y, z] reference layout
    dyn_violation: jnp.ndarray  # ()
    admm_iters: jnp.ndarray  # ()
    ik_cost: jnp.ndarray  # ()
    P_opt: jnp.ndarray  # (H+1, 9) ADMM scaled dual; feeds warm_start carry


def _interp_1khz(spec: CyclicMpcSpec, dts, knots):
    """Linear interpolation of per-knot values onto the 1 ms grid — the
    vectorized, static-shape equivalent of the reference's np.linspace loop
    (abstract_cyclic_gen.py:677-692). ``knots``: (K+1, d) covering the first
    ``size`` knots; ``dts``: (size,) durations."""
    bounds = jnp.concatenate([jnp.zeros(1, dts.dtype), jnp.cumsum(dts)])
    tau = (jnp.arange(spec.n_int, dtype=dts.dtype)) * 0.001
    k = jnp.clip(jnp.searchsorted(bounds, tau, side="right") - 1, 0, spec.size - 1)
    t0 = bounds[k]
    w = jnp.clip((tau - t0) / dts[k], 0.0, 1.0)
    return knots[k] * (1 - w[:, None]) + knots[k + 1] * w[:, None]


def _prepare_problem(
    spec: CyclicMpcSpec, q, v, t, v_des, w_des, noise_xy=None, terrain=None,
    warm_start=None,
):
    """Single-sample problem assembly: contact plan + dynamics costs + warm
    starts (abstract_cyclic_gen.py create_cnt_plan/create_costs).

    ``warm_start``: optional (X_wm, F_wm) overriding the reference's cold
    warm start (current centroidal state tiled, zero forces — kino_dyn.cpp:
    83-99); a receding-horizon caller passes the previous solution shifted
    one window (see sim/rollout.py)."""
    p = spec.params
    m = spec.model.total_mass
    dtype = q.dtype
    H = spec.horizon

    # origin reset (abstract_cyclic_gen.py:632-633); the pre-reset world xy
    # maps plan coordinates back onto the (world-frame) terrain heightfield
    xy_world = q[0:2]
    q = q.at[0:2].set(0.0)
    t = jnp.asarray(t, dtype)  # guard against x64 time arithmetic upstream
    Rfull = Q.quat_to_rot(q[3:7])
    v_des_w = Rfull @ v_des  # :641-643

    # current centroidal state + foot positions from ONE shared FK pass
    # (don't rely on XLA CSE to dedupe two separate fk() subgraphs)
    com, h_lin, h_ang, ee_pos = K.centroidal_state_and_frames(
        spec.model, q, v, spec.eff_frames
    )
    x_init = jnp.concatenate([com, h_lin / m, h_ang])
    plan, swing_mask = G.create_cnt_plan(
        spec.gait, spec.planner, H, q, t, v_des_w, w_des, com, ee_pos,
        noise_xy=noise_xy, terrain=terrain, terrain_offset=xy_world,
    )

    # --- dynamics costs (create_costs, abstract_cyclic_gen.py:564-614) ---
    dt_arr = plan.dt
    xy_nom = x_init[0:2] + jnp.cumsum(
        v_des_w[None, 0:2] * dt_arr[:, None], axis=0
    ) - v_des_w[0:2] * dt_arr[0]  # knot 0 anchors at the current CoM
    # nominal height rides the local ground under the planned CoM path when a
    # terrain heightfield is given (flat ground: identical to the reference)
    ground_nom = 0.0 if terrain is None else terrain.height_at(xy_nom + xy_world)
    X_nom = jnp.zeros((H, 9), dtype)
    X_nom = X_nom.at[:, 0:2].set(xy_nom)
    X_nom = X_nom.at[:, 2].set(p.nom_ht + ground_nom)
    X_nom = X_nom.at[:, 3:6].set(v_des_w)

    # orientation-correction angular momentum (:584-607, :616-627)
    ori_des = jnp.where(w_des != 0.0, q[3:7], jnp.array([0.0, 0.0, 0.0, 1.0], dtype))
    des_yaw = Q.yaw_quat(ori_des)
    amom = Q.log3_quat(Q.quat_mul(des_yaw, Q.quat_conj(q[3:7])))
    oc = jnp.asarray(p.ori_correction, dtype)
    yaw_mom = (jnp.asarray(spec.I_comp, dtype) @ jnp.array([0.0, 0.0, 1.0], dtype))[2] * w_des
    amom_z_nom = jnp.where(w_des == 0.0, amom[2] * oc[2], yaw_mom)
    X_nom = X_nom.at[:, 6].set(amom[0] * oc[0])
    X_nom = X_nom.at[:, 7].set(amom[1] * oc[1])
    X_nom = X_nom.at[:, 8].set(amom_z_nom)

    X_ter = jnp.zeros(9, dtype)
    X_ter = X_ter.at[0:2].set(x_init[0:2] + (p.gait_horizon * p.gait_period * v_des_w)[0:2])
    ground_ter = 0.0 if terrain is None else terrain.height_at(X_ter[0:2] + xy_world)
    X_ter = X_ter.at[2].set(p.nom_ht + ground_ter)
    X_ter = X_ter.at[3:6].set(v_des_w)
    X_ter = X_ter.at[6:8].set(amom[0:2])
    X_ter = X_ter.at[8].set(jnp.where(w_des == 0.0, amom[2], yaw_mom))

    W = jnp.concatenate(
        [jnp.tile(jnp.asarray(p.W_X, dtype), (H, 1)), jnp.asarray(p.W_X_ter, dtype)[None]]
    )
    X_ref = jnp.concatenate([X_nom, X_ter[None]], axis=0)
    W_F = jnp.tile(jnp.asarray(p.W_F, dtype).reshape(spec.n_eff, 3), (H, 1, 1))

    # mass-normalized force regularization reference point (params.py
    # f_reg_style): active feet share m g per knot; swing feet pull to zero
    if p.f_reg_style == "weight":
        cnt_flags = plan.cnt  # (H, ne)
        n_act = jnp.maximum(jnp.sum(cnt_flags, axis=-1, keepdims=True), 1.0)
        F_ref = jnp.zeros((H, spec.n_eff, 3), dtype).at[..., 2].set(
            cnt_flags * (m * 9.81) / n_act
        )
    else:
        F_ref = None

    b_lo = jnp.array([-spec.bx, -spec.by, 0.0], dtype)
    b_hi = jnp.array([spec.bx, spec.by, spec.bz], dtype)
    x_bounds = biconvex.kinematic_box_bounds(plan, b_lo, b_hi)

    if warm_start is None:
        X_wm = jnp.tile(x_init, (H + 1, 1))  # kino_dyn.cpp:83-99
        if spec.warm_start_style == "vdes":
            # ride the command: xy ramp + velocity rows at v_des. Selects the
            # front-loaded basin of the biconvex alternation (see
            # CyclicMpcSpec.warm_start_style).
            tgrid = jnp.concatenate([jnp.zeros(1, dtype), jnp.cumsum(dt_arr)])
            X_wm = X_wm.at[:, 0:2].add(tgrid[:, None] * v_des_w[None, 0:2])
            X_wm = X_wm.at[:, 3:6].set(v_des_w[None, :])
        F_wm = jnp.zeros((H, spec.n_eff, 3), dtype)
    else:
        X_wm, F_wm = warm_start[0], warm_start[1]
    out = dict(
        q=q, v=v, plan=plan, swing_mask=swing_mask, x_init=x_init,
        W=W, X_ref=X_ref, W_F=W_F, x_bounds=x_bounds, X_wm=X_wm, F_wm=F_wm,
    )
    if F_ref is not None:
        out["F_ref"] = F_ref
    return out


def _build_ik_tasks(spec: CyclicMpcSpec, prob, dyn_X):
    """IK task construction from the dynamics solution (single sample):
    tracking targets from the dyn plan (kino_dyn.cpp:50-56) + swing tasks
    (abstract_cyclic_gen.py:545-554). Returns (tasks, x0)."""
    p = spec.params
    m = spec.model.total_mass
    q, v = prob["q"], prob["v"]
    plan, swing_mask = prob["plan"], prob["swing_mask"]
    dtype = q.dtype
    ik_h = spec.ik_hor
    dt_arr = plan.dt

    # --- IK tracking targets from the dynamics plan (kino_dyn.cpp:50-56) ---
    com_ref = dyn_X[: ik_h + 1, 0:3]
    mom_ref = jnp.concatenate(
        [m * dyn_X[: ik_h + 1, 3:6], dyn_X[: ik_h + 1, 6:9]], axis=-1
    )

    # swing/contact foot tasks (abstract_cyclic_gen.py:545-554)
    cnt_ik = plan.cnt[:ik_h]
    ee_targets = plan.r[:ik_h]
    # via height is ground-relative: plan z = local ground + foot_size, so
    # (z - foot_size) + step_ht reduces to step_ht on flat ground (reference
    # semantics) and follows the heightfield on uneven terrain
    via_z = ee_targets[..., 2] - spec.planner.foot_size + p.step_ht
    via_targets = ee_targets.at[..., 2].set(via_z)
    is_via = swing_mask[:ik_h] & (cnt_ik == 0)
    ee_targets = jnp.where(is_via[..., None], via_targets, ee_targets)
    ee_wts = jnp.where(
        cnt_ik == 1.0,
        jnp.asarray(p.swing_wt[0], dtype),
        jnp.where(is_via, jnp.asarray(p.swing_wt[1], dtype), 0.0),
    )

    tasks = IK.IkTasks(
        ee_targets=ee_targets,
        ee_wts=ee_wts,
        com_ref=com_ref,
        mom_ref=mom_ref,
        com_wt=jnp.asarray(p.cent_wt[0], dtype),
        mom_wt=jnp.asarray(p.cent_wt[1], dtype),
        state_wt=jnp.asarray(p.state_wt, dtype),
        x_reg=jnp.asarray(spec.x_reg, dtype),
        reg_wt_state=p.reg_wt[0],
        reg_wt_ctrl=p.reg_wt[1],
        ctrl_wt=jnp.asarray(p.ctrl_wt, dtype),
        dts=dt_arr[:ik_h],
    )
    x0 = jnp.concatenate([q, v])
    return tasks, x0


def _finish_solve(spec: CyclicMpcSpec, prob, dyn: biconvex.BiconvexResult, ddp_cfg):
    """Single-sample IK from the dynamics solution, then 1 kHz interpolation
    and plan assembly (abstract_cyclic_gen.py:677-698)."""
    tasks, x0 = _build_ik_tasks(spec, prob, dyn.X)
    ik = IK.solve_ik(spec.model, spec.eff_frames, x0, tasks, ddp_cfg)
    plan = prob["plan"]
    sz = spec.size
    dts_sz = plan.dt[:sz]
    xs_int = _interp_1khz(spec, dts_sz, ik.xs[: sz + 1])
    us_int = _interp_1khz(spec, dts_sz, jnp.concatenate([ik.us, ik.us[-1:]])[: sz + 1])
    f_int = _interp_1khz(spec, dts_sz, dyn.F[: sz + 1].reshape(sz + 1, -1))
    return MpcPlan(
        xs_int=xs_int,
        us_int=us_int,
        f_int=f_int,
        X_opt=dyn.X,
        F_opt=dyn.F,
        xs=ik.xs,
        us=ik.us,
        cnt_plan=jnp.concatenate([plan.cnt[..., None], plan.r], axis=-1),
        dyn_violation=dyn.viol_norm,
        admm_iters=dyn.admm_iters,
        ik_cost=ik.cost,
        P_opt=dyn.P,
    )


def solve_mpc(
    spec: CyclicMpcSpec,
    q: jnp.ndarray,  # (nq,)
    v: jnp.ndarray,  # (nv,)
    t: jnp.ndarray,  # () gait clock
    v_des: jnp.ndarray,  # (3,) commanded CoM velocity (base heading frame)
    w_des: jnp.ndarray,  # () commanded yaw rate
    admm_cfg: biconvex.BiconvexConfig | None = None,
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
    noise_xy=None,  # optional (H, n_eff, 2) contact-location noise
    terrain=None,  # optional sim.physics.Terrain: uneven-ground planning
    warm_start=None,  # optional (X_wm, F_wm, P_wm) from a previous solve
) -> MpcPlan:
    """One full kino-dynamic MPC solve (single sample; vmap for batches).

    ``warm_start``: receding-horizon warm start (X, F, dual P) — typically the
    previous window's solution shifted one window (sim/rollout.py carries it).
    Default is the reference's cold start (kino_dyn.cpp:83-99)."""
    p = spec.params
    if admm_cfg is None:
        admm_cfg = biconvex.BiconvexConfig(rho=p.rho, x_solver="thomas")
    prob = _prepare_problem(
        spec, q, v, t, v_des, w_des, noise_xy=noise_xy, terrain=terrain,
        warm_start=None if warm_start is None else warm_start[:2],
    )
    H = spec.horizon
    dtype = q.dtype
    P_wm = jnp.zeros((H + 1, 9), dtype) if warm_start is None else warm_start[2]
    dyn = biconvex.solve(
        prob["plan"],
        spec.model.total_mass,
        prob["x_init"],
        biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"]),
        prob["W_F"],
        prob["X_wm"],
        prob["F_wm"],
        P_wm,
        admm_cfg,
        x_bounds=prob["x_bounds"],
        F_ref=prob.get("F_ref"),
    )
    return _finish_solve(spec, prob, dyn, ddp_cfg)


def solve_mpc_batch(
    spec: CyclicMpcSpec,
    q: jnp.ndarray,  # (B, nq)
    v: jnp.ndarray,  # (B, nv)
    t: jnp.ndarray,  # (B,)
    v_des: jnp.ndarray,  # (B, 3)
    w_des: jnp.ndarray,  # (B,)
    admm_cfg: biconvex.BiconvexConfig | None = None,
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
) -> MpcPlan:
    """Batched kino-dynamic MPC: ``solve_mpc`` vmapped over the leading axis.

    Every stage (assembly, centroidal ADMM, kinematic GN-DDP, interpolation)
    is one XLA program over the whole batch; the ADMM and FISTA loops retire
    lanes by a per-problem convergence mask, so any B works."""
    return jax.vmap(
        lambda q, v, t, vd, wd: solve_mpc(
            spec, q, v, t, vd, wd, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg
        )
    )(q, v, t, v_des, w_des)
