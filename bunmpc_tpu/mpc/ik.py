"""Kinematic-IK cost assembly for the DDP sweep.

JAX twin of the reference IK task API (reference
src/ik/inverse_kinematics.cpp + src/ik/{com_tasks,end_effector_tasks,
regularization_costs}.cpp, driven from examples/mpc/abstract_cyclic_gen.py:
545-562 and src/motion_planner/kino_dyn.cpp:53-56).

Instead of mutable cost containers populated by ``add_*`` calls, the stage
cost is one fixed-shape weighted residual vector per knot:

    r_k = [ ee-position residuals (n_eff*3) — weight swing_wt[0] on contact
            knots (target = planned contact location) or swing_wt[1] on
            via knots (target z lifted to step height), 0 otherwise;
            CoM tracking (3)        — weight cent_wt[0], target from ADMM;
            momentum tracking (6)   — weight cent_wt[1], target from ADMM;
            state regularization (2nv) — weight reg_wt[0]*state_wt ]

which reproduces crocoddyl's CostModelSum of CostModelResidual terms exactly
(Gauss-Newton, weighted-quad activations) while keeping every shape static.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..solvers import ddp
from ..utils import quat as Q


@dataclasses.dataclass(frozen=True)
class IkTasks:
    """Per-solve IK task data (all arrays, single sample; vmap for batches).

    ``state_wt``/``x_reg``/``reg_wt_state``/``ctrl_wt``/``reg_wt_ctrl`` may be
    single vectors/scalars (cyclic gaits) or per-knot arrays with a leading
    (H+1,) / (H,) axis (acyclic motions with time-windowed regularization,
    reference abstract_acyclic_gen.py:222-283)."""

    ee_targets: jnp.ndarray  # (H, n_eff, 3) tracked foot positions
    ee_wts: jnp.ndarray  # (H, n_eff) per-knot per-foot weights
    com_ref: jnp.ndarray  # (H+1, 3) from the dynamics solve
    mom_ref: jnp.ndarray  # (H+1, 6) [lin(3), ang(3)] momentum targets
    com_wt: jnp.ndarray  # () cent_wt[0]
    mom_wt: jnp.ndarray  # () cent_wt[1]
    state_wt: jnp.ndarray  # (2nv,) or (H+1, 2nv)
    x_reg: jnp.ndarray  # (nq+nv,) or (H+1, nq+nv)
    reg_wt_state: float | jnp.ndarray  # scalar or (H+1,)
    reg_wt_ctrl: float | jnp.ndarray  # scalar or (H,)
    ctrl_wt: jnp.ndarray  # (nv,) or (H, nv)
    dts: jnp.ndarray  # (H,)


def build_residual_fns(model: RobotModel, eff_frames, tasks: IkTasks):
    """Returns (stage_residuals(x, k), term_residuals(x), ctrl_weight (H, nv))."""
    H = tasks.ee_targets.shape[0]
    nq, nv = model.nq, model.nv

    state_wt = jnp.broadcast_to(tasks.state_wt, (H + 1, 2 * nv))
    x_reg = jnp.broadcast_to(tasks.x_reg, (H + 1, nq + nv))
    reg_wt_state = jnp.broadcast_to(jnp.asarray(tasks.reg_wt_state), (H + 1,))
    reg_wt_ctrl = jnp.broadcast_to(jnp.asarray(tasks.reg_wt_ctrl), (H,))
    ctrl_wt = jnp.broadcast_to(tasks.ctrl_wt, (H, nv))

    def split(x):
        return x[:nq], x[nq:]

    def common(x, k):
        q, v = split(x)
        com, h_lin, h_ang, ee = K.centroidal_state_and_frames(model, q, v, eff_frames)
        sdiff = ddp._state_diff(model, x_reg[k], x)
        return com, jnp.concatenate([h_lin, h_ang]), ee, sdiff

    def stage_residuals(x, k):
        com, h, ee, sdiff = common(x, k)
        r_ee = (ee - tasks.ee_targets[k]).reshape(-1)
        w_ee = jnp.repeat(tasks.ee_wts[k], 3)
        r_com = com - tasks.com_ref[k]
        r_mom = h - tasks.mom_ref[k]
        r = jnp.concatenate([r_ee, r_com, r_mom, sdiff])
        w = jnp.concatenate(
            [
                w_ee,
                jnp.full(3, tasks.com_wt, x.dtype),
                jnp.full(6, tasks.mom_wt, x.dtype),
                reg_wt_state[k] * state_wt[k],
            ]
        )
        return r, w

    def term_residuals(x):
        com, h, _, sdiff = common(x, H)
        r = jnp.concatenate([com - tasks.com_ref[H], h - tasks.mom_ref[H], sdiff])
        w = jnp.concatenate(
            [
                jnp.full(3, tasks.com_wt, x.dtype),
                jnp.full(6, tasks.mom_wt, x.dtype),
                reg_wt_state[H] * state_wt[H],
            ]
        )
        return r, w

    ctrl_weight = reg_wt_ctrl[:, None] * ctrl_wt
    return stage_residuals, term_residuals, ctrl_weight


def dense_weights(model: RobotModel, eff_frames, tasks: IkTasks):
    """Dense residual-weight tensors in build_residual_fns' row layout —
    the input format of the native IK twin (native/bindings.py).

    Returns (w_stage (H, nr), w_term (nrt,), ctrl_weight (H, nv),
    x_reg (H+1, nq+nv)) with nr = 3*n_eff + 9 + 2nv, nrt = 9 + 2nv."""
    H = tasks.ee_targets.shape[0]
    nq, nv = model.nq, model.nv
    dtype = tasks.ee_targets.dtype

    state_wt = jnp.broadcast_to(tasks.state_wt, (H + 1, 2 * nv))
    x_reg = jnp.broadcast_to(tasks.x_reg, (H + 1, nq + nv))
    reg_wt_state = jnp.broadcast_to(jnp.asarray(tasks.reg_wt_state), (H + 1,))
    reg_wt_ctrl = jnp.broadcast_to(jnp.asarray(tasks.reg_wt_ctrl), (H,))
    ctrl_wt = jnp.broadcast_to(tasks.ctrl_wt, (H, nv))

    w_ee = jnp.repeat(tasks.ee_wts, 3, axis=-1)  # (H, 3*n_eff)
    w_com = jnp.full((H, 3), tasks.com_wt, dtype)
    w_mom = jnp.full((H, 6), tasks.mom_wt, dtype)
    w_sd = reg_wt_state[:H, None] * state_wt[:H]
    w_stage = jnp.concatenate([w_ee, w_com, w_mom, w_sd], axis=-1)
    w_term = jnp.concatenate(
        [
            jnp.full(3, tasks.com_wt, dtype),
            jnp.full(6, tasks.mom_wt, dtype),
            reg_wt_state[H] * state_wt[H],
        ]
    )
    return w_stage, w_term, reg_wt_ctrl[:, None] * ctrl_wt, x_reg


def build_jacobian_fns(model: RobotModel, eff_frames, tasks: IkTasks):
    """Structured Gauss-Newton Jacobians for the IK residual stack — the
    JAX replacement for brute-force tangent ``jacfwd`` over the fused
    residual (the dominant cost of the whole MPC solve).

    Exploits the residual structure (crocoddyl computes the same blocks
    analytically per cost model, reference src/ik/{com_tasks,
    end_effector_tasks,regularization_costs}.cpp):

    * EE-position rows: analytic frame Jacobians from ONE shared FK
      (``kin.frame_jacobian``; zero wrt v).
    * CoM+momentum rows wrt dq: 9-row ``jacrev`` through the FK chain
      (9 VJPs instead of 36 JVPs of the fused residual).
    * momentum rows wrt dv: ``h = Ag(q)·v`` is linear in v, so a v-tangent
      ``jacfwd`` carries tangents only through the v-linear chain (XLA prunes
      the FK tangents) — essentially free, and yields the centroidal momentum
      matrix Ag. CoM rows wrt dv are zero.
    * state-regularization rows: identity blocks except the 6x6 base block,
      the right-Jacobian-inverse of the SE(3) difference — computed by a
      6-dim chart ``jacfwd`` touching only quaternion ops (no FK).
    * dynamics Fx/Fu (semi-implicit Euler on the manifold,
      reference src/ik/action_model.cpp:89-90 has Fx=0, Fu=I at the
      acceleration level): closed form for all rows except the 6x6 base
      blocks (SE(3) adjoint / right Jacobian), done by an 18-dim chart
      ``jacfwd`` (no FK).
    """
    H = tasks.ee_targets.shape[0]
    nq, nv = model.nq, model.nv
    ndx = 2 * nv
    nj = nv - 6

    state_wt = jnp.broadcast_to(tasks.state_wt, (H + 1, 2 * nv))
    x_reg = jnp.broadcast_to(tasks.x_reg, (H + 1, nq + nv))
    reg_wt_state = jnp.broadcast_to(jnp.asarray(tasks.reg_wt_state), (H + 1,))

    def stage_w(k, dtype):
        return jnp.concatenate(
            [
                jnp.repeat(tasks.ee_wts[k], 3),
                jnp.full(3, tasks.com_wt, dtype),
                jnp.full(6, tasks.mom_wt, dtype),
                reg_wt_state[k] * state_wt[k],
            ]
        )

    def _com_mom_jac(q, v, dtype):
        """(9, ndx): [dcom/dq; dh/dq | 0; Ag]."""

        def g_of_dq(dq):
            q2 = K.integrate(model, q, dq)
            com, h_lin, h_ang = K.centroidal_momentum(model, q2, v)
            return jnp.concatenate([com, h_lin, h_ang])

        G = jax.jacrev(g_of_dq)(jnp.zeros(nv, dtype))  # (9, nv)

        def h_of_v(v2):
            _, h_lin, h_ang = K.centroidal_momentum(model, q, v2)
            return jnp.concatenate([h_lin, h_ang])

        Ag = jax.jacfwd(h_of_v)(v)  # (6, nv)
        Gv = jnp.concatenate([jnp.zeros((3, nv), dtype), Ag], axis=0)
        return jnp.concatenate([G, Gv], axis=1)

    def _sdiff_jac(q, xr, dtype):
        """(ndx, ndx) Jacobian of _state_diff(x_reg, x) wrt the x tangent."""

        def base_diff(d6):
            p2, q2 = Q.se3_integrate(q[0:3], q[3:7], d6[0:3], d6[3:6])
            dv_, dw_ = Q.se3_difference(xr[0:3], xr[3:7], p2, q2)
            return jnp.concatenate([dv_, dw_])

        B6 = jax.jacfwd(base_diff)(jnp.zeros(6, dtype))  # (6, 6)
        J = jnp.zeros((ndx, ndx), dtype)
        J = J.at[0:6, 0:6].set(B6)
        J = J.at[6:nv, 6:nv].set(jnp.eye(nj, dtype=dtype))
        J = J.at[nv:, nv:].set(jnp.eye(nv, dtype=dtype))
        return J

    def _ee_jac(q, dtype):
        """(3*n_eff, ndx): stacked frame Jacobians, zero wrt v."""
        R, p = K.fk(model, q)
        Js = [K.frame_jacobian(model, q, name, R=R, p=p) for name in eff_frames]
        Jq = jnp.concatenate(Js, axis=0)  # (3*n_eff, nv)
        return jnp.concatenate([Jq, jnp.zeros_like(Jq)], axis=1)

    def _dyn_jacs(x, u, dt, dtype):
        """Fx (ndx, ndx), Fu (ndx, nv) of the semi-implicit Euler step in
        tangent coordinates (exact; base blocks via the SE(3) chart)."""
        q, v = x[:nq], x[nq:]
        v_next = v + u * dt
        # reference next base pose (primal step)
        pb, qb = Q.se3_integrate(q[0:3], q[3:7], v_next[0:3] * dt, v_next[3:6] * dt)

        def base_step_diff(d18):
            dq6, dv6, du6 = d18[0:6], d18[6:12], d18[12:18]
            p1, q1 = Q.se3_integrate(q[0:3], q[3:7], dq6[0:3], dq6[3:6])
            w6 = (v_next[0:6] + dv6 + du6 * dt) * dt
            p2, q2 = Q.se3_integrate(p1, q1, w6[0:3], w6[3:6])
            dv_, dw_ = Q.se3_difference(pb, qb, p2, q2)
            return jnp.concatenate([dv_, dw_])

        M = jax.jacfwd(base_step_diff)(jnp.zeros(18, dtype))  # (6, 18)
        A6, Bv6, Bu6 = M[:, 0:6], M[:, 6:12], M[:, 12:18]

        Fx = jnp.zeros((ndx, ndx), dtype)
        Fx = Fx.at[0:6, 0:6].set(A6)
        Fx = Fx.at[0:6, nv : nv + 6].set(Bv6)
        Fx = Fx.at[6:nv, 6:nv].set(jnp.eye(nj, dtype=dtype))
        Fx = Fx.at[6:nv, nv + 6 :].set(dt * jnp.eye(nj, dtype=dtype))
        Fx = Fx.at[nv:, nv:].set(jnp.eye(nv, dtype=dtype))

        Fu = jnp.zeros((ndx, nv), dtype)
        Fu = Fu.at[0:6, 0:6].set(Bu6)
        Fu = Fu.at[6:nv, 6:nv].set(dt * dt * jnp.eye(nj, dtype=dtype))
        Fu = Fu.at[nv:, :].set(dt * jnp.eye(nv, dtype=dtype))
        return Fx, Fu

    def stage_jac(x, u, k):
        dtype = x.dtype
        q, v = x[:nq], x[nq:]
        Jr = jnp.concatenate(
            [
                _ee_jac(q, dtype),
                _com_mom_jac(q, v, dtype),
                _sdiff_jac(q, x_reg[k], dtype),
            ],
            axis=0,
        )
        Fx, Fu = _dyn_jacs(x, u, tasks.dts[k], dtype)
        return Jr, stage_w(k, dtype), Fx, Fu

    def term_jac(x):
        dtype = x.dtype
        q, v = x[:nq], x[nq:]
        return jnp.concatenate(
            [_com_mom_jac(q, v, dtype), _sdiff_jac(q, x_reg[H], dtype)], axis=0
        )

    return stage_jac, term_jac


def solve_ik(
    model: RobotModel,
    eff_frames,
    x0: jnp.ndarray,  # (nq+nv,)
    tasks: IkTasks,
    cfg: ddp.DdpConfig = ddp.DdpConfig(),
    analytic_jacobians: bool = True,
) -> ddp.DdpResult:
    """One kinematic DDP solve (reference InverseKinematics::optimize,
    src/ik/inverse_kinematics.cpp:54-71); us0 = 0 like crocoddyl's default.

    ``analytic_jacobians`` selects the structured Gauss-Newton Jacobian path
    (build_jacobian_fns): identical derivatives (verified to 1e-9 vs the
    autodiff oracle, tests/test_ik_jacobians.py), and cheaper per DDP
    iteration. In f32 the two paths can take different (equally
    converged) line-search branches, so trajectories match exactly only in
    f64."""
    stage, term, ctrl_w = build_residual_fns(model, eff_frames, tasks)
    H = tasks.dts.shape[0]
    us0 = jnp.zeros((H, model.nv), x0.dtype)
    sj, tj = (None, None)
    if analytic_jacobians:
        sj, tj = build_jacobian_fns(model, eff_frames, tasks)
    return ddp.solve(
        model, x0, us0, tasks.dts, stage, ctrl_w, term, cfg,
        stage_jac_fn=sj, term_jac_fn=tj,
    )
