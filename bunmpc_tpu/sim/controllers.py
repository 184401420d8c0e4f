"""Whole-body inverse-dynamics controller (1 kHz low level).

JAX twin of the reference ``InverseDynamicsController``
(reference examples/controllers/robot_id_controller.py:12-86): RNEA
feed-forward torque minus J^T contact-force compensation, plus joint PD
feedback. Pure function, broadcasts over batches, fuses into the rollout scan.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..kin import algorithms as K
from ..robots.model import RobotModel


@partial(
    jax.tree_util.register_dataclass, data_fields=["kp", "kd"], meta_fields=[]
)
@dataclasses.dataclass(frozen=True)
class IdControllerGains:
    """Pytree: gains can be traced/vmapped (per-episode gain randomization)."""

    kp: float
    kd: float


def id_joint_torques(
    model: RobotModel,
    eff_frames,
    gains: IdControllerGains,
    q,  # (..., nq) measured
    v,  # (..., nv) measured
    q_des,
    v_des,
    a_des,  # (..., nv) desired acceleration (IK us)
    f_ff,  # (..., n_eff*3) feed-forward contact forces
    f_scale=None,  # optional (..., n_eff) per-leg force-compensation scale
):
    """Returns (tau_ff, tau_fb), each (..., n_joints) — identical split to the
    reference (robot_id_controller.py:57-86): tau_ff from desired-state RNEA
    and force compensation, tau_fb from measured-state PD.

    ``f_scale`` scales each leg's J^T f_ff term (contact-adaptive force
    gating, sim/rollout.py ``force_gate``): a planned-stance force applied
    while the foot is measured airborne has no ground to react against — it
    just accelerates the leg into the ground (impact-bounce loop on heavy
    robots). None = reference behavior (forces always applied)."""
    tau_id = K.rnea(model, q_des, v_des, a_des)  # (..., nv)
    R, p = K.fk(model, q_des)
    tau_eff = jnp.zeros_like(tau_id)
    for j, name in enumerate(eff_frames):
        J = K.frame_jacobian(model, q_des, name, R=R, p=p)  # (..., 3, nv)
        fj = f_ff[..., 3 * j : 3 * (j + 1)]
        if f_scale is not None:
            fj = fj * f_scale[..., j : j + 1]
        tau_eff = tau_eff + jnp.einsum("...iv,...i->...v", J, fj)
    tau_ff = (tau_id - tau_eff)[..., 6:]
    tau_fb = -gains.kp * (q[..., 7:] - q_des[..., 7:]) - gains.kd * (
        v[..., 6:] - v_des[..., 6:]
    )
    return tau_ff, tau_fb
