"""Quaternion / rotation utilities (batched, JAX).

Conventions follow the reference stack's Pinocchio layout so that states can be
exchanged 1:1 (reference: robot_properties_solo config.py:246-256 uses
``q = [pos(3), quat(x, y, z, w), joints]``):

* quaternions are stored ``(x, y, z, w)`` (scalar last),
* all functions broadcast over arbitrary leading batch dimensions,
* tangent-space maps (``exp3``/``log3``/``exp6``/``log6``) use the *local*
  (body-frame) convention, matching Pinocchio's Lie-group integrate/difference
  that the reference IK relies on (reference: src/ik/action_model.cpp:43-70).

Everything is pure jnp so it fuses into surrounding XLA programs (tiny
elementwise ops).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-9


def skew(v):
    """Cross-product matrix: skew(v) @ u == cross(v, u). v: (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(q1, q2):
    """Hamilton product, (x, y, z, w) layout."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conj(q):
    return jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_to_rot(q):
    """Unit quaternion (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
    return r


def rot_to_quat(R):
    """Rotation matrix -> quaternion (x, y, z, w), branch-free (Shepperd)."""
    # Four candidate constructions, pick the numerically best via weights.
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # candidate w-major
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) / 2.0
    q0 = jnp.stack(
        [(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0), qw0],
        axis=-1,
    )
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) / 2.0
    q1 = jnp.stack(
        [qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1), (m21 - m12) / (4 * qx1)],
        axis=-1,
    )
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) / 2.0
    q2 = jnp.stack(
        [(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2), (m02 - m20) / (4 * qy2)],
        axis=-1,
    )
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) / 2.0
    q3 = jnp.stack(
        [(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3, (m10 - m01) / (4 * qz3)],
        axis=-1,
    )

    cases = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4, 4)
    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cases, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return quat_normalize(q)


def exp3(w):
    """so(3) exponential: rotation vector -> quaternion (x, y, z, w).

    Gradient-safe at w=0: branches are written in terms of |w|^2 (smooth) with
    the safe-denominator double-where pattern so jacfwd/jacrev never see 0/0.
    """
    sq = jnp.sum(w * w, axis=-1, keepdims=True)
    small = sq < 1e-12
    theta = jnp.sqrt(jnp.where(small, 1.0, sq))
    s = jnp.where(small, 0.5 - sq / 48.0, jnp.sin(0.5 * theta) / theta)
    c = jnp.where(small, 1.0 - sq / 8.0, jnp.cos(0.5 * theta))
    return jnp.concatenate([w * s, c], axis=-1)


def log3_quat(q):
    """Quaternion -> rotation vector (inverse of exp3), gradient-safe at identity."""
    q = jnp.where(q[..., 3:4] < 0, -q, q)  # take the short path
    sq = jnp.sum(q[..., :3] * q[..., :3], axis=-1, keepdims=True)
    w = q[..., 3:4]
    small = sq < 1e-12
    vnorm = jnp.sqrt(jnp.where(small, 1.0, sq))
    angle = 2.0 * jnp.arctan2(vnorm, w)
    w_safe = jnp.clip(w, _EPS)
    scale = jnp.where(small, (2.0 / w_safe) * (1.0 - sq / (3.0 * w_safe * w_safe)), angle / vnorm)
    return q[..., :3] * scale


def log3(R):
    """Rotation matrix -> rotation vector (used for the orientation-correction
    AMOM term, reference: examples/mpc/abstract_cyclic_gen.py:616-627)."""
    return log3_quat(rot_to_quat(R))


def rot_x(theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([o, z, z], axis=-1),
            jnp.stack([z, c, -s], axis=-1),
            jnp.stack([z, s, c], axis=-1),
        ],
        axis=-2,
    )


def axis_angle_rot(axis, theta):
    """Rodrigues: rotation about a fixed (static, shape (3,)) axis by theta (...,)."""
    axis = jnp.asarray(axis)
    c = jnp.cos(theta)[..., None, None]
    s = jnp.sin(theta)[..., None, None]
    k = skew(axis)
    eye = jnp.eye(3, dtype=c.dtype)
    outer = jnp.outer(axis, axis)
    return c * eye + s * k + (1 - c) * outer


def rpy_to_rot(rpy):
    """Roll-pitch-yaw (XYZ extrinsic, URDF convention) -> rotation matrix."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def rot_to_rpy(R):
    """Rotation matrix -> roll-pitch-yaw (matches pin.rpy.matrixToRpy usage in
    reference abstract_cyclic_gen.py:174)."""
    pitch = -jnp.arcsin(jnp.clip(R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def yaw_quat(q):
    """Project a quaternion onto its yaw-only component (roll=pitch=0), used by
    the contact planner's heading frame (reference abstract_cyclic_gen.py:173-177)."""
    R = quat_to_rot(q)
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    half = 0.5 * yaw
    zero = jnp.zeros_like(half)
    return jnp.stack([zero, zero, jnp.sin(half), jnp.cos(half)], axis=-1)


# --- SE(3) exp/log (local-frame tangent [linear, angular], Pinocchio order) ---


def _so3_left_jacobian(w):
    """V(w) such that exp6 translation = V @ v. (..., 3) -> (..., 3, 3).

    Gradient-safe at w=0 (Taylor branches in |w|^2)."""
    sq = jnp.sum(w * w, axis=-1)[..., None, None]
    small = sq < 1e-10
    sq_safe = jnp.where(small, 1.0, sq)
    t = jnp.sqrt(sq_safe)
    K = skew(w)
    K2 = K @ K
    a = jnp.where(small, 0.5 - sq / 24.0, (1 - jnp.cos(t)) / sq_safe)
    b = jnp.where(small, 1.0 / 6.0 - sq / 120.0, (t - jnp.sin(t)) / (sq_safe * t))
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a * K + b * K2


def se3_integrate(p, q, dv, dw):
    """Integrate a local-frame twist (dv linear, dw angular) on SE(3).

    Mirrors Pinocchio's free-flyer ``integrate(q, v*dt)`` used by the
    reference's Euler-integrated kinematic action model
    (crocoddyl IntegratedActionModelEuler; reference src/ik/inverse_kinematics.cpp:43).
    """
    R = quat_to_rot(q)
    V = _so3_left_jacobian(dw)
    p_new = p + jnp.einsum("...ij,...jk,...k->...i", R, V, dv)
    q_new = quat_normalize(quat_mul(q, exp3(dw)))
    return p_new, q_new


def _so3_left_jacobian_inv(w):
    """Closed-form V(w)^-1 (avoids a batched 3x3 linear solve on the DDP hot
    path — a generic batched linalg.solve is far slower). Gradient-safe at
    w=0."""
    sq = jnp.sum(w * w, axis=-1)[..., None, None]
    small = sq < 1e-10
    sq_safe = jnp.where(small, 1.0, sq)
    t = jnp.sqrt(sq_safe)
    K = skew(w)
    K2 = K @ K
    # coefficient of K2: 1/theta^2 - (1 + cos t) / (2 t sin t); Taylor: 1/12 + t^2/720
    cot_term = (1.0 + jnp.cos(t)) / (2.0 * t * jnp.sin(t))
    b = jnp.where(small, 1.0 / 12.0 + sq / 720.0, 1.0 / sq_safe - cot_term)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye - 0.5 * K + b * K2


def se3_difference(p1, q1, p2, q2):
    """Local-frame twist (dv, dw) with integrate(x1, (dv, dw)) == x2."""
    q_rel = quat_mul(quat_conj(q1), q2)
    dw = log3_quat(q_rel)
    R1 = quat_to_rot(q1)
    dp_local = jnp.einsum("...ji,...j->...i", R1, p2 - p1)
    Vinv = _so3_left_jacobian_inv(dw)
    dv = jnp.einsum("...ij,...j->...i", Vinv, dp_local)
    return dv, dw


def _se3_Q(rho, w):
    """Barfoot's Q(ξ) block for the SE(3) left Jacobian, ξ = [rho (lin), w (ang)].

    Jl6(ξ) = [[Jl3(w), Q], [0, Jl3(w)]]. Gradient-safe Taylor branches at w=0.
    Validated against autodiff of se3_integrate (tests/test_se3_jacobians.py)."""
    sq = jnp.sum(w * w, axis=-1)[..., None, None]
    small = sq < 1e-8
    sq_safe = jnp.where(small, 1.0, sq)
    t = jnp.sqrt(sq_safe)
    rx = skew(rho)
    wx = skew(w)
    wxrx = wx @ rx
    rxwx = rx @ wx
    wxrxwx = wxrx @ wx
    c1 = jnp.where(small, 1.0 / 6.0 - sq / 120.0, (t - jnp.sin(t)) / (sq_safe * t))
    # (theta^2/2 + cos(theta) - 1)/theta^4  -> 1/24 - theta^2/720
    c2 = jnp.where(
        small, 1.0 / 24.0 - sq / 720.0, (sq / 2.0 + jnp.cos(t) - 1.0) / (sq_safe * sq_safe)
    )
    # (theta - sin(theta) - theta^3/6)/theta^5 -> -1/120 + theta^2/5040
    c3 = jnp.where(
        small,
        -1.0 / 120.0 + sq / 5040.0,
        (t - jnp.sin(t) - t * sq / 6.0) / (sq_safe * sq_safe * t),
    )
    Q = (
        0.5 * rx
        + c1 * (wxrx + rxwx + wxrxwx)
        + c2 * (wx @ wxrx + rxwx @ wx - 3.0 * wxrxwx)
        + 0.5 * (c2 + 3.0 * c3) * (wxrxwx @ wx + wx @ wxrxwx)
    )
    return Q


def se3_left_jacobian(rho, w):
    """SE(3) left Jacobian Jl6(ξ), ξ = [rho, w]: Exp(ξ + δ) ≈ Exp(Jl6 δ) Exp(ξ)."""
    Jl = _so3_left_jacobian(w)
    Q = _se3_Q(rho, w)
    top = jnp.concatenate([Jl, Q], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(Q), Jl], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_left_jacobian_inv(rho, w):
    """Closed-form Jl6(ξ)^-1 via the block inverse [[Ji, -Ji Q Ji],[0, Ji]]."""
    Ji = _so3_left_jacobian_inv(w)
    Q = _se3_Q(rho, w)
    top = jnp.concatenate([Ji, -(Ji @ Q @ Ji)], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(Q), Ji], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_right_jacobian(rho, w):
    """Jr6(ξ) = Jl6(-ξ): Exp(ξ + δ) ≈ Exp(ξ) Exp(Jr6 δ)."""
    return se3_left_jacobian(-rho, -w)


def se3_right_jacobian_inv(rho, w):
    return se3_left_jacobian_inv(-rho, -w)


def se3_adjoint_exp(rho, w):
    """Ad(Exp(ξ)) for twist ordering [linear, angular]: [[R, t^ R],[0, R]]
    with R = exp(w^), t = V(w) rho."""
    R = quat_to_rot(exp3(w))
    V = _so3_left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    top = jnp.concatenate([R, skew(t) @ R], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
