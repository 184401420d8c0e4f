"""Batched rigid-body kinematics & dynamics in JAX.

JAX replacement for the Pinocchio calls in the reference hot path
(FK/CoM/centroidal momentum: src/motion_planner/kino_dyn.cpp:42,
src/ik/action_model.cpp:60-63; RNEA + frame Jacobians:
examples/controllers/robot_id_controller.py:55,78).

Design: topology is static (``RobotModel`` numpy constants), so every
algorithm unrolls at trace time into a fixed chain of small dense ops that
broadcast over arbitrary leading batch dimensions. With B ~ 10^3 rollouts the
batch axis carries all the parallelism; XLA fuses the per-body ops — these
are O(n_bodies) elementwise / 3x3 ops, not matmul-shaped.

All quantities follow the Pinocchio conventions used by the reference:
world-frame body poses, local-frame base velocity in ``v[:6]`` (linear first),
centroidal momentum about the CoM in world axes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..robots.model import RobotModel
from ..utils.quat import axis_angle_rot, quat_to_rot, skew

_G = 9.81


def _split_q(model: RobotModel, q):
    return q[..., 0:3], q[..., 3:7], q[..., 7:]


def fk(model: RobotModel, q):
    """Forward kinematics.

    Returns ``(R, p)`` with ``R: (..., nb, 3, 3)`` world rotations and
    ``p: (..., nb, 3)`` world positions of every moving body frame.
    """
    base_p, base_quat, theta = _split_q(model, q)
    R0 = quat_to_rot(base_quat)
    Rs = [R0]
    ps = [base_p]
    for j in range(model.n_joints):
        b = int(model.parent[j])
        Rp, pp = Rs[b], ps[b]
        Rj = jnp.asarray(model.joint_rot[j], dtype=q.dtype)
        pj = jnp.asarray(model.joint_pos[j], dtype=q.dtype)
        Rrot = axis_angle_rot(model.axis[j].astype(q.dtype), theta[..., j])
        Rs.append(Rp @ Rj @ Rrot)
        ps.append(pp + jnp.einsum("...ij,j->...i", Rp, pj))
    return jnp.stack(Rs, axis=-3), jnp.stack(ps, axis=-2)


def frame_position(model: RobotModel, q, frame_name: str):
    """World position of a named fixed frame (e.g. a foot)."""
    R, p = fk(model, q)
    f = model.frames[frame_name]
    return p[..., f.body, :] + jnp.einsum(
        "...ij,j->...i", R[..., f.body, :, :], jnp.asarray(f.pos, dtype=q.dtype)
    )


def frame_positions(model: RobotModel, q, frame_names):
    """World positions of several frames, stacked on a new axis: (..., n, 3)."""
    R, p = fk(model, q)
    out = []
    for name in frame_names:
        f = model.frames[name]
        out.append(
            p[..., f.body, :]
            + jnp.einsum("...ij,j->...i", R[..., f.body, :, :], jnp.asarray(f.pos, dtype=q.dtype))
        )
    return jnp.stack(out, axis=-2)


def body_velocities(model: RobotModel, q, v):
    """World-frame angular & linear velocities of every body-frame origin.

    Returns ``(omega, vel, R, p)``; base twist ``v[:6]`` is local-frame
    (Pinocchio free-flyer convention, reference bullet_utils wrapper.py:277-330).
    """
    R, p = fk(model, q)
    R0 = R[..., 0, :, :]
    v_lin = jnp.einsum("...ij,...j->...i", R0, v[..., 0:3])
    omega0 = jnp.einsum("...ij,...j->...i", R0, v[..., 3:6])
    omegas = [omega0]
    vels = [v_lin]
    for j in range(model.n_joints):
        b = int(model.parent[j])
        body = j + 1
        a_w = jnp.einsum(
            "...ij,j->...i", R[..., body, :, :], jnp.asarray(model.axis[j], dtype=q.dtype)
        )
        r = p[..., body, :] - p[..., b, :]
        omegas.append(omegas[b] + a_w * v[..., 6 + j : 7 + j])
        vels.append(vels[b] + jnp.cross(omegas[b], r))
    return jnp.stack(omegas, axis=-2), jnp.stack(vels, axis=-2), R, p


def com(model: RobotModel, q):
    """World-frame center of mass (reference: pin.centerOfMass)."""
    R, p = fk(model, q)
    mass = jnp.asarray(model.mass, dtype=q.dtype)
    c_w = p + jnp.einsum("...nij,nj->...ni", R, jnp.asarray(model.com, dtype=q.dtype))
    return jnp.einsum("n,...ni->...i", mass, c_w) / model.total_mass


def centroidal_state_and_frames(model: RobotModel, q, v, frame_names):
    """Fused evaluation of (com, h_lin, h_ang, frame positions) from ONE
    forward-kinematics pass — the IK residual hot path (each DDP Gauss-Newton
    Jacobian differentiates this 36 times; sharing the FK halves the work
    vs calling centroidal_momentum + frame_positions separately)."""
    omega, vel, R, p = body_velocities(model, q, v)
    mass = jnp.asarray(model.mass, dtype=q.dtype)
    c_b = jnp.asarray(model.com, dtype=q.dtype)
    c_off = jnp.einsum("...nij,nj->...ni", R, c_b)
    c_w = p + c_off
    v_com = vel + jnp.cross(omega, c_off)
    com_w = jnp.einsum("n,...ni->...i", mass, c_w) / model.total_mass
    h_lin = jnp.einsum("n,...ni->...i", mass, v_com)
    I_w = jnp.einsum("...nij,njk,...nlk->...nil", R, jnp.asarray(model.inertia, dtype=q.dtype), R)
    h_ang_each = jnp.einsum("...nij,...nj->...ni", I_w, omega) + mass[..., :, None] * jnp.cross(
        c_w - com_w[..., None, :], v_com
    )
    frames = []
    for name in frame_names:
        f = model.frames[name]
        frames.append(
            p[..., f.body, :]
            + jnp.einsum("...ij,j->...i", R[..., f.body, :, :], jnp.asarray(f.pos, dtype=q.dtype))
        )
    return com_w, h_lin, jnp.sum(h_ang_each, axis=-2), jnp.stack(frames, axis=-2)


def centroidal_momentum(model: RobotModel, q, v):
    """Centroidal momentum ``h = (h_lin, h_ang)`` about the CoM in world axes,
    plus the CoM itself: returns ``(com, h_lin, h_ang)``.

    Matches ``pin.computeCentroidalMomentum`` as used for MPC warm starts
    (reference src/motion_planner/kino_dyn.cpp:42,83-99).
    """
    omega, vel, R, p = body_velocities(model, q, v)
    mass = jnp.asarray(model.mass, dtype=q.dtype)
    c_b = jnp.asarray(model.com, dtype=q.dtype)
    c_off = jnp.einsum("...nij,nj->...ni", R, c_b)  # body com offset in world
    c_w = p + c_off
    v_com = vel + jnp.cross(omega, c_off)
    com_w = jnp.einsum("n,...ni->...i", mass, c_w) / model.total_mass
    h_lin = jnp.einsum("n,...ni->...i", mass, v_com)
    I_w = jnp.einsum("...nij,njk,...nlk->...nil", R, jnp.asarray(model.inertia, dtype=q.dtype), R)
    h_ang_each = jnp.einsum("...nij,...nj->...ni", I_w, omega) + mass[..., :, None] * jnp.cross(
        c_w - com_w[..., None, :], v_com
    )
    return com_w, h_lin, jnp.sum(h_ang_each, axis=-2)


def frame_jacobian(model: RobotModel, q, frame_name: str, R=None, p=None):
    """Translation Jacobian of a frame in LOCAL_WORLD_ALIGNED convention:
    ``dp_frame/dt = J @ v`` with world-axis output and Pinocchio tangent layout.

    Replaces ``pin.computeFrameJacobian(..., LOCAL_WORLD_ALIGNED)[0:3]``
    (reference examples/controllers/robot_id_controller.py:78).
    """
    if R is None or p is None:
        R, p = fk(model, q)
    f = model.frames[frame_name]
    R0 = R[..., 0, :, :]
    p0 = p[..., 0, :]
    pf = p[..., f.body, :] + jnp.einsum(
        "...ij,j->...i", R[..., f.body, :, :], jnp.asarray(f.pos, dtype=q.dtype)
    )
    batch = q.shape[:-1]
    cols = [jnp.zeros(batch + (3,), q.dtype)] * model.nv
    # base: v_f = R0 v_loc + (R0 w_loc) x (pf - p0)
    rel = pf - p0
    for k in range(3):
        cols[k] = R0[..., :, k]
        cols[3 + k] = jnp.cross(R0[..., :, k], rel)
    for j in model.ancestors(f.body):
        body = j + 1
        a_w = jnp.einsum(
            "...ij,j->...i", R[..., body, :, :], jnp.asarray(model.axis[j], dtype=q.dtype)
        )
        cols[6 + j] = jnp.cross(a_w, pf - p[..., body, :])
    return jnp.stack(cols, axis=-1)  # (..., 3, nv)


def rnea(model: RobotModel, q, v, a, gravity: float = _G):
    """Recursive Newton-Euler inverse dynamics: tau = ID(q, v, a).

    ``a`` uses Pinocchio's local-frame convention for the base rows (time
    derivative of the local base twist). Returns ``tau`` with Pinocchio layout:
    rows 0:3 base force, 3:6 base torque (both local frame), then joints.
    Replaces ``pin.rnea`` (reference robot_id_controller.py:55).
    """
    omega, vel, R, p = body_velocities(model, q, v)
    R0 = R[..., 0, :, :]
    omega0 = omega[..., 0, :]
    vel0 = vel[..., 0, :]

    # base classical acceleration from local spatial acceleration:
    # v_w = R0 v_loc  =>  dv_w = R0 a_loc + omega x v_w
    a_lin0 = jnp.einsum("...ij,...j->...i", R0, a[..., 0:3]) + jnp.cross(omega0, vel0)
    alpha0 = jnp.einsum("...ij,...j->...i", R0, a[..., 3:6])

    alphas = [alpha0]
    accs = [a_lin0]
    for j in range(model.n_joints):
        b = int(model.parent[j])
        body = j + 1
        a_w = jnp.einsum(
            "...ij,j->...i", R[..., body, :, :], jnp.asarray(model.axis[j], dtype=q.dtype)
        )
        r = p[..., body, :] - p[..., b, :]
        qd = v[..., 6 + j : 7 + j]
        qdd = a[..., 6 + j : 7 + j]
        w_p = omega[..., b, :]
        alphas.append(alphas[b] + a_w * qdd + jnp.cross(w_p, a_w) * qd)
        accs.append(accs[b] + jnp.cross(alphas[b], r) + jnp.cross(w_p, jnp.cross(w_p, r)))

    mass = np.asarray(model.mass, dtype=np.dtype(q.dtype))  # keep f32 under x64
    g_vec = jnp.array([0.0, 0.0, -gravity], dtype=q.dtype)

    # per-body net force/torque about own CoM
    F_net = []
    N_net = []
    for b in range(model.n_bodies):
        c_off = jnp.einsum(
            "...ij,j->...i", R[..., b, :, :], jnp.asarray(model.com[b], dtype=q.dtype)
        )
        w_b = omega[..., b, :]
        a_com = accs[b] + jnp.cross(alphas[b], c_off) + jnp.cross(w_b, jnp.cross(w_b, c_off))
        I_w = R[..., b, :, :] @ jnp.asarray(model.inertia[b], dtype=q.dtype) @ jnp.swapaxes(
            R[..., b, :, :], -1, -2
        )
        F_net.append(mass[b] * (a_com - g_vec))
        N_net.append(
            jnp.einsum("...ij,...j->...i", I_w, alphas[b])
            + jnp.cross(w_b, jnp.einsum("...ij,...j->...i", I_w, w_b))
        )

    # backward pass: f[b], n[b] = wrench transmitted to body b from its parent,
    # torque expressed about body b's frame origin
    f = [None] * model.n_bodies
    n = [None] * model.n_bodies
    children = [[] for _ in range(model.n_bodies)]
    for j in range(model.n_joints):
        children[int(model.parent[j])].append(j + 1)
    for b in reversed(range(model.n_bodies)):
        c_off = jnp.einsum(
            "...ij,j->...i", R[..., b, :, :], jnp.asarray(model.com[b], dtype=q.dtype)
        )
        fb = F_net[b]
        nb = N_net[b] + jnp.cross(c_off, F_net[b])
        for cb in children[b]:
            fb = fb + f[cb]
            nb = nb + n[cb] + jnp.cross(p[..., cb, :] - p[..., b, :], f[cb])
        f[b] = fb
        n[b] = nb

    taus = []
    for j in range(model.n_joints):
        body = j + 1
        a_w = jnp.einsum(
            "...ij,j->...i", R[..., body, :, :], jnp.asarray(model.axis[j], dtype=q.dtype)
        )
        taus.append(jnp.sum(a_w * n[body], axis=-1))
    base_f = jnp.einsum("...ji,...j->...i", R0, f[0])
    base_n = jnp.einsum("...ji,...j->...i", R0, n[0])
    return jnp.concatenate([base_f, base_n, jnp.stack(taus, axis=-1)], axis=-1)


def mass_matrix(model: RobotModel, q):
    """Joint-space inertia matrix M(q) (..., nv, nv) via RNEA columns.

    M e_i = ID(q, 0, e_i) - ID(q, 0, 0); exact, vmapped over columns. nv is
    tiny (18) so the column sweep is cheap and XLA folds the shared FK.
    """
    nv = model.nv
    zeros_v = jnp.zeros(q.shape[:-1] + (nv,), q.dtype)
    tau0 = rnea(model, q, zeros_v, zeros_v, gravity=0.0)

    def column(e):
        e_full = jnp.broadcast_to(e, q.shape[:-1] + (nv,))
        return rnea(model, q, zeros_v, e_full, gravity=0.0) - tau0

    eye = jnp.eye(nv, dtype=q.dtype)
    cols = jax.vmap(column, in_axes=0, out_axes=-1)(eye)
    return cols


def nonlinear_effects(model: RobotModel, q, v, gravity: float = _G):
    """Coriolis + centrifugal + gravity bias b(q, v) = ID(q, v, 0)."""
    zeros_v = jnp.zeros(q.shape[:-1] + (model.nv,), q.dtype)
    return rnea(model, q, v, zeros_v, gravity=gravity)


def composite_inertia_about_com(model: RobotModel, q):
    """Locked (composite) rotational inertia of the whole robot about its CoM,
    in world axes: the reference uses the base-frame version at q0 for the
    yaw-momentum target (abstract_cyclic_gen.py:46-47, 604-607)."""
    R, p = fk(model, q)
    mass = jnp.asarray(model.mass, dtype=q.dtype)
    c_w = p + jnp.einsum("...nij,nj->...ni", R, jnp.asarray(model.com, dtype=q.dtype))
    com_w = jnp.einsum("n,...ni->...i", mass, c_w) / model.total_mass
    I_w = jnp.einsum("...nij,njk,...nlk->...nil", R, jnp.asarray(model.inertia, dtype=q.dtype), R)
    d = c_w - com_w[..., None, :]
    d2 = jnp.sum(d * d, axis=-1)[..., None, None] * jnp.eye(3, dtype=q.dtype)
    shift = mass[:, None, None] * (d2 - d[..., :, None] * d[..., None, :])
    return jnp.sum(I_w + shift, axis=-3)


# --- configuration-space Lie group ops (free-flyer x R^nj) ---


def integrate(model: RobotModel, q, dq):
    """Pinocchio-style ``integrate(q, dq)`` with dq in the local tangent."""
    from ..utils.quat import se3_integrate

    p_new, q_new = se3_integrate(q[..., 0:3], q[..., 3:7], dq[..., 0:3], dq[..., 3:6])
    return jnp.concatenate([p_new, q_new, q[..., 7:] + dq[..., 6:]], axis=-1)


def difference(model: RobotModel, q1, q2):
    """Tangent vector dq with integrate(q1, dq) == q2."""
    from ..utils.quat import se3_difference

    dv, dw = se3_difference(q1[..., 0:3], q1[..., 3:7], q2[..., 0:3], q2[..., 3:7])
    return jnp.concatenate([dv, dw, q2[..., 7:] - q1[..., 7:]], axis=-1)
