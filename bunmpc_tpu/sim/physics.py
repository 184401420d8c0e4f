"""In-graph rigid-body simulator with implicit soft ground contacts.

JAX replacement for the PyBullet backend (reference L1/L2:
bullet_utils/src/bullet_utils/env.py:82-91, wrapper.py:277-440,
examples/envs/pybullet_env.py:10-207). The reference steps one PyBullet C
server per process at 1 kHz; here the whole environment is a pure JAX
function so thousands of rollouts run inside one compiled ``lax.scan``.

Contact model: velocity-implicit spring-damper (the quadruped's feet are
light, so explicit penalty forces chatter at 1 kHz — the damping must be
implicit to be stable). Per step we solve the 3*n_eff linear system

    (I + dt * D * G) f = k_n * pen - D * u_free,   G = J M^{-1} J^T

(D = diag of normal/tangential damping gains, u_free = post-step contact
velocity without contact forces), then clamp to the friction cone and
unilateral normal — one linear solve + projection, batched over rollouts.
This mirrors how impulse-based engines (PyBullet's solver) stabilize stiff
contacts, in a fixed-shape, differentiable form.

State convention matches the reference's Pinocchio layout (q: base pos +
quat(xyzw) + joints; v: local-frame base twist + joint rates), so plans and
policies transfer 1:1.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..utils.quat import quat_to_rot


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["foot_radius", "kn", "dn", "mu", "kt"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ContactParams:
    """Registered as a pytree so physics parameters can be *traced*: vmapping
    over a batch of ContactParams runs parallel simulations with different
    ground properties (batched domain randomization — not possible in the
    reference's one-PyBullet-server-per-process architecture)."""

    foot_radius: float = 0.018  # collision sphere radius (solo12 foot_size)
    kn: float = 4e3  # normal stiffness [N/m] (~1.5 mm static penetration)
    dn: float = 300.0  # normal damping [N s/m] (implicit -> unconditionally stable)
    mu: float = 1.0  # Coulomb friction (bullet lateral_friction, solo12.urdf)
    kt: float = 300.0  # tangential damping [N s/m] (implicit)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["heights"],
    meta_fields=["origin", "cell"],
)
@dataclasses.dataclass(frozen=True)
class Terrain:
    """Uneven-ground heightfield (working replacement for the reference's
    broken Perlin terrain generator, pybullet_env.py:154-201): a regular grid
    of heights sampled bilinearly; contact normals stay vertical (valid for
    gentle slopes)."""

    heights: jnp.ndarray  # (N, M) grid of ground heights
    origin: tuple = (0.0, 0.0)  # world xy of grid[0, 0]
    cell: float = 0.05  # grid spacing [m]

    def height_at(self, xy):
        """Bilinear ground height at world xy (..., 2)."""
        h = jnp.asarray(self.heights)
        n, m = h.shape
        gx = (xy[..., 0] - self.origin[0]) / self.cell
        gy = (xy[..., 1] - self.origin[1]) / self.cell
        i0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, n - 2)
        j0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, m - 2)
        fx = jnp.clip(gx - i0, 0.0, 1.0)
        fy = jnp.clip(gy - j0, 0.0, 1.0)
        h00 = h[i0, j0]
        h10 = h[i0 + 1, j0]
        h01 = h[i0, j0 + 1]
        h11 = h[i0 + 1, j0 + 1]
        return (
            h00 * (1 - fx) * (1 - fy)
            + h10 * fx * (1 - fy)
            + h01 * (1 - fx) * fy
            + h11 * fx * fy
        )


def random_terrain(key, extent: float = 4.0, cell: float = 0.05, amplitude: float = 0.02, smooth: int = 3):
    """Random smooth heightfield centered on the origin (terrain fault
    injection; reference generate_terrain, pybullet_env.py:154)."""
    import jax.random as jrandom

    n = int(2 * extent / cell)
    h = amplitude * jrandom.normal(key, (n, n))
    for _ in range(smooth):  # box blur -> gentle slopes
        h = (
            h
            + jnp.roll(h, 1, 0)
            + jnp.roll(h, -1, 0)
            + jnp.roll(h, 1, 1)
            + jnp.roll(h, -1, 1)
        ) / 5.0
    return Terrain(heights=h, origin=(-extent, -extent), cell=cell)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["contact", "joint_damping", "torque_limit"],
    meta_fields=["dt"],
)
@dataclasses.dataclass(frozen=True)
class SimParams:
    """Pytree (dt static): vmap over SimParams batches = parallel sims with
    randomized physics (see ContactParams)."""

    dt: float = 0.001
    contact: ContactParams = ContactParams()
    joint_damping: float = 0.02  # motor/transmission damping
    torque_limit: float = 2.7  # Solo12 actuator limit [N m]


class SimState(NamedTuple):
    q: jnp.ndarray  # (..., nq)
    v: jnp.ndarray  # (..., nv)


class ContactInfo(NamedTuple):
    forces: jnp.ndarray  # (..., n_eff, 3) world-frame ground reaction forces
    positions: jnp.ndarray  # (..., n_eff, 3) foot positions
    in_contact: jnp.ndarray  # (..., n_eff) bool


def _foot_kinematics(model: RobotModel, eff_frames, q, v):
    """Foot world positions, velocities, and stacked translation Jacobians."""
    R, p = K.fk(model, q)
    omega, vel, _, _ = K.body_velocities(model, q, v)
    pos, vels, Js = [], [], []
    for name in eff_frames:
        f = model.frames[name]
        off = jnp.einsum("...ij,j->...i", R[..., f.body, :, :], jnp.asarray(f.pos, q.dtype))
        pos.append(p[..., f.body, :] + off)
        vels.append(vel[..., f.body, :] + jnp.cross(omega[..., f.body, :], off))
        Js.append(K.frame_jacobian(model, q, name, R=R, p=p))
    pos = jnp.stack(pos, axis=-2)  # (..., ne, 3)
    vels = jnp.stack(vels, axis=-2)
    J = jnp.concatenate(Js, axis=-2)  # (..., 3*ne, nv)
    return pos, vels, J


def step(
    model: RobotModel,
    eff_frames,
    params: SimParams,
    state: SimState,
    tau_joints,  # (..., n_joints) commanded joint torques
    f_ext=None,  # optional (..., 3) external force at the base origin (pushes)
    m_ext=None,  # optional (..., 3) external moment on the base
    terrain: Terrain | None = None,  # optional uneven ground
):
    """One 1 ms physics step (semi-implicit Euler), batched."""
    q, v = state
    cp = params.contact
    ne = len(eff_frames)
    dt = params.dt
    tau_joints = jnp.clip(tau_joints, -params.torque_limit, params.torque_limit)

    pos, vels, J = _foot_kinematics(model, eff_frames, q, v)
    ground = 0.0 if terrain is None else terrain.height_at(pos[..., 0:2])
    pen = cp.foot_radius - (pos[..., 2] - ground)  # (..., ne) penetration depth
    active = (pen > 0).astype(q.dtype)

    # free dynamics
    tau = jnp.concatenate(
        [jnp.zeros(q.shape[:-1] + (6,), q.dtype), tau_joints - params.joint_damping * v[..., 6:]],
        axis=-1,
    )
    if f_ext is not None:
        R0 = quat_to_rot(q[..., 3:7])
        tau = tau.at[..., 0:3].add(jnp.einsum("...ji,...j->...i", R0, f_ext))
    if m_ext is not None:
        R0 = quat_to_rot(q[..., 3:7])
        tau = tau.at[..., 3:6].add(jnp.einsum("...ji,...j->...i", R0, m_ext))

    M = K.mass_matrix(model, q)
    bias = K.nonlinear_effects(model, q, v)
    # M is SPD: one Cholesky factorization serves both M^-1(tau-bias) and
    # M^-1 J^T (vs two independent LU factorizations)
    L = jnp.linalg.cholesky(M)
    rhs = jnp.concatenate(
        [(tau - bias)[..., None], jnp.swapaxes(J, -1, -2)], axis=-1
    )  # (..., nv, 1+3ne)
    sol = cho_solve((L, True), rhs)
    Minv_tau = sol[..., 0]
    v_free = v + dt * Minv_tau
    u_free = jnp.einsum("...cv,...v->...c", J, v_free)  # (..., 3ne)

    # implicit contact solve: (I + dt D G) f = k - D u_free, rows masked by activity
    MinvJT = sol[..., 1:]  # (..., nv, 3ne)
    G = jnp.einsum("...cv,...vd->...cd", J, MinvJT)  # (..., 3ne, 3ne)
    d_gains = jnp.tile(jnp.asarray([cp.kt, cp.kt, cp.dn], q.dtype), ne)
    act3 = jnp.repeat(active, 3, axis=-1)
    D = d_gains * act3
    kvec = jnp.zeros_like(u_free)
    kvec = kvec.reshape(kvec.shape[:-1] + (ne, 3)).at[..., 2].set(cp.kn * pen * active)
    kvec = kvec.reshape(u_free.shape)
    A = jnp.eye(3 * ne, dtype=q.dtype) + dt * D[..., :, None] * G
    f = jnp.linalg.solve(A, (kvec - D * u_free)[..., None])[..., 0]
    f = f.reshape(f.shape[:-1] + (ne, 3))

    # unilateral + friction-cone projection
    fn = jnp.maximum(f[..., 2], 0.0) * active
    ft = f[..., 0:2]
    ft_norm = jnp.sqrt(jnp.sum(ft * ft, axis=-1) + 1e-12)
    scale = jnp.minimum(1.0, cp.mu * fn / ft_norm)
    ft = ft * scale[..., None]
    f = jnp.concatenate([ft, fn[..., None]], axis=-1)

    v_next = v_free + dt * jnp.einsum(
        "...vc,...c->...v", MinvJT, f.reshape(f.shape[:-2] + (3 * ne,))
    )
    q_next = K.integrate(model, q, v_next * dt)
    return SimState(q=q_next, v=v_next), ContactInfo(
        forces=f, positions=pos, in_contact=pen > 0
    )
