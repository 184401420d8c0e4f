"""Contact-conditioned state perturbations for data collection.

JAX twin of the reference's perturbation sampler (reference
examples/iterative_algorithm/data_collection.py:225-262): Gaussian tangent
perturbations of a nominal state, projected into the nullspace of the stacked
contact Jacobian so the perturbed state keeps the stance feet where they are,
resampled until no foot ends up below the ground.

Batched JAX version: instead of a rejection while-loop per sample, we draw K
candidates per slot, mask out those with feet below ground, and pick the
first valid one — fixed shapes, one program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..kin import algorithms as K
from ..robots.model import RobotModel


def contact_jacobian(model: RobotModel, eff_frames, q, cnt_flags):
    """Stacked LOCAL_WORLD_ALIGNED translation Jacobian of the feet flagged in
    contact; inactive rows zeroed (reference stacks only active feet —
    equivalent nullspace)."""
    R, p = K.fk(model, q)
    rows = []
    for j, name in enumerate(eff_frames):
        J = K.frame_jacobian(model, q, name, R=R, p=p)  # (3, nv)
        rows.append(J * cnt_flags[..., j, None, None])
    return jnp.concatenate(rows, axis=-2)  # (3*ne, nv)


def nullspace_project(Jc, vec):
    """(I - pinv(J) J) vec — removes the components that would move stance
    feet (data_collection.py:243-247)."""
    nv = vec.shape[-1]
    pinv = jnp.linalg.pinv(Jc)
    return vec - pinv @ (Jc @ vec)


def sample_perturbed_state(
    model: RobotModel,
    eff_frames,
    rng_key,
    q_nom,  # (nq,)
    v_nom,  # (nv,)
    cnt_flags,  # (n_eff,) contact flags at the replan knot
    sigma_base_pos=0.1,
    sigma_base_ori=0.3,
    sigma_joint_pos=0.2,
    sigma_vel=0.1,
    n_candidates: int = 8,
):
    """Returns (q0, v0, ok): a contact-consistent perturbed initial state.

    Draws ``n_candidates`` nullspace-projected perturbations and selects the
    first whose feet are all above ground; falls back to the nominal state if
    none qualifies (ok=False).
    """
    nv = model.nv
    k1, k2 = jax.random.split(rng_key)
    sig_pos = jnp.concatenate(
        [
            jnp.full(3, sigma_base_pos),
            jnp.full(3, sigma_base_ori),
            jnp.full(nv - 6, sigma_joint_pos),
        ]
    )
    dpos = jax.random.normal(k1, (n_candidates, nv)) * sig_pos
    dvel = jax.random.normal(k2, (n_candidates, nv)) * sigma_vel

    Jc = contact_jacobian(model, eff_frames, q_nom, cnt_flags)

    def candidate(dp, dv):
        dp_proj = nullspace_project(Jc, dp)
        dv_proj = nullspace_project(Jc, dv)
        q0 = K.integrate(model, q_nom, dp_proj)
        v0 = v_nom + dv_proj
        feet = K.frame_positions(model, q0, eff_frames)
        ok = jnp.all(feet[..., 2] >= 0.0)
        return q0, v0, ok

    q0s, v0s, oks = jax.vmap(candidate)(dpos, dvel)
    idx = jnp.argmax(oks)  # first valid candidate
    any_ok = jnp.any(oks)
    q0 = jnp.where(any_ok, q0s[idx], q_nom)
    v0 = jnp.where(any_ok, v0s[idx], v_nom)
    return q0, v0, any_ok
