"""Robustness envelopes: maximum survivable push search.

JAX twin of the reference stress tools (reference
max_force_search.py:32-344 binary-searches the largest external push the
controller survives; analysis/solo12_robustness_analysis.py applies random
pushes until failure). The binary search stays host-side (few steps), but
each probe evaluates a whole *batch* of push directions/phases at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout


def survival_fraction(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    magnitude: float,
    directions: np.ndarray,  # (B, 3) unit vectors
    push_start: int,
    push_duration: int,
    admm_cfg=None,
    ddp_cfg=None,
) -> float:
    """Fraction of push directions the MPC survives at the given magnitude."""
    B = len(directions)
    T = cfg.episode_length
    push = np.zeros((B, T, 3), np.float32)
    push[:, push_start : push_start + push_duration, :] = (
        magnitude * directions[:, None, :]
    )
    q = jnp.tile(jnp.asarray(state0.q, jnp.float32)[None], (B, 1))
    v = jnp.tile(jnp.asarray(state0.v, jnp.float32)[None], (B, 1))
    vd = jnp.tile(jnp.asarray(v_des, jnp.float32)[None], (B, 1))
    wd = jnp.full((B,), float(w_des), jnp.float32)
    run = jax.jit(
        jax.vmap(
            lambda q, v, vd, wd, p: rollout.rollout_mpc(
                spec, sim_params, cfg, physics.SimState(q=q, v=v), vd, wd,
                push_force=p, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
            )
        )
    )
    res = run(q, v, vd, wd, jnp.asarray(push))
    return float(1.0 - np.mean(np.asarray(res.failed)))


def max_force_search(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    f_low: float = 0.0,
    f_high: float = 30.0,
    n_bisect: int = 5,
    directions: np.ndarray | None = None,
    push_start: int | None = None,
    push_duration: int = 100,
    survival_threshold: float = 0.5,
    admm_cfg=None,
    ddp_cfg=None,
):
    """Binary search for the largest magnitude with survival above threshold
    (reference max_force_search.py search loop). Returns (f_max, history)."""
    if directions is None:
        ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        directions = np.stack([np.cos(ang), np.sin(ang), np.zeros(8)], -1).astype(np.float32)
    if push_start is None:
        push_start = cfg.episode_length // 3
    history = []
    for _ in range(n_bisect):
        mid = 0.5 * (f_low + f_high)
        frac = survival_fraction(
            spec, sim_params, cfg, state0, v_des, w_des, mid, directions,
            push_start, push_duration, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
        )
        history.append((mid, frac))
        if frac >= survival_threshold:
            f_low = mid
        else:
            f_high = mid
    return f_low, history
