"""Velocity-tracking evaluation over command grids.

JAX twin of the reference policy/MPC eval suite (reference
behavioral_cloning_vc_evaluation_iterative.py, test_sweep_policy.py,
sweep eval loops in safedagger_modified.py:491-516): roll out over a grid of
commanded (vx, vy, w) and report per-command velocity-tracking MSE and
survival. The reference evaluates commands sequentially, one PyBullet episode
each; here the whole grid is one vmapped rollout batch.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout


@dataclasses.dataclass
class GridEvalResult:
    v_des: np.ndarray  # (N, 3)
    w_des: np.ndarray  # (N,)
    vx_mse: np.ndarray  # (N,)
    vy_mse: np.ndarray  # (N,)
    survived: np.ndarray  # (N,) bool
    mean_speed: np.ndarray  # (N,)
    fail_step: np.ndarray = None  # (N,) survival time in steps (T if survived)

    def summary(self):
        ok = self.survived
        out = {
            "survival_rate": float(np.mean(ok)),
            "vx_mse_mean": float(np.mean(self.vx_mse[ok])) if ok.any() else float("nan"),
            "vy_mse_mean": float(np.mean(self.vy_mse[ok])) if ok.any() else float("nan"),
        }
        if self.fail_step is not None:
            # graded progress signal even when nothing survives the full
            # episode (binary survival saturates at 0 early in learning)
            out["mean_survival_ms"] = float(np.mean(self.fail_step))
        return out

    def to_csv(self, path: str):
        """Tabular export — the portable stand-in for the reference's xlsx
        error tables (reference plot/error_data/*.xlsx)."""
        import csv

        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["vx_des", "vy_des", "w_des", "vx_mse", "vy_mse", "survived", "mean_speed"])
            for i in range(len(self.w_des)):
                w.writerow(
                    [
                        self.v_des[i, 0],
                        self.v_des[i, 1],
                        self.w_des[i],
                        self.vx_mse[i],
                        self.vy_mse[i],
                        int(self.survived[i]),
                        self.mean_speed[i],
                    ]
                )


def _evaluate(res, v_des, w_des, skip_steps: int):
    v_act = np.asarray(res.states[..., 0:2])  # local-frame base velocity
    vx_mse = np.mean((v_act[:, skip_steps:, 0] - np.asarray(v_des)[:, None, 0]) ** 2, axis=1)
    vy_mse = np.mean((v_act[:, skip_steps:, 1] - np.asarray(v_des)[:, None, 1]) ** 2, axis=1)
    T = res.states.shape[1]
    failed = np.asarray(res.failed)
    fail_step = np.where(failed, np.asarray(res.fail_step), T)
    return GridEvalResult(
        v_des=np.asarray(v_des),
        w_des=np.asarray(w_des),
        vx_mse=vx_mse,
        vy_mse=vy_mse,
        survived=~failed,
        mean_speed=v_act[:, skip_steps:, 0].mean(axis=1),
        fail_step=fail_step,
    )


def eval_mpc_grid(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    vx_values,
    w_values=(0.0,),
    vy: float = 0.0,
    skip_frac: float = 0.2,
    admm_cfg=None,
    ddp_cfg=None,
) -> GridEvalResult:
    """MPC tracking over a (vx, w) grid — the expert baseline the policy is
    compared to (reference error_mpc, test_bayesian_optimization.py:477-515)."""
    grid = [(vx, w) for vx in vx_values for w in w_values]
    B = len(grid)
    v_des = jnp.asarray([[vx, vy, 0.0] for vx, _ in grid], jnp.float32)
    w_des = jnp.asarray([w for _, w in grid], jnp.float32)
    q = jnp.tile(state0.q[None], (B, 1)).astype(jnp.float32)
    v = jnp.tile(state0.v[None], (B, 1)).astype(jnp.float32)
    run = jax.jit(
        jax.vmap(
            lambda q, v, vd, wd: rollout.rollout_mpc(
                spec, sim_params, cfg, physics.SimState(q=q, v=v), vd, wd,
                admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
            )
        )
    )
    res = run(q, v, v_des, w_des)
    return _evaluate(res, v_des, w_des, int(skip_frac * cfg.episode_length))


def eval_policy_grid(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    policy_fn,
    vx_values,
    w_values=(0.0,),
    vy: float = 0.0,
    skip_frac: float = 0.2,
) -> GridEvalResult:
    """Policy tracking over the same grid (reference error_policy,
    test_bayesian_optimization.py:517-560)."""
    grid = [(vx, w) for vx in vx_values for w in w_values]
    B = len(grid)
    v_des = jnp.asarray([[vx, vy, 0.0] for vx, _ in grid], jnp.float32)
    w_des = jnp.asarray([w for _, w in grid], jnp.float32)
    q = jnp.tile(state0.q[None], (B, 1)).astype(jnp.float32)
    v = jnp.tile(state0.v[None], (B, 1)).astype(jnp.float32)
    run = jax.jit(
        jax.vmap(
            lambda q, v, vd, wd: rollout.rollout_policy(
                spec, sim_params, cfg, physics.SimState(q=q, v=v), vd, wd, policy_fn
            )
        )
    )
    res = run(q, v, v_des, w_des)
    return _evaluate(res, v_des, w_des, int(skip_frac * cfg.episode_length))
