"""Effects-of-cc-replanning evaluation: vc vs cc-static vs cc-replanned.

JAX twin of the reference ablation drivers
(reference behavioral_cloning_evaluation_effects_of_cc_replanning.py:339-357,
behavioral_cloning_evaluation_with_cc_replan.py, test_policy_with_cc_replan.py):
for each command, roll out

* ``vc``          — the velocity-conditioned policy on vc goals,
* ``cc_static``   — the contact-conditioned policy on goals PREcomputed from
  the desired contact schedule against the straight-line estimated CoM
  (reference rollout_policy with a desired_goal array, utils.py:187-219),
* ``cc_replanned`` — the contact-conditioned policy with goals recomputed
  online against the measured CoM every step (reference
  rollout_policy_with_cc_replanning, simulation.py:834).

The reference runs one PyBullet episode per (variant, command) sequentially;
here each variant's whole command batch is one vmapped device program (the
desired schedules are host-side numpy, padded to a common event count so the
batch stays fixed-shape).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..kin import algorithms as K
from ..learning import goals as GU
from ..learning.contact_planner import ContactPlanner
from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout


@dataclasses.dataclass
class CcReplanResult:
    v_des: np.ndarray  # (N, 3)
    w_des: np.ndarray  # (N,)
    # per-variant (N,) arrays
    vx_mse: dict
    vy_mse: dict
    survived: dict

    def summary(self):
        out = {}
        for name in self.vx_mse:
            ok = self.survived[name]
            out[name] = {
                "survival_rate": float(np.mean(ok)),
                "vx_mse_mean": float(np.mean(self.vx_mse[name][ok])) if ok.any() else float("nan"),
                "vy_mse_mean": float(np.mean(self.vy_mse[name][ok])) if ok.any() else float("nan"),
            }
        return out

    def to_csv(self, path: str):
        import csv

        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["variant", "vx_des", "vy_des", "w_des", "vx_mse", "vy_mse", "survived"])
            for name in self.vx_mse:
                for i in range(len(self.w_des)):
                    w.writerow(
                        [
                            name,
                            self.v_des[i, 0],
                            self.v_des[i, 1],
                            self.w_des[i],
                            self.vx_mse[name][i],
                            self.vy_mse[name][i],
                            int(self.survived[name][i]),
                        ]
                    )


def desired_schedules(
    spec: CyclicMpcSpec, q0, v0, v_des_batch, w_des_batch, episode_length: int,
    start_time: float = 0.0,
):
    """Per-command desired contact schedules, padded to a common event count
    (pad = repeat of the last event, which ``cc_goal_fn``'s clipped
    searchsorted treats as a plateau). Returns (N, n_eff, n_events, 4)."""
    cp = ContactPlanner(spec)
    scheds = []
    for vd, wd in zip(np.asarray(v_des_batch), np.asarray(w_des_batch)):
        sched, _ = cp.get_contact_schedule(
            np.asarray(q0), np.asarray(v0), vd, float(wd), episode_length, start_time
        )
        scheds.append(np.asarray(sched))
    n_events = max(s.shape[1] for s in scheds)
    padded = np.stack(
        [
            np.concatenate([s, np.repeat(s[:, -1:], n_events - s.shape[1], axis=1)], axis=1)
            if s.shape[1] < n_events
            else s
            for s in scheds
        ]
    )
    return padded


def static_cc_goals(
    spec: CyclicMpcSpec, schedules, q0, v_des_batch, episode_length: int,
    goal_horizon: int = 1,
):
    """Precomputed (no-replanning) cc goals per command: the desired schedule
    evaluated against the straight-line estimated CoM (utils.py:187-219 +
    construct_cc_goal utils.py:36-84). Returns (N, T, 3*n_eff*goal_horizon),
    short horizons padded by repeating the last goal row."""
    ne = spec.n_eff
    com0 = np.asarray(K.com(spec.model, jnp.asarray(q0)))
    outs = []
    for sched, vd in zip(np.asarray(schedules), np.asarray(v_des_batch)):
        com_est = GU.estimated_com_trajectory(com0, vd, episode_length)
        g = GU.construct_cc_goal(
            episode_length, ne, sched, com_est, goal_horizon=goal_horizon
        )
        if g.shape[0] == 0:
            g = np.zeros((1, 3 * ne * goal_horizon))
        if g.shape[0] < episode_length:
            g = np.concatenate(
                [g, np.repeat(g[-1:], episode_length - g.shape[0], axis=0)]
            )
        outs.append(g[:episode_length])
    return np.stack(outs)


def compare_cc_replanning(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    vc_policy_fn,
    cc_policy_fn,
    v_des_batch,  # (N, 3)
    w_des_batch,  # (N,)
    goal_horizon: int = 1,
    skip_frac: float = 0.2,
) -> CcReplanResult:
    """Run all three variants over the command batch and report tracking MSE
    + survival per variant (the reference's per-command wandb tables)."""
    N = len(np.asarray(w_des_batch))
    dtype = jnp.asarray(state0.q).dtype  # follow the caller's state dtype
    v_des = jnp.asarray(v_des_batch, dtype)
    w_des = jnp.asarray(w_des_batch, dtype)
    q = jnp.tile(jnp.asarray(state0.q, dtype)[None], (N, 1))
    v = jnp.tile(jnp.asarray(state0.v, dtype)[None], (N, 1))

    scheds = desired_schedules(
        spec, state0.q, state0.v, v_des_batch, w_des_batch, cfg.episode_length
    )
    goals_static = jnp.asarray(
        static_cc_goals(spec, scheds, state0.q, v_des_batch, cfg.episode_length,
                        goal_horizon=goal_horizon),
        dtype,
    )
    scheds_j = jnp.asarray(scheds, dtype)

    run_vc = jax.jit(
        jax.vmap(
            lambda q, v, vd, wd: rollout.rollout_policy(
                spec, sim_params, cfg, physics.SimState(q=q, v=v), vd, wd, vc_policy_fn
            )
        )
    )

    def one_static(q, v, vd, wd, goals):
        return rollout.rollout_policy(
            spec, sim_params, cfg, physics.SimState(q=q, v=v), vd, wd, cc_policy_fn,
            goal_fn=lambda step, _q: goals[step],
        )

    run_static = jax.jit(jax.vmap(one_static))

    def one_replan(q, v, vd, wd, sched):
        return rollout.rollout_policy_cc(
            spec, sim_params, cfg, physics.SimState(q=q, v=v), vd, wd, cc_policy_fn,
            sched, goal_horizon=goal_horizon,
        )

    run_replan = jax.jit(jax.vmap(one_replan))

    results = {
        "vc": run_vc(q, v, v_des, w_des),
        "cc_static": run_static(q, v, v_des, w_des, goals_static),
        "cc_replanned": run_replan(q, v, v_des, w_des, scheds_j),
    }

    skip = int(skip_frac * cfg.episode_length)
    vx_mse, vy_mse, survived = {}, {}, {}
    for name, res in results.items():
        v_act = np.asarray(res.states[..., 0:2])
        vx_mse[name] = np.mean(
            (v_act[:, skip:, 0] - np.asarray(v_des)[:, None, 0]) ** 2, axis=1
        )
        vy_mse[name] = np.mean(
            (v_act[:, skip:, 1] - np.asarray(v_des)[:, None, 1]) ** 2, axis=1
        )
        survived[name] = ~np.asarray(res.failed)
    return CcReplanResult(
        v_des=np.asarray(v_des), w_des=np.asarray(w_des),
        vx_mse=vx_mse, vy_mse=vy_mse, survived=survived,
    )
