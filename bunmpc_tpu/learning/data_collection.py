"""BC dataset generation driver.

JAX twin of the reference ``DataCollection`` (reference
examples/iterative_algorithm/data_collection.py:34-288): per iteration,
sample a gait + velocity command, roll out a nominal (benchmark) MPC episode,
then roll out *batches* of contact-conditioned perturbed MPC episodes from
states along the first gait cycle, and append everything to the replay
database with vc/cc goals.

Where the reference runs each perturbed rollout sequentially in its own
PyBullet process, here all perturbed rollouts of an iteration run as ONE
vmapped device program; the host only samples commands and assembles goals.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout
from . import goals as GU
from . import perturbations
from .contact_planner import ContactPlanner
from .database import Database


@dataclasses.dataclass
class DataCollectionConfig:
    """Reference defaults from cfgs/data_collection_config.yaml."""

    episode_length: int = 3000
    n_iteration: int = 5
    num_perturbations_per_replanning: int = 4
    goal_horizon: int = 1
    vx_range: tuple = (-0.3, 0.5)
    vy_range: tuple = (-0.2, 0.2)
    w_range: tuple = (-0.3, 0.3)
    action_type: str = "pd_target"
    database_size: int = 1_000_000
    sigma_base_pos: float = 0.1
    sigma_base_ori: float = 0.3
    sigma_joint_pos: float = 0.2
    sigma_vel: float = 0.1


class DataCollection:
    def __init__(
        self,
        spec: CyclicMpcSpec,
        cfg: DataCollectionConfig = DataCollectionConfig(),
        sim_params: physics.SimParams = physics.SimParams(),
        seed: int = 0,
        admm_cfg=None,
        ddp_cfg=None,
    ):
        self.spec = spec
        self.cfg = cfg
        self.sim_params = sim_params
        self.rng = np.random.default_rng(seed)
        self.key = jax.random.PRNGKey(seed)
        self.database = Database(cfg.database_size, goal_type="cc")
        self.planner = ContactPlanner(spec)

        p = spec.params
        self.rcfg = rollout.RolloutConfig(
            episode_length=cfg.episode_length,
            plan_freq=p.plan_freq,
            action_type=cfg.action_type,
            kp=p.kp,
            kd=p.kd,
            gait_id=GU.get_vc_gait_value(p.motion_name),
            gait_period=p.gait_period,
        )
        self._rollout_fn = jax.jit(
            jax.vmap(
                lambda q, v, vd, wd: rollout.rollout_mpc(
                    spec,
                    sim_params,
                    self.rcfg,
                    physics.SimState(q=q, v=v),
                    vd,
                    wd,
                    admm_cfg=admm_cfg,
                    ddp_cfg=ddp_cfg,
                ),
            )
        )

    def _append_rollouts(self, res, v_des, w_des, q0_batch):
        """Host-side postprocessing: build cc goals from each rollout's
        measured contact events and append successful episodes
        (data_collection.py:272-277 skips failed ones)."""
        n_eff = self.spec.n_eff
        B = res.states.shape[0]
        added = 0
        for b in range(B):
            if bool(res.failed[b]):
                continue
            states = np.asarray(res.states[b])
            actions = np.asarray(res.actions[b])
            vc = np.asarray(res.vc_goals[b])
            events = GU.contact_events_from_rollout(
                np.asarray(res.in_contact[b]), np.asarray(res.contact_pos[b])
            )
            if len(events) == 0:
                continue
            schedule = GU.construct_contact_schedule(events, n_eff)
            cc = GU.construct_cc_goal(
                self.cfg.episode_length,
                n_eff,
                schedule,
                np.asarray(res.com[b]),
                goal_horizon=self.cfg.goal_horizon,
            )
            T = len(cc)
            if T == 0:
                continue
            self.database.append(states[:T], actions[:T], vc_goals=vc[:T], cc_goals=cc[:T])
            added += T
        return added

    def run_iteration(self, q0, v0):
        """One data-collection iteration (data_collection.py:129-277)."""
        cfg = self.cfg
        p = self.spec.params
        v_des, w_des = GU.sample_velocities(self.rng, cfg.vx_range, cfg.vy_range, cfg.w_range)

        # --- benchmark MPC rollout (batch of 1) ---
        q0j = jnp.asarray(q0, jnp.float32)[None]
        v0j = jnp.asarray(v0, jnp.float32)[None]
        vdj = jnp.asarray(v_des, jnp.float32)[None]
        wdj = jnp.asarray([w_des], jnp.float32)
        bench = self._rollout_fn(q0j, v0j, vdj, wdj)
        added = self._append_rollouts(bench, v_des, w_des, q0j)

        # nominal trajectory states at each replanning point of one gait cycle
        num_replanning = int(p.gait_period / p.plan_freq)
        spp = self.rcfg.steps_per_plan
        nominal_q = np.asarray(bench.states[0])  # features, not q — reconstruct below
        # reconstruct (q, v) at replan points from the logged features:
        # features = [v(18), base_wrt_foot(8), q[2:](17)] -> q = [0, 0, feat[26:]]
        qs, vs, cnts = [], [], []
        cnt_plan0 = None
        for r in range(num_replanning):
            t_idx = r * spp
            feat = nominal_q[t_idx]
            v_r = feat[:18]
            q_r = np.concatenate([[0.0, 0.0], feat[26:]])
            qs.append(q_r)
            vs.append(v_r)

        # contact flags at each replan time from the gait phase
        from ..mpc import gait as G

        per_replan_t = np.arange(num_replanning) * p.plan_freq
        cnt_flags = np.asarray(G.in_stance(self.spec.gait, jnp.asarray(per_replan_t)))

        # --- perturbed rollouts, all in one batch ---
        B = num_replanning * cfg.num_perturbations_per_replanning
        qb, vb = [], []
        for r in range(num_replanning):
            for _ in range(cfg.num_perturbations_per_replanning):
                self.key, sub = jax.random.split(self.key)
                q0p, v0p, ok = perturbations.sample_perturbed_state(
                    self.spec.model,
                    self.spec.eff_frames,
                    sub,
                    jnp.asarray(qs[r], jnp.float32),
                    jnp.asarray(vs[r], jnp.float32),
                    jnp.asarray(cnt_flags[r], jnp.float32),
                    sigma_base_pos=cfg.sigma_base_pos,
                    sigma_base_ori=cfg.sigma_base_ori,
                    sigma_joint_pos=cfg.sigma_joint_pos,
                    sigma_vel=cfg.sigma_vel,
                )
                qb.append(np.asarray(q0p))
                vb.append(np.asarray(v0p))
        qb = jnp.asarray(np.stack(qb), jnp.float32)
        vb = jnp.asarray(np.stack(vb), jnp.float32)
        res = self._rollout_fn(
            qb, vb, jnp.tile(vdj, (B, 1)), jnp.tile(wdj, (B,))
        )
        added += self._append_rollouts(res, v_des, w_des, qb)
        return {"v_des": v_des, "w_des": w_des, "datapoints_added": added,
                "database_size": len(self.database)}

    def run(self, q0, v0, save_path: str | None = None):
        logs = []
        for it in range(self.cfg.n_iteration):
            log = self.run_iteration(q0, v0)
            logs.append(log)
            if save_path is not None:
                self.database.save(f"{save_path}/database_{len(self.database)}.hdf5")
        return logs
