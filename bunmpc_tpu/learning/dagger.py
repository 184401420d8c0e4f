"""Iterative DAgger / SafeDAgger / LocoSafeDagger drivers.

JAX twins of the reference iteration loops (reference
examples/iterative_algorithm/dagger_modified.py:39-918,
safedagger_modified.py:51-916, locosafedagger_modified.py:62-627). The
structure is identical — {train -> roll out with expert mixing/gating ->
aggregate expert-labeled data} — but every rollout batch of an iteration runs
as one vmapped device program, and LocoSafeDagger's Bayesian grid update is
vectorized (learning/bayes.py).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..mpc import gait as G
from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout
from . import bayes
from . import goals as GU
from . import networks
from . import perturbations
from .bc import BcConfig, train_policy
from .database import Database


@dataclasses.dataclass
class DaggerConfig:
    """Defaults mirror cfgs/dagger_modified_config.yaml /
    safedagger_modified_config.yaml (trot row for the per-gait sigmas)."""

    episode_length: int = 2000
    n_iterations: int = 5
    rollouts_per_iteration: int = 8
    mpc_usage_percentage: float = 0.5  # DAgger mixing
    # reference num_steps_to_block_under_safety = 2000 (4 gait cycles,
    # safedagger_modified_config.yaml:87) — the round-4 demo's 150 released
    # control back to the policy after 3 swing phases, far too early for the
    # expert to actually stabilize + label a recovery segment
    num_steps_to_block: int = 2000
    vx_range: tuple = (-0.3, 0.5)
    vy_range: tuple = (-0.2, 0.2)
    w_range: tuple = (-0.3, 0.3)
    goal_type: str = "vc"
    action_type: str = "pd_target"  # torque | pd_target | structured
    database_size: int = 1_000_000
    warmup_bc_epochs: int = 150
    bc: BcConfig = dataclasses.field(default_factory=BcConfig)

    # --- reference loop structure (safedagger_modified.py:274-916) ---
    # warmup = perturbed-start MPC rollouts along the nominal trajectory
    # (the recovery data BC needs; round-4's standing-start-only warmup
    # produced policies that die within ~1 s), sized by rollouts_warmup
    # commands x one gait cycle of replan points x perturbations each.
    rollouts_warmup: int | None = None  # None -> rollouts_per_iteration
    episode_length_warmup: int | None = None  # None -> episode_length
    warmup_perturbations_per_replanning: int = 1
    # per data-collection episode: gated rollouts start from perturbed
    # states ON the nominal trajectory (num_replannings sampled replan
    # points x num_perturbations each), not from standing
    num_replannings: int = 1
    num_perturbations: int = 2
    # after each gated episode, an MPC-only rollout continues from its final
    # state (reference ending_mpc_rollout_episode_length; 0 disables)
    ending_mpc_rollout_ms: int = 1000
    # contact-conditioned perturbation sigmas (reference per-gait trot row)
    sigma_base_pos: float = 0.1
    sigma_base_ori: float = 0.7
    sigma_joint_pos: float = 0.2
    sigma_vel: float = 0.2
    # PD-settle the initial pose into contact equilibrium before episodes
    # (the in-graph soft-contact twin of PyBullet's spawn-in-contact)
    settle_ms: int = 500
    # Reference aggregation semantics (data_collection.py:272-277): failed
    # episodes contribute NOTHING. False keeps this repo's round-4 deviation
    # (pre-failure prefix minus PREFIX_MARGIN — recovery-tube coverage), but
    # at high failed_frac that floods the database with doomed trajectories
    # and the BC policy degrades iteration-over-iteration (round-5 demo:
    # survival 0.25 -> 0.08 -> 0.0 across iterations at failed_frac ~0.85).
    skip_failed_episodes: bool = False
    # Warmup override (None -> same as skip_failed_episodes). Round-5
    # controlled A/B (PARITY.md): prefix-keeping is LOAD-BEARING in the
    # perturbed-start warmup (warmup grid survival 1204 ms with vs 643 ms
    # without) while it poisons gated iterations — the measured best combo
    # is skip_failed_episodes=True with skip_failed_warmup=False.
    skip_failed_warmup: bool | None = None


class _IterativeDriver:
    """Shared train/rollout/aggregate scaffolding."""

    mode = "dagger"

    def __init__(
        self,
        spec: CyclicMpcSpec,
        cfg: DaggerConfig = DaggerConfig(),
        sim_params: physics.SimParams = physics.SimParams(),
        seed: int = 0,
        admm_cfg=None,
        ddp_cfg=None,
    ):
        self.admm_cfg = admm_cfg
        self.ddp_cfg = ddp_cfg
        self.spec = spec
        self.cfg = cfg
        self.sim_params = sim_params
        self.rng = np.random.default_rng(seed)
        self.key = jax.random.PRNGKey(seed)
        self.database = Database(cfg.database_size, goal_type=cfg.goal_type)
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
        self.policy = None
        self._params = None
        self._settled = None
        self._mpc_runs = {}

    def _mpc_run(self, ep_len: int):
        """Jitted vmapped MPC rollout of the given episode length; cached per
        length (warmup / data / ending rollouts differ)."""
        if ep_len not in self._mpc_runs:
            rcfg = dataclasses.replace(self.rcfg, episode_length=ep_len)
            spec, sp = self.spec, self.sim_params
            self._mpc_runs[ep_len] = jax.jit(
                jax.vmap(
                    lambda q, v, vd, wd, st: rollout.rollout_mpc(
                        spec, sp, rcfg, physics.SimState(q=q, v=v), vd, wd,
                        start_time=st, admm_cfg=self.admm_cfg, ddp_cfg=self.ddp_cfg,
                    )
                )
            )
        return self._mpc_runs[ep_len]

    def _mpc_rollout(self, qb, vb, vds, wds, st=None, ep_len=None):
        ep_len = ep_len or self.cfg.episode_length
        if st is None:
            st = jnp.zeros(qb.shape[0], jnp.float32)
        return self._mpc_run(ep_len)(qb, vb, vds, wds, st)

    def _settle(self, q0, v0):
        """Settled standing start shared by all episodes (see
        DaggerConfig.settle_ms)."""
        if self._settled is None:
            s0 = physics.SimState(
                q=jnp.asarray(q0, jnp.float32), v=jnp.asarray(v0, jnp.float32)
            )
            if self.cfg.settle_ms > 0:
                p = self.spec.params
                s0 = rollout.settle_state(
                    self.spec.model, tuple(self.spec.eff_frames), self.sim_params,
                    s0, p.kp, p.kd, ms=self.cfg.settle_ms,
                )
            self._settled = jax.block_until_ready(s0)
        return self._settled

    # --- perturbed on-trajectory starts (safedagger_modified.py:744-815) ---

    def _perturbed_starts(self, res, vds, wds, quota: int, sample_replans: bool):
        """Build ``quota`` contact-conditioned perturbed initial states from
        the replan points of the first gait cycle of each successful
        benchmark episode. Returns (qb, vb, st, vdl, wdl) jnp arrays — always
        exactly ``quota`` rows (candidates are cycled with fresh perturbation
        draws, keeping the vmapped rollout shape static across iterations) —
        or None when every benchmark failed before completing one cycle."""
        p = self.spec.params
        spp = self.rcfg.steps_per_plan
        n_cycle = max(1, int(round(p.gait_period / p.plan_freq)))
        n_windows = res.states.shape[1] // spp
        n_cycle = min(n_cycle, n_windows)
        feats = np.asarray(res.states)
        failed = np.asarray(res.failed)
        fstep = np.asarray(res.fail_step)
        cands = [
            (b, r)
            for b in range(feats.shape[0])
            if not (failed[b] and fstep[b] < n_cycle * spp)
            for r in range(n_cycle)
        ]
        if not cands:
            return None
        if sample_replans:
            idx = self.rng.integers(0, len(cands), quota)
        else:
            idx = np.arange(quota) % len(cands)
        qb, vb, st, vdl, wdl = [], [], [], [], []
        for i in idx:
            b, r = cands[int(i)]
            f = feats[b, r * spp]
            q_r = np.concatenate([[0.0, 0.0], f[26:]])  # features -> q (xy=0)
            v_r = f[:18]
            t_r = float(r * p.plan_freq)
            cnt = G.in_stance(self.spec.gait, jnp.asarray(t_r, jnp.float32))
            self.key, sub = jax.random.split(self.key)
            q0p, v0p, _ok = perturbations.sample_perturbed_state(
                self.spec.model, self.spec.eff_frames, sub,
                jnp.asarray(q_r, jnp.float32), jnp.asarray(v_r, jnp.float32),
                jnp.asarray(cnt, jnp.float32),
                sigma_base_pos=self.cfg.sigma_base_pos,
                sigma_base_ori=self.cfg.sigma_base_ori,
                sigma_joint_pos=self.cfg.sigma_joint_pos,
                sigma_vel=self.cfg.sigma_vel,
            )
            qb.append(np.asarray(q0p))
            vb.append(np.asarray(v0p))
            st.append(t_r)
            vdl.append(np.asarray(vds[b]))
            wdl.append(float(wds[b]))
        return (
            jnp.asarray(np.stack(qb), jnp.float32),
            jnp.asarray(np.stack(vb), jnp.float32),
            jnp.asarray(np.asarray(st), jnp.float32),
            jnp.asarray(np.stack(vdl), jnp.float32),
            jnp.asarray(np.asarray(wdl), jnp.float32),
        )

    # --- phases ---

    def warmup(self, q0, v0):
        """Initial expert data + BC policy (reference SafeDagger.warmup,
        safedagger_modified.py:274-461): nominal (standing-start) MPC
        episodes for each warmup command, then perturbed-start episodes from
        every replan point of the first gait cycle — the database BC warms up
        on is dominated by recovery data, not a single nominal tube."""
        cfg = self.cfg
        n_cmd = cfg.rollouts_warmup or cfg.rollouts_per_iteration
        ep = cfg.episode_length_warmup or cfg.episode_length
        s0 = self._settle(q0, v0)
        qb = jnp.tile(s0.q[None], (n_cmd, 1))
        vb = jnp.tile(s0.v[None], (n_cmd, 1))
        vds, wds = self._sample_commands(n_cmd)
        bench = self._mpc_rollout(qb, vb, vds, wds, ep_len=ep)
        sf_warm = (
            cfg.skip_failed_warmup
            if cfg.skip_failed_warmup is not None
            else cfg.skip_failed_episodes
        )
        self._aggregate(bench, expert_only=False, skip_failed=sf_warm)
        p = self.spec.params
        n_cycle = max(1, int(round(p.gait_period / p.plan_freq)))
        quota = n_cmd * n_cycle * cfg.warmup_perturbations_per_replanning
        pert = self._perturbed_starts(bench, vds, wds, quota, sample_replans=False)
        if pert is not None:
            qp, vp, st, vdl, wdl = pert
            res = self._mpc_rollout(qp, vp, vdl, wdl, st=st, ep_len=ep)
            self._aggregate(res, expert_only=False, skip_failed=sf_warm)
        self._train(warmup=True)

    def _sample_commands(self, B):
        vds, wds = [], []
        for _ in range(B):
            v_des, w_des = GU.sample_velocities(
                self.rng, self.cfg.vx_range, self.cfg.vy_range, self.cfg.w_range
            )
            vds.append(v_des)
            wds.append(w_des)
        return jnp.asarray(np.stack(vds), jnp.float32), jnp.asarray(np.array(wds), jnp.float32)

    def _train(self, warmup=False):
        cfg = dataclasses.replace(
            self.cfg.bc, n_epoch=self.cfg.warmup_bc_epochs if warmup else self.cfg.bc.n_epoch
        )
        self.policy, report = train_policy(
            self.database, cfg, rng_seed=int(self.rng.integers(1 << 31)), params=self._params
        )
        self._params = self.policy.params
        return report

    # steps cut off the end of a failed episode's surviving prefix: the final
    # ~quarter second before a fall is committed-to-falling data (saturated
    # recovery torques at extreme states) that an imitation target should not
    # contain (round-4 verdict: the database was dominated by near-failure
    # data). The reference skips failed episodes entirely
    # (data_collection.py:272-277); keeping the clean prefix preserves the
    # recovery-tube coverage its PyBullet expert gets for free.
    PREFIX_MARGIN = 250

    def _aggregate(self, res, expert_only=True, keep=None, skip_failed=None):
        """Append expert-labeled data; failed episodes contribute their
        pre-failure prefix minus PREFIX_MARGIN (or nothing, with
        ``skip_failed`` — reference data_collection.py:272-277 semantics),
        and for gated rollouts only MPC-controlled steps are kept (the
        DAgger label rule). ``keep``: optional (B,) bool mask dropping
        episodes entirely (e.g. ending-MPC rollouts whose gated episode
        already failed — their start state is frozen at the failure)."""
        if skip_failed is None:
            skip_failed = self.cfg.skip_failed_episodes
        added = 0
        for b in range(res.states.shape[0]):
            if keep is not None and not bool(keep[b]):
                continue
            if bool(res.failed[b]):
                if skip_failed:
                    continue
                T = int(res.fail_step[b]) - self.PREFIX_MARGIN
                if T < 100:
                    continue
            else:
                T = res.states.shape[1]
            mask = np.asarray(res.mpc_usage[b][:T]) > 0 if expert_only else np.ones(T, bool)
            if mask.sum() == 0:
                continue
            self.database.append(
                np.asarray(res.states[b][:T])[mask],
                np.asarray(res.actions[b][:T])[mask],
                vc_goals=np.asarray(res.vc_goals[b][:T])[mask],
            )
            added += int(mask.sum())
        return added

    def _policy_fn(self):
        pol = self.policy

        def fn(feat, goal):
            return pol(feat, goal)

        return fn

    def _make_gated_rollout(self):
        """Subclasses return ``gated(qb, vb, vds, wds, keys)``. The policy
        weights MUST flow through the jit as a traced pytree
        (networks.policy_tree) — closing over ``self.policy`` inside the
        jitted episode bakes the warmup weights as constants, and every
        later iteration silently rolls out the stale policy (round-4 fix;
        regression-tested in tests/test_drivers.py)."""
        raise NotImplementedError

    # --- elastic checkpoint / resume (SURVEY.md §5.3-5.4: the reference has
    # none — Slurm timeouts kill the loop and all progress; here the full
    # driver state persists per iteration and the loop resumes exactly) ---

    def _extra_state(self) -> dict:
        """Subclass hook: extra arrays to persist (e.g. Bayesian posterior)."""
        return {}

    def _load_extra_state(self, z):
        pass

    def save_checkpoint(self, ckpt_dir: str, iteration: int, logs: list):
        from ..utils import checkpoint as CK

        os.makedirs(ckpt_dir, exist_ok=True)
        self.database.save(os.path.join(ckpt_dir, "database.hdf5"))
        if self.policy is not None:
            CK.save_policy(self.policy, os.path.join(ckpt_dir, "policy"))
        np.savez(
            os.path.join(ckpt_dir, "driver_state.npz"),
            key=np.asarray(self.key),
            **self._extra_state(),
        )
        state = {
            "mode": self.mode,
            "next_iteration": iteration,
            "logs": logs,
            "rng_state": self.rng.bit_generator.state,
        }
        tmp = os.path.join(ckpt_dir, "state.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, os.path.join(ckpt_dir, "state.json"))

    def load_checkpoint(self, ckpt_dir: str):
        """Restore driver state; returns (next_iteration, logs)."""
        from ..utils import checkpoint as CK

        with open(os.path.join(ckpt_dir, "state.json")) as fh:
            state = json.load(fh)
        if state["mode"] != self.mode:
            raise ValueError(f"checkpoint mode {state['mode']!r} != driver {self.mode!r}")
        self.database.load_saved_database(os.path.join(ckpt_dir, "database.hdf5"))
        pol_dir = os.path.join(ckpt_dir, "policy")
        if os.path.exists(os.path.join(pol_dir, "meta.json")):
            self.policy = CK.load_policy(pol_dir)
            self._params = self.policy.params
        z = np.load(os.path.join(ckpt_dir, "driver_state.npz"))
        self.key = jnp.asarray(z["key"])
        self._load_extra_state(z)
        self.rng.bit_generator.state = state["rng_state"]
        return state["next_iteration"], state["logs"]

    def run(
        self,
        q0,
        v0,
        checkpoint_dir: str | None = None,
        resume: bool = False,
        eval_hook=None,
    ):
        """Full loop: warmup then iterate (safedagger_modified.py:464-900).

        With ``checkpoint_dir`` the full driver state (database, policy,
        RNG streams, loop counter) is snapshotted after every iteration;
        ``resume=True`` continues from the last snapshot.

        ``eval_hook(driver) -> dict`` (optional) is called after warmup and
        after every iteration's training step — the reference's per-iteration
        eval sweep slot (safedagger_modified.py:491-516); its dict is merged
        into that iteration's log entry."""
        start_it, logs = 0, []
        if resume and checkpoint_dir and os.path.exists(
            os.path.join(checkpoint_dir, "state.json")
        ):
            start_it, logs = self.load_checkpoint(checkpoint_dir)
        else:
            self.warmup(q0, v0)
            if eval_hook is not None:
                logs.append({"iteration": "warmup", **eval_hook(self)})
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, 0, logs)
        gated = self._make_gated_rollout()
        cfg = self.cfg
        s0 = self._settle(q0, v0)
        for it in range(start_it, cfg.n_iterations):
            n_cmd = cfg.rollouts_per_iteration
            vds, wds = self._sample_commands(n_cmd)

            # benchmark MPC episodes give the nominal trajectories the
            # perturbed gated starts ride on (safedagger_modified.py:700-815);
            # their data is NOT aggregated (reference parity — only warmup
            # and expert-labeled segments enter the database)
            qb = jnp.tile(s0.q[None], (n_cmd, 1))
            vb = jnp.tile(s0.v[None], (n_cmd, 1))
            bench = self._mpc_rollout(qb, vb, vds, wds)
            quota = n_cmd * cfg.num_replannings * cfg.num_perturbations
            pert = self._perturbed_starts(bench, vds, wds, quota, sample_replans=True)
            if pert is None:
                # every benchmark fell within one gait cycle: fall back to
                # settled standing starts so the iteration still collects
                qp = jnp.tile(s0.q[None], (quota, 1))
                vp = jnp.tile(s0.v[None], (quota, 1))
                st = jnp.zeros(quota, jnp.float32)
                rep = np.arange(quota) % n_cmd
                vdl = jnp.asarray(np.asarray(vds)[rep], jnp.float32)
                wdl = jnp.asarray(np.asarray(wds)[rep], jnp.float32)
            else:
                qp, vp, st, vdl, wdl = pert
            self.key, sub = jax.random.split(self.key)
            keys = jax.random.split(sub, quota)
            res = gated(qp, vp, vdl, wdl, keys, st)
            added = self._aggregate(res)

            # ending MPC rollout from each surviving episode's final state
            # (reference ending_mpc_rollout_episode_length block,
            # safedagger_modified.py:871-886): fresh expert data in whatever
            # region the policy dragged the state to
            added_end = 0
            if cfg.ending_mpc_rollout_ms > 0:
                st_end = st + cfg.episode_length * self.rcfg.sim_dt
                res_end = self._mpc_rollout(
                    res.final_state.q, res.final_state.v, vdl, wdl,
                    st=st_end, ep_len=cfg.ending_mpc_rollout_ms,
                )
                added_end = self._aggregate(
                    res_end, expert_only=False, keep=~np.asarray(res.failed)
                )

            report = self._train()
            entry = {
                "iteration": it,
                "datapoints_added": added + added_end,
                "datapoints_ending_mpc": added_end,
                "database_size": len(self.database),
                "train_loss_first": report.train_losses[0],
                "train_loss": report.train_losses[-1],
                "valid_loss": report.valid_losses[-1],
                "mpc_usage": float(np.mean(np.asarray(res.mpc_usage))),
                "failed_frac": float(np.mean(np.asarray(res.failed))),
                "bench_failed_frac": float(np.mean(np.asarray(bench.failed))),
            }
            if eval_hook is not None:
                entry.update(eval_hook(self))
            logs.append(entry)
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, it + 1, logs)
        return logs


class Dagger(_IterativeDriver):
    """Classic DAgger (reference dagger_modified.py)."""

    mode = "dagger"

    def _make_gated_rollout(self):
        spec, sp, rcfg, cfg = self.spec, self.sim_params, self.rcfg, self.cfg

        def one(q, v, vd, wd, key, st, ptree):
            pol_fn = networks.policy_fn_from_tree(self.policy.module, ptree)
            return rollout.rollout_dagger(
                spec, sp, rcfg, physics.SimState(q=q, v=v), vd, wd,
                pol_fn, key, mpc_usage_percentage=cfg.mpc_usage_percentage,
                start_time=st, admm_cfg=self.admm_cfg, ddp_cfg=self.ddp_cfg,
            )

        run = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None)))
        return lambda qb, vb, vds, wds, keys, st=None: run(
            qb, vb, vds, wds, keys,
            jnp.zeros(qb.shape[0], jnp.float32) if st is None else st,
            networks.policy_tree(self.policy),
        )


class SafeDagger(_IterativeDriver):
    """Safety-gated DAgger (reference safedagger_modified.py)."""

    mode = "safedagger"

    def _make_gated_rollout(self):
        spec, sp, rcfg, cfg = self.spec, self.sim_params, self.rcfg, self.cfg

        def one(q, v, vd, wd, key, st, ptree):
            pol_fn = networks.policy_fn_from_tree(self.policy.module, ptree)
            return rollout.rollout_safedagger(
                spec, sp, rcfg, physics.SimState(q=q, v=v), vd, wd,
                pol_fn, num_steps_to_block=cfg.num_steps_to_block,
                start_time=st, admm_cfg=self.admm_cfg, ddp_cfg=self.ddp_cfg,
            )

        run = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None)))
        return lambda qb, vb, vds, wds, keys, st=None: run(
            qb, vb, vds, wds, keys,
            jnp.zeros(qb.shape[0], jnp.float32) if st is None else st,
            networks.policy_tree(self.policy),
        )


def weighted_vc_error(states, fail_step, failed, v_des, w_des):
    """Weighted velocity-tracking error of a rollout batch, exactly the
    reference's formula (locosafedagger_modified.py:566-585):

        e = 0.4 * vx_mse^2 + 0.3 * vy_mse^2 + 0.3 * w_mse^2

    with the component MSEs from ``compute_vc_mse`` (utils.py:221-237) over
    the base-local velocity rows of the state featurization — state[:, 0:2]
    are (vx, vy) and state[:, 5] is the yaw rate, the same rows the reference
    reads (it measures in the local frame too; the round-2 driver used only
    vx/vy, advisor finding). Failed episodes count their surviving prefix."""
    states = np.asarray(states)
    B, T = states.shape[0], states.shape[1]
    fail_step = np.asarray(fail_step)
    failed = np.asarray(failed)
    errs = []
    for b in range(B):
        Tb = int(fail_step[b]) if bool(failed[b]) else T
        if Tb < 2:
            errs.append(np.inf)
            continue
        vx_e, vy_e, w_e = GU.compute_vc_mse(
            np.asarray(v_des), float(w_des), states[b, :Tb, 0:2], states[b, :Tb, 5]
        )
        errs.append(0.4 * vx_e**2 + 0.3 * vy_e**2 + 0.3 * w_e**2)
    return float(np.mean(errs))


class LocoSafeDagger(_IterativeDriver):
    """LocoSafeDagger (reference locosafedagger_modified.py:62-627,
    run_unperturbed :449-617): each iteration samples its training goal from
    a Bayesian posterior over the velocity grid, rolls out BOTH the MPC
    expert and the current policy for that goal, computes the weighted
    vx/vy/w tracking error of each, aggregates whichever rollout tracked
    better (:586-605), and updates the posterior with a Gaussian likelihood
    centered at the attempted goal (:357-384; the reference's error argument
    is dropped by an argument-order bug in its own call site — here the
    error-scaled-likelihood extension is opt-in via
    ``error_scaled_likelihood``, off by default to match the effective
    reference behavior)."""

    mode = "locosafedagger"

    def __init__(
        self,
        *args,
        grid_n: int = 30,
        error_scaled_likelihood: bool = False,
        grid: "bayes.GoalGrid | None" = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        # an explicit grid lets a degenerate task envelope (e.g. vx-only)
        # use singleton vy/w axes instead of n duplicated zero rows
        self.grid = grid if grid is not None else bayes.GoalGrid.make(
            self.cfg.vx_range, self.cfg.vy_range, self.cfg.w_range, n=grid_n
        )
        self.posterior = self.grid.uniform_prior()
        self.error_scaled_likelihood = error_scaled_likelihood
        self._policy_rollout = None

    def _extra_state(self):
        return {"posterior": np.asarray(self.posterior)}

    def _load_extra_state(self, z):
        if "posterior" in z.files:
            self.posterior = jnp.asarray(z["posterior"])

    def _make_policy_rollout(self):
        spec, sp, rcfg = self.spec, self.sim_params, self.rcfg

        def one(q, v, vd, wd, ptree):
            pol_fn = networks.policy_fn_from_tree(self.policy.module, ptree)
            return rollout.rollout_policy(
                spec, sp, rcfg, physics.SimState(q=q, v=v), vd, wd, pol_fn
            )

        run = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
        return lambda qb, vb, vds, wds: run(
            qb, vb, vds, wds, networks.policy_tree(self.policy)
        )

    def select_rollout(self, res_mpc, res_policy, v_des, w_des):
        """The reference decision rule (locosafedagger_modified.py:586-605):
        aggregate the rollout with the smaller weighted tracking error.
        Returns ("mpc"|"policy", e_mpc, e_policy)."""
        e_mpc = weighted_vc_error(
            res_mpc.states, res_mpc.fail_step, res_mpc.failed, v_des, w_des
        )
        e_policy = weighted_vc_error(
            res_policy.states, res_policy.fail_step, res_policy.failed, v_des, w_des
        )
        return ("mpc" if e_mpc < e_policy else "policy"), e_mpc, e_policy

    def run(
        self,
        q0,
        v0,
        checkpoint_dir: str | None = None,
        resume: bool = False,
        eval_hook=None,
    ):
        start_it, logs = 0, []
        if resume and checkpoint_dir and os.path.exists(
            os.path.join(checkpoint_dir, "state.json")
        ):
            start_it, logs = self.load_checkpoint(checkpoint_dir)
        else:
            self.warmup(q0, v0)
            if eval_hook is not None:
                logs.append({"iteration": "warmup", **eval_hook(self)})
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, 0, logs)
        policy_rollout = self._make_policy_rollout()
        s0 = self._settle(q0, v0)
        for it in range(start_it, self.cfg.n_iterations):
            goal = bayes.random_sample_from_distribution(self.rng, self.grid, self.posterior)
            v_des = np.array([goal[0], goal[1], 0.0])
            w_des = float(goal[2])
            B = self.cfg.rollouts_per_iteration
            qb = jnp.tile(s0.q[None], (B, 1))
            vb = jnp.tile(s0.v[None], (B, 1))
            vds = jnp.asarray(np.tile(v_des, (B, 1)), jnp.float32)
            wds = jnp.asarray(np.full(B, w_des), jnp.float32)

            # dual rollout: nominal MPC expert AND the current policy
            res_mpc = self._mpc_rollout(qb, vb, vds, wds)
            res_policy = policy_rollout(qb, vb, vds, wds)
            choice, e_mpc, e_policy = self.select_rollout(res_mpc, res_policy, v_des, w_des)
            chosen = res_mpc if choice == "mpc" else res_policy
            added = self._aggregate(chosen, expert_only=False)
            err = min(e_mpc, e_policy)

            like = bayes.compute_likelihood(
                self.grid, goal, error=err if self.error_scaled_likelihood else None
            )
            self.posterior = bayes.update_goal_distribution(self.posterior, like)
            post = np.asarray(self.posterior)
            entropy = float(-(post[post > 0] * np.log(post[post > 0])).sum())

            report = self._train()
            entry = {
                "iteration": it,
                "goal": goal.tolist(),
                "aggregated": choice,
                "e_mpc": e_mpc,
                "e_policy": e_policy,
                "tracking_error": err,
                # posterior concentration signal (the "Bayesian Updates" in
                # BUNMPC's name): entropy of the goal posterior after this
                # iteration's multiplicative update — strictly below the
                # uniform prior's log(N) once any update has been applied
                "posterior_entropy": entropy,
                "datapoints_added": added,
                "database_size": len(self.database),
                "train_loss_first": report.train_losses[0],
                "train_loss": report.train_losses[-1],
                "valid_loss": report.valid_losses[-1],
            }
            if eval_hook is not None:
                entry.update(eval_hook(self))
            logs.append(entry)
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, it + 1, logs)
        return logs
