"""Policy-remembering ("past goals") evaluation.

JAX twin of the reference
``test_policy_rollout_with_past_goals.py`` (reference
examples/iterative_algorithm/test_policy_rollout_with_past_goals.py:481-660,
the only eval driver without a round-2 counterpart): goals are visited
sequentially; after training on goal ``i`` the policy is rolled out on EVERY
past goal ``j <= i`` and the vx/vy velocity-tracking MSEs are recorded,
yielding the lower-triangular "forgetting matrix" the reference exports to
xlsx (error_vx_his / error_vy_his).

The reference needs ``i+1`` sequential PyBullet episodes per iteration; here
the past-goal sweep of one iteration is a SINGLE vmapped rollout batch
(all past goals in parallel on the chip).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..learning.bc import BcConfig, train_policy
from ..learning.database import Database
from ..learning import goals as GU
from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout


@dataclasses.dataclass
class PastGoalsResult:
    goals: np.ndarray  # (n, 4) [vx, vy, vz, w]
    error_vx: np.ndarray  # (n, n) lower-triangular MSE matrix
    error_vy: np.ndarray  # (n, n)
    survived: np.ndarray  # (n, n) bool

    def forgetting(self):
        """Mean error increase on goal j between its own iteration and the
        final iteration — the quantitative 'did it forget' scalar."""
        n = self.error_vx.shape[0]
        diag = np.array([self.error_vx[j, j] for j in range(n)])
        final = self.error_vx[n - 1, :]
        return float(np.nanmean(final[: n - 1] - diag[: n - 1])) if n > 1 else 0.0

    def to_csv(self, path: str):
        n = self.error_vx.shape[0]
        with open(path, "w") as fh:
            fh.write("iteration,goal_idx,vx_des,vy_des,w_des,vx_mse,vy_mse,survived\n")
            for i in range(n):
                for j in range(i + 1):
                    g = self.goals[j]
                    fh.write(
                        f"{i},{j},{g[0]:.4f},{g[1]:.4f},{g[3]:.4f},"
                        f"{self.error_vx[i, j]:.6f},{self.error_vy[i, j]:.6f},"
                        f"{int(self.survived[i, j])}\n"
                    )


def run_past_goals_eval(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    rcfg: rollout.RolloutConfig,
    q0,
    v0,
    goal_list,  # (n, 4) rows [vx, vy, vz, w] (reference: linspace over ranges)
    bc_cfg: BcConfig = BcConfig(),
    database_size: int = 200_000,
    seed: int = 0,
    admm_cfg=None,
    ddp_cfg=None,
) -> PastGoalsResult:
    """Sequential-goal BC with past-goal re-evaluation (reference
    run_unperturbed loop): per iteration i — nominal MPC rollout at goal i,
    aggregate, train, then ONE batched policy rollout over goals[0..i]."""
    goal_list = np.asarray(goal_list, np.float32)
    n = goal_list.shape[0]
    db = Database(database_size, goal_type="vc")
    rng = np.random.default_rng(seed)
    params = None

    mpc_roll = jax.jit(
        lambda q, v, vd, wd: rollout.rollout_mpc(
            spec, sim_params, rcfg, physics.SimState(q=q, v=v), vd, wd,
            admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
        )
    )

    error_vx = np.full((n, n), np.nan)
    error_vy = np.full((n, n), np.nan)
    survived = np.zeros((n, n), bool)
    qj = jnp.asarray(q0, jnp.float32)
    vj = jnp.asarray(v0, jnp.float32)

    policy_batch = None
    for i in range(n):
        vd = jnp.asarray(goal_list[i, 0:3])
        wd = jnp.asarray(goal_list[i, 3])
        res = mpc_roll(qj, vj, vd, wd)
        T = int(res.fail_step[()]) if bool(res.failed) else res.states.shape[0]
        if T > 50:
            db.append(
                np.asarray(res.states[:T]),
                np.asarray(res.actions[:T]),
                vc_goals=np.asarray(res.vc_goals[:T]),
            )
        policy, _ = train_policy(db, bc_cfg, rng_seed=int(rng.integers(1 << 31)), params=params)
        params = policy.params

        if policy_batch is None:
            module = policy.module  # static architecture; weights are args

            def policy_batch_fn(ptree, qb, vb, vds, wds):
                p, sm, ss, gm, gs = ptree

                def pf(feat, goal):
                    x = jnp.concatenate(
                        [(feat - sm) / ss, (goal - gm) / gs], axis=-1
                    )
                    return module.apply({"params": p}, x)

                def one(q, v, vd, wd):
                    return rollout.rollout_policy(
                        spec, sim_params, rcfg, physics.SimState(q=q, v=v), vd, wd, pf
                    )

                return jax.vmap(one)(qb, vb, vds, wds)

            policy_batch = jax.jit(policy_batch_fn)

        ptree = (
            policy.params, policy.state_mean, policy.state_std,
            policy.goal_mean, policy.goal_std,
        )
        B = i + 1
        # evaluate on the full padded goal set so the jit compiles once;
        # rows j > i are discarded below
        vds = jnp.asarray(goal_list[:, 0:3])
        wds = jnp.asarray(goal_list[:, 3])
        qb = jnp.broadcast_to(qj, (n,) + qj.shape)
        vb = jnp.broadcast_to(vj, (n,) + vj.shape)
        pres = policy_batch(ptree, qb, vb, vds, wds)
        st = np.asarray(pres.states)
        failed = np.asarray(pres.failed)
        fail_step = np.asarray(pres.fail_step)
        for j in range(B):
            Tj = int(fail_step[j]) if bool(failed[j]) else st.shape[1]
            if Tj < 2:
                continue
            vx_e, vy_e, _ = GU.compute_vc_mse(
                goal_list[j, 0:3], float(goal_list[j, 3]),
                st[j, :Tj, 0:2], st[j, :Tj, 5],
            )
            error_vx[i, j] = vx_e
            error_vy[i, j] = vy_e
            survived[i, j] = not bool(failed[j])

    return PastGoalsResult(
        goals=goal_list, error_vx=error_vx, error_vy=error_vy, survived=survived
    )
