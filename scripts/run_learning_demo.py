"""Committed end-to-end learning-loop demonstration at real scale.

VERDICT round-4 task 1: a committed SafeDagger run whose best checkpoint
reaches survival >= 0.5 on the 12-point velocity grid (full 2000+ ms
episodes) with finite tracking MSE — the reference's headline capability
(safedagger_modified.py:464-916, eval sweep :491-516).

Round-5 restructure (the round-4 demo peaked at survival 1/12): the driver
now follows the reference loop shape exactly —
* warmup database = perturbed-start MPC rollouts along the nominal
  trajectory (recovery data; safedagger_modified.py:274-461), not
  standing-start episodes only;
* gated rollouts start from contact-conditioned perturbed states ON the
  nominal trajectory with phase-consistent start times (:744-815);
* num_steps_to_block_under_safety = 2000 (4 gait cycles,
  safedagger_modified_config.yaml:87) instead of 150;
* each episode appends an ending MPC-only rollout (:871-886);
* the task envelope is the reference's: vx in [0, 0.33], vy = w = 0
  (safedagger_modified_config.yaml:10-15).

Setup: Solo12 trot with the sim-validated trot_sim table (kp=12, kd=0.5,
W_F x0.1 — artifacts/stability_sweep_solo12_wf01.json) and contact params
kn=1e4/dn=500/kt=500; episodes start from the PD-settled standing state.
All spec/gain/sigma provenance is recorded in the artifact meta line.

After warmup and after every iteration the current policy is evaluated on a
fixed 12-point (vx, w=0) grid (eval/velocity_grid.py). Output is strict
JSON (non-finite -> null, utils/jsonio): one line of meta, one line per
stage, and a final {"best_iteration": ...} summary line.

Writes artifacts/learning_demo_safedagger.jsonl, gated by
tests/test_learning_demo.py.

Usage: python scripts/run_learning_demo.py [out_path] [n_iterations]
        [commands_per_iter] [episode_ms] [skip_failed_episodes(0|1)]
Runs on the GPU; one process per card.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

import numpy as np

from bunmpc_tpu.eval.velocity_grid import eval_policy_grid
from bunmpc_tpu.learning.bc import BcConfig
from bunmpc_tpu.learning.dagger import DaggerConfig, SafeDagger
from bunmpc_tpu.learning.networks import policy_fn_from_tree, policy_tree
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.sim import physics, rollout
from bunmpc_tpu.utils import jsonio

CONTACT = dict(kn=1e4, dn=500.0, kt=500.0)


def make_cfg(n_iter, n_cmd, ep_ms, skip_failed):
    """The demo's DaggerConfig — shared with finalize_learning_demo.py so a
    checkpoint-reconstructed artifact records the same provenance."""
    return DaggerConfig(
        episode_length=ep_ms,
        n_iterations=n_iter,
        rollouts_per_iteration=n_cmd,
        vx_range=(0.0, 0.33),  # reference task envelope (config:10-15)
        vy_range=(0.0, 0.0),
        w_range=(0.0, 0.0),
        rollouts_warmup=10,
        episode_length_warmup=1500,
        warmup_perturbations_per_replanning=1,
        num_replannings=1,
        num_perturbations=4,
        num_steps_to_block=2000,
        ending_mpc_rollout_ms=1000,
        warmup_bc_epochs=60,
        bc=BcConfig(n_epoch=20),
        # half the reference's nominal trot sigmas: the reference's sampler
        # has an argument-mixing bug that makes its EFFECTIVE velocity
        # perturbations much smaller than configured (PARITY.md), and the
        # in-graph expert fails 0.61 of episodes at the nominal values vs
        # 0.46 at half (artifacts/expert_robustness_probe.json)
        sigma_base_pos=0.05,
        sigma_base_ori=0.35,
        sigma_joint_pos=0.1,
        sigma_vel=0.1,
        skip_failed_episodes=skip_failed,
        # measured combo (PARITY.md round-5 A/B): prefix-keeping warmup is
        # load-bearing even when gated iterations skip failed episodes
        skip_failed_warmup=False,
    )


def build_meta(cfg, n_iter, n_cmd, ep_ms, **extra):
    """Artifact meta line (advisor round-4: full provenance so a re-run
    reproduces the artifact)."""
    return {
        "mode": "safedagger",
        "robot": "solo12",
        "gait": "trot_sim",
        "kp": trot_sim.kp,
        "kd": trot_sim.kd,
        "contact": CONTACT,
        "n_iterations": n_iter,
        "commands_per_iteration": n_cmd,
        "rollouts_per_iteration": n_cmd * cfg.num_replannings * cfg.num_perturbations,
        "episode_length": ep_ms,
        "episode_length_warmup": cfg.episode_length_warmup,
        "rollouts_warmup": cfg.rollouts_warmup,
        "num_steps_to_block": cfg.num_steps_to_block,
        "ending_mpc_rollout_ms": cfg.ending_mpc_rollout_ms,
        "skip_failed_episodes": cfg.skip_failed_episodes,
        "sigmas": {
            "base_pos": cfg.sigma_base_pos,
            "base_ori": cfg.sigma_base_ori,
            "joint_pos": cfg.sigma_joint_pos,
            "vel": cfg.sigma_vel,
        },
        "vx_range": list(cfg.vx_range),
        "warmup_bc_epochs": cfg.warmup_bc_epochs,
        "bc_epochs": cfg.bc.n_epoch,
        **extra,
    }


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = (
        sys.argv[1]
        if len(sys.argv) > 1
        else os.path.join(root, "artifacts", "learning_demo_safedagger.jsonl")
    )
    n_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    n_cmd = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    ep_ms = int(sys.argv[4]) if len(sys.argv) > 4 else 3000
    skip_failed = bool(int(sys.argv[5])) if len(sys.argv) > 5 else False

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    sim_params = physics.SimParams(contact=physics.ContactParams(**CONTACT))
    cfg = make_cfg(n_iter, n_cmd, ep_ms, skip_failed)
    driver = SafeDagger(spec, cfg, sim_params=sim_params, seed=0)

    # fixed eval grid shared across stages (reference eval sweep shape:
    # vx in linspace over the command envelope, safedagger_modified.py:491)
    vx_grid = np.linspace(0.0, 0.33, 12)
    ecfg = rollout.RolloutConfig(
        episode_length=2000,
        action_type=cfg.action_type,
        kp=trot_sim.kp,
        kd=trot_sim.kd,
        gait_period=trot_sim.gait_period,
    )
    state0 = driver._settle(Solo12Config.q0(), Solo12Config.v0())

    def eval_hook(drv):
        t0 = time.time()
        pol_fn = policy_fn_from_tree(drv.policy.module, policy_tree(drv.policy))
        res = eval_policy_grid(
            spec, sim_params, ecfg, state0, pol_fn, vx_grid, w_values=(0.0,)
        )
        s = res.summary()
        # scalar gates: (1) mean survival time (graded — binary survival
        # saturates at 0 early in learning), (2) tracking MSE with failed
        # commands charged the worst surviving error x2 (dying early can't
        # look "accurate"); inf (-> null in the artifact) while nothing
        # survives
        mse = res.vx_mse + res.vy_mse
        if res.survived.any():
            penalty = 2.0 * float(mse[res.survived].max())
        else:
            penalty = float("inf")
        score = float(np.where(res.survived, mse, penalty).mean())
        return {
            "eval": {
                **s,
                "tracking_score": score,
                "per_vx": [
                    {
                        "vx_des": float(res.v_des[i, 0]),
                        "vx_mse": float(res.vx_mse[i]),
                        "survived": bool(res.survived[i]),
                        "survival_ms": int(res.fail_step[i]),
                        "mean_speed": float(res.mean_speed[i]),
                    }
                    for i in range(len(res.w_des))
                ],
                "eval_seconds": round(time.time() - t0, 1),
            }
        }

    # elastic checkpointing: a crash (or the round clock) loses at most one
    # iteration; re-running the script resumes from the last snapshot.
    # Per-output-stem dir so variant runs don't resume each other's state
    # (the default stem keeps the historical .ckpt_learning_demo name).
    stem = os.path.splitext(os.path.basename(out))[0]
    ckpt_dir = os.path.join(
        root,
        ".ckpt_learning_demo"
        if stem == "learning_demo_safedagger"
        else f".ckpt_{stem}",
    )
    t0 = time.time()
    logs = driver.run(
        Solo12Config.q0(),
        Solo12Config.v0(),
        eval_hook=eval_hook,
        checkpoint_dir=ckpt_dir,
        resume=True,
    )
    wall = time.time() - t0

    meta = build_meta(
        cfg, n_iter, n_cmd, ep_ms,
        device=str(jax.devices()[0]),
        wall_seconds=round(wall, 1),
    )
    # best checkpoint by (survival, mean survival) — the deployable product
    iters = [e for e in logs if isinstance(e.get("iteration"), int)]
    best = max(
        iters,
        key=lambda s: (
            s["eval"]["survival_rate"],
            s["eval"].get("mean_survival_ms", 0),
        ),
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    entries = [{"meta": meta}] + logs + [
        {
            "best_iteration": best["iteration"],
            "survival_rate": best["eval"]["survival_rate"],
            "mean_survival_ms": best["eval"]["mean_survival_ms"],
            "tracking_score": best["eval"]["tracking_score"],
        }
    ]
    jsonio.write_jsonl(out, entries)
    print(f"wrote {out} ({len(logs)} stages, {wall:.0f}s)")
    for entry in logs:
        it = entry.get("iteration")
        ev = entry.get("eval", {})
        print(
            f"  it={it} train_loss={entry.get('train_loss', float('nan')):.4f} "
            f"failed_frac={entry.get('failed_frac')} "
            f"survival={ev.get('survival_rate')} "
            f"mean_survival_ms={ev.get('mean_survival_ms')} "
            f"score={ev.get('tracking_score')}"
        )


if __name__ == "__main__":
    main()
