"""Committed LocoSafeDagger run at real scale (VERDICT round-4 task 5).

One committed run (>= 3 iterations, realistic 2000 ms episodes) of the
LocoSafeDagger loop — the "Bayesian Updates" BUNMPC is named for (reference
locosafedagger_modified.py:357-425, 560-605) — showing:

* the Bayesian posterior over the velocity-goal grid CONCENTRATING
  (posterior entropy falling monotonically below the uniform prior's log N),
* goal sampling responding to it (each iteration's goal is a categorical
  draw from the current posterior),
* the dual-rollout decision rule at work (per goal, BOTH the MPC expert and
  the current policy roll out; the better tracker is aggregated).

Setup mirrors scripts/run_learning_demo.py (Solo12 trot_sim, sim-validated
contact params, perturbed-start warmup). Writes
artifacts/locosafedagger_demo.jsonl (strict JSON), gated by
tests/test_learning_demo.py::test_locosafedagger_posterior_concentrates.

Usage: python scripts/run_locosafedagger_demo.py [out_path] [n_iterations]
        [rollouts_per_iter] [episode_ms]
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

from bunmpc_tpu.learning.bc import BcConfig
from bunmpc_tpu.learning.dagger import DaggerConfig, LocoSafeDagger
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.sim import physics
from bunmpc_tpu.utils import jsonio

CONTACT = dict(kn=1e4, dn=500.0, kt=500.0)


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = (
        sys.argv[1]
        if len(sys.argv) > 1
        else os.path.join(root, "artifacts", "locosafedagger_demo.jsonl")
    )
    n_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    n_roll = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    ep_ms = int(sys.argv[4]) if len(sys.argv) > 4 else 2000

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    sim_params = physics.SimParams(contact=physics.ContactParams(**CONTACT))
    cfg = DaggerConfig(
        episode_length=ep_ms,
        n_iterations=n_iter,
        rollouts_per_iteration=n_roll,
        vx_range=(0.0, 0.33),
        vy_range=(-0.05, 0.05),
        w_range=(-0.1, 0.1),
        rollouts_warmup=8,
        episode_length_warmup=1500,
        warmup_bc_epochs=60,
        bc=BcConfig(n_epoch=20),
    )
    driver = LocoSafeDagger(spec, cfg, sim_params=sim_params, seed=0, grid_n=30)
    prior_entropy = float(np.log(np.prod(driver.grid.shape)))

    t0 = time.time()
    logs = driver.run(Solo12Config.q0(), Solo12Config.v0())
    wall = time.time() - t0

    meta = {
        "mode": "locosafedagger",
        "robot": "solo12",
        "gait": "trot_sim",
        "kp": trot_sim.kp,
        "kd": trot_sim.kd,
        "contact": CONTACT,
        "n_iterations": n_iter,
        "rollouts_per_iteration": n_roll,
        "episode_length": ep_ms,
        "grid_n": 30,
        "prior_entropy": prior_entropy,
        "sigmas": {
            "base_pos": cfg.sigma_base_pos,
            "base_ori": cfg.sigma_base_ori,
            "joint_pos": cfg.sigma_joint_pos,
            "vel": cfg.sigma_vel,
        },
        "device": str(jax.devices()[0]),
        "wall_seconds": round(wall, 1),
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    jsonio.write_jsonl(out, [{"meta": meta}] + logs)
    print(f"wrote {out} ({len(logs)} stages, {wall:.0f}s)")
    for e in logs:
        if isinstance(e.get("iteration"), int):
            print(
                f"  it={e['iteration']} goal={e['goal']} agg={e['aggregated']} "
                f"e_mpc={e['e_mpc']:.4g} e_policy={e['e_policy']:.4g} "
                f"H(post)={e['posterior_entropy']:.3f} (prior {prior_entropy:.3f})"
            )


if __name__ == "__main__":
    main()
