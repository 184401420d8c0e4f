"""Iterative-learning drivers (CLI): DAgger / SafeDAgger / LocoSafeDagger.

Twin of the reference driver scripts (dagger_modified.py,
safedagger_modified.py, locosafedagger_modified.py):

    python scripts/run_dagger.py mode=safedagger [key=value ...]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()  # persistent compile cache
    from bunmpc_tpu.learning.bc import BcConfig
    from bunmpc_tpu.learning.dagger import (
        Dagger,
        DaggerConfig,
        LocoSafeDagger,
        SafeDagger,
    )
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.utils.checkpoint import save_policy
    from bunmpc_tpu.utils.config import load_config
    from bunmpc_tpu.utils.logging import MetricsLogger

    args = sys.argv[1:]
    mode = next((a.split("=", 1)[1] for a in args if a.startswith("mode=")), "safedagger")
    overrides = [a for a in args if not a.startswith("mode=")]
    cfg = load_config(mode if mode != "dagger" else "dagger", overrides)

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    d_cfg = DaggerConfig(
        episode_length=cfg.get("episode_length", 2000),
        n_iterations=cfg.get("n_iterations", 5),
        rollouts_per_iteration=cfg.get("rollouts_per_iteration", 8),
        mpc_usage_percentage=cfg.get("mpc_usage_percentage", 0.5),
        num_steps_to_block=cfg.get("num_steps_to_block", 150),
        vx_range=tuple(cfg.get("vx_range", (-0.3, 0.5))),
        vy_range=tuple(cfg.get("vy_range", (-0.2, 0.2))),
        w_range=tuple(cfg.get("w_range", (-0.3, 0.3))),
        goal_type=cfg.get("goal_type", "vc"),
        action_type=cfg.get("action_type", "pd_target"),
        warmup_bc_epochs=cfg.get("warmup_bc_epochs", 150),
        bc=BcConfig(n_epoch=cfg.get("bc_epochs", 50)),
    )
    driver_cls = {"dagger": Dagger, "safedagger": SafeDagger, "locosafedagger": LocoSafeDagger}[
        mode
    ]
    kwargs = {"grid_n": cfg.get("grid_n", 30)} if mode == "locosafedagger" else {}
    driver = driver_cls(spec, d_cfg, **kwargs)

    out = cfg.get("save_path", f"./models/{mode}")
    os.makedirs(out, exist_ok=True)
    logger = MetricsLogger(out)
    # elastic resume (capability the reference lacks, SURVEY.md §5.3): the
    # full driver state snapshots every iteration; resume=true continues a
    # killed run from the last snapshot.
    ckpt_dir = cfg.get("checkpoint_dir", os.path.join(out, "checkpoint"))
    resume = bool(cfg.get("resume", False))
    logs = driver.run(
        Solo12Config.q0(), Solo12Config.v0(), checkpoint_dir=ckpt_dir, resume=resume
    )
    for log in logs:
        logger.log(log)
    save_policy(driver.policy, os.path.join(out, "policy"))
    print(f"{mode} finished: {logs[-1]}")


if __name__ == "__main__":
    main()
