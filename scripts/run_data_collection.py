"""Data-collection experiment driver (CLI).

Twin of the reference's ``data_collection.py`` Hydra entry point (reference
examples/iterative_algorithm/data_collection.py:282-288):

    python scripts/run_data_collection.py [key=value ...]

Overrides use dotted paths into bunmpc_tpu/configs/data_collection.yaml.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()  # persistent compile cache
    import jax

    from bunmpc_tpu.learning.data_collection import DataCollection, DataCollectionConfig
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.utils.config import hydrate, load_config
    from bunmpc_tpu.utils.logging import MetricsLogger

    cfg = load_config("data_collection", sys.argv[1:])
    gait = GAITS[cfg.get("gaits", ["trot"])[0]]
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, gait, Solo12Config.q0())

    dc_cfg = DataCollectionConfig(
        episode_length=cfg.get("episode_length", 3000),
        n_iteration=cfg.get("n_iteration", 5),
        num_perturbations_per_replanning=cfg.get("num_perturbations_per_replanning", 2),
        goal_horizon=cfg.get("goal_horizon", 1),
        vx_range=tuple(cfg.get("vx_range", (0.0, 0.3))),
        vy_range=tuple(cfg.get("vy_range", (0.0, 0.0))),
        w_range=tuple(cfg.get("w_range", (0.0, 0.0))),
        action_type=cfg.get("action_type", "pd_target"),
        database_size=cfg.get("database_size", 1_000_000),
    )
    out = cfg.get("data_save_path", "./data")
    os.makedirs(out, exist_ok=True)
    logger = MetricsLogger(out)
    dc = DataCollection(spec, dc_cfg)
    logs = dc.run(Solo12Config.q0(), Solo12Config.v0(), save_path=out)
    for i, log in enumerate(logs):
        logger.log({"iteration": i, **{k: str(v) for k, v in log.items()}})
    print(f"collected {len(dc.database)} datapoints -> {out}")


if __name__ == "__main__":
    main()
