"""Behavioral-cloning training driver (CLI).

Twin of the reference ``behavioral_cloning_train.py`` entry point:

    python scripts/run_bc.py database=path/to/database.hdf5 [key=value ...]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()  # persistent compile cache
    import numpy as np

    from bunmpc_tpu.learning.bc import BcConfig, train_policy
    from bunmpc_tpu.learning.database import Database
    from bunmpc_tpu.utils.checkpoint import save_policy
    from bunmpc_tpu.utils.config import load_config
    from bunmpc_tpu.utils.logging import MetricsLogger

    cfg = load_config("bc", [a for a in sys.argv[1:] if not a.startswith("database=")])
    db_path = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("database=")), None)
    if db_path is None:
        raise SystemExit("usage: run_bc.py database=path.hdf5 [overrides]")

    db = Database(cfg.get("database_size", 2_000_000), goal_type=cfg.get("goal_type", "cc"))
    db.load_saved_database(db_path)
    print(f"loaded database: {len(db)} samples")

    bc_cfg = BcConfig(
        batch_size=cfg.get("batch_size", 256),
        learning_rate=cfg.get("learning_rate", 2e-3),
        n_epoch=cfg.get("n_epoch", 150),
        num_hidden_layer=cfg.get("num_hidden_layer", 3),
        hidden_dim=cfg.get("hidden_dim", 512),
        loss=cfg.get("loss", "l1"),
    )
    out = cfg.get("save_path", "./models/bc_policy")
    logger = MetricsLogger(os.path.dirname(out) or ".")
    bundle, report = train_policy(db, bc_cfg, log_fn=logger.log)
    save_policy(bundle, out)
    print(
        f"trained: final train {report.train_losses[-1]:.4f} "
        f"valid {report.valid_losses[-1]:.4f} -> {out}"
    )


if __name__ == "__main__":
    main()
