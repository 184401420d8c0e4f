"""Hyperparameter grid sweep over BC training.

Twin of the reference's wandb sweep (reference sweep_policy.py:32-439 +
cfgs/sweep_config_wandb.yaml:10-20: grid over lr / batch / epochs / layers /
width). Runs the grid locally (sequentially per config — each config already
uses the whole device via the sharded train step) and reports the best
validation loss.

    python scripts/run_sweep.py database=path.hdf5 [out=sweep_results.json]
"""

import itertools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# reference sweep space (cfgs/sweep_config_wandb.yaml:10-20)
SPACE = {
    "learning_rate": [1e-3, 2e-3, 5e-3],
    "batch_size": [128, 256],
    "num_hidden_layer": [3, 4],
    "hidden_dim": [256, 512],
}


def main():
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()  # persistent compile cache
    from bunmpc_tpu.learning.bc import BcConfig, train_policy
    from bunmpc_tpu.learning.database import Database

    args = dict(a.split("=", 1) for a in sys.argv[1:])
    db_path = args.get("database")
    if db_path is None:
        raise SystemExit("usage: run_sweep.py database=path.hdf5 [out=...] [epochs=N]")
    epochs = int(args.get("epochs", 30))

    db = Database(2_000_000, goal_type=args.get("goal_type", "cc"))
    db.load_saved_database(db_path)
    print(f"database: {len(db)} samples")

    results = []
    keys = list(SPACE)
    for combo in itertools.product(*SPACE.values()):
        params = dict(zip(keys, combo))
        cfg = BcConfig(n_epoch=epochs, **params)
        _, report = train_policy(db, cfg, rng_seed=0)
        rec = {**params, "valid_loss": report.valid_losses[-1],
               "train_loss": report.train_losses[-1]}
        results.append(rec)
        print(rec)

    best = min(results, key=lambda r: r["valid_loss"])
    out = args.get("out", "sweep_results.json")
    with open(out, "w") as fh:
        json.dump({"results": results, "best": best}, fh, indent=2)
    print(f"best: {best} -> {out}")


if __name__ == "__main__":
    main()
