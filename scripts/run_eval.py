"""Evaluation-suite driver (CLI): velocity grids, cc-replanning ablation,
max-force robustness.

Twin of the reference eval scripts (behavioral_cloning_vc_evaluation_*.py,
behavioral_cloning_evaluation_effects_of_cc_replanning.py,
max_force_search.py, test_sweep_policy.py):

    python scripts/run_eval.py mode=mpc_grid  [vx=-0.3:0.5:5 w=0:0:1 ...]
    python scripts/run_eval.py mode=policy_grid policy=models/x/policy
    python scripts/run_eval.py mode=cc_replanning vc_policy=... cc_policy=...
    python scripts/run_eval.py mode=max_force
    python scripts/run_eval.py mode=past_goals n_goals=5 out=pg.csv

Results print as a summary dict and export to CSV (out=...csv), the
portable stand-in for the reference's wandb/xlsx error tables.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _parse_range(s, default):
    """"lo:hi:n" -> linspace; single number -> [x]."""
    import numpy as np

    if s is None:
        return np.asarray(default)
    if ":" in s:
        lo, hi, n = s.split(":")
        return np.linspace(float(lo), float(hi), int(n))
    return np.asarray([float(s)])


def main():
    from bunmpc_tpu.utils.runtime import setup_jax

    setup_jax()  # persistent compile cache
    import jax.numpy as jnp
    import numpy as np

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import GAITS, trot
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.sim import physics, rollout
    from bunmpc_tpu.utils.checkpoint import load_policy

    args = dict(a.split("=", 1) for a in sys.argv[1:])
    mode = args.get("mode", "mpc_grid")
    gait = GAITS.get(args.get("gait", "trot"), trot)

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, gait, Solo12Config.q0())
    sim_params = physics.SimParams(contact=physics.ContactParams(mu=1.0))
    cfg = rollout.RolloutConfig(
        episode_length=int(args.get("episode_length", 2000)),
        kp=gait.kp,
        kd=gait.kd,
        gait_period=gait.gait_period,
    )
    state0 = physics.SimState(q=jnp.asarray(Solo12Config.q0()), v=jnp.zeros(model.nv))
    vx = _parse_range(args.get("vx"), np.linspace(-0.2, 0.4, 4))
    w = _parse_range(args.get("w"), [0.0])
    out = args.get("out")

    if mode == "mpc_grid":
        from bunmpc_tpu.eval import velocity_grid

        res = velocity_grid.eval_mpc_grid(spec, sim_params, cfg, state0, vx, w_values=w)
    elif mode == "policy_grid":
        from bunmpc_tpu.eval import velocity_grid

        pol = load_policy(args["policy"])
        res = velocity_grid.eval_policy_grid(
            spec, sim_params, cfg, state0, pol, vx, w_values=w
        )
    elif mode == "cc_replanning":
        from bunmpc_tpu.eval import cc_replanning

        vc_pol = load_policy(args["vc_policy"])
        cc_pol = load_policy(args["cc_policy"])
        grid = [(x, ww) for x in vx for ww in w]
        res = cc_replanning.compare_cc_replanning(
            spec, sim_params, cfg, state0, vc_pol, cc_pol,
            v_des_batch=np.asarray([[x, 0.0, 0.0] for x, _ in grid]),
            w_des_batch=np.asarray([ww for _, ww in grid]),
            goal_horizon=int(args.get("goal_horizon", 1)),
        )
    elif mode == "past_goals":
        from bunmpc_tpu.eval.past_goals import run_past_goals_eval
        from bunmpc_tpu.learning.bc import BcConfig

        n_goals = int(args.get("n_goals", 5))
        vx_lo, vx_hi = (float(x) for x in args.get("vx_range", "0.0,0.4").split(","))
        goals = np.stack([
            np.linspace(vx_lo, vx_hi, n_goals),
            np.zeros(n_goals), np.zeros(n_goals), np.zeros(n_goals),
        ], axis=1)
        res = run_past_goals_eval(
            spec, sim_params, cfg, Solo12Config.q0(), np.zeros(18), goals,
            bc_cfg=BcConfig(n_epoch=int(args.get("bc_epochs", 50))),
        )
        print({"forgetting": res.forgetting()})
        if out:
            res.to_csv(out)
            print("wrote", out)
        return
    elif mode == "max_force":
        from bunmpc_tpu.eval import max_force

        f_max, hist = max_force.max_force_search(
            spec, sim_params, cfg, state0,
            v_des=np.asarray([float(args.get("vx_des", 0.0)), 0.0, 0.0]),
            w_des=float(args.get("w_des", 0.0)),
            f_high=float(args.get("f_high", 30.0)),
            n_bisect=int(args.get("n_bisect", 5)),
        )
        print({"f_max": f_max, "history": hist})
        return
    else:
        raise SystemExit(f"unknown mode {mode!r}")

    print(res.summary())
    if out:
        res.to_csv(out)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
