"""Contact-model calibration vs the reference closed loop (VERDICT r4 task 3).

The reference's PyBullet-validated Solo12 trot uses kp=3/kd=0.05 and the
verbatim W_F=1e1 table (reference examples/motions/cyclic/solo12_trot.py:
41-42, bullet_utils/src/bullet_utils/env.py:82-91); on the in-graph implicit
soft-contact model those gains have rolled over since round 2, and the repo
ships its own sim-validated ``trot_sim`` variant instead. This script does
the calibration the verdict asks for:

1. sweep ``ContactParams`` (kn, dn, kt, mu) with the REFERENCE gains and the
   REFERENCE trot table over a vmapped rollout batch (every grid point is one
   lane of a single device program — ContactParams is a pytree, so the sweep
   is a batched domain-randomization run, impossible in the reference's
   one-PyBullet-server-per-process design);
2. for the best row (and the shipped trot_sim baseline) record the
   quantitative closed-loop contact observables: measured contact duty factor
   vs the planned 0.6, touchdown impulse, mean/max penetration depth, roll
   envelope, CoM height deviation;
3. write artifacts/contact_calibration_solo12.json with the full grid + the
   comparison rows. PARITY.md summarizes the result; a gate in
   tests/test_gait_quality.py pins it.

Usage: python scripts/calibrate_contact.py [out.json] [T_ms]
Runs on the GPU (one compile); one process per card.
"""

import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.mpc import gait as G
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot, trot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.sim import physics, rollout
from bunmpc_tpu.utils import jsonio
from bunmpc_tpu.utils.quat import quat_to_rot, rot_to_rpy

VX = 0.3


def contact_metrics(spec, res, cfg, T):
    """Closed-loop contact observables for each batch element."""
    nv = spec.model.nv
    incnt = np.asarray(res.in_contact)  # (B, T, ne)
    forces = np.asarray(res.contact_forces)  # (B, T, ne, 3)
    cpos = np.asarray(res.contact_pos)  # (B, T, ne, 3)
    failed = np.asarray(res.failed)
    fail_step = np.where(failed, np.asarray(res.fail_step), T)
    # post-settle steady window
    w0 = 500
    B = incnt.shape[0]
    duty, imp, pen_mean, pen_max, roll_max, z_dev = [], [], [], [], [], []
    quat = np.asarray(res.states[..., nv + 8 + 1 : nv + 8 + 5])
    rpy = np.asarray(rot_to_rpy(quat_to_rot(jnp.asarray(quat))))
    z = np.asarray(res.states[..., nv + 8])
    foot_r = 0.018
    for b in range(B):
        Tb = int(fail_step[b])
        w = slice(w0, max(Tb, w0 + 1))
        duty.append(float(incnt[b, w].mean()))
        # touchdown impulse: peak normal force at 0->1 contact transitions
        trans = (incnt[b, 1:] > incnt[b, :-1]) & (np.arange(1, incnt.shape[1])[:, None] < Tb)
        fz = forces[b, 1:, :, 2]
        imp.append(float(fz[trans].max()) if trans.any() else 0.0)
        pen = np.clip(foot_r - cpos[b, w, :, 2], 0.0, None)
        pen_in = pen[incnt[b, w]]
        pen_mean.append(float(pen_in.mean()) if pen_in.size else 0.0)
        pen_max.append(float(pen.max()) if pen.size else 0.0)
        roll_max.append(float(np.rad2deg(np.abs(rpy[b, w, 0]).max())))
        z_dev.append(float(np.abs(z[b, max(Tb - 1000, w0):Tb].mean() - spec.params.nom_ht))
                     if Tb > w0 else float("nan"))
    return {
        "failed": failed.tolist(),
        "survival_ms": fail_step.tolist(),
        "duty_factor": duty,
        "touchdown_peak_fz": imp,
        "penetration_mean": pen_mean,
        "penetration_max": pen_max,
        "roll_max_deg": roll_max,
        "z_dev_end": z_dev,
    }


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        root, "artifacts", "contact_calibration_solo12.json"
    )
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 3000

    model = Solo12Config.load_model()
    q0 = Solo12Config.q0()
    spec_ref = KD.make_cyclic_spec(model, trot, q0)  # verbatim reference table
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot.kp, kd=trot.kd,
                                gait_period=trot.gait_period)

    # --- grid over ContactParams with reference gains ---
    kns = [2e3, 4e3, 1e4, 3e4]
    dns = [50.0, 150.0, 500.0]
    kts = [150.0, 500.0, 1500.0]
    grid = list(itertools.product(kns, dns, kts))
    B = len(grid)
    cps = physics.ContactParams(
        foot_radius=jnp.full(B, 0.018, jnp.float32),
        kn=jnp.asarray([g[0] for g in grid], jnp.float32),
        dn=jnp.asarray([g[1] for g in grid], jnp.float32),
        mu=jnp.full(B, 1.0, jnp.float32),
        kt=jnp.asarray([g[2] for g in grid], jnp.float32),
    )
    sps = physics.SimParams(contact=cps)

    def one(cp, s0):
        sp1 = physics.SimParams(contact=cp)
        return rollout.rollout_mpc(
            spec_ref, sp1, cfg, s0,
            jnp.asarray([VX, 0.0, 0.0], jnp.float32), jnp.asarray(0.0, jnp.float32),
        )

    # settle per-lane under its own contact params (reference robots spawn
    # settled; the drop transient must not decide the sweep)
    def settle_one(cp):
        sp1 = physics.SimParams(contact=cp)
        s0 = physics.SimState(q=jnp.asarray(q0, jnp.float32),
                              v=jnp.zeros(model.nv, jnp.float32))
        return rollout.settle_state(model, tuple(spec_ref.eff_frames), sp1, s0,
                                    trot.kp, trot.kd, ms=500)

    print(f"sweep: {B} contact-param rows, reference gains kp={trot.kp}/kd={trot.kd}",
          flush=True)
    t0 = time.time()
    run = jax.jit(jax.vmap(lambda cp: one(cp, settle_one(cp))))
    res = jax.block_until_ready(run(cps))
    sweep_s = time.time() - t0
    met = contact_metrics(spec_ref, res, cfg, T)
    rows = []
    for i, (kn, dn, kt) in enumerate(grid):
        rows.append({
            "kn": kn, "dn": dn, "kt": kt,
            **{k: met[k][i] for k in met},
        })
    # rank: survive, then roll envelope, then z deviation
    def score(r):
        return (
            0 if not r["failed"] else 1,
            -r["survival_ms"],
            r["roll_max_deg"] if np.isfinite(r["roll_max_deg"]) else 1e9,
        )
    rows_sorted = sorted(rows, key=score)
    best = rows_sorted[0]
    print("best row:", best, flush=True)

    # --- baseline: shipped trot_sim config for the same observables ---
    spec_sim = KD.make_cyclic_spec(model, trot_sim, q0)
    cfg_sim = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
    sp_sim = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    s0 = physics.SimState(q=jnp.asarray(q0, jnp.float32), v=jnp.zeros(model.nv, jnp.float32))
    s0 = rollout.settle_state(model, tuple(spec_sim.eff_frames), sp_sim, s0,
                              trot_sim.kp, trot_sim.kd, ms=500)
    run_sim = jax.jit(lambda s: rollout.rollout_mpc(
        spec_sim, sp_sim, cfg_sim, s,
        jnp.asarray([VX, 0.0, 0.0], jnp.float32), jnp.asarray(0.0, jnp.float32)))
    res_sim = jax.block_until_ready(run_sim(s0))
    met_sim = contact_metrics(
        spec_sim, jax.tree_util.tree_map(lambda a: a[None] if hasattr(a, "ndim") else a,
                                         res_sim),
        cfg_sim, T,
    )
    baseline = {k: v[0] for k, v in met_sim.items()}
    print("trot_sim baseline:", baseline, flush=True)

    artifact = {
        "meta": {
            "robot": "solo12", "vx": VX, "T_ms": T,
            "reference_gains": {"kp": trot.kp, "kd": trot.kd},
            "reference_table": "trot (verbatim, W_F=1e1)",
            "grid": {"kn": kns, "dn": dns, "kt": kts, "mu": 1.0},
            "planned_duty_factor": float(np.mean(trot.stance_percent)),
            "device": str(jax.devices()[0]),
            "sweep_seconds": round(sweep_s, 1),
        },
        "best": best,
        "grid_rows": rows,
        "trot_sim_baseline": {
            "kp": trot_sim.kp, "kd": trot_sim.kd,
            "contact": {"kn": 1e4, "dn": 500.0, "kt": 500.0},
            **baseline,
        },
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        jsonio.dump(artifact, fh, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
