"""Round-5 diagnostic: why do the learning-loop expert rollouts fail so often?

VERDICT round-4 task 2: the committed learning demo records failed_frac
0.78-0.94 — the gated (MPC-safety-net) rollouts fall over on most episodes,
so the database is dominated by near-failure data. This probe isolates the
three candidate causes:

  A. expert fragility: vmapped rollout_mpc from contact-conditioned perturbed
     starts ON the nominal trajectory (the reference's scheme,
     safedagger_modified.py:744-815) at the reference's per-gait sigma
     (cfgs/safedagger_modified_config.yaml: trot pos 0.1 / ori 0.7 /
     joint 0.2 / vel 0.2), vs the smaller sigmas the demo used;
  B. command-envelope fragility: rollout_mpc from the settled standing start
     over the demo's full (vx, vy, w) sampling envelope vs the reference's
     vx in [0, 0.3] only;
  C. safety-net efficacy: rollout_safedagger with a deliberately bad (stand
     still) policy from perturbed starts — with the reference's
     num_steps_to_block=2000 (4 gait cycles) vs the demo's 150.

Usage: python scripts/probe_expert_robustness.py [out.json]
"""

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

from bunmpc_tpu.learning import perturbations
from bunmpc_tpu.mpc import gait as G
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.sim import physics, rollout

EP_MS = 2000
# reference per-gait trot sigmas (cfgs/safedagger_modified_config.yaml:20-45)
REF_SIG = dict(sigma_base_pos=0.1, sigma_base_ori=0.7, sigma_joint_pos=0.2, sigma_vel=0.2)
# what the round-4 demo effectively used (perturbations.sample_perturbed_state defaults)
DEMO_SIG = dict(sigma_base_pos=0.1, sigma_base_ori=0.3, sigma_joint_pos=0.2, sigma_vel=0.1)


def settle(model, eff, sp, state0, kp, kd, ms=500):
    q0j = state0.q[7:]

    def step(s, _):
        tau = -6.0 * kp * (s.q[7:] - q0j) - 6.0 * kd * s.v[6:]
        s2, _ = physics.step(model, eff, sp, s, tau)
        return s2, None

    s, _ = jax.lax.scan(step, state0, None, length=ms)
    return s


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/probe_expert.json"
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    eff = tuple(spec.eff_frames)
    cfg = rollout.RolloutConfig(
        episode_length=EP_MS, kp=trot_sim.kp, kd=trot_sim.kd,
        gait_period=trot_sim.gait_period,
    )
    s0 = physics.SimState(
        q=jnp.asarray(Solo12Config.q0(), jnp.float32), v=jnp.zeros(model.nv, jnp.float32)
    )
    s0 = settle(model, eff, sp, s0, trot_sim.kp, trot_sim.kd)
    report = {}

    # ---- benchmark nominal rollout @ 0.3 m/s ----
    run1 = jax.jit(
        lambda s, vd, wd, st: rollout.rollout_mpc(spec, sp, cfg, s, vd, wd, start_time=st)
    )
    t0 = time.time()
    bench = jax.block_until_ready(
        run1(s0, jnp.asarray([0.3, 0.0, 0.0], jnp.float32), jnp.asarray(0.0), jnp.asarray(0.0))
    )
    report["bench"] = {
        "failed": bool(bench.failed), "fail_step": int(bench.fail_step),
        "seconds": round(time.time() - t0, 1),
    }
    print("bench:", report["bench"], flush=True)

    # (q, v) at the replan points of the first gait cycle, from logged features
    n_replan = int(round(trot_sim.gait_period / cfg.plan_freq))
    spp = cfg.steps_per_plan
    feats = np.asarray(bench.states)
    qs, vs = [], []
    for r in range(n_replan):
        f = feats[r * spp]
        vs.append(f[:18])
        qs.append(np.concatenate([[0.0, 0.0], f[26:]]))
    ts = np.arange(n_replan) * cfg.plan_freq
    cnt_flags = np.asarray(jax.vmap(lambda t: G.in_stance(spec.gait, t))(jnp.asarray(ts)))

    def perturbed_batch(key, n_per, sig):
        qb, vb, st = [], [], []
        keys = jax.random.split(key, n_replan * n_per)
        k = 0
        for r in range(n_replan):
            for _ in range(n_per):
                q0p, v0p, ok = perturbations.sample_perturbed_state(
                    model, eff, keys[k],
                    jnp.asarray(qs[r], jnp.float32), jnp.asarray(vs[r], jnp.float32),
                    jnp.asarray(cnt_flags[r], jnp.float32), **sig,
                )
                qb.append(np.asarray(q0p)); vb.append(np.asarray(v0p)); st.append(ts[r])
                k += 1
        return (
            jnp.asarray(np.stack(qb), jnp.float32), jnp.asarray(np.stack(vb), jnp.float32),
            jnp.asarray(np.asarray(st), jnp.float32),
        )

    vrun = jax.jit(
        jax.vmap(
            lambda q, v, vd, wd, st: rollout.rollout_mpc(
                spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, start_time=st
            )
        )
    )

    # ---- A: expert from perturbed on-trajectory starts ----
    for name, sig in [("demo_sigma", DEMO_SIG), ("ref_sigma", REF_SIG)]:
        key = jax.random.PRNGKey(hash(name) & 0x7FFFFFFF)
        qb, vb, st = perturbed_batch(key, 8, sig)
        B = qb.shape[0]
        vd = jnp.tile(jnp.asarray([0.3, 0.0, 0.0], jnp.float32), (B, 1))
        wd = jnp.zeros(B, jnp.float32)
        t0 = time.time()
        res = jax.block_until_ready(vrun(qb, vb, vd, wd, st))
        fail = np.asarray(res.failed)
        fs = np.where(fail, np.asarray(res.fail_step), EP_MS)
        report[f"expert_perturbed_{name}"] = {
            "B": B, "failed_frac": float(fail.mean()),
            "mean_survival_ms": float(fs.mean()), "seconds": round(time.time() - t0, 1),
        }
        print(name, report[f"expert_perturbed_{name}"], flush=True)

    # ---- B: expert over command envelopes from the settled standing start ----
    rng = np.random.default_rng(0)
    for name, vxr, vyr, wr in [
        ("ref_envelope", (0.0, 0.3), (0.0, 0.0), (0.0, 0.0)),
        ("demo_envelope", (-0.2, 0.4), (-0.1, 0.1), (-0.2, 0.2)),
    ]:
        B = 32
        vd = np.zeros((B, 3), np.float32)
        vd[:, 0] = rng.uniform(*vxr, B)
        vd[:, 1] = rng.uniform(*vyr, B)
        wd = rng.uniform(*wr, B).astype(np.float32)
        qb = jnp.tile(s0.q[None], (B, 1))
        vb = jnp.tile(s0.v[None], (B, 1))
        t0 = time.time()
        res = jax.block_until_ready(
            vrun(qb, vb, jnp.asarray(vd), jnp.asarray(wd), jnp.zeros(B, jnp.float32))
        )
        fail = np.asarray(res.failed)
        fs = np.where(fail, np.asarray(res.fail_step), EP_MS)
        report[f"expert_commands_{name}"] = {
            "B": B, "failed_frac": float(fail.mean()),
            "mean_survival_ms": float(fs.mean()), "seconds": round(time.time() - t0, 1),
        }
        print(name, report[f"expert_commands_{name}"], flush=True)

    # ---- C: safety-net rescue with a stand-still policy ----
    q0j = s0.q[7:]

    def bad_policy(feat, goal):
        return jnp.tile(q0j, 1)  # pd_target toward the standing pose

    for block in (150, 2000):
        grun = jax.jit(
            jax.vmap(
                lambda q, v, vd, wd, st: rollout.rollout_safedagger(
                    spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd,
                    bad_policy, num_steps_to_block=block, start_time=st,
                )
            )
        )
        key = jax.random.PRNGKey(123)
        qb, vb, st = perturbed_batch(key, 4, REF_SIG)
        B = qb.shape[0]
        vd = jnp.tile(jnp.asarray([0.3, 0.0, 0.0], jnp.float32), (B, 1))
        wd = jnp.zeros(B, jnp.float32)
        t0 = time.time()
        res = jax.block_until_ready(grun(qb, vb, vd, wd, st))
        fail = np.asarray(res.failed)
        fs = np.where(fail, np.asarray(res.fail_step), EP_MS)
        report[f"safety_net_block{block}"] = {
            "B": B, "failed_frac": float(fail.mean()),
            "mean_survival_ms": float(fs.mean()),
            "mpc_usage": float(np.asarray(res.mpc_usage).mean()),
            "seconds": round(time.time() - t0, 1),
        }
        print(f"block={block}", report[f"safety_net_block{block}"], flush=True)

    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
