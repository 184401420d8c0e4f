"""Validate mass-normalized force regularization (VERDICT round-4 task 6).

Rolls out, per robot, (a) the shipped sweep-patched table (f_reg_style
"zero" + per-robot W_F scale hacks) and (b) the SAME reference-verbatim W_F
value with f_reg_style="weight" (regularize toward the weight-distributed
nominal force — gravity moves into the reference point, so one table
transfers across robots; params.py f_reg_style). Reports survival, roll
envelope, and CoM height deviation for each.

Acceptance (verdict task 6): Solo12 z within 5 mm of nominal on the weight
style; Go2 still passes its gait-quality gates.

Usage: python scripts/validate_wf_norm.py [out.json] [T_ms]
Runs on the GPU; one process per card.
"""

import dataclasses
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

from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.sim import physics, rollout
from bunmpc_tpu.utils import jsonio
from bunmpc_tpu.utils.quat import quat_to_rot, rot_to_rpy

VX = 0.3


def run_case(name, model, params, q0, sp, eff_kwargs, T, sb=None, fg=None):
    spec = KD.make_cyclic_spec(model, params, q0, **eff_kwargs)
    cfg = rollout.RolloutConfig(
        episode_length=T, kp=params.kp, kd=params.kd, gait_period=params.gait_period
    )
    s0 = physics.SimState(q=jnp.asarray(q0, jnp.float32), v=jnp.zeros(model.nv, jnp.float32))
    s0 = rollout.settle_state(model, tuple(spec.eff_frames), sp, s0, params.kp, params.kd)
    t0 = time.time()
    run = jax.jit(
        lambda s: rollout.rollout_mpc(
            spec, sp, cfg, s, jnp.asarray([VX, 0.0, 0.0], jnp.float32),
            jnp.asarray(0.0, jnp.float32),
            swing_blend=None if sb is None else jnp.asarray(sb, jnp.float32),
            force_gate=None if fg is None else jnp.asarray(fg, jnp.float32),
        )
    )
    res = jax.block_until_ready(run(s0))
    nv = model.nv
    quat = jnp.asarray(res.states[..., nv + 8 + 1 : nv + 8 + 5])
    rpy = np.asarray(rot_to_rpy(quat_to_rot(quat)))
    z = np.asarray(res.states[..., nv + 8])
    win = slice(500, T)
    out = {
        "case": name,
        "f_reg_style": params.f_reg_style,
        "W_F_xyz": np.asarray(params.W_F[:3]).tolist(),
        "failed": bool(res.failed),
        "survival_ms": int(res.fail_step) if bool(res.failed) else T,
        "roll_max_deg": float(np.rad2deg(np.abs(rpy[win, 0]).max())),
        "pitch_max_deg": float(np.rad2deg(np.abs(rpy[win, 1]).max())),
        "z_dev_end_mm": float(abs(z[-1000:].mean() - params.nom_ht) * 1000.0),
        "vx_end": float(np.asarray(res.states[-1000:, 0]).mean()),
        "seconds": round(time.time() - t0, 1),
    }
    print(name, out, flush=True)
    return out


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        root, "artifacts", "wf_normalization.json"
    )
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 3000
    results = []

    # ---- Solo12 ----
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot, trot_sim
    from bunmpc_tpu.robots.solo12 import Solo12Config as S

    s_model = S.load_model()
    s_sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    results.append(
        run_case("solo12_trot_sim_zero", s_model, trot_sim, S.q0(), s_sp, {}, T)
    )
    # weight style at the shared table value W_F=1e0: the candidate that
    # transfers across robots (first sweep: W_F=1e1 under weight anchor is
    # too stiff a force prior — plan tracks F_nom over the velocity task and
    # the closed loop overshoots; 1e0 gives the tightest Fz/mg profile)
    trot_sim_w = dataclasses.replace(
        trot, motion_name="trot_sim", kp=trot_sim.kp, kd=trot_sim.kd,
        W_F=trot.W_F * 0.1, f_reg_style="weight",
    )
    results.append(
        run_case("solo12_trot_sim_weight", s_model, trot_sim_w, S.q0(), s_sp, {}, T)
    )

    # ---- Go2 ----
    from bunmpc_tpu.mpc.motions.go2_cyclic import trot_sim as g_trot_sim
    from bunmpc_tpu.robots.go2 import Go2Config as C

    g_model = C.load_model()
    g_sp = physics.SimParams(
        contact=physics.ContactParams(
            foot_radius=C.foot_size, kn=6e4, dn=3000.0, kt=3000.0, mu=1.0
        ),
        torque_limit=23.7,
    )
    g_kwargs = dict(
        eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
        foot_size=C.foot_size,
    )
    results.append(
        run_case("go2_trot_sim_zero", g_model, g_trot_sim, C.q0(), g_sp, g_kwargs, T,
                 sb=0.5, fg=1.0)
    )
    g_trot_w = dataclasses.replace(
        g_trot_sim, W_F=np.array([1e0, 1e0, 1e0] * 4), f_reg_style="weight"
    )
    results.append(
        run_case("go2_trot_sim_weight", g_model, g_trot_w, C.q0(), g_sp, g_kwargs, T,
                 sb=0.5, fg=1.0)
    )

    doc = {
        "meta": {"vx": VX, "T_ms": T, "device": str(jax.devices()[0])},
        "results": results,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        jsonio.dump(doc, fh, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
