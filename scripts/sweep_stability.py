"""In-sim trot stability sweep over PD gains x ground stiffness — ONE compile.

Exploits the pytree-ness of SimParams/ContactParams/IdControllerGains: a
single vmapped rollout program evaluates every (kp, kd, kn, dn, kt) combo in
parallel on the chip (the reference would need one PyBullet process per
combo). Drives the ROADMAP gait-quality items: Solo12 roll envelope and Go2
forward-walk tuning.

Usage: python scripts/sweep_stability.py [solo12|go2] [vx] [episode_ms]
        [settle_ms] [grid] [out_json]

``grid`` selects the combo set: ``default`` (gains x contact x blend) or
``calibrate`` (REFERENCE gains pinned — solo12 kp=3/kd=0.05 from the
reference solo12_trot.py:41-42 — swept over a wide ContactParams grid; the
round-4 question "can the reference's soft PD walk on a calibrated implicit
contact model?", VERDICT round-3 task 6).

``out_json`` (default artifacts/stability_sweep_<robot>[_<grid>].json) gets
the full machine-readable result table; tests/test_gait_quality.py gates the
committed winning configs against it.

Round 3: the sweep axes include ``swing_blend`` (contact-adaptive release of
planned-swing legs that are measured grounded, rollout.py) — the round-2
diagnosis was that the ID controller pushing against grounded "swing" feet
is what ratchets/rolls the heavier Go2.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.sim import controllers, physics, rollout
from bunmpc_tpu.utils.quat import quat_to_rot, rot_to_rpy


def main():
    robot = sys.argv[1] if len(sys.argv) > 1 else "solo12"
    vx = float(sys.argv[2]) if len(sys.argv) > 2 else 0.3
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 3000
    grid = sys.argv[5] if len(sys.argv) > 5 else "default"

    # A/B knobs (env): BUNMPC_SWEEP_WS=tiled|vdes overrides the spec's ADMM
    # warm-start style; BUNMPC_SWEEP_CARRY=0|1 overrides warm_start_carry;
    # BUNMPC_SWEEP_WF=<scale> scales the motion table's W_F (the round-4
    # starved-force diagnosis: too-heavy force regularization sinks the
    # plan's equilibrium height below nominal)
    ws_style = os.environ.get("BUNMPC_SWEEP_WS") or None
    carry_env = os.environ.get("BUNMPC_SWEEP_CARRY")
    carry = None if carry_env is None else bool(int(carry_env))
    wf_scale = float(os.environ.get("BUNMPC_SWEEP_WF", "1.0"))

    if robot == "solo12":
        from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
        from bunmpc_tpu.robots.solo12 import Solo12Config as C

        if wf_scale != 1.0:
            import dataclasses as _dc

            trot = _dc.replace(trot, W_F=trot.W_F * wf_scale)
        spec = KD.make_cyclic_spec(C.load_model(), trot, C.q0(), warm_start_style=ws_style)
        base_contact = (0.018, 1.0)  # foot_radius, mu
        tq_lim = 2.7
        # round-4 grid: the round-2 winner (kp=8/kd=0.3) survives but sags
        # ~4 cm under load (z_end 0.156 vs nom 0.2) and rides roll_max ~17
        # deg; the Go2 fix was 2.4x stiffer gains — sweep the same direction
        # (the reference's soft kp=3/kd=0.05 rolls over on the implicit
        # soft ground; round-2 artifact row kept in the committed JSON)
        gains_grid = [(8.0, 0.3), (12.0, 0.5), (16.0, 0.8), (20.0, 1.0)]
        contact_grid = [(1e4, 500.0, 500.0), (2e4, 900.0, 900.0)]
        # (swing_blend, force_gate) pairs: 1.0 = reference behavior on that axis
        blend_grid = [(1.0, 1.0), (0.5, 1.0), (0.5, 0.0)]
        if grid == "calibrate":
            # REFERENCE gains (solo12_trot.py:41-42) pinned; sweep the implicit
            # contact model. Hypotheses: (a) ground too soft/bouncy (kn/dn),
            # (b) tangential creep (kt), (c) both. PyBullet's rigid contact ~
            # very stiff + strongly damped normal, sticky tangential.
            gains_grid = [(3.0, 0.05)]
            contact_grid = [
                (1e4, 500.0, 500.0),     # round-2 winner contact
                (3e4, 1500.0, 1500.0),
                (1e5, 5000.0, 5000.0),   # near-rigid, high damping
                (3e5, 15000.0, 15000.0),
                (1e5, 15000.0, 5000.0),  # overdamped normal
                (1e5, 5000.0, 20000.0),  # sticky tangential
                (3e5, 30000.0, 30000.0),
                (1e6, 60000.0, 60000.0),
            ]
            blend_grid = [(1.0, 1.0), (0.5, 0.0)]
    else:
        from bunmpc_tpu.mpc.motions.go2_cyclic import trot
        from bunmpc_tpu.robots.go2 import Go2Config as C

        spec = KD.make_cyclic_spec(
            C.load_model(), trot, C.q0(),
            eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
            foot_size=C.foot_size, warm_start_style=ws_style,
        )
        base_contact = (C.foot_size, 1.0)
        tq_lim = 23.7
        # round-4 grid around the working point (vdes warm start + W_F fix:
        # forward trot at 0.32 m/s, pitch builds to fall at 1.8 s — sweep
        # gains/contact/blend to kill the pitch ratchet)
        gains_grid = [(25.0, 1.0), (25.0, 2.0), (40.0, 2.0), (60.0, 3.0)]
        contact_grid = [(6e4, 3000.0, 3000.0), (1.2e5, 5000.0, 5000.0)]
        # (swing_blend, force_gate) pairs: 1.0 = reference behavior on that axis
        blend_grid = [(1.0, 1.0), (0.5, 1.0), (0.5, 0.0), (0.2, 1.0), (0.2, 0.0)]

    combos = [
        (kp, kd, kn, dn, kt, sb, fg)
        for kp, kd in gains_grid
        for kn, dn, kt in contact_grid
        for sb, fg in blend_grid
    ]
    B = len(combos)
    arr = lambda i: jnp.asarray([c[i] for c in combos], jnp.float32)
    gains = controllers.IdControllerGains(kp=arr(0), kd=arr(1))
    sim_params = physics.SimParams(
        contact=physics.ContactParams(
            foot_radius=jnp.full(B, base_contact[0], jnp.float32),
            kn=arr(2), dn=arr(3), kt=arr(4),
            mu=jnp.full(B, base_contact[1], jnp.float32),
        ),
        joint_damping=jnp.full(B, 0.02, jnp.float32),
        torque_limit=jnp.full(B, tq_lim, jnp.float32),
    )

    cfg = rollout.RolloutConfig(episode_length=T, gait_period=spec.params.gait_period)
    state0 = physics.SimState(
        q=jnp.asarray(C.q0(), jnp.float32), v=jnp.zeros(spec.model.nv, jnp.float32)
    )
    settle_ms = int(sys.argv[4]) if len(sys.argv) > 4 else 500
    v_des = jnp.asarray([vx, 0.0, 0.0], jnp.float32)
    w_des = jnp.asarray(0.0, jnp.float32)

    blend, fgate = arr(5), arr(6)

    def one(sp, g, sb, fg):
        # pre-settle: hold q0 joints with PD until the base rests on its feet
        # (q0 starts the feet above the ground; the drop transient otherwise
        # kicks the gait during its first diagonal-support phase)
        q0j = state0.q[7:]

        def settle_step(s, _):
            # stiff hold (6x): the gait PD is sized for ff-carried loads and
            # sags ~0.2 rad under raw gravity
            tau = -6.0 * g.kp * (s.q[7:] - q0j) - 6.0 * g.kd * s.v[6:]
            s2, _ = physics.step(spec.model, tuple(spec.eff_frames), sp, s, tau)
            return s2, None

        s0, _ = jax.lax.scan(settle_step, state0, None, length=settle_ms)
        return rollout.rollout_mpc(
            spec, sp, cfg, s0, v_des, w_des, gains=g, swing_blend=sb,
            force_gate=fg, warm_start_carry=carry,
            # warm_start_carry None: per-spec default (ON for solo12's tiled
            # basin, OFF for the Go2's vdes basin; sim/rollout.py)
        )

    run = jax.jit(jax.vmap(one))
    res = jax.block_until_ready(run(sim_params, gains, blend, fgate))

    # states layout: [v(nv), base_wrt_foot(8), q[2:]]; q[3:7] = quat
    nv = spec.model.nv
    quat = jnp.asarray(res.states[..., nv + 8 + 1 : nv + 8 + 5])
    rpy = np.asarray(rot_to_rpy(quat_to_rot(quat)))  # (B, T, 3)
    z = np.asarray(res.states[..., nv + 8])  # q[2]
    vx_act = np.asarray(res.states[..., 0])
    last = slice(T - 1000, T)

    print(f"robot={robot} vx={vx} T={T}ms grid={grid}  ({B} combos, one compile)")
    print(f"{'kp':>5} {'kd':>5} {'kn':>8} {'dn':>6} {'kt':>6} {'sb':>4} {'fg':>4} | {'fail@':>6} "
          f"{'roll_rms':>8} {'roll_max':>8} {'pit_mean':>8} {'pit_max':>8} "
          f"{'z_end':>6} {'z_min':>6} {'vx_end':>6}")
    rows = []
    # attitude/height stats over the gait window only (post-settle transient
    # excluded): the gating criteria in VERDICT round-3 task 2 are about the
    # steady gait, and the first ~0.5 s still carries the drop/settle kick
    gait_win = slice(500, T)
    for i, (kp, kd, kn, dn, kt, sb, fg) in enumerate(combos):
        failed = bool(res.failed[i])
        fs = int(res.fail_step[i]) if failed else -1
        rr = np.rad2deg(np.sqrt((rpy[i, last, 0] ** 2).mean()))
        rm = np.rad2deg(np.abs(rpy[i, gait_win, 0]).max())
        rm_all = np.rad2deg(np.abs(rpy[i, :, 0]).max())
        pm = np.rad2deg(rpy[i, gait_win, 1].mean())
        px = np.rad2deg(np.abs(rpy[i, gait_win, 1]).max())
        row = {
            "kp": kp, "kd": kd, "kn": kn, "dn": dn, "kt": kt,
            "swing_blend": sb, "force_gate": fg,
            "failed": failed, "fail_step": fs,
            "roll_rms_deg": float(rr), "roll_max_deg": float(rm),
            "roll_max_deg_incl_settle": float(rm_all),
            "pitch_mean_deg": float(pm), "pitch_max_deg": float(px),
            "z_end_m": float(z[i, last].mean()), "z_min_m": float(z[i].min()),
            "z_dev_end_m": float(abs(z[i, last].mean() - spec.params.nom_ht)),
            "vx_end": float(vx_act[i, last].mean()),
        }
        rows.append(row)
        print(
            f"{kp:5.1f} {kd:5.2f} {kn:8.0f} {dn:6.0f} {kt:6.0f} {sb:4.1f} {fg:4.1f} | "
            f"{fs:6d} {rr:8.2f} {rm:8.2f} {pm:8.2f} {px:8.2f} "
            f"{row['z_end_m']:6.3f} {row['z_min_m']:6.3f} "
            f"{row['vx_end']:6.3f}"
        )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    suffix = f"_{grid}" if grid != "default" else ""
    out = (
        sys.argv[6]
        if len(sys.argv) > 6
        else os.path.join(root, "artifacts", f"stability_sweep_{robot}{suffix}.json")
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    import json

    with open(out, "w") as f:
        json.dump(
            {
                "robot": robot, "vx": vx, "episode_ms": T, "grid": grid,
                "settle_ms": settle_ms, "nom_ht": float(spec.params.nom_ht),
                "device": str(jax.devices()[0]), "rows": rows,
            },
            f,
            indent=1,
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
