"""Gait-quality diagnostics: in-sim MPC rollout attitude/height/contact-timing
report for Solo12 or Go2 trot.

Usage: python scripts/diagnose_gait.py [solo12|go2] [vx] [episode_ms] [out_prefix]
        [kp] [kd] [nom_ht] [swing_blend] [kn] [carry] [force_gate] [settle_ms]

Prints per-second attitude envelopes, z-height drift, contact-timing lead/lag
vs the gait plan, and velocity tracking — the observables behind the ROADMAP
items "Solo12 roll-oscillation polish" and "Go2 forward-walk tuning".
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
from bunmpc_tpu.sim import physics, rollout
from bunmpc_tpu.utils.quat import quat_to_rot, rot_to_rpy


def build(robot):
    if robot == "solo12":
        from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
        from bunmpc_tpu.robots.solo12 import Solo12Config as C

        spec = KD.make_cyclic_spec(C.load_model(), trot, C.q0())
        sp = physics.SimParams(contact=physics.ContactParams(mu=1.0))
    else:
        from bunmpc_tpu.mpc.motions.go2_cyclic import trot
        from bunmpc_tpu.robots.go2 import Go2Config as C

        spec = KD.make_cyclic_spec(
            C.load_model(), trot, C.q0(),
            eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
            foot_size=C.foot_size,
        )
        sp = physics.SimParams(
            contact=physics.ContactParams(
                foot_radius=C.foot_size, kn=2.4e4, dn=1800.0, kt=1800.0, mu=1.0
            ),
            torque_limit=23.7,
        )
    return spec, sp, C, trot


def main():
    robot = sys.argv[1] if len(sys.argv) > 1 else "solo12"
    vx = float(sys.argv[2]) if len(sys.argv) > 2 else 0.3
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 3000
    out = sys.argv[4] if len(sys.argv) > 4 else f"/tmp/diag_{robot}"
    kp = float(sys.argv[5]) if len(sys.argv) > 5 else None
    kd = float(sys.argv[6]) if len(sys.argv) > 6 else None
    nom_ht = float(sys.argv[7]) if len(sys.argv) > 7 else None
    swing_blend = float(sys.argv[8]) if len(sys.argv) > 8 else None
    kn = float(sys.argv[9]) if len(sys.argv) > 9 else None
    carry = bool(int(sys.argv[10])) if len(sys.argv) > 10 else True
    force_gate = float(sys.argv[11]) if len(sys.argv) > 11 else None
    settle_ms = int(sys.argv[12]) if len(sys.argv) > 12 else 0

    spec, sim_params, C, trot = build(robot)
    if kn is not None:
        import dataclasses as _dc

        sim_params = _dc.replace(
            sim_params,
            contact=_dc.replace(sim_params.contact, kn=kn, dn=kn / 20.0, kt=kn / 20.0),
        )
    if nom_ht is not None:
        import dataclasses as _dc

        trot = _dc.replace(trot, nom_ht=nom_ht)
        spec = _dc.replace(spec, params=trot)
    cfg = rollout.RolloutConfig(
        episode_length=T,
        kp=kp if kp is not None else trot.kp,
        kd=kd if kd is not None else trot.kd,
        gait_period=trot.gait_period,
    )
    if kp is not None or kd is not None:
        import dataclasses as _dc

        spec = _dc.replace(
            spec,
            params=_dc.replace(spec.params, kp=cfg.kp, kd=cfg.kd),
        )
    print(f"config: kp={spec.params.kp} kd={spec.params.kd} nom_ht={spec.params.nom_ht}")
    state0 = physics.SimState(q=jnp.asarray(C.q0()), v=jnp.zeros(18))
    if settle_ms:
        # pre-settle: hold q0 joints with PD until the base rests on its feet
        # (q0 starts the feet above the ground; the drop transient otherwise
        # kicks the gait during its first diagonal-support phase)
        q0j = state0.q[7:]
        # stiff hold: the gait PD is sized for feed-forward-carried loads and
        # sags ~0.2 rad under raw gravity (Go2 sank 8 cm at kp=25)
        kp_s, kd_s = 6.0 * spec.params.kp, 6.0 * spec.params.kd

        def settle_step(s, _):
            tau = -kp_s * (s.q[7:] - q0j) - kd_s * s.v[6:]
            s2, _ = physics.step(spec.model, tuple(spec.eff_frames), sim_params, s, tau)
            return s2, None

        state0, _ = jax.lax.scan(settle_step, state0, None, length=settle_ms)
        print(f"settled {settle_ms} ms: z={float(state0.q[2]):.4f} "
              f"|v|={float(jnp.abs(state0.v).max()):.4f}")
    run = jax.jit(
        lambda s, vd, wd: rollout.rollout_mpc(
            spec, sim_params, cfg, s, vd, wd, swing_blend=swing_blend,
            warm_start_carry=carry, force_gate=force_gate,
        )
    )
    res = jax.block_until_ready(
        run(state0, jnp.asarray([vx, 0.0, 0.0], jnp.float32), jnp.asarray(0.0, jnp.float32))
    )

    qs = np.concatenate(
        [np.asarray(res.base[:, :2]), np.asarray(res.states[:, 26:43])], -1
    )
    rpy = np.asarray(rot_to_rpy(quat_to_rot(jnp.asarray(qs[:, 3:7]))))
    z = qs[:, 2]
    vx_act = np.asarray(res.states[:, 0])
    incnt = np.asarray(res.in_contact)

    print(f"robot={robot} vx={vx} T={T}ms failed={bool(res.failed)} fail_step={int(res.fail_step)}")
    for s in range(T // 500):
        sl = slice(s * 500, (s + 1) * 500)
        print(
            f"  t={s*0.5:.1f}s: roll[deg] rms={np.rad2deg(np.sqrt((rpy[sl,0]**2).mean())):6.2f} "
            f"max={np.rad2deg(np.abs(rpy[sl,0]).max()):6.2f} | "
            f"pitch mean={np.rad2deg(rpy[sl,1].mean()):+6.2f} "
            f"max={np.rad2deg(np.abs(rpy[sl,1]).max()):6.2f} | "
            f"z mean={z[sl].mean():.3f} drift={z[sl][-1]-z[sl][0]:+.3f} | "
            f"vx mean={vx_act[sl].mean():.3f}"
        )

    # contact-timing: planned stance fraction vs measured, per foot
    from bunmpc_tpu.mpc import gait as G

    ts = jnp.arange(T) * cfg.sim_dt
    planned = np.asarray(jax.vmap(lambda t: G.in_stance(spec.gait, t))(ts))
    meas = incnt > 0
    print("  contact duty (planned vs measured) and phase lead/lag per foot:")
    for j, name in enumerate(["FL", "FR", "HL", "HR"]):
        # cross-correlate stance signals to estimate timing offset
        p = planned[:, j].astype(float) - planned[:, j].mean()
        m = meas[:, j].astype(float) - meas[:, j].mean()
        lags = np.arange(-100, 101)
        xc = [np.dot(p[max(0, -l) : T - max(0, l)], m[max(0, l) : T - max(0, -l)]) for l in lags]
        best = lags[int(np.argmax(xc))]
        print(
            f"    {name}: duty plan={planned[:, j].mean():.2f} meas={meas[:, j].mean():.2f} "
            f"touchdown offset={best:+d} ms (>0: measured late)"
        )

    from bunmpc_tpu.eval import visualize as V

    V.rollout_strip(res, out + "_strip.png", title=f"{robot} trot vx={vx}")
    model = C.load_model()
    V.render_rollout_video(model, res, out + ".gif", stride=20)
    print(f"  wrote {out}_strip.png, {out}.gif")


if __name__ == "__main__":
    main()
