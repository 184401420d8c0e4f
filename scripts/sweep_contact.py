"""Closed-loop contact/gain parameter sweep for in-sim trot quality.

The ROADMAP gait-quality items (Solo12 z-ratchet at vx=0.3, Go2 forward trot)
come down to contact timing: late touchdowns create contact-force deficits vs
the MPC feed-forward and the base sinks between replans. This script vmaps the
FULL closed-loop rollout (MPC in the loop) over a batch of
(kn, dn, kt, kp, kd) combinations — one compile, all combos in parallel on
the chip — and reports survival, z drift, attitude and contact duty per combo.

Usage: python scripts/sweep_contact.py [solo12|go2] [vx] [T_ms]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

from bunmpc_tpu.mpc import gait as G
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.sim import controllers, physics
from bunmpc_tpu.utils.quat import quat_to_rot, rot_to_rpy


def main():
    robot = sys.argv[1] if len(sys.argv) > 1 else "solo12"
    vx = float(sys.argv[2]) if len(sys.argv) > 2 else 0.3
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 2000

    if robot == "solo12":
        from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
        from bunmpc_tpu.robots.solo12 import Solo12Config as C

        spec = KD.make_cyclic_spec(C.load_model(), trot, C.q0())
        foot_radius, torque_limit = 0.018, 2.5
        #            kn     dn     kt     kp    kd
        combos = [
            (4e3,   300.0,  300.0, 3.0, 0.05),  # current defaults
            (1e4,   600.0,  600.0, 3.0, 0.05),
            (2e4,  1000.0, 1000.0, 3.0, 0.05),
            (4e4,  2000.0, 2000.0, 3.0, 0.05),
            (4e3,   300.0, 1500.0, 3.0, 0.05),  # tangential stick only
            (4e3,  1500.0,  300.0, 3.0, 0.05),  # touchdown damping only
            (2e4,  1000.0, 1000.0, 8.0, 0.20),  # stiff ground + firmer PD
            (4e3,   300.0,  300.0, 8.0, 0.20),  # firmer PD only
        ]
    else:
        from bunmpc_tpu.mpc.motions.go2_cyclic import trot
        from bunmpc_tpu.robots.go2 import Go2Config as C

        spec = KD.make_cyclic_spec(
            C.load_model(), trot, C.q0(),
            eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
            foot_size=C.foot_size,
        )
        foot_radius, torque_limit = C.foot_size, 23.7
        combos = [
            (2.4e4, 1800.0, 1800.0, 25.0, 1.0),  # current defaults
            (6e4,   3000.0, 3000.0, 25.0, 1.0),
            (1.2e5, 5000.0, 5000.0, 25.0, 1.0),
            (2.4e4, 1800.0, 5000.0, 25.0, 1.0),
            (6e4,   3000.0, 3000.0, 40.0, 2.0),
            (2.4e4, 1800.0, 1800.0, 40.0, 2.0),
            (6e4,   3000.0, 3000.0, 15.0, 0.5),
            (2.4e4, 5000.0, 1800.0, 25.0, 1.0),
        ]

    model = spec.model
    eff = spec.eff_frames
    theta = jnp.asarray(combos, jnp.float32)
    n_windows = T // 50
    q0 = jnp.asarray(C.q0(), jnp.float32)
    v_des = jnp.asarray([vx, 0.0, 0.0], jnp.float32)
    w_des = jnp.asarray(0.0, jnp.float32)

    def run_one(th):
        cp = physics.ContactParams(
            foot_radius=foot_radius, kn=th[0], dn=th[1], kt=th[2], mu=1.0
        )
        sp = physics.SimParams(contact=cp, torque_limit=torque_limit)
        gains = controllers.IdControllerGains(kp=th[3], kd=th[4])
        state0 = physics.SimState(q=q0, v=jnp.zeros(18, jnp.float32))

        def window(state, w):
            sim_t = jnp.round(w.astype(jnp.float32) * 0.05, 3)
            plan = KD.solve_mpc(spec, state.q, state.v, sim_t, v_des, w_des)

            def sub(st, i):
                q_des = plan.xs_int[i, : model.nq]
                v_des_t = plan.xs_int[i, model.nq :]
                tau_ff, tau_fb = controllers.id_joint_torques(
                    model, eff, gains, st.q, st.v, q_des, v_des_t,
                    plan.us_int[i], plan.f_int[i],
                )
                ns, ci = physics.step(model, eff, sp, st, tau_ff + tau_fb)
                rpy = rot_to_rpy(quat_to_rot(st.q[3:7]))
                return ns, (st.q[2], rpy, st.v[0], ci.in_contact)

            state, outs = jax.lax.scan(sub, state, jnp.arange(50))
            return state, outs

        _, outs = jax.lax.scan(window, state0, jnp.arange(n_windows))
        z, rpy, vxs, incnt = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), outs
        )
        return z, rpy, vxs, incnt

    z, rpy, vxs, incnt = jax.block_until_ready(
        jax.jit(jax.vmap(run_one))(theta)
    )
    z = np.asarray(z); rpy = np.asarray(rpy); vxs = np.asarray(vxs)
    incnt = np.asarray(incnt)

    ts = jnp.arange(T) * 0.001
    planned = np.asarray(jax.vmap(lambda t: G.in_stance(spec.gait, t))(ts))
    half = T // 2
    print(f"robot={robot} vx={vx} T={T}ms  (metrics over the 2nd half)")
    print(f"{'kn':>7} {'dn':>6} {'kt':>6} {'kp':>5} {'kd':>5} | "
          f"{'z_mean':>6} {'z_min':>6} {'roll':>5} {'pitch':>6} {'vx':>5} "
          f"{'dutyF':>5} {'dutyH':>5} {'alive':>5}")
    for b, th in enumerate(combos):
        zb = z[b, half:]
        alive = bool((z[b] > 0.66 * spec.params.nom_ht).all())
        duty = incnt[b, half:].mean(axis=0)
        print(
            f"{th[0]:7.0f} {th[1]:6.0f} {th[2]:6.0f} {th[3]:5.1f} {th[4]:5.2f} | "
            f"{zb.mean():6.3f} {zb.min():6.3f} "
            f"{np.rad2deg(np.abs(rpy[b, half:, 0]).max()):5.1f} "
            f"{np.rad2deg(np.abs(rpy[b, half:, 1]).max()):6.1f} "
            f"{vxs[b, half:].mean():5.2f} "
            f"{duty[:2].mean():5.2f} {duty[2:].mean():5.2f} {str(alive):>5}"
        )
    print(f"planned duty={planned.mean():.2f}  nom_ht={spec.params.nom_ht}")


if __name__ == "__main__":
    main()
