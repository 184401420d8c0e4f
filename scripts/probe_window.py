"""Per-millisecond probe of MPC windows from a settled stand.

Prints, for each ms of the first few 50 ms windows: desired foot z (FK of the
interpolated IK state) vs measured foot z, planned stance flags, per-foot
normal force vs feed-forward, and base z desired/actual. This pins down WHY
the in-sim trot loses contact duty (ROADMAP gait-quality item).

Usage: python scripts/probe_window.py [vx] [n_windows] [settle_ms]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

from bunmpc_tpu.kin import algorithms as K
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.sim import controllers, physics


def main():
    vx = float(sys.argv[1]) if len(sys.argv) > 1 else 0.0
    n_win = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    settle = int(sys.argv[3]) if len(sys.argv) > 3 else 500

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    eff = spec.eff_frames
    sp = physics.SimParams()
    gains = controllers.IdControllerGains(kp=trot.kp, kd=trot.kd)
    m = model.total_mass

    solve = jax.jit(
        lambda q, v, t: KD.solve_mpc(
            spec, q, v, t, jnp.asarray([vx, 0.0, 0.0], jnp.float32),
            jnp.asarray(0.0, jnp.float32),
        )
    )

    @jax.jit
    def stand_step(st):
        f_ff = jnp.tile(jnp.asarray([0.0, 0.0, m * 9.81 / 4], jnp.float32), 4)
        q0 = jnp.asarray(Solo12Config.q0(), jnp.float32)
        tau_ff, tau_fb = controllers.id_joint_torques(
            model, eff, gains, st.q, st.v, q0, jnp.zeros(18), jnp.zeros(18), f_ff
        )
        ns, _ = physics.step(model, eff, sp, st, tau_ff + tau_fb)
        return ns

    @jax.jit
    def ctrl_step(st, q_des, v_des_t, a_des, f_ff):
        tau_ff, tau_fb = controllers.id_joint_torques(
            model, eff, gains, st.q, st.v, q_des, v_des_t, a_des, f_ff
        )
        ns, ci = physics.step(model, eff, sp, st, tau_ff + tau_fb)
        return ns, ci

    @jax.jit
    def foot_z(q):
        return K.frame_positions(model, q, eff)[:, 2]

    st = physics.SimState(
        q=jnp.asarray(Solo12Config.q0(), jnp.float32), v=jnp.zeros(18, jnp.float32)
    )
    for _ in range(settle):
        st = stand_step(st)
    print(f"settled: z={float(st.q[2]):.4f} feet z={np.round(np.asarray(foot_z(st.q)),4)}")

    for w in range(n_win):
        sim_t = jnp.round(jnp.asarray(w * 0.05, jnp.float32), 3)
        plan = solve(st.q, st.v, sim_t)
        cnt = np.asarray(plan.cnt_plan)[:3, :, 0]
        print(f"\n== window {w} t={w*0.05:.2f}s cnt[0..2]={cnt.astype(int).tolist()}")
        print(f"{'i':>3} {'zb':>6} {'zb_des':>6} | fz_des (4) | fz_meas (4) | z_des (4) | z_meas (4)")
        xs = np.asarray(plan.xs_int)
        us = np.asarray(plan.us_int)
        fi = np.asarray(plan.f_int)
        for i in range(50):
            q_des = jnp.asarray(xs[i, : model.nq])
            zd = np.asarray(foot_z(q_des))
            zm = np.asarray(foot_z(st.q))
            if i % 5 == 0:
                print(
                    f"{i:>3} {float(st.q[2]):6.3f} {xs[i,2]:6.3f} | "
                    + " ".join(f"{fi[i,3*j+2]:5.1f}" for j in range(4)) + " | "
                    + " ".join(f"{float(fzm):5.1f}" for fzm in np.asarray(ci.forces[:,2]) ) + " | "
                    + " ".join(f"{z:5.3f}" for z in zd) + " | "
                    + " ".join(f"{z:5.3f}" for z in zm)
                    if i > 0 or w > 0
                    else f"{i:>3} {float(st.q[2]):6.3f} {xs[i,2]:6.3f} | "
                    + " ".join(f"{fi[i,3*j+2]:5.1f}" for j in range(4)) + " |  (first)  | "
                    + " ".join(f"{z:5.3f}" for z in zd) + " | "
                    + " ".join(f"{z:5.3f}" for z in zm)
                )
            st, ci = ctrl_step(
                st, q_des, jnp.asarray(xs[i, model.nq:]), jnp.asarray(us[i]), jnp.asarray(fi[i])
            )


if __name__ == "__main__":
    main()
