"""Host-loop MPC rollout with full per-step instrumentation.

Unlike the fused `rollout_mpc` scan, this steps windows on the host and
records q vs q_des, per-foot normal forces, torques and velocities — for
debugging in-sim tracking quality (ROADMAP: trot collapse diagnosis).

Usage: python scripts/debug_tracking.py [vx] [T_ms] [kp] [kd]
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
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu.robots.solo12 import Solo12Config
from bunmpc_tpu.sim import controllers, physics


def main():
    vx = float(sys.argv[1]) if len(sys.argv) > 1 else 0.0
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    kp = float(sys.argv[3]) if len(sys.argv) > 3 else trot.kp
    kd = float(sys.argv[4]) if len(sys.argv) > 4 else trot.kd
    kn = float(sys.argv[5]) if len(sys.argv) > 5 else 4e3
    dn = float(sys.argv[6]) if len(sys.argv) > 6 else 300.0

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    sim_params = physics.SimParams(
        contact=physics.ContactParams(mu=1.0, kn=kn, dn=dn, kt=dn)
    )
    gains = controllers.IdControllerGains(kp=kp, kd=kd)
    eff = spec.eff_frames

    solve = jax.jit(
        lambda q, v, t: KD.solve_mpc(
            spec, q, v, t, jnp.asarray([vx, 0.0, 0.0], jnp.float32), jnp.asarray(0.0, jnp.float32)
        )
    )

    @jax.jit
    def substep(state, q_des, v_des_t, a_des, f_ff):
        q, v = state
        tau_ff, tau_fb = controllers.id_joint_torques(
            model, eff, gains, q, v, q_des, v_des_t, a_des, f_ff
        )
        tau = tau_ff + tau_fb
        new_state, cinfo = physics.step(model, eff, sim_params, state, tau)
        return new_state, tau_ff, tau_fb, cinfo

    state = physics.SimState(
        q=jnp.asarray(Solo12Config.q0(), jnp.float32), v=jnp.zeros(18, jnp.float32)
    )
    spp = 50
    rows = []
    for w in range(T // spp):
        sim_t = w * 0.05
        plan = solve(state.q, state.v, jnp.round(jnp.asarray(sim_t, jnp.float32), 3))
        xs = np.asarray(plan.xs_int)
        us = np.asarray(plan.us_int)
        fi = np.asarray(plan.f_int)
        for i in range(spp):
            q_des = jnp.asarray(xs[i, :19])
            v_des_t = jnp.asarray(xs[i, 19:])
            state, tau_ff, tau_fb, cinfo = substep(
                state, q_des, v_des_t, jnp.asarray(us[i]), jnp.asarray(fi[i])
            )
            if (w * spp + i) % 10 == 0:
                rows.append(
                    dict(
                        t=w * spp + i,
                        z=float(state.q[2]),
                        z_des=float(q_des[2]),
                        vz=float(state.v[2]),
                        jerr=float(jnp.abs(state.q[7:] - q_des[7:]).mean()),
                        fz=float(cinfo.forces[..., 2].sum()),
                        fz_ff=float(np.sum(fi[i][2::3])),
                        ncnt=int(cinfo.in_contact.sum()),
                        tau_ff=float(jnp.abs(tau_ff).max()),
                        tau_fb=float(jnp.abs(tau_fb).max()),
                    )
                )
    print(f"vx={vx} kp={kp} kd={kd}")
    print(
        f"{'t':>5} {'z':>6} {'z_des':>6} {'vz':>6} {'jerr':>6} {'fz':>6} "
        f"{'fz_ff':>6} {'ncnt':>4} {'tffmax':>6} {'tfbmax':>6}"
    )
    for r in rows[:: max(1, len(rows) // 40)]:
        print(
            f"{r['t']:>5} {r['z']:6.3f} {r['z_des']:6.3f} {r['vz']:6.2f} "
            f"{r['jerr']:6.3f} {r['fz']:6.1f} {r['fz_ff']:6.1f} {r['ncnt']:>4} "
            f"{r['tau_ff']:6.2f} {r['tau_fb']:6.2f}"
        )


if __name__ == "__main__":
    main()
