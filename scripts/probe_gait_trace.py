"""Fine-grained gait failure probe: host-loop rollout dumping per-step
planned-vs-actual base z, per-foot forces (planned + measured), foot heights,
and per-leg PD tracking errors — the observables that cracked the Go2
collapse (ROADMAP Go2 item, VERDICT round-3 task 2).

Usage: python scripts/probe_gait_trace.py [robot] [vx] [T_ms] [kp] [kd] [kn]
        [sb] [fg] [out_npz] [settle_ms] [ff_scale] [schedule]
``ff_scale`` globally scales the J^T f_ff term (1 = normal, 0 = PD only) to
isolate whether over-pressing planned forces drives the base upward.
``schedule``: accel (default) | plain — the ADMM outer schedule; plain pins
the reference's fixed-rho dual ascent (divergence isolation).
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
from bunmpc_tpu.mpc import gait as G
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.sim import controllers, physics, rollout
from bunmpc_tpu.utils.quat import quat_to_rot, rot_to_rpy


def main():
    robot = sys.argv[1] if len(sys.argv) > 1 else "go2"
    argv = sys.argv[1:]
    if robot == "go2":
        from bunmpc_tpu.mpc.motions.go2_cyclic import trot
        from bunmpc_tpu.robots.go2 import Go2Config as C
    else:
        from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
        from bunmpc_tpu.robots.solo12 import Solo12Config as C
    vx = float(argv[1]) if len(argv) > 1 else 0.3
    T = int(argv[2]) if len(argv) > 2 else 1000
    kp = float(argv[3]) if len(argv) > 3 else trot.kp
    kd = float(argv[4]) if len(argv) > 4 else trot.kd
    kn = float(argv[5]) if len(argv) > 5 else (6e4 if robot == "go2" else 1e4)
    sb = float(argv[6]) if len(argv) > 6 else 1.0
    fg = float(argv[7]) if len(argv) > 7 else 1.0
    out = argv[8] if len(argv) > 8 else f"/tmp/{robot}_trace.npz"
    settle_ms = int(argv[9]) if len(argv) > 9 else 500
    ff_scale = float(argv[10]) if len(argv) > 10 else 1.0
    schedule = argv[11] if len(argv) > 11 else "accel"

    model = C.load_model()
    if robot == "go2":
        spec = KD.make_cyclic_spec(
            model, trot, C.q0(), eff_frames=tuple(C.eff_names),
            hip_frames=tuple(C.hip_names), foot_size=C.foot_size,
        )
    else:
        spec = KD.make_cyclic_spec(model, trot, C.q0())
    import dataclasses as dc

    spec = dc.replace(spec, params=dc.replace(spec.params, kp=kp, kd=kd))
    sim_params = physics.SimParams(
        contact=physics.ContactParams(
            foot_radius=getattr(C, "foot_size", 0.018), kn=kn, dn=kn / 20.0,
            kt=kn / 20.0, mu=1.0,
        ),
        torque_limit=23.7 if robot == "go2" else 2.7,
    )
    gains = controllers.IdControllerGains(kp=kp, kd=kd)
    eff = spec.eff_frames
    leg_mask = rollout.leg_joint_mask(model, eff)  # (4, 12)

    state = physics.SimState(q=jnp.asarray(C.q0()), v=jnp.zeros(model.nv))
    if settle_ms:
        q0j = state.q[7:]
        kp_s, kd_s = 6.0 * kp, 6.0 * kd

        def settle_step(s, _):
            tau = -kp_s * (s.q[7:] - q0j) - kd_s * s.v[6:]
            s2, _ = physics.step(model, eff, sim_params, s, tau)
            return s2, None

        state, _ = jax.lax.scan(settle_step, state, None, length=settle_ms)
        print(f"settled: z={float(state.q[2]):.4f}")

    from bunmpc_tpu.solvers import biconvex

    if schedule == "plain":
        acfg = biconvex.BiconvexConfig(
            rho=spec.params.rho, dual_relax=1.0, rho_growth=1.0,
            x_solver="thomas",
        )
    else:
        acfg = biconvex.BiconvexConfig(rho=spec.params.rho, x_solver="thomas")
    solve = jax.jit(
        lambda q, v, t, vd, wd: KD.solve_mpc(spec, q, v, t, vd, wd, admm_cfg=acfg)
    )
    step = jax.jit(
        lambda s, tau: physics.step(model, eff, sim_params, s, tau)
    )
    ctrl = jax.jit(
        lambda q, v, qd, vd, ad, f, fs: controllers.id_joint_torques(
            model, eff, gains, q, v, qd, vd, ad, f, f_scale=fs
        )
    )
    foot_z_fn = jax.jit(lambda q: K.frame_positions(model, q, eff)[:, 2])

    spp = 50
    vd = jnp.asarray([vx, 0.0, 0.0], jnp.float32)
    wd = jnp.asarray(0.0, jnp.float32)
    rows = []
    prev_cnt = jnp.ones(4, bool)
    for w in range(T // spp):
        t = round(w * 0.05, 3)
        q = state.q.at[0:2].set(0.0)
        plan = solve(q, state.v, jnp.asarray(t), vd, wd)
        planned_cnt = np.asarray(plan.cnt_plan[0, :, 0])
        viol_w = float(plan.dyn_violation)
        Xw = np.asarray(plan.X_opt)
        com_now = np.asarray(K.com(model, state.q))
        print(
            f"  w{w:02d} com_z={com_now[2]:.4f} X_z[0,1,2,5,H]="
            f"{Xw[0,2]:.4f} {Xw[1,2]:.4f} {Xw[2,2]:.4f} {Xw[5,2]:.4f} {Xw[-1,2]:.4f} "
            f"X_vz[0,1]={Xw[0,5]:+.3f} {Xw[1,5]:+.3f} viol={viol_w:.1e}"
        )
        fmax_w = float(np.abs(np.asarray(plan.F_opt)).max())
        if not np.isfinite(fmax_w) or fmax_w > 1e4 or viol_w > 0.1:
            print(
                f"WINDOW {w} t={t}: SOLVER BLOWUP viol={viol_w:.3e} "
                f"|F|max={fmax_w:.1f} iters={int(plan.admm_iters)} "
                f"z={float(state.q[2]):.3f} |v|max={float(jnp.abs(state.v).max()):.2f}"
            )
        for i in range(spp):
            q, v = state.q, state.v
            fsc = jnp.where(prev_cnt, 1.0, fg) * ff_scale
            tau_ff, tau_fb = ctrl(
                q, v, plan.xs_int[i, : model.nq], plan.xs_int[i, model.nq :],
                plan.us_int[i], plan.f_int[i], fsc,
            )
            if sb != 1.0:
                t_ms = t + i * 0.001
                planned_st = G.in_stance(spec.gait, jnp.asarray(t_ms, q.dtype))
                scale_j = rollout.swing_blend_scale(
                    jnp.asarray(leg_mask, q.dtype), planned_st, prev_cnt,
                    jnp.asarray(sb, q.dtype),
                )
                tau_fb = scale_j * tau_fb
            tau = tau_ff + tau_fb
            state, cinfo = step(state, tau)
            prev_cnt = cinfo.in_contact
            rpy = np.rad2deg(np.asarray(rot_to_rpy(quat_to_rot(state.q[3:7]))))
            fz_meas = np.asarray(cinfo.forces[:, 2])
            fz_plan = np.asarray(plan.f_int[i]).reshape(4, 3)[:, 2]
            fz_t = np.asarray(foot_z_fn(state.q))
            qerr = np.asarray(state.q[7:] - plan.xs_int[i, 7 : model.nq])
            fx_meas = np.asarray(cinfo.forces[:, 0])
            fx_plan = np.asarray(plan.f_int[i]).reshape(4, 3)[:, 0]
            rows.append(
                np.concatenate(
                    [
                        [w * 0.05 + i * 0.001, float(state.q[2]),
                         float(plan.xs_int[i, 2]), rpy[0], rpy[1]],
                        fz_meas, fz_plan, fz_t,
                        np.abs(qerr.reshape(4, 3)).max(axis=1),
                        np.asarray(prev_cnt, float), planned_cnt,
                        [float(np.abs(np.asarray(tau)).max()),
                         float(state.v[0]), float(plan.xs_int[i, model.nq]),
                         fx_meas.sum(), fx_plan.sum()],
                    ]
                )
            )
    A = np.array(rows)
    np.savez(out, trace=A)
    cols = (
        "t z z_des roll pitch "
        "fzm0 fzm1 fzm2 fzm3 fzp0 fzp1 fzp2 fzp3 footz0 footz1 footz2 footz3 "
        "qe0 qe1 qe2 qe3 cnt0 cnt1 cnt2 cnt3 pl0 pl1 pl2 pl3 tau_max "
        "vx vx_des fx_m fx_p"
    ).split()
    print(f"wrote {out}; columns: {cols}")
    # compact console dump every 50 ms
    hdr = (f"{'t':>5} {'z':>6} {'z_des':>6} {'roll':>6} {'pitch':>6} | fz_meas | fz_plan | "
           f"qerr | cnt plan | {'vx':>6} {'vx_des':>6} {'fx_m':>6} {'fx_p':>6}")
    print(hdr)
    for r in A[::50]:
        print(
            f"{r[0]:5.2f} {r[1]:6.3f} {r[2]:6.3f} {r[3]:6.1f} {r[4]:6.1f} | "
            f"{r[5]:5.0f} {r[6]:5.0f} {r[7]:5.0f} {r[8]:5.0f} | "
            f"{r[9]:5.0f} {r[10]:5.0f} {r[11]:5.0f} {r[12]:5.0f} | "
            f"{max(r[17:21]):4.2f} | {''.join(str(int(c)) for c in r[21:25])} {''.join(str(int(c)) for c in r[25:29])} "
            f"{r[29]:5.1f} | {r[30]:6.3f} {r[31]:6.3f} {r[32]:6.1f} {r[33]:6.1f}"
        )


if __name__ == "__main__":
    main()
