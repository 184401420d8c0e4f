"""Probe: does the Go2 kino-dyn solve NaN on off-nominal (in-sim) states?

The round-3 Go2 stability sweep shows rollouts "failing" with benign
attitude/height stats — the rollout's mpc_bad predicate (NaN in the plan,
sim/rollout.py) is what fires, not the physical failure envelope. This
script solves a batch of perturbed Go2 states and reports the NaN fraction
per pipeline stage (ADMM X/F, IK xs, 1 kHz interp) to localize the blow-up.

Usage: python scripts/probe_go2_nan.py [n] [pert_scale]
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
from bunmpc_tpu.mpc.motions.go2_cyclic import trot
from bunmpc_tpu.robots.go2 import Go2Config as C
from bunmpc_tpu.utils import quat as Q


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    scale = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0

    model = C.load_model()
    spec = KD.make_cyclic_spec(
        model, trot, C.q0(), eff_frames=tuple(C.eff_names),
        hip_frames=tuple(C.hip_names), foot_size=C.foot_size,
    )

    rng = np.random.default_rng(0)
    q = np.tile(C.q0(), (B, 1)).astype(np.float32)
    # perturb: base height +-5cm, attitude up to ~15 deg, joints +-0.3 rad
    q[:, 2] += rng.normal(size=B).astype(np.float32) * 0.03 * scale
    rpy = rng.normal(size=(B, 3)).astype(np.float32) * 0.1 * scale
    quat = np.stack([
        np.asarray(Q.rot_to_quat(Q.rpy_to_rot(jnp.asarray(r)))) for r in rpy
    ])
    q[:, 3:7] = quat
    q[:, 7:] += rng.normal(size=(B, 12)).astype(np.float32) * 0.15 * scale
    v = rng.normal(size=(B, 18)).astype(np.float32) * np.concatenate(
        [[0.3] * 3, [0.5] * 3, [1.0] * 12]
    ).astype(np.float32) * scale
    t = rng.uniform(0, 0.5, size=B).astype(np.float32)
    v_des = np.stack(
        [np.full(B, 0.3), np.zeros(B), np.zeros(B)], -1
    ).astype(np.float32)
    w_des = np.zeros(B, np.float32)

    solve = jax.jit(
        lambda q, v, t, vd, wd: KD.solve_mpc_batch(spec, q, v, t, vd, wd)
    )
    plans = jax.block_until_ready(
        solve(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t),
              jnp.asarray(v_des), jnp.asarray(w_des))
    )

    def nan_frac(x):
        return float(jnp.mean(jnp.any(jnp.isnan(x.reshape(B, -1)), axis=1)))

    print(f"B={B} scale={scale}")
    print(f"  X_opt  nan frac: {nan_frac(plans.X_opt):.3f}")
    print(f"  F_opt  nan frac: {nan_frac(plans.F_opt):.3f}")
    print(f"  xs     nan frac: {nan_frac(plans.xs):.3f}")
    print(f"  us     nan frac: {nan_frac(plans.us):.3f}")
    print(f"  xs_int nan frac: {nan_frac(plans.xs_int):.3f}")
    print(f"  f_int  nan frac: {nan_frac(plans.f_int):.3f}")
    viol = np.asarray(plans.dyn_violation)
    print(f"  dyn_violation: med={np.median(viol):.2e} max={viol.max():.2e} "
          f"conv@1e-3={np.mean(viol < 1e-3):.2f} nan={np.mean(np.isnan(viol)):.2f}")


if __name__ == "__main__":
    main()
