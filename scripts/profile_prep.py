"""Sub-stage timing of batched problem assembly.

Splits `_prepare_problem` into its three compute stages:

  (a) FK + centroidal state + foot positions (kin.centroidal_state_and_frames)
  (b) contact-plan construction (gait.create_cnt_plan)
  (c) cost/bound/warm-start assembly (the remainder, by subtraction)

plus the full prep and the full batched solve, at B=512 on the current
device. Stages timed on their own do not add up exactly; a device trace of
the full solve is the per-layer source.

Usage: python scripts/profile_prep.py [B]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

import jax.numpy as jnp
import numpy as np

import bench  # noqa: E402
from bunmpc_tpu.kin import algorithms as K
from bunmpc_tpu.mpc import gait as G
from bunmpc_tpu.mpc import kino_dyn as KD
from bunmpc_tpu.utils import quat as Q


def timeit(fn, *args, n=10):
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    spec = bench.make_spec()
    model = spec.model
    q, v, t, v_des, w_des = bench.make_inputs(B)

    # (a) FK + centroidal + frames
    kin = jax.jit(
        jax.vmap(lambda q, v: K.centroidal_state_and_frames(model, q, v, spec.eff_frames))
    )
    dt_kin, (com, h_lin, h_ang, ee_pos) = timeit(kin, q, v)

    # (b) contact plan, from precomputed kin quantities
    def cnt_one(q, t, vd, wd, com, ee):
        qr = q.at[0:2].set(0.0)
        R = Q.quat_to_rot(qr[3:7])
        return G.create_cnt_plan(
            spec.gait, spec.planner, spec.horizon, qr, t, R @ vd, wd, com, ee
        )

    cnt = jax.jit(jax.vmap(cnt_one))
    dt_cnt, _ = timeit(cnt, q, t, v_des, w_des, com, ee_pos)

    # full prep
    prep = jax.jit(
        jax.vmap(lambda q, v, t, vd, wd: KD._prepare_problem(spec, q, v, t, vd, wd))
    )
    dt_prep, _ = timeit(prep, q, v, t, v_des, w_des)

    # full batched solve
    full = jax.jit(lambda q, v, t, vd, wd: KD.solve_mpc_batch(spec, q, v, t, vd, wd))
    dt_full, plans = timeit(full, q, v, t, v_des, w_des, n=5)
    ok = float(jnp.mean((plans.dyn_violation < 1e-3).astype(jnp.float32)))

    out = {
        "B": B,
        "device": jax.devices()[0].device_kind,
        "kin_ms": round(dt_kin * 1e3, 3),
        "cnt_plan_ms": round(dt_cnt * 1e3, 3),
        "prep_ms": round(dt_prep * 1e3, 3),
        "assembly_remainder_ms": round((dt_prep - dt_kin - dt_cnt) * 1e3, 3),
        "full_ms": round(dt_full * 1e3, 3),
        "prep_share": round(dt_prep / dt_full, 3),
        "solves_per_s": round(B / dt_full, 1),
        "converged_frac": ok,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
