"""Smoke test of the batched Solo12 MPC on one GPU.

    python chip_smoke.py

Phases, in one process:

1. device: JAX's first device must be a GPU (no CPU fallback); prints its
   kind, nvidia-smi's name and power limit, the JAX version, the compile-cache
   directory and the default matmul precision.
2. main path at full width: the function and inputs ``bench.py`` times
   (B=512 random trot commands through ``KD.solve_mpc_batch``): compile
   seconds, median time per batch over 5 reps, solves/s, converged_frac at
   the 1e-3 exit tolerance (must be 1.0), the compiled program's memory
   analysis and the device's peak bytes in use.
3. parity with the native C++ twin (f64) under the reference ADMM schedule:
   (a) the frozen window ``tests/fixtures/solo12_trot_e2e.npz`` tiled to
   B=128; (b) the fully native raw -> plan -> ADMM -> IK chain on 4 lanes of
   the phase-2 inputs. Both run as one batch of 132 lanes (one compile).
   Every deviation is printed beside its gate.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failed phase or gate prints ``{"ok": false, ...}`` instead and exits 1.
"""

import json
import os
import statistics
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "solo12_trot_e2e.npz")
HIP_FRAMES = ("FL_HFE", "FR_HFE", "HL_HFE", "HR_HFE")

FIXTURE_B = 128
CHAIN_LANES = 4
# Bounds of the f32 path against the f64 native solutions. (X, F): the
# f32-accumulation bounds the fused TPU-era ADMM was held to. (xs, us): the
# kinematic GN-DDP's optimum is flat along the weakly regularized joint
# velocities, so f32 round-off moves it there: on these lanes the f32 path
# measured |dxs| 4.7e-3, |dus| 0.13 on a CPU, where the same program in f64
# gives 8.3e-4 and 2.2e-2 (with IK costs 1e-4 relative below the native
# ones). |dus| carries the ~1/dt^2 amplification of accelerations; its scale
# is ~50 rad/s^2.
GATES_FIXTURE = {"dX": 1e-3, "dF": 5e-3}
GATES_CHAIN = {"dX": 1e-3, "dF": 5e-3, "dxs": 1e-2, "dus": 2.5e-1}


def parity_admm_config(max_admm_iters: int = 500):
    """The reference ADMM schedule (no over-relaxation, no rho escalation)
    at a tight exit tolerance, so both sides land on the same fixed point."""
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu.solvers.biconvex import BiconvexConfig

    return BiconvexConfig(
        rho=trot.rho, x_solver="thomas", dual_relax=1.0, rho_growth=1.0,
        exit_tol=1e-5, max_admm_iters=max_admm_iters,
    )


def last_line(dev=None, count: int = 0, error: str | None = None) -> str:
    """The result line the smoke ends with: the device on success, the error
    otherwise."""
    if error is not None:
        return json.dumps({"ok": False, "error": error})
    return json.dumps(
        {"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count}}
    )


def check_gates(name: str, devs: dict, gates: dict) -> list:
    """Print each deviation beside its gate; return the names that failed."""
    failed = []
    for k, gate in gates.items():
        good = bool(devs[k] < gate)  # NaN fails
        print(f"  {name} |{k}| = {devs[k]:.3e}  gate < {gate:g}  {'ok' if good else 'FAIL'}")
        if not good:
            failed.append(f"{name}.{k}")
    return failed


def parity_solve(inputs, admm_cfg=None):
    """Lanes of raw inputs through ``solve_mpc_batch`` in f32 under the
    reference schedule; lanes are independent problems."""
    import jax

    import bench
    from bunmpc_tpu.mpc import kino_dyn as KD

    if admm_cfg is None:
        admm_cfg = parity_admm_config()
    spec = bench.make_spec()
    return jax.jit(lambda *a: KD.solve_mpc_batch(spec, *a, admm_cfg=admm_cfg))(*inputs)


def fixture_inputs(fx, batch: int):
    """The frozen trot window's raw inputs, tiled to ``batch`` lanes (f32)."""
    import jax.numpy as jnp

    return tuple(
        jnp.broadcast_to(jnp.asarray(fx[k], jnp.float32), (batch,) + np.shape(fx[k]))
        for k in ("q", "v", "t", "v_des", "w_des")
    )


def fixture_devs(plans, fx) -> dict:
    """Max deviation over all lanes of (X, F) from the fixture's native f64
    solution."""
    return {
        "dX": float(np.abs(np.asarray(plans.X_opt, np.float64) - fx["X_opt"]).max()),
        "dF": float(np.abs(np.asarray(plans.F_opt, np.float64) - fx["F_opt"]).max()),
        "viol_max": float(np.max(np.asarray(plans.dyn_violation))),
        "admm_iters_max": int(np.max(np.asarray(plans.admm_iters))),
    }


def chain_devs(plans, inputs) -> dict:
    """Max deviation over lanes of (X, F, xs, us) from the fully native f64
    chain run on the same raw inputs."""
    import bench
    from bunmpc_tpu.native import bindings as native
    from bunmpc_tpu.robots.solo12 import Solo12Config

    spec = bench.make_spec()
    raw = [np.asarray(a, np.float64) for a in inputs]
    devs = {"dX": 0.0, "dF": 0.0, "dxs": 0.0, "dus": 0.0, "native_viol_max": 0.0}
    for i in range(raw[0].shape[0]):
        nat = native.solve_raw(
            spec.model, spec.eff_frames, HIP_FRAMES, Solo12Config.q0(), spec.params,
            *(a[i] for a in raw),
        )
        for k, ours, theirs in (
            ("dX", plans.X_opt, nat["X"]), ("dF", plans.F_opt, nat["F"]),
            ("dxs", plans.xs, nat["xs"]), ("dus", plans.us, nat["us"]),
        ):
            d = float(np.abs(np.asarray(ours[i], np.float64) - theirs).max())
            devs[k] = max(devs[k], d) if np.isfinite(d) else float("nan")
        devs["native_viol_max"] = max(devs["native_viol_max"], float(nat["viol"]))
    devs["viol_max"] = float(np.max(np.asarray(plans.dyn_violation)))
    return devs


def phase_device():
    import jax

    from bunmpc_tpu.utils.device import nvidia_smi_line, require_gpu
    from bunmpc_tpu.utils.runtime import setup_jax

    cache = setup_jax()
    dev = require_gpu()
    print(f"device_kind: {dev.device_kind}  count: {len(jax.devices())}")
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(f"jax {jax.__version__}  compile cache: {cache}")
    print(f"jax_default_matmul_precision: {jax.config.jax_default_matmul_precision}")
    return dev


def phase_main_path(dev):
    import jax

    import bench

    spec = bench.make_spec()
    args = bench.make_inputs()
    solve = bench.make_solve(spec, bench.admm_config())
    t0 = time.perf_counter()
    compiled = solve.lower(*args).compile()
    print(f"main path B={bench.B}: compile {time.perf_counter() - t0:.1f} s")
    print(f"  memory_analysis: {compiled.memory_analysis()}")
    plans = jax.block_until_ready(compiled(*args))
    conv = bench.converged_frac(plans)
    times = bench.timed_reps(compiled, args)
    med = statistics.median(times)
    finite = all(
        bool(np.isfinite(np.asarray(a)).all())
        for a in (plans.xs_int, plans.us_int, plans.f_int, plans.X_opt, plans.F_opt)
    )
    print(f"  reps (s): {times}")
    print(f"  median {med * 1e3:.2f} ms/batch  {bench.B / med:.1f} solves/s")
    print(f"  converged_frac@1e-3: {conv}  finite: {finite}  "
          f"xs_int {tuple(plans.xs_int.shape)}")
    print(f"  peak_bytes_in_use: {dev.memory_stats().get('peak_bytes_in_use')}")
    failed = []
    if conv != 1.0:
        failed.append("main.converged_frac")
    if not finite:
        failed.append("main.finite")
    if plans.xs_int.shape != (bench.B, spec.n_int, spec.model.nq + spec.model.nv):
        failed.append("main.shape")
    return failed, args


def phase_parity(main_inputs):
    """(a) and (b) share one compiled solve: the fixture tiled to FIXTURE_B
    lanes followed by the first CHAIN_LANES lanes of the main-path inputs."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.native import bindings as native

    native.load()  # builds the twin from the committed sources
    fx = np.load(FIXTURE)
    chain_in = tuple(x[:CHAIN_LANES] for x in main_inputs)
    inputs = tuple(
        jnp.concatenate([a, b]) for a, b in zip(fixture_inputs(fx, FIXTURE_B), chain_in)
    )
    t0 = time.perf_counter()
    plans = jax.block_until_ready(parity_solve(inputs))
    print(f"parity (reference schedule, exit_tol 1e-5, f32 on {jax.devices()[0].device_kind}, "
          f"B={FIXTURE_B}+{CHAIN_LANES}): compile+solve {time.perf_counter() - t0:.1f} s")
    plans = jax.tree_util.tree_map(np.asarray, plans)
    a = fixture_devs(jax.tree_util.tree_map(lambda x: x[:FIXTURE_B], plans), fx)
    print(f"  (a) fixture x{FIXTURE_B}: viol_max {a['viol_max']:.2e} "
          f"admm_iters_max {a['admm_iters_max']}")
    failed = check_gates("fixture", a, GATES_FIXTURE)
    b = chain_devs(jax.tree_util.tree_map(lambda x: x[FIXTURE_B:], plans), chain_in)
    print(f"  (b) native chain x{CHAIN_LANES}: viol_max {b['viol_max']:.2e} "
          f"native viol_max {b['native_viol_max']:.2e}")
    failed += check_gates("chain", b, GATES_CHAIN)
    return failed


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        dev = phase_device()
        failed, main_inputs = phase_main_path(dev)
        failed += phase_parity(main_inputs)
    except Exception as e:  # report the failing phase, then fail the run
        traceback.print_exc()
        print(last_line(error=f"{type(e).__name__}: {e}"))
        return 1
    if failed:
        print(last_line(error=f"failed: {failed}"))
        return 1
    import jax

    print(last_line(dev, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
