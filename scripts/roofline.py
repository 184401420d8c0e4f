"""Roofline / speed-of-light analysis of the batched MPC hot path on a GPU.

For each stage (problem assembly, full batched solve) this reports XLA's own
cost model (FLOPs, device-memory bytes accessed) against measured wall time,
i.e. achieved FLOP/s and bandwidth as a share of the card's published peaks
(``bunmpc_tpu.utils.device.PEAKS``, keyed by device kind; an unknown card is
an error) — which of compute or memory is the binding roof.

    python scripts/roofline.py [batch=512]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

setup_jax()

import bench  # noqa: E402
from bunmpc_tpu.mpc import kino_dyn as KD  # noqa: E402
from bunmpc_tpu.utils.device import card_record, peak_for, require_gpu  # noqa: E402


def analyze(name, fn, args, n=5):
    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else (ca or {})
    flops = float(ca.get("flops", 0.0))
    bytes_acc = float(ca.get("bytes accessed", 0.0))
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(compiled(*args))
    dt = (time.perf_counter() - t0) / n
    return dict(name=name, sec=dt, flops=flops, bytes=bytes_acc), out


def main():
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    B = int(args.get("batch", bench.B))
    dev = require_gpu()
    peak = peak_for(dev.device_kind)
    spec = bench.make_spec()
    admm_cfg = bench.admm_config()
    inputs = bench.make_inputs(B)

    rows = []
    r, _ = analyze("prep", jax.vmap(lambda *a: KD._prepare_problem(spec, *a)), inputs)
    rows.append(r)
    r, _ = analyze(
        "full solve",
        lambda *a: KD.solve_mpc_batch(spec, *a, admm_cfg=admm_cfg),
        inputs,
    )
    rows.append(r)

    print(f"B={B}  device={card_record(dev)}")
    print(f"published peaks: {peak.f32_tflops} TFLOP/s f32, {peak.hbm_tbs} TB/s")
    print(f"{'stage':<14}{'ms':>9}{'GFLOP':>10}{'GB':>9}{'%peak FLOP':>12}{'%peak BW':>10}  roof")
    for r in rows:
        fu = 100 * r["flops"] / r["sec"] / (peak.f32_tflops * 1e12)
        bu = 100 * r["bytes"] / r["sec"] / (peak.hbm_tbs * 1e12)
        roof = "compute" if fu > bu else "memory"
        print(
            f"{r['name']:<14}{r['sec']*1e3:>9.2f}{r['flops']/1e9:>10.2f}"
            f"{r['bytes']/1e9:>9.3f}{fu:>11.2f}%{bu:>9.2f}%  {roof}"
        )
    print(
        "NOTE: XLA's cost model counts a while-loop body once, not once per "
        "trip, so the loop-bound stages' shares are lower bounds."
    )


if __name__ == "__main__":
    main()
