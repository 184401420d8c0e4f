"""Multi-device scaling benchmark: batched MPC sharded over the mesh.

Measures solves/s at 1..N devices and reports scaling efficiency
(BASELINE.md target: >= 85% at 4 hosts). On a single-chip machine, run with
virtual CPU devices to validate the sharded program:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_multichip.py

On real multi-chip hardware it reports the true scaling curve.

Multi-HOST (DCN-spanning) measurement — the exact invocation for the day
real multi-host hardware exists (BASELINE.md >= 85%-at-4-hosts target); run
the SAME command on every host of the slice:

    # host i of N (e.g. N=4), any reachable host as coordinator:
    python scripts/bench_multichip.py \
        coordinator=<host0-addr>:8476 num_processes=4 process_id=$i \
        per_device=64 fast=0

This initializes jax.distributed, builds the 2-D ('dcn', 'ici') mesh
(hosts x local chips, parallel/mesh.multihost_mesh), shards the solve batch
over BOTH axes, and reports solves/s + efficiency vs the single-host rate.
The DCN code path is validated single-process on virtual CPU devices
(committed smoke artifact artifacts/multichip_scaling_cpu_dcn.json):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_multichip.py dcn=2 per_device=4
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    args = dict(a.split("=", 1) for a in sys.argv[1:])
    if "coordinator" in args:
        # real multi-host: one process per host, coordinated over DCN
        jax.distributed.initialize(
            coordinator_address=args["coordinator"],
            num_processes=int(args["num_processes"]),
            process_id=int(args["process_id"]),
        )

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu.parallel.mesh import (
        batch_mesh,
        multihost_mesh,
        scaling_efficiency,
    )
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.solvers import biconvex, ddp

    per_device = int(args.get("per_device", 16))
    fast = args.get("fast", "1") == "1"
    # dcn: number of hosts. Real multi-host -> process_count; single-process
    # smoke -> simulated host split of the local device list.
    dcn = int(args["dcn"]) if "dcn" in args else (
        jax.process_count() if jax.process_count() > 1 else 0
    )

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    kwargs = {}
    if fast:  # keep virtual-CPU runs tractable
        kwargs = dict(
            admm_cfg=biconvex.BiconvexConfig(rho=trot.rho, max_admm_iters=30),
            ddp_cfg=ddp.DdpConfig(n_iters=2),
        )

    n_avail = len(jax.devices())
    counts = sorted({1, 2, 4, 8, n_avail} & set(range(1, n_avail + 1)))
    rates = {}
    for n in counts:
        mesh = batch_mesh(n)
        B = per_device * n
        sh = NamedSharding(mesh, P("batch"))
        rng = np.random.default_rng(0)
        q = jax.device_put(
            jnp.asarray(np.tile(Solo12Config.q0(), (B, 1)), jnp.float32), sh
        )
        v = jax.device_put(jnp.zeros((B, 18), jnp.float32), sh)
        t = jax.device_put(jnp.zeros(B, jnp.float32), sh)
        vd = jax.device_put(
            jnp.tile(jnp.asarray([0.2, 0.0, 0.0], jnp.float32), (B, 1)), sh
        )
        wd = jax.device_put(jnp.zeros(B, jnp.float32), sh)
        solve = jax.jit(jax.vmap(lambda *a: KD.solve_mpc(spec, *a, **kwargs)))
        jax.block_until_ready(solve(q, v, t, vd, wd))
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(solve(q, v, t, vd, wd))
        dt = (time.perf_counter() - t0) / 3
        rates[n] = B / dt
        print(f"{n} devices: B={B} -> {rates[n]:.1f} solves/s")

    eff = scaling_efficiency(rates)
    platform = jax.devices()[0].platform

    # --- DCN-spanning ('dcn', 'ici') mesh path ---
    dcn_doc = None
    if dcn >= 2:
        n_all = len(jax.devices())
        per_host = n_all // dcn
        multi = jax.process_count() > 1

        def dcn_rate(k_hosts):
            mesh = multihost_mesh(
                dcn=k_hosts, devices=jax.devices()[: k_hosts * per_host]
            )
            B = per_device * k_hosts * per_host
            sh = NamedSharding(mesh, P(("dcn", "ici")))
            q = jax.device_put(
                jnp.asarray(np.tile(Solo12Config.q0(), (B, 1)), jnp.float32), sh
            )
            v = jax.device_put(jnp.zeros((B, 18), jnp.float32), sh)
            t = jax.device_put(jnp.zeros(B, jnp.float32), sh)
            vd = jax.device_put(
                jnp.tile(jnp.asarray([0.2, 0.0, 0.0], jnp.float32), (B, 1)), sh
            )
            wd = jax.device_put(jnp.zeros(B, jnp.float32), sh)
            solve = jax.jit(jax.vmap(lambda *a: KD.solve_mpc(spec, *a, **kwargs)))
            jax.block_until_ready(solve(q, v, t, vd, wd))
            t0 = time.perf_counter()
            for _ in range(3):
                jax.block_until_ready(solve(q, v, t, vd, wd))
            return B / ((time.perf_counter() - t0) / 3)

        if multi:
            # every process must join every collective: measure the full
            # mesh only; the 1-host baseline for the efficiency quotient
            # comes from a separate single-host run of this script
            r_full = dcn_rate(dcn)
            dcn_doc = {
                "hosts": dcn,
                "per_host_devices": per_host,
                "rate_full_mesh": round(r_full, 1),
                "note": "divide by a single-host run's rate x hosts for efficiency",
            }
            print(f"dcn mesh {dcn}x{per_host}: {r_full:.1f} solves/s")
        else:
            r1 = dcn_rate(1)
            rk = dcn_rate(dcn)
            dcn_doc = {
                "hosts": dcn,
                "per_host_devices": per_host,
                "rate_1_host": round(r1, 1),
                "rate_full_mesh": round(rk, 1),
                "efficiency_vs_1_host": round(rk / (dcn * r1), 3),
            }
            print(
                f"dcn mesh {dcn}x{per_host}: {rk:.1f} solves/s "
                f"(eff {dcn_doc['efficiency_vs_1_host']:.0%} vs 1 host)"
            )

    doc = {
        "platform": platform,
        "n_devices": n_avail,
        "per_device": per_device,
        "fast_budget": fast,
        "rates": {str(k): round(v, 1) for k, v in rates.items()},
        "efficiency": eff,
    }
    if dcn_doc is not None:
        doc["dcn"] = dcn_doc
    if platform == "cpu":
        doc["note"] = (
            "virtual CPU devices share the same host cores — this run "
            "validates the sharded program (psum/sharding correctness), "
            "not hardware scaling efficiency"
        )
        print("NOTE:", doc["note"])

    suffix = "_dcn" if (dcn >= 2 and jax.process_count() == 1) else ""
    out = args.get(
        "out",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "artifacts",
            f"multichip_scaling_{platform}{suffix}.json",
        ),
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps({"rates": rates, "efficiency": eff}))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
