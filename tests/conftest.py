"""Test harness: the suite runs on the CPU, with an 8-device virtual CPU mesh
forced before any backend initialization so the sharded paths compile and
run, and with x64 enabled (the product path is f32; the golden parity tests
compare in f64)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

from bunmpc_tpu.utils.runtime import setup_jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: the suite is compile-bound (dozens of large
# jitted programs); warm runs skip straight to execution.
setup_jax()
