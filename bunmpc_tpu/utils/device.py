"""What the measuring entry points need to know about the accelerator.

Every speed number this repo prints comes from a GPU run and names the card
it ran on; a measurement path that finds no GPU fails instead of falling
back to the CPU."""

from __future__ import annotations

import subprocess
from typing import NamedTuple


class Peak(NamedTuple):
    f32_tflops: float  # dense float32 outside the tensor cores
    hbm_tbs: float  # device-memory bandwidth, TB/s


# NVIDIA H100 data sheet (dense rates, full power limit), keyed by
# jax.Device.device_kind. A card that is not listed has no peak: a roofline
# share against a guessed peak would be a wrong number, not a rough one.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(f32_tflops=67.0, hbm_tbs=3.35),  # SXM5
    "NVIDIA H100 PCIe": Peak(f32_tflops=51.0, hbm_tbs=2.0),
}


def peak_for(device_kind: str) -> Peak:
    """Published peaks of ``device_kind``; ``KeyError`` for an unknown card."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def require_gpu(devices=None):
    """The first JAX device, if it is a GPU; ``RuntimeError`` otherwise."""
    if devices is None:
        import jax

        devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind}); "
            "this measurement runs on the GPU only"
        )
    return dev


NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def parse_nvidia_smi(line: str) -> tuple[str, float | None]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> ``("NVIDIA H100 80GB HBM3", 700.0)``.
    A limit the driver does not report (``[N/A]``) parses as ``None``."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    limit = limit.strip()
    if limit == "[N/A]":
        return name.strip(), None
    value, _, unit = limit.partition(" ")
    if unit != "W":
        raise ValueError(f"unexpected power limit in nvidia-smi line: {line!r}")
    return name.strip(), float(value)


def nvidia_smi_line() -> str:
    """The first card's name and power limit as nvidia-smi reports them (a
    child process that does not touch JAX)."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, check=True, capture_output=True, text=True, timeout=60
    ).stdout
    return out.strip().splitlines()[0]


def card_record(dev) -> dict:
    """Device fields every result line carries."""
    name, limit = parse_nvidia_smi(nvidia_smi_line())
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "gpu_name": name,
        "power_limit_w": limit,
    }
