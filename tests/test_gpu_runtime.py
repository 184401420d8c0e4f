"""CPU tests of what the GPU entry points (bench.py, chip_smoke.py) are built
from: the compile-cache setup, the device check, the peak table, the
nvidia-smi parser, the smoke's result line and parity helpers, the batched
solve path, and static rules the tree keeps (no TPU-only code, one place
that sets the cache directory)."""

import json
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from bunmpc_tpu.utils import device, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


# --- compile cache ---------------------------------------------------------


def test_setup_jax_honours_env_cache_dir(tmp_path, monkeypatch, restore_cache_config):
    d = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    assert runtime.setup_jax() == str(d)
    assert jax.config.jax_compilation_cache_dir == str(d)
    assert d.is_dir()


def test_setup_jax_default_is_checkout_path_whatever_the_cwd(
    tmp_path, monkeypatch, restore_cache_config
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    expected = os.path.join(REPO, ".jax_cache")
    assert runtime.setup_jax() == expected
    assert jax.config.jax_compilation_cache_dir == expected


def test_empty_env_cache_dir_falls_back_to_checkout(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert runtime.cache_dir() == os.path.join(REPO, ".jax_cache")


# --- device check, peaks, nvidia-smi -----------------------------------------


def test_require_gpu_refuses_cpu_device():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_require_gpu_returns_the_gpu():
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert device.require_gpu([gpu]) is gpu


@pytest.mark.parametrize(
    "kind, f32, bw",
    [("NVIDIA H100 80GB HBM3", 67.0, 3.35), ("NVIDIA H100 PCIe", 51.0, 2.0)],
)
def test_peak_table_known_h100(kind, f32, bw):
    assert device.peak_for(kind) == device.Peak(f32_tflops=f32, hbm_tbs=bw)


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device.peak_for(kind)


@pytest.mark.parametrize(
    "line, name, limit",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
        ("NVIDIA H100 80GB HBM3, 400.00 W\n", "NVIDIA H100 80GB HBM3", 400.0),
        ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", None),
    ],
)
def test_parse_nvidia_smi(line, name, limit):
    assert device.parse_nvidia_smi(line) == (name, limit)


@pytest.mark.parametrize("line", ["", "NVIDIA H100 80GB HBM3", ", 700.00 W", "H100, 7 kW"])
def test_parse_nvidia_smi_rejects_malformed(line):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(line)


# --- chip_smoke.py -------------------------------------------------------------


def test_smoke_last_line_ok():
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.last_line(gpu, 1)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )


def test_smoke_last_line_failure_carries_error():
    assert json.loads(chip_smoke.last_line(error="boom")) == {"ok": False, "error": "boom"}


def test_smoke_check_gates_fails_nan_and_excess(capsys):
    gates = {"a": 1e-3, "b": 1e-3, "c": 1e-3}
    failed = chip_smoke.check_gates("x", {"a": 1e-4, "b": 2e-3, "c": float("nan")}, gates)
    assert failed == ["x.b", "x.c"]
    assert capsys.readouterr().out.count("FAIL") == 2


def test_smoke_refuses_cpu_before_compiling():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is False
    assert "main path" not in out.stdout  # stopped at the device phase


def test_smoke_alone_without_the_repo_fails(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        (tmp_path / "chip_smoke.py").write_text(fh.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_smoke_fixture_parity_helper_small_budget():
    """The fixture phase at a CPU-sized batch and iteration budget: the
    entry point runs in f32, the ADMM stops at its cap, and the deviations
    from the native fixture are finite."""
    fx = np.load(chip_smoke.FIXTURE)
    cfg = chip_smoke.parity_admm_config(max_admm_iters=40)
    plans = chip_smoke.parity_solve(chip_smoke.fixture_inputs(fx, 2), admm_cfg=cfg)
    assert plans.X_opt.dtype == np.float32
    a = chip_smoke.fixture_devs(plans, fx)
    assert set(a) == {"dX", "dF", "viol_max", "admm_iters_max"}
    assert a["admm_iters_max"] == 40
    assert np.isfinite([a["dX"], a["dF"], a["viol_max"]]).all()
    assert a["dX"] < 0.1 and a["dF"] < 1.0


def test_smoke_chain_parity_helper_one_lane():
    """The native-chain phase on one lane of the bench inputs at a small
    ADMM budget: the native twin builds and the deviations are finite."""
    import bench

    cfg = chip_smoke.parity_admm_config(max_admm_iters=40)
    lane = tuple(x[:1] for x in bench.make_inputs(8))
    b = chip_smoke.chain_devs(chip_smoke.parity_solve(lane, admm_cfg=cfg), lane)
    for k in ("dX", "dF", "dxs", "dus", "viol_max", "native_viol_max"):
        assert np.isfinite(b[k]), k
    assert b["native_viol_max"] < 1e-5  # the native side runs to its own tolerance
    assert b["dX"] < 0.1


# --- batched solve -------------------------------------------------------------


def test_solve_mpc_batch_odd_batch_matches_per_lane_solve():
    """B=3 through the one batched entry point equals solve_mpc lane by
    lane (no lane-width padding or tiling assumption left)."""
    import bench
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.solvers import biconvex, ddp

    spec = bench.make_spec()
    admm_cfg = biconvex.BiconvexConfig(
        rho=spec.params.rho, x_solver="thomas", fista_max_iters=30, max_admm_iters=40
    )
    ddp_cfg = ddp.DdpConfig(n_iters=2)
    args = bench.make_inputs(3, seed=5)
    batch = jax.jit(
        lambda *a: KD.solve_mpc_batch(spec, *a, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg)
    )(*args)
    one = jax.jit(lambda *a: KD.solve_mpc(spec, *a, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg))
    assert batch.xs_int.shape == (3, spec.n_int, spec.model.nq + spec.model.nv)
    for i in range(3):
        lane = one(*(a[i] for a in args))
        # f32 sums in batched vs single-sample order. The GN-DDP optimum is
        # flat along the weakly regularized joint velocities, where f32
        # round-off moves xs by up to ~1e-4 (and f32 vs f64 by ~5e-3);
        # accelerations (|us| up to ~300 rad/s^2) amplify that by ~1/dt^2
        for name, atol in (
            ("X_opt", 1e-5), ("F_opt", 1e-5), ("dyn_violation", 1e-6),
            ("xs", 5e-4), ("xs_int", 5e-4), ("us", 5e-2),
        ):
            np.testing.assert_allclose(
                np.asarray(getattr(batch, name)[i]), np.asarray(getattr(lane, name)),
                rtol=1e-4, atol=atol, err_msg=name,
            )
        assert int(batch.admm_iters[i]) == int(lane.admm_iters)


# --- native build ---------------------------------------------------------------


def test_native_library_is_keyed_on_source_hash():
    import hashlib

    from bunmpc_tpu.native import bindings

    h = hashlib.sha256()
    for src in bindings._SRCS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    path = bindings.lib_path()
    assert os.path.basename(path) == f"libbunmpc_native.{h.hexdigest()[:16]}.so"
    assert bindings.build() == path and os.path.exists(path)


# --- static rules ---------------------------------------------------------------


def _python_files():
    """The tree's Python files, outside hidden directories and build output."""
    skip = {"build", "chiprun_out"}
    files = []
    for d, dirs, fs in os.walk(REPO):
        dirs[:] = [x for x in dirs if not x.startswith(".") and x not in skip]
        files += [os.path.relpath(os.path.join(d, f), REPO) for f in fs if f.endswith(".py")]
    this = os.path.relpath(os.path.abspath(__file__), REPO)
    return [f for f in files if f != this]


RULES = {
    "pallas_tpu_import": re.compile(r"jax\.experimental\.pallas\.tpu|pallas\s+import\s+tpu"),
    "tpu_platform_branch": re.compile(r"""[=!]=\s*["']tpu["']|["']tpu["']\s*[=!]="""),
    "cache_dir_setting": re.compile(r"jax_compilation_cache_dir\"?\s*,"),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_static_rules(rule):
    allowed = {"cache_dir_setting": {os.path.join("bunmpc_tpu", "utils", "runtime.py")}}
    bad = []
    for rel in _python_files():
        if rel in allowed.get(rule, ()):
            continue
        with open(os.path.join(REPO, rel)) as fh:
            for n, line in enumerate(fh, 1):
                if RULES[rule].search(line):
                    bad.append(f"{rel}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)
