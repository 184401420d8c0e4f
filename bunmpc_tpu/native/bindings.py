"""ctypes bindings for the native golden solver library.

Builds ``libbunmpc_native.so`` on demand with g++ (pybind11 is not in this
toolchain; the C ABI + ctypes keeps the dependency surface zero). Used by the
test suite to cross-validate the batched JAX kernels against an independent
C++ implementation of the reference solver semantics (SURVEY.md §7.1's
native-parity requirement).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(__file__)
_SRCS = [
    os.path.join(_DIR, "src", "bunmpc_native.cpp"),
    os.path.join(_DIR, "src", "bunmpc_ik.cpp"),
    os.path.join(_DIR, "src", "bunmpc_plan.cpp"),
]
_lib = None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lib_path() -> str:
    """The library's path, named by a hash of the committed sources: a copied
    or stale build of other sources is never loaded, whatever its mtime."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(_DIR, f"libbunmpc_native.{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the shared library unless a build of these sources exists.
    Concurrent builders each write a private file and rename it into place."""
    lib = lib_path()
    if not os.path.exists(lib):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
        os.close(fd)
        try:
            cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *_SRCS, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def _as64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def biconvex_solve(
    cnt,
    r,
    dts,
    m,
    x_init,
    W,
    X_ref,
    W_F,
    rho,
    X_wm,
    F_wm,
    max_admm=100,
    fista_max_iters=150,
    fista_tol=1e-5,
    exit_tol=1e-3,
    beta=1.5,
    L0_x=2.25e6,
    L0_f=506.25,
    mu=1.0,
    x_bounds=None,
):
    """Single biconvex ADMM solve (layouts match mpc/centroidal.py)."""
    lib = load()
    H, ne = np.asarray(cnt).shape
    X = _as64(X_wm).copy()
    F = _as64(F_wm).copy()
    viol = ctypes.c_double()
    iters = ctypes.c_int()
    lb = ub = None
    if x_bounds is not None:
        lb = _as64(np.clip(x_bounds[0], -1e30, 1e30))
        ub = _as64(np.clip(x_bounds[1], -1e30, 1e30))
    lib.bunmpc_biconvex_solve(
        ctypes.c_int(H),
        ctypes.c_int(ne),
        ctypes.c_double(m),
        _dptr(_as64(cnt)),
        _dptr(_as64(r)),
        _dptr(_as64(dts)),
        _dptr(_as64(x_init)),
        _dptr(_as64(W)),
        _dptr(_as64(X_ref)),
        _dptr(_as64(W_F)),
        ctypes.c_double(rho),
        ctypes.c_int(max_admm),
        ctypes.c_int(fista_max_iters),
        ctypes.c_double(fista_tol),
        ctypes.c_double(exit_tol),
        ctypes.c_double(beta),
        ctypes.c_double(L0_x),
        ctypes.c_double(L0_f),
        ctypes.c_double(mu),
        _dptr(lb) if lb is not None else None,
        _dptr(ub) if ub is not None else None,
        _dptr(X),
        _dptr(F),
        ctypes.byref(viol),
        ctypes.byref(iters),
    )
    return X, F, viol.value, iters.value


def _op(name, H, ne, m, cnt, r, dts, a, b, out_shape):
    lib = load()
    out = np.zeros(out_shape)
    getattr(lib, name)(
        ctypes.c_int(H),
        ctypes.c_int(ne),
        ctypes.c_double(m),
        _dptr(_as64(cnt)),
        _dptr(_as64(r)),
        _dptr(_as64(dts)),
        _dptr(_as64(a)),
        *([_dptr(_as64(b))] if b is not None else []),
        _dptr(out),
    )
    return out


def ax_apply(cnt, r, dts, m, X, F):
    H, ne = np.asarray(cnt).shape
    return _op("bunmpc_ax_apply", H, ne, m, cnt, r, dts, X, F, (H + 1, 9))


def af_apply(cnt, r, dts, m, F, X):
    H, ne = np.asarray(cnt).shape
    return _op("bunmpc_af_apply", H, ne, m, cnt, r, dts, F, X, (H + 1, 9))


def bx_vec(cnt, r, dts, m, X):
    H, ne = np.asarray(cnt).shape
    return _op("bunmpc_bx_vec", H, ne, m, cnt, r, dts, X, None, (H + 1, 9))


def bf_vec(cnt, r, dts, m, F, x_init):
    H, ne = np.asarray(cnt).shape
    return _op("bunmpc_bf_vec", H, ne, m, cnt, r, dts, F, x_init, (H + 1, 9))


def soc_project(y, mu):
    lib = load()
    out = _as64(y).copy()
    lib.bunmpc_soc_project(_dptr(out), ctypes.c_int(out.size // 3), ctypes.c_double(mu))
    return out


# --- gait planner twins (reference gait_planner.cpp) ---


def gait_phase(t, period, offset, stance_percent):
    lib = load()
    lib.bunmpc_gait_phase.restype = ctypes.c_int
    return lib.bunmpc_gait_phase(
        ctypes.c_double(t), ctypes.c_double(period), ctypes.c_double(offset),
        ctypes.c_double(stance_percent),
    )


def gait_percent_in_phase(t, period, offset, stance_percent):
    lib = load()
    lib.bunmpc_gait_percent_in_phase.restype = ctypes.c_double
    return lib.bunmpc_gait_percent_in_phase(
        ctypes.c_double(t), ctypes.c_double(period), ctypes.c_double(offset),
        ctypes.c_double(stance_percent),
    )


def gait_contact_plan(t, dt, horizon, period, offsets, stance_percent):
    lib = load()
    offsets = _as64(offsets)
    sp = _as64(stance_percent)
    ne = len(offsets)
    out = np.zeros((horizon, ne), np.int32)
    per = np.array([period], np.float64)
    lib.bunmpc_gait_contact_plan(
        ctypes.c_double(t), ctypes.c_double(dt), ctypes.c_int(horizon), ctypes.c_int(ne),
        _dptr(per), _dptr(offsets), _dptr(sp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out


# --- kinematic GN-DDP IK twin + chained kino-dyn solve (bunmpc_ik.cpp) ---


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _model_args(model, eff_frames):
    """Flatten a robots.model.RobotModel into the C-ABI argument tuple."""
    parent = np.ascontiguousarray(model.parent, dtype=np.int32)
    jrot = _as64(model.joint_rot)
    jpos = _as64(model.joint_pos)
    axis = _as64(model.axis)
    mass = _as64(model.mass)
    bcom = _as64(model.com)
    inertia = _as64(model.inertia)
    eff_body = np.ascontiguousarray(
        [model.frames[n].body for n in eff_frames], dtype=np.int32
    )
    eff_pos = _as64(np.stack([model.frames[n].pos for n in eff_frames]))
    keep = (parent, jrot, jpos, axis, mass, bcom, inertia, eff_body, eff_pos)
    args = (
        ctypes.c_int(model.n_joints), _iptr(parent), _dptr(jrot), _dptr(jpos),
        _dptr(axis), _dptr(mass), _dptr(bcom), _dptr(inertia),
        ctypes.c_int(len(eff_frames)), _iptr(eff_body), _dptr(eff_pos),
    )
    return args, keep


def centroidal_state(model, eff_frames, q, v):
    """(com, h(6), ee (ne,3)) — golden twin of kin.centroidal_state_and_frames."""
    lib = load()
    margs, keep = _model_args(model, eff_frames)
    com = np.zeros(3)
    h = np.zeros(6)
    ee = np.zeros((len(eff_frames), 3))
    lib.bunmpc_centroidal_state(
        *margs, _dptr(_as64(q)), _dptr(_as64(v)), _dptr(com), _dptr(h), _dptr(ee)
    )
    return com, h, ee


def ik_solve(
    model, eff_frames, x0, dts, ee_targets, ee_wts, com_ref, mom_ref,
    com_wt, mom_wt, w_sd, x_reg, ctrl_w,
    n_iters=6, alphas=(1.0, 0.7, 0.3, 0.1, 0.03), reg=1e-9,
):
    """Kinematic GN-DDP solve (FD-Jacobian golden twin of mpc/ik.solve_ik).

    ``w_sd`` (H+1, 2nv) and ``ctrl_w`` (H, nv) are the fully-scaled dense
    weights (ik.dense_weights layout: reg_wt * state_wt / reg_wt * ctrl_wt).
    """
    lib = load()
    margs, keep = _model_args(model, eff_frames)
    H = len(dts)
    nx = model.nq + model.nv
    xs = np.zeros((H + 1, nx))
    us = np.zeros((H, model.nv))
    cost = ctypes.c_double()
    al = _as64(alphas)
    lib.bunmpc_ik_solve(
        *margs,
        ctypes.c_int(H), _dptr(_as64(dts)), _dptr(_as64(ee_targets)),
        _dptr(_as64(ee_wts)), _dptr(_as64(com_ref)), _dptr(_as64(mom_ref)),
        ctypes.c_double(float(com_wt)), ctypes.c_double(float(mom_wt)),
        _dptr(_as64(w_sd)), _dptr(_as64(x_reg)), _dptr(_as64(ctrl_w)),
        ctypes.c_int(n_iters), _dptr(al), ctypes.c_int(len(al)),
        ctypes.c_double(reg),
        _dptr(_as64(x0)), _dptr(xs), _dptr(us), ctypes.byref(cost),
    )
    return xs, us, cost.value


def kinodyn_solve(
    model, eff_frames, m_total,
    # dynamics problem
    cnt, r, dts, x_init, W, X_ref, W_F, rho, X_wm, F_wm,
    # IK problem (com/mom refs come from the ADMM solution)
    ik_dts, ee_targets, ee_wts, com_wt, mom_wt, w_sd, x_reg, ctrl_w, x0,
    max_admm=100, fista_max_iters=150, fista_tol=1e-5, exit_tol=1e-3,
    beta=1.5, L0_x=2.25e6, L0_f=506.25, mu=1.0, x_bounds=None,
    n_iters=6, alphas=(1.0, 0.7, 0.3, 0.1, 0.03), reg=1e-9,
):
    """Full native kino-dynamic solve: ADMM -> IK (reference
    KinoDynMP::optimize, kino_dyn.cpp:39-58)."""
    lib = load()
    margs, keep = _model_args(model, eff_frames)
    H, ne = np.asarray(cnt).shape
    ik_h = len(ik_dts)
    nx = model.nq + model.nv
    X = _as64(X_wm).copy()
    F = _as64(F_wm).copy()
    xs = np.zeros((ik_h + 1, nx))
    us = np.zeros((ik_h, model.nv))
    viol = ctypes.c_double()
    iters = ctypes.c_int()
    cost = ctypes.c_double()
    lb = ub = None
    if x_bounds is not None:
        lb = _as64(np.clip(x_bounds[0], -1e30, 1e30))
        ub = _as64(np.clip(x_bounds[1], -1e30, 1e30))
    al = _as64(alphas)
    lib.bunmpc_kinodyn_solve(
        *margs, ctypes.c_double(float(m_total)),
        ctypes.c_int(H), _dptr(_as64(cnt)), _dptr(_as64(r)), _dptr(_as64(dts)),
        _dptr(_as64(x_init)), _dptr(_as64(W)), _dptr(_as64(X_ref)),
        _dptr(_as64(W_F)), ctypes.c_double(float(rho)), ctypes.c_int(max_admm),
        ctypes.c_int(fista_max_iters), ctypes.c_double(fista_tol),
        ctypes.c_double(exit_tol), ctypes.c_double(beta),
        ctypes.c_double(L0_x), ctypes.c_double(L0_f), ctypes.c_double(mu),
        _dptr(lb) if lb is not None else None,
        _dptr(ub) if ub is not None else None,
        ctypes.c_int(ik_h), _dptr(_as64(ik_dts)), _dptr(_as64(ee_targets)),
        _dptr(_as64(ee_wts)), ctypes.c_double(float(com_wt)),
        ctypes.c_double(float(mom_wt)), _dptr(_as64(w_sd)),
        _dptr(_as64(x_reg)), _dptr(_as64(ctrl_w)),
        ctypes.c_int(n_iters), _dptr(al), ctypes.c_int(len(al)),
        ctypes.c_double(reg),
        _dptr(_as64(x0)), _dptr(X), _dptr(F),
        ctypes.byref(viol), ctypes.byref(iters),
        _dptr(xs), _dptr(us), ctypes.byref(cost),
    )
    return dict(X=X, F=F, viol=viol.value, admm_iters=iters.value,
                xs=xs, us=us, ik_cost=cost.value)


def prepare_problem(
    model, eff_frames, hip_frames, q0, params,
    q, v, t, v_des, w_des,
    use_hip_nudges=True, foot_size=0.018, round3=True, y_anchor=0.0,
    bx=0.45, by=0.45, bz=0.45, ik_hor=None,
):
    """Full problem assembly from raw (q, v, t, v_des, w_des) — independent
    C++ twin of the reference create_cnt_plan + create_costs chain
    (abstract_cyclic_gen.py:159-414, :532-614; src/motion_planner/
    biconvex.cpp:27-57). ``params`` is a BiconvexMotionParams. Returns a dict
    with the contact plan, cost tables, bounds, and IK ee task arrays."""
    lib = load()
    margs, keep = _model_args(model, eff_frames)
    hip_body = np.ascontiguousarray(
        [model.frames[n].body for n in hip_frames], dtype=np.int32
    )
    hip_pos = _as64(np.stack([model.frames[n].pos for n in hip_frames]))
    ne = len(eff_frames)
    H = params.horizon
    if ik_hor is None:
        ik_hor = params.ik_horizon(0.5)
    cnt = np.zeros((H, ne))
    r = np.zeros((H, ne, 3))
    dts = np.zeros(H)
    x_init = np.zeros(9)
    W = np.zeros((H + 1, 9))
    X_ref = np.zeros((H + 1, 9))
    W_F = np.zeros((H, ne, 3))
    lb_x = np.zeros((H + 1, 9))
    ub_x = np.zeros((H + 1, 9))
    ee_wts = np.zeros((ik_hor, ne))
    ee_targets = np.zeros((ik_hor, ne, 3))
    lib.bunmpc_prepare_problem(
        *margs,
        _iptr(hip_body), _dptr(hip_pos), _dptr(_as64(q0)),
        ctypes.c_int(1 if use_hip_nudges else 0),
        ctypes.c_double(foot_size),
        ctypes.c_double(params.gait_period), ctypes.c_double(params.gait_dt),
        _dptr(_as64(params.stance_percent)), _dptr(_as64(params.phase_offset)),
        ctypes.c_double(params.step_ht), ctypes.c_double(params.nom_ht),
        ctypes.c_double(params.gait_horizon),
        _dptr(_as64(params.W_X)), _dptr(_as64(params.W_X_ter)),
        _dptr(_as64(params.W_F)), _dptr(_as64(params.ori_correction)),
        ctypes.c_double(params.swing_wt[0]), ctypes.c_double(params.swing_wt[1]),
        ctypes.c_double(bx), ctypes.c_double(by), ctypes.c_double(bz),
        ctypes.c_int(H), ctypes.c_int(ik_hor), ctypes.c_int(1 if round3 else 0),
        ctypes.c_double(float(y_anchor)),
        _dptr(_as64(q)), _dptr(_as64(v)), ctypes.c_double(float(t)),
        _dptr(_as64(v_des)), ctypes.c_double(float(w_des)),
        _dptr(cnt), _dptr(r), _dptr(dts), _dptr(x_init), _dptr(W),
        _dptr(X_ref), _dptr(W_F), _dptr(lb_x), _dptr(ub_x),
        _dptr(ee_wts), _dptr(ee_targets),
    )
    return dict(
        cnt=cnt, r=r, dts=dts, x_init=x_init, W=W, X_ref=X_ref, W_F=W_F,
        lb_x=lb_x, ub_x=ub_x, ee_wts=ee_wts, ee_targets=ee_targets,
    )


def solve_raw(model, eff_frames, hip_frames, q0, params, q, v, t, v_des, w_des,
              max_admm=4000, exit_tol=1e-6, n_iters=6):
    """Fully native chain from raw (q, v, t, v_des, w_des): prepare_problem ->
    ADMM -> IK (kinodyn_solve), with no JAX-assembled input anywhere.

    Matches the JAX layer's documented choices: unrounded contact locations,
    the CoM-y anchor of X_nom, the reference's cold start (centroidal state
    tiled, zero forces; the solo family's "tiled" warm start) and
    regularization towards [q0, 0]. Returns kinodyn_solve's dict."""
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    q0 = np.asarray(q0, np.float64)
    q_reset = q.copy()
    q_reset[0:2] = 0.0  # origin reset (abstract_cyclic_gen.py:632-633)
    com, _, _ = centroidal_state(model, eff_frames, q_reset, v)
    p = prepare_problem(
        model, eff_frames, hip_frames, q0, params, q, v, t, np.asarray(v_des), w_des,
        round3=False, y_anchor=float(com[1]),
    )
    nv = model.nv
    H, ne = p["cnt"].shape
    ik_h = p["ee_wts"].shape[0]
    w_sd = np.tile(params.reg_wt[0] * np.asarray(params.state_wt, np.float64), (ik_h + 1, 1))
    ctrl_w = np.tile(params.reg_wt[1] * np.asarray(params.ctrl_wt, np.float64), (ik_h, 1))
    # (ik_h+1, nq+nv): the native IK reads one regularization target per knot
    x_reg = np.tile(np.concatenate([q0, np.zeros(nv)]), (ik_h + 1, 1))
    return kinodyn_solve(
        model, eff_frames, model.total_mass,
        p["cnt"], p["r"], p["dts"], p["x_init"], p["W"], p["X_ref"], p["W_F"],
        params.rho, np.tile(p["x_init"], (H + 1, 1)), np.zeros((H, ne, 3)),
        p["dts"][:ik_h], p["ee_targets"], p["ee_wts"],
        float(params.cent_wt[0]), float(params.cent_wt[1]),
        w_sd, x_reg, ctrl_w, np.concatenate([q_reset, v]),
        max_admm=max_admm, exit_tol=exit_tol, n_iters=n_iters,
        x_bounds=(p["lb_x"], p["ub_x"]),
    )
