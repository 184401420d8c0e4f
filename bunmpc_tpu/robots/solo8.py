"""Solo8 robot description (JAX twin of the reference's Solo8 support:
robot_properties_solo/src/robot_properties_solo/solo8wrapper.py,
config.py:73-138, and the xacro sources solo8.urdf.xacro + leg.xacro).

The reference ships no pre-generated solo8 URDF (resources/pre_generated_urdf/
is empty), so — like Go2 — the model is built programmatically from the xacro
constants: base + 4 legs x (HFE, KFE), i.e. the ``has_side_motion=false``
branch of the leg macro (leg.xacro:187-232): each hip flexion joint mounts
directly on the base at (±base_2_HFE_x, ±base_2_HFE_y, 0) and the foot is a
massless fixed frame on the lower leg.
"""

from __future__ import annotations

import os

import numpy as np

from .assets_io import load_model
from .model import Frame, RobotModel

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "solo8_model.npz")

# --- xacro constants (leg.xacro:7-20, solo8.urdf.xacro:18-23) ---
_BASE_2_HFE_X = 0.1946
_BASE_2_HFE_Y = 0.1015
_HFE_2_KFE_Y = 0.03745
_HFE_2_KFE_Z = 0.160
_KFE_2_FOOT_Y = 0.009
_KFE_2_FOOT_Z = 0.160

_BASE = dict(
    mass=1.43315091,
    com=np.zeros(3),
    I=np.diag([0.00578574, 0.01938108, 0.02476124]),
)
# left-side link inertials (leg.xacro upper/lower leg blocks); the right side
# mirrors com x/y (and the xz/yz products of inertia) via _mirror below
_UPPER = dict(
    mass=0.14737324,
    com=np.array([0.00001530, 0.01767640, -0.07838230]),
    I=np.array(
        [
            [0.00041540, 0.0, 0.00000010],
            [0.0, 0.00041637, -0.00004589],
            [0.00000010, -0.00004589, 0.00002982],
        ]
    ),
)
_LOWER = dict(
    mass=0.02318294,
    com=np.array([0.0, 0.00776716, -0.07003876]),
    I=np.array(
        [
            [0.00008508, 0.0, 0.0],
            [0.0, 0.00008580, -0.00000200],
            [0.0, -0.00000200, 0.00000139],
        ]
    ),
)

# (leg, front/hind sign, left/right sign) in the solo12 asset's leg order
_LEGS = [("FL", 1, 1), ("FR", 1, -1), ("HL", -1, 1), ("HR", -1, -1)]


def _mirror(base: dict, side: int):
    """Right legs mirror the left-side inertial: com x/y and the xz/yz
    inertia products flip sign (a 180-deg yaw of the left-side inertial,
    matching leg.xacro's right-side blocks; Ixy is untouched)."""
    com = base["com"] * np.array([side, side, 1.0])
    signs = np.array([[1, 1, side], [1, 1, side], [side, side, 1]])
    return base["mass"], com, base["I"] * signs


def build_solo8_model() -> RobotModel:
    parent, joint_rot, joint_pos, axis, names = [], [], [], [], []
    masses = [_BASE["mass"]]
    coms = [_BASE["com"].copy()]
    inertias = [_BASE["I"].copy()]
    frames = {}
    eye = np.eye(3)

    for leg, fh, side in _LEGS:
        upper_body = len(masses)
        parent.append(0)
        joint_rot.append(eye.copy())
        joint_pos.append(np.array([fh * _BASE_2_HFE_X, side * _BASE_2_HFE_Y, 0.0]))
        axis.append(np.array([0.0, 1.0, 0.0]))
        names.append(f"{leg}_HFE")
        m, c, I = _mirror(_UPPER, side)
        masses.append(m)
        coms.append(c)
        inertias.append(I)
        frames[f"{leg}_HFE"] = Frame(body=upper_body, rot=eye.copy(), pos=np.zeros(3))

        lower_body = len(masses)
        parent.append(upper_body)
        joint_rot.append(eye.copy())
        joint_pos.append(np.array([0.0, side * _HFE_2_KFE_Y, -_HFE_2_KFE_Z]))
        axis.append(np.array([0.0, 1.0, 0.0]))
        names.append(f"{leg}_KFE")
        m, c, I = _mirror(_LOWER, side)
        masses.append(m)
        coms.append(c)
        inertias.append(I)
        # massless foot frame (leg.xacro ANKLE fixed joint)
        frames[f"{leg}_FOOT"] = Frame(
            body=lower_body,
            rot=eye.copy(),
            pos=np.array([0.0, side * _KFE_2_FOOT_Y, -_KFE_2_FOOT_Z]),
        )

    nj = len(names)
    return RobotModel(
        name="solo8",
        n_joints=nj,
        parent=np.array(parent, np.int32),
        joint_rot=np.stack(joint_rot),
        joint_pos=np.stack(joint_pos),
        axis=np.stack(axis),
        mass=np.array(masses),
        com=np.stack(coms),
        inertia=np.stack(inertias),
        joint_names=tuple(names),
        frames=frames,
        # URDF placeholder limits (leg.xacro revolute blocks: ±10 rad,
        # 1000 N m, 1000 rad/s — the real robot enforces its own)
        joint_lower=np.full(nj, -10.0),
        joint_upper=np.full(nj, 10.0),
        velocity_limit=np.full(nj, 1000.0),
        effort_limit=np.full(nj, 1000.0),
    )


class Solo8Config:
    name = "solo8"
    eff_names = ["FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"]
    # no HAA: the Raibert hip frames are the HFE joints on the base
    hip_names = ["FL_HFE", "FR_HFE", "HL_HFE", "HR_HFE"]
    n_eff = 4
    foot_size = 0.018

    # reference config.py:129 (x offset and 0.4 m height kept verbatim)
    initial_configuration = np.array(
        [0.2, 0.0, 0.4, 0.0, 0.0, 0.0, 1.0] + [0.8, -1.6] * 4
    )

    _model: RobotModel | None = None

    @classmethod
    def load_model(cls) -> RobotModel:
        if cls._model is None:
            if os.path.exists(_ASSET):
                cls._model = load_model(_ASSET)
            else:
                cls._model = build_solo8_model()
        return cls._model

    @classmethod
    def q0(cls) -> np.ndarray:
        return cls.initial_configuration.copy()

    @classmethod
    def v0(cls) -> np.ndarray:
        return np.zeros(cls.load_model().nv)
