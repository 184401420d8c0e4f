"""Minimal URDF parser producing :class:`RobotModel` constants.

JAX stand-in for ``pinocchio.urdf.buildModel(..., JointModelFreeFlyer())``
(reference: src/motion_planner/kino_dyn.cpp:9). Parsing happens once on the
host; the result is a static pytree of numpy constants, so nothing here runs
inside jit.

Supported subset (all the reference robots need):
* ``revolute`` / ``continuous`` joints -> moving joints,
* ``fixed`` joints -> welded: child inertia composited into the parent moving
  body, child link recorded as a named frame (feet),
* ``<inertial>`` with origin xyz/rpy, mass, full inertia tensor,
* ``<limit>`` effort/velocity/lower/upper.

Joints are created in depth-first URDF tree order, which reproduces
Pinocchio's joint ordering for the star-topology quadrupeds (4 serial legs),
so ``q``/``v`` vectors are interchangeable with the reference's.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from .model import Frame, RobotModel, compose_inertia, transform_inertia


def _parse_origin(elem):
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if elem is not None:
        origin = elem.find("origin")
        if origin is not None:
            if origin.get("xyz"):
                xyz = np.array([float(x) for x in origin.get("xyz").split()])
            if origin.get("rpy"):
                rpy = np.array([float(x) for x in origin.get("rpy").split()])
    return xyz, rpy


def _rpy_to_rot(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_inertial(link):
    inertial = link.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    xyz, rpy = _parse_origin(inertial)
    R = _rpy_to_rot(rpy)
    mass = float(inertial.find("mass").get("value"))
    ie = inertial.find("inertia")
    ixx = float(ie.get("ixx", 0))
    iyy = float(ie.get("iyy", 0))
    izz = float(ie.get("izz", 0))
    ixy = float(ie.get("ixy", 0))
    ixz = float(ie.get("ixz", 0))
    iyz = float(ie.get("iyz", 0))
    I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # inertia is given in the (possibly rotated) inertial frame about the CoM
    I = R @ I_local @ R.T
    return mass, xyz, I


class _Joint:
    def __init__(self, elem):
        self.name = elem.get("name")
        self.type = elem.get("type")
        self.parent_link = elem.find("parent").get("link")
        self.child_link = elem.find("child").get("link")
        xyz, rpy = _parse_origin(elem)
        self.pos = xyz
        self.rot = _rpy_to_rot(rpy)
        axis = elem.find("axis")
        self.axis = (
            np.array([float(x) for x in axis.get("xyz").split()])
            if axis is not None
            else np.array([1.0, 0.0, 0.0])
        )
        limit = elem.find("limit")
        self.lower = float(limit.get("lower", "-inf")) if limit is not None else -np.inf
        self.upper = float(limit.get("upper", "inf")) if limit is not None else np.inf
        self.velocity = float(limit.get("velocity", "inf")) if limit is not None else np.inf
        self.effort = float(limit.get("effort", "inf")) if limit is not None else np.inf


def build_model(urdf_path: str, name: str | None = None, root_link: str | None = None) -> RobotModel:
    tree = ET.parse(urdf_path)
    robot = tree.getroot()

    links = {link.get("name"): link for link in robot.findall("link")}
    joints = [_Joint(j) for j in robot.findall("joint")]
    children: Dict[str, List[_Joint]] = {}
    child_links = set()
    for j in joints:
        children.setdefault(j.parent_link, []).append(j)
        child_links.add(j.child_link)

    if root_link is None:
        roots = [ln for ln in links if ln not in child_links]
        if len(roots) != 1:
            raise ValueError(f"expected one root link, found {roots}")
        root_link = roots[0]

    parent: List[int] = []
    joint_rot: List[np.ndarray] = []
    joint_pos: List[np.ndarray] = []
    axis: List[np.ndarray] = []
    joint_names: List[str] = []
    limits: List[tuple] = []
    masses: List[float] = []
    coms: List[np.ndarray] = []
    inertias: List[np.ndarray] = []
    frames: Dict[str, Frame] = {}

    def weld_subtree(link_name: str, body: int, R_bl: np.ndarray, p_bl: np.ndarray):
        """Merge ``link_name`` (posed at (R_bl, p_bl) in body coords) into ``body``
        and recurse through its fixed children; spawn moving joints for the rest."""
        frames[link_name] = Frame(body=body, rot=R_bl.copy(), pos=p_bl.copy())
        m, c, I = _parse_inertial(links[link_name])
        m, c, I = transform_inertia(R_bl, p_bl, m, c, I)
        masses[body], coms[body], inertias[body] = compose_inertia(
            masses[body], coms[body], inertias[body], m, c, I
        )
        for j in children.get(link_name, []):
            R_j = R_bl @ j.rot
            p_j = p_bl + R_bl @ j.pos
            if j.type == "fixed":
                weld_subtree(j.child_link, body, R_j, p_j)
            elif j.type in ("revolute", "continuous"):
                spawn_joint(j, body, R_j, p_j)
            else:
                raise NotImplementedError(f"joint type {j.type!r} ({j.name})")

    def spawn_joint(j: _Joint, parent_body: int, R_pj: np.ndarray, p_pj: np.ndarray):
        parent.append(parent_body)
        joint_rot.append(R_pj)
        joint_pos.append(p_pj)
        axis.append(j.axis / np.linalg.norm(j.axis))
        joint_names.append(j.name)
        limits.append((j.lower, j.upper, j.velocity, j.effort))
        child_body = add_body_placeholder()
        weld_subtree(j.child_link, child_body, np.eye(3), np.zeros(3))

    def add_body_placeholder() -> int:
        body = len(masses)
        masses.append(0.0)
        coms.append(np.zeros(3))
        inertias.append(np.zeros((3, 3)))
        return body

    # root body (floating base)
    add_body_placeholder()
    weld_subtree(root_link, 0, np.eye(3), np.zeros(3))

    # joint frames (pinocchio exposes operational frames for joints too; the
    # reference reads hip positions via e.g. the "FL_HFE" frame,
    # abstract_cyclic_gen.py:55): joint j's frame == child body j+1's origin
    for j, jn in enumerate(joint_names):
        frames.setdefault(jn, Frame(body=j + 1, rot=np.eye(3), pos=np.zeros(3)))

    limits_arr = np.array(limits) if limits else np.zeros((0, 4))
    return RobotModel(
        name=name or robot.get("name", "robot"),
        n_joints=len(joint_names),
        parent=np.array(parent, dtype=np.int32),
        joint_rot=np.stack(joint_rot) if joint_rot else np.zeros((0, 3, 3)),
        joint_pos=np.stack(joint_pos) if joint_pos else np.zeros((0, 3)),
        axis=np.stack(axis) if axis else np.zeros((0, 3)),
        mass=np.array(masses),
        com=np.stack(coms),
        inertia=np.stack(inertias),
        joint_names=tuple(joint_names),
        frames=frames,
        joint_lower=limits_arr[:, 0],
        joint_upper=limits_arr[:, 1],
        velocity_limit=limits_arr[:, 2],
        effort_limit=limits_arr[:, 3],
    )
