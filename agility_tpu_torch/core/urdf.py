"""Go2 model assembly from the distilled JSON asset (counterpart of
agility_tpu/core/urdf.py, JSON path only).

Fixed-joint subtrees are merged into their moving parent (composite
inertia), except frames marked `dont_collapse` which stay as massless
reported bodies.  The asset is the port's own `assets/go2_model.json`, a
byte-for-byte copy of the JAX package's, so both packages build the same
model.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from agility_tpu_torch.core.model import CollisionSphere, RobotModel, merge_inertia

GO2_DEFAULT_DOF_POS = {
    "FL_hip_joint": 0.0, "RL_hip_joint": 0.0, "FR_hip_joint": 0.0, "RR_hip_joint": 0.0,
    "FL_thigh_joint": 0.9, "RL_thigh_joint": 0.9, "FR_thigh_joint": 0.9, "RR_thigh_joint": 0.9,
    "FL_calf_joint": -1.8, "RL_calf_joint": -1.8, "FR_calf_joint": -1.8, "RR_calf_joint": -1.8,
}


def default_asset_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                        "go2_model.json")


def build_model(d: dict, default_dof_pos=None) -> RobotModel:
    """Collapse fixed joints of a parsed JSON description into a RobotModel
    (no collision spheres)."""
    links = {n: dict(mass=float(l["mass"]), com=np.array(l["com"]),
                     inertia=np.array(l["inertia"])) for n, l in d["links"].items()}
    joints = d["joints"]
    children = {}
    for j in joints:
        children.setdefault(j["parent"], []).append(j)
    roots = [n for n in links if n not in {j["child"] for j in joints}]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, got {roots}")

    names, parents, jpos, jrot, jaxis = [], [], [], [], []
    masses, coms, inertias = [], [], []
    dof_names, dof_link, limits = [], [], []
    body_names, body_link, body_offset = [], [], []

    def add_moving(name, parent_idx, p, R, axis):
        idx = len(names)
        names.append(name)
        parents.append(parent_idx)
        jpos.append(p)
        jrot.append(R)
        jaxis.append(axis)
        masses.append(links[name]["mass"])
        coms.append(links[name]["com"].copy())
        inertias.append(links[name]["inertia"].copy())
        body_names.append(name)
        body_link.append(idx)
        body_offset.append(np.zeros(3))
        return idx

    def visit(link, moving_idx, fp, fR):
        for j in children.get(link, []):
            xyz, rot = np.array(j["xyz"]), np.array(j["rot"])
            if j["type"] in ("revolute", "continuous", "prismatic"):
                child = add_moving(j["child"], moving_idx, fp + fR @ xyz, fR @ rot,
                                   np.array(j["axis"]))
                dof_names.append(j["name"])
                dof_link.append(child)
                limits.append([j["lower"], j["upper"], j["effort"], j["velocity"]])
                visit(j["child"], child, np.zeros(3), np.eye(3))
            elif j["type"] == "fixed":
                cp, cR = fp + fR @ xyz, fR @ rot
                cl = links[j["child"]]
                if cl["mass"] > 0:
                    m, c, I = merge_inertia(
                        masses[moving_idx], coms[moving_idx], inertias[moving_idx],
                        cl["mass"], cp + cR @ cl["com"], cR @ cl["inertia"] @ cR.T)
                    masses[moving_idx], coms[moving_idx], inertias[moving_idx] = m, c, I
                if j["dont_collapse"]:
                    body_names.append(j["child"])
                    body_link.append(moving_idx)
                    body_offset.append(cp)
                visit(j["child"], moving_idx, cp, cR)
            else:
                raise ValueError(f"unsupported joint type {j['type']}")

    add_moving(roots[0], -1, np.zeros(3), np.eye(3), np.zeros(3))
    visit(roots[0], 0, np.zeros(3), np.eye(3))

    lim = np.array(limits)
    nu, L = len(dof_names), len(names)
    ancestors = np.zeros((L, nu), bool)
    for dof in range(nu):
        for i in range(L):
            k = i
            while k != -1:
                if k == dof_link[dof]:
                    ancestors[i, dof] = True
                    break
                k = parents[k]
    ddp = np.array([(default_dof_pos or {}).get(n, 0.0) for n in dof_names])
    return RobotModel(
        link_names=names, parent=np.array(parents, np.int32),
        joint_pos=np.stack(jpos), joint_rot=np.stack(jrot), joint_axis=np.stack(jaxis),
        link_mass=np.array(masses), link_com=np.stack(coms),
        link_inertia=np.stack(inertias), dof_names=dof_names,
        dof_link=np.array(dof_link, np.int32),
        dof_limit_lower=lim[:, 0], dof_limit_upper=lim[:, 1],
        dof_effort_limit=lim[:, 2], dof_velocity_limit=lim[:, 3],
        default_dof_pos=ddp, body_names=body_names,
        body_link=np.array(body_link, np.int32), body_offset=np.stack(body_offset),
        spheres=[], ancestors=ancestors)


def _go2_collision_spheres(model: RobotModel) -> List[CollisionSphere]:
    """Sphere decomposition of the Go2 collision primitives (base box as 3
    spheres + head; per leg hip, thigh, two calf and one foot sphere)."""
    spheres: List[CollisionSphere] = []
    li = {n: i for i, n in enumerate(model.link_names)}
    bi = {n: i for i, n in enumerate(model.body_names)}

    def add(link, body, off, r, name):
        spheres.append(CollisionSphere(li[link], bi[body], np.array(off, float), r, name))

    for k, x in enumerate((-0.13, 0.0, 0.13)):
        add("base", "base", (x, 0.0, 0.0), 0.057, f"base_{k}")
    add("base", "base", (0.293, 0.0, -0.06), 0.047, "head")
    for leg in ("FL", "FR", "RL", "RR"):
        ys = 1.0 if leg in ("FL", "RL") else -1.0
        add(f"{leg}_hip", f"{leg}_hip", (0.0, 0.08 * ys, 0.0), 0.046, f"{leg}_hip")
        add(f"{leg}_thigh", f"{leg}_thigh", (0.0, 0.0, -0.1065), 0.034, f"{leg}_thigh")
        add(f"{leg}_calf", f"{leg}_calf", (0.008, 0.0, -0.06), 0.013, f"{leg}_calf_u")
        add(f"{leg}_calf", f"{leg}_calf", (0.016, 0.0, -0.15), 0.016, f"{leg}_calf_l")
        add(f"{leg}_calf", f"{leg}_foot", (-0.002, 0.0, -0.213), 0.022, f"{leg}_foot")
    return spheres


def build_go2_model(source: Optional[str] = None) -> RobotModel:
    """The Go2 RobotModel: 13 moving links, 12 dofs, 17 reported bodies
    (base, 4x hip/thigh/calf/foot), 24 collision spheres."""
    with open(source or default_asset_path()) as f:
        model = build_model(json.load(f), GO2_DEFAULT_DOF_POS)
    keep = [i for i, n in enumerate(model.body_names)
            if n == "base" or n[:3] in ("FL_", "FR_", "RL_", "RR_")]
    model.body_names = [model.body_names[i] for i in keep]
    model.body_link = model.body_link[keep]
    model.body_offset = model.body_offset[keep]
    model.spheres = _go2_collision_spheres(model)
    return model
