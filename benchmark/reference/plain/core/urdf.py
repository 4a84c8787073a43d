"""Go2 model assembly from a URDF or the distilled JSON asset (counterpart
of agility_tpu/core/urdf.py).

Fixed-joint subtrees are merged into their moving parent (composite
inertia), except frames marked `dont_collapse` which stay as massless
reported bodies.  A URDF is parsed into a `ParsedURDF` and serialised to
the asset's plain-JSON schema (`parsed_to_json`); the model is built from
that schema either way.  The asset is the port's own
`assets/go2_model.json`, a byte-for-byte copy of the JAX package's, so both
packages build the same model.
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from benchmark.reference.plain.core.model import CollisionSphere, RobotModel, merge_inertia, rpy_to_mat

GO2_DEFAULT_DOF_POS = {
    "FL_hip_joint": 0.0, "RL_hip_joint": 0.0, "FR_hip_joint": 0.0, "RR_hip_joint": 0.0,
    "FL_thigh_joint": 0.9, "RL_thigh_joint": 0.9, "FR_thigh_joint": 0.9, "RR_thigh_joint": 0.9,
    "FL_calf_joint": -1.8, "RL_calf_joint": -1.8, "FR_calf_joint": -1.8, "RR_calf_joint": -1.8,
}


def default_asset_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                        "go2_model.json")


def _vec(s: Optional[str], default="0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()])


def _origin(el):
    """(xyz, rotation matrix) of an element's <origin>, identity if absent."""
    o = el.find("origin")
    get = (lambda k: None) if o is None else o.get
    return _vec(get("xyz")), rpy_to_mat(_vec(get("rpy")))


class _Link:
    """A URDF <link>: mass, COM and inertia about the COM in the link frame."""

    def __init__(self, el):
        self.name = el.get("name")
        inertial = el.find("inertial")
        if inertial is None:
            self.mass, self.com, self.inertia = 0.0, np.zeros(3), np.zeros((3, 3))
            return
        self.mass = float(inertial.find("mass").get("value"))
        self.com, rot = _origin(inertial)
        I = inertial.find("inertia")
        g = lambda k: float(I.get(k))
        Ib = np.array([[g("ixx"), g("ixy"), g("ixz")], [g("ixy"), g("iyy"), g("iyz")],
                       [g("ixz"), g("iyz"), g("izz")]])
        self.inertia = rot @ Ib @ rot.T


class _Joint:
    """A URDF <joint>; `dont_collapse="true"` keeps a fixed child as a
    reported body."""

    def __init__(self, el):
        self.name, self.type = el.get("name"), el.get("type")
        self.parent = el.find("parent").get("link")
        self.child = el.find("child").get("link")
        self.xyz, self.rot = _origin(el)
        ax = el.find("axis")
        self.axis = _vec(ax.get("xyz")) if ax is not None else np.array([1.0, 0, 0])
        lim = el.find("limit")
        f = lambda k: float(lim.get(k, "0")) if lim is not None else 0.0
        self.lower, self.upper, self.effort, self.velocity = (f("lower"), f("upper"),
                                                              f("effort"), f("velocity"))
        self.dont_collapse = el.get("dont_collapse") == "true"


class ParsedURDF:
    """Links by name and joints in file order; one root link."""

    def __init__(self, links: Dict[str, _Link], joints: List[_Joint]):
        self.links, self.joints = links, joints
        self.children: Dict[str, List[_Joint]] = {}
        for j in joints:
            self.children.setdefault(j.parent, []).append(j)
        roots = [n for n in links if n not in {j.child for j in joints}]
        if len(roots) != 1:
            raise ValueError(f"expected one root link, got {roots}")
        self.root = roots[0]

    def build_model(self, default_dof_pos: Optional[Dict[str, float]] = None) -> RobotModel:
        """Collapse fixed joints into a RobotModel (no collision spheres)."""
        return build_model(parsed_to_json(self), default_dof_pos)


def load_urdf(path: str) -> ParsedURDF:
    root = ET.parse(path).getroot()
    links = {l.name: l for l in (_Link(el) for el in root.findall("link"))}
    return ParsedURDF(links, [_Joint(el) for el in root.findall("joint")])


def parsed_to_json(p: ParsedURDF) -> dict:
    """A parsed robot description in the plain-JSON schema of the model asset
    (tools/extract_go2.py writes it)."""
    return {
        "links": {n: {"mass": l.mass, "com": l.com.tolist(), "inertia": l.inertia.tolist()}
                  for n, l in p.links.items()},
        "joints": [{"name": j.name, "type": j.type, "parent": j.parent, "child": j.child,
                    "xyz": j.xyz.tolist(), "rot": j.rot.tolist(), "axis": j.axis.tolist(),
                    "lower": j.lower, "upper": j.upper, "effort": j.effort,
                    "velocity": j.velocity, "dont_collapse": j.dont_collapse}
                   for j in p.joints],
    }


def parsed_from_json(d: dict) -> ParsedURDF:
    links = {}
    for n, ld in d["links"].items():
        l = _Link.__new__(_Link)
        l.name, l.mass = n, float(ld["mass"])
        l.com, l.inertia = np.array(ld["com"]), np.array(ld["inertia"])
        links[n] = l
    joints = []
    for jd in d["joints"]:
        j = _Joint.__new__(_Joint)
        j.name, j.type, j.parent, j.child = jd["name"], jd["type"], jd["parent"], jd["child"]
        j.xyz, j.rot, j.axis = np.array(jd["xyz"]), np.array(jd["rot"]), np.array(jd["axis"])
        j.lower, j.upper, j.effort, j.velocity = (jd["lower"], jd["upper"], jd["effort"],
                                                  jd["velocity"])
        j.dont_collapse = jd["dont_collapse"]
        joints.append(j)
    return ParsedURDF(links, joints)


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
    (base, 4x hip/thigh/calf/foot), 24 collision spheres.  `source` is a
    .urdf or a distilled .json model asset; by default the packaged
    assets/go2_model.json."""
    source = source or default_asset_path()
    if source.endswith(".json"):
        with open(source) as f:
            d = json.load(f)
    else:
        d = parsed_to_json(load_urdf(source))
    model = build_model(d, GO2_DEFAULT_DOF_POS)
    keep = [i for i, n in enumerate(model.body_names)
            if n == "base" or n[:3] in ("FL_", "FR_", "RL_", "RR_")]
    model.body_names = [model.body_names[i] for i in keep]
    model.body_link = model.body_link[keep]
    model.body_offset = model.body_offset[keep]
    model.spheres = _go2_collision_spheres(model)
    return model
