"""The port's URDF loading (core/urdf.py, tools/extract_go2.py) vs the JAX
package's.

The repo ships no URDF, so the tests write their own: a small hand-made
robot (inertial and joint origins with rpy, a fixed child with mass merged
into its moving parent, a `dont_collapse` frame, a joint without limits) and
the Go2 written back out from the packaged JSON asset.  Parsing, the JSON
schema and the collapsed model are plain float64 numpy on both sides, in the
same order, so they are compared exactly; the Go2 built from its URDF
against the one built from the asset at 1e-12 (the asset's rotation
matrices pass through rpy angles).
"""
import json
import subprocess
import sys

import numpy as np
import pytest

from agility_tpu.core import urdf as jurdf
from agility_tpu_torch.core import urdf as turdf

SMALL = """<robot name="r">
  <link name="base"><inertial><origin xyz="0.01 0 -0.02" rpy="0.1 0.2 0.3"/><mass value="5"/>
    <inertia ixx="0.1" ixy="0.01" ixz="0" iyy="0.2" iyz="0.02" izz="0.3"/></inertial></link>
  <link name="imu"><inertial><origin xyz="0 0.01 0"/><mass value="0.2"/>
    <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.002"/></inertial></link>
  <link name="hip"><inertial><origin xyz="0 0.05 0" rpy="0 0 0.5"/><mass value="0.7"/>
    <inertia ixx="0.002" ixy="0" ixz="0.0001" iyy="0.003" iyz="0" izz="0.001"/></inertial></link>
  <link name="calf"><inertial><mass value="0.3"/>
    <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.0005"/></inertial></link>
  <link name="foot"/>
  <joint name="imu_joint" type="fixed"><parent link="base"/><child link="imu"/>
    <origin xyz="0.1 0 0.05" rpy="0 0.3 0"/></joint>
  <joint name="hip_joint" type="revolute"><parent link="base"/><child link="hip"/>
    <origin xyz="0.2 0.05 0" rpy="0.1 0 0"/><axis xyz="1 0 0"/>
    <limit lower="-1.0" upper="1.0" effort="23.7" velocity="30.1"/></joint>
  <joint name="calf_joint" type="continuous"><parent link="hip"/><child link="calf"/>
    <origin xyz="0 0 -0.2"/><axis xyz="0 1 0"/></joint>
  <joint name="foot_joint" type="fixed" dont_collapse="true"><parent link="calf"/>
    <child link="foot"/><origin xyz="0 0 -0.21"/></joint>
</robot>
"""


def _rpy(R):
    """rpy angles of R = Rz(y) Ry(p) Rx(r)."""
    return (np.arctan2(R[2, 1], R[2, 2]), -np.arcsin(np.clip(R[2, 0], -1, 1)),
            np.arctan2(R[1, 0], R[0, 0]))


def write_urdf(d, path):
    """A URDF of the model asset's JSON schema (inertia already in the link frame)."""
    f = lambda v: " ".join(repr(float(x)) for x in v)
    out = ['<robot name="go2">']
    for n, l in d["links"].items():
        I = l["inertia"]
        out.append(f'<link name="{n}"><inertial><origin xyz="{f(l["com"])}"/>'
                   f'<mass value="{l["mass"]!r}"/><inertia ixx="{I[0][0]!r}" ixy="{I[0][1]!r}" '
                   f'ixz="{I[0][2]!r}" iyy="{I[1][1]!r}" iyz="{I[1][2]!r}" izz="{I[2][2]!r}"/>'
                   '</inertial></link>')
    for j in d["joints"]:
        dc = ' dont_collapse="true"' if j["dont_collapse"] else ""
        out.append(f'<joint name="{j["name"]}" type="{j["type"]}"{dc}>'
                   f'<parent link="{j["parent"]}"/><child link="{j["child"]}"/><origin xyz="{f(j["xyz"])}" '
                   f'rpy="{f(_rpy(np.array(j["rot"])))}"/><axis xyz="{f(j["axis"])}"/>'
                   f'<limit lower="{j["lower"]!r}" upper="{j["upper"]!r}" '
                   f'effort="{j["effort"]!r}" velocity="{j["velocity"]!r}"/></joint>')
    out.append("</robot>")
    with open(path, "w") as fh:
        fh.write("\n".join(out))


def _model_equal(got, want, atol=0.0):
    for k, v in vars(want).items():
        if k == "spheres":
            assert len(got.spheres) == len(v)
            for a, b in zip(got.spheres, v):
                assert (a.link, a.body, a.radius, a.name) == (b.link, b.body, b.radius, b.name)
                np.testing.assert_array_equal(a.offset, b.offset)
        elif isinstance(v, np.ndarray):
            np.testing.assert_allclose(getattr(got, k), v, rtol=0, atol=atol, err_msg=k)
        else:
            assert getattr(got, k) == v, k


def test_parse_and_build_match(tmp_path):
    path = tmp_path / "small.urdf"
    path.write_text(SMALL)
    tp, jp = turdf.load_urdf(str(path)), jurdf.load_urdf(str(path))
    assert tp.root == jp.root == "base"
    assert turdf.parsed_to_json(tp) == jurdf.parsed_to_json(jp)
    ddp = {"hip_joint": 0.1}
    got, want = tp.build_model(ddp), jp.build_model(ddp)
    _model_equal(got, want)
    assert got.body_names == ["base", "hip", "calf", "foot"] and got.nu == 2
    np.testing.assert_allclose(got.link_mass, [5.2, 0.7, 0.3])   # the imu merged


def test_json_round_trip_of_the_asset():
    with open(turdf.default_asset_path()) as f:
        d = json.load(f)
    td = turdf.parsed_to_json(turdf.parsed_from_json(d))
    assert td == d == jurdf.parsed_to_json(jurdf.parsed_from_json(d))


def test_go2_from_urdf_matches(tmp_path):
    """build_go2_model of a .urdf: equal to the JAX package's from the same
    file, and to the model built from the packaged asset; the extract tool
    writes the asset's schema to the path it is given."""
    with open(turdf.default_asset_path()) as f:
        d = json.load(f)
    urdf = tmp_path / "go2.urdf"
    write_urdf(d, urdf)
    got = turdf.build_go2_model(str(urdf))
    _model_equal(got, jurdf.build_go2_model(str(urdf)))
    _model_equal(got, turdf.build_go2_model(), atol=1e-12)
    out = tmp_path / "sub" / "go2_model.json"
    subprocess.run([sys.executable, "-m", "agility_tpu_torch.tools.extract_go2", str(urdf),
                    str(out)], check=True, capture_output=True)
    with open(out) as f:
        written = json.load(f)
    assert written == turdf.parsed_to_json(turdf.load_urdf(str(urdf)))
    _model_equal(turdf.build_go2_model(str(out)), got)


def test_extract_needs_an_output_path(tmp_path):
    r = subprocess.run([sys.executable, "-m", "agility_tpu_torch.tools.extract_go2",
                        str(tmp_path / "x.urdf")], capture_output=True, text=True)
    assert r.returncode == 2 and "out" in r.stderr


def test_parse_rejects_two_roots(tmp_path):
    path = tmp_path / "bad.urdf"
    path.write_text(SMALL.replace('<link name="foot"/>', '<link name="foot"/><link name="x"/>'))
    with pytest.raises((ValueError, AssertionError)):
        jurdf.load_urdf(str(path))
    with pytest.raises(ValueError):
        turdf.load_urdf(str(path))
