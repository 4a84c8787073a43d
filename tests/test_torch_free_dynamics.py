"""The free-dynamics kernel's wrapper (kernels/free_dynamics.py) on the CPU:
its constant table and output rows against SoAConsts, pre_contact and the
kernel source's offsets, its CPU route, and what it refuses.  The kernel
itself runs only on a card (tests/test_torch_cuda.py)."""
import copy
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from agility_tpu_torch.kernels import free_dynamics as kfd
from agility_tpu_torch.physics import soa as tsoa
from torch_cases import CFG, TMC, batch_case, layered_case

CU = os.path.join(os.path.dirname(kfd.__file__), "..", "csrc", "free_dynamics.cu")


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _inputs(ceiling):
    s, ctl, prm, grid = batch_case()
    if ceiling:
        grid = layered_case()[0]
    sd, args, _ = tsoa.batch_inputs(CFG, grid, s, ctl, prm)
    return sd, args


def _kernel_constants():
    """The kernel source's `constexpr int kName = expr;` values, evaluated in
    order."""
    env = {}
    with open(CU) as f:
        for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", f.read()):
            env[name] = eval(expr, {}, dict(env))
    return env


def test_table_reads_back_the_model():
    """pack_consts' table, read through table_layout, equals SoAConsts:
    joint frames, masses, COMs, inertias, effort limits, and each sphere's
    link, offset, radius and lever mask; the subtree masses are the sums
    soa.mass_factors forms."""
    c = tsoa.consts_of(TMC)
    table = kfd.pack_consts(c)
    lay = kfd.table_layout(c.S)
    assert table.dtype == torch.float32 and table.dim() == 1
    read = {k: table[at:at + int(np.prod(shape))].reshape(shape).numpy()
            for k, (at, shape) in lay.items()}
    assert table.numel() == sum(v.size for v in read.values())
    for k in ("joint_pos", "joint_quat", "joint_axis", "link_mass", "link_com", "link_inertia"):
        np.testing.assert_array_equal(read[k], getattr(c, k))
    np.testing.assert_array_equal(read["effort"], c.effort[:, 0].numpy())
    sph = read["spheres"]
    np.testing.assert_array_equal(sph[:, 0], c.sph_link)
    np.testing.assert_array_equal(sph[:, 1:4], c.sph_offset)
    np.testing.assert_array_equal(sph[:, 4], c.sph_radius[:, 0].numpy())
    np.testing.assert_array_equal(sph[:, 5:], c.lever_mask.numpy())
    for leg in c.legs:
        for i, d in enumerate(leg):
            want = sum(float(c.link_mass[e + 1]) for e in leg[i:])
            assert read["chain_mass"][d] == pytest.approx(want, rel=1e-7)
    assert read["tree_mass"][0] == pytest.approx(float(c.link_mass.sum()), rel=1e-7)


def test_layouts_are_the_kernels():
    """The table's offsets, the sphere record and the output rows are those
    the CUDA source declares."""
    k = _kernel_constants()
    table = kfd.table_layout(24)
    for name, field in (("kJointPos", "joint_pos"), ("kJointQuat", "joint_quat"),
                        ("kJointAxis", "joint_axis"), ("kLinkMass", "link_mass"),
                        ("kLinkCom", "link_com"), ("kLinkInertia", "link_inertia"),
                        ("kEffort", "effort"), ("kChainMass", "chain_mass"),
                        ("kTreeMass", "tree_mass"), ("kSpheres", "spheres")):
        assert k[name] == table[field][0], name
    assert k["kSphereStride"] == kfd.SPHERE
    rows = kfd.row_layout(28)
    for name, field in (("kDinv", "Dinv"), ("kB", "B"), ("kBDinv", "BDinv"), ("kSinv", "Sinv"),
                        ("kUFree", "u_free"), ("kTauJ", "tau_j"), ("kTauOrg", "tau_org"),
                        ("kPhi", "phi")):
        assert k[name] == rows[field][0], name
    assert (k["kLinks"], k["kDofs"], k["kLegs"]) == (kfd.LINKS, kfd.DOFS, kfd.LEGS)


def test_params_have_no_padding():
    """Every field of the launch parameters is 8 bytes, so the ctypes
    structs and the kernel's lay out alike (the wrapper also compares their
    sizes on the card)."""
    def fields(st):
        """The sizes of st's scalar fields, nested structs flattened."""
        out = []
        for _, t in st._fields_:
            out += fields(t) if issubclass(t, ctypes.Structure) else [ctypes.sizeof(t)]
        return out

    for st in (kfd._View, kfd._Window, kfd._Params):
        sizes = fields(st)
        assert set(sizes) == {8} and ctypes.sizeof(st) == 8 * len(sizes)
    assert ctypes.sizeof(kfd._Params) == 8 * (13 * 4 + 2 * (3 * 4 + 5) + 2 + 5 + 4)


@pytest.mark.parametrize("ceiling", [False, True])
def test_output_views_read_back_pre_contact(ceiling):
    """pre_contact's CPU result written through output_views' views of one
    buffer fills every row once, and the buffer read back as the dict is
    pre_contact's, leaf for leaf."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    want = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    c = tsoa.consts_of(TMC)
    rows = kfd.contact_rows(c, ceiling)
    assert rows == want["phi"].shape[0] == 24 + 4 * ceiling
    R = sum(int(np.prod(s)) for _, s in kfd.row_layout(rows).values())
    N = sd.bp.shape[1]
    buf = torch.full((R, N), float("nan"))
    views = kfd.output_views(buf, c.legs, rows)
    assert sum(t.numel() for t in _leaves(views)) == R * N
    for dst, src in zip(_leaves(views), _leaves(want), strict=True):
        assert dst.shape == src.shape
        dst.copy_(src)
    assert not torch.isnan(buf).any()
    got = kfd.output_views(buf, c.legs, rows)
    assert got.keys() == want.keys() and got["f"].keys() == want["f"].keys()
    assert got["f"]["legs"] == want["f"]["legs"]
    assert [type(got[k]) for k in got] == [type(want[k]) for k in got]
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ceiling", [False, True])
def test_free_dynamics_on_cpu_is_pre_contact(ceiling):
    """On CPU tensors free_dynamics is pre_contact exactly, and launches
    nothing."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    before = kfd.free_dynamics.launches
    got = kfd.free_dynamics(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    want = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    assert kfd.free_dynamics.launches == before
    assert len(_leaves(got)) == len(_leaves(want)) > 0
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert torch.equal(a, b)


def test_launch_counts_are_eager_calls_and_replays(monkeypatch):
    """kernels.launch_counts gives the free-dynamics kernel's launches on the
    device: its eager calls and the replays of stage A's graph (a captured
    call launches it at each replay, not at the capture); a CPU call counts
    nothing; zero_launch_counts zeroes the calls, the eager calls and the
    replays."""
    from agility_tpu_torch.kernels import launch_counts, zero_launch_counts

    monkeypatch.setattr(kfd.free_dynamics, "launches", 7)
    monkeypatch.setattr(kfd.free_dynamics, "eager", 3)
    monkeypatch.setattr(tsoa.FREE_DYNAMICS, "replays", 5)
    assert launch_counts()["free_dynamics"] == 3 + 5
    sd, args = _inputs(True)
    kfd.free_dynamics(TMC, CFG, sd, *args)
    assert launch_counts()["free_dynamics"] == 8 and kfd.free_dynamics.launches == 7
    zero_launch_counts()
    assert launch_counts()["free_dynamics"] == 0
    assert (kfd.free_dynamics.launches, kfd.free_dynamics.eager,
            tsoa.FREE_DYNAMICS.replays) == (0, 0, 0)


@pytest.mark.parametrize("change", ["links", "legs", "parent", "dof_link"])
def test_unsupported_tree_raises(change):
    """A tree other than 13 links in 4 legs of 3 dofs, each a chain off the
    base, is refused before anything is packed or launched."""
    c = copy.copy(tsoa.consts_of(TMC))
    if change == "links":
        c.L = 14
    elif change == "legs":
        c.legs = [[0, 1], [2, 3, 4], [5, 6, 7], [8, 9, 10, 11]]
    elif change == "parent":
        c.parent = np.array([-1, 0, 1, 1, 0, 4, 5, 0, 7, 8, 0, 10, 11], np.int32)
    else:
        c.dof_link = np.arange(12, dtype=np.int32)
    with pytest.raises(ValueError, match="13-link tree"):
        kfd.pack_consts(c)
    with pytest.raises(ValueError, match="13-link tree"):
        kfd.check_tree(c)


def test_too_many_contact_rows_raise():
    """S' beyond MAX_ROWS (what K1 takes) is refused; the Go2's 24 spheres
    and 4 ceiling rows fit."""
    c = copy.copy(tsoa.consts_of(TMC))
    assert kfd.contact_rows(c, True) == 28 and kfd.contact_rows(c, False) == 24
    c.S = 30
    assert kfd.contact_rows(c, False) == 30
    with pytest.raises(ValueError, match="contact rows"):
        kfd.contact_rows(c, True)


def test_other_devices_raise():
    """Off the CPU and CUDA the wrapper has no route: it raises."""
    sd, (target, kp, kd, prm, sampler, _) = _inputs(False)
    meta = tsoa.SoAState(*(t.to("meta") for t in sd))
    with pytest.raises(ValueError, match="no kernel for device"):
        kfd.free_dynamics(TMC, CFG, meta, target, kp, kd, prm, sampler)
