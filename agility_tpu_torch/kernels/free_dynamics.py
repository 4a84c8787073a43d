"""Stage A's free dynamics as one hand-written CUDA kernel (csrc/free_dynamics.cu).

`free_dynamics` has `physics/soa.py:pre_contact`'s signature and returns the
same dict: the PD torques, the factored mass matrix, the unconstrained
velocity and the contact geometry (with the ceiling rows where a ceiling
sampler is given).  It dispatches on the device alone: CPU tensors go to
`soa.pre_contact`, the kernel's plain twin; CUDA tensors launch the kernel,
or raise.

Replaces no TPU kernel: agility_tpu/physics/soa.py is plain jnp, which XLA
fuses.  PyTorch runs the same per-env scalar program as ~13,550 passes over
(N,) or (S, N) tensors a substep; the kernel runs it once, in blocks of 32
envs: a thread an env computes its dynamics, two more its spheres (the CUDA
source says what bounds it and how the design answers).

The kernel writes one float32 buffer of `row_layout(rows)`'s rows, each N
floats (env-minor: row k of env n at k N + n); `output_views` returns views
of it in pre_contact's nested lists and tuples, so the contact stage reads
them unchanged.  The model's constants go to the card once per ModelConsts,
packed by `pack_consts` into `table_layout(S)`'s table.  The kernel holds one
tree: 13 links, 4 legs of 3 dofs, each leg a chain off the base (the layout
soa.limit_impulses already requires), and at most MAX_ROWS contact rows
(what K1 takes).
"""
from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from agility_tpu_torch.kernels import build
from agility_tpu_torch.physics.constants import ModelConsts, SoAConsts

SOURCE = "agility_tpu_torch/csrc/free_dynamics.cu"
MAX_ROWS = 32           # contact rows S' (spheres plus ceiling rows), as K1's MAX_CONTACTS
LINKS, DOFS, LEGS = 13, 12, 4
PARENT = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11)   # each leg a chain of 3 off the base
SPHERE = 5 + DOFS       # a sphere's record: link, offset (3), radius, lever mask (12)


def table_layout(S: int) -> dict:
    """{field: (offset, shape)} of the constant table for S spheres, in the
    kernel's order (csrc/free_dynamics.cu: kJointPos ... kSpheres)."""
    fields = (("joint_pos", (LINKS, 3)), ("joint_quat", (LINKS, 4)), ("joint_axis", (LINKS, 3)),
              ("link_mass", (LINKS,)), ("link_com", (LINKS, 3)), ("link_inertia", (LINKS, 3, 3)),
              ("effort", (DOFS,)), ("chain_mass", (DOFS,)), ("tree_mass", (1,)),
              ("spheres", (S, SPHERE)))
    out, at = {}, 0
    for name, shape in fields:
        out[name] = (at, shape)
        at += int(np.prod(shape))
    return out


def check_tree(c: SoAConsts) -> None:
    """Raises ValueError unless `c` is the tree the kernel holds."""
    legs = [[3 * k, 3 * k + 1, 3 * k + 2] for k in range(LEGS)]
    if (c.L, c.nu) != (LINKS, DOFS) or [list(leg) for leg in c.legs] != legs \
            or tuple(int(x) for x in c.parent) != PARENT \
            or [int(x) for x in c.dof_link] != list(range(1, LINKS)):
        raise ValueError(f"free_dynamics: the kernel holds a 13-link tree of 4 legs of 3 dofs, "
                         f"each a chain off the base; got {c.L} links, legs {c.legs}")


def pack_consts(c: SoAConsts) -> torch.Tensor:
    """The kernel's constant table (float32, on the CPU).  The subtree masses
    are summed in double as soa.mass_factors sums them (Python floats), then
    rounded, as a tensor op rounds a Python scalar."""
    check_tree(c)
    chain = [0.0] * DOFS
    for leg in c.legs:
        for i in range(len(leg) - 1, -1, -1):
            d = leg[i]
            m = float(c.link_mass[d + 1])
            chain[d] = m if i + 1 == len(leg) else m + chain[leg[i + 1]]
    tree = float(c.link_mass[0])
    for leg in c.legs:
        tree = tree + chain[leg[0]]
    spheres = np.concatenate([np.asarray(c.sph_link, np.float32)[:, None],
                              c.sph_offset, c.sph_radius.cpu().numpy(),
                              c.lever_mask.cpu().numpy()], axis=1)
    values = dict(joint_pos=c.joint_pos, joint_quat=c.joint_quat, joint_axis=c.joint_axis,
                  link_mass=c.link_mass, link_com=c.link_com, link_inertia=c.link_inertia,
                  effort=c.effort.cpu().numpy(), chain_mass=chain, tree_mass=[tree],
                  spheres=spheres)
    lay = table_layout(c.S)
    table = np.zeros(sum(int(np.prod(s)) for _, s in lay.values()), np.float32)
    for name, (at, shape) in lay.items():
        v = np.asarray(values[name], np.float64).reshape(shape)
        table[at:at + v.size] = v.ravel()
    return torch.from_numpy(table)


def row_layout(rows: int) -> dict:
    """{output: (first row, shape)} of the kernel's buffer for `rows` contact
    rows (csrc/free_dynamics.cu: kDinv ... kPhi); each row is N floats."""
    fields = (("Dinv", (LEGS, 3, 3)), ("B", (LEGS, 6, 3)), ("BDinv", (LEGS, 6, 3)),
              ("Sinv", (6, 6)), ("u_free", (18,)), ("tau_j", (DOFS,)), ("tau_org", (DOFS,)),
              ("phi", (rows,)), ("n", (3, rows)), ("r", (3, rows)), ("lever", (DOFS, 3, rows)))
    out, at = {}, 0
    for name, shape in fields:
        out[name] = (at, shape)
        at += int(np.prod(shape))
    return out


def contact_rows(c: SoAConsts, ceiling: bool) -> int:
    """S' = S, plus the base-link spheres' rows with a ceiling; raises
    where they exceed MAX_ROWS."""
    rows = c.S + (c.n_ceil if ceiling else 0)
    if rows > MAX_ROWS:
        raise ValueError(f"free_dynamics: {rows} contact rows; the kernel takes at most "
                         f"{MAX_ROWS}")
    return rows


def output_views(buf: torch.Tensor, legs, rows: int) -> dict:
    """pre_contact's dict as views of the kernel's buffer (R, N): f (Dinv,
    B, BDinv, Sinv nested lists of (N,) rows, and `legs`), u_free (18 rows),
    phi (S', N), n and r (tuples of (S', N)), lever (12, 3, S', N), tau_j and
    tau_org (12, N)."""
    lay = row_layout(rows)
    N = buf.shape[1]

    def block(name):
        at, shape = lay[name]
        return buf[at:at + int(np.prod(shape))].view(*shape, N)

    nest = lambda t: [nest(x) for x in t.unbind(0)] if t.dim() > 1 else t
    f = dict(Dinv=[nest(m) for m in block("Dinv").unbind(0)],
             B=[nest(m) for m in block("B").unbind(0)],
             BDinv=[nest(m) for m in block("BDinv").unbind(0)],
             Sinv=nest(block("Sinv")), legs=legs)
    return dict(f=f, u_free=list(block("u_free").unbind(0)), phi=block("phi"),
                n=tuple(block("n").unbind(0)), r=tuple(block("r").unbind(0)),
                lever=block("lever"), tau_j=block("tau_j"), tau_org=block("tau_org"))


# ctypes mirrors of the kernel's parameter structs (every field 8 bytes)
class _View(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("s0", ctypes.c_int64), ("s1", ctypes.c_int64),
                ("sn", ctypes.c_int64)]


class _Window(ctypes.Structure):
    _fields_ = [("values", _View), ("x0", _View), ("y0", _View), ("ox", ctypes.c_double),
                ("oy", ctypes.c_double), ("hscale", ctypes.c_double), ("gmax", ctypes.c_double),
                ("P", ctypes.c_int64)]


_STATE = ("bp", "bq", "q", "u", "target", "kp", "kd", "kp_scale", "kd_scale", "added_mass",
          "shift_x", "shift_y", "shift_z")


class _Params(ctypes.Structure):
    _fields_ = [(name, _View) for name in _STATE] + [
        ("floor", _Window), ("ceil", _Window), ("consts", ctypes.c_void_p),
        ("out", ctypes.c_void_p)] + [
        (name, ctypes.c_int64) for name in ("N", "S", "rows", "has_mass", "has_shift")] + [
        (name, ctypes.c_double) for name in ("dt", "gx", "gy", "gz")]


def _lib():
    lib = build.load("free_dynamics")
    if lib.free_dynamics_launch.argtypes is None:
        lib.free_dynamics_params_bytes.argtypes = []
        lib.free_dynamics_params_bytes.restype = ctypes.c_int
        if lib.free_dynamics_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError("free_dynamics: the kernel's parameter struct is "
                               f"{lib.free_dynamics_params_bytes()} bytes, the wrapper's "
                               f"{ctypes.sizeof(_Params)}")
        lib.free_dynamics_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.free_dynamics_launch.restype = ctypes.c_int
    return lib


_TABLES = {}    # id(ModelConsts) -> its constant table on the card, dropped with it


def _table(mc: ModelConsts) -> torch.Tensor:
    t = _TABLES.get(id(mc))
    if t is None:
        t = _TABLES[id(mc)] = pack_consts(mc.soa).to(mc.device)
        weakref.finalize(mc, _TABLES.pop, id(mc), None)
    return t


def _view(t, shape, dev, dtype=torch.float32, what="") -> _View:
    """A _View of t broadcast to `shape` ((rows, N), (N,) or (P, P, N))."""
    if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != dtype:
        raise ValueError(f"free_dynamics: {what} must be a {dtype} tensor on {dev}, got "
                         f"{getattr(t, 'dtype', type(t))} on {getattr(t, 'device', None)}")
    t = t.expand(shape)
    st = t.stride()
    if len(shape) == 1:
        return _View(t.data_ptr(), 0, 0, st[0])
    if len(shape) == 2:
        return _View(t.data_ptr(), st[0], 0, st[1])
    return _View(t.data_ptr(), st[0], st[1], st[2])


def _window(smp, N, dev, ceiling, what) -> _Window:
    from agility_tpu_torch.physics.soa import PatchSampler

    if not isinstance(smp, PatchSampler) or smp.ceiling != ceiling:
        raise ValueError(f"free_dynamics: {what} must be a soa.PatchSampler with "
                         f"ceiling={ceiling}, got {smp!r:.80}")
    P = smp.values_T.shape[0]
    if tuple(smp.values_T.shape) != (P, P, N) or P < 2:
        raise ValueError(f"free_dynamics: {what}'s window is {tuple(smp.values_T.shape)}, "
                         f"not (P, P, {N})")
    return _Window(_view(smp.values_T, (P, P, N), dev, what=f"{what}.values_T"),
                   _view(smp.x0, (N,), dev, torch.int64, f"{what}.x0"),
                   _view(smp.y0, (N,), dev, torch.int64, f"{what}.y0"),
                   float(smp.origin[0]), float(smp.origin[1]), float(smp.hscale),
                   P - 1.001, P)


def free_dynamics(mc: ModelConsts, cfg, sd, target, kp, kd, prm, sampler, ceil_sampler=None):
    """soa.pre_contact on the tensors' device: the CUDA kernel for CUDA
    tensors (one launch, on the current stream, never synchronised), the
    plain version for CPU tensors.  Each CUDA call adds one to
    `free_dynamics.launches`, and one to `free_dynamics.eager` where the
    stream is not capturing: the calls that launch the kernel on the
    device there and then (a captured call launches it at each replay of
    its graph; kernels.launch_counts counts both)."""
    dev = sd.bp.device
    if dev.type == "cpu":
        from agility_tpu_torch.physics.soa import pre_contact

        return pre_contact(mc, cfg, sd, target, kp, kd, prm, sampler, ceil_sampler)
    if dev.type != "cuda":
        raise ValueError(f"free_dynamics: no kernel for device {dev}")
    if mc.device != dev:
        raise ValueError(f"free_dynamics: the model is on {mc.device}, the state on {dev}")
    c = mc.soa
    check_tree(c)
    ceiling = ceil_sampler is not None
    rows = contact_rows(c, ceiling)
    N = sd.bp.shape[-1]
    state = (("bp", sd.bp, 3), ("bq", sd.bq, 4), ("q", sd.q, 12), ("u", sd.u, 18),
             ("target", target, 12), ("kp", kp, 12), ("kd", kd, 12),
             ("kp_scale", prm["kp_scale"], 12), ("kd_scale", prm["kd_scale"], 12))
    views = {k: _view(t, (n, N), dev, what=k) for k, t, n in state}
    mass, shift = prm.get("added_mass"), prm.get("com_shift")
    none = _View(None, 0, 0, 0)
    views["added_mass"] = none if mass is None else _view(mass, (N,), dev, what="added_mass")
    for k, name in enumerate(("shift_x", "shift_y", "shift_z")):
        views[name] = none if shift is None else _view(shift[k], (N,), dev, what="com_shift")
    floor = _window(sampler, N, dev, False, "sampler")
    ceil = _window(ceil_sampler, N, dev, True, "ceil_sampler") if ceiling else \
        _Window(none, none, none, 0.0, 0.0, 1.0, 0.0, 2)
    buf = torch.empty((sum(int(np.prod(s)) for _, s in row_layout(rows).values()), N),
                      dtype=torch.float32, device=dev)
    out = output_views(buf, c.legs, rows)
    if N == 0:
        return out
    table = _table(mc)
    lib = _lib()
    params = _Params(*[views[k] for k in _STATE], floor, ceil, table.data_ptr(), buf.data_ptr(),
                     N, c.S, rows, mass is not None, shift is not None,
                     float(cfg.dt), *(float(g) for g in cfg.gravity))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.free_dynamics_launch(ctypes.byref(params), stream)
        eager = not torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"free_dynamics kernel launch failed: cudaError {err}")
    free_dynamics.launches += 1
    free_dynamics.eager += eager
    return out


free_dynamics.launches = 0
free_dynamics.eager = 0
