"""K1: the contact LCP solve, as a hand-written CUDA kernel and its plain-torch twin.

Replaces agility_tpu/physics/pallas_contact.py:_kernel (pallas_call at
pallas_contact.py:85), extended by the warm start of the served path
(agility_tpu/physics/soa.py:jacobi_solve, lam0).  The CUDA source,
csrc/contact_lcp.cu, says what bounds it on the card and how its design
answers that.

Layout of every argument (env-major, contact-interleaved: index 3*s + a):
  G     (N, 3S, 3S)  Delassus matrix J M^-1 J^T
  vf    (N, 3S)      J u_free
  bias  (N, 3S)      Baumgarte + restitution velocity bias (world frame)
  n     (N, 3S)      contact normals
  act   (N, S)       1.0 where the contact is active
  dinv  (N, S, 9)    row-major inverse 3x3 diagonal blocks of G (+ reg)
  mu    (N, S)       friction coefficient
  lam0  (N, 3S)      warm-start impulses (zeros for a cold solve)
Returns lam (N, 3S).

`contact_lcp` dispatches on the tensors' device alone: CPU tensors take
`contact_lcp_reference`; CUDA tensors launch the kernel, or raise.

K1 has two callers: the SoA substep (physics/soa.py:substep, between its
two stages), and the per-env engine's world-frame solve through
`jacobi_solve_batch` below (the counterpart of
agility_tpu/physics/pallas_contact.py:jacobi_solve_batch), which builds the
same inputs from the fast path's dense Jacobians.

The kernel runs persistent blocks that stream each env's G through a
two-stage ring of asynchronous copies in shared memory into registers (8
lanes per contact) and sweep it there.  `launch_config` computes its launch
parameters (threads, row stride, shared memory, grid, copy width) from the
shapes alone, so the CPU tests check the layout rules that the kernel's
launcher checks again.
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build

TPU_KERNEL = "agility_tpu/physics/pallas_contact.py:27"   # _kernel; pallas_call at :85
SOURCE = "agility_tpu_torch/csrc/contact_lcp.cu"
MAX_CONTACTS = 32
MAX_SMEM = 232_448          # bytes of shared memory a block can use on Hopper (227 KB)
LANES_PER_CONTACT = 8       # each holds float4 chunks q, q + 8, q + 16 of the contact's 3 rows


def _pad4(x: int) -> int:
    return -(-x // 4) * 4


def launch_config(N: int, S: int, sm_count: int, blocks_per_sm: int) -> dict:
    """The kernel's launch parameters for N envs of S contacts (M = 3S rows):

      threads  8 lanes per contact, rounded up to whole warps
      ld       G's row stride in shared memory, in floats: M rounded up to
               whole float4 chunks (a contact's 8 lanes read 8 consecutive
               chunks of a row, conflict-free at any such stride)
      smem     bytes: two ring stages (G in rows of ld, then vf, bias, n,
               lam0, act, mu, dinv, each padded to 4 floats), lam and G lam
               (ld floats each) and the stages' two 8-byte barriers
      grid     min(N, blocks_per_sm * sm_count): persistent blocks
      vec      4 when S % 4 == 0: then ld == M and every per-env segment is
               16-byte aligned, so one thread copies an env with bulk (TMA)
               copies; else 1: every thread copies 4 bytes at a time

    Raises if the shared memory exceeds what a block can use."""
    M = 3 * S
    ld = _pad4(M)
    stage = M * ld + 4 * _pad4(M) + 2 * _pad4(S) + _pad4(9 * S)
    smem = 4 * (2 * stage + 2 * ld) + 16
    if smem > MAX_SMEM:
        raise ValueError(f"contact_lcp: S = {S} needs {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a block can use")
    return dict(threads=32 * -(-LANES_PER_CONTACT * S // 32), ld=ld, smem=smem,
                grid=max(1, min(N, blocks_per_sm * sm_count)), vec=4 if S % 4 == 0 else 1)


def _project(lam, n, act, mu, lam_max):
    """Friction-cone projection on (N, S, 3) impulses."""
    ln = torch.sum(lam * n, dim=-1)
    lt = lam - ln[..., None] * n
    ln = torch.clamp(ln, 0.0, lam_max) * act
    tn = torch.linalg.vector_norm(lt, dim=-1)
    scale = torch.clamp(mu * ln / torch.clamp(tn, min=1e-9), max=1.0) * act
    return lt * scale[..., None] + ln[..., None] * n


def contact_lcp_reference(G, vf, bias, n, act, dinv, mu, lam0, *, iters: int,
                          relax: float, lam_max: float = 25.0):
    """Plain-torch K1: `iters` projected block-Jacobi sweeps from project(lam0)."""
    N, M = vf.shape
    S = M // 3
    n3 = n.view(N, S, 3)
    D = dinv.view(N, S, 3, 3)
    rhs = vf - bias
    lam = _project(lam0.view(N, S, 3), n3, act, mu, lam_max)
    for _ in range(iters):
        v = (torch.bmm(G, lam.reshape(N, M, 1))[..., 0] + rhs).view(N, S, 3)
        dl = -torch.einsum("nsab,nsb->nsa", D, v)
        lam = _project(lam + relax * dl, n3, act, mu, lam_max)
    return lam.reshape(N, M)


def per_env_problem(phi, normals, JpT, G, u_free, mu, dt, *, baumgarte=0.2, slop=0.002,
                    max_depen_vel=1.0, restitution=0.0):
    """K1's eight inputs for a cold solve from the per-env engine's world-frame
    contact data: phi (N, S), normals (N, S, 3), JpT (N, nv, 3S), G = JpT^T
    M^-1 JpT (N, 3S, 3S), u_free (N, nv), mu (N,).  The velocity bias lies
    along the normals; dinv inverts G's 3 x 3 diagonal blocks + 1e-6 I."""
    from agility_tpu_torch.physics.dynamics import _inv3

    N, S = phi.shape
    M = 3 * S
    active = (phi < 0.0).to(u_free.dtype)
    v_free = (JpT.transpose(1, 2) @ u_free[..., None])[..., 0]         # (N, 3S)
    vn0 = torch.sum(v_free.view(N, S, 3) * normals, dim=-1)
    depth = torch.clamp(-phi - slop, min=0.0)
    bias_n = torch.clamp(baumgarte / dt * depth, max=max_depen_vel)
    bias_n = bias_n + restitution * torch.clamp(-vn0, min=0.0)
    diag = torch.diagonal(G.view(N, S, 3, S, 3), dim1=1, dim2=3).permute(0, 3, 1, 2)
    dinv = _inv3(diag + 1e-6 * torch.eye(3, dtype=G.dtype, device=G.device))
    return (G.contiguous(), v_free.contiguous(), (bias_n[..., None] * normals).reshape(N, M),
            normals.reshape(N, M).contiguous(), active.contiguous(),
            dinv.reshape(N, S, 9).contiguous(), mu.reshape(N, 1).expand(N, S).contiguous(),
            torch.zeros_like(v_free))


def jacobi_solve_batch(phi, normals, JpT, MinvJT, G, u_free, mu, dt, *, iters=10, relax=0.6,
                       baumgarte=0.2, slop=0.002, max_depen_vel=1.0, restitution=0.0,
                       lam_max=25.0):
    """The per-env engine's contact solve through K1, cold (lam0 = 0):
    `iters` sweeps on `per_env_problem`'s inputs, MinvJT = M^-1 JpT.
    Returns (u_new = u_free + MinvJT lam, the world force lam / dt (N, S, 3))."""
    N, S = phi.shape
    args = per_env_problem(phi, normals, JpT, G, u_free, mu, dt, baumgarte=baumgarte,
                           slop=slop, max_depen_vel=max_depen_vel, restitution=restitution)
    lam = contact_lcp(*args, iters=iters, relax=relax, lam_max=lam_max)
    return u_free + (MinvJT @ lam[..., None])[..., 0], lam.view(N, S, 3) / dt


def _lib():
    lib = build.load("contact_lcp")
    if lib.contact_lcp_launch.argtypes is None:
        lib.contact_lcp_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
            [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.contact_lcp_launch.restype = ctypes.c_int
        lib.contact_lcp_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.contact_lcp_blocks_per_sm.restype = ctypes.c_int
    return lib


_OCCUPANCY = {}     # (device index, S) -> (SM count, blocks per SM)


def device_launch_config(N: int, S: int, dev: torch.device) -> dict:
    """`launch_config` on the card `dev`: its SM count, and the blocks of the
    S-contact kernel that fit on one SM by the CUDA occupancy query (cached
    per device and S)."""
    key = (dev.index, S)
    if key not in _OCCUPANCY:
        cfg = launch_config(1, S, 1, 1)
        blocks = _lib().contact_lcp_blocks_per_sm(cfg["threads"], cfg["smem"], cfg["vec"])
        if blocks <= 0:
            raise RuntimeError(f"contact_lcp: occupancy query gave {blocks} blocks per SM "
                               f"for S = {S} ({cfg['threads']} threads, {cfg['smem']} bytes)")
        _OCCUPANCY[key] = (torch.cuda.get_device_properties(dev).multi_processor_count, blocks)
    sm_count, blocks_per_sm = _OCCUPANCY[key]
    return dict(launch_config(N, S, sm_count, blocks_per_sm), sm_count=sm_count,
                blocks_per_sm=blocks_per_sm)


def contact_lcp(G, vf, bias, n, act, dinv, mu, lam0, *, iters: int, relax: float,
                lam_max: float = 25.0):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Each kernel launch adds one to
    `contact_lcp.launches`."""
    args = (G, vf, bias, n, act, dinv, mu, lam0)
    dev = G.device
    if dev.type == "cpu":
        return contact_lcp_reference(*args, iters=iters, relax=relax, lam_max=lam_max)
    if dev.type != "cuda":
        raise ValueError(f"contact_lcp: no kernel for device {dev}")
    N, M = vf.shape
    S = M // 3
    shapes = [(N, M, M), (N, M), (N, M), (N, M), (N, S), (N, S, 9), (N, S), (N, M)]
    for name, t, shp in zip("G vf bias n act dinv mu lam0".split(), args, shapes):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shp \
                or not t.is_contiguous():
            raise ValueError(f"contact_lcp: {name} must be a contiguous float32 "
                             f"{shp} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if M % 3 or S > MAX_CONTACTS:
        raise ValueError(f"contact_lcp: 3S = {M} rows; the kernel takes S <= "
                         f"{MAX_CONTACTS} contacts")
    out = torch.empty_like(vf)
    if N == 0:
        return out
    lib = _lib()
    ptrs = [t.data_ptr() for t in args]
    with torch.cuda.device(dev):
        cfg = device_launch_config(N, S, dev)
        if cfg["vec"] == 4 and any(p % 16 for p in ptrs):
            raise ValueError("contact_lcp: at S % 4 == 0 the kernel reads its inputs with "
                             "bulk copies, which need every input 16-byte aligned")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.contact_lcp_launch(*ptrs, out.data_ptr(), N, S, int(iters), float(relax),
                                     float(lam_max), cfg["threads"], cfg["ld"], cfg["smem"],
                                     cfg["grid"], cfg["vec"], stream)
    if err != 0:
        raise RuntimeError(f"contact_lcp kernel launch failed: cudaError {err}")
    contact_lcp.launches += 1
    return out


contact_lcp.launches = 0
