"""Env-axis data parallelism over torch.distributed (counterpart of
agility_tpu/dist/mesh.py).

One process per card, the parameters replicated, the envs partitioned
along the env axis.  The JAX package gets this from GSPMD: the sharded
program is the single-device program, so a W-device run of seed s is the
1-device run of seed s, partitioned by env.  The port keeps that contract
by hand:

- every per-env random draw is made at the global width from a generator
  seeded alike on every rank, and the rank takes its rows (`EnvShard.take`),
  so the generators stay in step;
- every reduction over the env axis (the TSC env's success EMAs, GAE's
  advantage normalisation, the rollout metrics, each PPO and DAgger
  minibatch's losses and gradients) is a sum over the rank's rows, summed
  across ranks (`all_reduce_`) and divided by the global count;
- what the JAX runner replicates stays replicated: the discriminator's
  replay ring receives every rank's rows each control step (`gather_rows`)
  and its update runs alike on every rank.

Every rank then holds bit-identical parameters without a broadcast.

The module uses only `all_reduce` and `broadcast`, which NCCL carries for
CUDA tensors and ProcessGroupGloo for CUDA and CPU tensors alike, so the
same code runs under both backends (two ranks on one card need gloo: NCCL
refuses two ranks on one device).  `init` never falls back: a failed NCCL
init raises.

`launch` runs a function in W spawned ranks of a gloo or NCCL group on this
host, each with a time limit, for tests and checks.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class Rank(NamedTuple):
    rank: int
    world: int
    local_rank: int
    device: torch.device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(device="cuda", backend: Optional[str] = None, timeout_s: float = 600.0) -> Rank:
    """Join (or form) the process group and return this process's place in
    it.  torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT say where; without them the process forms a one-rank group
    on a free local port.  A CUDA `device` becomes cuda:LOCAL_RANK.  The
    backend is NCCL for CUDA and gloo for the CPU unless `backend` names
    one."""
    env = os.environ
    if "RANK" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        addr, port = env["MASTER_ADDR"], env["MASTER_PORT"]
    else:
        rank, world, local = 0, 1, 0
        addr, port = "localhost", str(free_port())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh.init: a CUDA device was asked for but torch sees none")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return Rank(rank, world, local, dev)


def join(device, num_envs: int, multihost: bool = False):
    """The training CLIs' --shard / --multihost: join the group torchrun
    describes (a one-rank group without torchrun; --multihost requires its
    multi-node environment).  Returns (this rank's EnvShard of `num_envs`
    global envs, its device)."""
    if multihost and "RANK" not in os.environ:
        raise SystemExit("--multihost needs torchrun's multi-node environment (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT): launch with torchrun --nnodes")
    r = init(device)
    shard = EnvShard(r.rank, r.world, num_envs)
    if r.rank == 0:
        print(f"env-sharded over {r.world} rank(s), {dist.get_backend()}; rank 0 holds envs "
              f"[{shard.offset}, {shard.offset + shard.local}) of {num_envs}", flush=True)
    return shard, r.device


def close() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


class EnvShard:
    """Rank `rank`'s block of `num_envs` global envs: envs [offset, offset +
    local).  `world` must divide `num_envs`."""

    def __init__(self, rank: int, world: int, num_envs: int):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if num_envs % world:
            raise ValueError(f"{num_envs} envs do not split evenly over {world} ranks")
        self.rank, self.world, self.num_envs = rank, world, num_envs
        self.local = num_envs // world
        self.offset = rank * self.local

    @property
    def rows(self) -> slice:
        return slice(self.offset, self.offset + self.local)

    def take(self, x, dim: int = 0):
        """The rank's rows along `dim` of tensor or array `x` where its size
        there is `num_envs`; `x` itself otherwise (counterpart of
        shard_env_tree, leaf by leaf)."""
        if x.ndim <= dim or x.shape[dim] != self.num_envs:
            return x
        if isinstance(x, torch.Tensor):
            return x.narrow(dim, self.offset, self.local)
        return np.take(x, np.arange(self.offset, self.offset + self.local), axis=dim)

    def __repr__(self):
        return (f"EnvShard(rank={self.rank}, world={self.world}, envs "
                f"[{self.offset}, {self.offset + self.local}) of {self.num_envs})")


def all_reduce_(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce `x` in place across the group ("sum" or "max") and return it.
    Counts its calls in `all_reduce_.calls`; where `all_reduce_.events` is
    a list, a CUDA tensor's call appends a (start, end) pair of CUDA
    events around it."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    all_reduce_.calls += 1
    if all_reduce_.events is not None and x.is_cuda:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dist.all_reduce(x, op=ops[op])
        b.record()
        all_reduce_.events.append((a, b))
    else:
        dist.all_reduce(x, op=ops[op])
    return x


all_reduce_.calls = 0
all_reduce_.events = None


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers into every rank's `module`,
    in one broadcast (counterpart of replicate_tree)."""
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src)
    with torch.no_grad():
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def gather_rows(local: torch.Tensor, shard: EnvShard) -> torch.Tensor:
    """The (num_envs, ...) tensor of every rank's rows: the rank's rows
    written into zeros, summed across ranks (exact: each element is one
    rank's value plus zeros; booleans travel as bytes)."""
    dtype = torch.uint8 if local.dtype == torch.bool else local.dtype
    out = torch.zeros((shard.num_envs,) + tuple(local.shape[1:]), dtype=dtype,
                      device=local.device)
    out[shard.rows] = local
    return all_reduce_(out).to(local.dtype)


def minibatch_rows(perm: torch.Tensor, n_mb: int, mb: int, shard: Optional[EnvShard]):
    """Each of the `n_mb` minibatches of `mb` rows of a global permutation
    over the (T x num_envs) rollout, as indices into the rank's (T x local)
    rollout flattened: global index t * num_envs + e
    belongs to the rank that holds env e.  A rank may hold no row of a
    minibatch."""
    if shard is None or shard.world == 1:
        return [perm[j * mb:(j + 1) * mb] for j in range(n_mb)]
    g = perm[:n_mb * mb]
    t, e = g // shard.num_envs, g % shard.num_envs
    mine = (e >= shard.offset) & (e < shard.offset + shard.local)
    counts = mine.view(n_mb, mb).sum(dim=1).tolist()
    return list(torch.split((t * shard.local + e - shard.offset)[mine], counts))


def all_reduce_grads_(params, extras: torch.Tensor) -> torch.Tensor:
    """Sum the gradients of `params` (those that have one) and the 1-D
    tensor `extras` across the group, in one all-reduce; the gradients are
    written back in place.  Returns the summed extras."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [extras.reshape(-1).to(grads[0].dtype)])
    all_reduce_(flat)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return flat[i:]


def _rank_main(fn, rank, world, port, backend, device, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        init(device, backend, timeout_s=60.0)
        # pickled here by the plain pickler: the queue's own would share
        # tensors through file descriptors that die with this process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        close()


def launch(fn: Callable, world: int, args=(), backend: str = "gloo", device="cuda",
           timeout_s: float = 120.0) -> list:
    """fn(*args) in `world` spawned ranks of a `backend` group on this host
    (LOCAL_RANK 0: every rank on `device`, cuda:0 for a CUDA one); returns
    the ranks' results in rank order.  `fn` must be importable by its
    module path and its result picklable.  A rank that raises, or a run
    past `timeout_s`, stops every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, device, args,
                                                  results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(f"mesh.launch: {world - len(out)} of {world} ranks gave no "
                                   f"result within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"mesh.launch: rank {rank} failed:\n{val}")
            out[rank] = pickle.loads(val)
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0) if len(out) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    return [out[r] for r in range(world)]
