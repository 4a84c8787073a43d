"""CUDA graphs of the engine's eager op chains.

An op chain of many small kernels that the host issues one by one costs the
host ~10 µs an op and the device under 1 µs: the card waits on the host.
Captured once into a `torch.cuda.CUDAGraph` and replayed, the whole chain
costs the host one launch, and the host issues what follows while the card
replays.

`GraphCache` holds one graph per key.  A graph reads static copies of its
inputs, made with each input's shape, strides and dtype, and writes the
same output tensors at every replay: an output is valid until the next call
with its key, so a caller that keeps one clones it.

A graph may also read another graph's tensors in place ("borrowed"): two
graphs on one stream with an eager launch between them, the second reading
the first's outputs and static inputs by address, with no copy.  The
contract: the second graph's key includes the first's, so one entry of the
second always reads the same entry of the first; both entries have the
same owner, so they are dropped together; and the lender's tensors hold
this call's values when the borrower replays, which stream order gives
when the borrower is called after the lender's replay and before its next.
"""
from __future__ import annotations

import weakref
from typing import Callable, Hashable, Sequence

import torch


def _static(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


class _Graph:
    """One captured graph, its static inputs and the outputs it writes."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor],
                 held: Sequence[torch.Tensor], borrowed):
        self.borrowed = borrowed
        self.args = [_static(t) for t in args]
        self.held = [_static(t) for t in held]
        self.held_src = [None] * len(held)
        self.load(args, held)
        # warm up on the capture stream, then capture there (cuBLAS takes its
        # handle and workspace for a stream at the stream's first call)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(self.args, self.held)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(self.args, self.held)

    def load(self, args: Sequence[torch.Tensor], held: Sequence[torch.Tensor]) -> None:
        for dst, src in zip(self.args, args):
            dst.copy_(src)
        if any(a is not b for a, b in zip(held, self.held_src)):
            for dst, src in zip(self.held, held):
                dst.copy_(src)
            self.held_src = list(held)


class GraphCache:
    """`fn(args, held)` replayed from a CUDA graph, one capture per key.

    `fn` takes two lists of CUDA tensors on one device and returns any
    structure of tensors.  It must launch its work on the current stream,
    never read a value back to the host, branch only on what the key fixes,
    and read no tensor but its arguments and those `owner` keeps alive: the
    graph holds their addresses.  The entry is dropped when `owner` is
    garbage collected.

    A call copies every tensor of `args` into the graph's static inputs, and
    those of `held` only when they are other objects than the last call's
    (inputs that stay the same over several calls, such as a control step's
    terrain window read by each of its substeps; they are kept referenced,
    so an object seen again is the same tensor).  `borrowed` is any object
    holding tensors that `fn` reads in place through its closure, never
    copied: another graph's outputs (see the module's docstring).  The
    entry keeps it referenced, and every call with the key must pass the
    same object.  The first call with a key warms `fn` up once and captures
    it (`captures`); every call then replays (`replays`)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graphs = {}

    def __call__(self, key: Hashable, owner, fn: Callable, args: Sequence[torch.Tensor],
                 held: Sequence[torch.Tensor] = (), borrowed=None):
        with torch.cuda.device(args[0].device):
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = _Graph(fn, args, held, borrowed)
                weakref.finalize(owner, self._graphs.pop, key, None)
                self.captures += 1
            else:
                if borrowed is not g.borrowed:
                    raise ValueError("GraphCache: the borrowed tensors differ from those the "
                                     "graph was captured with; the key must fix them")
                g.load(args, held)
            g.graph.replay()
        self.replays += 1
        return g.out
