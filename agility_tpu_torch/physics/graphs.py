"""CUDA graphs of the engine's op chains.

An op chain of many small kernels that the host issues one by one costs the
host ~10 µs an op and the device under 1 µs: the card waits on the host.
Captured once into a `torch.cuda.CUDAGraph` and replayed, the whole chain
costs the host one launch, and the host issues what follows while the card
replays.

`GraphCache` holds one graph per key, and `key` derives a key from what a
call hands the graph.  A graph reads static copies of its inputs, made with
each input's shape, strides and dtype, and writes the same output tensors at
every replay: an output is valid until the next call with its key, so a
caller that keeps one clones it.  On tensors off a CUDA device the cache
calls the function directly, so every device runs the same functions.

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
from typing import Callable, Hashable

import torch


def _map(fn, tree):
    """`tree` (nested tuples, NamedTuples, lists and dicts) rebuilt with
    fn(leaf) in place of each leaf."""
    if isinstance(tree, (tuple, list)):
        values = [_map(fn, v) for v in tree]
        return type(tree)(*values) if hasattr(tree, "_fields") else type(tree)(values)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensors(tree, out: list) -> list:
    """`out` with the tensor leaves of `tree` appended, in _map's order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _signature(tree):
    """A hashable image of `tree`: its structure, each tensor leaf's shape,
    dtype and device, every other leaf as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.shape, tree.dtype, tree.device
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple([_signature(v) for v in tree])
    if isinstance(tree, dict):
        return dict, tuple([(k, _signature(v)) for k, v in tree.items()])
    return tree


def key(inputs, *fixed) -> Hashable:
    """A graph's key: the tree structure of `inputs`, each tensor leaf's
    shape, dtype and device, every other leaf (the graph folds it in as a
    Python value), and `fixed`, what the graph reads besides its inputs (a
    model read by address, settings).  New tensors of the same structure
    give the same key, so one graph serves them all."""
    return _signature(inputs), fixed


def _static(tree):
    """`tree` with an uninitialised copy of each tensor leaf (its shape,
    strides and dtype) in its place, and the copies in order."""
    copies = []

    def copy(t):
        if not isinstance(t, torch.Tensor):
            return t
        copies.append(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device))
        return copies[-1]

    return _map(copy, tree), copies


class _Graph:
    """One captured graph, its static inputs and the outputs it writes."""

    def __init__(self, fn: Callable, args, held, borrowed):
        self.borrowed = borrowed
        static_args, self.args = _static(args)
        static_held, self.held = _static(held)
        self.held_src = [None] * len(self.held)
        self.load(_tensors(args, []), _tensors(held, []))
        # warm up on the capture stream, then capture there (cuBLAS takes its
        # handle and workspace for a stream at the stream's first call)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(static_args, static_held)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(static_args, static_held)

    def load(self, args: list, held: list) -> None:
        for dst, src in zip(self.args, args):
            dst.copy_(src)
        if any(a is not b for a, b in zip(held, self.held_src)):
            for dst, src in zip(self.held, held):
                dst.copy_(src)
            self.held_src = held


class GraphCache:
    """`fn(args, held)` replayed from a CUDA graph, one capture per key.

    `args` and `held` are trees (nested tuples, NamedTuples, lists and
    dicts) of tensors and Python values; `fn` takes trees of the same
    structure and returns any structure of tensors.  Where every tensor of
    them is on a CUDA device (one device), `fn` must launch its work on the
    current stream, never read a value back to the host, branch only on
    what the key fixes, and read no tensor but its arguments and those
    `owner` keeps alive: the graph holds their addresses.  The entry is
    dropped when `owner` is garbage collected.  Elsewhere the call is
    `fn(args, held)`, and nothing is counted.

    A call copies every tensor of `args` into the graph's static inputs, and
    those of `held` only when they are other objects than the last call's
    (inputs that stay the same over several calls, such as a control step's
    terrain window read by each of its substeps; they are kept referenced,
    so an object seen again is the same tensor).  `fn` is handed the static
    trees, whose other leaves are the first call's.  `borrowed` is any
    object holding tensors that `fn` reads in place through its closure,
    never copied: another graph's outputs (see the module's docstring).  The
    entry keeps it referenced, and every call with the key must pass the
    same object.  The first call with a key warms `fn` up once and captures
    it (`captures`); every call then replays (`replays`)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graphs = {}

    def __call__(self, key: Hashable, owner, fn: Callable, args, held=(), borrowed=None):
        tensors, held_tensors = _tensors(args, []), _tensors(held, [])
        if not all(t.is_cuda for t in tensors + held_tensors):
            return fn(args, held)
        with torch.cuda.device(tensors[0].device):
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = _Graph(fn, args, held, borrowed)
                weakref.finalize(owner, self._graphs.pop, key, None)
                self.captures += 1
            else:
                if borrowed is not g.borrowed:
                    raise ValueError("GraphCache: the borrowed tensors differ from those the "
                                     "graph was captured with; the key must fix them")
                g.load(tensors, held_tensors)
            g.graph.replay()
        self.replays += 1
        return g.out
