"""Replay of a pure tensor function as a CUDA graph.

A function whose work is many small element-wise launches and no host
read (the primitive solver's fixed-trip root solve: some 7,700 torch ops
a call) is bound by the host's launch rate on a small grid.  ``Graphed``
captures it once for each set of argument shapes and replays the
capture: the same kernels on the same values, so the results are
bitwise those of the eager call, from one host launch.

Arguments and results are nested lists, tuples and dicts of tensors and
plain values.  The arguments are copied into the capture's own buffers
before each replay and the results cloned out of its memory pool after
it, so the caller owns what it gets.  Plain values (floats, ``None``)
are part of the capture's key.  On CPU tensors the function runs as it
is.
"""

from __future__ import annotations

import torch

# the captures a Graphed holds at once (each holds its buffers and
# memory pool)
KEEP = 2


def _leaves(obj, out):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            _leaves(o, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out)
    else:
        out.append(obj)
    return out


def _rebuild(obj, it):
    if isinstance(obj, list):
        return [_rebuild(o, it) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_rebuild(o, it) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, it) for k, v in obj.items()}
    return next(it)


def _key(obj):
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_key(o) for o in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _key(v)) for k, v in obj.items())
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    return ("value", obj)


def _clone(obj):
    return _rebuild(obj, iter([t.clone() if isinstance(t, torch.Tensor)
                               else t for t in _leaves(obj, [])]))


class Graphed:
    """``fn`` replayed from a CUDA graph on CUDA arguments; the KEEP most
    recently used captures are held, older ones are freed.  ``captures``
    and ``replays`` count what was done."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self._graphs = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *args):
        leaves = _leaves(args, [])
        first = next((t for t in leaves if isinstance(t, torch.Tensor)),
                     None)
        if first is None or not first.is_cuda:
            return self.fn(*args)
        key = _key(args)
        entry = self._graphs.pop(key, None)
        if entry is None:
            entry = self._capture(args)
        self._graphs[key] = entry
        while len(self._graphs) > KEEP:
            self._graphs.pop(next(iter(self._graphs)))
        graph, static, out = entry
        for s, t in zip(_leaves(static, []), leaves):
            if isinstance(s, torch.Tensor):
                s.copy_(t)
        graph.replay()
        self.replays += 1
        return _clone(out)

    def _capture(self, args):
        static = _clone(args)
        # one eager call on a side stream first: lazy device tables and
        # the allocator's blocks are made outside the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*static)
        self.captures += 1
        return graph, static, out
