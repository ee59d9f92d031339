"""Replay of pure tensor functions as CUDA graphs.

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

``Window`` replays the driver's batched cycle window, k cycles with the
dt chain on the device: the state is copied into the capture's buffers
once a window (``load``), every replay carries it on in place (the
capture ends by writing its new state, t, dt and cycle count over its
inputs), and ``state()`` copies it out once when the window ends.

A replay runs no Python wrapper, so it raises no kernel's launch count
(``kernels.Kernel.launches``).  Each capture records the launches its
wrappers counted while it was captured and takes them off again (a
capture runs nothing), and every replay adds them.  The warm-up call
before a capture, whose result is dropped, does none of the run's work:
its launches are taken off too.  So the counts are what an eager run of
the same calls would have counted.
"""

from __future__ import annotations

import gc

import torch

# the captures a Graphed holds at once (each holds its buffers and
# memory pool)
KEEP = 2


# dicts are walked in the order of their sorted keys, so that two states
# whose dicts were built in another order have the same key and leaves


def _leaves(obj, out):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            _leaves(o, out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], out)
    else:
        out.append(obj)
    return out


def _rebuild(obj, it):
    if isinstance(obj, list):
        return [_rebuild(o, it) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_rebuild(o, it) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(obj[k], it) for k in sorted(obj)}
    return next(it)


def _key(obj):
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_key(o) for o in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _key(obj[k])) for k in sorted(obj))
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    return ("value", obj)


def _clone(obj):
    return _rebuild(obj, iter([t.clone() if isinstance(t, torch.Tensor)
                               else t for t in _leaves(obj, [])]))


def _counts():
    from . import kernels
    return [k.launches for k in kernels.ALL]


def _restore(counts) -> None:
    from . import kernels
    for k, n in zip(kernels.ALL, counts):
        k.launches = n


def _add(launches) -> None:
    from . import kernels
    for k, n in zip(kernels.ALL, launches):
        k.launches += n


def _warm_up(fn, *args):
    """One eager call on a side stream, its result dropped and its
    launches taken off the counts: lazy device tables, the kernels'
    first loads and the allocator's blocks are made outside the
    capture."""
    counts = _counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    _restore(counts)


def _capture(fn, *args):
    """(graph, fn's result on ``args`` as captured, the launches the
    wrappers counted while capturing, taken off the counts).  Garbage is
    collected first: a dropped capture found by the collector during
    this one would free its memory pool inside the capture, which ends
    it with an error."""
    counts = _counts()
    gc.collect()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    launched = [n - c for n, c in zip(_counts(), counts)]
    _restore(counts)
    return graph, out, launched


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
        graph, static, out, launched = entry
        for s, t in zip(_leaves(static, []), leaves):
            if isinstance(s, torch.Tensor):
                s.copy_(t)
        graph.replay()
        _add(launched)
        self.replays += 1
        return _clone(out)

    def _capture(self, args):
        static = _clone(args)
        _warm_up(self.fn, *static)
        graph, out, launched = _capture(self.fn, *static)
        self.captures += 1
        return graph, static, out, launched


class Window:
    """The driver's window ``batch(state, t, dt, ncyc, nlim_eff) ->
    (state, t, dt, ncyc, counters)`` captured once on copies of its
    arguments, after a warm-up call of ``warm`` (the same signature; the
    driver's one-cycle window) or of ``batch``; ``replay()`` runs the
    next batch in place and returns (t, dt, ncyc, counters), tensors of
    the capture that the next replay overwrites.  The capture raises if
    the batch reads the host (a CUDA error of the capture) or changes the
    state's structure."""

    def __init__(self, batch, state, scalars, warm=None) -> None:
        self.static = _clone((state, tuple(scalars)))
        # ``warm``: a one-cycle window for the warm-up (its work dropped)
        _warm_up(lambda s, sc: (warm or batch)(s, *sc),
                 *_clone((state, tuple(scalars))))

        def run(st, sc):
            st2, t, dt, ncyc, counters = batch(st, *sc)
            if _key(st2) != _key(st):
                raise RuntimeError("the window changed the state's "
                                   "structure; it cannot replay in place")
            # the new state, t, dt and cycle count over the inputs, so the
            # next replay starts from them
            for dst, src in zip(_leaves(st, []) + list(sc[:3]),
                                _leaves(st2, []) + [t, dt, ncyc]):
                if isinstance(dst, torch.Tensor) and dst is not src:
                    dst.copy_(src)
            return counters

        self.graph, self.counters, self.launched = _capture(
            run, *self.static)

    def load(self, state, scalars) -> None:
        """Copy a window's starting state and scalars into the capture's
        buffers (the structure it was captured with)."""
        if _key((state, tuple(scalars))) != _key(self.static):
            raise ValueError("the window was captured for another "
                             "structure of state")
        for dst, src in zip(_leaves(self.static, []),
                            _leaves((state, tuple(scalars)), [])):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def replay(self):
        self.graph.replay()
        _add(self.launched)
        t, dt, ncyc = self.static[1][:3]
        return t, dt, ncyc, self.counters

    def state(self):
        """The state after the last replay, copied out of the capture's
        buffers."""
        return _clone(self.static[0])
