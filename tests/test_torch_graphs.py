"""``athenak_tpu_torch.graphs.Graphed``: the CUDA-graph replay of the
dyngr stage's primitive solver and Z4c RHS with the matter source.

On the CPU the wrapped function runs as it is (no capture); the
structure helpers rebuild nested arguments and key captures by shape and
plain value.  The replay itself is checked on the card (marked ``cuda``,
skipped where no CUDA device is present): bitwise the eager call, as
captured and on new values.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import graphs  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.main import build  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DYN = os.path.join(ROOT, "inputs", "dyn_grmhd")


def _nested(seed):
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(rng.standard_normal((2, 3))) for _ in range(4)]
    return (t[0], [t[1], t[2]], {"a": t[3], "b": 0.5, "c": None})


def test_leaves_and_rebuild_round_trip():
    args = _nested(1)
    leaves = graphs._leaves(args, [])
    assert len(leaves) == 6
    back = graphs._rebuild(args, iter(leaves))
    assert back[0] is args[0] and back[1][1] is args[1][1]
    assert back[2]["a"] is args[2]["a"] and back[2]["b"] == 0.5
    assert back[2]["c"] is None and isinstance(back[1], list)


def test_key_by_shape_dtype_and_value():
    a, b = _nested(1), _nested(2)
    assert graphs._key(a) == graphs._key(b)
    c = (a[0][:1], a[1], a[2])
    assert graphs._key(c) != graphs._key(a)
    d = (a[0], a[1], dict(a[2], b=0.25))
    assert graphs._key(d) != graphs._key(a)
    e = (a[0].float(), a[1], a[2])
    assert graphs._key(e) != graphs._key(a)


def test_clone_owns_its_tensors():
    args = _nested(3)
    out = graphs._clone(args)
    assert graphs._key(out) == graphs._key(args)
    for x, y in zip(graphs._leaves(out, []), graphs._leaves(args, [])):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
        else:
            assert x == y


def test_cpu_arguments_run_the_function_as_it_is():
    calls = []

    def fn(x, ys, opts):
        calls.append(1)
        return {"s": x + ys[0] * ys[1], "k": [opts["a"] * opts["b"]]}

    g = graphs.Graphed(fn)
    args = _nested(4)
    got = g(*args)
    ref = fn(*args)
    assert torch.equal(got["s"], ref["s"])
    assert torch.equal(got["k"][0], ref["k"][0])
    assert len(calls) == 2 and (g.captures, g.replays) == (0, 0)


def _cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_c2p_graph_bitwise_on_the_card():
    """tov_cowling (f64): the graphed primitive solve equals the eager
    one, as captured and on a perturbed state; one capture, two
    replays."""
    _cards()
    pin = ParameterInput.from_file(os.path.join(DYN,
                                                "tov_cowling.athinput"))
    _, phys, _, _, state = build(pin, device="cuda")
    adm = phys.adm_of(state)
    ps = phys.ps
    graphed = ps._c2p_graph
    gen = torch.Generator(device="cuda").manual_seed(5)
    for u in (state["u"], state["u"] * (1.0 + 1e-3 * torch.rand(
            state["u"].shape, generator=gen, device="cuda",
            dtype=state["u"].dtype))):
        got = phys.cons_to_prim(u, state["bcc"], adm)
        ps._c2p_graph = ps._con_to_prim
        try:
            ref = phys.cons_to_prim(u, state["bcc"], adm)
        finally:
            ps._c2p_graph = graphed
        for a, b in zip(got[:3], ref[:3]):
            assert torch.equal(a, b)
        for k in ref[3]:
            assert torch.equal(got[3][k], ref[3][k])
    assert (graphed.captures, graphed.replays) == (1, 2)


@pytest.mark.cuda
def test_matter_rhs_graph_bitwise_on_the_card():
    """tov_z4c_smr as shipped (f64, two levels): the graphed Z4c RHS
    with the matter source equals the eager RHS, as captured and on a
    perturbed z."""
    _cards()
    pin = ParameterInput.from_file(os.path.join(DYN,
                                                "tov_z4c_smr.athinput"))
    _, phys, _, _, state = build(pin, device="cuda")
    tm = phys.set_tmunu(state["u"], state["w"], state["bcc"],
                        phys.adm_of(state))
    z = state["z"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    for zz in (z, z * (1.0 + 1e-6 * (torch.rand(
            z.shape, generator=gen, device="cuda", dtype=z.dtype) - 0.5))):
        assert torch.equal(phys.z4c._matter_rhs(zz, tm),
                           phys.z4c.rhs(zz, tmunu=tm))
    g = phys.z4c._matter_rhs
    assert (g.captures, g.replays) == (1, 2)
