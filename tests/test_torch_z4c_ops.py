"""The Z4c operators of the port against the JAX package's, on the CPU.

JAX runs in float64 in this suite (tests/conftest.py).  The inputs are
made with numpy from a seed and handed to both packages:

  * the finite-difference operators of ``z4c/fd.py`` for nghost 2-5, and
    the copy of their tables in the CUDA stage kernel;
  * the whole-array right-hand side ``Z4c.rhs`` on the single-puncture
    deck at 16^3 with every channel perturbed (the shift too, so both
    branches of the upwind select run): outflow faces (Sommerfeld rows
    on) at nghost 2 and 4, and periodic faces (no Sommerfeld rows) at
    nghost 3 with non-default gauge options;
  * ``alg_constr`` and the problem generator's arrays.

The JAX side runs outside ``jax.jit``: a right-hand side is thousands
of small operations, and each jnp function compiles once and is cached,
which is faster than compiling the whole right-hand side as one program.
"""

import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.z4c import fd as jax_fd  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.z4c import fd  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUNCTURE = os.path.join(ROOT, "inputs", "z4c", "one_puncture.athinput")
SMALL = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
         "mesh/x1min=-4.0", "mesh/x1max=4.0", "mesh/x2min=-4.0",
         "mesh/x2max=4.0", "mesh/x3min=-4.0", "mesh/x3max=4.0"]
PERIODIC = [f"mesh/{s}{a}_bc=periodic" for a in ("x1", "x2", "x3")
            for s in ("i", "o")]
GAUGE = ["z4c/shift_H=0.5", "z4c/shift_alpha2Gamma=0.3",
         "z4c/lapse_harmonic=0.4", "z4c/damp_kappa2=0.1",
         "z4c/chi_psi_power=-2.0"]
CASES = {"outflow_ng2": ["mesh/nghost=2"],
         "outflow_ng4": ["mesh/nghost=4"],
         "periodic_ng3": ["mesh/nghost=3"] + PERIODIC + GAUGE}


def builds(extra):
    """(JAX build, port build) of the puncture deck at 16^3."""
    pj = JaxInput.from_file(PUNCTURE)
    pt = ParameterInput.from_file(PUNCTURE)
    pj.modify_from_cmdline(SMALL + list(extra))
    pt.modify_from_cmdline(SMALL + list(extra))
    return jax_main.build(pj), torch_main.build(pt, device="cpu")


def perturbed(u, seed, eps=1e-2):
    """u plus seeded normal noise of size eps on every channel."""
    rng = np.random.default_rng(seed)
    return np.asarray(u) + eps * rng.normal(size=np.shape(u))


def scaled_err(got, want):
    """max |got - want| / max(|want|, 1), elementwise."""
    want = np.asarray(want)
    return float((np.abs(np.asarray(got) - want)
                  / np.maximum(np.abs(want), 1.0)).max())


@pytest.mark.parametrize("ng", [2, 3, 4, 5])
def test_fd_operators_match_jax(ng):
    rng = np.random.default_rng(ng)
    f = rng.normal(size=(2, 12, 13, 14))
    beta = rng.normal(size=f.shape)
    idx = (1.7, 2.3, 0.9)
    ft, bt = torch.from_numpy(f), torch.from_numpy(beta)
    pairs = []
    for d in range(3):
        pairs += [(fd.d1(ft, d, idx, ng), jax_fd.d1(f, d, idx, ng)),
                  (fd.d2(ft, d, idx, ng), jax_fd.d2(f, d, idx, ng)),
                  (fd.adv(bt, ft, d, idx, ng),
                   jax_fd.adv(beta, f, d, idx, ng)),
                  (fd.ko_diss(ft, d, idx, ng),
                   jax_fd.ko_diss(f, d, idx, ng))]
    for da, db in ((0, 1), (0, 2), (1, 2)):
        pairs.append((fd.d1d1(ft, da, db, idx, ng),
                      jax_fd.d1d1(f, da, db, idx, ng)))
    for got, want in pairs:
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-13


def _cuda_table(text, name):
    """Rows of a Z4C_*_TAB macro of the CUDA source, evaluated."""
    lines = text.splitlines()
    k = next(i for i, line in enumerate(lines)
             if line.startswith(f"#define {name}"))
    body = []
    while True:
        body.append(lines[k].rstrip().rstrip("\\"))
        if not lines[k].rstrip().endswith("\\"):
            break
        k += 1
    rows = re.findall(r"\{([^{}]*)\}", " ".join(body))

    def ev(expr):
        node = ast.parse(expr.strip(), mode="eval")
        allowed = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
                   ast.Div, ast.USub)
        assert all(isinstance(n, allowed) for n in ast.walk(node)), expr
        return eval(compile(node, "<table>", "eval"))

    return [[ev(x) for x in row.split(",")] for row in rows]


def test_cuda_stencil_tables_match_fd():
    """The CUDA kernel's copy of the tables equals fd.py's, and fd.py's
    offsets follow the rule the kernel computes them by."""
    with open(os.path.join(ROOT, "athenak_tpu_torch", "csrc",
                           "z4c_rhs.cuh")) as f:
        text = f.read()
    tabs = {"Z4C_D1_TAB": fd._D1, "Z4C_D2_TAB": fd._D2,
            "Z4C_ADV_TAB": fd._ADV_L, "Z4C_DISS_TAB": fd._DISS}
    offsets = {"Z4C_D1_TAB": lambda ng: [o for o in range(1 - ng, ng)
                                         if o != 0],
               "Z4C_D2_TAB": lambda ng: list(range(1 - ng, ng)),
               "Z4C_ADV_TAB": lambda ng: list(range(-ng, ng - 1)),
               "Z4C_DISS_TAB": lambda ng: list(range(-ng, ng + 1))}
    for name, tab in tabs.items():
        rows = _cuda_table(text, name)
        assert len(rows) == 4, name
        for ng, row in zip((2, 3, 4, 5), rows):
            assert row == [c for _, c in tab[ng]], (name, ng)
            assert [o for o, _ in tab[ng]] == offsets[name](ng), (name, ng)
    for ng in (2, 3, 4, 5):
        assert fd._ADV_R[ng] == [(-o, -c) for o, c in fd._ADV_L[ng]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rhs_matches_jax(case):
    (_, pj, _, _, sj), (_, pt, _, _, st) = builds(CASES[case])
    assert (pt.sbc_mask is None) == (pj.sbc_mask is None) \
        == case.startswith("periodic")
    assert pt.ng == pj.ng and pt.diss == pj.diss and pt.idx == pj.idx
    u = perturbed(sj["u"], 11)
    want = np.asarray(pj.rhs(jax.numpy.asarray(u)))
    got = pt.rhs(torch.from_numpy(u)).numpy()
    assert scaled_err(got, want) <= 1e-10
    # the shift was perturbed: both upwind branches ran
    beta = u[:, 19:22]
    assert (beta < 0).any() and (beta > 0).any()


def test_alg_constr_matches_jax():
    """The projection on a perturbed state (with cells of det g <= 0,
    which it leaves unscaled): to 1e-13, torch's x ** (1/3) standing for
    the cube root."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(CASES["outflow_ng2"])
    u = perturbed(sj["u"], 12)
    u[:, 1:7, :2] *= -1.0
    u0 = u.copy()
    want = np.asarray(pj.alg_constr(jax.numpy.asarray(u)))
    got = pt.alg_constr(torch.from_numpy(u)).numpy()
    assert scaled_err(got, want) <= 1e-13
    np.testing.assert_array_equal(u, u0)   # the input is not written


@pytest.mark.parametrize("case", ["outflow_ng2", "periodic_ng3"])
def test_pgen_and_options_match_jax(case):
    (mj, pj, _, _, sj), (mt, pt, _, _, st) = builds(CASES[case])
    assert set(st) == {"u", "w"} and st["w"] is st["u"]
    assert st["u"].dtype == torch.float64
    np.testing.assert_allclose(st["u"].numpy(), np.asarray(sj["u"]),
                               rtol=1e-14, atol=1e-14)
    assert vars(pt.opt) == vars(pj.opt)
    if pj.sbc_mask is not None:
        np.testing.assert_array_equal(pt.sbc_mask, pj.sbc_mask)
    assert pt.dt_from_state(st) == float(pj.dt_from_state(sj))
