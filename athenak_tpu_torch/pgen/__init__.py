"""Problem generators: initial conditions for a deck.

Counterpart of ``athenak_tpu/pgen/__init__.py`` (reference:
src/pgen/pgen.hpp:27-93).  Each generator is a module with

    init(pin, mesh, phys) -> state      # tensors on phys.device

and optionally

    final(pin, mesh, phys, state)       # after the run, e.g. error files

selected by <problem>/pgen_name.  The blast wave and driven turbulence
(hydro and MHD), the shock tubes, Kelvin-Helmholtz, Shu-Osher, the
linear waves, the Orszag-Tang vortex, the circularly polarised Alfven
wave, the field loop, the current sheet, Rayleigh-Taylor, the
Liska-Wendroff implosion, the slotted cylinder, the advection test and
the Z4c generators (single, boosted and two punctures, Kerr-Schild, the
linear wave and the AwA gauge-wave and robust-stability tests), the GR
generators (Bondi accretion, the split monopole, the Fishbone-Moncrief
torus), the star-disk magnetosphere, the diffusion decay tests, the
shock-cloud interaction, the self-gravity problems (the Jeans wave,
the binary potential, the Bonnor-Ebert collapse), the shearing-box
problems (the shearing waves, the 2-D and 3-D MRI), the ion-neutral
two-fluid state and the radiation problems (the hohlraum, the beam in
Kerr and in snake coordinates, thermal relaxation, the shadow, the
radiating linear wave, the diffusing pulse) and the dynamical-GRMHD
generators (the TOV star, the superposed binary black hole, the
imported ADM and BNS volumes; the shock tube on a flat ADM slice) are
ported so far.
"""

from __future__ import annotations

from importlib import import_module

import numpy as np
import torch

_REGISTRY = {
    "linear_wave": "athenak_tpu_torch.pgen.linear_wave",
    "shock_tube": "athenak_tpu_torch.pgen.shock_tube",
    "orszag_tang": "athenak_tpu_torch.pgen.orszag_tang",
    "blast": "athenak_tpu_torch.pgen.blast",
    "cpaw": "athenak_tpu_torch.pgen.cpaw",
    "alfven_wave": "athenak_tpu_torch.pgen.cpaw",
    "field_loop": "athenak_tpu_torch.pgen.field_loop",
    "turb": "athenak_tpu_torch.pgen.turb",
    "z4c_one_puncture": "athenak_tpu_torch.pgen.z4c_one_puncture",
    "z4c_linear_wave": "athenak_tpu_torch.pgen.z4c_linear_wave",
    "z4c_two_punctures": "athenak_tpu_torch.pgen.z4c_two_punctures",
    "z4c_two_puncture": "athenak_tpu_torch.pgen.z4c_two_punctures",
    "z4c_kerr_schild": "athenak_tpu_torch.pgen.z4c_kerr_schild",
    "kerr_schild": "athenak_tpu_torch.pgen.z4c_kerr_schild",
    "z4c_gauge_wave": "athenak_tpu_torch.pgen.z4c_gauge_wave",
    "gauge_wave": "athenak_tpu_torch.pgen.z4c_gauge_wave",
    "z4c_stability": "athenak_tpu_torch.pgen.z4c_stability",
    "robust_stability": "athenak_tpu_torch.pgen.z4c_stability",
    "z4c_boosted_puncture": "athenak_tpu_torch.pgen.z4c_boosted_puncture",
    "kh": "athenak_tpu_torch.pgen.kh",
    "current_sheet": "athenak_tpu_torch.pgen.current_sheet",
    "shu_osher": "athenak_tpu_torch.pgen.shu_osher",
    "rt": "athenak_tpu_torch.pgen.rt",
    "implode": "athenak_tpu_torch.pgen.lw_implode",
    "lw_implode": "athenak_tpu_torch.pgen.lw_implode",
    "slotted_cyl": "athenak_tpu_torch.pgen.slotted_cyl",
    "slotted_cylinder": "athenak_tpu_torch.pgen.slotted_cyl",
    "advection": "athenak_tpu_torch.pgen.advection",
    "gr_bondi": "athenak_tpu_torch.pgen.gr_bondi",
    "gr_monopole": "athenak_tpu_torch.pgen.gr_monopole",
    "gr_torus": "athenak_tpu_torch.pgen.gr_torus",
    "disk_magnetosphere": "athenak_tpu_torch.pgen.disk_magnetosphere",
    "diffusion_test": "athenak_tpu_torch.pgen.diffusion_test",
    "shock_cloud": "athenak_tpu_torch.pgen.shock_cloud",
    "jeans": "athenak_tpu_torch.pgen.jeans_wave",
    "gravity": "athenak_tpu_torch.pgen.jeans_wave",
    "binary_gravity": "athenak_tpu_torch.pgen.binary_gravity",
    "be_collapse": "athenak_tpu_torch.pgen.be_collapse",
    "shwave": "athenak_tpu_torch.pgen.shwave",
    "mri2d": "athenak_tpu_torch.pgen.mri2d",
    "mri3d": "athenak_tpu_torch.pgen.mri3d",
    "twofluid": "athenak_tpu_torch.pgen.twofluid",
    "rad_hohlraum": "athenak_tpu_torch.pgen.rad_hohlraum",
    "rad_beam": "athenak_tpu_torch.pgen.rad_beam",
    "rad_snake": "athenak_tpu_torch.pgen.rad_snake",
    "rad_relax": "athenak_tpu_torch.pgen.rad_relax",
    "rad_shadow": "athenak_tpu_torch.pgen.rad_shadow",
    "rad_linear_wave": "athenak_tpu_torch.pgen.rad_linear_wave",
    "rad_diffusion": "athenak_tpu_torch.pgen.rad_diffusion",
    "dynbbh": "athenak_tpu_torch.pgen.dynbbh",
    "z4c_adm_import": "athenak_tpu_torch.pgen.import_id",
    "dyngr_bns_import": "athenak_tpu_torch.pgen.import_id",
    "tov": "athenak_tpu_torch.pgen.dyngr_tov",
    "dyngr_tov": "athenak_tpu_torch.pgen.dyngr_tov",
}


def get_pgen(name: str):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"problem/pgen_name = '{name}' is not ported to "
            f"athenak_tpu_torch yet (ported: {sorted(_REGISTRY)})")
    return import_module(_REGISTRY[name])


def to_device(phys, a):
    """A host array as a tensor on the run's device at its dtype."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=phys.dtype,
                           device=phys.device)


def host64(t):
    """A tensor as a float64 numpy array on the host (the user history
    functions sum in float64, as the JAX package's do)."""
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def state_from_prims(phys, w, bfc=None):
    """Build the initial state from host primitive arrays: move (w, bfc)
    to the device at the run's dtype, then (under MHD) bcc and
    prim -> cons there."""
    wt = to_device(phys, w)
    if bfc is None:
        return phys.make_state(phys.prim_to_cons(wt), wt)
    bfct = {k: to_device(phys, v) for k, v in bfc.items()}
    bcc = phys.compute_bcc(bfct)
    return phys.make_state(phys.prim_to_cons(wt, bcc), wt, bfct, bcc=bcc)
