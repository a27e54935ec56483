"""The port's other profile families against the JAX package: ShockedGas,
Battaglia, ConcentrationDuffy08, Arico20's root find and every Mead20
class (every Arico20 class: test_torch_arico.py; the displacement tables
and grid runs of both families: test_torch_family_tables.py).

Same inputs, made with numpy, in float64 on the CPU; APAR (reference
example 12, tests/test_arico.py) and Params_TAGN_7p8. Tolerances:
- closed forms: rtol 1e-10 (entries that underflow to 0 in either
  package are held to 1e-14 of max|value| instead);
- quadratures, roots and fixed points (numerical normalizations, the
  root finds of ModifiedDarkMatter and Mead's EjectedGas, the collisionless
  relaxation and everything built on it, every projection): 1e-8 of
  max|value|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.profiles import arico20 as JA, mead20 as JM
from baryonification_tpu.profiles import battaglia as JB
from baryonification_tpu_torch.profiles import arico20 as TA, mead20 as TM
from baryonification_tpu_torch.profiles import battaglia as TB

from test_arico import APAR       # reference example 12's Arico20 set
from test_torch_thermo import COSMO_DICT, PAR, _np, close_of_max

torch.set_num_threads(1)

MPAR = dict(JM.Params_TAGN_7p8)
MASSES = np.array([3e12, 5e13, 8e14])
RADII = np.geomspace(1e-3, 30, 40)
SCALES = (0.6, 0.9)


@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology.from_dict(COSMO_DICT, device="cpu")


def closed_form(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-14 * np.abs(want).max())


def test_concentration_duffy08(cosmo, cosmo_t):
    M = np.geomspace(1e11, 1e16, 11)
    for rho in ("critical", "matter"):
        cj = J.cosmology.ConcentrationDuffy08(J.MassDef(200, rho))
        ct = T.cosmology.ConcentrationDuffy08(T.MassDef(200, rho))
        for a in SCALES:
            closed_form(ct(cosmo_t, torch.tensor(M), a), cj(cosmo, M, a))
    with pytest.raises(KeyError):
        T.cosmology.ConcentrationDuffy08(T.MassDef(500, "critical"))(
            cosmo_t, torch.tensor(M), 0.8)


def test_shocked_gas(cosmo, cosmo_t):
    kw = dict(PAR, epsilon_shock=1.5, width_shock=0.3)
    pj, pt = J.ShockedGas(**kw), T.ShockedGas(**kw)
    for a in SCALES:
        for what in ("real", "projected"):
            close_of_max(getattr(pt, what)(cosmo_t, RADII, MASSES, a),
                         getattr(pj, what)(cosmo, RADII, MASSES, a))
    # the shock takes the gas down to a quarter far outside it
    far = pt.real(cosmo_t, 500.0, 1e14, 0.8)
    gas = T.Gas(**kw).real(cosmo_t, 500.0, 1e14, 0.8)
    np.testing.assert_allclose(float(far), 0.25 * float(gas), rtol=1e-6)


BATTAGLIA = [("Pressure", "200_AGN"), ("Pressure", "500_AGN"),
             ("Pressure", "500_SH"), ("ElectronPressure", "500_SH"),
             ("GasDensity", "200_AGN"), ("GasDensity", "200_SH")]


@pytest.mark.parametrize("name,model", BATTAGLIA)
def test_battaglia(name, model, cosmo, cosmo_t):
    for truncate in (False, 2.0):
        pj = getattr(JB, name)(model, truncate=truncate)
        pt = getattr(TB, name)(model, truncate=truncate)
        assert pt.mass_def == pt.mdef
        assert pt.mass_def.Delta == pj.mass_def.Delta
        for a in SCALES:
            closed_form(pt.real(cosmo_t, RADII, MASSES, a),
                        pj.real(cosmo, RADII, MASSES, a))
        close_of_max(pt.projected(cosmo_t, RADII, MASSES, 0.8),
                     pj.projected(cosmo, RADII, MASSES, 0.8))
    with pytest.raises(ValueError, match="Model_def"):
        getattr(TB, name)("300_XYZ")


def test_pchip_local_root():
    """The batched root against the JAX function of one row, on rows
    whose sign change sits at the grid's ends, in its middle, and
    decreasing."""
    x = np.linspace(-3.0, 2.0, 64)
    lny = np.log(np.geomspace(1e-2, 10, 64))
    rows = np.stack([np.sinh(x - s) * g for s, g in
                     ((-2.9, 1.0), (0.3, 2.0), (1.9, 0.5), (0.0, -1.0))])
    want = [float(JA.pchip_local_root(jnp.asarray(r), jnp.asarray(lny)))
            for r in rows]
    got = TA.pchip_local_root(torch.tensor(rows), torch.tensor(lny))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


MEAD = [n for n in JM.__all__ if n not in ("model_params", "MeadProfiles")
        and not n.startswith("Params")]
MEAD_CLOSED = {"DarkMatter", "TwoHalo", "Stars", "CollisionlessMatter",
               "DarkMatterOnly", "DarkMatterOnlywithLSS", "Temperature"}


def _family_case(jm, tm, par, closed, name, cosmo, cosmo_t):
    """Real at both scale factors; projected at one, but for the withLSS
    variants, whose projection is the same integral as their parent's."""
    pj, pt = getattr(jm, name)(**par), getattr(tm, name)(**par)
    for a in SCALES:
        want = pj.real(cosmo, RADII, MASSES, a)
        got = pt.real(cosmo_t, RADII, MASSES, a)
        if name in closed:
            closed_form(got, want)
        else:
            close_of_max(got, want)
    if not name.endswith("withLSS"):
        close_of_max(pt.projected(cosmo_t, RADII, MASSES, 0.8),
                     pj.projected(cosmo, RADII, MASSES, 0.8))


@pytest.mark.parametrize("name", MEAD)
def test_mead20(name, cosmo, cosmo_t):
    _family_case(JM, TM, MPAR, MEAD_CLOSED, name, cosmo, cosmo_t)


def test_family_vocabularies():
    assert TA.model_params == JA.model_params
    assert TM.model_params == JM.model_params
    for k in ("Params_TAGN_7p6", "Params_TAGN_7p8", "Params_TAGN_8p0"):
        assert getattr(TM, k) == getattr(JM, k)
    gas = TA.Gas(**APAR)
    assert gas.mass_def == TA.BoundGas().mass_def
    assert gas.precision_fftlog is gas.myprof.precision_fftlog
    gas.set_parameter("theta_out", 2)
    assert gas.myprof.left.left.theta_out == 2
    assert T.profiles.Arico20 is TA and T.profiles.Mead20 is TM
    assert T.profiles.Battaglia is TB
    assert T.profiles.Thermodynamic.ThermalSZ is T.ThermalSZ


def test_smoke_parameters():
    """chip_smoke.py's Arico20 parameters, which it and the card tests of
    tests/test_torch_cuda.py use, are reference example 12's set."""
    import chip_smoke
    assert chip_smoke.APAR == APAR
    assert "jax" in __import__("sys").modules     # importing it left JAX be
