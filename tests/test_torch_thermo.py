"""The port's thermodynamic profiles and pixel windows against the JAX
package (the tSZ table and its paint: test_torch_tsz.py).

Same inputs, made with numpy, through both packages in float64 on the
CPU. Tolerances:
- closed forms (the pixel windows, the non-thermal fractions, the gas
  number density, the -99 sentinel): rtol 1e-10;
- quadratures, roots and fixed points (``mass_translator``'s bisection,
  ``Pressure``'s inward integral and everything built on it,
  ``ConvolvedProfile``'s FFTLog round trip): 1e-8 of max|value|, with
  the same non-finite entries.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.cosmology.massdef import mass_translator as j_mt
from baryonification_tpu_torch.cosmology.massdef import (
    mass_translator as t_mt)

torch.set_num_threads(1)

COSMO_DICT = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
                  w0=-1.0)
# examples/05_paint_tsz_shell.py, with a non-thermal fraction's parameters
PAR = dict(epsilon=4.0, theta_ej=4, theta_co=0.1, M_c=1e14, mu_beta=0.1,
           gamma=2.5, delta=7, eta=0.3, eta_delta=0.1, tau=-1.5,
           tau_delta=0, A=0.055, M1=3e11, epsilon_h=0.015, a=0.3, n=2.0,
           p=0.3, q=0.707, cutoff=np.inf, proj_cutoff=1000)
NT = dict(alpha_nt=0.2, nu_nt=0.3, gamma_nt=0.8)
MASSES = np.array([3e12, 5e13, 8e14])
RADII = np.geomspace(1e-3, 30, 40)
SCALES = (0.6, 0.9)
NSIDE = 64


@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology.from_dict(COSMO_DICT, device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def close_of_max(got, want, frac=1e-8):
    """Agree to ``frac`` of max|want|, with the same non-finite entries."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=frac * np.abs(want[fin]).max())


@pytest.mark.parametrize("pair", [("critical", "matter"),
                                  ("matter", "critical")])
def test_mass_translator(pair, cosmo, cosmo_t):
    """200c <-> 200m through Diemer15 (the Green+20 fraction's use)."""
    din, dout = pair
    M = np.geomspace(1e12, 1e16, 9)
    for a in SCALES:
        want = j_mt(cosmo, M, a, J.MassDef(200, din), J.MassDef(200, dout),
                    J.cosmology.ConcentrationDiemer15(J.MassDef(200, din)))
        got = t_mt(cosmo_t, torch.tensor(M), a, T.MassDef(200, din),
                   T.MassDef(200, dout),
                   T.cosmology.ConcentrationDiemer15(T.MassDef(200, din)))
        close_of_max(got, want)
        assert not np.allclose(_np(got), M)
    md = T.MassDef(200, "critical")
    R = md.get_radius(cosmo_t, torch.tensor(M), 0.8)
    np.testing.assert_allclose(md.get_mass(cosmo_t, R, 0.8).numpy(), M,
                               rtol=1e-12)
    assert md.get_Delta() == 200


THERMO = ["Pressure", "ElectronPressure", "GasNumberDensity", "Temperature",
          "ThermalSZ", "NonThermalFrac", "NonThermalFracGreen20"]
CLOSED = {"GasNumberDensity", "NonThermalFrac"}


@pytest.mark.parametrize("name", THERMO)
def test_thermodynamic_profiles(name, cosmo, cosmo_t):
    """Every thermodynamic class, real and projected, 3 masses x 40 radii
    x 2 scale factors."""
    kw = dict(PAR, **NT)
    pj = getattr(J.profiles, name)(**kw)
    pt = getattr(T.profiles, name)(**kw)
    for a in SCALES:
        for what in ("real", "projected"):
            want = getattr(pj, what)(cosmo, RADII, MASSES, a)
            got = getattr(pt, what)(cosmo_t, RADII, MASSES, a)
            if name == "ThermalSZ" and what == "real":
                # the sentinel that lets the profile ride through a table
                np.testing.assert_array_equal(_np(got), _np(want))
                assert (_np(got) == -99.0).all()
            elif name in CLOSED and what == "real":
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-10,
                                           atol=0)
            else:
                close_of_max(got, want)
    # scalar radius and mass squeeze as in the JAX package
    got = pt.projected(cosmo_t, 0.3, 1e14, 0.8)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got),
                               float(pj.projected(cosmo, 0.3, 1e14, 0.8)),
                               rtol=1e-8)


def test_xray_luminosity_raises():
    for pkg in (J, T):
        with pytest.raises(NotImplementedError, match="calibrated"):
            pkg.XrayLuminosity(**PAR)


PIXELS = {"GridPixelApprox": (0.7,), "HealPixel": (NSIDE,), "NoPix": ()}


@pytest.mark.parametrize("name", list(PIXELS))
def test_pixel_windows(name):
    """The windows in k, across GridPixelApprox's series branch at
    kr = 1e-2."""
    k = np.geomspace(1e-5, 1e4, 97)
    wj = getattr(J, name)(*PIXELS[name])
    wt = getattr(T, name)(*PIXELS[name])
    assert wt.isHarmonic == wj.isHarmonic and wt.size == wj.size
    for what in ("real", "projected"):
        want = _np(getattr(wj, what)(k))
        got = getattr(wt, what)(torch.tensor(k)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    if name == "GridPixelApprox":
        kr = k * 2 * np.sqrt(0.7**2 / np.pi)
        assert (kr < 1e-2).any() and (kr > 1e-2).any()


CONVOLVED = [("NoPix", "Gas"), ("GridPixelApprox", "Gas"),
             ("HealPixel", "ThermalSZ")]


@pytest.mark.parametrize("pix,prof", CONVOLVED)
def test_convolved_profile(pix, prof, cosmo, cosmo_t):
    cj = J.ConvolvedProfile(getattr(J.profiles, prof)(**PAR),
                            getattr(J, pix)(*PIXELS[pix]))
    ct = T.ConvolvedProfile(getattr(T.profiles, prof)(**PAR),
                            getattr(T, pix)(*PIXELS[pix]))
    for a in SCALES:
        for what in ("real", "projected"):
            want = _np(getattr(cj, what)(cosmo, RADII, MASSES, a))
            got = getattr(ct, what)(cosmo_t, RADII, MASSES, a)
            if pix == "HealPixel" and what == "real":
                # the HEALPix window has no 3D meaning: it zeroes it
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                close_of_max(got, want)
    # delegation to the wrapped profile, and pickling
    assert ct.mass_def == ct.Profile.mass_def
    assert ct.precision_fftlog is ct.Profile.precision_fftlog
    back = pickle.loads(pickle.dumps(ct))
    assert back.Pixel.size == ct.Pixel.size
    with pytest.raises(AttributeError):
        ct.no_such_attribute


def test_harmonic_projection_refuses_z0(cosmo_t):
    ct = T.ConvolvedProfile(T.ThermalSZ(**PAR), T.HealPixel(NSIDE))
    with pytest.raises(AssertionError, match="a = 1"):
        ct.projected(cosmo_t, RADII, MASSES, 1.0)


def test_comoving_angular_distance(cosmo, cosmo_t):
    a = np.linspace(0.3, 0.95, 7)
    np.testing.assert_allclose(
        cosmo_t.comoving_angular_distance(torch.tensor(a)).numpy(),
        np.asarray(cosmo.comoving_angular_distance(a)), rtol=1e-10)


def test_thermo_profiles_in_place_of_gas(cosmo, cosmo_t):
    """Pressure with its non-thermal fraction taken off, and Temperature
    built from it, as users combine them."""
    kw = dict(PAR, **NT)
    pj = J.Pressure(**kw) * (1 - J.NonThermalFrac(**kw))
    pt = T.Pressure(**kw) * (1 - T.NonThermalFrac(**kw))
    close_of_max(pt.real(cosmo_t, RADII, MASSES, 0.7),
                 pj.real(cosmo, RADII, MASSES, 0.7))
    gj = J.Temperature(pressure=pj, **kw)
    gt = T.Temperature(pressure=copy.deepcopy(pt), **kw)
    close_of_max(gt.projected(cosmo_t, RADII, MASSES, 0.7),
                 gj.projected(cosmo, RADII, MASSES, 0.7))
