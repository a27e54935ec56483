"""The asserts of examples 01, 03, 07, 08, 11 and 13 through the port.

The six scripts assert invariants of the model layer: mass closure of the
Schneider19 (01), Arico20 (11) and Mead20 (13) components, the
pixel-window pipeline against brute-force Hankel quadrature and the shape
of its suppression (03), the shock model's contract (07), and the
Schneider+19 Fig. 1 curves against the scraped figure with the
scrape-jitter attribution of their residuals (08, reading
``examples/data/S19_Fig1_Scrapped.csv``). ``chip_smoke.py`` restates each
script's asserts with the port's names, at the script's own bars
(``example01`` ... ``example13``; where a script calls JAX itself, the
step is restated in torch), and its ``examples`` phase runs all of them
on the card. Here they run on the CPU in float64.

Only the card runs example 03's third anchor (the S19 Gas profile through
HealPixel(128) against an 80,000-point quadrature, ~1e9 Bessel
evaluations); its first two anchors (3.2e8 each) run here.
"""

import numpy as np
import torch

import baryonification_tpu_torch as T

import chip_smoke as cs

torch.set_num_threads(1)


def test_example01_mass_closure():
    values, fails = cs.example01(T, "cpu")
    assert not fails
    assert len(values["nfw"]) == len(values["budget"]) == 3


def test_example03_pixel_smoothing():
    values, fails = cs.example03(T, torch, "cpu", anchors=(1, 2))
    assert not fails
    assert values["anchor1"] < 5e-4 and values["anchor2"] < 2e-4
    assert "anchor3" not in values


def test_example07_shocks():
    values, fails = cs.example07(T, "cpu")
    assert not fails
    assert abs(values["eps4"]["mid"] - 0.625) < 1e-6


def test_example08_fig1():
    values, fails = cs.example08(T, "cpu")
    assert not fails
    assert set(values["rms"]) == set(cs.FIG1_CURVES)
    for panel in cs.FIG1_PANELS:
        assert 0.8 < values["jitter"][panel][2] < 1.2


def test_example11_arico_bookkeeping():
    values, fails = cs.example11(T, "cpu")
    assert not fails
    np.testing.assert_allclose(values["budget"], 1.0, atol=0.02)


def test_example13_mead_bookkeeping():
    values, fails = cs.example13(T, "cpu")
    assert not fails
    for name in ("Params_TAGN_7p6", "Params_TAGN_8p0"):
        np.testing.assert_allclose(values[f"{name} total"], 1.0, atol=0.02)
