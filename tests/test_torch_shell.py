"""The port's shell-baryonify slice end to end against the JAX package.

``BaryonifyShell(method="scatter").process()`` of both packages on the
``shell_setup`` inputs of test_runners.py (NSIDE 32, 25 halos), float64
on the CPU. The maps must agree to rms/mean < 1e-10, the bar of
test_runners.py::test_matches_bruteforce, once with the port's own
displacement table and once with the JAX table carried across.
"""

import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops import healpix as jhpx
from baryonification_tpu_torch.ops import scatter_cuda
from baryonification_tpu_torch.runners.shell_cellmajor import MAX_PROPS

from test_profiles import PAR
from test_runners import COSMO_DICT

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TABLE_GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=4,
                  M_min=1e13, M_max=1e15, N_samples_Mass=6,
                  R_min=1e-3, R_max=70, N_samples_R=64)


@pytest.fixture(scope="module")
def inputs():
    """The shell_setup recipe of test_runners.py, as numpy arrays."""
    nside = 32
    rng = np.random.default_rng(11)
    n_halo = 25
    ra = rng.uniform(0, 360, n_halo)
    dec = np.degrees(np.arcsin(rng.uniform(-0.8, 0.8, n_halo)))
    M = 10 ** rng.uniform(13.6, 14.8, n_halo)
    z = rng.uniform(0.15, 0.45, n_halo)
    mass_map = rng.uniform(0.5, 1.5, jhpx.npix(nside))
    return dict(ra=ra, dec=dec, M=M, z=z), mass_map


@pytest.fixture(scope="module")
def jax_model(cosmo):
    model = J.Baryonification2D(J.DarkMatterOnly(**PAR),
                                J.DarkMatterBaryon(**PAR), cosmo,
                                epsilon_max=20)
    model.setup_interpolator(**TABLE_GRID)
    return model


@pytest.fixture(scope="module")
def jax_map(inputs, jax_model):
    halos, mass_map = inputs
    cat = J.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    shell = J.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    return J.BaryonifyShell(cat, shell, epsilon_max=20, model=jax_model,
                            method="scatter", verbose=False).process()


@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology.from_dict(COSMO_DICT, device="cpu")


def _port_runner(inputs, model, **kw):
    halos, mass_map = inputs
    cat = T.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    shell = T.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    return T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                            verbose=False, device="cpu", **kw)


def _rms(got, want, mass_map):
    return np.sqrt(np.mean((got - want) ** 2)) / mass_map.mean()


def _port_model(cosmo_t):
    return T.Baryonification2D(T.DarkMatterOnly(**PAR),
                               T.DarkMatterBaryon(**PAR), cosmo_t,
                               epsilon_max=20)


def test_matches_jax_with_own_table(inputs, jax_map, cosmo_t):
    model = _port_model(cosmo_t)
    model.setup_interpolator(**TABLE_GRID)
    runner = _port_runner(inputs, model)
    assert runner.method == "scatter" and runner.dtype == torch.float64
    got = runner.process()
    assert _rms(got, jax_map, inputs[1]) < 1e-10


@pytest.mark.parametrize("carry", ["load_table", "from_arrays"])
def test_matches_jax_with_carried_table(carry, inputs, jax_model, jax_map,
                                        cosmo_t, tmp_path):
    model = _port_model(cosmo_t)
    if carry == "load_table":
        jax_model.save_table(tmp_path / "table.npz")
        model.load_table(tmp_path / "table.npz")
    else:
        model.from_arrays([np.asarray(g) for g in jax_model._grids],
                          np.asarray(jax_model._table),
                          jax_model.Rdelta_sampling, jax_model.p_keys)
    got = _port_runner(inputs, model).process()
    assert _rms(got, jax_map, inputs[1]) < 1e-10


def test_conservation_change_and_stages(inputs, jax_model, cosmo_t):
    model = _port_model(cosmo_t).from_arrays(
        [np.asarray(g) for g in jax_model._grids],
        np.asarray(jax_model._table), False, [])
    runner = _port_runner(inputs, model, n_buckets=3)
    runner.profile = True
    before = scatter_cuda.LAUNCHES["scatter_add"]
    new_map = runner.process()
    mass_map = inputs[1]
    assert new_map.shape == mass_map.shape
    assert np.isclose(new_map.sum(), mass_map.sum(), rtol=1e-8)
    assert not np.allclose(new_map, mass_map)
    # CPU tensors take the plain scatter, never the kernel
    assert scatter_cuda.LAUNCHES["scatter_add"] == before
    labels = [label for label, _ in runner.stage_times]
    assert labels == ["halo_arrays", "pass", "regrid", "fetch_map"]


def test_empty_catalog_is_a_no_op(inputs, cosmo_t):
    _, mass_map = inputs
    cat = T.HaloLightConeCatalog(ra=[], dec=[], M=[], z=[], cosmo=COSMO_DICT)
    shell = T.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    model = _port_model(cosmo_t).from_arrays(
        [np.linspace(0, 1, 3)] * 3, np.zeros((3, 3, 3)), False, [])
    out = T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                           verbose=False, device="cpu").process()
    np.testing.assert_array_equal(out, mass_map)


def _made(cls, inputs, model, device, **kw):
    """A runner of ``cls`` on the inputs' catalog and shell (nothing is
    computed, so "cuda" needs no GPU)."""
    halos, mass_map = inputs
    cat = T.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    shell = T.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    return cls(cat, shell, 20, model, device=device, **kw)


class _PropsModel:
    """A model stub with one extra table axis more than the cell-major
    packed records hold (only ``p_keys`` is read when a runner is made)."""
    p_keys = [f"p{i}" for i in range(MAX_PROPS + 1)]


@pytest.mark.parametrize("method", ["cellmajor", "gather"])
def test_unported_methods_raise(method, inputs, cosmo_t):
    """``gather`` is not ported and raises; an explicit ``cellmajor`` that
    the model cannot use (more extra axes than MAX_PROPS) raises too, on
    either device, naming the reason."""
    if method == "gather":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_runner(inputs, _port_model(cosmo_t), method=method)
        return
    for device in ("cpu", "cuda"):     # no tensor is made here
        with pytest.raises(ValueError, match="packed records"):
            _made(T.BaryonifyShell, inputs, _PropsModel(), device,
                  method=method)


def test_auto_resolves_to_scatter_on_every_device(inputs, cosmo_t):
    """With a model whose extra axes do not fit the packed records,
    ``auto`` is ``scatter`` on the CPU and on CUDA, where it warns."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _made(T.BaryonifyShell, inputs, _PropsModel(),
                     "cpu").method == "scatter"
    with pytest.warns(UserWarning, match="packed records"):
        runner = _made(T.BaryonifyShell, inputs, _PropsModel(), "cuda")
    assert runner.method == "scatter" and runner.dtype == torch.float32


@pytest.mark.parametrize("device,method", [("cpu", "scatter"),
                                           ("cuda", "cellmajor")])
def test_auto_resolves_by_device(device, method, inputs, cosmo_t):
    """``auto`` is ``scatter`` on the CPU and ``cellmajor`` on CUDA, as
    in the JAX package (no tensor is made here); explicit methods are
    taken on either device."""
    model = _port_model(cosmo_t)
    for cls in (T.BaryonifyShell, T.PaintProfilesShell):
        assert _made(cls, inputs, model, device).method == method
        for explicit in ("scatter", "cellmajor"):
            assert _made(cls, inputs, model, device,
                         method=explicit).method == explicit
    with pytest.raises(ValueError, match="unknown method"):
        _made(T.BaryonifyShell, inputs, model, device, method="halo-major")


def test_port_never_imports_jax():
    """Every module of the port imports, and a tiny process() (both
    methods), anafast and paint run on the CPU, with ``jax`` made
    unimportable."""
    code = textwrap.dedent("""
        import sys, pkgutil, importlib
        sys.modules["jax"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import baryonification_tpu_torch as T
        for m in pkgutil.walk_packages(T.__path__, T.__name__ + "."):
            importlib.import_module(m.name)
        cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
                  w0=-1.0)
        par = T.default_params()
        model = T.Baryonification2D(T.DarkMatterOnly(**par),
                                    T.DarkMatterBaryon(**par),
                                    T.Cosmology.from_dict(cd, device="cpu"))
        model.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=2,
                                 M_min=1e13, M_max=1e15, N_samples_Mass=3,
                                 R_min=1e-3, R_max=50, N_samples_R=24)
        rng = np.random.default_rng(0)
        cat = T.HaloLightConeCatalog(ra=rng.uniform(0, 360, 5),
                                     dec=rng.uniform(-60, 60, 5),
                                     M=10 ** rng.uniform(13.5, 14.5, 5),
                                     z=rng.uniform(0.15, 0.4, 5), cosmo=cd)
        shell = T.LightconeShell(map=np.ones(12 * 16 ** 2), cosmo=cd)
        out = T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                               verbose=False, device="cpu").process()
        assert np.isfinite(out).all() and abs(out.sum() / 3072 - 1) < 1e-8
        out_cm = T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                  verbose=False, device="cpu",
                                  method="cellmajor").process()
        assert abs(out_cm.sum() / 3072 - 1) < 1e-8
        assert np.abs(out_cm - out).max() < 1e-6 * np.abs(out - 1).max()
        from baryonification_tpu_torch.ops.spectra import anafast
        cl = anafast(torch.tensor(out), 16, 24)
        assert cl.shape == (25,) and torch.isfinite(cl).all()
        tab = T.TabulatedProfile(T.DarkMatter(**par),
                                 T.Cosmology.from_dict(cd, device="cpu"))
        tab.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=2,
                               M_min=1e13, M_max=1e15, N_samples_Mass=3,
                               R_min=1e-3, R_max=50, N_samples_R=24)
        shell64 = T.LightconeShell(map=np.zeros(12 * 64 ** 2), cosmo=cd)
        painted = T.PaintProfilesShell(cat, shell64, epsilon_max=20,
                                       model=tab, verbose=False,
                                       device="cpu").process()
        assert np.isfinite(painted).all() and painted.sum() > 0
        assert not any(k == "jax" or k.startswith("jax.")
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
