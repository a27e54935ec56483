"""Tests of the port that need the card (``cuda`` marker).

This file imports no JAX (the GPU machine has none), so it runs there on
its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test here skips. The sorted scatter cases are those
of tests/test_ops.py::TestPallasScatter, and the window cases are unsorted
rows shaped like the shell runner's; test_torch_scatter.py holds the plain
version against the JAX package on the same cases. The cell-major cases
hold the kernel against its plain version, with discs whose edges graze
pixel centres and patch caps, and show that its patch cull skips only
what adds nothing (bit for bit the result without the cull); its
adjoint and second-order kernels against their plain versions (autograd
of the plain pass) on the same cases and three more (a halo centred in a
patch, rows of 2000 nodes, one bucket cut to F = 32 and to F = 16), and
both shell runners'
``process_device`` against ``process()`` bit for bit, with gradients
against the CPU. The
Legendre cases hold each SHT kernel against its plain version on the
card, at the (nside, lmax) of tests/test_spectra.py and one larger size,
and at the shapes that both kernels' tiling has to get right. The grid
cases hold the CIC deposit through the scatter kernel against the plain
version on the same rows (positions past both box edges), and small grid
runs on the card in float64 against the CPU, with the launches that show
the grid path going through the scatter kernel. The snapshot cases run
``BaryonifySnapshot`` on the card in float64 against the CPU, both
methods (the gather method through the scatter kernel), and the dP(k)
case examples/10's halo-model suppression. The scatter's backward kernel
is held against its plain version (a gather: exactly), the chunked
launches (the chunk length lowered) against one launch, forward and
backward, the autograd of the scatter-add by ``gradcheck`` and
``gradgradcheck``, and the grid and snapshot runners' ``process_device``
on the card in float64 against ``process()`` and against the CPU, values
and gradients. ``PaintProfilesAnisGrid`` runs on the card in float64
against the CPU, both methods, with the cell-major pass's derivatives in
its canvas and its remap; ``ud_grade`` on the card against the CPU. The
regrid cases (tests/_torch_regrid_cases.py) hold the check entry's ids
and weights to the plain ops bit for bit, the atomic kernel's and the
deterministic route's maps to the plain version (the route bit for bit
over two runs, its warp path on a pile-up), the adjoint kernel to
autograd of the plain version, and show the shell runners launching the
regrid kernels and never its plain version; the regrid's ring table is
held to the closed form of every ring bit for bit (NSIDE 1 to 8192), and
its warps' merged adds are counted (fewer adds than rows on a NESTED
sky, the map within its bar in any input order and on a pile-up). The
snapshot cases (tests/_torch_snap_cases.py) hold the ``snap_pass`` and
``snap_vjp`` kernels against the plain step loop on the card, with
their tallies equal to its census, ``gradcheck`` of the pass, and one
launch a bucket's forward and one its backward. The anisotropic paint
cases (tests/_torch_anis_cases.py) hold the ``anis_pass`` and
``anis_vjp`` kernels against the plain step loop on the card in the
plane, the rows' and the canvas gradient, with their tallies equal to
its census, ``gradcheck`` of the pass in its rows and its canvas, one
launch a bucket's forward and one its backward, and one ``anis_pass``
launch a bucket in ``PaintProfilesAnisGrid.process``.
"""

import numpy as np
import pytest
import torch

from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
from baryonification_tpu_torch.ops import healpix as hpx
from baryonification_tpu_torch.ops import legendre_cuda as lc
from baryonification_tpu_torch.ops import scatter_cuda as sc
from baryonification_tpu_torch.ops import snap_pass_cuda as spc
from baryonification_tpu_torch.ops import spectra as sp

torch.set_num_threads(1)

CASES = ["single_channel_oor", "multi_channel", "ladder", "heavy_duplicates",
         "nonzero_accumulator", "all_out_of_range"]


def scatter_case(name):
    """(npix, idx sorted int32, value planes f32, base accumulators f32,
    tolerance, block_rows, tile_rows) for a test_ops.py case."""
    if name in ("single_channel_oor", "multi_channel", "ladder"):
        npix, n_rows, n_chan, seed = {
            "single_channel_oor": (300, 1000, 1, 0),
            "multi_channel": (513, 2048, 3, 1),
            "ladder": (1100, 3000, 2, 4)}[name]
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.integers(0, npix + max(1, int(npix * 0.5)),
                                   n_rows)).astype(np.int32)
        vals = [rng.normal(size=idx.size).astype(np.float32)
                for _ in range(n_chan)]
        base = [np.zeros(npix, np.float32) for _ in range(n_chan)]
        return npix, idx, vals, base, 1e-6, 256, 128
    if name == "heavy_duplicates":
        rng = np.random.default_rng(2)
        idx = np.sort(rng.integers(0, 8, 4000)).astype(np.int32)
        vals = [rng.normal(size=idx.size).astype(np.float32)]
        return 140, idx, vals, [np.zeros(140, np.float32)], 1e-5, 128, 128
    if name == "nonzero_accumulator":
        rng = np.random.default_rng(3)
        base = [rng.normal(size=260).astype(np.float32)]
        idx = np.sort(rng.integers(0, 260, 700)).astype(np.int32)
        vals = [rng.normal(size=idx.size).astype(np.float32)]
        return 260, idx, vals, base, 1e-5, 128, 128
    if name == "all_out_of_range":
        idx = np.full(512, 130 + 7, np.int32)
        return (130, idx, [np.ones(512, np.float32)],
                [np.ones(130, np.float32)], 0.0, 128, 128)
    raise KeyError(name)


WINDOW_CASES = ["windows_c1", "windows_c2", "windows_c3", "windows_int64",
                "one_pixel", "empty"]


def window_case(name):
    """(npix, idx, value planes f64, base accumulators f64) of unsorted
    rows shaped like one chunk of the shell runner: per halo a row-major
    window of consecutive pixels plus 4 fallback rows, rows outside the
    disc aimed at the sentinel Npix. ``windows_int64`` carries int64 rows,
    some beyond 2^31 (dropped, not wrapped); the others int32."""
    rng = np.random.default_rng(len(name))
    npix = 3072
    if name == "empty":
        idx = np.zeros(0, np.int32)
    elif name == "one_pixel":
        idx = np.full(5000, 77, np.int32)
    else:
        n_halo, n_rings, n_phi, ring_len = 6, 6, 8, 64
        first = rng.integers(0, npix - n_rings * ring_len, n_halo)
        first[1] = first[0] + 3                  # two overlapping halos
        win = (first[:, None, None] + ring_len * np.arange(n_rings)[:, None]
               + np.arange(n_phi)).reshape(n_halo, -1)
        in_disc = rng.random(win.shape) > 0.4
        fb = first[:, None] + np.array([0, 1, ring_len, ring_len + 1])
        use_fb = np.arange(n_halo) == 2          # one unresolved disc
        in_disc[use_fb] = False
        idx = np.concatenate(
            [np.where(in_disc, win, npix),
             np.where(use_fb[:, None], fb, npix)], axis=1).reshape(-1)
        if name == "windows_int64":
            idx = idx.astype(np.int64)
            idx[::7] = npix + 2**32 + np.arange(idx[::7].size)
        else:
            idx = idx.astype(np.int32)
    n_chan = {"windows_c1": 1, "windows_c2": 2, "one_pixel": 1}.get(name, 3)
    vals = [rng.normal(size=idx.size) for _ in range(n_chan)]
    base = [rng.normal(size=npix) for _ in range(n_chan)]
    return npix, idx, vals, base


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version(name, dtype, cuda_device):
    """Kernel against the plain version on sorted rows (runs of equal
    destinations in neighbouring lanes); float32 to the case's tolerance
    (summation order), float64 to 1e-12."""
    npix, idx, vals, base, tol, _, _ = scatter_case(name)
    ref = tuple(torch.tensor(b, dtype=dtype) for b in base)
    sc.scatter_add_accum_reference(
        ref, torch.tensor(idx), tuple(torch.tensor(v, dtype=dtype)
                                      for v in vals))
    accs = tuple(torch.tensor(b, dtype=dtype, device=cuda_device)
                 for b in base)
    before = sc.LAUNCHES["scatter_add"]
    sc.sorted_scatter_add(accs, torch.tensor(idx, device=cuda_device),
                          tuple(torch.tensor(v, dtype=dtype,
                                             device=cuda_device)
                                for v in vals))
    torch.cuda.synchronize()
    assert sc.LAUNCHES["scatter_add"] == before + 1
    tol = tol if dtype == torch.float32 else 1e-12
    for g, w in zip(accs, ref):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                   rtol=max(tol, 1e-12), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", WINDOW_CASES)
def test_kernel_on_unsorted_windows(name, dtype, cuda_device):
    """Unsorted runner-shaped rows through the kernel in one launch (none
    for an empty input) against the plain version: float64 to 1e-12,
    float32 to 1e-5 of the largest sum (one pixel takes 5000 rows)."""
    npix, idx, vals, base = window_case(name)
    ref = tuple(torch.tensor(b, dtype=dtype) for b in base)
    sc.scatter_add_accum_reference(
        ref, torch.tensor(idx), tuple(torch.tensor(v, dtype=dtype)
                                      for v in vals))
    accs = tuple(torch.tensor(b, dtype=dtype, device=cuda_device)
                 for b in base)
    before = sc.LAUNCHES["scatter_add"]
    out = sc.scatter_add_accum(
        accs, torch.tensor(idx, device=cuda_device),
        tuple(torch.tensor(v, dtype=dtype, device=cuda_device)
              for v in vals))
    torch.cuda.synchronize()
    assert all(o is a for o, a in zip(out, accs))
    assert sc.LAUNCHES["scatter_add"] == before + (idx.size > 0)
    for g, w in zip(accs, ref):
        if dtype == torch.float64:
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_allclose(
                g.cpu().numpy(), w.numpy(), rtol=0,
                atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_scatter_refuses_bad_planes(cuda_device):
    """A non-contiguous accumulator and tensors on two devices raise; a
    non-contiguous value plane is taken (copied)."""
    idx = torch.arange(8, dtype=torch.int32, device=cuda_device)
    ones = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        sc.scatter_add_accum((torch.zeros(32, device=cuda_device)[::2],),
                             idx, (ones,))
    with pytest.raises(ValueError, match="must be on"):
        sc.scatter_add_accum((torch.zeros(16, device=cuda_device),),
                             idx.cpu(), (ones,))
    with pytest.raises(ValueError, match="must be on"):
        sc.scatter_add_accum((torch.zeros(16),), idx.cpu(), (ones,))
    acc = torch.zeros(16, device=cuda_device)
    sc.scatter_add_accum((acc,), idx,
                         (torch.ones(16, device=cuda_device)[::2],))
    assert acc.cpu().tolist() == [1.0] * 8 + [0.0] * 8


@pytest.mark.cuda
def test_unsorted_wrapper_on_card(cuda_device):
    """Unsorted int64 rows, some far beyond 2^31 (dropped, not wrapped)."""
    rng = np.random.default_rng(5)
    npix = 5000
    idx = rng.integers(0, npix + 900, 60_000)
    idx[::97] += 2**32
    vals = [rng.normal(size=idx.size) for _ in range(3)]
    ref = tuple(torch.zeros(npix, dtype=torch.float64) for _ in range(3))
    sc.scatter_add_accum(ref, torch.tensor(idx),
                         tuple(torch.tensor(v) for v in vals))
    accs = tuple(torch.zeros(npix, dtype=torch.float64, device=cuda_device)
                 for _ in range(3))
    out = sc.scatter_add_accum(accs, torch.tensor(idx, device=cuda_device),
                               tuple(torch.tensor(v, device=cuda_device)
                                     for v in vals))
    assert all(o is a for o, a in zip(out, accs))
    for g, w in zip(accs, ref):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12)


def _small_shell():
    """A small table, 60 halos and an NSIDE-32 shell, all on the CPU."""
    import baryonification_tpu_torch as T
    cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
              w0=-1.0)
    par = T.default_params()
    model = T.Baryonification2D(T.DarkMatterOnly(**par),
                                T.DarkMatterBaryon(**par),
                                T.Cosmology.from_dict(cd, device="cpu"))
    model.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=3,
                             M_min=1e13, M_max=1e15, N_samples_Mass=4,
                             R_min=1e-3, R_max=50, N_samples_R=32)
    rng = np.random.default_rng(0)
    cat = T.HaloLightConeCatalog(ra=rng.uniform(0, 360, 60),
                                 dec=rng.uniform(-70, 70, 60),
                                 M=10 ** rng.uniform(13.3, 14.8, 60),
                                 z=rng.uniform(0.15, 0.45, 60), cosmo=cd)
    shell = T.LightconeShell(map=rng.uniform(0.5, 1.5, 12 * 32 ** 2),
                             cosmo=cd)
    return T, model, cat, shell


@pytest.mark.cuda
def test_shell_on_card_matches_cpu(cuda_device):
    """process(method="scatter") on the card (float64, then float32)
    against the port's CPU float64 run on one table. float64 agrees to
    rounding; float32 geometry and offsets sit at ~1e-5 rms/mean of
    float64 (measured on the CPU at NSIDE 64, 2000 halos)."""
    T, model, cat, shell = _small_shell()
    kw = dict(epsilon_max=20, model=model, verbose=False, method="scatter")
    want = T.BaryonifyShell(cat, shell, device="cpu", **kw).process()
    for prec, bar in (("float64", 1e-10), ("float32", 5e-5)):
        before = sc.LAUNCHES["scatter_add"]
        got = T.BaryonifyShell(cat, shell, device=cuda_device,
                               precision=prec, **kw).process()
        assert sc.LAUNCHES["scatter_add"] > before
        rms = np.sqrt(np.mean((got - want) ** 2)) / shell.map.mean()
        assert rms < bar, (prec, rms)


@pytest.mark.cuda
def test_cellmajor_process_on_card(cuda_device):
    """process() under ``auto`` on the card is the cell-major method: it
    launches the cell-major kernel and no scatter, and agrees with the
    port's CPU float64 cell-major run (float64 to rounding, float32 as the
    scatter check above); the paint likewise, to 1e-10 / 1e-3 of its
    largest pixel."""
    T, model, cat, shell = _small_shell()
    kw = dict(epsilon_max=20, model=model, verbose=False)
    want = T.BaryonifyShell(cat, shell, device="cpu", method="cellmajor",
                            **kw).process()
    for prec, bar in (("float64", 1e-10), ("float32", 5e-5)):
        before = (sc.LAUNCHES["scatter_add"], cmc.LAUNCHES["cellmajor_pass"])
        runner = T.BaryonifyShell(cat, shell, device=cuda_device,
                                  precision=prec, **kw)
        assert runner.method == "cellmajor"
        got = runner.process()
        assert sc.LAUNCHES["scatter_add"] == before[0]
        assert cmc.LAUNCHES["cellmajor_pass"] > before[1]
        rms = np.sqrt(np.mean((got - want) ** 2)) / shell.map.mean()
        assert rms < bar, (prec, rms)

    tab = T.TabulatedProfile(T.DarkMatter(**T.default_params()),
                             model.cosmo)
    tab.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=4,
                           R_min=1e-3, R_max=50, N_samples_R=32)
    kw = dict(epsilon_max=5, model=tab, verbose=False)
    want = T.PaintProfilesShell(cat, shell, device="cpu", method="cellmajor",
                                **kw).process()
    for prec, bar in (("float64", 1e-10), ("float32", 1e-3)):
        before = (sc.LAUNCHES["scatter_add"], cmc.LAUNCHES["cellmajor_pass"])
        got = T.PaintProfilesShell(cat, shell, device=cuda_device,
                                   precision=prec, **kw).process()
        assert sc.LAUNCHES["scatter_add"] == before[0]
        assert cmc.LAUNCHES["cellmajor_pass"] > before[1]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert np.isfinite(got).all() and err < bar, (prec, err)


CELLMAJOR_CASES = ["empty_cells", "f4", "f_big", "k_hundreds"]


def cellmajor_case(name, mode, n_r=40, centred=False, n_hi=None):
    """One bucket on the CPU in float64, built by the port's own
    registration: (planes' base values, pixel planes, dense, counts, F,
    slot records, rows, g0, dg, rad_hi). Every case holds one halo above
    the table's mass range (its row is NaN); the raw table has -inf and
    NaN nodes, put to -1e30 (paint) or 0 (offsets) as the runners do.

    empty_cells: 6 halos at NSIDE 32, cells of nside_c 8 (F = 16), most
    cells without a candidate; f4: F = 4; f_big: F = 1024, more than a
    block of threads; k_hundreds: 400 halos in one patch of sky, hundreds
    of candidates a cell (F = 64). ``n_r`` radial nodes in the table;
    ``centred`` puts halo 1 at the centre of a patch of 32 pixels, its
    disc over the whole patch (see adjoint_case); ``n_hi`` the rows' nodes
    in place of the runners' bound."""
    from baryonification_tpu_torch.runners import shell_cellmajor as tcm
    from baryonification_tpu_torch.runners.shell import DefaultRunner
    nside, nsc, n_halo = {"empty_cells": (32, 8, 6), "f4": (16, 8, 40),
                          "f_big": (64, 2, 30),
                          "k_hundreds": (32, 4, 400)}[name]
    rng = np.random.default_rng(len(name) + 10 * len(mode))
    eps = 20.0
    if name == "k_hundreds":
        theta = rng.uniform(0.9, 1.4, n_halo)
        phi = rng.uniform(0.8, 1.3, n_halo)
    else:
        theta = np.arccos(rng.uniform(-1, 1, n_halo))
        phi = rng.uniform(0, 2 * np.pi, n_halo)
    radius = rng.uniform(0.03, 0.15, n_halo)
    a = rng.uniform(0.7, 0.9, n_halo)
    D = rng.uniform(500.0, 1500.0, n_halo)
    rt = hpx.RingTables(nside, dtype=torch.float64, device="cpu")
    pix = hpx.pixel_planes_device(nside, rt.z, rt.start, rt.npr, rt.shift,
                                  p=hpx.nest2ring_all(nside, "cpu"))
    if centred:
        # the patch (32 NESTED pixels) nearest to the middle of the sky
        # patch, its centre taken as the kernel takes a patch's cap
        v = torch.stack(pix, 1)
        mid = torch.tensor([np.sin(1.15) * np.cos(1.05),
                            np.sin(1.15) * np.sin(1.05), np.cos(1.15)],
                           dtype=torch.float64)
        q = int(torch.argmax(v @ mid)) // 32
        cen = v[32 * q:32 * q + 32].sum(0)
        cen = (cen / cen.norm()).numpy()
        theta[1] = np.arccos(cen[2])
        phi[1] = np.arctan2(cen[1], cen[0])
        radius[1], a[1], D[1] = 0.13, 0.75, 300.0
    R_com = radius * D / (eps * a)
    M = 10 ** rng.uniform(13.2, 14.8, n_halo)
    M[0] = 1e16                              # outside the mass grid
    if centred:
        M[1] = 10 ** 14.0
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    st = np.sin(theta)
    packed = tcm.pack_halo_records(
        t(st * np.cos(phi)), t(st * np.sin(phi)), t(np.cos(theta)), t(D),
        t(a), t(R_com), t(np.log(R_com)), t(np.log(1 / a)), t(np.log(M)))
    hids, cell_start, K = tcm.coarse_halo_index(
        nsc, t(theta), t(phi), t(radius),
        cell_map=hpx.ring2nest(nsc, torch.arange(hpx.npix(nsc))))
    dense, counts = tcm.dense_cell_candidates(hpx.npix(nsc), max(K, 1), hids,
                                              cell_start)
    gz = np.log1p(np.linspace(0.1, 0.5, 3))
    gm = np.log(np.geomspace(1e13, 1e15, 4))
    gr = np.linspace(np.log(1e-3), np.log(50.0), n_r)
    r = np.exp(gr)[None, None, :]
    if mode == "paint":
        table = 0.5 * (gm[None, :, None] - 30) - 2 * np.log1p(r / 0.3) \
            + 0 * gz[:, None, None]
        table[:, 1, 25:] = -np.inf
        table[1, 2, 5] = np.nan
        fill = -1e30
    else:
        table = 0.05 * r * np.exp(-r / 3) * (1 + 0.1 * gm[None, :, None]
                                              + 0.2 * gz[:, None, None])
        table[:, 1, 30:] = np.inf
        table[2, 3, 7] = np.nan
        fill = 0.0
    table = np.where(np.isfinite(table), table, fill)
    rad_max = np.log(eps) if mode == "offsets_rdelta" \
        else np.log(eps * R_com.max())
    n_hi = n_hi or DefaultRunner._node_bound(gr, rad_max, len(gr))
    rows = tcm.halo_rows((t(gz), t(gm), t(gr)), t(table), packed, n_hi)
    base = [t(rng.normal(size=hpx.npix(nside)))
            for _ in range(1 if mode == "paint" else 3)]
    return (base, pix, dense, counts, (nside // nsc) ** 2,
            tcm.slot_records(packed, eps), rows, float(gr[0]),
            float(gr[1] - gr[0]), float(gr[n_hi - 1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["offsets", "offsets_rdelta", "paint"])
@pytest.mark.parametrize("name", CELLMAJOR_CASES)
def test_cellmajor_kernel_matches_plain(name, mode, dtype, cuda_device):
    """One launch adds what the plain version adds, on the same inputs on
    the card, to the same base planes: float64 to 1e-12 and float32 to
    1e-5 of the largest sum added, plus 4 ulp of the base (the kernel
    rounds operation for operation as the plain version)."""
    (base, pix, dense, counts, F, recs, rows, g0, dg,
     rad_hi) = cellmajor_case(name, mode)
    counts_np = counts.numpy()
    if name == "empty_cells":
        assert (counts_np == 0).mean() > 0.3
    if name == "k_hundreds":
        assert counts_np.max() >= 100
    assert torch.isnan(rows[0]).all()
    on = lambda v: v.to(cuda_device, dtype if v.is_floating_point()
                        else v.dtype)
    args = (tuple(on(p) for p in pix), on(dense), on(counts), F, on(recs),
            on(rows), g0, dg, rad_hi)
    want = tuple(on(b) for b in base)
    cmc.cellmajor_pass_reference(mode, want, *args)
    got = tuple(on(b) for b in base)
    before = cmc.LAUNCHES["cellmajor_pass"]
    out = cmc.cellmajor_pass(mode, got, *args)
    torch.cuda.synchronize()
    assert cmc.LAUNCHES["cellmajor_pass"] == before + 1
    assert all(o is g for o, g in zip(out, got))
    added = max(float((w - on(b)).abs().max()) for w, b in zip(want, base))
    assert added > 0
    tol = ((1e-12 if dtype == torch.float64 else 1e-5) * added
           + 4 * torch.finfo(dtype).eps * max(float(b.abs().max())
                                              for b in base))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=tol)


@pytest.mark.cuda
def test_cellmajor_refuses_bad_inputs(cuda_device):
    (base, pix, dense, counts, F, recs, rows, g0, dg,
     rad_hi) = cellmajor_case("f4", "paint")
    on = lambda v: v.to(cuda_device)
    planes = (on(base[0]),)
    pix_d = tuple(on(p) for p in pix)
    tail = (on(dense), on(counts), F, on(recs), on(rows), g0, dg, rad_hi)
    with pytest.raises(ValueError, match="output planes"):
        cmc.cellmajor_pass("offsets", planes, pix_d, *tail)
    with pytest.raises(TypeError, match="int32"):
        cmc.cellmajor_pass("paint", planes, pix_d, on(dense).long(),
                           *tail[1:])
    with pytest.raises(ValueError, match="must be on"):
        cmc.cellmajor_pass("paint", planes, pix_d, dense, *tail[1:])
    with pytest.raises(ValueError, match="cells of F"):
        cmc.cellmajor_pass("paint", planes, pix_d, tail[0], tail[1], F * 4,
                           *tail[3:])
    with pytest.raises(ValueError, match="contiguous"):
        big = torch.zeros(2 * planes[0].shape[0], dtype=torch.float64,
                          device=cuda_device)
        cmc.cellmajor_pass("paint", (big[::2],), pix_d, *tail)


# the cell-major cases and three more for the adjoint kernels
ADJOINT_CASES = CELLMAJOR_CASES + ["centred_span", "long_rows",
                                   "f32_next_to_f16"]


def split_cells(case, m):
    """The bucket ``case`` with every cell cut into ``m`` cells of F / m
    pixels, each holding its cell's candidates: the same slots of every
    pixel, so the same sums, walked with a smaller F."""
    (base, pix, dense, counts, F, recs, rows, g0, dg, rad_hi) = case
    ncell = counts.shape[0]
    dense = dense.reshape(ncell, -1).repeat_interleave(m, 0).reshape(-1)
    return (base, pix, dense.contiguous(), counts.repeat_interleave(m),
            F // m, recs, rows, g0, dg, rad_hi)


def patch_spans(case, mode, h):
    """[(lowest node i, highest node i)] of the lanes that halo ``h`` adds
    to, for each patch of 32 pixels of the cells listing it: the plain
    pass's tests and lerp position (its rows' NaN aside)."""
    (_, pix, dense, counts, F, recs, rows, g0, dg, rad_hi) = case
    n_hi = rows.shape[1]
    px, py, pz = pix
    hvx, hvy, hvz, cosr, hD, ha, hReps, hlnR = recs[h]
    dx, dy, dz = (px - hvx) * hD, (py - hvy) * hD, (pz - hvz) * hD
    r_com = torch.sqrt(dx * dx + dy * dy + dz * dz) / ha
    rad = torch.log(torch.clamp(r_com, min=1e-30))
    if mode == "offsets_rdelta":
        rad = rad - hlnR
    inside = ((rad >= g0) & (rad <= rad_hi) & (r_com < hReps)
              & (px * hvx + py * hvy + pz * hvz >= cosr))
    t = torch.clamp((rad - g0) * (1.0 / dg), 0.0, float(n_hi - 1))
    i = torch.clamp(torch.floor(t).long(), 0, n_hi - 2)
    ncell = counts.shape[0]
    d2 = dense.reshape(ncell, -1)
    lists = (d2 == h) & (torch.arange(d2.shape[1]) < counts[:, None])
    out = []
    for c in torch.nonzero(lists.any(1)).flatten().tolist():
        for q in range(c * F, (c + 1) * F, 32):
            m = inside[q:q + 32]
            if m.any():
                out.append((int(i[q:q + 32][m].min()),
                            int(i[q:q + 32][m].max())))
    return out


def adjoint_case(name, mode):
    """[bucket] for the adjoint kernels: a cell-major case, or
    centred_span: k_hundreds (F = 64) with 300 radial nodes and halo 1 at
      the centre of a patch, its disc over the whole patch, so that the
      lanes of that patch add to 8 or more nodes of its row (more than
      32), the rows cut to end there (the patch's farthest lane at node
      n_hi - 2);
    long_rows: k_hundreds with rows of 2000 radial nodes;
    f32_next_to_f16: k_hundreds cut to F = 32 (a warp a cell: the patch
      walk) and to F = 16 (the lane-by-lane walk), on the same slots."""
    if name in CELLMAJOR_CASES:
        return [cellmajor_case(name, mode)]
    if name == "centred_span":
        case = cellmajor_case("k_hundreds", mode, n_r=300, centred=True)
        top = max(hi for _, hi in patch_spans(case, mode, 1)) + 2
        return [cellmajor_case("k_hundreds", mode, n_r=300, centred=True,
                               n_hi=top)]
    if name == "long_rows":
        return [cellmajor_case("k_hundreds", mode, n_r=2000)]
    case = cellmajor_case("k_hundreds", mode)
    return [split_cells(case, 2), split_cells(case, 4)]


@pytest.mark.parametrize("mode", ["offsets", "offsets_rdelta", "paint"])
def test_adjoint_cases_hold_their_premise(mode):
    """The adjoint cases are what their names say (CPU, no card)."""
    (case,) = adjoint_case("centred_span", mode)
    n_hi = case[6].shape[1]
    spans = patch_spans(case, mode, 1)
    assert max(hi - lo for lo, hi in spans) + 2 > 32
    assert any(hi - lo >= 8 and hi == n_hi - 2 for lo, hi in spans)
    (case,) = adjoint_case("long_rows", mode)
    assert case[4] % 32 == 0 and case[6].shape[1] > 1500
    f32, f16 = adjoint_case("f32_next_to_f16", mode)
    assert (f32[4], f16[4]) == (32, 16)
    assert f32[3].shape[0] * 32 == f16[3].shape[0] * 16 == f32[1][0].shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["offsets", "offsets_rdelta", "paint"])
@pytest.mark.parametrize("name", ADJOINT_CASES)
def test_cellmajor_adjoint_matches_plain(name, mode, dtype, cuda_device):
    """The adjoint and second-order kernels against their plain versions
    (the autograd of the plain pass and its double backward) on the same
    inputs on the card, random cotangents and row directions: the rows'
    gradients are summed with atomics in no fixed order, so they hold to
    1e-10 (float64) and 1e-5 (float32) of their largest value, the JVP
    planes (one thread a pixel) alike; the NaN row of the halo outside
    the grid and the cells without candidates add nothing (no NaN). The
    kernel's tally: two global atomics a slot-pixel that adds, or fewer
    where float32 lanes of a patch merge their terms first. F = 32 and
    F = 16 cuts of one bucket (the patch walk and the lane-by-lane walk)
    add the same slots and give the same gradients."""
    results = []
    for case in adjoint_case(name, mode):
        (_, pix, dense, counts, F, recs, rows, g0, dg, rad_hi) = case
        assert torch.isnan(rows[0]).all()
        on = lambda v: v.to(cuda_device, dtype if v.is_floating_point()
                            else v.dtype)
        args = (tuple(on(p) for p in pix), on(dense), on(counts), F,
                on(recs), on(rows), g0, dg, rad_hi)
        rng = np.random.default_rng(len(name) + len(mode))
        n_out = 1 if mode == "paint" else 3
        g = tuple(on(torch.tensor(rng.normal(size=pix[0].shape[0])))
                  for _ in range(n_out))
        u = on(torch.tensor(rng.normal(size=tuple(rows.shape))))
        before = dict(cmc.LAUNCHES)
        d = cmc.cellmajor_vjp(mode, g, *args)
        jvp, d2 = cmc.cellmajor_vjp2(mode, g, u, *args)
        d_want = cmc.cellmajor_vjp_reference(mode, g, *args)
        jvp_want, d2_want = cmc.cellmajor_vjp2_reference(mode, g, u, *args)
        tally = torch.zeros(len(cmc.TALLY), dtype=torch.int64,
                            device=cuda_device)
        cmc._launch_adjoint("cellmajor_vjp", mode, g, None, *args,
                            tally=tally)
        torch.cuda.synchronize()
        assert cmc.LAUNCHES["cellmajor_vjp"] == before["cellmajor_vjp"] + 2
        assert cmc.LAUNCHES["cellmajor_vjp2"] == before["cellmajor_vjp2"] + 1
        bar = 1e-10 if dtype == torch.float64 else 1e-5
        for got, want in ((d, d_want), (d2, d2_want)) + tuple(zip(jvp,
                                                                  jvp_want)):
            assert bool(torch.isfinite(got).all())
            scale = float(want.abs().max())
            assert scale > 0
            assert float((got - want).abs().max()) <= bar * scale
        assert float(d[0].abs().max()) == 0.0   # the halo outside the grid
        assert float(d2[0].abs().max()) == 0.0
        n = dict(zip(cmc.TALLY, tally.tolist()))
        assert n["adds"] > 0 and 0 < n["atomics"] <= 2 * n["adds"]
        if dtype == torch.float64 or F % 32:
            assert n["atomics"] == 2 * n["adds"]
        results.append((d, n["adds"]))
    if len(results) == 2:
        (d32, n32), (d16, n16) = results
        assert n32 == n16
        assert float((d32 - d16).abs().max()) <= bar * float(d16.abs().max())


@pytest.mark.cuda
def test_process_device_on_card(cuda_device):
    """process_device() on the card equals process() bit for bit, float32
    and float64, for both shell runners (under deterministic algorithms:
    the regrid's atomic kernel otherwise sums in no fixed order),
    launches the adjoint kernel for a gradient, and the float64
    gradient and Hessian-vector product through it agree with the CPU's
    plain versions to 1e-9."""
    T, model, cat, shell = _small_shell()
    tab = T.TabulatedProfile(T.DarkMatter(**T.default_params()),
                             model.cosmo)
    tab.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=4,
                           R_min=1e-3, R_max=50, N_samples_R=32)

    def runner(kind, device, **kw):
        if kind == "shell":
            return T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                    verbose=False, device=device, **kw)
        return T.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                                    verbose=False, device=device, **kw)

    def grads(r, table, loss):
        s = torch.ones((), dtype=table.dtype, device=table.device,
                       requires_grad=True)
        (g,) = torch.autograd.grad(loss(r.process_device(table * s)), s,
                                   create_graph=True)
        (h,) = torch.autograd.grad(g, s)
        out = float(g.detach()), float(h)
        assert np.isfinite(out).all() and out[0] != 0
        return out

    for kind, table in (("shell", model._table), ("paint", tab._ln2D)):
        for prec in ("float32", "float64"):
            r = runner(kind, cuda_device, precision=prec)
            r.process()                            # stage the geometry
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                want = r.process()
                got = r.process_device()
            finally:
                torch.use_deterministic_algorithms(False)
            assert got.is_cuda and got.dtype == r.dtype
            np.testing.assert_array_equal(got.double().cpu().numpy(), want)
        loss = ((lambda m: (m ** 2).sum()) if kind == "shell"
                else (lambda m: m.sum()))
        before = dict(cmc.LAUNCHES)
        g_card = grads(runner(kind, cuda_device, precision="float64"),
                       table.to(cuda_device), loss)
        assert cmc.LAUNCHES["cellmajor_vjp"] > before["cellmajor_vjp"]
        assert cmc.LAUNCHES["cellmajor_vjp2"] > before["cellmajor_vjp2"]
        g_cpu = grads(runner(kind, "cpu", method="cellmajor"), table, loss)
        np.testing.assert_allclose(g_card, g_cpu, rtol=1e-9)


# F -> (nside, nside_c) of the grazing cases
GRAZE_F = {4: (16, 8), 16: (32, 8), 64: (32, 4), 1024: (64, 2)}


def grazing_case(F, dtype, seed=0):
    """A bucket on the CPU in ``dtype`` whose disc edges graze pixel
    centres and patch caps: 48 halos, a third of them with discs smaller
    than one pixel, the others up to 6 pixels. Halos 0-23 sit near pixel
    centres; halos 24-47 sit on the great circle from a patch's cap
    centre (the normalised sum of its 32 pixels, as the kernel takes it)
    through its farthest pixel q, beyond q, so
    that the patch test of csrc/cellmajor_pass.cu is as tight as it gets.
    Each disc's cos_reach is the computed cosine (the kernel's
    operations, in ``dtype``) of one pixel (the one nearest its edge, or
    q), moved by -2 to 2 ulps, so that pixel lies just inside, on or just
    outside the disc. Every cell lists every halo; the chord and radial
    tests never reject (eps_R is huge, the radial grid spans 1e-6 to 1e4
    Mpc), so the angular test decides. Returns (pix, dense, counts, F,
    recs, g0, dg, n_hi, cosang) with cosang the (npix, H) computed
    cosines."""
    nside, nsc = GRAZE_F[F]
    rng = np.random.default_rng(seed + F)
    rt = hpx.RingTables(nside, dtype=torch.float64, device="cpu")
    pix = tuple(p.to(dtype) for p in hpx.pixel_planes_device(
        nside, rt.z, rt.start, rt.npr, rt.shift,
        p=hpx.nest2ring_all(nside, "cpu")))
    p64 = np.stack([p.double().numpy() for p in pix], axis=-1)
    resol = hpx.nside2resol(nside)
    H, half = 48, 24
    theta = resol * np.where(np.arange(H) % 3 == 0,
                             rng.uniform(0.05, 0.9, H),
                             rng.uniform(1.0, 6.0, H))
    v = p64[rng.integers(0, p64.shape[0], half)]
    v = v + rng.normal(scale=0.3 * resol, size=v.shape)
    P = 32
    patch = rng.integers(0, p64.shape[0] // P, half)
    lanes = p64[patch[:, None] * P + np.arange(P)[None, :]]
    c = lanes.sum(axis=1)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    q_lane = np.einsum("hpk,hk->hp", lanes, c).argmin(axis=1)
    q_id = patch * P + q_lane
    q = p64[q_id]
    t = q - np.sum(q * c, axis=-1, keepdims=True) * c
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    a = np.arccos(np.clip(np.sum(q * c, axis=-1), -1, 1)) + theta[half:]
    v = np.concatenate([v, np.cos(a)[:, None] * c + np.sin(a)[:, None] * t])
    hv = torch.tensor(v / np.linalg.norm(v, axis=-1, keepdims=True)).to(dtype)
    cosang = (pix[0][:, None] * hv[None, :, 0]
              + pix[1][:, None] * hv[None, :, 1]
              + pix[2][:, None] * hv[None, :, 2])
    ang = np.arccos(np.clip(cosang.double().numpy(), -1, 1))
    edge = np.abs(ang - theta[None, :]).argmin(axis=0)
    edge[half:] = q_id
    cosr = cosang[edge, np.arange(H)].clone()
    for h, k in enumerate(rng.integers(-2, 3, H)):
        for _ in range(abs(int(k))):
            cosr[h] = torch.nextafter(cosr[h], cosr.new_tensor(np.sign(k)))
    col = lambda x: torch.full((H,), x, dtype=dtype)
    recs = torch.stack([hv[:, 0], hv[:, 1], hv[:, 2], cosr, col(1000.0),
                        col(0.8), col(1e30), col(0.0)], dim=-1).contiguous()
    ncell = 12 * nsc**2
    dense = torch.arange(H, dtype=torch.int32).repeat(ncell)
    counts = torch.full((ncell,), H, dtype=torch.int32)
    n_hi = 64
    g0, g1 = np.log(1e-6), np.log(1e4)
    return (pix, dense, counts, F, recs, g0, (g1 - g0) / (n_hi - 1), n_hi,
            cosang)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("F", list(GRAZE_F))
def test_cellmajor_grazing_discs(F, dtype, cuda_device):
    """Disc edges within ulps of pixel centres, discs below one pixel, F
    = 4 to 1024: the kernel counts exactly the (pixel, slot) pairs that
    the plain version counts (paint of rows of log 0 adds 1 a pair), with
    and without its patch cull, bit for bit; offsets agree at the bars of
    test_cellmajor_kernel_matches_plain and reach the same pixels."""
    pix, dense, counts, F, recs, g0, dg, n_hi, cosang = grazing_case(F, dtype)
    on = lambda v: v.to(cuda_device)
    H = recs.shape[0]
    rad_hi = g0 + (n_hi - 1) * dg
    args = (tuple(on(p) for p in pix), on(dense), on(counts), F, on(recs))
    zeros = lambda n: tuple(torch.zeros(pix[0].shape[0], dtype=dtype,
                                        device=cuda_device) for _ in range(n))
    ones_rows = on(torch.zeros((H, n_hi), dtype=dtype))
    want = cmc.cellmajor_pass_reference("paint", zeros(1), *args, ones_rows,
                                        g0, dg, rad_hi)[0]
    for cull in (True, False):
        got = cmc._cellmajor_pass_raw("paint", zeros(1), *args, ones_rows,
                                      g0, dg, rad_hi, cull=cull)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want), cull
    inside = (cosang >= recs[:, 3][None, :]).sum(dim=1).to(dtype)
    assert torch.equal(want.cpu(), inside)
    assert 0 < float(want.sum()) < cosang.numel()

    rng = np.random.default_rng(F)
    rows = on(torch.tensor(0.01 * np.exp(g0 + dg * np.arange(n_hi))[None, :]
                           * rng.uniform(0.5, 1.5, (H, 1)), dtype=dtype))
    want = cmc.cellmajor_pass_reference("offsets", zeros(3), *args, rows, g0,
                                        dg, rad_hi)
    got = cmc.cellmajor_pass("offsets", zeros(3), *args, rows, g0, dg,
                             rad_hi)
    raw = cmc._cellmajor_pass_raw("offsets", zeros(3), *args, rows, g0, dg,
                                  rad_hi, cull=False)
    torch.cuda.synchronize()
    added = max(float(w.abs().max()) for w in want)
    assert added > 0
    tol = (1e-12 if dtype == torch.float64 else 1e-5) * added
    reached = lambda planes: sum(p != 0 for p in planes) > 0
    assert torch.equal(reached(got), reached(want))
    for g, r, w in zip(got, raw, want):
        assert torch.equal(g, r)
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cellmajor_all_culled(dtype, cuda_device):
    """Every cell lists only halos on the far side of the sky: the planes
    stay bit-unchanged, and the kernel's count of the (patch, slot) pairs
    its patches walk is 0 (every patch culled every slot), against all of
    them without the cull."""
    pix, _, _, F, recs, g0, dg, n_hi, _ = grazing_case(64, dtype, seed=1)
    nside, nsc = GRAZE_F[F]
    rt = hpx.RingTables(nsc, dtype=torch.float64, device="cpu")
    cv = hpx.pixel_planes_device(nsc, rt.z, rt.start, rt.npr, rt.shift,
                                 p=hpx.nest2ring_all(nsc, "cpu"))
    far = (cv[0][:, None] * recs[None, :, 0].double()
           + cv[1][:, None] * recs[None, :, 1].double()
           + cv[2][:, None] * recs[None, :, 2].double()) < -0.2
    order = torch.argsort((~far).to(torch.int8), dim=1, stable=True)
    dense = order.to(torch.int32).reshape(-1)
    counts = far.sum(dim=1).to(torch.int32)
    assert int(counts.min()) > 0
    on = lambda v: v.to(cuda_device)
    rows = on(torch.zeros((recs.shape[0], n_hi), dtype=dtype))
    base = torch.tensor(np.random.default_rng(2).normal(size=pix[0].shape[0]),
                        dtype=dtype, device=cuda_device)
    pairs = int(counts.sum()) * F // 32
    for cull, walked in ((True, 0), (False, pairs)):
        got = base.clone()
        kept = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        cmc._cellmajor_pass_raw("paint", (got,), tuple(on(p) for p in pix),
                                on(dense), on(counts), F, on(recs), rows, g0,
                                dg, g0 + (n_hi - 1) * dg, cull=cull,
                                kept=kept)
        torch.cuda.synchronize()
        assert torch.equal(got, base)
        assert int(kept) == walked, (cull, int(kept), walked)


LEGENDRE_SIZES = [(16, 47), (32, 95), (256, 512)]


def _legendre_inputs(nside, lmax, device):
    """float64 analysis folds of a random map and random a_lm planes on
    ``device``."""
    c64 = sp._seed_consts(nside, lmax, torch.float64, torch.device("cpu"))
    rng = np.random.default_rng(nside)
    hmap = torch.tensor(rng.normal(size=12 * nside**2))
    folds = tuple(f.to(device) for f in
                  sp._analysis_folds(hmap, nside, lmax,
                                     sp._bluestein_len(nside), c64))
    L = lmax + 1
    tri = np.tril(np.ones((L, L)))
    alm = tuple(torch.tensor(rng.normal(size=(L, L)) * tri * mask,
                             device=device)
                for mask in (1.0, np.arange(L)[None, :] > 0))
    return folds, alm


def _kernel_vs_plain(name, nside, lmax, dtype, device, to_out):
    """Run kernel and plain version on the same inputs of ``dtype`` (and
    the plain version on the float64 inputs); returns the outputs passed
    through ``to_out`` as (kernel, plain, plain float64) lists."""
    folds, alm = _legendre_inputs(nside, lmax, device)
    ins64 = folds if name == "legendre_alm" else alm
    outs = []
    for dt, fn in ((dtype, getattr(lc, name)),
                   (dtype, getattr(lc, name + "_reference")),
                   (torch.float64, getattr(lc, name + "_reference"))):
        c = sp._seed_consts(nside, lmax, dt, device)
        args = tuple(t.to(dt) for t in ins64) + (c["p_mm"], c["sc0"],
                                                 c["x"])
        before = lc.LAUNCHES[name]
        res = fn(*args)
        torch.cuda.synchronize()
        assert lc.LAUNCHES[name] == before + (fn is getattr(lc, name))
        outs.append([o.double().cpu().numpy() for o in to_out(res)])
    return outs


def _assert_kernel_close(got, want, want64, dtype):
    """float64: to 1e-10 of max|out| (the same recurrence, rounded step
    for step alike; only the final sums' order differs). float32: sums of
    ~R terms with cancellation, where two summation orders differ by the
    rounding error itself: to 4x the plain version's own float32 error
    against its float64 run (test_spectra.py's fixed bars hold at its
    small sizes only)."""
    scale = max(np.abs(w).max() for w in want)
    if dtype == torch.float64:
        atol = 1e-10 * scale
    else:
        atol = 4 * max(np.abs(w - w64).max() for w, w64 in zip(want, want64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nside,lmax", LEGENDRE_SIZES)
def test_legendre_alm_kernel_matches_plain(nside, lmax, dtype, cuda_device):
    got, want, want64 = _kernel_vs_plain("legendre_alm", nside, lmax, dtype,
                                         cuda_device, lambda r: r)
    _assert_kernel_close(got, want, want64, dtype)
    assert not any(np.triu(g, 1).any() for g in got)   # m > l is zero


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nside,lmax", LEGENDRE_SIZES)
def test_legendre_synth_kernel_matches_plain(nside, lmax, dtype,
                                             cuda_device):
    """Compared as maps, as test_spectra.py does: each set of folds
    through the same float64 ring synthesis."""
    c64 = sp._seed_consts(nside, lmax, torch.float64, cuda_device)
    M = sp._bluestein_len(nside)

    def to_map(folds):
        return [sp._synth_from_folds(*(b.double() for b in folds), nside,
                                     lmax, M, c64)]

    got, want, want64 = _kernel_vs_plain("legendre_synth", nside, lmax,
                                         dtype, cuda_device, to_map)
    _assert_kernel_close(got, want, want64, dtype)


# (nside of the seeds, lmax, rings kept, which rings): lmax < 32 (one short
# tile or chunk); L - m never a multiple of the 32 or 64 steps; R = 8; R not a
# multiple of 32; 1, 2, 4, 8 and 16 rings per thread (R up to 256, 512,
# 1024, 2048, 4096), all on the rings nearest the equator; and the 256
# polar rings of NSIDE 512 up to lmax 600, which leave the scaled regime
# one after the other, most of them in the middle of a chunk
TILING_SHAPES = [(4, 11, 8, "equator"), (32, 20, 50, "equator"),
                 (32, 70, 64, "equator"), (128, 45, 200, "equator"),
                 (256, 33, 500, "equator"), (512, 64, 1000, "equator"),
                 (1024, 40, 1100, "equator"), (2048, 37, 2100, "equator"),
                 (2048, 32, 4096, "equator"), (512, 600, 256, "polar")]


def _first_lit_steps(p_mm, sc0, x):
    """For every (m, ring) that starts scaled and leaves the scaled regime
    before lmax: l - m - 1 of the step at which its sc reaches 0 (modulo
    the synthesis kernel's chunk length, the step's place in its chunk),
    by the plain recurrence."""
    L, R = p_mm.shape
    FOLD, BIG = lc._fold_big(p_mm.dtype)
    p1, p2 = torch.zeros_like(p_mm), torch.zeros_like(p_mm)
    sc = torch.zeros_like(sc0)
    m = torch.arange(L, device=x.device)[:, None].expand(L, R)
    places = []
    for l in range(L):
        before = sc[:l] > 0
        lc._recurrence_step(l, l + 1, x, p1, p2, sc, p_mm, sc0, FOLD, BIG)
        lit = before & (sc[:l] == 0)
        places.append(l - m[:l][lit] - 1)
    return torch.cat(places)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nside,lmax,rings,which", TILING_SHAPES)
@pytest.mark.parametrize("name", ["legendre_alm", "legendre_synth"])
def test_legendre_tiling_shapes(name, nside, lmax, rings, which, dtype,
                                cuda_device):
    """Each kernel on ``rings`` rings of an NSIDE's seeds (those nearest
    the equator, or the polar ones), with random inputs, against its plain
    version, output by output with the bars of
    :func:`_assert_kernel_close`."""
    L = lmax + 1
    rng = np.random.default_rng(rings)
    cut = slice(-rings, None) if which == "equator" else slice(0, rings)
    if name == "legendre_alm":
        ins64 = [torch.tensor(rng.normal(size=(L, rings)),
                              device=cuda_device) for _ in range(4)]
    else:
        tri = np.tril(np.ones((L, L)))
        ins64 = [torch.tensor(rng.normal(size=(L, L)) * tri,
                              device=cuda_device) for _ in range(2)]
    outs, tails = [], []
    for dt, fn in ((dtype, getattr(lc, name)),
                   (dtype, getattr(lc, name + "_reference")),
                   (torch.float64, getattr(lc, name + "_reference"))):
        c = sp._seed_consts(nside, lmax, dt, cuda_device)
        tails.append((c["p_mm"][:, cut].contiguous(),
                      c["sc0"][:, cut].contiguous(),
                      c["x"][cut].contiguous()))
        res = fn(*(f.to(dt) for f in ins64), *tails[-1])
        torch.cuda.synchronize()
        outs.append([o.double().cpu().numpy() for o in res])
    if which == "polar":
        chunk = lc.synth_chunk()
        places = _first_lit_steps(*tails[0]) % chunk
        assert int(((places > 0) & (places < chunk - 1)).sum()) > 1000
    got, want, want64 = outs
    _assert_kernel_close(got, want, want64, dtype)
    if name == "legendre_alm":
        assert not any(np.triu(g, 1).any() for g in got)   # m > l is zero
    else:
        assert all(np.isfinite(g).all() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_legendre_synth_writes_every_output(dtype, cuda_device):
    """The synthesis wrapper hands the kernel uninitialised planes: with
    the allocator's free blocks full of NaN, at an R (50) that is no
    multiple of the thread count, every [m, r] comes back written and
    equal to the plain version's."""
    nside, lmax, rings = 32, 70, 50
    L = lmax + 1
    rng = np.random.default_rng(3)
    tri = np.tril(np.ones((L, L)))
    ar, ai = (torch.tensor(rng.normal(size=(L, L)) * tri, dtype=dtype,
                           device=cuda_device) for _ in range(2))
    c = sp._seed_consts(nside, lmax, dtype, cuda_device)
    tail = (c["p_mm"][:, -rings:].contiguous(),
            c["sc0"][:, -rings:].contiguous(), c["x"][-rings:].contiguous())
    want = lc.legendre_synth_reference(ar, ai, *tail)
    poison = [torch.full((L, rings), float("nan"), dtype=dtype,
                         device=cuda_device) for _ in range(8)]
    torch.cuda.synchronize()
    del poison                      # back to the allocator, still NaN
    got = lc.legendre_synth(ar, ai, *tail)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        # the same terms in the same order; the kernel fuses the multiply
        # into the add of each sum
        atol = (1e-12 if dtype == torch.float64 else 1e-5) * scale
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=atol)


@pytest.mark.cuda
def test_legendre_launch_refuses_bad_inputs(cuda_device):
    folds, (ar, ai) = _legendre_inputs(16, 47, cuda_device)
    folds = tuple(f.float() for f in folds)
    ar, ai = ar.float(), ai.float()
    c = sp._seed_consts(16, 47, torch.float32, cuda_device)
    p, s0, x = c["p_mm"], c["sc0"], c["x"]
    with pytest.raises(ValueError, match="shape"):
        lc.legendre_alm(folds[0][:, :8].contiguous(), *folds[1:], p, s0, x)
    with pytest.raises(TypeError):
        lc.legendre_alm(*folds, p.double(), s0, x)
    with pytest.raises(TypeError):
        lc.legendre_synth(ar, ai, p, s0.long(), x)
    with pytest.raises(ValueError, match="contiguous"):
        lc.legendre_synth(ar.T, ai, p, s0, x)
    with pytest.raises(ValueError, match="on"):
        lc.legendre_synth(ar.cpu(), ai, p, s0, x)
    before = dict(lc.LAUNCHES)
    lc.legendre_synth(ar, ai, p, s0, x)
    assert lc.LAUNCHES["legendre_synth"] == before["legendre_synth"] + 1


# ----- grid runners: the CIC redeposit through the scatter kernel -----

def _cic_positions(N, dim, dtype, device, seed=0):
    """Every cell displaced by up to 2.5 cells, some past both box edges
    (negative offsets, and just below 0 and N)."""
    rng = np.random.default_rng(seed)
    pos = [np.arange(N ** dim) // N ** (dim - 1 - d) % N
           + rng.uniform(-2.5, 2.5, N ** dim) for d in range(dim)]
    pos[0][:4] = [-1e-9, N - 1e-12, -N - 0.5, 2 * N + 0.25]
    vals = rng.uniform(0.5, 1.5, N ** dim)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return [t(p) for p in pos], t(vals)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_cic_deposit_kernel_matches_plain(dim, dtype, cuda_device):
    """cic_deposit_{2d,3d} on the card (one scatter launch a CIC corner,
    N^d rows each) against the plain version on the same rows on the card: float64
    to rtol 1e-12 (the same sums in another order), float32 to 1e-5 of
    max|map|; the total is conserved."""
    from baryonification_tpu_torch.ops import scatter as tsc
    N = 32 if dim == 3 else 128
    pos, vals = _cic_positions(N, dim, dtype, cuda_device)
    before = sc.LAUNCHES["scatter_add"]
    fn = tsc.cic_deposit_2d if dim == 2 else tsc.cic_deposit_3d
    got = fn(N, *pos, vals, dtype=dtype)
    assert sc.LAUNCHES["scatter_add"] == before + 2 ** dim
    idx, rows = map(torch.cat, zip(*tsc._cic_corners(N, pos, vals, dtype)))
    assert idx.shape[0] == 2 ** dim * N ** dim
    (want,) = sc.scatter_add_accum_reference(
        (torch.zeros(N ** dim, dtype=dtype, device=cuda_device),), idx,
        (rows,))
    got, want = got.reshape(-1).cpu().numpy(), want.cpu().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    total = float(vals.double().sum())
    assert np.isclose(got.sum(dtype=np.float64), total, rtol=1e-5)


def _small_grids():
    """A small 3D table and gas profile on the CPU; a 3D grid (N = 16,
    L = 40) and a 2D one (N = 32, L = 60, with ellipticity) with 12 halos
    each."""
    import baryonification_tpu_torch as T
    cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
              w0=-1.0)
    par = T.default_params()
    cosmo = T.Cosmology.from_dict(cd, device="cpu")
    grid = dict(z_min=0.1, z_max=0.5, N_samples_z=3, M_min=1e13, M_max=1e15,
                N_samples_Mass=4, R_min=1e-3, R_max=50, N_samples_R=32)
    model = T.Baryonification3D(T.DarkMatterOnly(**par),
                                T.DarkMatterBaryon(**par), cosmo)
    model.setup_interpolator(**grid)
    gas = T.TabulatedProfile(T.Gas(**par), cosmo)
    gas.setup_interpolator(**grid)
    rng = np.random.default_rng(4)
    out = {}
    for dim, N, L in ((3, 16, 40.0), (2, 32, 60.0)):
        kw = dict(x=rng.uniform(0, L, 12), y=rng.uniform(0, L, 12),
                  M=10 ** rng.uniform(13.5, 14.8, 12), redshift=0.25,
                  cosmo=cd)
        if dim == 3:
            kw['z'] = rng.uniform(0, L, 12)
        else:
            kw.update(q_ell=rng.uniform(0.4, 0.9, 12),
                      A_ell=rng.normal(size=(12, 2)))
        gm = T.GriddedMap(map=rng.uniform(0.5, 1.5, (N,) * dim),
                          redshift=0.25, bins=(np.arange(N) + 0.5) * (L / N),
                          cosmo=cd)
        out[dim] = T.HaloNDCatalog(**kw), gm
    return T, model, gas, out


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cellmajor", "scatter"])
def test_grid_runners_on_card_match_cpu(method, cuda_device):
    """BaryonifyGrid and PaintProfilesGrid on the card in float64 against
    the port's CPU float64 run of the same method (3D, and 2D with
    ellipticity), to rms/mean < 1e-10. Every baryonify launches the
    scatter kernel (the CIC redeposit, one launch a corner, and the
    windows of the scatter method), never the cell-major shell kernel;
    the cell-major paint launches neither."""
    T, model, gas, grids = _small_grids()
    for dim, (cat, gm) in grids.items():
        ell = dict(use_ellipticity=dim == 2, method=method, verbose=False)
        for runner, mdl, eps in (("BaryonifyGrid", model, 10),
                                 ("PaintProfilesGrid", gas, 5)):
            cls = getattr(T, runner)
            want = cls(cat, gm, epsilon_max=eps, model=mdl, device="cpu",
                       **ell).process()
            before = (sc.LAUNCHES["scatter_add"],
                      cmc.LAUNCHES["cellmajor_pass"])
            got = cls(cat, gm, epsilon_max=eps, model=mdl,
                      device=cuda_device, precision="float64",
                      **ell).process()
            n_sc = sc.LAUNCHES["scatter_add"] - before[0]
            assert cmc.LAUNCHES["cellmajor_pass"] == before[1]
            n_cic = 2 ** dim if runner == "BaryonifyGrid" else 0
            if method == "scatter":
                assert n_sc > n_cic
            else:
                assert n_sc == n_cic
            scale = gm.map.mean() if runner == "BaryonifyGrid" \
                else want.mean()
            rms = np.sqrt(np.mean((got - want) ** 2)) / scale
            assert np.isfinite(got).all() and rms < 1e-10, \
                (dim, runner, rms)


@pytest.mark.cuda
def test_grid_auto_is_cellmajor_on_card(cuda_device):
    """``auto`` resolves to the cell-major method on the card, and one
    process() of BaryonifyGrid launches the scatter kernel only for the
    CIC redeposit, once a corner (float32, the card's default)."""
    T, model, _, grids = _small_grids()
    cat, gm = grids[3]
    runner = T.BaryonifyGrid(cat, gm, epsilon_max=10, model=model,
                             verbose=False, device=cuda_device)
    assert runner.method == "cellmajor" and runner.dtype == torch.float32
    before = sc.LAUNCHES["scatter_add"]
    out = runner.process()
    assert sc.LAUNCHES["scatter_add"] == before + 8
    assert np.isclose(out.sum(), gm.map.sum())


# chip_smoke.py's model parameters (bench_runners' tSZ model, reference
# example 12's Arico20 set), so that these tests and the smoke run test
# the same models
from chip_smoke import APAR as ARICO_PAR, PAR as TSZ_PAR  # noqa: E402
MODEL_GRID = dict(z_min=0.1, z_max=0.5, N_samples_z=2, M_min=1e13,
                  M_max=1e15, N_samples_Mass=4, R_min=1e-3, R_max=50,
                  N_samples_R=32)


def _cosmo(T, device):
    return T.Cosmology.from_dict(dict(Omega_m=0.3, Omega_b=0.05, h=0.7,
                                      sigma8=0.8, n_s=0.96, w0=-1.0),
                                 device=device)


@pytest.mark.cuda
def test_tsz_table_and_paint_on_card_match_cpu(cuda_device):
    """examples/05's pixel-convolved tSZ table (NSIDE 64) built on the
    card in float64 against the CPU build, to 1e-10 of max|table|; its
    float64 paint on the card, both methods, against the CPU paint to
    rms/mean < 1e-10, the cell-major paint through its kernel."""
    import baryonification_tpu_torch as T
    tabs = {}
    for dev in ("cpu", cuda_device):
        tab = T.TabulatedProfile(T.ConvolvedProfile(
            T.ThermalSZ(**TSZ_PAR), T.HealPixel(64)), _cosmo(T, dev))
        tab.setup_interpolator(**dict(MODEL_GRID, M_min=1e12, M_max=1e16,
                                      R_max=1e2, N_samples_R=40))
        tabs[str(dev)] = tab
    want, got = tabs["cpu"], tabs[str(cuda_device)]
    # nodes whose log is not finite (a zero or, past the FFTLog ringing, a
    # negative projected profile) paint nothing: compared as 0
    w2, g2 = (torch.where(torch.isfinite(t._ln2D), torch.exp(t._ln2D),
                          0.0).cpu() for t in (want, got))
    assert not torch.isfinite(want._ln3D).any()
    assert not torch.isfinite(got._ln3D).any()
    assert float((g2 - w2).abs().max() / w2.abs().max()) < 1e-10

    rng = np.random.default_rng(2)
    n = 300
    cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
              w0=-1.0)
    cat = T.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.5, 15.0, n), z=rng.uniform(0.1, 0.9, n),
        cosmo=cd)
    shell = T.LightconeShell(map=np.zeros(12 * 64**2), cosmo=cd)
    for method in ("cellmajor", "scatter"):
        kw = dict(epsilon_max=5, model=want, verbose=False, method=method)
        ref = T.PaintProfilesShell(cat, shell, device="cpu", **kw).process()
        before = cmc.LAUNCHES["cellmajor_pass"]
        out = T.PaintProfilesShell(cat, shell, device=cuda_device,
                                   precision="float64", **kw).process()
        assert (cmc.LAUNCHES["cellmajor_pass"] > before) == \
            (method == "cellmajor")
        rms = np.sqrt(np.mean((out - ref) ** 2)) / ref.mean()
        assert ref.sum() > 0 and np.isfinite(out).all() and rms < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["Arico20", "Mead20"])
def test_family_table_on_card_matches_cpu(family, cuda_device):
    """A small Baryonification3D table of the Arico20 (reference example
    12's parameters) or Mead20 (Params_TAGN_7p8) family built on the card
    in float64 against the CPU build, to 1e-10 of max|table|."""
    import baryonification_tpu_torch as T
    fam = getattr(T.profiles, family)
    par = ARICO_PAR if family == "Arico20" else fam.Params_TAGN_7p8
    out = {}
    for dev in ("cpu", cuda_device):
        model = T.Baryonification3D(fam.DarkMatterOnly(**par),
                                    fam.DarkMatterBaryon(**par),
                                    _cosmo(T, dev), epsilon_max=10)
        model.setup_interpolator(verbose=False, **MODEL_GRID)
        out[str(dev)] = model._table.cpu().numpy()
    want, got = out["cpu"], out[str(cuda_device)]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cellmajor", "gather"])
def test_snapshot_on_card_matches_cpu(method, cuda_device):
    """BaryonifySnapshot on the card in float64 against the port's CPU
    float64 run of the same method: the rms of the position difference
    over the rms of the CPU's offsets < 1e-10. The gather method launches
    the scatter kernel (one launch a halo chunk) and no snap_pass, the
    cell-major method snap_pass (one launch a bucket; its census, from
    the kernel's tally, that of the plain loop on the CPU) and no other
    kernel."""
    T, model, _, _ = _small_grids()
    cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
              w0=-1.0)
    rng = np.random.default_rng(9)
    L, n_part, n_halo = 60.0, 8000, 12
    snap = T.ParticleSnapshot(*rng.uniform(0, L, (3, n_part)),
                              M=np.ones(n_part), L=L, redshift=0.25, cosmo=cd)
    cat = T.HaloNDCatalog(x=rng.uniform(0, L, n_halo),
                          y=rng.uniform(0, L, n_halo),
                          z=rng.uniform(0, L, n_halo),
                          M=10 ** rng.uniform(13.5, 14.8, n_halo),
                          redshift=0.25, cosmo=cd)
    kw = dict(epsilon_max=10, model=model, method=method, verbose=False)
    cpu = T.BaryonifySnapshot(cat, snap, device="cpu", **kw)
    card = T.BaryonifySnapshot(cat, snap, device=cuda_device,
                               precision="float64", **kw)
    cpu.census, card.census = [], []
    want = cpu.process()
    before = (sc.LAUNCHES["scatter_add"], cmc.LAUNCHES["cellmajor_pass"],
              spc.LAUNCHES["snap_pass"])
    got = card.process()
    n_sc = sc.LAUNCHES["scatter_add"] - before[0]
    n_snap = spc.LAUNCHES["snap_pass"] - before[2]
    assert cmc.LAUNCHES["cellmajor_pass"] == before[1]
    assert (n_sc > 0) == (method == "gather")
    if method == "gather":
        assert n_snap == 0
    else:
        assert n_snap == len(card.census) == len(cpu.census) > 0
        for a, b in zip(card.census, cpu.census):
            assert (a["pairs"], a["inside"]) == (b["pairs"], b["inside"])
    g, w, x0 = (np.stack([c[k] for k in "xyz"], -1)
                for c in (got, want, snap.cat))
    off = w - x0
    off -= L * np.round(off / L)
    scale = np.sqrt(np.mean(off ** 2))
    assert scale > 1e-3
    assert np.isfinite(g).all()
    assert np.sqrt(np.mean((g - w) ** 2)) / scale < 1e-10


@pytest.mark.cuda
def test_pk_suppression_on_card_matches_cpu(cuda_device):
    """examples/10's halo-model suppression at one Fig. 2 sweep point
    (theta_ej = 4, few masses) on the card against the CPU, to 1e-10
    relative."""
    import baryonification_tpu_torch as T
    from chip_smoke import fig2_sweeps, s19_fig2_config
    k = np.geomspace(0.05, 20.0, 30)
    out = {}
    for dev in ("cpu", cuda_device):
        cosmo, bpar, Gas_S19, h = s19_fig2_config(T, dev)
        par = dict(fig2_sweeps(bpar, h))["T4"]
        dmb = T.DarkMatterBaryon(**par, gas=Gas_S19(**par)) - T.TwoHalo(**par)
        out[str(dev)] = T.analysis.pk_suppression(
            T.DarkMatter(**par), dmb, cosmo, k, n_M_lo=6, n_M_hi=10
        ).cpu().numpy()
    want, got = out["cpu"], out[str(cuda_device)]
    assert 1 - want.min() > 0.05
    assert np.abs(got / want - 1).max() < 1e-10


# ----- the scatter-add's backward, the chunked launches, and the
# differentiable grid and snapshot paths -----

def _vjp_rows(C, dtype, device, npix=700, n=5000, seed=0, integer=False):
    """Unsorted int32 rows with sentinel rows (== npix and beyond), C
    value planes and C cotangent planes; ``integer`` values (small
    integers) sum exactly in any order."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, npix, n).astype(np.int32)
    idx[rng.random(n) < 0.15] = npix
    idx[:7] = npix + np.arange(7) * 1000
    mk = (lambda m: rng.integers(-8, 9, m).astype(np.float64)) if integer \
        else (lambda m: rng.normal(size=m))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (torch.tensor(idx, device=device),
            tuple(t(mk(n)) for _ in range(C)),
            tuple(t(mk(npix)) for _ in range(C)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_scatter_vjp_kernel_matches_plain(C, dtype, cuda_device):
    """scatter_add_vjp on the card (one launch) against its plain version
    (masked index_select) on the same rows: a gather, so exact; int64
    rows past the sentinel give 0 as int32 ones do."""
    idx, _, cts = _vjp_rows(C, dtype, cuda_device, seed=C)
    before = sc.LAUNCHES["scatter_add_vjp"]
    got = sc.scatter_add_vjp(cts, idx)
    assert sc.LAUNCHES["scatter_add_vjp"] == before + 1
    want = sc.scatter_add_vjp_reference(cts, idx)
    got64 = sc.scatter_add_vjp(cts, idx.long())
    for g, g64, w in zip(got, got64, want):
        assert g.dtype == dtype and g.shape == idx.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(g64, w, rtol=0, atol=0)
    assert bool((got[0][idx >= cts[0].shape[0]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_scatter_chunked_matches_one_launch(C, dtype, cuda_device,
                                            monkeypatch):
    """With the chunk length lowered to 1000 rows, the forward and the
    backward of 5000 rows (sentinel rows included) take five launches
    each and equal one launch: the forward on integer values, which sum
    exactly in any order, and the backward (a gather) exactly."""
    idx, vals, cts = _vjp_rows(C, dtype, cuda_device, seed=10 + C,
                               integer=True)
    npix = cts[0].shape[0]
    one = sc.scatter_add_accum(tuple(torch.zeros_like(g) for g in cts), idx,
                               vals)
    d_one = sc.scatter_add_vjp(cts, idx)
    monkeypatch.setattr(sc, "CHUNK_ROWS", 1000)
    before = dict(sc.LAUNCHES)
    chunked = sc.scatter_add_accum(tuple(torch.zeros_like(g) for g in cts),
                                   idx, vals)
    d_chunked = sc.scatter_add_vjp(cts, idx)
    assert sc.LAUNCHES["scatter_add"] == before["scatter_add"] + 5
    assert sc.LAUNCHES["scatter_add_vjp"] == before["scatter_add_vjp"] + 5
    want = sc.scatter_add_accum_reference(
        tuple(torch.zeros(npix, dtype=dtype, device=cuda_device)
              for _ in range(C)), idx, vals)
    for a, b, w in zip(chunked, one, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    for a, b in zip(d_chunked, d_one):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_scatter_autograd_gradcheck_on_card(cuda_device):
    """torch.autograd.gradcheck (and gradgradcheck: the backward's own
    VJP is the scatter-add) of scatter_add_accum in float64 on the card,
    into accumulators that carry a graph, two planes, sentinel rows; the
    backward launches the scatter_add_vjp kernel."""
    idx, vals, base = _vjp_rows(2, torch.float64, cuda_device, npix=40,
                                n=120, seed=3)
    leaves = tuple(t.clone().requires_grad_(True) for t in base + vals)

    def f(a0, a1, v0, v1):
        accs = (a0 * 1.0, a1 * 1.0)
        return sc.scatter_add_accum(accs, idx, (v0, v1))

    before = sc.LAUNCHES["scatter_add_vjp"]
    assert torch.autograd.gradcheck(f, leaves)
    assert torch.autograd.gradgradcheck(f, leaves)
    assert sc.LAUNCHES["scatter_add_vjp"] > before


def _grad_of_scale(runner, table, loss):
    """(first, second) derivative of loss(process_device(table * s)) at
    s = 1, the second by double backward."""
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    out = runner.process_device(table.to(runner.device) * s)
    (g,) = torch.autograd.grad(loss(out), s, create_graph=True)
    (h,) = torch.autograd.grad(g, s)
    return float(g.detach()), float(h)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cellmajor", "scatter"])
def test_grid_process_device_on_card_matches_cpu(method, cuda_device):
    """BaryonifyGrid and PaintProfilesGrid.process_device on the card in
    float64 (3D, and 2D with ellipticity): the map against process() on
    the card to rms/mean < 1e-12 (the CIC's atomic adds land in no fixed
    order) and against the CPU's to 1e-10; the first and second
    derivatives in a table scale against the CPU's to 1e-8. Every
    backward launches the scatter_add_vjp kernel (the CIC's, the windowed
    scatters' or the cell-major passes' row reads)."""
    T, model, gas, grids = _small_grids()
    for dim, (cat, gm) in grids.items():
        kw = dict(use_ellipticity=dim == 2, method=method, verbose=False)
        for runner, mdl, eps in (("BaryonifyGrid", model, 10),
                                 ("PaintProfilesGrid", gas, 5)):
            cls = getattr(T, runner)
            tab = mdl._table if runner == "BaryonifyGrid" else (
                mdl._ln2D if dim == 2 else mdl._ln3D)
            loss = (lambda m: (m ** 2).sum()) if runner == "BaryonifyGrid" \
                else (lambda m: m.sum())
            cpu = cls(cat, gm, epsilon_max=eps, model=mdl, device="cpu", **kw)
            card = cls(cat, gm, epsilon_max=eps, model=mdl,
                       device=cuda_device, precision="float64", **kw)
            want = cpu.process_device().numpy()
            got = card.process_device().cpu().numpy()
            proc = card.process()
            scale = gm.map.mean() if runner == "BaryonifyGrid" \
                else want.mean()
            assert np.sqrt(np.mean((got - proc) ** 2)) / scale < 1e-12
            assert np.sqrt(np.mean((got - want) ** 2)) / scale < 1e-10
            want = _grad_of_scale(cpu, tab, loss)
            before = sc.LAUNCHES["scatter_add_vjp"]
            got = _grad_of_scale(card, tab, loss)
            assert sc.LAUNCHES["scatter_add_vjp"] > before, (dim, runner)
            for g_card, g_cpu in zip(got, want):
                assert g_cpu != 0 and abs(g_card - g_cpu) / abs(g_cpu) \
                    < 1e-8, (dim, runner, got, want)


@pytest.mark.cuda
def test_snapshot_process_device_on_card_matches_cpu(cuda_device):
    """BaryonifySnapshot.process_device on the card in float64: the
    positions equal process()'s bit for bit (one pass, no atomics; the
    wrap into [0, L] on the card) and the CPU's to 1e-12 of the box; the
    first and second derivatives of the sum of squared x offsets in a
    table scale against the CPU's to 1e-8."""
    T, model, _, _ = _small_grids()
    cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
              w0=-1.0)
    rng = np.random.default_rng(9)
    L, n_part, n_halo = 60.0, 8000, 12
    snap = T.ParticleSnapshot(*rng.uniform(0, L, (3, n_part)),
                              M=np.ones(n_part), L=L, redshift=0.25, cosmo=cd)
    cat = T.HaloNDCatalog(x=rng.uniform(0, L, n_halo),
                          y=rng.uniform(0, L, n_halo),
                          z=rng.uniform(0, L, n_halo),
                          M=10 ** rng.uniform(13.5, 14.8, n_halo),
                          redshift=0.25, cosmo=cd)
    kw = dict(epsilon_max=10, model=model, method="cellmajor", verbose=False)
    cpu = T.BaryonifySnapshot(cat, snap, device="cpu", **kw)
    card = T.BaryonifySnapshot(cat, snap, device=cuda_device,
                               precision="float64", **kw)
    got = card.process_device()
    proc = card.process()
    want = cpu.process_device()
    for c, g, w in zip("xyz", got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), proc[c])
        assert float((g.cpu() - w).abs().max()) < 1e-12 * L

    def loss(pos, x0):
        d = pos[0] - x0
        d = d - L * torch.round(d / L)
        return (d * d).sum()

    want, got = (_grad_of_scale(
        r, model._table,
        lambda pos, r=r: loss(pos, torch.as_tensor(snap.cat['x'],
                                                   device=r.device)))
        for r in (cpu, card))
    for g_card, g_cpu in zip(got, want):
        assert g_cpu != 0 and abs(g_card - g_cpu) / abs(g_cpu) < 1e-8


def _anis_inputs(T):
    """CPU-built Gas paint and DarkMatter canvas tables (12 mass nodes), a
    32^2 canvas map and 10 halos."""
    cd = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
              w0=-1.0)
    par = T.default_params()
    cosmo = T.Cosmology.from_dict(cd, device="cpu")
    grid = dict(z_min=0.05, z_max=0.6, N_samples_z=3, M_min=1e13,
                M_max=1e15, N_samples_Mass=12, R_min=1e-3, R_max=70,
                N_samples_R=40)
    models = []
    for cls in (T.Gas, T.DarkMatter):
        m = T.TabulatedProfile(cls(**par), cosmo)
        m.setup_interpolator(**grid)
        models.append(m)
    rng = np.random.default_rng(7)
    N, L = 32, 60.0
    cat = T.HaloNDCatalog(x=rng.uniform(5, 55, 10), y=rng.uniform(5, 55, 10),
                          M=10 ** rng.uniform(13.5, 14.8, 10), redshift=0.25,
                          cosmo=cd)
    gm = T.GriddedMap(map=10 ** rng.uniform(12.0, 14.0, (N, N)),
                      redshift=0.25, bins=(np.arange(N) + 0.5) * (L / N),
                      cosmo=cd)
    return cat, gm, models


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cellmajor", "scatter"])
def test_anis_on_card_matches_cpu(method, cuda_device):
    """PaintProfilesAnisGrid on the card in float64 (CPU-built tables)
    against the CPU: process() of each method to rms/max < 1e-10 (the
    loop through the scatter kernel), and for the cell-major pass
    process_device() equal to process() on the card, the derivatives of
    the painted sum in a canvas scale (first and second) and in a remap
    scale against the CPU's to 1e-8, the remap scale's row reads through
    the scatter_add_vjp kernel."""
    import baryonification_tpu_torch as T
    cat, gm, (paint, canvas) = _anis_inputs(T)
    kw = dict(epsilon_max=3, Painting_model=paint, Canvas_model=canvas,
              verbose=False, method=method)
    cpu = T.PaintProfilesAnisGrid(cat, gm, device="cpu", **kw)
    card = T.PaintProfilesAnisGrid(cat, gm, device=cuda_device,
                                   precision="float64", **kw)
    want = cpu.process()
    before = sc.LAUNCHES["scatter_add"]
    got = card.process()
    assert (sc.LAUNCHES["scatter_add"] > before) == (method == "scatter")
    assert (want != 0).sum() > 20
    assert np.sqrt(np.mean((got - want) ** 2)) / np.abs(want).max() < 1e-10
    if method == "scatter":
        return
    np.testing.assert_array_equal(card.process_device().cpu().numpy(), got)

    def derivs(r, which):
        s = torch.tensor(1.0, dtype=torch.float64, device=r.device,
                         requires_grad=True)
        if which == "canvas":
            out = r.process_device(canvas=torch.as_tensor(
                gm.map, device=r.device) * s)
        else:
            rm = r.build_remap_device()
            nq = rm.shape[1] - 2
            out = r.process_device(remap=torch.cat(
                [rm[:, :nq] * s, rm[:, nq:]], dim=1))
        (g,) = torch.autograd.grad(out.sum(), s, create_graph=True)
        (h,) = torch.autograd.grad(g, s)
        return float(g.detach()), float(h)

    for which in ("canvas", "remap"):
        before = sc.LAUNCHES["scatter_add_vjp"]
        got_d = derivs(card, which)
        assert (sc.LAUNCHES["scatter_add_vjp"] > before) == \
            (which == "remap")
        for g_card, g_cpu in zip(got_d, derivs(cpu, which)):
            assert g_cpu != 0 and abs(g_card - g_cpu) / abs(g_cpu) < 1e-8, \
                (which, got_d)


@pytest.mark.cuda
@pytest.mark.parametrize("nside_in,nside_out", [(64, 16), (16, 64)])
def test_ud_grade_on_card_matches_cpu(nside_in, nside_out, cuda_device):
    """ud_grade on the card against the CPU, power -2: upgrading copies
    (exact), degrading sums 16 children in a scan whose order may round
    apart on the card (1e-14 relative); the sum is kept."""
    m = torch.as_tensor(np.random.default_rng(3).uniform(
        0.5, 1.5, hpx.npix(nside_in)))
    want = hpx.ud_grade(m, nside_out, power=-2)
    got = hpx.ud_grade(m.to(cuda_device), nside_out, power=-2)
    assert got.is_cuda and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-14,
                               atol=0)
    assert abs(float(got.sum()) - float(m.sum())) < 1e-12 * float(m.sum())


# ----- the grid pass kernels (csrc/grid_pass.cu) against the step loop -----

from _torch_grid_cases import CASES as GRID_CASES  # noqa: E402
from _torch_grid_cases import (grid_case, patch_slots,  # noqa: E402
                               port_bucket, port_rows)
from baryonification_tpu_torch.ops import grid_pass_cuda as gpc  # noqa: E402
from baryonification_tpu_torch.runners import \
    grid_cellmajor as tgcm  # noqa: E402

# float32 bars of the kernels against the step loop, of max|plain|: the
# same arithmetic a slot (the geometry bit for bit), summed in another
# order: a voxel's at most 9 slots (the pass), a node's shares from a few
# hundred voxel-slots, by atomic adds in no fixed order on both sides
# (the adjoint)
GRID_KERNEL_F32_BAR = {"pass": 1e-5, "vjp": 1e-4}


def _grid_inputs(name, mode, dtype, device):
    case = grid_case(name, mode)
    bk = port_bucket(case, mode, device, dtype)
    rows = port_rows(case, torch.as_tensor(case["table_z"], dtype=dtype,
                                           device=device))
    return case, bk, rows


def _grid_cts(bk, rows, seed=1):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(bk.ncell * bk.F, generator=gen,
                             dtype=torch.float64).to(rows)
                 for _ in range(bk.n_planes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["offsets", "offsets_rdelta", "paint"])
@pytest.mark.parametrize("name", list(GRID_CASES))
def test_grid_kernels_match_step_loop(name, mode, dtype, cuda_device):
    """grid_pass and grid_vjp against the plain step loop (_bucket_pass,
    _bucket_vjp) on the shared cases: float64 within 1e-12 of max|plain|,
    float32 within GRID_KERNEL_F32_BAR; the kernels' tallies equal to the
    loop's census. The adjoint gives 0 at the NaN row, where the loop's
    autograd gives NaN (0 * exp(NaN), paint) or 0."""
    _, bk, rows = _grid_inputs(name, mode, dtype, cuda_device)
    head, tail = bk.kernel_args(rows), bk.kernel_scalars()
    tally = torch.zeros(len(gpc.TALLY), dtype=torch.int64,
                        device=cuda_device)
    got = gpc.grid_pass(*head, *tail, tally=tally)
    census = dict(slots=0, inside=0, steps=0)
    want = tgcm._bucket_pass(bk, rows, tgcm._zero_planes(bk, rows), census)
    torch.cuda.synchronize()
    f64 = dtype == torch.float64
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert scale > 0 and all(bool(torch.isfinite(g).all()) for g in got)
    assert err <= (1e-12 if f64 else GRID_KERNEL_F32_BAR["pass"]) * scale, \
        (err, scale)
    assert tally.tolist()[:2] == [census["slots"], census["inside"]]
    assert 0 < census["inside"] < census["slots"]
    assert tally.tolist()[2] == 0

    cts = _grid_cts(bk, rows)
    vtally = torch.zeros(len(gpc.TALLY), dtype=torch.int64,
                         device=cuda_device)
    d_k = gpc.grid_vjp(*head, cts, *tail, tally=vtally)
    with torch.no_grad():
        (d_p,) = tgcm._bucket_vjp(bk, rows, cts)
    ok = torch.isfinite(rows).all(dim=1)
    assert not ok.all() and bool(torch.isfinite(d_k).all())
    assert float(d_k[~ok].abs().max()) == 0.0
    scale = float(d_p[ok].abs().max())
    err = float((d_k[ok] - d_p[ok]).abs().max())
    assert scale > 0
    assert err <= (1e-12 if f64 else GRID_KERNEL_F32_BAR["vjp"]) * scale, \
        (err, scale)
    vt = vtally.tolist()
    assert vt[:2] == tally.tolist()[:2] and 0 < vt[2] <= 2 * vt[1]
    assert vt[3] == tally.tolist()[3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["offsets", "offsets_rdelta", "paint"])
@pytest.mark.parametrize("name", list(GRID_CASES))
def test_grid_kernels_cull_is_exact(name, mode, dtype, cuda_device):
    """The kernels with their cull (the runners' launch) against launches
    that walk every listed slot (cull=False): the planes equal bit for
    bit, and so do the tallies' slots and inside; the cull skips at least
    one (patch, slot) pair and none where a voxel is live by the plain
    geometry (patch_slots), and none without it; grid_vjp with and
    without the cull agrees within 1e-12 (float64) or GRID_KERNEL_F32_BAR
    (float32) of max|d_rows| (its adds merge in another order)."""
    _, bk, rows = _grid_inputs(name, mode, dtype, cuda_device)
    head, tail = bk.kernel_args(rows), bk.kernel_scalars()
    out, counts = {}, {}
    for cull in (True, False):
        for entry in ("pass", "vjp"):
            tally = torch.zeros(len(gpc.TALLY), dtype=torch.int64,
                                device=cuda_device)
            out[entry, cull] = (
                gpc.grid_pass(*head, *tail, tally=tally, cull=cull)
                if entry == "pass" else
                gpc.grid_vjp(*head, _grid_cts(bk, rows), *tail,
                             tally=tally, cull=cull))
            counts[entry, cull] = dict(zip(gpc.TALLY, tally.tolist()))
    assert all(torch.equal(a, b)
               for a, b in zip(out["pass", True], out["pass", False]))
    pairs, dead = patch_slots(bk)
    for entry in ("pass", "vjp"):
        on, off = counts[entry, True], counts[entry, False]
        assert (on["slots"], on["inside"]) == (off["slots"], off["inside"])
        assert off["culled"] == 0 and 0 < on["culled"] <= dead < pairs, \
            (entry, on["culled"], dead, pairs)
    ok = torch.isfinite(rows).all(dim=1)
    d_on, d_off = out["vjp", True], out["vjp", False]
    assert bool(torch.isfinite(d_on).all())
    scale = float(d_off[ok].abs().max())
    err = float((d_on[ok] - d_off[ok]).abs().max())
    f64 = dtype == torch.float64
    assert scale > 0
    assert err <= (1e-12 if f64 else GRID_KERNEL_F32_BAR["vjp"]) * scale, \
        (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("3d_block0", "offsets"),
                                       ("2d", "offsets_rdelta"),
                                       ("3d", "paint")])
def test_grid_pass_gradcheck(name, mode, cuda_device):
    """torch.autograd.gradcheck of the pass in its rows on the card in
    float64 (the kernel forward, the grid_vjp backward; the NaN row set
    finite; the atomic adds' order allowed 1e-12 between two backwards)."""
    _, bk, rows = _grid_inputs(name, mode, torch.float64, cuda_device)
    rows = torch.nan_to_num(rows, nan=0.5).requires_grad_(True)
    before = dict(gpc.LAUNCHES)
    assert torch.autograd.gradcheck(lambda r: tgcm._pass_diff(bk, r),
                                    (rows,), nondet_tol=1e-12)
    assert gpc.LAUNCHES["grid_pass"] > before["grid_pass"]
    assert gpc.LAUNCHES["grid_vjp"] > before["grid_vjp"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["offsets", "paint"])
def test_grid_kernel_launches(mode, cuda_device):
    """One grid_pass launch a bucket's forward and one grid_vjp launch its
    first-order backward, with no scatter_add_vjp launch for the row
    reads; under create_graph the backward is the step loop (its row
    reads through scatter_add_vjp, no grid_vjp launch) and its gradient
    the first-order one."""
    case, bk, rows = _grid_inputs("2d_block0", mode, torch.float64,
                                  cuda_device)
    n0 = dict(gpc.LAUNCHES, vjp=sc.LAUNCHES["scatter_add_vjp"])
    gpc_counts = lambda: dict(gpc.LAUNCHES,
                              vjp=sc.LAUNCHES["scatter_add_vjp"])
    with torch.no_grad():
        tgcm._pass_diff(bk, rows)
    assert gpc_counts() == dict(n0, grid_pass=n0["grid_pass"] + 1)
    r = rows.clone().requires_grad_(True)
    out = tgcm._pass_diff(bk, r)
    cts = _grid_cts(bk, rows)
    (d1,) = torch.autograd.grad(out, r, cts)
    assert gpc_counts() == dict(n0, grid_pass=n0["grid_pass"] + 2,
                                grid_vjp=n0["grid_vjp"] + 1)
    out = tgcm._pass_diff(bk, r)
    (d2,) = torch.autograd.grad(out, r, cts, create_graph=True)
    d2 = d2.detach()
    now = gpc_counts()
    assert now["grid_pass"] == n0["grid_pass"] + 3
    assert now["grid_vjp"] == n0["grid_vjp"] + 1 and now["vjp"] > n0["vjp"]
    ok = torch.isfinite(rows).all(dim=1)
    scale = float(d1[ok].abs().max())
    assert float((d1[ok] - d2[ok]).abs().max()) <= 1e-12 * scale


@pytest.mark.cuda
def test_grid_runner_launches_grid_pass(cuda_device):
    """A warm process() of BaryonifyGrid and PaintProfilesGrid (3D and 2D)
    launches grid_pass once a bucket, and the census that the kernels'
    tallies fill counts the slots the loop's census counts on the CPU."""
    T, model, gas, grids = _small_grids()
    for dim, (cat, gm) in grids.items():
        for cls, mdl, eps in (("BaryonifyGrid", model, 10),
                              ("PaintProfilesGrid", gas, 5)):
            kw = dict(epsilon_max=eps, model=mdl, verbose=False,
                      precision="float64", use_ellipticity=dim == 2)
            card = getattr(T, cls)(cat, gm, device=cuda_device, **kw)
            cpu = getattr(T, cls)(cat, gm, device="cpu", method="cellmajor",
                                  **kw)
            card.process()
            card.census, cpu.census = [], []
            n0 = gpc.LAUNCHES["grid_pass"]
            card.process()
            assert gpc.LAUNCHES["grid_pass"] - n0 == len(card.census) > 0
            cpu.process()
            assert len(cpu.census) == len(card.census)
            for a, b in zip(card.census, cpu.census):
                assert (a["slots"], a["inside"]) == (b["slots"],
                                                     b["inside"]), (dim, cls)


# ----- the shell regrid: csrc/regrid.cu -----

from _torch_regrid_cases import CASES as REGRID_CASES  # noqa: E402
from _torch_regrid_cases import as_torch, regrid_case  # noqa: E402
from baryonification_tpu_torch.ops import regrid_cuda as rc  # noqa: E402

# the adjoint kernel against autograd of the plain version, of the largest
# gradient (the same formula in another order; float32 rounds in
# 1 / sqrt(1 - c^2) and 1 / (x^2 + y^2) near the poles)
REGRID_VJP_BAR = {torch.float64: 1e-10, torch.float32: 1e-4}


def regrid_map_bar(dtype, counts):
    """The bar of a map against the plain version's, of max|map|: the
    same positive rows summed in two orders differ by at most
    2 (L - 1) u of the sum, L the longest segment (``counts``: the rows
    a destination takes), u the unit roundoff; float64 at least 1e-12,
    the CPU tests' bar."""
    u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
    bound = 2 * max(int(counts.max()) - 1, 1) * u if counts.numel() else u
    return bound if dtype == torch.float32 else max(bound, 1e-12)


def _regrid_inputs(name, dtype, device):
    return as_torch(regrid_case(name), dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", REGRID_CASES)
def test_regrid_parts_match_plain(name, dtype, cuda_device):
    """The check entry's ids and weights equal the plain ops' on the card
    bit for bit (the kernel rounds as PyTorch's CUDA ops do)."""
    nside, vx, vy, vz, m, off = _regrid_inputs(name, dtype, cuda_device)
    ids, w = rc._regrid_parts(nside, vx, vy, vz, off)
    x, y, z = (v + o for v, o in zip((vx, vy, vz), off))
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    ps, ws = hpx.get_interp_weights_parts(nside, theta, phi)
    assert torch.equal(ids, torch.stack(ps))
    want = torch.stack(ws)
    bad = (w != want).nonzero()
    assert bad.shape[0] == 0, (bad.shape[0], bad[:4].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", REGRID_CASES)
def test_regrid_kernel_matches_plain(name, dtype, cuda_device):
    """The atomic kernel's map against the plain version on the card
    (regrid_map_bar of max|map|), the mass conserved (float64 to 1e-8,
    float32 to that bar and eight roundings); one launch
    (none for no pixel); the deterministic route within the same bar and
    equal to itself over two runs bit for bit."""
    args = _regrid_inputs(name, dtype, cuda_device)
    m = args[4]
    want = rc.regrid_shell_reference(*args)
    bar = regrid_map_bar(dtype, rc._segment_counts(
        args[0], *rc._planes("t", *args[1:]))) if m.shape[0] else 0.0
    n0 = dict(rc.LAUNCHES)
    got = rc.regrid_shell(*args)
    assert rc.LAUNCHES["regrid"] - n0["regrid"] == int(m.shape[0] > 0)
    torch.use_deterministic_algorithms(True)
    try:
        det = [rc.regrid_shell(*args) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert rc.LAUNCHES["regrid_det"] - n0["regrid_det"] == \
        2 * int(m.shape[0] > 0)
    assert torch.equal(det[0], det[1])
    scale = max(float(want.abs().max()), 1e-300)
    for out in (got, det[0]):
        assert out.dtype == dtype and out.shape == want.shape
        assert float((out - want).abs().max()) <= bar * scale
        # float32 weights sum to 1 within a few roundings, and the sums
        # round as above
        tol = 1e-8 if dtype == torch.float64 else bar + 8 * 2.0 ** -24
        mass = float(m.double().sum())
        assert abs(float(out.double().sum()) - mass) <= tol * max(mass, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_regrid_deterministic_long_segments(dtype, cuda_device):
    """The pile-up (hundreds of rows on a few destinations: the warp path,
    in shared memory and past it in global memory) and a whole NSIDE-64
    sky moved a few pixels: the deterministic route's map the same bit
    for bit over two runs, and within regrid_map_bar of the plain version
    also with the inputs permuted (other keys, so another order)."""
    for name in ("pileup", "n64_nested_large"):
        nside, vx, vy, vz, m, off = _regrid_inputs(name, dtype, cuda_device)
        planes, T, n = rc._planes("t", vx, vy, vz, m, off)
        counts = rc._segment_counts(nside, planes, T, n)
        if name == "pileup":
            assert int(counts.max()) > 256, int(counts.max())
        bar = regrid_map_bar(dtype, counts)
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(0)
                              ).to(cuda_device)
        torch.use_deterministic_algorithms(True)
        try:
            a = rc.regrid_shell(nside, vx, vy, vz, m, off)
            b = rc.regrid_shell(nside, vx, vy, vz, m, off)
            c = rc.regrid_shell(nside, vx[perm], vy[perm], vz[perm], m[perm],
                                tuple(o[perm] for o in off))
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(a, b)
        want = rc.regrid_shell_reference(nside, vx, vy, vz, m, off)
        scale = float(want.abs().max())
        for out in (a, c):
            assert float((out - want).abs().max()) <= bar * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", [c for c in REGRID_CASES if c != "empty"])
def test_regrid_vjp_matches_autograd(name, dtype, cuda_device):
    """The adjoint kernel against autograd of the plain forward on the
    card, in the offsets and the map (REGRID_VJP_BAR of the largest
    gradient; NaN where autograd's is NaN: z / r exactly +-1), and through
    the autograd Function: one regrid_vjp launch for a first-order
    backward, none under create_graph (the plain closed form). In float32
    at NSIDE 8192's polar caps theta = acos(z / r) rounds more coarsely
    than the rings lie, and autograd of the plain forward and the plain
    closed form differ there by more than the bar, both far off
    float64's (ROADMAP C; experiments/regrid/f32_caps.py): that case
    holds the kernel to its plain closed form instead of autograd."""
    nside, vx, vy, vz, m, off = _regrid_inputs(name, dtype, cuda_device)
    ct = torch.as_tensor(np.random.default_rng(1).normal(
        size=12 * nside * nside), dtype=dtype, device=cuda_device)
    leaves = [o.clone().requires_grad_() for o in off] + [
        m.clone().requires_grad_()]
    out = rc.regrid_shell_reference(nside, vx, vy, vz, leaves[3],
                                    tuple(leaves[:3]))
    want = torch.autograd.grad(out, leaves, ct)
    if name == "n8192_caps" and dtype == torch.float32:
        d_o, d_m = rc.regrid_vjp_reference(nside, vx, vy, vz, m, off, ct)
        want = list(d_o) + [d_m]
    n0 = rc.LAUNCHES["regrid_vjp"]
    out = rc.regrid_shell(nside, vx, vy, vz, leaves[3], tuple(leaves[:3]))
    got = torch.autograd.grad(out, leaves, ct)
    assert rc.LAUNCHES["regrid_vjp"] == n0 + 1
    (d_o, d_m) = rc.regrid_vjp(nside, vx, vy, vz, m, off, ct)
    assert all(torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
               for a, b in zip(got, list(d_o) + [d_m]))
    scale = max(float(torch.nan_to_num(w, nan=0.0).abs().max())
                for w in want)

    def assert_close(got):
        for g, w in zip(got, want):
            g = g.detach()
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            ok = ~torch.isnan(w)
            if ok.any():
                assert float((g[ok] - w[ok]).abs().max()) <= \
                    REGRID_VJP_BAR[dtype] * scale, name

    assert_close(got)
    out = rc.regrid_shell(nside, vx, vy, vz, leaves[3], tuple(leaves[:3]))
    got2 = torch.autograd.grad(out, leaves, ct, create_graph=True)
    assert rc.LAUNCHES["regrid_vjp"] == n0 + 2      # the direct call above
    assert_close(got2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nside", [1, 2, 16, 1024, 8192])
def test_regrid_ring_table_matches_closed_form(nside, dtype, cuda_device):
    """The ring table the kernels read (regrid_rings) equals the plain
    ops' closed form of every ring on the card bit for bit: ring_info's
    start, length and shift, arccos of its clamped z, 2 pi / npr and its
    reciprocal; filled once per (NSIDE, dtype, device)."""
    import math
    rc._RING_TABLES.clear()
    n0 = rc.LAUNCHES["regrid_rings"]
    got = rc._ring_fields(nside, dtype, cuda_device)
    rc._ring_fields(nside, dtype, cuda_device)
    assert rc.LAUNCHES["regrid_rings"] == n0 + 1
    zr, start, npr, shift = hpx.ring_info(
        nside, torch.arange(1, 4 * nside, device=cuda_device), dtype)
    dphi = 2.0 * math.pi / npr.to(dtype)
    want = dict(start=start, npr=npr, shift=shift, dphi=dphi,
                theta=torch.arccos(torch.clamp(zr, -1.0, 1.0)),
                inv_dphi=1 / dphi)
    for k, w in want.items():
        assert torch.equal(got[k][1:].to(w.dtype), w), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_regrid_merges_a_warps_adds(dtype, cuda_device):
    """The atomic kernel's lanes merge their rows on one destination
    before the global adds (its tally counts the adds issued): a whole
    NSIDE-64 sky in NESTED order moved a few pixels issues fewer adds
    than 4 n and no more than its nonzero rows; its map, the map of the
    same inputs permuted (less to merge) and the pile-up's (a few
    destinations for every lane) are within regrid_map_bar of the plain
    version, the mass kept."""
    for name, permute in (("n64_nested_large", False),
                          ("n64_nested_large", True), ("pileup", False)):
        nside, vx, vy, vz, m, off = _regrid_inputs(name, dtype, cuda_device)
        if permute:
            perm = torch.randperm(
                m.shape[0], generator=torch.Generator().manual_seed(0)
            ).to(cuda_device)
            vx, vy, vz, m = vx[perm], vy[perm], vz[perm], m[perm]
            off = tuple(o[perm] for o in off)
        planes, T, n = rc._planes("t", vx, vy, vz, m, off)
        tally = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        got = rc._regrid_atomic(nside, planes, T, n, tally=tally)
        _, w = rc._regrid_parts(nside, vx, vy, vz, off)
        rows, adds = int((w * m != 0).sum()), int(tally)
        assert 0 < adds <= rows, (name, adds, rows)
        if name == "n64_nested_large" and not permute:
            assert adds < 4 * n, (adds, 4 * n)
        want = rc.regrid_shell_reference(nside, vx, vy, vz, m, off)
        bar = regrid_map_bar(dtype, rc._segment_counts(nside, planes, T, n))
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= bar * scale, name
        tol = 1e-8 if dtype == torch.float64 else bar + 8 * 2.0 ** -24
        mass = float(m.double().sum())
        assert abs(float(got.double().sum()) - mass) <= tol * mass, name


@pytest.mark.cuda
def test_regrid_refuses_bad_inputs(cuda_device):
    nside, vx, vy, vz, m, off = _regrid_inputs("n16_nested_small",
                                               torch.float32, cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        rc.regrid_shell(nside, vx, vy, vz, m.double(), off)
    with pytest.raises(ValueError, match="NSIDE"):
        rc.regrid_shell(2 * rc.MAX_NSIDE, vx, vy, vz, m, off)
    with pytest.raises(ValueError, match="1-D"):
        rc.regrid_shell(nside, vx[:-1], vy, vz, m, off)
    with pytest.raises(ValueError, match="ct"):
        rc.regrid_vjp(nside, vx, vy, vz, m, off, m[:-1])


@pytest.mark.cuda
def test_regrid_in_the_shell_runners(cuda_device):
    """process() on the card launches the regrid kernel under both
    methods (the deterministic route under deterministic algorithms) and
    never the plain version; a gradient of process_device() launches
    regrid_vjp."""
    T, model, cat, shell = _small_shell()
    calls = []
    plain = rc.regrid_shell_reference
    rc.regrid_shell_reference = lambda *a: calls.append(a) or plain(*a)
    try:
        for method in ("cellmajor", "scatter"):
            r = T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                 verbose=False, device=cuda_device,
                                 method=method)
            n0 = dict(rc.LAUNCHES)
            r.process()
            assert rc.LAUNCHES["regrid"] == n0["regrid"] + 1, method
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                r.process()
            finally:
                torch.use_deterministic_algorithms(False)
            assert rc.LAUNCHES["regrid_det"] == n0["regrid_det"] + 1
        table = model._table.to(cuda_device).requires_grad_(True)
        n0 = rc.LAUNCHES["regrid_vjp"]
        r = T.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                             verbose=False, device=cuda_device,
                             precision="float64")
        torch.autograd.grad((r.process_device(table) ** 2).sum(), table)
        assert rc.LAUNCHES["regrid_vjp"] == n0 + 1
    finally:
        rc.regrid_shell_reference = plain
    assert not calls


# ----- the snapshot pass: csrc/snap_pass.cu -----

from _torch_snap_cases import CASES as SNAP_CASES  # noqa: E402
from _torch_snap_cases import port_bucket as snap_bucket  # noqa: E402
from _torch_snap_cases import port_rows as snap_rows  # noqa: E402
from _torch_snap_cases import snap_case  # noqa: E402

# bars of the kernels against the step loop on the card, of max|plain|:
# the same arithmetic a pair (the geometry bit for bit), summed in
# another order: a slot's at most K pairs (the pass), a node's shares
# from a few hundred pairs by atomic adds in no fixed order (the adjoint)
SNAP_KERNEL_BAR = {torch.float64: {"pass": 1e-13, "vjp": 1e-12},
                   torch.float32: {"pass": 1e-5, "vjp": 1e-4}}


def _snap_inputs(name, dtype, device):
    case = snap_case(name)
    bk = snap_bucket(case, device, dtype)
    rows = snap_rows(case, torch.as_tensor(case["table_z"], dtype=dtype,
                                           device=device))
    return case, bk, rows


def _snap_cts(bk, rows, seed=1):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(bk.ncell * bk.P, generator=gen,
                             dtype=torch.float64).to(rows)
                 for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(SNAP_CASES))
def test_snap_kernels_match_step_loop(name, dtype, cuda_device):
    """snap_pass and snap_vjp against the plain step loop (_bucket_pass,
    _bucket_vjp on a _SnapBucket) on the shared cases, within
    SNAP_KERNEL_BAR of max|plain|; the kernels' tallies equal to the
    loop's census; pad slots 0; two launches of the pass bit for bit; the
    adjoint 0 at the NaN row."""
    _, bk, rows = _snap_inputs(name, dtype, cuda_device)
    bars = SNAP_KERNEL_BAR[dtype]
    tally = torch.zeros(len(spc.TALLY), dtype=torch.int64,
                        device=cuda_device)
    got = spc.snap_pass(*bk.kernel_args(rows), *bk.kernel_scalars(),
                        tally=tally)
    again = bk.kernel_pass(rows)
    census = dict(pairs=0, inside=0, steps=0)
    want = tgcm._bucket_pass(bk, rows, tgcm._zero_planes(bk, rows), census)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert scale > 0 and all(bool(torch.isfinite(g).all()) for g in got)
    assert err <= bars["pass"] * scale, (err, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    pad = (torch.arange(bk.P, device=cuda_device)[None, :]
           >= bk.counts_p[:, None]).reshape(-1)
    assert bool(pad.any()) and all(float(g[pad].abs().max()) == 0
                                   for g in got)
    assert tally.tolist() == [census["pairs"], census["inside"], 0]
    assert 0 < census["inside"] < census["pairs"]

    cts = _snap_cts(bk, rows)
    vtally = torch.zeros(len(spc.TALLY), dtype=torch.int64,
                         device=cuda_device)
    d_k = spc.snap_vjp(*bk.kernel_args(rows), cts, *bk.kernel_scalars(),
                       tally=vtally)
    with torch.no_grad():
        (d_p,) = tgcm._bucket_vjp(bk, rows, cts)
    ok = torch.isfinite(rows).all(dim=1)
    assert not ok.all() and bool(torch.isfinite(d_k).all())
    assert float(d_k[~ok].abs().max()) == 0.0
    scale = float(d_p[ok].abs().max())
    err = float((d_k[ok] - d_p[ok]).abs().max())
    assert scale > 0
    assert err <= bars["vjp"] * scale, (err, scale)
    vt = vtally.tolist()
    assert vt[:2] == tally.tolist()[:2] and 0 < vt[2] <= 2 * vt[1]


@pytest.mark.cuda
def test_snap_pass_gradcheck(cuda_device):
    """torch.autograd.gradcheck of the pass in its rows on the card in
    float64 on the smallest case (the snap_pass forward, the snap_vjp
    backward; the NaN row set finite; the atomic adds' order allowed
    1e-12 between two backwards)."""
    _, bk, rows = _snap_inputs("p5", torch.float64, cuda_device)
    rows = torch.nan_to_num(rows, nan=0.5).requires_grad_(True)
    before = dict(spc.LAUNCHES)
    assert torch.autograd.gradcheck(lambda r: tgcm._pass_diff(bk, r),
                                    (rows,), nondet_tol=1e-12)
    assert spc.LAUNCHES["snap_pass"] > before["snap_pass"]
    assert spc.LAUNCHES["snap_vjp"] > before["snap_vjp"]


@pytest.mark.cuda
def test_snap_kernel_launches(cuda_device):
    """One snap_pass launch a bucket's forward and one snap_vjp launch its
    first-order backward, with no scatter_add_vjp launch for the row
    reads; under create_graph the backward is the step loop with a
    warning (its row reads through scatter_add_vjp, no snap_vjp launch)
    and its gradient the first-order one."""
    _, bk, rows = _snap_inputs("p42_rdelta_mesh", torch.float64,
                               cuda_device)
    counts = lambda: dict(spc.LAUNCHES, vjp=sc.LAUNCHES["scatter_add_vjp"])
    n0 = counts()
    with torch.no_grad():
        tgcm._pass_diff(bk, rows)
    assert counts() == dict(n0, snap_pass=n0["snap_pass"] + 1)
    r = rows.clone().requires_grad_(True)
    cts = _snap_cts(bk, rows)
    (d1,) = torch.autograd.grad(tgcm._pass_diff(bk, r), r, cts)
    assert counts() == dict(n0, snap_pass=n0["snap_pass"] + 2,
                            snap_vjp=n0["snap_vjp"] + 1)
    out = tgcm._pass_diff(bk, r)
    with pytest.warns(UserWarning, match="snapshot pass's backward"):
        (d2,) = torch.autograd.grad(out, r, cts, create_graph=True)
    d2 = d2.detach()
    now = counts()
    assert now["snap_pass"] == n0["snap_pass"] + 3
    assert now["snap_vjp"] == n0["snap_vjp"] + 1 and now["vjp"] > n0["vjp"]
    ok = torch.isfinite(rows).all(dim=1)
    scale = float(d1[ok].abs().max())
    assert float((d1[ok] - d2[ok]).abs().max()) <= 1e-12 * scale


# ----- the anisotropic paint pass: csrc/anis_pass.cu -----

from _torch_anis_cases import CASES as ANIS_CASES  # noqa: E402
from _torch_anis_cases import anis_case, overflow_buckets  # noqa: E402
from _torch_anis_cases import port_bucket as anis_bucket  # noqa: E402
from baryonification_tpu_torch.ops import anis_pass_cuda as apc  # noqa: E402

# bars of the kernels against the step loop on the card, of max|plain|
# (the grid kernels'): the same arithmetic a pixel-slot (the geometry bit
# for bit), summed in another order: a pixel's slots (the pass and the
# canvas gradient), a node's shares from many pixel-slots by atomic adds
# in no fixed order (the rows' gradient)
ANIS_KERNEL_BAR = {torch.float64: {"pass": 1e-12, "vjp": 1e-12},
                   torch.float32: {"pass": 1e-5, "vjp": 1e-4}}


def _anis_ct(bk, rows, seed=1):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(bk.ncell * bk.F, generator=gen,
                       dtype=torch.float64).to(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(ANIS_CASES) + ["b8+overflow"])
def test_anis_kernels_match_step_loop(name, dtype, cuda_device):
    """anis_pass and anis_vjp against the plain step loop (_bucket_pass,
    _bucket_vjp on an _AnisBucket) on the shared cases, within
    ANIS_KERNEL_BAR of max|plain| (the plane, the rows' gradient and the
    canvas gradient each); the kernels' tallies equal to the loop's
    census; two launches of the pass bit for bit; the rows' range nodes
    take no gradient; ``needs`` leaves out what it is asked to. A
    "+overflow" case has one halo's ln Paint at 1000: where its exp
    overflows, the kernels, as the loop, paint nothing and give no
    gradient (all finite)."""
    base, _, over = name.partition("+")
    if over:
        bk, _, rows, cv = overflow_buckets(anis_case(base), cuda_device,
                                           dtype)
    else:
        bk, rows, cv = anis_bucket(anis_case(name), cuda_device, dtype)
    bars = ANIS_KERNEL_BAR[dtype]
    head, tail = bk.kernel_args(rows, cv), bk.kernel_scalars()
    tally = torch.zeros(len(apc.TALLY), dtype=torch.int64,
                        device=cuda_device)
    got = apc.anis_pass(*head, *tail, tally=tally)
    (again,) = bk.kernel_pass(rows, extra=(cv,))
    census = dict(slots=0, inside=0, steps=0)
    (want,) = tgcm._bucket_pass(bk, rows, tgcm._zero_planes(bk, rows),
                                census, (cv,))
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert scale > 0 and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= bars["pass"] * scale
    assert torch.equal(got, again)
    assert tally.tolist() == [census["slots"], census["inside"], 0]
    assert 0 < census["inside"] < census["slots"]

    ct = _anis_ct(bk, rows)
    vtally = torch.zeros(len(apc.TALLY), dtype=torch.int64,
                         device=cuda_device)
    d_k = apc.anis_vjp(*head, ct, *tail, tally=vtally)
    with torch.no_grad():
        d_p = tgcm._bucket_vjp(bk, rows, (ct,), (cv,))
    for k, p in zip(d_k, d_p):
        scale = float(p.abs().max())
        assert scale > 0 and bool(torch.isfinite(k).all())
        assert float((k - p).abs().max()) <= bars["vjp"] * scale
    assert float(d_k[0][:, -2:].abs().max()) == 0.0
    vt = vtally.tolist()
    assert vt[:2] == tally.tolist()[:2] and 0 < vt[2] <= 2 * vt[1]
    d_r, d_c = apc.anis_vjp(*head, ct, *tail, needs=(True, False))
    assert d_c is None and float((d_r - d_k[0]).abs().max()) <= \
        bars["vjp"] * float(d_k[0].abs().max())
    d_r, d_c = apc.anis_vjp(*head, ct, *tail, needs=(False, True))
    assert d_r is None and torch.equal(d_c, d_k[1])


@pytest.mark.cuda
def test_anis_pass_gradcheck(cuda_device):
    """torch.autograd.gradcheck of the pass in its rows and its canvas on
    the card in float64 on the smallest case (the anis_pass forward, the
    anis_vjp backward; the atomic adds' order allowed 1e-12 between two
    backwards)."""
    bk, rows, cv = anis_bucket(anis_case("b4_mesh"), cuda_device,
                               torch.float64)
    before = dict(apc.LAUNCHES)
    assert torch.autograd.gradcheck(
        lambda r, v: tgcm._pass_diff(bk, r, None, (v,)),
        (rows.requires_grad_(True), cv.requires_grad_(True)),
        nondet_tol=1e-12)
    assert apc.LAUNCHES["anis_pass"] > before["anis_pass"]
    assert apc.LAUNCHES["anis_vjp"] > before["anis_vjp"]


@pytest.mark.cuda
def test_anis_kernel_launches(cuda_device):
    """One anis_pass launch a bucket's forward and one anis_vjp launch its
    first-order backward, with no scatter_add_vjp launch for the row
    reads; under create_graph the backward is the step loop with a
    warning (its row reads through scatter_add_vjp, no anis_vjp launch)
    and its gradients the first-order ones."""
    bk, rows, cv = anis_bucket(anis_case("b4_mesh"), cuda_device,
                               torch.float64)
    counts = lambda: dict(apc.LAUNCHES, vjp=sc.LAUNCHES["scatter_add_vjp"])
    n0 = counts()
    with torch.no_grad():
        tgcm._pass_diff(bk, rows, None, (cv,))
    assert counts() == dict(n0, anis_pass=n0["anis_pass"] + 1)
    r = rows.clone().requires_grad_(True)
    v = cv.clone().requires_grad_(True)
    ct = _anis_ct(bk, rows)
    d1 = torch.autograd.grad(tgcm._pass_diff(bk, r, None, (v,)), (r, v), ct)
    assert counts() == dict(n0, anis_pass=n0["anis_pass"] + 2,
                            anis_vjp=n0["anis_vjp"] + 1)
    out = tgcm._pass_diff(bk, r, None, (v,))
    with pytest.warns(UserWarning, match="anisotropic paint pass's "
                      "backward"):
        d2 = torch.autograd.grad(out, (r, v), ct, create_graph=True)
    now = counts()
    assert now["anis_pass"] == n0["anis_pass"] + 3
    assert now["anis_vjp"] == n0["anis_vjp"] + 1 and now["vjp"] > n0["vjp"]
    for a, b in zip(d1, d2):
        scale = float(a.abs().max())
        assert float((a - b.detach()).abs().max()) <= 1e-12 * scale


@pytest.mark.cuda
def test_anis_runner_launches_anis_pass(cuda_device):
    """A warm process() of PaintProfilesAnisGrid (cell-major, float64)
    launches anis_pass once a bucket and never the step loop, and the
    census that the kernel's tally fills counts the pixel-slots the
    loop's census counts on the CPU."""
    import baryonification_tpu_torch as T
    cat, gm, (paint, canvas) = _anis_inputs(T)
    kw = dict(epsilon_max=3, Painting_model=paint, Canvas_model=canvas,
              verbose=False, method="cellmajor")
    card = T.PaintProfilesAnisGrid(cat, gm, device=cuda_device,
                                   precision="float64", **kw)
    cpu = T.PaintProfilesAnisGrid(cat, gm, device="cpu", **kw)
    card.process()
    card.census, cpu.census = [], []
    n0 = apc.LAUNCHES["anis_pass"]
    loop = tgcm._bucket_pass
    try:
        tgcm._bucket_pass = None          # the step loop must not run
        card.process()
    finally:
        tgcm._bucket_pass = loop
    assert apc.LAUNCHES["anis_pass"] - n0 == len(card.census) > 0
    cpu.process()
    assert len(cpu.census) == len(card.census)
    for a, b in zip(card.census, cpu.census):
        assert (a["slots"], a["inside"]) == (b["slots"], b["inside"]) and \
            0 < a["inside"] < a["slots"]
