#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Drives the port's paths (baryonification_tpu_torch; no JAX) on the card
and fails on any fault:

  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel from csrc/, one nvcc per source,
     all started together;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes its path gives it, with both times (CUDA events) and
     the least time the card could take (the bound). The scatter takes
     unsorted rows, as the runners make them, at three inputs (a real
     chunk of the shell path, 4M clustered rows, and the 1.34e8 CIC rows
     that the grid path's auto method gives it at 256^3, in eight calls
     of one CIC corner each), with the whole call, the library call doing the same function, and the device
     launches a call; both Legendre kernels also get their issue bound; the
     cell-major pass runs in both modes at the shell path's bucket with
     the most slot-pixels, after a census of the path's buckets; the
     regrid kernels (csrc/regrid.cu) at the shell path's inputs of one
     process(): the ring table against its closed form bit for bit, the
     check entry's ids and weights against the plain ops bit for bit,
     the atomic kernel's and the deterministic route's maps against the
     plain version (the route bit for bit over two runs, its longest
     segment; the atomic kernel's global adds issued, its tally), the
     adjoint kernel against autograd of the plain version, each timed
     beside index_add_ of the same rows, with the issue bounds from the
     SASS of this build;
  4. shell path: the Schneider19 displacement table built on the card
     (bench.py's grid) and BaryonifyShell.process() on an NSIDE-1024
     full-sky shell with bench.py's 1e6-halo catalog, cold and warm with
     stages, under method "auto" (the cell-major method on the card: its
     kernel launched, no scatter) and with method="scatter" (the scatter
     kernel launched), both regridding through the regrid kernel;
     asserts mass conservation and that the map
     changed, and compares the two maps; then writes the input map to a
     FITS file, loads it through LightconeShell(path=...), holds the
     process() of the loaded shell to the in-memory run's bit for bit,
     and ud_grades the result to NSIDE 256 on the card against the CPU;
  5. grad: the differentiable shell path at the shell path's width
     (bench.py's NSIDE-1024, 1e6-halo shell and table grid): chi^2 of
     the map in ln M_c through build_table_device and process_device,
     a cold and a warm value_and_grad in float32 (the adjoint kernel
     launched, no plain version on the card, no registration in the warm
     step; seconds, peak memory), the float64 gradient against central
     differences at three steps, float32 against float64,
     process_device() against process() bit for bit (deterministic
     algorithms), the adjoint kernel against its plain version at the
     largest bucket and the second-order kernel on 2^20 pixels of the
     smallest, both precisions, with the adjoint's bound beside the
     forward's time, its census, its own counts of the slot-pixels that
     add (held to the census) and of its global atomics, and its issue
     bound from the SASS of this build (the adjoint, the forward and
     the second-order kernel timed alike, on the device: queued_ms);
  6. fit: examples 14, 16 and 18 through the port on the card (float64,
     their own sizes), every assert of theirs: Adam fits, Laplace
     covariances (the second-order kernel), sigma8 through
     cosmology_device (example 18's |corr| > 0.3, which the JAX package
     fails too, held to the JAX package's forecast); then the
     second-order kernel against its plain version at example 14's
     largest bucket;
  7. grid and grid2d paths: bench_runners.py's 3D grid (256^3, 1e5
     halos) and 2D map (2048^2, 2e5 halos) runs, Baryonification3D/2D
     tables built on the card: BaryonifyGrid cold and warm with stages
     under "auto" (the cell-major method: plain PyTorch passes, then the
     CIC redeposit, one scatter launch a corner) and with
     method="scatter"; the 2D run also paints a TabulatedProfile(Gas).
     Mass conserved, the two
     methods' maps compared, the census of each pass (voxel-slots listed
     and inside) with its operations bound, and the device launches,
     idle share and peak memory of a warm call; the 2D run also paints
     bench_runners' tsz_model(32) (a pixel-convolved ThermalSZ table),
     its float32 map held against a float64 paint on the card;
  8. tSZ path: bench_runners.py's bench_paint, the flagship painting run
     (examples/05's model at full width): the TabulatedProfile of
     ConvolvedProfile(ThermalSZ, HealPixel(1024)) built on the card, a
     full-sky NSIDE-1024 Compton-y map painted from 1e6 halos by
     PaintProfilesShell under "auto" (the cell-major kernel in paint
     mode, no scatter), its float32 map held against a float64 paint,
     and the kernel held against its plain version at every bucket's
     inputs of that run (the tSZ table's rows), float32 and float64;
     method="scatter" on the first 1e5 halos (the scatter kernel), its
     float32 map held against float64, its float64 map against the
     cell-major float64 map, and the kernel against its plain version at
     the run's largest chunk; and anafast of the y map at lmax 2048 (the
     analysis kernel);
  9. families path: grid-256 under BaryonifyGrid("auto") with the
     Arico20 (reference example 12's parameters) and Mead20
     (Params_TAGN_7p8) DMO/DMB pairs, Baryonification3D tables built on
     the card; mass conserved, eight scatter launches (the CIC) a call;
  10. snapshot path: bench_runners.py's bench_snap (L = 500 Mpc, 5e6
     uniform particles, 1e5 halos, eps_max 15, the grid phase's
     Baryonification3D table): BaryonifySnapshot under "auto" (the
     cell-major method: the snap_pass kernel, one launch a bucket) cold
     and warm with stages, every position finite and in [0, L], only
     particles within eps_max R_com of some halo moved (on a sample), the
     census of each bucket (the kernel's tally) with its operations
     bound, the device launches, idle share and peak memory of a warm
     call, the float32 offsets against a float64 run at SNAP_F32_BAR;
     snap_pass and snap_vjp against the plain step loop on the card at
     the run's largest bucket (check_snap_bucket), both dtypes, their
     tallies against the loop's census, their times, bounds, registers
     and spills; at 2e6 particles / 3e4 halos the gather method (one
     scatter launch a halo chunk) against the cell-major method in
     float64 (rtol 1e-10, atol 1e-10) and float32
     (SNAP_METHODS_F32_BAR), and the scatter kernel against its plain
     version at the gather run's largest chunk;
  11. gradgrid: grid-256 differentiated at full width (bench_runners'
     bench_grid inputs): chi^2 = sum (map(ln M_c) - map(ln M_c,true))^2
     through float64 build_table_device and float32
     BaryonifyGrid.process_device under "auto" (the cell-major passes'
     step-wise adjoint, the CIC through the scatter kernel and its
     backward kernel scatter_add_vjp): a cold and a warm value_and_grad
     with seconds, peak memory and no registration in the warm step, and
     one more with the memory that the forward keeps split by stage, the
     float64 gradient against central differences, process_device()
     against process(); the backward kernel against its plain version on
     the CIC's 1.34e8 rows (eight calls, one a corner) with its time, the
     library call's (torch.where over an indexed gather) and its bytes
     bound; the scatter and its backward on 2^31 + 2^20 rows in one call
     (three chunks) and a CIC deposit of 8 * 700^3 rows, exactly; then the
     2D baryonify, the 2D tSZ paint and the 3D Gas paint at smaller sizes,
     both methods, process_device() against process() and one backward
     each;
  12. gradsnap: snap-5e6 (bench_snap's inputs) differentiated: chi^2 on
     example 15's seven P(k) bands at 256^3 through
     BaryonifySnapshot.process_device (the snap_pass kernel forward, the
     snap_vjp kernel backward, no plain step loop on the card), cold and
     warm value_and_grad, float64 against central differences,
     process_device() against process() (float64 bit for bit);
  13. ex15: examples/15_gradient_fit_dPk.py on the card at its sizes, in
     float64, the full tier (20 Adam steps), its three asserts (the
     snapshot kernels and the scatter kernels launched);
  13b. anis: bench_runners.py's bench_anis (2048^2, 2e5 halos, the tSZ
     table painted on a DarkMatter canvas): PaintProfilesAnisGrid's remap
     (host build against build_remap_device), cold and warm process()
     with stages under "auto" (the cell-major pass: the anis_pass kernel,
     one launch a bucket, never the plain step loop on the card), the
     census (the kernel's tally) with its operations bound, launches,
     idle share and peak memory of a warm call; anis_pass and anis_vjp
     against the plain step loop on the card at the run's largest bucket
     (check_anis_bucket), both dtypes, their tallies against the loop's
     census, two launches bit for bit, their times, bounds, atomics,
     registers and spills; float32 against float64, warm value_and_grad
     in a canvas and a remap scale (the anis_vjp kernel, one launch a
     bucket a backward, no scatter_add_vjp), and the loop (method
     "scatter", a scatter launch a halo) against the cell-major pass on
     2000 halos in float64; then examples/17_anis_paint_composition.py on
     the card at its size in float64: the composed baryonify ->
     anisotropic paint chain (the anis kernels launched), the gradient
     against central differences, 25 Adam steps and the example's three
     asserts;
  14. dP(k) path: examples/10_delta_pk_snapshot.py and
     examples/12_arico_delta_pk_snapshot.py on the card: the halo-model
     suppression against the 15 scraped Schneider+19 Fig. 2 curves at the
     example's bars (0.035 a curve, 0.030 overall), and the two mock boxes
     (the S19 pair, and Arico20 with an Rdelta-sampled table at eps_max
     2): table, BaryonifySnapshot (float64, "auto"), make_map on the
     host, power_spectrum_3d on the card; measured vs predicted RMS below
     0.050 and the examples' least suppression;
  15. C_ell path: examples/09_delta_cls_shells.py at its full resolution
     (NSIDE 1024, lmax 2048): paint a DMO shell from 3000 halos, baryonify
     it for theta_ej in {2, 4, 8}, and assert the example's four shape
     checks on the anafast ratios; the cell-major and analysis kernels
     must have been launched;
  16. synthesis path: synfast then anafast at NSIDE 1024 / lmax 2048
     (recovered C_ell inside cosmic variance), and alm2map then
     map2alm(iter=3) (residual below iter=0's); the synthesis kernel must
     have been launched;
  17. reference: a small shell (both methods), anafast, alm2map and
     paint (both methods) at NSIDE 64 on the card (float64 and float32)
     against the port's CPU float64 runs, the two shell methods against
     each other on the card in float64, a small table built on the card
     against the CPU build, small 3D and 2D grids (both methods, an
     other_params axis, 2D ellipticity) and a ParamTabulatedProfile shell
     paint against the CPU; a small NSIDE-64 tSZ table and its paint
     (both methods, both precisions), and small Arico20 and Mead20
     Baryonification3D tables, on the card against the CPU;
  18. examples: the asserts of examples 01, 03, 07, 08, 11 and 13 (the
     model layer's mass closures, the pixel windows against brute-force
     Hankel quadrature on the card, the shock contract, Schneider+19
     Fig. 1 against its scraped points) at the scripts' own bars;
  19. mesh: shell-1e6 through mesh= on a 1-rank NCCL mesh (bit for bit
     as process() under deterministic algorithms, and a float32 gradient
     step), then on 2 gloo ranks spawned on the one card, each running
     shell-1e6 (and its gradient step), grid-256, a grid2d gradient step,
     snap-5e6, tsz-1024's paint and anis-2048, held against the 1-rank
     or one device's run, each rank's launches counted; a failing rank
     fails the run.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel's launches in the JSON record are those of the run
whose inputs give its time there (TIMED_RUN), and ``launches_by_path``
lists every path's. The last lines are a JSON
record of the kernels, the nvidia-smi line, and {"ok": true, "device":
{...}}.

    python3 chip_smoke.py --phases kernels,shell --root <other checkout>

drives the package of another checkout with this script and its inputs
(no ok record), so that two versions are timed alike on one card.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.modules["jax"] = None    # the port must run without JAX

import numpy as np

ROOT = Path(__file__).resolve().parent
COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96, w0=-1.0)
# bench.py's profile parameters and table grid
PAR = dict(epsilon=4.0, theta_ej=4, theta_co=0.1, M_c=1e14, mu_beta=0.1,
           gamma=2.5, delta=7, mu_theta_ej=0.1, M_theta_ej=5e13,
           M_theta_co=5e13, M_gamma=5e13, M_delta=5e13, eta=0.3,
           eta_delta=0.1, tau=-1.5, tau_delta=0, A=0.055, M1=3e11,
           epsilon_h=0.015, a=0.3, n=2.0, p=0.3, q=0.707,
           cutoff=np.inf, proj_cutoff=1000)
BENCH_GRID = dict(z_min=0.05, z_max=1.2, N_samples_z=12,
                  M_min=1e12, M_max=1e16, N_samples_Mass=24,
                  R_min=1e-3, R_max=1e2, N_samples_R=100)
SMALL_GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=4,
                  M_min=1e13, M_max=1e15, N_samples_Mass=6,
                  R_min=1e-3, R_max=70, N_samples_R=64)
EPS_MAX = 20.0
# examples/09_delta_cls_shells.py
EX09_PAR = dict(epsilon=4.0, theta_co=0.1, M_c=1e14, mu_beta=0.1,
                gamma=2.5, delta=7, eta=0.3, eta_delta=0.1, tau=-1.5,
                tau_delta=0, A=0.055, M1=3e11, epsilon_h=0.015, a=0.3,
                n=2.0, p=0.3, q=0.707, cutoff=np.inf, proj_cutoff=1000)
EX09_SWEEP = (2.0, 4.0, 8.0)
# the card's published peaks (H100 SXM data sheet, 700 W): HBM bytes/s and
# non-tensor FLOP/s by dtype
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """Fail the run (a check that ``python -O`` keeps)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def catalog(T, n_halo, nside, seed=7):
    """bench.py's synthetic lightcone: uniform sky, power-law masses in
    [1e13, 10^15.3], z in [0.1, 0.9], and a uniform(0.5, 1.5) mass map."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halo)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n_halo)))
    u = rng.uniform(0, 1, n_halo)
    M = 1e13 * (1 - u * (1 - (10 ** 15.3 / 1e13) ** (-0.8))) ** (-1 / 0.8)
    z = rng.uniform(0.1, 0.9, n_halo)
    cat = T.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z, cosmo=COSMO)
    shell = T.LightconeShell(map=rng.uniform(0.5, 1.5, 12 * nside**2),
                             cosmo=COSMO)
    return cat, shell


def model_for(T, device, grid=None):
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    model = T.Baryonification2D(T.DarkMatterOnly(**PAR),
                                T.DarkMatterBaryon(**PAR), cosmo,
                                epsilon_max=EPS_MAX)
    if grid is not None:
        model.setup_interpolator(**grid)
    return model


def cuda_ms(torch, fn, n_iter):
    """Mean milliseconds of fn() over n_iter launches, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter


def device_launches(torch, fn):
    """(count, total device ms, wall s) of the device activities (kernels
    and copies) that one fn() puts on the card, by torch.profiler, and
    the host-clock time of that same profiled fn() up to its last device
    activity; (None, None, None) if the profiler saw none in three
    tries."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
        if evs:
            return (sum(e.count for e in evs),
                    sum(getattr(e, "self_device_time_total", 0.0)
                        for e in evs) / 1e3, wall)
    return None, None, None


def clustered_rows(npix, n_rows, seed=0):
    """~n_rows unsorted destination rows with heavy duplicates: overlapping
    700-pixel windows packed on 1/32 of the sky, plus 30% out-of-range
    sentinel rows, shuffled."""
    rng = np.random.default_rng(seed)
    n_sent = int(0.3 * n_rows)
    width = 700
    n_win = (n_rows - n_sent) // width
    centres = rng.integers(0, npix // 32, n_win)
    idx = (centres[:, None] + np.arange(width)[None, :]).reshape(-1)
    idx = np.concatenate([idx, np.full(n_sent, npix)])
    rng.shuffle(idx)
    return idx.astype(np.int32)


def path_chunk_rows(T, torch, device, n_halo, nside):
    """The destination rows of one real chunk of the shell path, made as
    stage B makes them (runners/shell.py, _accumulate_shell_offsets): the
    path's catalog walked by bucket and chunk, and the middle chunk of the
    (n_rings, n_phi) bucket that launches most often. Logs the census of
    the path's chunks. Returns the int32 rows (unsorted, sentinel Npix)."""
    from baryonification_tpu_torch.ops import healpix as hpx
    cat, shell = catalog(T, n_halo, nside)
    runner = T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=None,
                              verbose=False, device=device)
    arrs = runner._halo_arrays(T.Cosmology.from_dict(COSMO, device=device))
    tables, _ = runner._ring_tables(nside, runner.dtype)
    npx = hpx.npix(nside)

    def rows(n_rings, n_phi, c):
        H = c['theta'].shape[0]
        radius = EPS_MAX * (c['R_com'] * c['a']) / c['D']
        pix, valid = hpx.disc_window_mask_tab(tables, c['theta'], c['phi'],
                                              radius, n_rings, n_phi)
        pix, valid = pix.reshape(H, -1), valid.reshape(H, -1)
        fb_pix, _ = hpx.get_interp_weights_tab(tables, c['theta'], c['phi'])
        use_fb = (valid.sum(dim=-1) < 4)[:, None]
        valid = torch.cat([valid & ~use_fb, use_fb.expand(H, 4)], dim=-1)
        pix = torch.cat([pix, fb_pix], dim=-1)
        return torch.where(valid, pix, npx).reshape(-1).to(torch.int32)

    buckets = {}
    for n_rings, n_phi, c in runner._halo_chunks(arrs, nside, ""):
        buckets.setdefault((n_rings, n_phi), []).append(c)
    n_chunks = sum(len(cs) for cs in buckets.values())
    log(f"kernels: shell path census at {n_halo} halos, NSIDE {nside}: "
        f"{n_chunks} chunks (one scatter launch each)")
    mid = {}
    for (nr, nphi), cs in sorted(buckets.items()):
        H = cs[0]['theta'].shape[0]
        mid[nr, nphi] = rows(nr, nphi, cs[len(cs) // 2])
        log(f"kernels:   window {nr} x {nphi} + 4, {H} halos a chunk: "
            f"{len(cs)} chunks of {H * (nr * nphi + 4)} rows, sentinel share "
            f"{float((mid[nr, nphi] >= npx).float().mean()):.3f} (middle "
            f"chunk)")
    nr, nphi = max(buckets, key=lambda k: len(buckets[k]))
    log(f"kernels: path-shaped input: the middle chunk of the {nr} x {nphi} "
        f"bucket ({len(buckets[nr, nphi])} of the path's {n_chunks} "
        f"launches)")
    return mid[nr, nphi]


def scatter_input_check(torch, sc, device, label, idx, npix, n_iter):
    """Kernel vs plain version on one set of unsorted rows (and on the
    same rows sorted), both dtypes; then float32 C = 3 times by CUDA
    events. Returns (max f32 error, dict of times in ms)."""
    rng = np.random.default_rng(1)
    idx_np = idx.cpu().numpy()
    n = idx_np.size
    vals = [rng.uniform(0.5, 1.5, n) for _ in range(3)]
    base = [rng.uniform(0.0, 1.0, npix) for _ in range(3)]
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    valid = idx_np[idx_np < npix]
    per_pix = np.bincount(valid, minlength=npix)
    n_touched = int((per_pix > 0).sum())
    log(f"kernels: scatter_add {label} input: Npix={npix} C=3 rows={n} "
        f"sentinel={n - valid.size} touched pixels={n_touched} max rows/"
        f"pixel={per_pix.max()} mean rows/touched pixel="
        f"{valid.size / max(n_touched, 1):.2f}")
    idx_s, order = torch.sort(idx)
    errs = {}
    for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        v = tuple(t(x, dt) for x in vals)
        acc_p = tuple(t(b, dt) for b in base)
        sc.scatter_add_accum_reference(acc_p, idx, v)
        acc_u = tuple(t(b, dt) for b in base)       # rows as the path makes
        sc.scatter_add_accum(acc_u, idx, v)
        acc_s = tuple(t(b, dt) for b in base)       # the same rows sorted
        sc.sorted_scatter_add(acc_s, idx_s, tuple(x[order] for x in v))
        torch.cuda.synchronize()
        for got_planes in (acc_u, acc_s):
            for g, p in zip(got_planes, acc_p):
                err = (g - p).abs()
                if dt == torch.float64:
                    # same rows summed in another order: rounding only
                    bad = bool((err > 1e-12 * p.abs()).any())
                    tol = "rtol 1e-12"
                else:
                    bound = 1e-5 * float(p.abs().max())
                    bad = float(err.max()) > bound
                    tol = f"atol 1e-5*max|sum| = {bound:.3e}"
                errs[name] = max(errs.get(name, 0.0), float(err.max()))
                check(not bad, f"scatter_add {label} {name} disagrees with "
                      f"the plain version: max err {float(err.max()):.3e} "
                      f"({tol})")
        log(f"kernels: scatter_add {label} {name} agrees with plain "
            f"index_add_ (unsorted and sorted rows): max|err|="
            f"{errs[name]:.3e} ({tol})")

    # times at the main path's dtype (float32)
    v32 = tuple(t(x, torch.float32) for x in vals)
    v32s = tuple(x[order] for x in v32)
    acc = tuple(t(b, torch.float32) for b in base)
    acc3 = torch.stack(acc, dim=1)

    def library():
        # one PyTorch call for the same function on the same unsorted
        # rows, its sentinel handling inside the timing: mask, compaction,
        # one index_add_ into the three planes stacked as (Npix, 3)
        ok = idx < npix
        acc3.index_add_(0, idx[ok].to(torch.int64),
                        torch.stack(v32, dim=1)[ok])

    fns = dict(call=lambda: sc.scatter_add_accum(acc, idx, v32),
               sorted=lambda: sc.sorted_scatter_add(acc, idx_s, v32s),
               plain=lambda: sc.scatter_add_accum_reference(acc, idx, v32),
               library=library)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {k: [] for k in fns}
    for k in ("plain", "library", "call", "sorted", "sorted", "call",
              "library", "plain"):
        runs[k].append(cuda_ms(torch, fns[k], n_iter))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    n_dev = {k: device_launches(torch, fns[k]) for k in ("call", "library")}
    # bytes this run's data needs: every row's int32 index read once, the
    # 3 float32 values of every row aimed at a pixel read once, every
    # touched pixel's 3 planes read and written once
    n_bytes = n * 4 + valid.size * 3 * 4 + n_touched * 3 * 4 * 2
    ms["bound"] = n_bytes / PEAK_BYTES * 1e3

    def on_device(k):
        n_launch, dev_ms, _ = n_dev[k]
        if n_launch is None:
            return "device launches not measured"
        return (f"{n_launch} device launches a call, {dev_ms:.4f} ms on the "
                f"device")

    log(f"kernels: scatter_add {label} f32 C=3: whole call on unsorted rows "
        f"(scatter_add_accum) {ms['call']:.4f} ms (runs "
        + ", ".join(f"{x:.4f}" for x in runs["call"])
        + f"; {on_device('call')}); on the same rows sorted "
        f"{ms['sorted']:.4f} ms; plain (mask + 3 index_add_) "
        f"{ms['plain']:.4f} ms; library (mask, compaction, one stacked "
        f"index_add_) {ms['library']:.4f} ms ({on_device('library')}); "
        f"bound {ms['bound']:.5f} ms ({n_bytes / 1e6:.2f} MB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    return errs["f32"], ms


def check_scatter(T, torch, sc, device, n_halo, nside):
    """The scatter kernel vs its plain version on unsorted rows, as the
    runners produce them, at three inputs: a real chunk of the shell path,
    4M clustered rows with heavy duplicates, and the CIC rows of grid-256.
    Returns the record for the kernels line (the times of the CIC rows,
    the input of the path that launches the kernel under auto)."""
    npix = 12 * nside**2
    idx_path = path_chunk_rows(T, torch, device, n_halo, nside)
    err_p, ms = scatter_input_check(torch, sc, device, "path-shaped",
                                    idx_path, npix, 200)
    idx_cl = torch.tensor(clustered_rows(npix, 4_000_000), device=device)
    err_c, _ = scatter_input_check(torch, sc, device, "clustered-4M",
                                   idx_cl, npix, 20)
    del idx_cl
    err_g = 0.0
    if hasattr(T, "BaryonifyGrid"):     # not in a checkout before the grid
        # the input of the path that launches the kernel under auto: the
        # CIC redeposit of the grid runners
        err_g, ms = check_scatter_cic(T, torch, sc, device)
    return dict(name="scatter_add", route="cuda",
                source="baryonification_tpu_torch/csrc/scatter_add.cu",
                replaces="baryonification_tpu/ops/scatter_pallas.py:117",
                max_abs_err=max(err_p, err_c, err_g), ms=ms["call"],
                plain_ms=ms["plain"], bound_ms=ms["bound"],
                bound_by="bytes", library_ms=ms["library"])


def cic_rows(T, torch, device, cell="grid"):
    """The CIC rows of a grid cell's redeposit, as its ``auto`` path
    makes them: one process() with ops.scatter's deposit recorded (its
    cell positions and the map's values, float32), then the 2^d
    (destination, value) row sets of N^d rows, one a CIC corner, that the
    deposit hands the kernel one call each."""
    from baryonification_tpu_torch.ops import scatter as tsc
    from baryonification_tpu_torch.runners import grid as tgrid
    dim, N, L, n_halo = GRID_CELLS[cell]
    cat, gm = nd_catalog(T, dim, N, L, n_halo)
    name = "cic_deposit_2d" if dim == 2 else "cic_deposit_3d"
    orig, seen = getattr(tgrid, name), []

    def record(N_, *args, dtype):
        seen.append((args[:-1], args[-1], dtype))
        return orig(N_, *args, dtype=dtype)

    setattr(tgrid, name, record)
    try:
        T.BaryonifyGrid(cat, gm, epsilon_max=GRID_EPS,
                        model=grid_model(T, torch, device, dim),
                        verbose=False, device=device).process()
    finally:
        setattr(tgrid, name, orig)
    pos, vals, dt = seen[0]
    return list(tsc._cic_corners(N, pos, vals, dt)), N ** dim


def check_scatter_cic(T, torch, sc, device):
    """The scatter kernel against its plain version on the CIC rows of
    grid-256 (one plane; float32 as the path, and float64): the deposit's
    calls, one a CIC corner, into one accumulator, with their CUDA-event
    time, the library call's (mask, compaction, one index_add_ a corner),
    the device launches and the bytes bound. Returns (max float32 error,
    dict of times in ms)."""
    corners, npix = cic_rows(T, torch, device)
    corners = [(i, v.to(torch.float32)) for i, v in corners]
    n = sum(i.shape[0] for i, _ in corners)
    per_pix = sum(torch.bincount(i.long(), minlength=npix)
                  for i, _ in corners)
    n_touched = int((per_pix > 0).sum())
    log(f"kernels: scatter_add grid-256 CIC input: Npix={npix} C=1 "
        f"{len(corners)} calls of {corners[0][0].shape[0]} rows, {n} rows "
        f"in all; touched pixels={n_touched} max rows/pixel="
        f"{int(per_pix.max())} mean rows/touched pixel={n / n_touched:.2f}")
    del per_pix
    errs = {}

    def deposit(fn, dt):
        acc = torch.zeros(npix, dtype=dt, device=device)
        for i, v in corners:
            fn((acc,), i, (v.to(dt),))
        return acc

    for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        want = deposit(sc.scatter_add_accum_reference, dt)
        got = deposit(sc.scatter_add_accum, dt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if dt == torch.float64:
            bad = bool(((got - want).abs() > 1e-12 * want.abs()).any())
            tol = "rtol 1e-12"
        else:
            bound = 1e-5 * float(want.abs().max())
            bad = err > bound
            tol = f"atol 1e-5*max|sum| = {bound:.3e}"
        errs[name] = err
        check(not bad, f"scatter_add grid-256 CIC {name} disagrees with the "
              f"plain version: max err {err:.3e} ({tol})")
        log(f"kernels: scatter_add grid-256 CIC {name} agrees with plain "
            f"index_add_: max|err|={err:.3e} ({tol})")
        del want, got
    acc = torch.zeros(npix, dtype=torch.float32, device=device)

    def library():
        for i, v in corners:
            ok = i < npix
            acc.index_add_(0, i[ok].to(torch.int64), v[ok])

    def each(fn):
        return lambda: [fn((acc,), i, (v,)) for i, v in corners]

    fns = dict(call=each(sc.scatter_add_accum),
               plain=each(sc.scatter_add_accum_reference), library=library)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {k: [] for k in fns}
    for k in ("plain", "library", "call", "call", "library", "plain"):
        runs[k].append(cuda_ms(torch, fns[k], 5))
    ms = {k: sum(r) / len(r) for k, r in runs.items()}
    n_dev = {k: device_launches(torch, fns[k]) for k in ("call", "library")}
    # the formula of the other inputs: every row's int32 index and float32
    # value read once, every touched pixel read and written once
    n_bytes = n * 4 + n * 4 + n_touched * 4 * 2
    ms["bound"] = n_bytes / PEAK_BYTES * 1e3
    on_dev = {k: ("device launches not measured" if c is None else
                  f"{c} device launches a call, {d:.4f} ms on the device")
              for k, (c, d, _) in n_dev.items()}
    log(f"kernels: scatter_add grid-256 CIC f32 C=1: the deposit's "
        f"{len(corners)} calls (scatter_add_accum) {ms['call']:.4f} ms (runs "
        + ", ".join(f"{x:.4f}" for x in runs["call"])
        + f"; {on_dev['call']}); plain (mask + index_add_) "
        f"{ms['plain']:.4f} ms; library (mask, compaction, one index_add_) "
        f"{ms['library']:.4f} ms ({on_dev['library']}); bound "
        f"{ms['bound']:.5f} ms ({n_bytes / 1e6:.2f} MB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    return errs["f32"], ms


# operations that the cell-major pass needs, from csrc/cellmajor_pass.cu
# (a sqrt, log, exp or division counted as one). The disc's conditions
# are a conjunction, so every listed (pixel, candidate) slot needs only
# the angular test (a three-term dot product and a compare); a slot that
# passes it, the rest of the disc test (separation, ln r, the radial
# tests; one more with rdelta); a slot inside the disc, the readout and,
# in offsets mode, the unit-sphere delta. The bound counts each where
# this run's data needs it.
CM_ANG_FLOPS = 6
CM_DISC_FLOPS = {"offsets": 18, "offsets_rdelta": 19, "paint": 18}
CM_READ_FLOPS = {"offsets": 56, "offsets_rdelta": 56, "paint": 12}
# the first design's count, the whole disc test (6 + 18) for every
# slot-pixel: logged beside the bound so that it compares with the
# kernel's earlier records
CM_TEST_FLOPS = 24

# The issue bound of the cell-major kernel counts the SASS instructions a
# lane issues in csrc/cellmajor_pass.cu where F is a multiple of 32, read
# at run time from the build (cuobjdump -sass of the cellmajor_kernel
# instances), on the fast path of each block (no division or sqrt slow
# path, no launch count), each block counted where it runs: the set-up of
# a pixel whose cell has candidates (the cell, the cap, the epilogue); the
# chunk step, run by every lane once for 32 candidates (the ids, the patch
# test, the ballot); a walked slot (the shuffle, the angular test, the
# loop); a slot past the angular test (the separation, division, log and
# radial tests); a slot inside its disc (the readout and, in offsets mode,
# the unit-sphere delta). An FP64 instruction holds its pipe for two
# clocks (64 lanes a clock and SM), so a float64 block costs the larger of
# twice its FP64 instructions and all its instructions; the MUFU (SFU)
# pipe issues 16 lanes a clock and SM.
CM_BLOCKS = ("pixel set-up", "chunk step", "walked slot",
             "past the angular test", "inside")
CM_INSTANCES = {"IfLb0ELb0ELb1E": ("offsets", "float32"),
                "IfLb1ELb0ELb1E": ("paint", "float32"),
                "IdLb0ELb0ELb1E": ("offsets", "float64"),
                "IdLb1ELb0ELb1E": ("paint", "float64")}
MUFU_LANES_PER_SM = 16


def sass_functions(text):
    """{function name: [(address, instruction)]} of cuobjdump -sass."""
    import re
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def cellmajor_blocks(ins):
    """(all, FP64, MUFU) instructions of each of CM_BLOCKS on its fast
    path in one cellmajor_kernel instance's SASS ``ins``. The candidate
    loop is found by its shapes: the walk loop holds the SHFL.IDX and ends
    in a backward branch; a slot closes where the angular test's exit (the
    first conditional branch after the shuffle) jumps, and what follows
    up to the backward branch runs for every walked slot; the chunk
    loop's backward branch follows it. A conditional forward branch is
    taken where it skips at most 24 instructions holding a CALL (a slow
    path) or a debug count's REDG. Returns the counts and, for each
    block, the SASS address ranges it was read from (to check against
    ``cuobjdump -sass``); raises where a block lacks the instruction that
    marks it (the ballot of the chunk step, the walk's shuffle, the MUFU
    of the sqrt and log past the angular test)."""
    import re

    def target(t):
        m = re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    idx = {a: i for i, (a, _) in enumerate(ins)}
    shfl = next(i for i, (_, t) in enumerate(ins)
                if t.startswith("SHFL.IDX"))
    back, walk_head = next((i, target(t)) for i, (_, t) in enumerate(ins)
                           if i > shfl and target(t) is not None
                           and target(t) <= ins[shfl][0])
    # the slot's close: where the angular test's exit, the first
    # conditional branch after the shuffle, jumps
    join = next(target(t) for _, t in ins[shfl + 1:back]
                if t.startswith("@") and target(t) is not None
                and target(t) > ins[shfl][0])
    cback, chunk_head = next((i, target(t)) for i, (_, t) in enumerate(ins)
                             if i > back and target(t) is not None
                             and target(t) < walk_head)

    def skips(i, g):
        return idx[g] - i <= 24 and any(
            p in ins[j][1] for j in range(i + 1, idx[g])
            for p in ("CALL", "REDG"))

    def path(i, limit, last=None, until=None):
        # from index i along the fast path, to the first instruction for
        # which last() holds (kept) or up to the index where until()
        # holds; returns ([(address, instruction)], the index after)
        out = []
        for _ in range(4000):
            if until is not None and until(i):
                return out, i
            a, t = ins[i]
            out.append((a, t))
            if last is not None and last(t):
                return out, i + 1
            g = target(t)
            if g is not None and (not t.startswith("@") or (
                    a < g < limit and skips(i, g))):
                i = idx[g]
                continue
            i += 1
        raise RuntimeError("no end to a path in the SASS")

    setup, _ = path(0, 1 << 40, until=lambda i: ins[i][0] == chunk_head)
    setup += path(cback + 1, 1 << 40,
                  last=lambda t: t.startswith("EXIT"))[0]
    chunk, _ = path(idx[chunk_head], walk_head,
                    until=lambda i: ins[i][0] == walk_head)
    chunk += ins[back + 1:cback + 1]
    walk, i = path(idx[walk_head], join, last=lambda t: target(t) == join)
    walk += path(idx[join], ins[back][0] + 16,
                 until=lambda i: i == back + 1)[0]
    radial, i = path(i, join, last=lambda t: target(t) == join)
    inside, _ = path(i, join, until=lambda i: ins[i][0] == join)
    blocks = (setup, chunk, walk, radial, inside)
    for b, name, mark in ((chunk, "chunk step", "VOTE"),
                          (walk, "walked slot", "SHFL.IDX"),
                          (radial, "past the angular test", "MUFU")):
        if not any(mark in t for _, t in b):
            raise RuntimeError(f"the {name} block holds no {mark}")

    def ranges(b):
        out = []
        for a, _ in b:
            if out and a == out[-1][1] + 16:
                out[-1][1] = a
            else:
                out.append([a, a])
        return " ".join(f"{x:#x}-{y:#x}" for x, y in out)

    return (tuple((len(b), sum(1 for _, t in b if re.match(
        r"(@\S+\s+)?D(ADD|MUL|FMA|SETP|MNMX)", t)),
                   sum(1 for _, t in b if "MUFU" in t)) for b in blocks),
            tuple(ranges(b) for b in blocks))


def library_sass(name):
    """sass_functions of this checkout's built library ``name`` (a source
    of csrc/, or the path of another shared library), by cuobjdump
    -sass."""
    import shutil
    from baryonification_tpu_torch import _cuda_build as cb
    if name.endswith(".so"):
        path = name
    else:
        lib = cb._LIBS.get(name)
        check(lib is not None, f"the {name} library is not loaded")
        path = lib._name
    tool = shutil.which("cuobjdump") or str(
        Path(cb.nvcc_path()).with_name("cuobjdump"))
    check(Path(tool).exists(), f"no cuobjdump beside nvcc ({tool})")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-300:]}")
    return sass_functions(out.stdout)


def fast_path(ins):
    """(all, FP64, MUFU) instructions that a warp issues along one
    kernel's SASS ``ins`` (sass_functions) from its entry to its EXIT on
    the fast path: an unconditional forward branch is followed; a
    conditional forward branch is taken where the code it skips, at most
    160 instructions, holds a slow path (a CALL, or local memory: the
    division's and the trigonometry's slow paths), else not; no backward
    branch is taken. So a warp's lanes are taken to run one side of each
    branch and the body of each loop once (the regrid merge's sum over a
    group's lanes, which a group of two runs once); a predicated EXIT is
    not taken."""
    import re

    def target(t):
        m = re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    idx = {a: i for i, (a, _) in enumerate(ins)}

    def slow(i, g):
        return idx[g] - i <= 160 and any(
            re.search(r"\b(CALL|STL|LDL)", t) for _, t in ins[i + 1:idx[g]])

    out, i = [], 0
    for _ in range(20000):
        a, t = ins[i]
        out.append(t)
        if re.match(r"EXIT\b", t):
            break
        g = target(t)
        if g is not None and g > a and (not t.startswith("@")
                                        or slow(i, g)):
            i = idx[g]
            continue
        i += 1
    else:
        raise RuntimeError("no EXIT on the fast path of the SASS")
    return (len(out),
            sum(1 for t in out
                if re.match(r"(@\S+\s+)?D(ADD|MUL|FMA|SETP|MNMX)", t)),
            sum(1 for t in out if "MUFU" in t))


def cellmajor_sass():
    """{(mode, dtype): CM_BLOCKS counts} of this checkout's built
    cell-major library, with each block's address ranges logged; fails
    the run if an instance of CM_INSTANCES cannot be read or parsed."""
    counts = {}
    for name, ins in library_sass("cellmajor_pass").items():
        for key, md in CM_INSTANCES.items():
            if "cellmajor_kernel" + key in name:
                try:
                    counts[md], where = cellmajor_blocks(ins)
                except (StopIteration, RuntimeError, KeyError) as e:
                    check(False, f"the SASS of cellmajor_kernel {md} has "
                                 f"not the expected loop shape ({e!r})")
                log(f"kernels: cellmajor_pass {md[0]} {md[1]} SASS address "
                    f"ranges by block ({name}): " + "; ".join(
                        f"{b}: {r}" for b, r in zip(CM_BLOCKS, where)))
    check(set(counts) == set(CM_INSTANCES.values()),
          f"cellmajor_kernel instances not found in the SASS: "
          f"{sorted(set(CM_INSTANCES.values()) - set(counts))}")
    return counts


def adjoint_sass():
    """{dtype: CM_BLOCKS counts} of the adjoint kernel's offsets instances
    (F a multiple of 32, the first-order entry) in this checkout's build,
    read by cellmajor_blocks: the adjoint walks as the forward does, and
    its slot (the forward's tests, the value and its derivative, in
    float64 the two adds) closes where the forward's does; in float32 the
    lanes' merge and their adds follow the close, and count with the
    walked slot, which every lane runs. Fails the run where an instance
    cannot be read."""
    counts = {}
    for name, ins in library_sass("cellmajor_pass").items():
        for key, dname in (("IfLb0ELb0ELb1ELi1E", "float32"),
                           ("IdLb0ELb0ELb1ELi1E", "float64")):
            if "adjoint_kernel" + key in name:
                try:
                    counts[dname], where = cellmajor_blocks(ins)
                except (StopIteration, RuntimeError, KeyError) as e:
                    check(False, f"the SASS of adjoint_kernel offsets "
                                 f"{dname} has not the expected loop shape "
                                 f"({e!r})")
                log(f"grad: cellmajor_vjp offsets {dname} SASS address "
                    f"ranges by block ({name}): " + "; ".join(
                        f"{b}: {r}" for b, r in zip(CM_BLOCKS, where)))
                log(f"grad: cellmajor_vjp offsets {dname} SASS instructions "
                    f"a lane by block (" + ", ".join(CM_BLOCKS)
                    + f"; all, FP64, MUFU): {counts[dname]}")
    check(set(counts) == {"float32", "float64"},
          f"adjoint_kernel instances not found in the SASS: {counts}")
    return counts


def slot_census(torch, cmc, c, mode):
    """Slot-pixels of the pass's inputs ``c`` by the path the kernel
    takes for them: {'slots': all, 'angular': passing the angular test,
    'inside': inside their halo's disc and radial range (the slots that
    run the readout), 'pixels': those of cells with candidates, 'chunks':
    lane runs of the kernel's chunk step (32 candidates), 'patches': all
    (patch, slot) pairs, 'culled_patches': those that the kernel's patch
    test skips (its own count, from a ``mode`` run of the kernel),
    'culled': the slot-pixels they cover}. Where the kernel does not cull
    (F not a multiple of 32, or the first design's package from another
    checkout, which has no cull and whose records hold cos_reach last)
    the cull counts are None."""
    F, counts, pix, recs = c["F"], c["counts"], c["pix"], c["recs"]
    ncell = counts.shape[0]
    dense2d = c["dense"].reshape(ncell, -1)
    new_recs = hasattr(cmc, "_cellmajor_pass_raw")
    i_cos, i_D, i_a, i_R = (3, 4, 5, 6) if new_recs else (7, 3, 4, 5)
    has_cull = new_recs and F % 32 == 0
    C = max(1, (1 << 20) // F)
    n = dict(slots=0, pixels=0, chunks=0, angular=0, inside=0)
    for c0 in range(0, ncell, C):
        c1 = min(c0 + C, ncell)
        cnt = counts[c0:c1]
        n["slots"] += int(cnt.sum()) * F
        n["pixels"] += int((cnt > 0).sum()) * F
        n["chunks"] += int(((cnt + 31) // 32).sum()) * F
        px, py, pz = (v[c0 * F:c1 * F].reshape(c1 - c0, F) for v in pix)
        for k in range(int(cnt.max())):
            live = (k < cnt)[:, None]
            rec = recs[dense2d[c0:c1, k].long()]
            h = [rec[:, j, None] for j in range(8)]
            dx, dy, dz = ((p - hv) * h[i_D] for p, hv in
                          ((px, h[0]), (py, h[1]), (pz, h[2])))
            r_com = torch.sqrt(dx * dx + dy * dy + dz * dz) / h[i_a]
            rad = torch.log(torch.clamp(r_com, min=1e-30))
            ang = (px * h[0] + py * h[1] + pz * h[2] >= h[i_cos]) & live
            ok = ((rad >= c["g0"]) & (rad <= c["rad_hi"])
                  & (r_com < h[i_R]) & ang)
            n["angular"] += int(ang.sum())
            n["inside"] += int(ok.sum())
    n["P"] = 32 if has_cull else None
    if not has_cull:
        n.update(patches=None, culled_patches=None, culled=None)
        return n
    kept = torch.zeros(1, dtype=torch.int64, device=counts.device)
    planes = tuple(torch.zeros_like(pix[0])
                   for _ in range(1 if mode == "paint" else 3))
    cmc._cellmajor_pass_raw(mode, planes, pix, c["dense"], counts, F, recs,
                            c["rows"], c["g0"], c["dg"], c["rad_hi"],
                            kept=kept)
    n["patches"] = int(counts.sum()) * (F // 32)
    n["culled_patches"] = n["patches"] - int(kept)
    n["culled"] = n["culled_patches"] * 32
    return n


def cellmajor_census(T, torch, cmc, device, model, tab, n_halo, nside):
    """The shell path's cell-major buckets, made as process() makes them
    (runner caches, float32): logs per bucket nside_c -> nside_c_eff, H,
    K, F, the slot-pixels sum(counts) * F by the kernel's path (culled by
    their patch, inside their disc) and the CUDA-event times of the parts
    of its pass[...] stage: slot_records, halo_rows (the row blend) and
    the kernel (offsets, float32; also without the patch cull). Returns
    the pass's inputs of the bucket with the most slot-pixels, for both
    modes (offsets rows from the displacement table, paint rows from
    ``tab``'s log table), with that bucket's census."""
    from baryonification_tpu_torch.runners import shell_cellmajor as tcm
    cat, shell = catalog(T, n_halo, nside)
    runner = T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                              verbose=False, device=device)
    dt = runner.dtype
    arrs = runner._halo_arrays(T.Cosmology.from_dict(COSMO, device=device))
    packed_all = runner._packed_records(arrs, dt)
    pix = runner._pixels_nested(nside, dt)
    has_cull = hasattr(cmc, "_cellmajor_pass_raw")
    gd = tuple(g.to(device, dt) for g in model._grids)
    t_off = model._table.to(device, dt)
    t_off = torch.where(torch.isfinite(t_off), t_off, 0.0)
    g2 = model._grids[2].cpu().numpy()
    g0, dg = float(gd[2][0]), float(gd[2][1] - gd[2][0])
    best, total = None, dict(slots=0, inside=0, culled=0)
    log(f"kernels: cell-major census at {n_halo} halos, NSIDE {nside} "
        f"(one launch a bucket; float32 offsets, CUDA events):")
    for bi, (nside_c, jidx, r_b, rcm_max) in enumerate(
            runner._cm_groups(arrs, nside)):
        dense, counts, K, nsc_eff = runner._dense_candidates(
            bi, nside_c, lambda jidx=jidx: {
                k: arrs[k][jidx].to(dt) for k in ('theta', 'phi', 'radius')},
            r_b)
        F = (nside // nsc_eff) ** 2
        packed = packed_all[jidx]
        n_hi = runner._node_bound(g2, np.log(EPS_MAX * rcm_max), len(g2))
        recs = tcm.slot_records(packed, EPS_MAX)
        rows = tcm.halo_rows(gd, t_off, packed, n_hi)
        c = dict(pix=pix, dense=dense, counts=counts, F=F, recs=recs,
                 rows=rows, g0=g0, dg=dg, rad_hi=float(gd[2][n_hi - 1]))
        ms_rec = cuda_ms(torch, lambda: tcm.slot_records(packed, EPS_MAX), 5)
        ms_rows = cuda_ms(torch, lambda: tcm.halo_rows(gd, t_off, packed,
                                                       n_hi), 5)
        planes = tuple(torch.zeros_like(pix[0]) for _ in range(3))
        args = (planes, pix, dense, counts, F, recs, rows, g0, dg,
                c["rad_hi"])
        cmc.cellmajor_pass("offsets", *args)
        ms_k = cuda_ms(torch, lambda: cmc.cellmajor_pass("offsets", *args), 5)
        n = slot_census(torch, cmc, c, "offsets")
        for key in total:
            total[key] += n[key] or 0
        line = (f"kernels:   bucket {bi}: nside_c {nside_c} -> {nsc_eff}, "
                f"H={jidx.shape[0]}, K={K}, F={F}, n_hi={n_hi}: "
                f"slot-pixels {n['slots']:.4e}, inside their disc "
                f"{n['inside']:.4e} ({100 * n['inside'] / n['slots']:.1f}%), "
                f"passing the angular test {n['angular']:.4e}")
        if n["P"]:
            ms_k0 = cuda_ms(torch, lambda: cmc._cellmajor_pass_raw(
                "offsets", *args, cull=False), 5)
            out = n["slots"] - n["inside"]
            line += (f"; patch of {n['P']}: "
                     f"{n['culled_patches']} of {n['patches']} "
                     f"patch-slots culled (the kernel's count), covering "
                     f"{n['culled']:.4e} slot-pixels ("
                     f"{100 * n['culled'] / n['slots']:.1f}% of all, "
                     f"{100 * n['culled'] / max(out, 1):.1f}% of those "
                     f"outside); kernel {ms_k:.4f} ms (without the cull "
                     f"{ms_k0:.4f} ms)")
        else:
            line += f"; kernel {ms_k:.4f} ms"
        log(line + f", slot_records {ms_rec:.4f} ms, halo_rows {ms_rows:.4f}"
            f" ms")
        if best is None or n["slots"] > best[0]["slots"]:
            best = (n, bi, jidx, dense, counts, F, rcm_max)
    n, bi, jidx, dense, counts, F, rcm_max = best
    log(f"kernels: cell-major path-shaped input: bucket {bi} "
        f"({n['slots']:.4e} of the path's {total['slots']:.4e} slot-pixels;"
        f" the path: {total['inside']:.4e} inside their disc"
        + (f", {total['culled']:.4e} culled by their patch" if has_cull
           else "") + ")")
    packed = packed_all[jidx]
    inputs = {}
    for mode, tabl, grids, fill in (
            ("offsets", model._table, model._grids, 0.0),
            ("paint", tab._ln2D, tab._grids, -1e30)):
        gh = grids[2].cpu().numpy()
        n_hi = runner._node_bound(gh, np.log(EPS_MAX * rcm_max), len(gh))
        gm = tuple(g.to(device, dt) for g in grids)
        t = tabl.to(device, dt)
        t = torch.where(torch.isfinite(t), t, fill)
        g2d = gm[2].cpu()
        inputs[mode] = dict(
            pix=pix, dense=dense, counts=counts, F=F,
            recs=tcm.slot_records(packed, EPS_MAX),
            rows=tcm.halo_rows(gm, t, packed, n_hi), g0=float(g2d[0]),
            dg=float(g2d[1] - g2d[0]), rad_hi=float(g2d[n_hi - 1]))
        inputs[mode]["census"] = (n if mode == "offsets" else
                                  slot_census(torch, cmc, inputs[mode],
                                              mode))
    return inputs


def check_cellmajor(T, torch, cmc, device, n_halo, nside, issue_bound):
    """The cell-major kernel against its plain version at the shell
    path's bucket with the most slot-pixels, offsets and paint, float64
    and float32, with CUDA-event times and the bound; the kernel with and
    without its patch cull must agree bit for bit. With ``issue_bound``
    also the issue bound (see CM_BLOCKS), from the SASS of this build.
    Returns the record for the kernels line (float32 offsets, the main
    path's)."""
    model = model_for(T, device, BENCH_GRID)
    tab = T.TabulatedProfile(T.DarkMatter(**dict(EX09_PAR, theta_ej=4.0)),
                             T.Cosmology.from_dict(COSMO, device=device))
    tab.setup_interpolator(z_min=0.05, z_max=1.2, N_samples_z=12,
                           M_min=1e12, M_max=1e16, N_samples_Mass=24,
                           R_min=1e-3, R_max=1e2, N_samples_R=100)
    inputs = cellmajor_census(T, torch, cmc, device, model, tab, n_halo,
                              nside)
    has_cull = hasattr(cmc, "_cellmajor_pass_raw")
    sass = cellmajor_sass() if issue_bound else None
    if issue_bound:
        log("kernels: cellmajor_pass SASS instructions a lane by block ("
            + ", ".join(CM_BLOCKS) + "; all, FP64, MUFU): " + (
                "; ".join(f"{m} {d} {c}" for (m, d), c in sass.items())))
    rec = dict(name="cellmajor_pass", route="cuda",
               source="baryonification_tpu_torch/csrc/cellmajor_pass.cu",
               replaces="baryonification_tpu/runners/shell_cellmajor.py:255",
               library_ms=None)
    for mode in ("offsets", "paint"):
        c32 = inputs[mode]
        n_out = 1 if mode == "paint" else 3
        npix, ncell = c32["pix"][0].shape[0], c32["counts"].shape[0]
        H, n_hi = c32["rows"].shape
        n_rec = c32["recs"].shape[1]
        slots = int(c32["counts"].sum())
        census = c32["census"]
        n_in = census["inside"]
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[1]
            c = {k: (tuple(p.to(dt) for p in v) if k == "pix" else
                     v.to(dt) if torch.is_tensor(v) and v.is_floating_point()
                     else v) for k, v in c32.items()}
            args = (c["pix"], c["dense"], c["counts"], c["F"], c["recs"],
                    c["rows"], c["g0"], c["dg"], c["rad_hi"])
            want = tuple(torch.zeros(npix, dtype=dt, device=device)
                         for _ in range(n_out))
            got = tuple(torch.zeros_like(w) for w in want)
            cmc.cellmajor_pass_reference(mode, want, *args)
            cmc.cellmajor_pass(mode, got, *args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            bar = (1e-12 if dt == torch.float64 else 1e-5) * scale
            log(f"kernels: cellmajor_pass {mode} {dname} vs plain: max|err| "
                f"{err:.3e} (max|out| {scale:.3e}; atol "
                f"{'1e-12' if dt == torch.float64 else '1e-5'}*max|out| = "
                f"{bar:.3e})")
            check(err <= bar and all(bool(torch.isfinite(g).all())
                                     for g in got),
                  f"cellmajor_pass {mode} {dname} disagrees with its plain "
                  f"version: max err {err:.3e}")
            k_fn = lambda: cmc.cellmajor_pass(mode, got, *args)
            p_fn = lambda: cmc.cellmajor_pass_reference(mode, want, *args)
            ms_p1 = cuda_ms(torch, p_fn, 1)
            ms_k1, ms_k2 = cuda_ms(torch, k_fn, 10), cuda_ms(torch, k_fn, 10)
            ms_p2 = cuda_ms(torch, p_fn, 1)
            ms_k, ms_p = (ms_k1 + ms_k2) / 2, (ms_p1 + ms_p2) / 2
            extra = ""
            if has_cull:
                raw = tuple(torch.zeros_like(w) for w in want)
                cmc._cellmajor_pass_raw(mode, raw, *args, cull=False)
                once = tuple(torch.zeros_like(w) for w in want)
                cmc.cellmajor_pass(mode, once, *args)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(once, raw)),
                      f"cellmajor_pass {mode} {dname}: the patch cull "
                      f"changed the result")
                ms_0 = cuda_ms(torch, lambda: cmc._cellmajor_pass_raw(
                    mode, got, *args, cull=False), 10)
                extra = (f"; without the patch cull {ms_0:.4f} ms, bit for "
                         f"bit the same result")
            t = 8 if dt == torch.float64 else 4
            flops = (slots * c["F"] * CM_ANG_FLOPS
                     + census["angular"] * CM_DISC_FLOPS[mode]
                     + n_in * CM_READ_FLOPS[mode])
            flops_pr5 = (slots * c["F"] * CM_TEST_FLOPS
                         + n_in * CM_READ_FLOPS[mode])
            n_bytes = (npix * (2 * n_out + 3) * t + ncell * 4 + slots * 4
                       + H * n_rec * t + H * n_hi * t)
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            t_pr5 = flops_pr5 / PEAK_FLOPS[dname] * 1e3
            t_bytes = n_bytes / PEAK_BYTES * 1e3
            bound, by = ((t_ops, "operations") if t_ops >= t_bytes
                         else (t_bytes, "bytes"))
            log(f"kernels: cellmajor_pass {mode} {dname}: kernel {ms_k:.4f} "
                f"ms (runs {ms_k1:.4f}, {ms_k2:.4f}){extra}, plain "
                f"{ms_p:.2f} ms (runs {ms_p1:.2f}, {ms_p2:.2f}); "
                f"{slots * c['F']:.4e} slot-pixels, {census['angular']:.4e} "
                f"passing the angular test, {n_in:.4e} inside their disc; "
                f"bound {bound:.4f} ms by {by} ({flops:.3e} flops at "
                f"{PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s, {n_bytes / 1e6:.1f} "
                f"MB at {PEAK_BYTES / 1e12:.2f} TB/s); kernel at "
                f"{100 * bound / ms_k:.1f}% of the bound; by the first "
                f"design's count ({CM_TEST_FLOPS} a slot-pixel, "
                f"{flops_pr5:.3e} flops) {t_pr5:.4f} ms, kernel at "
                f"{100 * t_pr5 / ms_k:.1f}% of it")
            if mode == "offsets" and dt == torch.float32:
                rec.update(max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                           bound_ms=bound, bound_by=by)
            if sass and census["P"]:
                cellmajor_issue_bound(torch, mode, dname, census,
                                      sass[mode, dname], k_fn, ms_k)
    return rec


# the regrid (csrc/regrid.cu): floating-point operations a pixel for its
# operations bound, counted from the kernel's source (a division, square
# root or transcendental one each): the moved vector and its norm 9, z / r
# and its clamp 3, theta, phi and the wrap 4, cos 1, z_to_ring's three
# branches and the select 21, each of the two rings 14 (its z, phi step,
# t, floor, fraction, clamped acos), the theta weight and the four
# weights 13, the four products 4; the adjoint recomputes all but the
# products and adds 54 (the weights' derivatives 15, theta and phi 6,
# acos and its clamp 8, the norm's and atan2's terms 25)
REGRID_FLOPS = 9 + 3 + 4 + 1 + 21 + 2 * 14 + 13 + 4
REGRID_VJP_FLOPS = REGRID_FLOPS - 4 + 54
# the adjoint kernel against autograd of the plain version, of the
# largest gradient (the same formula in another order; float32 rounds in
# 1 / sqrt(1 - c^2) and 1 / (x^2 + y^2) near the poles)
REGRID_VJP_BAR = {"float64": 1e-10, "float32": 1e-4}
REGRID_SOURCE = "baryonification_tpu_torch/csrc/regrid.cu"
REGRID_REPLACES = "baryonification_tpu/runners/shell.py:756"
# the ring table's fill: the closed form of ring_info (and the ring terms
# that interp_terms derives from it) a ring
REGRID_RINGS_REPLACES = "baryonification_tpu/ops/healpix.py:167"


def regrid_inputs(T, torch, device, n_halo, nside):
    """The regrid's inputs of one process() of the shell path (auto =
    cellmajor, float32: the NESTED pixel planes, the passes' offsets and
    the NESTED mass map), as runners.shell._regrid_shell receives them."""
    from baryonification_tpu_torch.runners import shell as tsh
    model = model_for(T, device, BENCH_GRID)
    cat, shell = catalog(T, n_halo, nside)
    runner = T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                              verbose=False, device=device)
    keep = []
    with spied(tsh, "_regrid_shell", keep.append):
        runner.process()
    check(len(keep) == 1, f"process() regridded {len(keep)} times")
    # the rest of a warm call's regrid stage: the NESTED mass map, cached
    # on the runner under a key that sums the host map
    n2r, _ = runner._nested_maps(nside)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner._orig_map_nested(np.asarray(shell.map, dtype=np.float64), n2r,
                            runner.dtype)
    torch.cuda.synchronize()
    log(f"kernels: regrid stage's host part in a warm process(): the "
        f"cached NESTED mass map (its key sums the host map) "
        f"{time.perf_counter() - t0:.4f} s")
    return keep[0]


def regrid_bar(dname, longest):
    """The bar of a map against the plain version's, of max|map|: the
    same positive rows summed in two orders differ by at most 2 (L - 1) u
    of the sum, L the longest segment (the most rows one destination
    takes), u the unit roundoff; float64 at least 1e-12."""
    u = 2.0 ** -24 if dname == "float32" else 2.0 ** -53
    bar = 2 * max(longest - 1, 1) * u
    return bar if dname == "float32" else max(bar, 1e-12)


def regrid_bound(n, npix, dname, vjp=False):
    """((ms, 'bytes' or 'operations'), bytes, operations) of one regrid
    (or its adjoint) of n pixels into an npix map: seven planes read once
    and the map written once (the adjoint: the cotangent map read, three
    offset planes written), the operations at the card's peak rate."""
    t = 8 if dname == "float64" else 4
    n_bytes = 7 * n * t + npix * t + (3 * n * t if vjp else 0)
    flops = n * (REGRID_VJP_FLOPS if vjp else REGRID_FLOPS)
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes")), n_bytes, flops


def regrid_sass():
    """{(kernel, dtype): fast_path counts} of the regrid kernel and its
    adjoint in this checkout's build (cuobjdump -sass); fails the run
    where one cannot be read."""
    import re
    counts = {}
    for name, ins in library_sass("regrid").items():
        m = re.search(r"\d(regrid_kernel|regrid_vjp_kernel)I([fd])E", name)
        if m:
            key = (m.group(1), {"f": "float32", "d": "float64"}[m.group(2)])
            try:
                counts[key] = fast_path(ins)
            except (RuntimeError, KeyError, IndexError) as e:
                check(False, f"the SASS of {key} has no fast path ({e!r})")
    check(len(counts) == 4, f"regrid kernels not found in the SASS: "
                            f"{sorted(counts)}")
    return counts


def lane_issue_ms(counts, n, mhz):
    """(issue ms, MUFU ms) of n lanes each issuing ``counts`` = (all,
    FP64, MUFU) SASS instructions at ``mhz``: an FP64 instruction holds
    its pipe for two clocks, the MUFU pipe takes MUFU_LANES_PER_SM lanes a
    clock and SM."""
    a, f64, mufu = counts
    lanes = N_SM * mhz * 1e6
    return (n * max(a, 2 * f64) / (lanes * LANES_PER_SM) * 1e3,
            n * mufu / (lanes * MUFU_LANES_PER_SM) * 1e3)


def regrid_issue(torch, counts, n, k_fn, ms_k, label):
    """Log the issue bound of one regrid kernel call over n pixels, each
    a lane running ``counts`` = (all, FP64, MUFU) SASS instructions (its
    fast path), at the SM clock read while k_fn runs; returns its ms."""
    a, f64, mufu = counts
    mhz = sm_clock_under(torch, k_fn, 200)
    issue_ms, mufu_ms = lane_issue_ms(counts, n, mhz)
    log(f"kernels: {label}: the fast path of its SASS (cuobjdump -sass of "
        f"this build) is {a} instructions ({f64} FP64, {mufu} MUFU) a "
        f"pixel: at the {mhz:.0f} MHz read during the run the issue bound "
        f"is {issue_ms:.4f} ms ({N_SM} SMs x {LANES_PER_SM} lanes), the "
        f"MUFU pipe's {mufu_ms:.4f} ms; kernel at "
        f"{100 * issue_ms / ms_k:.1f}% of the issue bound")
    return issue_ms


def check_ring_table(torch, rc, hpx, nside, dt, dname, device):
    """The ring table (regrid_rings) against the plain ops' closed form of
    every ring on the card (ops/healpix.py ring_info, the clamped arccos,
    2 pi / npr and its reciprocal), bit for bit; its fill's queued_ms and
    the plain ops' time, its bytes. Returns (the largest difference of an
    entry, ms, plain ms, bytes)."""
    import math
    fields = rc._ring_fields(nside, dt, device)

    def plain():
        zr, start, npr, shift = hpx.ring_info(
            nside, torch.arange(1, 4 * nside, device=device), dt)
        dphi = 2.0 * math.pi / npr.to(dt)
        return dict(start=start, npr=npr, shift=shift, dphi=dphi,
                    theta=torch.arccos(torch.clamp(zr, -1.0, 1.0)),
                    inv_dphi=1 / dphi)

    want, ms_p = timed(torch, plain)
    got = {k: fields[k][1:].to(want[k].dtype) for k in want}
    n_diff = sum(int((got[k] != want[k]).sum()) for k in want)
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    tab = rc._ring_table(nside, dt, device)
    scratch = torch.empty_like(tab)
    ms = queued_ms(torch, lambda: rc._call(
        "regrid_rings", dt, nside, scratch.data_ptr(), rc._stream(tab)), 20)
    log(f"kernels: regrid_rings {dname} (NSIDE {nside}, {tab.shape[0]} rows "
        f"of {tab.shape[1]} bytes, {tab.numel()} bytes): {n_diff} of "
        f"{len(want) * (4 * nside - 1)} entries differ from the plain ops' "
        f"closed form; fill {ms:.4f} ms, the plain ops {ms_p:.3f} ms")
    check(n_diff == 0, f"regrid_rings {dname} differs from the closed form")
    return err, ms, ms_p, tab.numel()


def check_regrid(T, torch, rc, device, n_halo, nside, issue_bound=False):
    """The regrid kernels at the shell path's inputs (captured from one
    process(), float32; the same planes cast to float64): the ring table
    against its closed form bit for bit; the check entry's ids and
    weights against the plain ops bit for bit; the atomic kernel's and
    the deterministic route's maps against the plain version (regrid_bar
    of the longest segment), the route equal to itself bit for bit, the
    mass kept, the atomic kernel's adds issued (its tally) against the
    nonzero rows; the adjoint kernel against autograd of the plain
    version (REGRID_VJP_BAR); queued_ms times beside the plain versions',
    index_add_ of the same rows (the library call; under deterministic
    algorithms for the route) and the bounds (with ``issue_bound`` the
    issue bounds from the SASS of this build); the device launches of one
    call. Returns the kernels-line records of regrid, regrid_rings,
    regrid_det and regrid_vjp (float32)."""
    hpx = T.ops.healpix
    base = regrid_inputs(T, torch, device, n_halo, nside)
    nside = base[0]
    npix = 12 * nside ** 2
    recs = {}
    sass = regrid_sass() if issue_bound else None
    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        vx, vy, vz, m = (x.to(dt) for x in base[1:5])
        off = tuple(o.to(dt) for o in base[5])
        n = m.shape[0]
        args = (nside, vx, vy, vz, m, off)
        # ids and weights
        ids, w = rc._regrid_parts(nside, vx, vy, vz, off)
        x, y, z = (v + o for v, o in zip((vx, vy, vz), off))
        r = torch.sqrt(x * x + y * y + z * z)
        theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
        phi = torch.atan2(y, x)
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        ps, ws = hpx.get_interp_weights_parts(nside, theta, phi)
        same_ids = torch.equal(ids, torch.stack(ps))
        want_w = torch.stack(ws)
        n_diff = int((w != want_w).sum())
        ib = torch.int32 if dt == torch.float32 else torch.int64
        ulps = int((w.view(ib).long() - want_w.view(ib).long()).abs().max())
        rows = int((w * m != 0).sum())
        del x, y, z, r, theta, phi, ps, ws, want_w
        log(f"kernels: regrid {dname} at the shell path's inputs ({n} "
            f"NESTED pixels, NSIDE {nside}): the check entry's ids equal "
            f"the plain ops' {same_ids}; weights differing {n_diff} of "
            f"{4 * n}, at most {ulps} ulp; {rows} nonzero rows")
        check(same_ids and n_diff == 0,
              f"regrid {dname}: ids or weights differ from the plain ops")
        err_tab, ms_tab, ms_tab_p, tab_bytes = check_ring_table(
            torch, rc, hpx, nside, dt, dname, device)
        # maps
        planes, _, _ = rc._planes("regrid", vx, vy, vz, m, off)
        counts = rc._segment_counts(nside, planes, dt, n)
        longest = int(counts.max())
        n_warp, n_global = int((counts > 16).sum()), int((counts > 256).sum())
        bar = regrid_bar(dname, longest)
        want, ms_p = timed(torch, lambda: rc.regrid_shell_reference(*args))
        got = rc.regrid_shell(*args)
        with deterministic(torch):
            det = [rc.regrid_shell(*args) for _ in range(2)]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        err_d = float((det[0] - want).abs().max())
        same = torch.equal(det[0], det[1])
        mass = float(m.double().sum())
        drift = [abs(float(o.double().sum()) - mass) / mass
                 for o in (want, got, det[0])]
        log(f"kernels: regrid {dname}: the atomic map against the plain "
            f"version max|err| / max|map| {err / scale:.3e}, the "
            f"deterministic route's {err_d / scale:.3e} (bar {bar:.3e} from "
            f"the longest segment, {longest} rows; {n_warp} segments of "
            f"more than 16 rows (a warp each), {n_global} of more than 256 "
            f"(sorted in global memory)); the route bit for bit over two "
            f"runs {same}; |sum - mass| / mass plain {drift[0]:.3e}, kernel "
            f"{drift[1]:.3e}, route {drift[2]:.3e}")
        mass_bar = 1e-8 if dname == "float64" else bar + 8 * 2.0 ** -24
        check(err <= bar * scale and err_d <= bar * scale and same
              and bool(torch.isfinite(got).all())
              and max(drift[1:]) <= mass_bar,
              f"regrid {dname}: the kernels' maps disagree")
        tally = torch.zeros(1, dtype=torch.int64, device=device)
        rc._regrid_atomic(nside, planes, dt, n, tally=tally)
        adds = int(tally)
        log(f"kernels: regrid {dname}: {adds} global adds issued for "
            f"{rows} nonzero rows ({adds / rows:.4f} of them, "
            f"{adds / n:.4f} a pixel; the warps' merge)")
        check(0 < adds <= rows, f"regrid {dname}: {adds} adds issued")
        # times: the wrapper (the map's memset and the kernel), the
        # library call on the same rows, the route, the plain version
        idx = ids.reshape(-1)
        contrib = (w * m).reshape(-1)
        del ids, w, want, got, det, planes
        lib = lambda: torch.zeros(npix, dtype=dt, device=device).index_add_(
            0, idx, contrib)
        ms_k = queued_ms(torch, lambda: rc.regrid_shell(*args), 20)
        ms_lib = queued_ms(torch, lib, 20)
        with deterministic(torch):
            ms_det = queued_ms(torch, lambda: rc.regrid_shell(*args), 10)
            ms_lib_det = queued_ms(torch, lib, 5)
        del idx, contrib
        (bound, by), n_bytes, flops = regrid_bound(n, npix, dname)
        n0 = rc.LAUNCHES["regrid"]
        rc.regrid_shell(*args)
        n_k = rc.LAUNCHES["regrid"] - n0
        n_p = device_launches(torch, lambda: rc.regrid_shell_reference(
            *args))[0]
        ms_zeros = queued_ms(torch, lambda: torch.zeros(
            npix, dtype=dt, device=device), 20)
        issue_k = None if sass is None else regrid_issue(
            torch, sass["regrid_kernel", dname], n,
            lambda: rc.regrid_shell(*args), ms_k - ms_zeros,
            f"regrid {dname} (without the map's memset)")
        log(f"kernels: regrid {dname}: kernel {ms_k:.4f} ms (with its "
            f"map's memset, alone {ms_zeros:.4f} ms), index_add_ of the "
            f"same rows {ms_lib:.4f} ms, "
            f"plain {ms_p:.3f} ms; deterministic route {ms_det:.4f} ms, "
            f"deterministic index_add_ {ms_lib_det:.4f} ms; bound "
            f"{bound:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB, {flops:.3e} "
            f"operations): kernel at {100 * bound / ms_k:.1f}%, route at "
            f"{100 * bound / ms_det:.1f}%; launches a call: the wrapper's "
            f"torch.zeros of the map and {n_k} kernel launch, the plain "
            f"version {n_p} device launches (torch.profiler)")
        # the adjoint (the path's: no map gradient)
        gen = torch.Generator(device="cpu").manual_seed(0)
        ct = torch.randn(npix, generator=gen, dtype=torch.float64).to(
            device, dt)
        leaves = [o.clone().requires_grad_() for o in off] + [
            m.clone().requires_grad_()]
        out = rc.regrid_shell_reference(nside, vx, vy, vz, leaves[3],
                                        tuple(leaves[:3]))
        # autograd of the plain chain: the regrid's share of a backward
        # before its adjoint kernel
        want_g, ms_auto = timed(torch, lambda: torch.autograd.grad(
            out, leaves, ct))
        del out, leaves
        d_o, d_m = rc.regrid_vjp(*args, ct)
        scale_g = max(float(g.abs().max()) for g in want_g)
        err_v = max(float((a - b).abs().max())
                    for a, b in zip(list(d_o) + [d_m], want_g))
        finite = all(bool(torch.isfinite(a).all()) for a in d_o)
        del d_o, d_m, want_g
        log(f"kernels: regrid_vjp {dname} against autograd of the plain "
            f"version: max|err| / max|grad| {err_v / scale_g:.3e} (bar "
            f"{REGRID_VJP_BAR[dname]:g})")
        check(finite and err_v <= REGRID_VJP_BAR[dname] * scale_g,
              f"regrid_vjp {dname} disagrees with autograd")
        ms_v = queued_ms(torch, lambda: rc.regrid_vjp(*args, ct, False), 20)
        _, ms_vp = timed(torch, lambda: rc.regrid_vjp_reference(*args, ct,
                                                                False))
        (bound_v, by_v), nb_v, fl_v = regrid_bound(n, npix, dname, vjp=True)
        issue_v = None if sass is None else regrid_issue(
            torch, sass["regrid_vjp_kernel", dname], n,
            lambda: rc.regrid_vjp(*args, ct, False), ms_v,
            f"regrid_vjp {dname}")
        log(f"kernels: regrid_vjp {dname}: kernel {ms_v:.4f} ms, plain "
            f"{ms_vp:.3f} ms, autograd of the plain forward {ms_auto:.3f} "
            f"ms; bound {bound_v:.4f} ms by {by_v} "
            f"({nb_v / 1e6:.1f} MB, {fl_v:.3e} operations): kernel at "
            f"{100 * bound_v / ms_v:.1f}%")
        if dname == "float32":
            common = dict(route="cuda", source=REGRID_SOURCE,
                          replaces=REGRID_REPLACES)
            recs["regrid"] = dict(common, name="regrid", max_abs_err=err,
                                  ms=ms_k, plain_ms=ms_p, bound_ms=bound,
                                  bound_by=by, library_ms=ms_lib,
                                  longest_segment=longest,
                                  issue_ms=issue_k)
            # the table's bytes written once; a few operations a ring
            recs["regrid_rings"] = dict(
                common, name="regrid_rings", max_abs_err=err_tab,
                replaces=REGRID_RINGS_REPLACES, ms=ms_tab,
                plain_ms=ms_tab_p, bound_ms=tab_bytes / PEAK_BYTES * 1e3,
                bound_by="bytes", library_ms=None)
            recs["regrid_det"] = dict(common, name="regrid_det",
                                      max_abs_err=err_d, ms=ms_det,
                                      plain_ms=ms_p, bound_ms=bound,
                                      bound_by=by, library_ms=ms_lib_det)
            recs["regrid_vjp"] = dict(common, name="regrid_vjp",
                                      max_abs_err=err_v, ms=ms_v,
                                      plain_ms=ms_vp, bound_ms=bound_v,
                                      bound_by=by_v, library_ms=None,
                                      issue_ms=issue_v)
    return recs


def cellmajor_issue_bound(torch, mode, dname, n, sass, k_fn, ms_k,
                          name="cellmajor_pass", label="kernels"):
    """Log the issue bound of one call of kernel ``name`` from the census
    ``n`` of its inputs and the SASS counts ``sass`` of its blocks
    (CM_BLOCKS), at the SM clock read while it runs."""
    runs = (n["pixels"], n["chunks"], n["slots"] - n["culled"],
            n["angular"], n["inside"])
    mhz = sm_clock_under(torch, k_fn, 300)
    issue = sum(r * max(a, 2 * f64) for r, (a, f64, _) in zip(runs, sass))
    mufu = sum(r * m for r, (_, _, m) in zip(runs, sass))
    issue_ms = issue / (N_SM * LANES_PER_SM * mhz * 1e6) * 1e3
    mufu_ms = mufu / (N_SM * MUFU_LANES_PER_SM * mhz * 1e6) * 1e3
    log(f"{label}: {name} {mode} {dname}: lane runs of the "
        f"kernel's blocks (pixel set-up, chunk step, walked slot, past the "
        f"angular test, inside) "
        + ", ".join(f"{r:.4e}" for r in runs) + " at "
        + ", ".join(f"{a:g}" if not f64 else f"{a:g} ({f64:g} FP64)"
                    for a, f64, _ in sass)
        + " SASS instructions (MUFU "
        + ", ".join(f"{m:g}" for _, _, m in sass)
        + f"; cuobjdump -sass of this build): at the {mhz:.0f} MHz read "
        f"during the run the issue bound is {issue_ms:.4f} ms ({N_SM} SMs "
        f"x {LANES_PER_SM} lanes), the MUFU pipe's {mufu_ms:.4f} ms "
        f"({MUFU_LANES_PER_SM} lanes a clock and SM); kernel at "
        f"{100 * issue_ms / ms_k:.1f}% of the issue bound")


def legendre_bound_ms(name, L, R, dtype):
    """Least time for one Legendre kernel call: the larger of its flops
    (8 per (m, l, ring) update, L(L+1)/2 * R updates) over the non-tensor
    peak of its dtype, and its bytes (each input read once, each output
    written once) over HBM bandwidth. Returns (ms, 'operations'|'bytes')."""
    t = 8 if dtype == "float64" else 4
    flops = 8.0 * (L * (L + 1) // 2) * R
    if name == "legendre_alm":       # 4 folds + p_mm (T), sc0 (i32), x; A
        n_bytes = 5 * L * R * t + 4 * L * R + R * t + 2 * L * L * t
    else:                            # 2 a_lm + p_mm, sc0, x; 4 folds
        n_bytes = 2 * L * L * t + L * R * t + 4 * L * R + R * t \
            + 4 * L * R * t
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes")), flops, n_bytes


# Issue slots per (m, l, ring) update of the two Legendre kernels, read from
# the SASS of this checkout's csrc/legendre_sht.cu built for sm_90a by CUDA
# 12.8 (cuobjdump -sass, the 8-rings-per-thread kernels, the loop over one
# even and one odd step of 8 rings): they hold for that source only, so a
# package of another checkout (--root) gets no issue bound. By how the
# update's slot of 32 rings runs it: (out of the scaled regime, tested for
# the rescale, tested at a step where its warp runs the rescale code). An
# FP64 instruction holds its pipe for two clocks (64 lanes a clock and SM),
# so a float64 update costs the larger of twice its FP64 instructions and
# all its instructions.
# legendre_alm: float32 111 and 246 instructions a loop; float64 112 (96 of
# them FP64) and 321 (144 FP64); the rescale code is inline, so a tested
# update costs the same at every step.
# legendre_synth: float32 103 and 142, and 112 more for the two rescale
# blocks behind their branches; float64 105 (96 FP64) and 169 (96 FP64),
# and 151 (48 FP64) more for the blocks.
SLOTS_PER_UPDATE = {
    "legendre_alm": {"float32": (111 / 16, 246 / 16, 246 / 16),
                     "float64": (2 * 96 / 16, 321 / 16, 321 / 16)},
    "legendre_synth": {"float32": (103 / 16, 142 / 16, (142 + 112) / 16),
                       "float64": (2 * 96 / 16, 2 * 96 / 16,
                                   (169 + 151) / 16)},
}
N_SM, LANES_PER_SM = 132, 128
SLOT_RPT = 8        # rings a thread at R = 2048


def chunk_rules(lc):
    """name -> (steps between two votes of a warp on its slots, steps of a
    row's first chunk after its seed) of csrc/legendre_sht.cu: the
    analysis's kTile, whose seed is row 0 of the first tile, and the
    synthesis's chunk length as the library reports it."""
    return {"legendre_alm": (32, 31),
            "legendre_synth": (lc.synth_chunk(),) * 2}


def slot_shares(torch, lc, c, rules):
    """For each kernel of ``rules`` (name -> (chunk, first chunk)), shares
    of its (m, l, ring) updates by how its kernel runs them, from the plain
    recurrence on this run's seeds. The kernels decide by chunk and by slot
    of 32 rings (slot k of warp w is rings 32 * (8 k + w) ..): at a chunk's
    start a slot is out when every ring of it and of the warp's slots
    nearer the equator (higher k) has sc == 0; the other slots are tested
    for the rescale. (The one step a row that a kernel runs as tested
    whatever the vote, the first or the last odd one, is counted with its
    chunk.) Returns {name: (out, rescale)}: the share in slots that are
    out, and the share that is tested at a step where some ring of its warp
    does rescale, so that the warp runs the rescale code (legendre_synth
    keeps it behind a branch)."""
    p_mm, sc0, x = c["p_mm"], c["sc0"], c["x"]
    L, R = p_mm.shape
    FOLD, BIG = lc._fold_big(p_mm.dtype)
    n_warp, padded = 8, 32 * 8 * SLOT_RPT
    slot = torch.arange(SLOT_RPT * n_warp, device=x.device)
    real = torch.clamp(R - 32 * slot, 0, 32).double().reshape(SLOT_RPT,
                                                              n_warp)
    p1, p2 = torch.zeros_like(p_mm), torch.zeros_like(p_mm)
    sc = torch.zeros_like(sc0)
    acc = {name: torch.zeros(2, dtype=torch.float64, device=x.device)
           for name in rules}
    # per rule: the tested rings of each (row, warp) in its current chunk
    tested = {name: torch.zeros((L, n_warp), dtype=torch.float64,
                                device=x.device) for name in rules}

    def slots(z):
        z = torch.nn.functional.pad(z, (0, padded - R))
        return z.reshape(-1, SLOT_RPT, n_warp, 32)

    # the counters of each (row, warp) summed: sc never rises, so the sum
    # falls at the steps where a ring of the warp rescales, and only there
    sc_sum = torch.zeros((L, n_warp), dtype=torch.int64, device=x.device)
    for l in range(L - 1):
        k = l + 1
        lc._recurrence_step(l, k, x, p1, p2, sc, p_mm, sc0, FOLD, BIG)
        now = slots(sc[:k]).sum(dim=(1, 3))
        event = (now[:l] != sc_sum[:l]).double()     # rows m < l
        sc_sum[:k] = now
        out = slots(sc[:k] != 0).any(dim=-1).logical_not().double() \
            .flip(1).cumprod(dim=1).flip(1)
        done = l - torch.arange(k, device=x.device)   # steps since the seed
        for name, (chunk, first) in rules.items():
            acc[name][1] += (tested[name][:l] * event).sum()
            # rows whose next chunk starts at l + 1, cut at the last l
            steps = torch.where(
                done == 0, first,
                torch.where((done >= first) & ((done - first) % chunk == 0),
                            chunk, 0)).clamp(max=L - 1 - l)
            w = steps[:, None, None] * real[None]
            acc[name][0] += (out * w).sum()
            tested[name][:k] = torch.where(
                steps[:, None] > 0, ((1 - out) * real[None]).sum(dim=1),
                tested[name][:k])
    n = (L * (L + 1) // 2) * R
    return {name: tuple(float(v) / n for v in a) for name, a in acc.items()}


def sm_clock_under(torch, fn, n_iter):
    """The SM clock (MHz) that nvidia-smi reports while n_iter launches
    of fn() run."""
    for _ in range(n_iter):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    torch.cuda.synchronize()
    return float(out.stdout.strip().splitlines()[0])


def legendre_inputs(torch, sp, device, nside, lmax):
    """float64 inputs of the two Legendre kernels: the analysis folds of a
    random map, random a_lm planes, the float64 seeds and the Bluestein
    length."""
    L = lmax + 1
    rng = np.random.default_rng(12)
    hmap = torch.tensor(rng.normal(size=12 * nside**2), device=device)
    c64 = sp._seed_consts(nside, lmax, torch.float64, device)
    M = sp._bluestein_len(nside)
    folds64 = sp._analysis_folds(hmap, nside, lmax, M, c64)
    tri = np.tril(np.ones((L, L)))
    alm64 = tuple(torch.tensor(rng.normal(size=(L, L)) * tri * mask,
                               device=device)
                  for mask in (1.0, np.arange(L)[None, :] > 0))
    return folds64, alm64, c64, M


def check_legendre(torch, lc, sp, device, issue_bound, nside=1024,
                   lmax=2048):
    """Both Legendre kernels against their plain versions at the C_ell
    path's shapes (L = lmax + 1, R = 2 * nside), float32 and float64, with
    their issue bound where ``issue_bound`` (see SLOTS_PER_UPDATE). Returns
    the two records for the kernels line."""
    L, R = lmax + 1, 2 * nside
    folds64, alm64, c64, M = legendre_inputs(torch, sp, device, nside, lmax)
    log(f"kernels: legendre inputs at NSIDE {nside}, lmax {lmax}: L={L} "
        f"R={R}, max sc0 (f32) = "
        f"{int(sp._seed_consts(nside, lmax, torch.float32, device)['sc0'].max())}")
    records, shares = {}, {}
    for name in ("legendre_alm", "legendre_synth"):
        rec = dict(name=name, route="cuda",
                   source="baryonification_tpu_torch/csrc/legendre_sht.cu",
                   replaces=("baryonification_tpu/ops/spectra.py:342"
                             if name == "legendre_alm" else
                             "baryonification_tpu/ops/spectra.py:446"),
                   library_ms=None)
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[1]
            c = sp._seed_consts(nside, lmax, dt, device)
            tail = (c["p_mm"], c["sc0"], c["x"])
            ins = tuple(f.to(dt).contiguous() for f in
                        (folds64 if name == "legendre_alm" else alm64))
            kern = getattr(lc, name)
            plain = getattr(lc, name + "_reference")
            got = kern(*ins, *tail)
            want = plain(*ins, *tail)
            torch.cuda.synchronize()
            err_raw = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            if name == "legendre_synth":
                # compared as maps, as in test_spectra.py: each set of
                # folds through one float64 ring synthesis
                got, want = ((sp._synth_from_folds(
                    *(b.double() for b in bs), nside, lmax, M, c64),)
                    for bs in (got, want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            if dt == torch.float64:
                bar = 1e-10 * scale
                tol = f"atol 1e-10*max|out| = {bar:.3e}"
                want64 = want
            else:
                # float32 sums of ~R terms with cancellation: two orders
                # of summation differ by the rounding error itself, so the
                # bar is 4x the plain version's own float32 error against
                # its float64 run on the same inputs
                own = max(float((w.double() - w64).abs().max())
                          for w, w64 in zip(want, want64))
                bar = 4 * own
                tol = (f"atol 4x the plain version's float32 error "
                       f"{own:.3e} = {bar:.3e}")
            log(f"kernels: {name} {dname} vs plain: max|err| of the "
                f"outputs {err_raw:.3e}; compared"
                f"{' as maps' if name == 'legendre_synth' else ''}: "
                f"max|err| {err:.3e} (max|out| {scale:.3e}; {tol})")
            check(err <= bar, f"{name} {dname} disagrees with its plain "
                  f"version: max err {err:.3e} ({tol})")
            # times: plain, kernel, kernel, plain (CUDA events)
            k_fn = lambda: kern(*ins, *tail)
            p_fn = lambda: plain(*ins, *tail)
            ms_p1 = cuda_ms(torch, p_fn, 1)
            ms_k1, ms_k2 = cuda_ms(torch, k_fn, 5), cuda_ms(torch, k_fn, 5)
            ms_p2 = cuda_ms(torch, p_fn, 1)
            ms_k, ms_p = (ms_k1 + ms_k2) / 2, (ms_p1 + ms_p2) / 2
            (bound, by), flops, n_bytes = legendre_bound_ms(name, L, R,
                                                            dname)
            log(f"kernels: {name} {dname}: kernel {ms_k:.4f} ms (runs "
                f"{ms_k1:.4f}, {ms_k2:.4f}), plain {ms_p:.2f} ms (runs "
                f"{ms_p1:.2f}, {ms_p2:.2f}); bound {bound:.4f} ms by {by} "
                f"({flops:.3e} flops at {PEAK_FLOPS[dname] / 1e12:.0f} "
                f"TFLOP/s, {n_bytes / 1e6:.1f} MB at "
                f"{PEAK_BYTES / 1e12:.2f} TB/s); kernel at "
                f"{100 * bound / ms_k:.1f}% of the bound")
            if dt == torch.float32:       # the card's SHT dtype
                rec.update(max_abs_err=err_raw, ms=ms_k, plain_ms=ms_p,
                           bound_ms=bound, bound_by=by)
            if not issue_bound:
                continue
            if dname not in shares:     # one recurrence for both kernels
                shares[dname] = slot_shares(torch, lc, c, chunk_rules(lc))
            out, resc = shares[dname][name]
            mhz = sm_clock_under(torch, k_fn, 300)
            s_out, s_test, s_resc = SLOTS_PER_UPDATE[name][dname]
            slots = (L * (L + 1) // 2) * R * (
                out * s_out + (1 - out - resc) * s_test + resc * s_resc)
            issue_ms = slots / (N_SM * LANES_PER_SM * mhz * 1e6) * 1e3
            log(f"kernels: {name} {dname}: {100 * out:.1f}% of the updates "
                f"run in slots out of the scaled regime ({s_out:g} issue "
                f"slots an update), {100 * resc:.1f}% tested at a step "
                f"where their warp rescales ({s_resc:g}), the others "
                f"tested ({s_test:g}); chunk rule "
                f"{chunk_rules(lc)[name]}, slots from the SASS of this "
                f"source built by CUDA 12.8; at the {mhz:.0f} MHz read "
                f"during the run the issue bound is {issue_ms:.4f} ms "
                f"({N_SM} SMs x {LANES_PER_SM} lanes); kernel at "
                f"{100 * issue_ms / ms_k:.1f}% of it")
        records[name] = rec
    return records


# kernel -> the run whose inputs give its time in the kernels line (the
# scatter: grid-256's CIC rows; the cell-major pass: the shell path's
# largest bucket; legendre_alm: the C_ell path's anafast shapes;
# legendre_synth: synth-1024's; regrid_rings: the first regrid of a
# process, which fills the ring table that its later calls read)
TIMED_RUN = {"scatter_add": "grid BaryonifyGrid (auto = cellmajor)",
             "cellmajor_pass": "shell path (auto = cellmajor)",
             "legendre_alm": "C_ell path (baryonify + anafast)",
             "legendre_synth": "synthesis path",
             "cellmajor_vjp": "grad (value_and_grad, float32)",
             "cellmajor_vjp2": "fit (examples 14, 16, 18)",
             "scatter_add_vjp": "gradgrid (value_and_grad, float32)",
             "grid_pass": "grid BaryonifyGrid (auto = cellmajor)",
             "grid_vjp": "gradgrid (value_and_grad, float32)",
             "regrid": "shell path (auto = cellmajor)",
             "regrid_rings": "mesh shell-1e6 (2 gloo ranks on one card, "
                             "rank 0)",
             "regrid_vjp": "grad (value_and_grad, float32)",
             "regrid_det": "mesh shell-1e6 (1 nccl rank)",
             "snap_pass": "snap BaryonifySnapshot (auto = cellmajor, "
                          "5000000)",
             "snap_vjp": "gradsnap (value_and_grad, float32)",
             "anis_pass": "anis (auto = cellmajor)",
             "anis_vjp": "anis (value_and_grad in a remap scale, "
                         "float32)"}
COUNTERS = []       # the LAUNCHES dicts of the kernel modules
SCATTER = []        # the name of the scatter module's forward kernel
CELLMAJOR = []      # the name of the cell-major module's forward kernel
GRID = ["grid_pass"]  # the grid pass module's forward kernel
SNAP = ["snap_pass"]  # the snapshot pass module's forward kernel
ANIS = ["anis_pass"]  # the anisotropic paint pass module's forward kernel
REGRID = ["regrid"]   # the shell regrid's kernel (stage C of a baryonify)
# the regrid's deterministic route, under use_deterministic_algorithms
REGRID_DET = ["regrid_det"]
PATH_LAUNCHES = {}  # path -> launch counts of its run (read_counts)


def reset_counts():
    for counts in COUNTERS:
        for k in counts:
            counts[k] = 0


def read_counts(path, expected):
    """All launch counts after a path; fails if a kernel of the path
    (``expected``) was launched no time."""
    launches = {k: n for counts in COUNTERS for k, n in counts.items()}
    log(f"{path}: kernel launches {launches}")
    check(path not in PATH_LAUNCHES, f"path {path!r} read twice")
    PATH_LAUNCHES[path] = launches
    for k in expected:
        check(launches[k] > 0, f"the {path} launched kernel {k} no time")
    return launches


def run_process(torch, runner, label, expected, absent=(), paint=False):
    """process() cold, then warm with its stages. Fails unless the map
    conserves mass and changed (``paint``: is finite, non-negative and
    not empty), every kernel of ``expected`` was launched in the cold run
    and none of ``absent``. Works for the shell and the grid runners.
    Returns (map, launch counts of the cold run, warm seconds)."""
    grid = hasattr(runner, "GriddedMap")
    src = runner.GriddedMap if grid else runner.LightconeShell
    cat = runner.HaloNDCatalog if grid else runner.HaloLightConeCatalog
    size = (f"N={src.Npix}^{src.map.ndim}" if grid else
            f"NSIDE={src.NSIDE}")
    reset_counts()
    t0 = time.perf_counter()
    new_map = runner.process()
    t_cold = time.perf_counter() - t0
    launches = read_counts(label, expected)
    for k in absent:
        check(launches[k] == 0, f"the {label} launched kernel {k}")
    log(f"main: {label}: process() cold {t_cold:.2f} s, {size}, "
        f"{cat.cat.size} halos, method={runner.method}, "
        f"dtype={runner.dtype}")
    check(new_map.shape == src.map.shape and np.isfinite(new_map).all(),
          "map of the wrong shape or not finite")
    new_sum, old_sum = new_map.sum(), src.map.sum()
    if paint:
        check(new_sum > 0 and new_map.min() >= 0, "the paint is empty or "
              "negative")
        log(f"main: {label}: painted sum {new_sum:.10e}, max "
            f"{new_map.max():.4e}")
    else:
        check(np.isclose(new_sum, old_sum),
              f"mass not conserved: {new_sum!r} != {old_sum!r}")
        check(not np.allclose(new_map, src.map), "the map did not change")
        log(f"main: {label}: mass conserved: sum(new)={new_sum:.10e} "
            f"sum(old)={old_sum:.10e} (np.isclose); max|change|="
            f"{np.abs(new_map - src.map).max():.4e}")

    runner.profile = True
    runner.stage_times = []
    t0 = time.perf_counter()
    warm_map = runner.process()
    t_warm = time.perf_counter() - t0
    runner.profile = False
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in runner.stage_times)
    log(f"main: {label}: process() warm {t_warm:.2f} s (stages, synced: "
        f"{stages})")
    check(np.isclose(warm_map.sum(), new_sum), "the warm run differs")
    return new_map, launches, t_warm


def main_path(T, torch, device, n_halo, nside):
    """Table build on the card, then process() cold and warm under
    ``auto`` (the cell-major method on the card) and with
    method="scatter", on one catalog. Returns the launch counts of the
    two cold runs."""
    t0 = time.perf_counter()
    model = model_for(T, device, BENCH_GRID)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    check(bool(torch.isfinite(model._table).all()), "non-finite table")
    log(f"main: displacement table {tuple(model._table.shape)} built on "
        f"{device} in float64: {t_table:.2f} s")

    cat, shell = catalog(T, n_halo, nside)
    runner = T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                              verbose=False, device=device)
    check(runner.method == "cellmajor",
          f"method 'auto' resolved to {runner.method!r} on the card")
    cm_map, cm_launches, _ = run_process(torch, runner,
                                         "shell path (auto = cellmajor)",
                                         CELLMAJOR + REGRID, SCATTER)
    runner = T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                              verbose=False, device=device, method="scatter")
    sc_map, sc_launches, _ = run_process(torch, runner,
                                         "shell path (scatter)",
                                         SCATTER + REGRID, CELLMAJOR)
    rms = np.sqrt(np.mean((cm_map - sc_map) ** 2)) / shell.map.mean()
    rel = np.abs(cm_map - sc_map).max() / np.abs(sc_map - shell.map).max()
    log(f"main: cell-major vs scatter map (float32 both): rms/mean = "
        f"{rms:.3e}, max|diff| / max|change| = {rel:.3e}")
    fits_shell(T, torch, device, model, cat, shell)
    return cm_launches, sc_launches


def fits_shell(T, torch, device, model, cat, shell):
    """The shell path from a FITS file: the input map written with
    write_healpix_fits (into the git-ignored .scratch/, removed after),
    loaded through LightconeShell(path=...) (the map read back exactly),
    and BaryonifyShell.process() (auto) from it equal to the run from the
    map in memory bit for bit, both under deterministic algorithms (the
    regrid's atomic kernel otherwise sums in no fixed order on the card;
    under them it takes its deterministic route);
    then ud_grade of that map to NSIDE 256 with power -2 (the sum kept)
    on the card against the CPU's."""
    path = ROOT / ".scratch" / "chip_smoke_shell.fits"
    path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    T.io.write_healpix_fits(path, shell.map)
    t_write = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        loaded = T.LightconeShell(path=str(path), cosmo=COSMO)
        t_read = time.perf_counter() - t0
    finally:
        path.unlink()
    check(np.array_equal(loaded.map, shell.map), "FITS: the shell map did "
          "not read back exactly")
    maps = []
    with deterministic(torch):
        for src in (shell, loaded):
            maps.append(T.BaryonifyShell(cat, src, epsilon_max=EPS_MAX,
                                         model=model, verbose=False,
                                         device=device).process())
    log(f"main: FITS shell (NSIDE {loaded.NSIDE}): written in {t_write:.2f} "
        f"s, read through LightconeShell(path=...) in {t_read:.2f} s; "
        f"process() from it equals the in-memory run bit for bit: "
        f"{np.array_equal(maps[0], maps[1])}")
    check(np.array_equal(maps[0], maps[1]), "FITS: the shell from the file "
          "baryonifies differently")
    hpx = T.ops.healpix
    m = torch.as_tensor(maps[0], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    low = hpx.ud_grade(m, 256, power=-2)
    torch.cuda.synchronize()
    t_ud = time.perf_counter() - t0
    want = hpx.ud_grade(torch.as_tensor(maps[0]), 256, power=-2).numpy()
    low = low.cpu().numpy()
    rel = float(np.abs(low - want).max() / np.abs(want).max())
    drift = abs(low.sum() - maps[0].sum()) / maps[0].sum()
    log(f"main: ud_grade to NSIDE 256 (power -2) on the card {t_ud * 1e3:.2f} "
        f"ms (the first call builds its index tables); max|card - CPU| / "
        f"max {rel:.3e} (bar 1e-14), sum kept to {drift:.3e} (bar 1e-12)")
    check(rel < 1e-14 and drift < 1e-12, "ud_grade on the card differs "
          "from the CPU's")


def reference_check(T, torch, device):
    """Small shell on the card against the port's CPU float64 run, and a
    small table built on the card against the CPU build."""
    t_model = model_for(T, device, SMALL_GRID)
    c_model = model_for(T, "cpu", SMALL_GRID)
    tab_d, tab_c = t_model._table.cpu().numpy(), c_model._table.numpy()
    rel = np.abs(tab_d - tab_c).max() / np.abs(tab_c).max()
    log(f"reference: small table on {device} vs cpu: max|diff|/max = "
        f"{rel:.3e}")
    check(rel < 1e-10, f"table on the card differs: {rel:.3e}")

    cat, shell = catalog(T, 2000, 64, seed=3)
    kw = dict(epsilon_max=EPS_MAX, model=c_model, verbose=False)
    scale = shell.map.mean()
    for method in ("scatter", "cellmajor"):
        want = T.BaryonifyShell(cat, shell, device="cpu", method=method,
                                **kw).process()
        for prec, bar in (("float64", 1e-10), ("float32", 5e-5)):
            got = T.BaryonifyShell(cat, shell, device=device, precision=prec,
                                   method=method, **kw).process()
            rms = np.sqrt(np.mean((got - want) ** 2)) / scale
            # float32 geometry and offsets: 1.1e-5 rms/mean against
            # float64 on the CPU at this size
            log(f"reference: NSIDE 64 shell ({method}) on {device} in "
                f"{prec} vs cpu float64: rms/mean = {rms:.3e} (bar {bar:g})")
            check(np.isfinite(got).all() and rms < bar,
                  f"{prec} {method} shell on the card differs: {rms:.3e}")
    # the two methods on the card in float64, to the JAX tests' bar, on
    # those tests' shell (tests/test_runners.py shell_setup and
    # test_baryonify_cellmajor_agrees: NSIDE 32, 25 halos whose discs
    # cover many pixels; the scatter method's fallback for discs of < 4
    # pixels has no cell-major counterpart, so smaller halos differ there)
    rng = np.random.default_rng(11)
    n = 25
    cat = T.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-0.8, 0.8, n))),
        M=10 ** rng.uniform(13.6, 14.8, n), z=rng.uniform(0.15, 0.45, n),
        cosmo=COSMO)
    shell = T.LightconeShell(map=rng.uniform(0.5, 1.5, 12 * 32**2),
                             cosmo=COSMO)
    cm, sc = (T.BaryonifyShell(cat, shell, device=device, precision="float64",
                               method=m, **kw).process()
              for m in ("cellmajor", "scatter"))
    change = np.abs(sc - shell.map).max()
    excess = np.abs(cm - sc) - (1e-6 * change + 1e-6 * np.abs(sc))
    log(f"reference: NSIDE 32 float64 on {device}, cellmajor vs scatter: "
        f"max|diff| = {np.abs(cm - sc).max():.3e} (bar atol 1e-6 * "
        f"max|change| = {1e-6 * change:.3e}, rtol 1e-6)")
    check(change > 0 and excess.max() <= 0,
          "cellmajor and scatter differ on the card")


# bench_runners.py's grid and grid2d runs (bench_grid, bench_grid2d): its
# table grid, eps_max 15 (5 to paint), redshift 0.25, catalog seed 3
RUNNERS_GRID = dict(z_min=0.05, z_max=1.0, N_samples_z=8, M_min=1e12,
                    M_max=1e16, N_samples_Mass=24, R_min=1e-3, R_max=1e2,
                    N_samples_R=100)
GRID_EPS, GRID_PAINT_EPS = 15.0, 5.0
# cell -> (dim, N, box L [Mpc], halos)
GRID_CELLS = {"grid": (3, 256, 500.0, 100_000),
              "grid2d": (2, 2048, 1000.0, 200_000)}
# float32 bar of the two methods' maps (and of a small grid on the card
# against the CPU's float64): rms/mean. The JAX tests hold the methods to
# atol 1e-8 max|change| + rtol 1e-8 in float64 only; float32 cell
# positions i + offset round at ~6e-8 i, and the port's float32 runs of
# the small reference grids sit at 1.1e-6 (3D) and 1.7e-6 (2D) rms/mean
# of float64 on the CPU
GRID_F32_BAR = 1e-5
# float32 bar of a grid paint, rms/mean: against a float64 paint of the
# same inputs (on the card, or the CPU's for the small reference grids),
# and the two methods' float32 paints against each other. With the halo
# positions taken as float64 offsets from their nearest bins, each
# method's float32 Gas paint at grid2d-2048 is off its float64 paint by
# 3.8e-5 (2.3e-3 of max at one pixel), the two float32 paints differ by
# 9.1e-7, and the tSZ paint is off by 2.5e-5; with float32 box
# coordinates they were 8.8e-5, 9.6e-5, 3.9e-5 and, for the tSZ paint's
# flat-topped profile, 5.7e-4 (NVIDIA H100 80GB HBM3, 700 W)
GRID_PAINT_F32_BAR = 3e-4
# operations the cell-major grid pass needs (a sqrt, log, exp or division
# counted as one), from runners/grid_cellmajor.py: every listed
# voxel-slot takes the deltas (3 a dimension: the window place less
# half, times res, less the halo's offset), the squared radius and its
# compare against (eps_max R)^2; the 2D runs also shear the deltas (6)
# for the elliptical radius (3); one that passes reads the table: the
# window test (3 a dimension), sqrt, log, t (2), the node and weight
# (3), the lerp (3) and either exp and an add (paint) or the circular
# radius, two divisions and a multiply-add a dimension (offsets)
GRID_TEST_FLOPS = {3: 3 * 3 + 5 + 1, 2: 2 * 3 + 6 + 3 + 1}
GRID_READ_FLOPS = {("offsets", 3): 9 + 1 + 1 + 2 + 3 + 3 + 2 + 6,
                   ("offsets", 2): 6 + 1 + 1 + 2 + 3 + 3 + 4 + 2 + 4,
                   ("paint", 3): 9 + 1 + 1 + 2 + 3 + 3 + 2,
                   ("paint", 2): 6 + 1 + 1 + 2 + 3 + 3 + 2}
# the adjoint's operations a slot inside beyond the pass's: 1 - w, the two
# node shares and their two adds (its cotangent dot product and divisions
# stand where the pass's push does)
GRID_VJP_FLOPS = 5
# the grid_pass kernel against the plain step loop on the same bucket,
# max|err| / max|plain|: each voxel's slots round alike (the geometry bit
# for bit: the kernel builds without FMA contraction, the loop rounds one
# operation a launch) and are summed in another
# order (the loop by steps of slots, the kernel one slot at a time), over
# at most K = 93 slots a voxel at grid2d-2048
GRID_PASS_BAR = {"float64": 1e-12, "float32": 1e-5}
# grid_vjp against the loop's VJP: both sum a node's shares with atomic
# adds in no fixed order, over up to ~1e5 voxel-slots a node (the shell
# adjoint's bars, ADJ_BAR)
GRID_VJP_BAR = {"float64": 1e-10, "float32": 1e-4}
GRID_PASS_SOURCE = "baryonification_tpu_torch/csrc/grid_pass.cu"
GRID_PASS_REPLACES = "baryonification_tpu/runners/grid_cellmajor.py:317"
_GRID_MODELS = {}


def grid_model(T, torch, device, dim, kind="displacement"):
    """bench_runners.py's Baryonification3D (3D) or 2D table built on the
    card, or (``kind="gas"``) examples/17's TabulatedProfile(Gas), or
    (``kind="dm"``) bench_anis's canvas TabulatedProfile(DarkMatter), on
    the same grid; cached, the build time logged once."""
    key = (dim, kind, str(device))
    if key not in _GRID_MODELS:
        t0 = time.perf_counter()
        cosmo = T.Cosmology.from_dict(COSMO, device=device)
        if kind in ("gas", "dm"):
            model = T.TabulatedProfile(
                (T.Gas if kind == "gas" else T.DarkMatter)(**PAR), cosmo)
            model.setup_interpolator(**RUNNERS_GRID)
        else:
            cls = T.Baryonification3D if dim == 3 else T.Baryonification2D
            model = cls(T.DarkMatterOnly(**PAR), T.DarkMatterBaryon(**PAR),
                        cosmo, epsilon_max=GRID_EPS)
            model.setup_interpolator(verbose=False, **RUNNERS_GRID)
        torch.cuda.synchronize()
        tab = model._table if kind == "displacement" else model._ln3D
        log(f"grid: {type(model).__name__} ({dim}D) table "
            f"{tuple(tab.shape)} built on {device} in float64: "
            f"{time.perf_counter() - t0:.2f} s")
        _GRID_MODELS[key] = model
    return _GRID_MODELS[key]


def nd_catalog(T, dim, N, L, n_halo, seed=3):
    """bench_runners.py's grid inputs, drawn in its order from one
    generator: uniform positions in [0, L), power-law masses in
    [1e13, 1e15] of slope -0.8, redshift 0.25; a uniform(0.5, 1.5) mass
    map on N^dim cells."""
    rng = np.random.default_rng(seed)
    pos = {c: rng.uniform(0, L, n_halo) for c in "xyz"[:dim]}
    u = rng.uniform(0, 1, n_halo)
    M = 1e13 * (1 - u * (1 - (1e15 / 1e13) ** -0.8)) ** (1 / -0.8)
    cat = T.HaloNDCatalog(M=M, redshift=0.25, cosmo=COSMO, **pos)
    gm = T.GriddedMap(map=rng.uniform(0.5, 1.5, (N,) * dim), redshift=0.25,
                      bins=(np.arange(N) + 0.5) * (L / N), cosmo=COSMO)
    return cat, gm


def census_run(torch, runner, counts=None, kernel=None):
    """One warm process() with the runner's census (it synchronises once
    a step), the peak device memory of that call and the launches it
    counts in ``counts[kernel]`` (a kernel module's LAUNCHES), then one
    under torch.profiler (no stage syncs): (census, peak GiB, kernel
    launches, device launches, busy ms, the idle share as text)."""
    runner.census = []
    torch.cuda.reset_peak_memory_stats()
    n0 = counts[kernel] if counts else 0
    runner.process()
    n_kernel = (counts[kernel] if counts else 0) - n0
    peak = torch.cuda.max_memory_allocated() / 2**30
    census, runner.census = runner.census, None
    n_launch, dev_ms, wall = device_launches(torch, runner.process)
    idle = ("not measured" if n_launch is None else
            f"{100 * max(0.0, 1 - dev_ms / (1e3 * wall)):.1f}% of that "
            f"profiled call's {wall:.3f} s")
    return census, peak, n_kernel, n_launch, dev_ms, idle


def grid_census(torch, runner, label, mode, dim, dname):
    """One more warm process() with the pass's census (it synchronises
    once a step; the kernel's own counts, one step a launch), and one
    under torch.profiler (no stage syncs) for the device's launches and
    busy time; logs per bucket the voxel-slots listed and inside, the
    pass's steps, the operations bound, the device-idle share of the
    profiled call (its busy time over its own wall time, which holds the
    profiler's host cost too), and the peak device memory of a warm
    call. The census call must launch the grid_pass kernel once a
    bucket. Returns (voxel-slots, inside, operations bound ms)."""
    from baryonification_tpu_torch.ops import grid_pass_cuda as gp
    census, peak, n, n_launch, dev_ms, idle = census_run(
        torch, runner, gp.LAUNCHES, "grid_pass")
    log(f"grid: {label}: a warm process() launches grid_pass {n} "
        f"times for its {len(census)} buckets")
    check(n == len(census), f"{label}: {n} grid_pass launches for "
          f"{len(census)} buckets")
    slots = sum(c["slots"] for c in census)
    inside = sum(c["inside"] for c in census)
    flops = (slots * GRID_TEST_FLOPS[dim]
             + inside * GRID_READ_FLOPS[mode, dim])
    bound = flops / PEAK_FLOPS[dname] * 1e3
    for c in census:
        log(f"grid: {label} census bucket {c['bucket']}: H={c['H']}, "
            f"B={c['B']}->{c['B_eff']}, K={c['K']}, F={c['F']}, "
            f"n_hi={c['n_hi']}: voxel-slots {c['slots']:.4e}, inside "
            f"{c['inside']:.4e} ({100 * c['inside'] / max(c['slots'], 1):.1f}"
            f"%), {c['steps']} steps")
    log(f"grid: {label}: the pass lists {slots:.4e} voxel-slots, "
        f"{inside:.4e} inside; operations bound {bound:.4f} ms "
        f"({flops:.3e} flops at {PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s); "
        f"one warm process() puts {n_launch} device launches on the card, "
        f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms busy; "
        f"device idle {idle}; peak device memory {peak:.2f} GiB")
    return slots, inside, bound


def compare_maps(label, a, b, base):
    """Log and check rms/mean of two baryonified maps of one run in
    float32."""
    rms = np.sqrt(np.mean((a - b) ** 2)) / base.mean()
    log(f"grid: {label}: rms/mean {rms:.3e}, max|diff|/max|change| "
        f"{np.abs(a - b).max() / np.abs(b - base).max():.3e} (bar rms/mean "
        f"{GRID_F32_BAR:g})")
    check(rms < GRID_F32_BAR, f"{label} differ: rms/mean {rms:.3e}")


def check_bucket_kernels(torch, label, mod, bk, rows, extra, launch, vjp,
                         bars, bounds, desc, seed=0):
    """The two kernels of module ``mod`` (its pass and its adjoint, named
    by its LAUNCHES, counting its TALLY) on a cell-major bucket ``bk``
    against the plain step loop (_bucket_pass, _bucket_vjp, on the card)
    at ``rows`` and the ``extra`` inputs, with seeded random cotangents:
    ``launch(tally)`` gives the pass kernel's planes, ``vjp(cts, tally)``
    the adjoint's gradients (one an input). Every output finite; the
    planes within ``bars[0]`` and each gradient within ``bars[1]`` (by
    dtype name) of max|plain| (over the plain gradient's finite values);
    two launches of the pass bit for bit; both tallies' listed and inside
    counts equal to the loop's census, the pass without atomic adds and
    the adjoint with at most two an inside slot. ``bounds(tally, vjp)``
    gives a launch's (operations ms, bytes ms). Logs ``desc`` (the
    bucket), the census, and for each kernel its tally, errors, device
    time (queued_ms) beside the loop's (CUDA events) and bounds (build_all
    logs the kernels' registers and spills). Returns ({"pass_", "vjp"}:
    dict(max_abs_err, ms, plain_ms, bound_ms, bound_by, ops_ms, bytes_ms,
    tally)) and (the planes, the cotangents, the gradients)."""
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    dname = str(rows.dtype).split(".")[1]
    names, keys = tuple(mod.LAUNCHES), mod.TALLY[:2]
    tallies = [torch.zeros(len(mod.TALLY), dtype=torch.int64,
                           device=rows.device) for _ in range(2)]
    got = launch(tallies[0])
    same = all(torch.equal(a, b) for a, b in zip(got, launch(None)))
    census = {keys[0]: 0, keys[1]: 0, "steps": 0}
    plain = lambda census=None: tgcm._bucket_pass(
        bk, rows, tgcm._zero_planes(bk, rows), census, extra)
    errs = [rel_err(tuple(got), tuple(plain(census)))]
    _, ms_p = timed(torch, plain)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cts = tuple(torch.randn(g.shape, generator=gen, dtype=torch.float64)
                .to(g) for g in got)
    d_k = vjp(cts, tallies[1])
    with torch.no_grad():
        d_p, ms_vp = timed(torch, lambda: tgcm._bucket_vjp(
            bk, rows, cts, extra))
    fin = [torch.isfinite(d) for d in d_p]
    verrs = [rel_err(k[f], p[f]) for k, p, f in zip(d_k, d_p, fin)]
    del d_p
    kt, vt = (t.tolist() for t in tallies)
    text, out = [], {}
    for part, name, e, ms_plain, fn, t, bar in (
            ("pass_", names[0], errs, ms_p, lambda: launch(None), kt,
             bars[0][dname]),
            ("vjp", names[1], verrs, ms_vp, lambda: vjp(cts, None), vt,
             bars[1][dname])):
        ms = queued_ms(torch, fn, 5)
        o_ms, y_ms = bounds(kt, part == "vjp")
        b_ms, b_by = max((o_ms, "operations"), (y_ms, "bytes"))
        out[part] = dict(max_abs_err=max(r * s for r, s in e), ms=ms,
                         plain_ms=ms_plain, bound_ms=b_ms, bound_by=b_by,
                         ops_ms=o_ms, bytes_ms=y_ms, tally=t)
        text.append(
            f"{name} tally {t[0]:.4e} / {t[1]:.4e}, {t[2]:.4e} global "
            f"atomics, max|err| / max|plain| "
            + ", ".join(f"{r:.3e} (max|plain| {s:.3e})" for r, s in e)
            + f" (bar {bar:g}), kernel {ms:.4f} ms, plain {ms_plain:.2f} ms,"
            f" bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}%; "
            f"operations {o_ms:.4f}, bytes {y_ms:.4f})")
        check(max(r for r, _ in e) <= bar, f"{label}: {name} {dname} "
              f"disagrees with its plain version: {e}")
    log(f"{label}: largest bucket ({desc}), {dname}: census "
        f"{census[keys[0]]:.4e} {keys[0]}, {census[keys[1]]:.4e} inside "
        f"({census['steps']} steps); two {names[0]} launches bit for bit: "
        f"{same}; {sum(int((~f).sum()) for f in fin)} non-finite plain "
        f"gradients; " + "; ".join(text))
    check(all(bool(torch.isfinite(g).all()) for g in got + tuple(d_k)),
          f"{label}: {names[0]}, {names[1]} {dname}: non-finite output")
    check(same, f"{label}: two {names[0]} launches {dname} differ")
    check(kt[:2] == [census[keys[0]], census[keys[1]]] and kt[2] == 0
          and vt[:2] == kt[:2] and 0 < vt[2] <= 2 * vt[1],
          f"{label}: the kernels' tallies {kt}, {vt} are not the census "
          f"{census}")
    return out, (got, cts, d_k)


def largest_bucket(calls):
    """The positional arguments of the grid_pass_diff call (of
    ``calls``) whose bucket lists the most voxel-slots."""
    return max(calls, key=lambda a: int(a[7].sum()) * a[2] ** a[1])


def grid_kernel_bounds(c, mode, dim, dname, vjp):
    """(operations ms, bytes ms) of one grid kernel launch on a bucket
    whose counts are ``c`` (slots, inside, and its sizes): the tests of
    every listed voxel-slot and the readout of each inside
    (GRID_TEST_FLOPS, GRID_READ_FLOPS; rdelta one more, the adjoint
    GRID_VJP_FLOPS more); bytes: each input read once (the candidate ids a
    slot lists, the counts, the per-halo columns, the rows; the adjoint's
    cotangent planes), each output written once (the planes; the
    adjoint's rows)."""
    t = 8 if dname == "float64" else 4
    read = (GRID_READ_FLOPS["paint" if mode == "paint" else "offsets", dim]
            + (mode == "offsets_rdelta") + (GRID_VJP_FLOPS if vjp else 0))
    flops = c["slots"] * GRID_TEST_FLOPS[dim] + c["inside"] * read
    planes = c["nvox"] * c["planes"] * t
    n_bytes = (c["listed"] * 8 + c["ncell"] * 8 + c["H"] * c["hcols"] * t
               + c["H"] * dim * 8 + c["H"] * c["n_hi"] * t * (1 + vjp)
               + planes)
    return flops / PEAK_FLOPS[dname] * 1e3, n_bytes / PEAK_BYTES * 1e3


def check_grid_bucket(torch, label, args, mode, dt, seed=0):
    """grid_pass and grid_vjp against the plain step loop on one bucket of
    a run (check_bucket_kernels, within GRID_PASS_BAR / GRID_VJP_BAR):
    ``args`` the runner's grid_pass_diff arguments, its geometry read in
    ``mode`` and its rows and records cast to ``dt``. Then both kernels
    without their cull (cull=False): the planes bit for bit those of the
    cull's launch, the tallies' slots and inside the same, grid_vjp within
    GRID_VJP_BAR of the cull's. Logs and returns check_bucket_kernels'
    results, with the kernels' device times without the cull (queued_ms),
    the share of (patch, slot) pairs culled (the kernel's own count over
    the listed pairs, a patch being the voxels of a block that one warp
    holds), the adjoint's atomic adds without the cull and the launch's
    shape (gp.launch_shape)."""
    from baryonification_tpu_torch.ops import grid_pass_cuda as gp
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    (_, dim, B, n_hi, N, half, dense, counts, counts_host, pk, rows, g0, dg,
     rad_hi, eps, res) = args
    dname = str(dt).split(".")[1]
    bk = tgcm._GridBucket(mode, dim, B, n_hi, N, half, dense, counts,
                          counts_host, pk.to(dt), g0, dg, rad_hi, eps, res)
    rows = rows.detach().to(dt).contiguous()
    head, tail = bk.kernel_args(rows), bk.kernel_scalars()
    sizes = dict(nvox=bk.ncell * bk.F, planes=bk.n_planes,
                 listed=int(counts.sum()), ncell=bk.ncell, H=rows.shape[0],
                 hcols=bk.hrec.shape[1], n_hi=n_hi)
    out, (got, cts, d_k) = check_bucket_kernels(
        torch, label, gp, bk, rows, (),
        lambda t: gp.grid_pass(*head, *tail, tally=t),
        lambda c, t: (gp.grid_vjp(*head, c, *tail, tally=t),),
        (GRID_PASS_BAR, GRID_VJP_BAR),
        lambda kt, v: grid_kernel_bounds(
            dict(sizes, slots=kt[0], inside=kt[1]), mode, dim, dname, v),
        f"H={rows.shape[0]}, B={B}, F={bk.F}, K={bk.K}, n_hi={n_hi}; "
        f"{mode}", seed)
    kt, vt = out["pass_"]["tally"], out["vjp"]["tally"]
    # without the cull: the same planes and counts
    n_tally = len(gp.TALLY)
    ntally = torch.zeros(n_tally, dtype=torch.int64, device=rows.device)
    got_nc = gp.grid_pass(*head, *tail, tally=ntally, cull=False)
    same = all(torch.equal(a, b) for a, b in zip(got, got_nc))
    nvtally = torch.zeros(n_tally, dtype=torch.int64, device=rows.device)
    d_nc = gp.grid_vjp(*head, cts, *tail, tally=nvtally, cull=False)
    ok_rows = torch.isfinite(rows).all(dim=1)
    ncerr, _ = rel_err(d_k[0][ok_rows], d_nc[ok_rows])
    ms_knc = queued_ms(
        torch, lambda: gp.grid_pass(*head, *tail, cull=False), 5)
    ms_vknc = queued_ms(
        torch, lambda: gp.grid_vjp(*head, cts, *tail, cull=False), 5)
    nkt, nvt = ntally.tolist(), nvtally.tolist()
    pairs = sizes["listed"] * -(-bk.F // 32)
    log(f"{label}: {mode} {dname} cull: {kt[3]:.4e} of {pairs:.4e} "
        f"(patch, slot) pairs culled ({100 * kt[3] / max(pairs, 1):.1f}%); "
        f"without it grid_pass {ms_knc:.4f} ms, planes bit for bit: {same}, "
        f"tally {nkt}; grid_vjp {ms_vknc:.4f} ms, {nvt[2]:.4e} global "
        f"atomics, max|diff| / max|d_rows| {ncerr:.3e} against the cull's;"
        f" launch shape {gp.launch_shape(mode, dim, B, dt)}")
    check(same and nkt[:2] == kt[:2] and nvt[:2] == kt[:2]
          and nkt[3] == nvt[3] == 0 and vt[3] == kt[3] <= pairs,
          f"{label}: {mode} {dname}: the cull changed the planes "
          f"(bit for bit {same}) or the tallies {kt}, {vt} against "
          f"{nkt}, {nvt} without it")
    check(ncerr <= GRID_VJP_BAR[dname], f"{label}: grid_vjp {mode} {dname} "
          f"with and without the cull differ: {ncerr:.3e}")
    out["pass_"].update(ms_no_cull=ms_knc, culled=kt[3], pairs=pairs)
    out["vjp"].update(ms_no_cull=ms_vknc, atomics_no_cull=nvt[2])
    return out


def grid_kernel_checks(torch, label, calls, real_modes):
    """check_grid_bucket on the largest bucket of ``calls`` (a run's
    grid_pass_diff arguments, by mode) in every mode (those of
    ``real_modes`` on their own run's rows and records, the others on the
    geometry of the first) and both dtypes. Returns {(mode, dtype name):
    result}."""
    out = {}
    for mode in ("offsets", "offsets_rdelta", "paint"):
        src = mode if mode in real_modes else real_modes[0]
        args = largest_bucket(calls[src])
        for dt in (torch.float32, torch.float64):
            out[mode, str(dt).split(".")[1]] = check_grid_bucket(
                torch, f"{label} ({mode} on the {src} run's bucket)", args,
                mode, dt)
            torch.cuda.empty_cache()
    return out


def kernel_record(name, source, replaces, res):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                library_ms=None, **{k: res[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})


def device_equals_process(torch, label, runner, paint):
    """process_device() against process() on the card: the paint bit for
    bit; BaryonifyGrid's offsets planes (what the passes give the CIC)
    bit for bit, the map itself to the atomic adds' order (the CIC's
    scatter sums in no fixed order)."""
    if paint:
        got = runner.process_device().to(torch.float64).cpu().numpy()
        same = np.array_equal(got, runner.process())
    else:
        seen = []
        cic = runner._cic_offsets
        runner._cic_offsets = lambda gm, off, *a: (
            seen.append(tuple(o.clone() for o in off)), cic(gm, off, *a))[1]
        try:
            runner.process_device()
            runner.process()
        finally:
            del runner._cic_offsets
        same = all(torch.equal(a, b) for a, b in zip(*seen))
    log(f"grid: {label}: process_device() against process() on the card: "
        f"{'the map' if paint else 'the offsets planes'} bit for bit: "
        f"{same}")
    check(same, f"{label}: process_device() differs from process()")


def grid_path(T, torch, device, cell):
    """One of bench_runners.py's grid runs on the card: BaryonifyGrid cold
    and warm with stages under ``auto`` (the cell-major method: the
    scatter kernel launched once a CIC corner, for the redeposit; the
    cell-major shell kernel never) and with method="scatter" (the kernel
    launched once a chunk and for the CIC), the two maps compared; grid2d also
    paints a TabulatedProfile(Gas) both ways, and once more both ways in
    float64, against which each float32 paint is held. Where the package
    has the grid pass kernels, the auto runs launch grid_pass and never
    the plain step loop on a _GridBucket, process_device() equals
    process() bit for bit (the paint; BaryonifyGrid's offsets), and
    grid_pass and grid_vjp are held against the step loop on the largest
    bucket of the run (check_grid_bucket), in every mode and both dtypes.
    Returns (the launch counts of every cold run, by run; those checks'
    results by (mode, dtype))."""
    from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
    from baryonification_tpu_torch.ops import scatter_cuda as sc
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    dim, N, L, n_halo = GRID_CELLS[cell]
    model = grid_model(T, torch, device, dim)
    cat, gm = nd_catalog(T, dim, N, L, n_halo)
    out, calls = {}, {}
    dname = "float32"
    runs = [("BaryonifyGrid", model, GRID_EPS, "offsets")]
    if dim == 2:
        runs.append(("PaintProfilesGrid",
                     grid_model(T, torch, device, dim, "gas"),
                     GRID_PAINT_EPS, "paint"))
    for name, mdl, eps, mode in runs:
        paint = mode == "paint"
        mk = lambda **kw: getattr(T, name)(cat, gm, epsilon_max=eps,
                                           model=mdl, verbose=False,
                                           device=device, **kw)
        runner = mk()
        check(runner.method == "cellmajor",
              f"method 'auto' resolved to {runner.method!r} on the card")
        label = f"{cell} {name} (auto = cellmajor)"
        keep = lambda a: calls.setdefault(a[0], []).append(a)
        with spied(tgcm, "grid_pass_diff", keep), \
                plain_on_card(cmc, sc) as plain:
            cm_map, out[label], _ = run_process(
                torch, runner, label, GRID + ([] if paint else SCATTER),
                CELLMAJOR + (SCATTER if paint else []) + ["grid_vjp"],
                paint=paint)
        check(not plain, f"{label}: plain versions ran on the card: {plain}")
        if not paint:
            check(out[label]["scatter_add"] == 2 ** dim,
                  f"{label}: the CIC redeposit is one scatter launch a "
                  f"corner ({2 ** dim}), got {out[label]['scatter_add']}")
            gap = abs(cm_map.sum() - gm.map.sum()) / gm.map.sum()
            log(f"grid: {label}: mass conserved to {gap:.3e} (bar 1e-8)")
            check(gap < 1e-8, f"{label}: mass off by {gap:.3e}")
        grid_census(torch, runner, label, mode, dim, dname)
        device_equals_process(torch, label, runner, paint)
        label_s = f"{cell} {name} (scatter)"
        sc_map, out[label_s], _ = run_process(
            torch, mk(method="scatter"), label_s, SCATTER, CELLMAJOR,
            paint=paint)
        if paint:
            check_paint_f32(cell, name, mk, cm_map, sc_map)
        else:
            compare_maps(f"{cell} {name} cell-major vs scatter (float32 "
                         f"both)", cm_map, sc_map, gm.map)
    if dim == 2:
        out.update(grid_tsz_paint(T, torch, device, cell, cat, gm))
    checks = grid_kernel_checks(torch, f"grid: {cell}", calls, list(calls))
    return out, checks


def grid_tsz_paint(T, torch, device, cell, cat, gm):
    """bench_runners.py's grid2d paint: PaintProfilesGrid with
    tsz_model(32) under ``auto`` (the cell-major method, no kernel
    launched), cold and warm with stages, its float32 map held against a
    float64 paint of the same inputs on the card at GRID_PAINT_F32_BAR.
    Returns the launch counts of the cold run."""
    tab = tsz_model(T, torch, device, 32)
    mk = lambda **kw: T.PaintProfilesGrid(cat, gm, epsilon_max=GRID_PAINT_EPS,
                                          model=tab, verbose=False,
                                          device=device, **kw)
    runner = mk()
    check(runner.method == "cellmajor",
          f"method 'auto' resolved to {runner.method!r} on the card")
    label = f"{cell} PaintProfilesGrid tSZ (auto = cellmajor)"
    y, launches, _ = run_process(torch, runner, label, GRID,
                                 CELLMAJOR + SCATTER, paint=True)
    t0 = time.perf_counter()
    y64 = mk(precision="float64").process()
    rms, rel = map_diff(y, y64)
    log(f"grid: {cell} PaintProfilesGrid tSZ float64 (cell-major) "
        f"{time.perf_counter() - t0:.2f} s; float32 vs float64: rms/mean "
        f"{rms:.3e}, max|diff|/max {rel:.3e} (bar rms/mean "
        f"{GRID_PAINT_F32_BAR:g}); {int((y > 0).sum())} of {y.size} pixels "
        f"painted")
    check(rms < GRID_PAINT_F32_BAR, f"{cell} PaintProfilesGrid tSZ float32 "
          f"vs float64: rms/mean {rms:.3e}")
    return {label: launches}


def check_paint_f32(cell, name, mk, cm_map, sc_map):
    """The float32 paint of both methods held against the same paint in
    float64 on the card (each method against its own float64 run), the
    two float64 paints against each other at the JAX tests' bar (rtol
    1e-8, atol 1e-10 max), and the two float32 paints against each other.
    Every reading is logged before any is checked."""
    f64 = {}
    for method in ("cellmajor", "scatter"):
        t0 = time.perf_counter()
        f64[method] = mk(method=method, precision="float64").process()
        log(f"grid: {cell} {name} ({method}, float64) process() "
            f"{time.perf_counter() - t0:.2f} s, painted sum "
            f"{f64[method].sum():.10e}")
    pairs = (("cell-major float32 vs float64", cm_map, f64["cellmajor"]),
             ("scatter float32 vs float64", sc_map, f64["scatter"]),
             ("cell-major vs scatter (float32 both)", cm_map, sc_map))
    rms = {}
    for what, a, b in pairs:
        rms[what] = np.sqrt(np.mean((a - b) ** 2)) / b.mean()
        log(f"grid: {cell} {name} {what}: rms/mean {rms[what]:.3e}, "
            f"max|diff|/max {np.abs(a - b).max() / np.abs(b).max():.3e} "
            f"(bar rms/mean {GRID_PAINT_F32_BAR:g})")
    cm64, sc64 = f64["cellmajor"], f64["scatter"]
    excess = np.abs(cm64 - sc64) - (1e-10 * sc64.max() + 1e-8 * np.abs(sc64))
    log(f"grid: {cell} {name} cell-major vs scatter (float64 both): "
        f"max|diff|/max {np.abs(cm64 - sc64).max() / sc64.max():.3e}, rms/"
        f"mean {np.sqrt(np.mean((cm64 - sc64) ** 2)) / sc64.mean():.3e} "
        f"(bar atol 1e-10 max, rtol 1e-8)")
    check(sc64.sum() > 0 and excess.max() <= 0,
          f"{cell} {name}: the float64 paints of the two methods differ")
    for what, r in rms.items():
        check(r < GRID_PAINT_F32_BAR, f"{cell} {name} {what}: rms/mean "
              f"{r:.3e}")


def reference_grid(T, torch, device):
    """Small grids on the card in float64 and float32 against the port's
    CPU float64 runs, both methods: 3D (N = 32) and 2D with ellipticity
    (N = 64), a table with an other_params axis (catalog column
    theta_ej); and a ParamTabulatedProfile paint on an NSIDE-64 shell.
    On the same small grids PaintProfilesGrid paints that
    ParamTabulatedProfile(Gas) (both methods, the same catalog column).
    float64 to rms/mean < 1e-10 (the shell paint: max|diff|/max), float32
    to GRID_F32_BAR (the grid paint: GRID_PAINT_F32_BAR; the shell paint:
    1e-3 of max, as the shell's reference paint)."""
    cosmo = T.Cosmology.from_dict(COSMO, device="cpu")
    theta = {'theta_ej': np.array([2.0, 4.0, 8.0])}
    ptab = T.ParamTabulatedProfile(T.Gas(**PAR), cosmo)
    ptab.setup_interpolator(other_params=theta, **SMALL_GRID)
    rng = np.random.default_rng(8)
    for dim, N, L, n in ((3, 32, 80.0, 40), (2, 64, 90.0, 40)):
        cls = T.Baryonification3D if dim == 3 else T.Baryonification2D
        model = cls(T.DarkMatterOnly(**PAR), T.DarkMatterBaryon(**PAR),
                    cosmo, epsilon_max=GRID_EPS)
        model.setup_interpolator(verbose=False, other_params=theta,
                                 **SMALL_GRID)
        kw = {c: rng.uniform(0, L, n) for c in "xyz"[:dim]}
        kw['theta_ej'] = rng.uniform(2.5, 7.5, n)
        ell = dim == 2
        if ell:
            kw.update(q_ell=rng.uniform(0.4, 0.9, n),
                      A_ell=rng.normal(size=(n, 2)))
        cat = T.HaloNDCatalog(M=10 ** rng.uniform(13.3, 14.8, n),
                              redshift=0.25, cosmo=COSMO, **kw)
        gm = T.GriddedMap(map=rng.uniform(0.5, 1.5, (N,) * dim),
                          redshift=0.25, bins=(np.arange(N) + 0.5) * (L / N),
                          cosmo=COSMO)
        args = dict(epsilon_max=GRID_EPS, model=model, use_ellipticity=ell,
                    verbose=False)
        for method in ("scatter", "cellmajor"):
            want = T.BaryonifyGrid(cat, gm, device="cpu", method=method,
                                   **args).process()
            for prec, bar in (("float64", 1e-10), ("float32", GRID_F32_BAR)):
                got = T.BaryonifyGrid(cat, gm, device=device, method=method,
                                      precision=prec, **args).process()
                rms = np.sqrt(np.mean((got - want) ** 2)) / gm.map.mean()
                log(f"reference: {dim}D grid N={N} ({method}, theta_ej "
                    f"axis{', ellipticity' if ell else ''}) on {device} in "
                    f"{prec} vs cpu float64: rms/mean = {rms:.3e} (bar "
                    f"{bar:g})")
                check(np.isfinite(got).all() and rms < bar,
                      f"{prec} {method} {dim}D grid on the card differs: "
                      f"{rms:.3e}")
        args.update(epsilon_max=GRID_PAINT_EPS, model=ptab)
        bad = []
        for method in ("scatter", "cellmajor"):
            want = T.PaintProfilesGrid(cat, gm, device="cpu", method=method,
                                       **args).process()
            check(want.sum() > 0, f"the {dim}D grid paint is empty")
            for prec, bar in (("float64", 1e-10),
                              ("float32", GRID_PAINT_F32_BAR)):
                got = T.PaintProfilesGrid(cat, gm, device=device,
                                          method=method, precision=prec,
                                          **args).process()
                rms = np.sqrt(np.mean((got - want) ** 2)) / want.mean()
                log(f"reference: {dim}D grid N={N} ParamTabulatedProfile "
                    f"paint ({method}{', ellipticity' if ell else ''}) on "
                    f"{device} in {prec} vs cpu float64: rms/mean = "
                    f"{rms:.3e}, max|diff|/max = "
                    f"{np.abs(got - want).max() / want.max():.3e} (bar "
                    f"rms/mean {bar:g})")
                if not (np.isfinite(got).all() and rms < bar):
                    bad.append(f"{prec} {method} {dim}D grid paint on the "
                               f"card differs: {rms:.3e}")
        # every reading logged before any is checked
        check(not bad, "; ".join(bad))

    nside, n = 64, 400
    cat = T.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.2, 14.8, n), z=rng.uniform(0.1, 0.55, n),
        theta_ej=rng.uniform(2.5, 7.5, n), cosmo=COSMO)
    floor = T.LightconeShell(map=np.zeros(12 * nside**2), cosmo=COSMO)
    kw = dict(epsilon_max=5, model=ptab, verbose=False)
    for method in ("scatter", "cellmajor"):
        want = T.PaintProfilesShell(cat, floor, device="cpu", method=method,
                                    **kw).process()
        check(want.sum() > 0, "the ParamTabulatedProfile paint is empty")
        for prec, bar in (("float64", 1e-10), ("float32", 1e-3)):
            got = T.PaintProfilesShell(cat, floor, device=device,
                                       precision=prec, method=method,
                                       **kw).process()
            err = np.abs(got - want).max() / np.abs(want).max()
            log(f"reference: NSIDE {nside} ParamTabulatedProfile paint "
                f"({method}) on {device} in {prec} vs cpu float64: "
                f"max|diff|/max = {err:.3e} (bar {bar:g})")
            check(np.isfinite(got).all() and err < bar,
                  f"{prec} {method} ParamTabulatedProfile paint on the card "
                  f"differs: {err:.3e}")


# bench_runners.py's bench_paint: its tsz_model (examples/05's
# pixel-convolved ThermalSZ, bench_runners' PAR, on RUNNERS_GRID),
# eps_max 5, catalog seed 3; the scatter method on the first 1e5 halos
# (at 1e6 it is host-bound at 13-25 s, as the shell path's)
TSZ_SCATTER_HALOS = 100_000
# float32 bars of the tSZ y map against a float64 paint of the same inputs
# on the card, rms/mean. The float32 angular test cos(sep) >= cos(r_disc)
# of both paint methods resolves 1 - cos ~ 1e-6 to ~6e-8, so pixels in a
# band of a few % of the disc radius are painted in one precision only;
# they carry nearly all of the difference. The first bar, 5e-3, came
# from the CPU's prediction of 1.8e-3 at NSIDE 1024 / 1e6 halos with
# GRID_F32_BAR's 2.7x margin; the card read 5.249e-4 (cell-major, 1e6
# halos) and 4.223e-3 (scatter, the first 1e5 halos: fewer halos, so the
# edge pixels weigh more against the mean; the cell-major method reads
# 1.780e-3 on those halos), and each bar is now 2.7x its reading (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6)
TSZ_F32_BAR = 1.4e-3
TSZ_SCATTER_F32_BAR = 1.1e-2
# reference example 12's Arico20 parameters (tests/test_arico.py:12-17)
APAR = dict(alpha_g=2, epsilon_h=0.015, M1_0=2.2e11 / 0.7, alpha_sat=1,
            M_c=1.2e14 / 0.7, eta=0.6, mu=0.31, beta=0.6,
            epsilon_hydro=np.sqrt(5), M_inn=3.3e13 / 0.7, M_r=1e30,
            beta_r=2, theta_inn=0.1, theta_out=1, theta_rg=0.3,
            sigma_rg=0.1, a=0.3, n=2, p=0.3, q=0.707, A_nt=0.495,
            alpha_nt=0.1, mean_molecular_weight=0.59)
_TSZ_MODELS = {}


def tsz_model(T, torch, device, nside, grid=RUNNERS_GRID):
    """bench_runners.py's tsz_model(nside): TabulatedProfile of
    ConvolvedProfile(ThermalSZ(**PAR), HealPixel(nside)), built on
    ``device`` in float64; cached, the build time logged once."""
    key = (nside, str(device), tuple(sorted(grid.items())))
    if key not in _TSZ_MODELS:
        t0 = time.perf_counter()
        cosmo = T.Cosmology.from_dict(COSMO, device=device)
        tab = T.TabulatedProfile(T.ConvolvedProfile(
            T.ThermalSZ(**PAR), T.HealPixel(NSIDE=nside)), cosmo)
        tab.setup_interpolator(**grid)
        if tab._ln2D.is_cuda:
            torch.cuda.synchronize()
        fin = torch.isfinite(tab._ln2D)
        log(f"tsz: TabulatedProfile(ConvolvedProfile(ThermalSZ, HealPixel("
            f"{nside}))) table {tuple(tab._ln2D.shape)} built on {device} "
            f"in float64: {time.perf_counter() - t0:.2f} s; projected "
            f"table finite at {int(fin.sum())} of {fin.numel()} nodes, 3D "
            f"table finite at {int(torch.isfinite(tab._ln3D).sum())} (the "
            f"real profile is the -99 sentinel, as in the JAX package)")
        check(bool(fin.any()), "the tSZ projected table is nowhere finite")
        _TSZ_MODELS[key] = tab
    return _TSZ_MODELS[key]


def tsz_catalog(n_halo, seed=3):
    """bench_runners.py's painting catalog, drawn in its order from one
    generator: uniform sky, power-law masses in [1e13, 1e15] of slope
    -0.8, z uniform in [0.1, 0.9]."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halo)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n_halo)))
    u = rng.uniform(0, 1, n_halo)
    M = 1e13 * (1 - u * (1 - (1e15 / 1e13) ** -0.8)) ** (1 / -0.8)
    z = rng.uniform(0.1, 0.9, n_halo)
    return dict(ra=ra, dec=dec, M=M, z=z)


def map_diff(a, b):
    """(rms/mean, max|diff|/max) of map a against map b."""
    return (np.sqrt(np.mean((a - b) ** 2)) / b.mean(),
            np.abs(a - b).max() / np.abs(b).max())


@contextlib.contextmanager
def spied(module, name, keep):
    """``module.name`` wrapped for the block: each call's positional
    arguments go to ``keep`` before the call goes on as it was."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        keep(args)
        return fn(*args, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def check_pass_inputs(torch, cmc, label, calls):
    """The cell-major kernel against its plain version on the inputs of
    each of a run's passes (one call a bucket, as the runner made them),
    float64 and float32, at check_cellmajor's bars; logs each bucket's F,
    whether the kernel culls there (F a multiple of 32), its slot-pixels
    and the float32 kernel's CUDA-event time."""
    for bi, (mode, planes, pix, *rest) in enumerate(calls):
        dense, counts, F, recs, rows, g0, dg, rad_hi = rest
        slots = int(counts.sum()) * F
        errs = []
        for dt in (torch.float64, torch.float32):
            args = (tuple(p.to(dt) for p in pix), dense, counts, F,
                    recs.to(dt), rows.to(dt), g0, dg, rad_hi)
            want = tuple(torch.zeros_like(p, dtype=dt) for p in planes)
            got = tuple(torch.zeros_like(w) for w in want)
            cmc.cellmajor_pass_reference(mode, want, *args)
            cmc.cellmajor_pass(mode, got, *args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            rel = 1e-12 if dt == torch.float64 else 1e-5
            errs.append((str(dt).split(".")[1], err, scale, rel))
            check(err <= rel * scale and all(bool(torch.isfinite(g).all())
                                             for g in got),
                  f"cellmajor_pass {mode} on the {label} bucket {bi} "
                  f"disagrees with its plain version in {dt}: max err "
                  f"{err:.3e}, max|out| {scale:.3e}")
        ms = cuda_ms(torch, lambda: cmc.cellmajor_pass(mode, got, *args), 5)
        log(f"{label}: bucket {bi}: cellmajor_pass {mode} vs plain at the "
            f"run's inputs: F={F} ({'patch cull' if F % 32 == 0 else 'no '
            'cull'}), {rows.shape[0]} halos, {slots:.4e} slot-pixels; "
            + "; ".join(f"{d} max|err| {e:.3e} (atol {r:g}*max|out| "
                        f"{s:.3e})" for d, e, s, r in errs)
            + f"; float32 kernel {ms:.4f} ms")


def check_scatter_rows(torch, sc, label, idx, vals, npix):
    """The scatter kernel against its plain version on one chunk of a
    run (its rows and values as the runner made them), float64 (rtol
    1e-12 a pixel: the same values summed in another order) and float32
    (atol 1e-5 max|sum|), scatter_input_check's bars."""
    valid = idx < npix
    line = []
    for dt in (torch.float64, torch.float32):
        v = tuple(x.to(dt) for x in vals)
        want = tuple(torch.zeros(npix, dtype=dt, device=idx.device)
                     for _ in v)
        got = tuple(torch.zeros_like(w) for w in want)
        sc.scatter_add_accum_reference(want, idx, v)
        sc.scatter_add_accum(got, idx, v)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        if dt == torch.float64:
            bad = any(bool(((g - w).abs() > 1e-12 * w.abs()).any())
                      for g, w in zip(got, want))
        else:
            bad = err > 1e-5 * scale
        line.append(f"{str(dt).split('.')[1]} max|err| {err:.3e} (max|sum| "
                    f"{scale:.3e})")
        check(not bad and scale > 0, f"scatter_add on the {label} chunk "
              f"disagrees with its plain version in {dt}: {err:.3e}")
    # CUDA-event times of one whole float32 call, kernel and plain version
    ms = cuda_ms(torch, lambda: sc.scatter_add_accum(got, idx, v), 10)
    ms_plain = cuda_ms(torch, lambda: sc.scatter_add_accum_reference(
        want, idx, v), 10)
    log(f"{label}: scatter_add vs plain at the run's largest chunk "
        f"({idx.numel()} rows, {int(valid.sum())} aimed at a pixel): "
        + "; ".join(line) + " (f64 rtol 1e-12 a pixel, f32 atol "
        f"1e-5*max|sum|); float32 whole call {ms:.4f} ms, plain "
        f"{ms_plain:.4f} ms")


def tsz_path(T, torch, sp, sc, cmc, device, n_halo, nside):
    """bench_runners.py's full-sky Compton-y paint on the card: the table,
    PaintProfilesShell under ``auto`` (cell-major, cold and warm with
    stages) held against a float64 paint of the same inputs, and the
    kernel against its plain version at every bucket of the run; the
    scatter method on the first 1e5 halos, its float32 map against
    float64, its float64 map against the cell-major float64 map of the
    same halos, and the kernel against its plain version at the run's
    largest chunk; anafast of the float32 y map. Returns the launch
    counts of the spectrum's run."""
    from baryonification_tpu_torch.runners import shell as tshell
    tab = tsz_model(T, torch, device, nside)
    halos = tsz_catalog(n_halo)
    shell = T.LightconeShell(map=np.zeros(12 * nside**2), cosmo=COSMO)

    def mk(h, **kw):
        cat = T.HaloLightConeCatalog(cosmo=COSMO, **h)
        return T.PaintProfilesShell(cat, shell, epsilon_max=GRID_PAINT_EPS,
                                    model=tab, verbose=False, device=device,
                                    **kw)

    runner = mk(halos)
    check(runner.method == "cellmajor",
          f"method 'auto' resolved to {runner.method!r} on the card")
    y, _, t_warm = run_process(torch, runner, "tsz path (auto = cellmajor)",
                               CELLMAJOR, SCATTER, paint=True)
    n_painted = int((y > 0).sum())
    log(f"tsz: y map: {n_painted} of {y.size} pixels painted "
        f"({100 * n_painted / y.size:.2f}%), mean y {y.mean():.4e}, max y "
        f"{y.max():.4e}; warm process() {t_warm:.3f} s")
    t0 = time.perf_counter()
    y64 = mk(halos, precision="float64").process()
    log(f"tsz: the same paint in float64 (cell-major): "
        f"{time.perf_counter() - t0:.2f} s")
    rms, rel = map_diff(y, y64)
    log(f"tsz: y map float32 vs float64 (cell-major, {n_halo} halos): "
        f"rms/mean {rms:.3e}, max|diff|/max {rel:.3e} (bar rms/mean "
        f"{TSZ_F32_BAR:g})")
    # the kernel at the path's own inputs: every bucket's pass of one more
    # float32 run (the tSZ table's rows, -1e30 at its non-finite nodes)
    calls = []
    with spied(tshell, "cellmajor_pass", calls.append):
        runner.process()
    check(len(calls) > 0, "the tsz run made no cell-major pass")
    check_pass_inputs(torch, cmc, "tsz path (auto = cellmajor)", calls)
    del calls

    n_sc = min(TSZ_SCATTER_HALOS, n_halo)
    sub = {k: v[:n_sc] for k, v in halos.items()}
    log(f"cut: tsz scatter method on the first {n_sc} halos (at 1e6 the "
        f"shell scatter method is host-bound at 13-25 s)")
    sc_runner = mk(sub, method="scatter")
    sc_label = f"tsz path (scatter, {n_sc} halos)"
    ys, _, _ = run_process(torch, sc_runner, sc_label, SCATTER, CELLMAJOR,
                           paint=True)
    # the kernel at the path's own inputs: the largest chunk of one more
    # float32 run
    chunk = []

    def keep(args):
        if not chunk or args[1].numel() > chunk[0].numel():
            chunk[:] = args[1:]

    with spied(tshell, "scatter_add_accum", keep):
        sc_runner.process()
    check(len(chunk) == 2, "the tsz scatter run made no scatter call")
    check_scatter_rows(torch, sc, sc_label, *chunk, 12 * nside**2)
    del chunk[:]
    f64 = {m: mk(sub, method=m, precision="float64").process()
           for m in ("cellmajor", "scatter")}
    cm64, sc64 = f64["cellmajor"], f64["scatter"]
    rms_s, rel_s = map_diff(ys, sc64)
    rms_c, rel_c = map_diff(mk(sub).process(), cm64)
    log(f"tsz: scatter float32 vs float64 ({n_sc} halos): rms/mean "
        f"{rms_s:.3e}, max|diff|/max {rel_s:.3e} (bar rms/mean "
        f"{TSZ_SCATTER_F32_BAR:g}); cell-major float32 vs float64 on the "
        f"same halos: rms/mean {rms_c:.3e}, max|diff|/max {rel_c:.3e} "
        f"(logged)")
    # tests/test_torch_cellmajor.py's bar between the paint methods
    excess = np.abs(cm64 - sc64) - (1e-9 * sc64.max() + 1e-6 * np.abs(sc64))
    rms_m, rel_m = map_diff(cm64, sc64)
    log(f"tsz: cell-major vs scatter (float64 both, {n_sc} halos): "
        f"rms/mean {rms_m:.3e}, max|diff|/max {rel_m:.3e} (bar atol 1e-9 "
        f"max, rtol 1e-6)")

    lmax = 2 * nside
    reset_counts()
    ymap = torch.as_tensor(y, device=device, dtype=torch.float32)
    cl, t_cl = synced(torch, lambda: sp.anafast(ymap, nside, lmax))
    counts = read_counts("tsz path (anafast of the y map)", ["legendre_alm"])
    _, t_warm_cl = synced(torch, lambda: sp.anafast(ymap, nside, lmax))
    cl = cl.double().cpu().numpy()
    ells = [2, 10, 100, 500, 1000, 2000]
    log(f"tsz: anafast of the float32 y map at lmax {lmax}: cold "
        f"{t_cl:.3f} s, warm {t_warm_cl:.3f} s; C_ell^yy at ell "
        + ", ".join(f"{l}: {cl[l]:.4e}" for l in ells if l <= lmax))
    # every reading is logged before any is checked
    check(rms < TSZ_F32_BAR, f"tsz y map float32 vs float64: rms/mean "
          f"{rms:.3e}")
    check(rms_s < TSZ_SCATTER_F32_BAR, f"tsz scatter y map float32 vs "
          f"float64: rms/mean {rms_s:.3e}")
    check(sc64.sum() > 0 and excess.max() <= 0,
          "tsz: the float64 paints of the two methods differ")
    check(cl.shape == (lmax + 1,) and np.isfinite(cl).all()
          and (cl[2:] > 0).all(), "C_ell^yy not finite and positive")
    return counts


def families_path(T, torch, device):
    """grid-256 (bench_runners' 3D grid inputs) under BaryonifyGrid
    ("auto") with the Arico20 and Mead20 DMO/DMB pairs: each
    Baryonification3D table built on the card (timed), process() cold
    and warm; mass conserved, the map changed, the CIC one scatter launch
    a corner."""
    dim, N, L, n_halo = GRID_CELLS["grid"]
    cat, gm = nd_catalog(T, dim, N, L, n_halo)
    out = {}
    for fam, par in (("Arico20", APAR),
                     ("Mead20", T.profiles.Mead20.Params_TAGN_7p8)):
        mod = getattr(T.profiles, fam)
        t0 = time.perf_counter()
        cosmo = T.Cosmology.from_dict(COSMO, device=device)
        model = T.Baryonification3D(mod.DarkMatterOnly(**par),
                                    mod.DarkMatterBaryon(**par), cosmo,
                                    epsilon_max=GRID_EPS)
        model.setup_interpolator(verbose=False, **RUNNERS_GRID)
        torch.cuda.synchronize()
        log(f"families: {fam} Baryonification3D table "
            f"{tuple(model._table.shape)} built on {device} in float64: "
            f"{time.perf_counter() - t0:.2f} s")
        check(bool(torch.isfinite(model._table).all()),
              f"non-finite {fam} table")
        runner = T.BaryonifyGrid(cat, gm, epsilon_max=GRID_EPS, model=model,
                                 verbose=False, device=device)
        check(runner.method == "cellmajor",
              f"method 'auto' resolved to {runner.method!r} on the card")
        label = f"families grid {fam} BaryonifyGrid (auto = cellmajor)"
        _, out[label], _ = run_process(torch, runner, label,
                                       SCATTER + GRID, CELLMAJOR)
        check(out[label]["scatter_add"] == 2 ** dim,
              f"{label}: the CIC redeposit is one scatter launch a corner "
              f"({2 ** dim}), got {out[label]['scatter_add']}")
    return out


def reference_models(T, torch, device, nside=64):
    """A small tSZ table (NSIDE 64) built on the card in float64 against
    the CPU build (1e-10 of max|table|), its paint on the card (both
    methods, float64 to 1e-10 and float32 to 1e-3 of max, the bars of the
    reference paint) against the CPU's float64 paint, and small Arico20
    and Mead20 Baryonification3D tables on the card against the CPU
    (1e-10 of max|table|)."""
    grid = dict(SMALL_GRID, z_max=0.95)      # the catalog's redshifts
    tabs = {str(d): tsz_model(T, torch, d, nside, grid)
            for d in ("cpu", device)}
    # nodes whose log is not finite (a zero or, past the FFTLog ringing, a
    # negative projected profile) paint nothing: compared as 0
    want, got = (torch.where(torch.isfinite(t._ln2D), torch.exp(t._ln2D),
                             0.0).cpu()
                 for t in (tabs["cpu"], tabs[str(device)]))
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"reference: NSIDE {nside} tSZ table on {device} vs cpu: "
        f"max|diff|/max = {rel:.3e}")
    check(rel < 1e-10, f"tSZ table on the card differs: {rel:.3e}")
    check(not torch.isfinite(tabs[str(device)]._ln3D).any(),
          "the tSZ 3D table is finite somewhere")
    halos = tsz_catalog(2000, seed=2)
    cat = T.HaloLightConeCatalog(cosmo=COSMO, **halos)
    floor = T.LightconeShell(map=np.zeros(12 * nside**2), cosmo=COSMO)
    kw = dict(epsilon_max=GRID_PAINT_EPS, model=tabs["cpu"], verbose=False)
    bad = []
    for method in ("scatter", "cellmajor"):
        ref = T.PaintProfilesShell(cat, floor, device="cpu", method=method,
                                   **kw).process()
        check(ref.sum() > 0, "the reference tSZ paint is empty")
        for prec, bar in (("float64", 1e-10), ("float32", 1e-3)):
            out = T.PaintProfilesShell(cat, floor, device=device,
                                       precision=prec, method=method,
                                       **kw).process()
            err = np.abs(out - ref).max() / np.abs(ref).max()
            log(f"reference: NSIDE {nside} tSZ paint ({method}) on {device} "
                f"in {prec} vs cpu float64: max|diff|/max = {err:.3e} (bar "
                f"{bar:g})")
            if not (np.isfinite(out).all() and err < bar):
                bad.append(f"{prec} {method} tSZ paint differs: {err:.3e}")
    for fam, par in (("Arico20", APAR),
                     ("Mead20", T.profiles.Mead20.Params_TAGN_7p8)):
        mod = getattr(T.profiles, fam)
        tables = []
        for d in ("cpu", device):
            model = T.Baryonification3D(
                mod.DarkMatterOnly(**par), mod.DarkMatterBaryon(**par),
                T.Cosmology.from_dict(COSMO, device=d), epsilon_max=GRID_EPS)
            model.setup_interpolator(verbose=False, **SMALL_GRID)
            tables.append(model._table.cpu().numpy())
        rel = np.abs(tables[1] - tables[0]).max() / np.abs(tables[0]).max()
        log(f"reference: small {fam} Baryonification3D table on {device} vs "
            f"cpu: max|diff|/max = {rel:.3e}")
        if not (np.isfinite(tables[1]).all() and rel < 1e-10):
            bad.append(f"{fam} table on the card differs: {rel:.3e}")
    check(not bad, "; ".join(bad))


def synced(torch, fn):
    """(fn(), seconds) with the card's work finished."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_anafast(torch, sp, hmap, nside, lmax):
    """Device time by kernel of one warm anafast of a device-resident map
    (torch.profiler), and the device's idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    sp.anafast(hmap, nside, lmax)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sp.anafast(hmap, nside, lmax)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the kernels themselves (an op's own entry repeats its kernels' time)
    evs = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in evs) / 1e3
    if not evs:
        log("cl: the profiler saw no device time; not measured")
        return
    top = sorted(evs, key=dev_us, reverse=True)[:6]
    log(f"cl: anafast profile (map on the card): wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms (idle {100 * (1 - busy / 1e3 / wall):.0f}"
        f"%); by kernel: " + "; ".join(
            f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
            for e in top))


def cl_path(T, torch, sp, device, nside, n_halo=3000):
    """examples/09_delta_cls_shells.py on the card: paint, baryonify over
    the theta_ej sweep, anafast ratios, the example's four checks."""
    lmax = 2 * nside
    scaled = [int(l * nside / 64) for l in (8, 16, 32, 48, 64, 96)]
    scaled[0] = min(scaled[0], 64)
    ells = tuple(scaled)
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    rng = np.random.default_rng(4)
    cat = T.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n_halo),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n_halo))),
        M=10 ** rng.uniform(13.2, 15.0, n_halo),
        z=rng.uniform(0.1, 0.9, n_halo), cosmo=COSMO)
    t0 = time.perf_counter()
    tab = T.TabulatedProfile(T.DarkMatter(**dict(EX09_PAR, theta_ej=4.0)),
                             cosmo)
    tab.setup_interpolator(z_min=0.05, z_max=1.0, N_samples_z=8,
                           M_min=1e12, M_max=1e16, N_samples_Mass=16,
                           R_min=1e-3, R_max=1e2, N_samples_R=100)
    log(f"cl: TabulatedProfile(DarkMatter) tables built in "
        f"{time.perf_counter() - t0:.2f} s")

    reset_counts()
    floor = T.LightconeShell(map=np.full(12 * nside**2, 1e10), cosmo=COSMO)
    painted, t_paint = synced(torch, lambda: T.PaintProfilesShell(
        cat, floor, epsilon_max=5, model=tab, verbose=False,
        device=device).process())
    paint_counts = read_counts("C_ell path (paint)", CELLMAJOR)
    check(np.isfinite(painted).all() and painted.sum() > 0,
          "the painted map is not finite or empty")
    log(f"cl: painted {n_halo} halos at NSIDE {nside} in {t_paint:.2f} s")
    shell = T.LightconeShell(map=painted + 1e10, cosmo=COSMO)

    reset_counts()
    cl0, t_cl = synced(torch, lambda: sp.anafast(shell.map, nside, lmax,
                                                 device=device))
    t_anafast = [t_cl]
    res = {}
    for theta_ej in EX09_SWEEP:
        par = dict(EX09_PAR, theta_ej=theta_ej)
        model = T.Baryonification2D(T.DarkMatterOnly(**par),
                                    T.DarkMatterBaryon(**par), cosmo,
                                    epsilon_max=20)
        model.setup_interpolator(z_min=0.05, z_max=1.0, N_samples_z=6,
                                 M_min=1e12, M_max=1e16,
                                 N_samples_Mass=16, R_min=1e-3,
                                 R_max=1e2, N_samples_R=100, verbose=False)
        new_map, t_b = synced(torch, lambda: T.BaryonifyShell(
            cat, shell, epsilon_max=20, model=model, verbose=False,
            device=device).process())
        cl1, t_cl = synced(torch, lambda: sp.anafast(new_map, nside, lmax,
                                                     device=device))
        t_anafast.append(t_cl)
        check(bool(torch.isfinite(cl1).all()) and cl1.shape == (lmax + 1,),
              "C_ell not finite or of the wrong shape")
        ratio = (cl1 / cl0).double().cpu().numpy()
        res[theta_ej] = np.array([ratio[l] - 1 for l in ells])
        log(f"cl: theta_ej={theta_ej}: baryonify {t_b:.2f} s, anafast "
            f"{t_cl:.3f} s")
    counts = read_counts("C_ell path (baryonify + anafast)",
                         CELLMAJOR + REGRID + ["legendre_alm"])
    profile_anafast(torch, sp, torch.as_tensor(new_map, device=device,
                                               dtype=torch.float32),
                    nside, lmax)
    log("cl: anafast times (s, synced, map on the host): "
        + ", ".join(f"{t:.3f}" for t in t_anafast))
    log("cl: dC_ell/C_ell at ell = " + ", ".join(map(str, ells)))
    for tej, d in res.items():
        log(f"cl:   theta_ej={tej:4.1f}  "
            + "  ".join(f"{v:+.5f}" for v in d))
    i_hi, i_lo = 5, 0
    check(all(abs(d[i_lo]) < 5e-3 for d in res.values()),
          "example 09: low ell not preserved")
    check(res[4.0][i_hi] < -2e-3 and res[8.0][i_hi] < -2e-3,
          "example 09: no small-scale suppression")
    check(res[8.0][i_hi] < res[4.0][i_hi] < res[2.0][i_hi],
          "example 09: theta_ej ordering broken")
    d8 = res[8.0]
    check(d8[i_hi] < d8[3] < d8[1] + 1e-4,
          "example 09: ell ordering broken")
    log("cl: the example's four dC_ell shape checks pass")
    return paint_counts, counts


def synth_path(T, torch, sp, device, nside):
    """synfast -> anafast within cosmic variance; alm2map -> map2alm,
    where three Jacobi rounds beat none."""
    lmax = 2 * nside
    ell = np.arange(lmax + 1)
    cl_in = torch.tensor(1.0 / (ell + 10.0) ** 2, device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    reset_counts()
    hmap, t_syn = synced(torch, lambda: sp.synfast(cl_in, nside, lmax, gen))
    cl_hat, t_ana = synced(torch, lambda: sp.anafast(hmap, nside, lmax))
    check(hmap.shape == (12 * nside**2,) and bool(torch.isfinite(hmap).all()),
          "synfast map not finite or of the wrong shape")
    ratio = (cl_hat.double() / cl_in.double()).cpu().numpy()[2:]
    # chi2_{2l+1}/(2l+1) per ell: sigma_l = sqrt(2/(2l+1)); each ell within
    # 5 sigma_l, and the mean over 2..lmax within 5 sigma of the mean
    sig = np.sqrt(2.0 / (2 * ell[2:] + 1))
    z = np.abs(ratio - 1) / sig
    sig_mean = np.sqrt(np.sum(sig**2)) / sig.size
    log(f"synth: synfast {t_syn:.3f} s, anafast {t_ana:.3f} s; recovered/"
        f"input C_ell: max |r-1|/sigma_l = {z.max():.2f} (bound 5), mean "
        f"r = {ratio.mean():.5f} (bound 1 +/- {5 * sig_mean:.5f})")
    check(z.max() < 5 and abs(ratio.mean() - 1) < 5 * sig_mean,
          "synfast -> anafast outside the cosmic-variance bound")

    are, aim = sp.synalm(cl_in, lmax, gen)
    f, t_a2m = synced(torch, lambda: sp.alm2map(are, aim, nside, lmax))
    scale = float(torch.maximum(are.abs().max(), aim.abs().max()))
    resid = {}
    for it in (0, 3):
        (gre, gim), t_m2a = synced(
            torch, lambda: sp.map2alm(f, nside, lmax, iter=it))
        resid[it] = max(float((gre - are).abs().max()),
                        float((gim - aim).abs().max())) / scale
        log(f"synth: map2alm(iter={it}) {t_m2a:.3f} s, max|a - a_in|/max|a_in|"
            f" = {resid[it]:.3e}")
    log(f"synth: alm2map {t_a2m:.3f} s")
    check(resid[3] < resid[0], "map2alm(iter=3) did not beat iter=0")
    return read_counts("synthesis path", ["legendre_synth", "legendre_alm"])


def reference_spectra(T, torch, sp, device, nside=64):
    """anafast, alm2map (float64 and float32 on the card) and the paint
    (both precisions) at NSIDE 64 against the port's CPU float64 runs."""
    lmax = 2 * nside
    rng = np.random.default_rng(5)
    m = torch.tensor(rng.normal(size=12 * nside**2))
    L = lmax + 1
    tri = np.tril(np.ones((L, L)))
    are = torch.tensor(rng.normal(size=(L, L)) * tri)
    aim = torch.tensor(rng.normal(size=(L, L)) * tri
                       * (np.arange(L)[None, :] > 0))
    cl_want = sp.anafast(m, nside, lmax).numpy()
    f_want = sp.alm2map(are, aim, nside, lmax).numpy()
    M = sp._bluestein_len(nside)
    # float64 to rounding; float32 to 1e-4 (its SHT sits near 1e-5 of
    # float64 at this size, as test_spectra.py measures)
    for dt, bar in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        c = sp._seed_consts(nside, lmax, dt, device)
        cl = sp._anafast_core(m.to(device, dt), nside, lmax, M, c)
        f = sp._alm2map_core(are.to(device, dt), aim.to(device, dt), nside,
                             lmax, M, c)
        e_cl = float(np.max(np.abs(cl.double().cpu().numpy() - cl_want)
                            / cl_want))
        e_f = float(np.abs(f.double().cpu().numpy() - f_want).max()
                    / np.abs(f_want).max())
        log(f"reference: NSIDE {nside} on {device} in {dt}: anafast max "
            f"rel err {e_cl:.3e}, alm2map max err/max|f| {e_f:.3e} "
            f"(bar {bar:g})")
        check(e_cl < bar and e_f < bar, f"{dt} SHT on the card differs")

    cosmo = T.Cosmology.from_dict(COSMO, device="cpu")
    tab = T.TabulatedProfile(T.DarkMatter(**dict(EX09_PAR, theta_ej=4.0)),
                             cosmo)
    tab.setup_interpolator(z_min=0.05, z_max=1.0, N_samples_z=4,
                           M_min=1e12, M_max=1e16, N_samples_Mass=8,
                           R_min=1e-3, R_max=1e2, N_samples_R=60)
    rng = np.random.default_rng(6)
    n = 400
    cat = T.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.2, 15.0, n), z=rng.uniform(0.1, 0.9, n),
        cosmo=COSMO)
    floor = T.LightconeShell(map=np.zeros(12 * nside**2), cosmo=COSMO)
    kw = dict(epsilon_max=5, model=tab, verbose=False)
    for method in ("scatter", "cellmajor"):
        want = T.PaintProfilesShell(cat, floor, device="cpu", method=method,
                                    **kw).process()
        # the painted map is sparse and peaked, so the error is taken
        # against its largest pixel. float32 moves a pixel that sits ~1e-4
        # rad from a halo centre by ~1e-3 of its separation (cancellation
        # in the geometry), and the profile is steep there: 2e-4 of max
        # measured on the CPU at this size
        for prec, bar in (("float64", 1e-10), ("float32", 1e-3)):
            got = T.PaintProfilesShell(cat, floor, device=device,
                                       precision=prec, method=method,
                                       **kw).process()
            err = np.abs(got - want).max() / np.abs(want).max()
            log(f"reference: NSIDE {nside} paint ({method}) on {device} in "
                f"{prec} vs cpu float64: max|diff|/max = {err:.3e} (bar "
                f"{bar:g})")
            check(np.isfinite(got).all() and err < bar,
                  f"{prec} {method} paint on the card differs: {err:.3e}")


# ----- the snapshot path: bench_runners.py's bench_snap -----

# bench_runners.py:202-221 (bench_snap): box side [Mpc], particles, halos
SNAP_CELL = (500.0, 5_000_000, 100_000)
# bench_runners.py:18-19: the gather method's comparison size (at 5e6
# particles it crashed the TPU worker)
SNAP_GATHER = (2_000_000, 30_000)
SNAP_EPS = 15.0
# float32 bars, rms of the offset difference over the rms of the float64
# offsets, each 2.7x the CPU's reading of the plain version at bench_snap's
# geometry (L = 500, its halo catalog) with fewer particles: the float32
# offsets against float64 5.87e-5 (4e5 particles, 1e5 halos: a particle
# near L = 500 is resolved to ~3e-5 Mpc, so the r < eps_max R cut flips
# at the sphere's edge), the two float32 methods against each other
# 3.6e-7 (2e5 particles, 3e4 halos)
SNAP_F32_BAR = 1.6e-4
SNAP_METHODS_F32_BAR = 1e-6
# operations the cell-major snapshot pass needs (a sqrt, log or division
# counted as one), from runners/snapshot_cellmajor.py: every listed
# (particle, halo) pair takes the three min-image deltas (5 each) and the
# squared radius and its compare against (eps_max R)^2 (6); one inside
# reads the table: sqrt, log, t (2), node and weight (3), the lerp (3),
# 1/r and the scale by a (2) and the push (2 a dimension)
SNAP_TEST_FLOPS = 3 * 5 + 6
SNAP_READ_FLOPS = 1 + 1 + 2 + 3 + 3 + 2 + 6
# the adjoint's more a pair inside: the cotangents' dot (5), the shares
# (3), less the push (6)
SNAP_VJP_FLOPS = 5 + 3 - 6
# the snap_pass and snap_vjp kernels against the plain step loop on the
# card, of max|plain|: the same arithmetic a pair (the geometry bit for
# bit), summed in another order: a slot's pairs (the pass), a node's
# shares from many pairs by atomic adds in no fixed order (the adjoint)
SNAP_PASS_BAR = {"float64": 1e-13, "float32": 1e-5}
SNAP_VJP_BAR = {"float64": 1e-12, "float32": 1e-4}
SNAP_PASS_SOURCE = "baryonification_tpu_torch/csrc/snap_pass.cu"
SNAP_PASS_REPLACES = "baryonification_tpu/runners/snapshot_cellmajor.py:89"


def snap_inputs(T, L, n_part, n_halo, seed):
    """bench_runners.py's bench_snap inputs, drawn in its order from one
    generator: halo positions uniform in [0, L), power-law masses in
    [1e13, 1e15] of slope -0.8, redshift 0.25; then uniform particles of
    unit mass."""
    rng = np.random.default_rng(seed)
    pos = {c: rng.uniform(0, L, n_halo) for c in "xyz"}
    u = rng.uniform(0, 1, n_halo)
    M = 1e13 * (1 - u * (1 - (1e15 / 1e13) ** -0.8)) ** (1 / -0.8)
    cat = T.HaloNDCatalog(M=M, redshift=0.25, cosmo=COSMO, **pos)
    part = {c: rng.uniform(0, L, n_part) for c in "xyz"}
    snap = T.ParticleSnapshot(M=np.ones(n_part), L=L, redshift=0.25,
                              cosmo=COSMO, **part)
    return cat, snap


def snap_offsets(snap, new_cat):
    """(Np, 3) float64 offsets of a process() result (min image)."""
    L = float(snap.L)
    d = np.stack([new_cat[c] - snap.cat[c] for c in "xyz"], axis=-1)
    return d - L * np.round(d / L)


def offsets_diff(a, b):
    """rms of a - b over the rms of b."""
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def snap_process(torch, runner, label, expected, absent):
    """process() cold with the launch counts read, then warm with its
    stages; checks every position finite and in [0, L]. Returns (new
    catalog, launches, cold s, warm s)."""
    snap = runner.ParticleSnapshot
    reset_counts()
    t0 = time.perf_counter()
    new_cat = runner.process()
    t_cold = time.perf_counter() - t0
    launches = read_counts(label, expected)
    for k in absent:
        check(launches[k] == 0, f"the {label} launched kernel {k}")
    pos = np.stack([new_cat[c] for c in "xyz"], axis=-1)
    check(np.isfinite(pos).all() and pos.min() >= 0
          and pos.max() <= snap.L, f"{label}: positions not finite or "
          f"outside [0, L]")
    runner.profile = True
    runner.stage_times = []
    t0 = time.perf_counter()
    warm = runner.process()
    t_warm = time.perf_counter() - t0
    runner.profile = False
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in runner.stage_times)
    log(f"snap: {label}: {len(snap)} particles, "
        f"{runner.HaloNDCatalog.cat.size} halos, n_cells "
        f"{runner.tree.n_cells}, P {runner.tree.max_per_cell}, "
        f"method={runner.method}, dtype={runner.dtype}: process() cold "
        f"{t_cold:.2f} s, warm {t_warm:.2f} s (stages, synced: {stages})")
    # the gather's scatter adds in whatever order the card's atomics
    # take, so its runs agree to the hot dtype's rounding only
    rel = offsets_diff(snap_offsets(snap, warm), snap_offsets(snap, new_cat))
    bar = (0.0 if runner.method == "cellmajor" else
           1e-6 if runner.dtype == torch.float32 else 1e-13)
    log(f"snap: {label}: warm vs cold offsets rms/rms {rel:.3e} (bar {bar:g})")
    check(rel <= bar, f"{label}: the warm run differs: {rel:.3e}")
    return new_cat, launches, t_cold, t_warm


def check_locality(torch, device, runner, off, n_sample=20000, seed=0):
    """On a sample of particles: every particle that moved lies within
    eps_max R_com of some halo (min image, on the card in float64), and
    some moved. Returns (moved, sampled)."""
    snap, cat = runner.ParticleSnapshot, runner.HaloNDCatalog.cat
    L = float(snap.L)
    _, R_com, _, xh, _ = runner._halo_geom()
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(snap), size=min(n_sample, len(snap)), replace=False)
    p = torch.as_tensor(np.stack([snap.cat[c][sel] for c in "xyz"], -1),
                        device=device)
    h = torch.as_tensor(xh, device=device)
    reach = torch.as_tensor(runner.epsilon_max * R_com, device=device)
    nearest = torch.empty(len(sel), dtype=torch.float64, device=device)
    for i0 in range(0, len(sel), 512):
        d = p[i0:i0 + 512, None, :] - h[None]
        d = d - L * torch.round(d / L)
        q = torch.sqrt((d * d).sum(-1)) / reach[None]
        nearest[i0:i0 + 512] = q.min(dim=1).values
    moved = np.any(off[sel] != 0, axis=1)
    q = nearest.cpu().numpy()
    log(f"snap: locality on {len(sel)} sampled particles: {moved.sum()} "
        f"moved, the largest r / (eps_max R_com) of a moved one to its "
        f"nearest halo {q[moved].max() if moved.any() else 0:.6f}; "
        f"{(q < 1).sum()} lie inside some halo's reach")
    check(moved.any() and (q[moved] < 1 + 1e-6).all(),
          "snap: a particle moved outside every halo's eps_max R_com")
    return int(moved.sum()), len(sel)


def snap_census(torch, runner, label):
    """One more warm process() with the pass's census (on the card the
    kernel's tally: it synchronises once a bucket), and one under
    torch.profiler for the device's launches, busy time and idle share;
    the peak device memory of a warm call. Fails unless the census call
    launched snap_pass once a bucket. Returns (pairs, inside, operations
    bound ms)."""
    from baryonification_tpu_torch.ops import snap_pass_cuda as spc
    census, peak, n_warm, n_launch, dev_ms, idle = census_run(
        torch, runner, spc.LAUNCHES, "snap_pass")
    log(f"snap: {label}: snap_pass launches a warm process() {n_warm} "
        f"({len(census)} buckets)")
    check(n_warm == len(census) > 0, f"{label}: a warm process() launched "
          f"snap_pass {n_warm} times for {len(census)} buckets")
    pairs = sum(c["pairs"] for c in census)
    inside = sum(c["inside"] for c in census)
    flops = pairs * SNAP_TEST_FLOPS + inside * SNAP_READ_FLOPS
    bound = flops / PEAK_FLOPS["float32"] * 1e3
    for c in census:
        log(f"snap: {label} census bucket {c['bucket']}: H={c['H']}, "
            f"K={c['K']}, P={c['P']}, n_hi={c['n_hi']}: pairs "
            f"{c['pairs']:.4e}, inside {c['inside']:.4e} "
            f"({100 * c['inside'] / max(c['pairs'], 1):.1f}%), "
            f"{c['steps']} steps")
    log(f"snap: {label}: the pass lists {pairs:.4e} (particle, halo) "
        f"pairs, {inside:.4e} inside; operations bound {bound:.4f} ms "
        f"({flops:.3e} flops at {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s); one warm process() puts {n_launch} device launches on "
        f"the card, {dev_ms if dev_ms is None else round(dev_ms, 3)} ms "
        f"busy; device idle {idle}; peak device memory {peak:.2f} GiB")
    return pairs, inside, bound


def snap_kernel_bounds(c, dname, vjp):
    """(operations ms, bytes ms) of one snapshot kernel launch on a bucket
    whose counts are ``c`` (pairs, inside, and its sizes): the tests of
    every listed pair and the readout of each inside (SNAP_TEST_FLOPS,
    SNAP_READ_FLOPS; the adjoint SNAP_VJP_FLOPS more); bytes: each input
    that the kernel needs read once (the positions of the real slots,
    the adjoint's cotangents there too; the per-cell counts; the
    candidate ids within their counts, of the cells with a particle; the
    per-halo columns; the rows, whole), each output written once (every
    slot of the planes, pads too; the adjoint's rows)."""
    t = 8 if dname == "float64" else 4
    read = SNAP_READ_FLOPS + (SNAP_VJP_FLOPS if vjp else 0)
    flops = c["pairs"] * SNAP_TEST_FLOPS + c["inside"] * read
    n_bytes = (c["real"] * 3 * t * (1 + vjp)
               + (0 if vjp else c["slots"] * 3 * t) + c["ncell"] * 2 * 4
               + c["ids"] * 4 + c["H"] * c["hcols"] * t
               + c["H"] * c["n_hi"] * t * (1 + vjp))
    return flops / PEAK_FLOPS[dname] * 1e3, n_bytes / PEAK_BYTES * 1e3


def check_snap_bucket(torch, label, args, dt, seed=0):
    """snap_pass and snap_vjp against the plain step loop on a _SnapBucket
    (check_bucket_kernels, within SNAP_PASS_BAR / SNAP_VJP_BAR) at one
    bucket of a run: ``args`` the runner's snapshot_pass_diff arguments,
    its planes, records and rows cast to ``dt``. Returns
    check_bucket_kernels' results."""
    from baryonification_tpu_torch.ops import snap_pass_cuda as spc
    from baryonification_tpu_torch.runners import snapshot_cellmajor as tscm
    (rdelta, P, n_hi, dense, counts_h, counts_host, planes, counts_p, pk,
     rows, g0, dg, rad_hi, eps, a_scale, L) = args
    dname = str(dt).split(".")[1]
    if dt == torch.float32:
        # the radial grid's nodes as float32 holds them, as the runner's
        g0, dg, rad_hi = (float(np.float32(v)) for v in (g0, dg, rad_hi))
    bk = tscm._SnapBucket(rdelta, P, n_hi, dense, counts_h, counts_host,
                          tuple(p.to(dt) for p in planes), counts_p,
                          pk.to(dt), g0, dg, rad_hi, eps, a_scale, L)
    rows = rows.detach().to(dt).contiguous()
    head, tail = bk.kernel_args(rows), bk.kernel_scalars()
    real = bk.counts_p.clamp(max=P).long()
    sizes = dict(real=int(real.sum()), slots=bk.ncell * P, ncell=bk.ncell,
                 ids=int(torch.where(real > 0, bk.counts_h.clamp(max=bk.K),
                                     0).long().sum()),
                 H=rows.shape[0], hcols=bk.hrec.shape[1], n_hi=n_hi)
    out, _ = check_bucket_kernels(
        torch, label, spc, bk, rows, (),
        lambda t: spc.snap_pass(*head, *tail, tally=t),
        lambda c, t: (spc.snap_vjp(*head, c, *tail, tally=t),),
        (SNAP_PASS_BAR, SNAP_VJP_BAR),
        lambda kt, v: snap_kernel_bounds(
            dict(sizes, pairs=kt[0], inside=kt[1]), dname, v),
        f"H={rows.shape[0]}, ncell={bk.ncell}, K={bk.K}, P={P}, "
        f"n_hi={n_hi}, rdelta={bool(rdelta)}; {sizes['real']} real slots "
        f"of {sizes['slots']}, {sizes['ids']} candidate ids read of "
        f"{dense.numel()}", seed)
    return out


def snap_path(T, torch, sc, device):
    """bench_runners.py's bench_snap on the card: BaryonifySnapshot of 5e6
    particles around 1e5 halos under ``auto`` (the cell-major method:
    the snap_pass kernel, one launch a bucket), cold and warm with
    stages, the census and profile of a warm call, the float32 offsets
    held against a float64 run, snap_pass and snap_vjp against the plain
    step loop at the run's largest bucket in both dtypes
    (check_snap_bucket); at 2e6 / 3e4 the gather method (one scatter
    launch a halo chunk) against the cell-major method in float64 (rtol
    1e-10, atol 1e-10) and float32, and the scatter kernel against its
    plain version at the gather run's largest chunk. Returns (the launch
    counts of every cold run, by run; {dtype name: check_snap_bucket's
    result})."""
    from baryonification_tpu_torch.runners import snapshot as tsnap
    from baryonification_tpu_torch.runners import snapshot_cellmajor as tscm
    model = grid_model(T, torch, device, 3)
    L, n_part, n_halo = SNAP_CELL
    cat, snap = snap_inputs(T, L, n_part, n_halo, seed=3)
    out = {}

    def mk(c, s, **kw):
        t0 = time.perf_counter()
        r = T.BaryonifySnapshot(c, s, epsilon_max=SNAP_EPS, model=model,
                                verbose=False, device=device, **kw)
        return r, time.perf_counter() - t0

    runner, t_list = mk(cat, snap)
    check(runner.method == "cellmajor",
          f"method 'auto' resolved to {runner.method!r} on the card")
    log(f"snap: cell list of {n_part} particles ({runner.tree.n_cells}^3 "
        f"cells, at most {runner.tree.max_per_cell} a cell) built on the "
        f"host in {t_list:.2f} s")
    label = f"snap BaryonifySnapshot (auto = cellmajor, {n_part})"
    new32, out[label], _, _ = snap_process(torch, runner, label, SNAP,
                                           SCATTER + CELLMAJOR)
    off32 = snap_offsets(snap, new32)
    check_locality(torch, device, runner, off32)
    snap_census(torch, runner, label)
    calls = []
    with spied(tscm, "snapshot_pass_diff", calls.append):
        runner.process()
    # the bucket that lists the most (particle, halo) pairs
    args = max(calls, key=lambda a: int(
        (a[7].long() * a[4].long()).sum()))
    del calls
    kernels = {}
    for dt in (torch.float32, torch.float64):
        kernels[str(dt).split(".")[1]] = check_snap_bucket(
            torch, f"snap {label}", args, dt)
        torch.cuda.empty_cache()
    del args
    r64, _ = mk(cat, snap, precision="float64")
    t0 = time.perf_counter()
    off64 = snap_offsets(snap, r64.process())
    rel = offsets_diff(off32, off64)
    moved = np.any(off64 != 0, axis=1)
    log(f"snap: float64 run (cell-major) {time.perf_counter() - t0:.2f} s; "
        f"{moved.mean() * 100:.2f}% of the particles moved, rms offset "
        f"{np.sqrt(np.mean(off64[moved] ** 2)):.4e} Mpc; float32 vs "
        f"float64 offsets: rms/rms {rel:.3e}, max|diff| "
        f"{np.abs(off32 - off64).max():.3e} Mpc (bar rms/rms "
        f"{SNAP_F32_BAR:g})")
    del r64, off64, off32, new32, runner

    n_part2, n_halo2 = SNAP_GATHER
    log(f"cut: the gather method at {n_part2} particles / {n_halo2} halos "
        f"(bench_runners.py's comparison size), the cell-major method at "
        f"{n_part} / {n_halo}")
    cat2, snap2 = snap_inputs(T, L, n_part2, n_halo2, seed=5)
    offs = {}
    for method in ("cellmajor", "gather"):
        r, _ = mk(cat2, snap2, method=method)
        label = f"snap BaryonifySnapshot ({method}, {n_part2})"
        new, out[label], _, _ = snap_process(
            torch, r, label, SCATTER if method == "gather" else SNAP,
            CELLMAJOR + (SNAP if method == "gather" else SCATTER))
        offs[method, "float32"] = snap_offsets(snap2, new)
        if method == "gather":
            chunk = []

            def keep(args):
                if not chunk or args[1].numel() > chunk[0].numel():
                    chunk[:] = args[1:]

            with spied(tsnap, "scatter_add_accum", keep):
                r.process()
            check(len(chunk) == 2, "the snap gather run made no scatter call")
            check_scatter_rows(torch, sc, label, *chunk, n_part2)
            del chunk[:]
        r64, _ = mk(cat2, snap2, method=method, precision="float64")
        t0 = time.perf_counter()
        offs[method, "float64"] = snap_offsets(snap2, r64.process())
        log(f"snap: {method} float64 run at {n_part2}: "
            f"{time.perf_counter() - t0:.2f} s")
    new_cm = offs["cellmajor", "float64"] + np.stack(
        [snap2.cat[c] for c in "xyz"], -1)
    new_g = offs["gather", "float64"] + np.stack(
        [snap2.cat[c] for c in "xyz"], -1)
    err64 = np.abs(new_cm - new_g) - (1e-10 + 1e-10 * np.abs(new_g))
    rel_m = offsets_diff(offs["cellmajor", "float32"],
                         offs["gather", "float32"])
    rel_g = offsets_diff(offs["gather", "float32"], offs["gather", "float64"])
    log(f"snap: cellmajor vs gather at {n_part2} / {n_halo2}: float64 "
        f"max|diff| {np.abs(new_cm - new_g).max():.3e} Mpc (bar atol 1e-10 "
        f"+ rtol 1e-10); float32 offsets rms/rms {rel_m:.3e} (bar "
        f"{SNAP_METHODS_F32_BAR:g}); gather float32 vs float64 rms/rms "
        f"{rel_g:.3e} (logged)")
    # every reading is logged before any is checked
    check(rel < SNAP_F32_BAR, f"snap float32 vs float64 offsets: {rel:.3e}")
    check(err64.max() <= 0, "snap: the float64 methods differ")
    check(rel_m < SNAP_METHODS_F32_BAR,
          f"snap: the float32 methods differ: {rel_m:.3e}")
    return out, kernels


# ----- the dP(k) path: examples/10 and 12 -----

# examples/10_delta_pk_snapshot.py:43-44: per-curve and overall RMS bars of
# the halo-model suppression against the scraped Schneider+19 Fig. 2
FIG2_TOL = 0.035
FIG2_TOL_OVERALL = 0.030
# examples/10_delta_pk_snapshot.py:271-280 (Part B) and
# examples/12_arico_delta_pk_snapshot.py:83-94: mock boxes, measured vs
# predicted RMS bar and the least suppression in the window
BOX_RMS_TOL = 0.050
BOX_SUPP = {"ex10": 0.10, "ex12": 0.02}
FIG2_CSV = ROOT / "examples" / "data" / "S19_Fig2_Scrapped.csv"


def s19_fig2_config(T, device):
    """Notebook-10 cosmology, parameters and the S19-beta gas class
    (examples/10_delta_pk_snapshot.py:47-76)."""
    h = 0.6711
    cosmo = T.Cosmology(Omega_m=0.3175, Omega_b=0.049, h=h, sigma8=0.82,
                        n_s=0.9649, device=device)
    bpar = dict(theta_ej=4, theta_co=0.1,
                M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3,
                tau=-np.inf, tau_delta=0,  # -inf cancels one f_star term
                A=0.09 / 2, M1=2.5e11 / h,
                epsilon_h=0.015, a=0.3, n=2, epsilon=4, p=0.3, q=0.707,
                gamma=2, delta=7, proj_cutoff=205 / h / 2)

    class Gas_S19(T.Gas):
        """Schneider+19 beta(M) = 3 - (M_c/M)^mu."""

        def _get_gas_params(self, M, z):
            beta, theta_ej, theta_co, delta, gamma = \
                super()._get_gas_params(M, z)
            beta = 3.0 - (self.M_c / M)[:, None] ** self.mu_beta
            return beta, theta_ej, theta_co, delta, gamma

    return cosmo, bpar, Gas_S19, h


def fig2_sweeps(bpar, h):
    """(scraped-column tag, parameter dict) for the 15 published curves
    (examples/10_delta_pk_snapshot.py:79-91)."""
    sweeps = [(f'T{v}', dict(bpar, theta_ej=v)) for v in (2, 3, 4, 6, 8)]
    # the eta sweep holds eta + eta_delta = 0.6 fixed
    sweeps += [(f'Ep{i + 1}', dict(bpar, eta=v, eta_delta=0.6 - v))
               for i, v in enumerate((0.1, 0.2, 0.3, 0.4, 0.5))]
    sweeps += [(tag, dict(bpar, M_c=v)) for tag, v in
               [('Mc2p5e13', 2.5e13 / h), ('Mc5e13', 5e13 / h),
                ('Mc1e14', 1e14 / h), ('Mc2e14', 2e14 / h),
                ('Mc4e14', 4e14 / h)]]
    return sweeps


def load_scraped_fig2(h, path=FIG2_CSV):
    """Scraped S19 Fig. 2 curves as {tag: (k [1/Mpc], P_B/P_DMO)}; the
    scraped k is in h/Mpc (examples/10_delta_pk_snapshot.py:94-109)."""
    tags = [t.strip() for t in open(path).readline().split(',')[::2]]
    raw = np.genfromtxt(path, delimiter=',', skip_header=2)
    out = {}
    for i, tag in enumerate(tags):
        X, Y = raw[:, 2 * i], raw[:, 2 * i + 1]
        ok = np.isfinite(X) & np.isfinite(Y)
        out[tag] = (X[ok] * h, Y[ok])
    return out


def fig2_rms(T, device):
    """RMS of the predicted suppression (``analysis.pk_suppression`` on
    ``device``) against each of the 15 scraped curves
    (examples/10_delta_pk_snapshot.py:112-136)."""
    cosmo, bpar, Gas_S19, h = s19_fig2_config(T, device)
    scraped = load_scraped_fig2(h)
    rms = {}
    for tag, par in fig2_sweeps(bpar, h):
        kk, SS = scraped[tag]
        dmo = T.DarkMatter(**par)
        dmb = (T.DarkMatterBaryon(**par, gas=Gas_S19(**par))
               - T.TwoHalo(**par))
        S = T.analysis.pk_suppression(dmo, dmb, cosmo, kk, M_cut=10**12.8)
        rms[tag] = float(np.sqrt(np.mean((S.cpu().numpy() - SS) ** 2)))
    return rms


def box_crosscheck(T, device, n_halo=40, L=100.0, n_grid=128, n_bins=36,
                   seed=7, part_mass=4e10, table_samples=(20, 500),
                   model_pair=None, cosmo=None, epsilon_max=20,
                   table_kwargs=None, M_range=(13.0, 14.5)):
    """The snapshot pipeline on a DMO-sampled mock box
    (examples/10_delta_pk_snapshot.py:139-249): the displacement table
    and ``BaryonifySnapshot`` (float64) on ``device``, ``make_map`` on the
    host, ``power_spectrum_3d`` and ``profile_uk`` on ``device``. Returns
    (k, measured S, predicted S) over the box's k bins."""
    if model_pair is None:
        cosmo, bpar, Gas_S19, h = s19_fig2_config(T, device)
        zero2h = T.TwoHalo(**bpar) * 0
        DMO = T.DarkMatterOnly(**bpar, twohalo=zero2h)
        DMB = T.DarkMatterBaryon(**bpar, twohalo=zero2h,
                                 gas=Gas_S19(**bpar))
    else:
        DMO, DMB = model_pair
    cd = dict(cosmo.cosmodict)
    disp = T.Baryonification3D(DMO, DMB, cosmo, epsilon_max=epsilon_max)
    tkw = dict(z_min=0.0, z_max=0.01, N_samples_z=2,
               z_linear_sampling=True, M_min=1e12, M_max=1e16,
               N_samples_Mass=table_samples[0],
               R_min=1e-4, R_max=300, N_samples_R=table_samples[1])
    tkw.update(table_kwargs or {})
    disp.setup_interpolator(verbose=False, **tkw)

    # sample particles from the DMO enclosed-mass CDF around each halo
    rng = np.random.default_rng(seed)
    hx = rng.uniform(0, L, (n_halo, 3))
    hM = 10 ** rng.uniform(M_range[0], M_range[1], n_halo)
    r_s = np.geomspace(1e-3, 60, 2048)
    rho_all = np.clip(DMO.real(cosmo, r_s, hM, 1.0).cpu().numpy(), 0, None)
    parts, mass = [], []
    for j in range(n_halo):
        Menc = np.cumsum(4 * np.pi * r_s**3 * rho_all[j]
                         * np.gradient(np.log(r_s)))
        n_p = max(2000, int(hM[j] / part_mass))
        rr = np.interp(rng.uniform(0, 1, n_p), Menc / Menc[-1], r_s)
        dirs = rng.normal(size=(n_p, 3))
        dirs /= np.linalg.norm(dirs, axis=1)[:, None]
        parts.append(np.mod(hx[j] + rr[:, None] * dirs, L))
        mass.append(np.full(n_p, Menc[-1] / n_p))
    xyz = np.concatenate(parts)
    pm = np.concatenate(mass)

    snap = T.ParticleSnapshot(x=xyz[:, 0], y=xyz[:, 1], z=xyz[:, 2], M=pm,
                              L=L, redshift=0.0, cosmo=cd)
    cat = T.HaloNDCatalog(x=hx[:, 0], y=hx[:, 1], z=hx[:, 2], M=hM,
                          redshift=0.0, cosmo=cd)
    new_cat = T.BaryonifySnapshot(cat, snap, epsilon_max=epsilon_max,
                                  model=disp, precision="float64",
                                  verbose=False, device=device).process()

    def pk_of(c):
        s = T.ParticleSnapshot(x=c['x'], y=c['y'], z=c['z'], M=c['M'], L=L,
                               redshift=0.0, cosmo=cd)
        grid = s.make_map(n_grid)
        delta = grid / grid.mean() - 1
        return T.ops.spectra.power_spectrum_3d(delta, L, n_bins=n_bins,
                                               device=device)

    k, pk0, _ = pk_of(snap.cat)
    _, pk1, _ = pk_of(new_cat)
    k, pk0, pk1 = (x.cpu().numpy() for x in (k, pk0, pk1))
    S_meas = pk1 / pk0
    uD = T.analysis.profile_uk(DMO, cosmo, hM, 1.0, k).cpu().numpy()
    uB = T.analysis.profile_uk(DMB, cosmo, hM, 1.0, k).cpu().numpy()
    rho_bar = pm.sum() / L**3
    S_pred = 1 + (uB**2 - uD**2).sum(axis=0) / (rho_bar**2 * L**3) / pk0
    return k, S_meas, S_pred


def box_window(k, S_meas, S_pred):
    """(RMS, largest suppression, bins) in the examples' window: k index
    >= 6 and k <= 1.2 1/Mpc."""
    win = (np.arange(len(k)) >= 6) & (k <= 1.2)
    diff = S_meas[win] - S_pred[win]
    return (float(np.sqrt(np.mean(diff**2))), float(1 - S_meas[win].min()),
            int(win.sum()))


def pk_path(T, torch, device):
    """examples/10 and 12 on the card: Part A (the halo-model suppression
    against the 15 scraped Schneider+19 Fig. 2 curves, the example's
    bars), Part B (the S19 mock box: table, BaryonifySnapshot in float64
    under ``auto`` = cell-major, power_spectrum_3d) and example 12's
    Arico20 box (an Rdelta-sampled table, eps_max 2: the pass's
    use_rdelta branch). Returns the launch counts of the boxes."""
    t0 = time.perf_counter()
    rms = fig2_rms(T, device)
    torch.cuda.synchronize()
    overall = float(np.sqrt(np.mean([v**2 for v in rms.values()])))
    worst = max(rms, key=rms.get)
    log(f"pk: Part A, pk_suppression on {device} against the 15 scraped "
        f"curves in {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{t} {v:.4f}" for t, v in rms.items())
        + f"; overall RMS {overall:.4f} (bars {FIG2_TOL} a curve, "
        f"{FIG2_TOL_OVERALL} overall), worst {worst}")
    reset_counts()
    boxes = {}
    cosmo12 = T.Cosmology.from_dict(COSMO, device=device)
    A20 = T.profiles.Arico20
    for name, kw in (
            ("ex10", {}),
            ("ex12", dict(model_pair=(A20.DarkMatterOnly(**APAR),
                                      A20.DarkMatterBaryon(**APAR)),
                          cosmo=cosmo12, epsilon_max=2, seed=13,
                          table_kwargs=dict(M_min=1e12, M_max=1e16,
                                            N_samples_Mass=16, R_min=1e-3,
                                            R_max=30, N_samples_R=1500,
                                            Rdelta_sampling=True)))):
        t0 = time.perf_counter()
        k, S_meas, S_pred = box_crosscheck(T, device, **kw)
        torch.cuda.synchronize()
        boxes[name] = box_window(k, S_meas, S_pred)
        r, supp, n = boxes[name]
        log(f"pk: {name} mock box (table, BaryonifySnapshot float64 auto, "
            f"make_map, power_spectrum_3d on {device}) in "
            f"{time.perf_counter() - t0:.2f} s: {n} bins in the window, "
            f"measured vs predicted RMS {r:.4f} (bar {BOX_RMS_TOL}), largest "
            f"suppression {100 * supp:.1f}% (bar {100 * BOX_SUPP[name]:.0f}%)")
    counts = read_counts("pk path (mock boxes, auto = cellmajor)", [])
    # every reading is logged before any is checked
    for tag, v in rms.items():
        check(v < FIG2_TOL, f"pk: Fig. 2 curve {tag}: RMS {v:.4f}")
    check(overall < FIG2_TOL_OVERALL, f"pk: Fig. 2 overall RMS {overall:.4f}")
    for name, (r, supp, _) in boxes.items():
        check(r < BOX_RMS_TOL, f"pk: {name} box RMS {r:.4f}")
        check(supp > BOX_SUPP[name], f"pk: {name} box suppression {supp:.4f}")
    return counts


# ----- the differentiable shell path: the grad and fit phases -----

# examples/14_gradient_fit_Mc.py's truth and start in ln M_c
LN_MC_TRUE = float(np.log(10 ** 13.8))
LN_MC_START = float(np.log(10 ** 14.4))
# the full-width gradient against central differences: the JAX package's
# map-level bar (tests/test_grad.py:697), or tests/test_grad.py:121's where
# the regrid's floor() kinks make the differences depend on their step
GRAD_FD_BAR = 2e-3
GRAD_FD_KINK_BAR = 5e-2
GRAD_FD_STEPS = (1e-2, 3e-3, 1e-3)
# the adjoint and second-order kernels against their plain versions, of
# the plain result's largest value: float64 to rounding; float32 sums its
# rows with atomics in no fixed order, as the plain version sums them in
# another
ADJ_BAR = {"float64": 1e-10, "float32": 1e-4}
# operations of a slot inside its disc in the adjoint (counted as
# CM_READ_FLOPS is: a sqrt, exp or division one) from
# csrc/cellmajor_pass.cu adjoint_slot: the row lerp (4), the offsets
# derivative in closed form (offsets_vjp, 48) or exp and the cotangent's
# product (paint, 2), the two lerp weights and the two adds; and in the
# second-order entry, which carries Dual<Dual<T>> through the forward's
# arithmetic, each dual operation by its float operations (a Dual<T>
# product 3, a quotient 4, a square root 3; Dual<Dual<T>> about three
# times Dual<T>) with the lerp of u. The tests before it are the forward's
CM_ADJ_FLOPS = {"offsets": 56, "paint": 10}
CM_ADJ2_FLOPS = {"offsets": 330, "paint": 24}
ADJOINT = ("cellmajor_vjp", "cellmajor_vjp2")
# no TPU kernel: the JAX package differentiates cellmajor_offsets_pass
# (this line) with XLA autodiff, jax.grad for the adjoint and jax.hessian
# for the second order
ADJ_REPLACES = "baryonification_tpu/runners/shell_cellmajor.py:255"


def grid_points(grid):
    """The (z, M, r) sample points of a setup_interpolator grid."""
    return (np.geomspace(grid["z_min"], grid["z_max"], grid["N_samples_z"]),
            np.geomspace(grid["M_min"], grid["M_max"],
                         grid["N_samples_Mass"]),
            np.geomspace(grid["R_min"], grid["R_max"], grid["N_samples_R"]))


def table_of(T, cosmo, grid, par, dim=2, eps=EPS_MAX):
    """The Baryonification2D (``dim`` 3: 3D) table of the profile
    parameters ``par`` (tensors carry their graph) at ``grid``'s points,
    (z, M, r), through build_table_device."""
    z, M, r = grid_points(grid)
    cls = T.Baryonification2D if dim == 2 else T.Baryonification3D
    m = cls(T.DarkMatterOnly(**par), T.DarkMatterBaryon(**par), cosmo,
            epsilon_max=eps)
    return m.build_table_device(z, M, r).reshape(len(z), len(M), len(r))


def on_card(x):
    if isinstance(x, (tuple, list)):
        return any(on_card(v) for v in x)
    return getattr(x, "is_cuda", False)


# the regrid's plain adjoint called on the card under create_graph (the
# declared route of its autograd Function's backward), by name
CREATE_GRAPH_PLAIN = []


@contextlib.contextmanager
def plain_on_card(cmc, sc=None):
    """Names of the cell-major and regrid plain versions (and with ``sc``
    the scatter's) called on CUDA tensors in the block (a path on the
    card must call none). The regrid's plain adjoint called with grad
    mode on is its Function's backward under create_graph, the one
    declared route of a plain version on the card: it goes to
    CREATE_GRAPH_PLAIN instead."""
    import torch
    from baryonification_tpu_torch.ops import regrid_cuda as rc
    calls = []
    spies = [(cmc, name) for name in ("cellmajor_pass_reference",
                                      "cellmajor_vjp_reference",
                                      "cellmajor_vjp2_reference")]
    spies += [(rc, "regrid_shell_reference")]
    if sc is not None:
        spies += [(sc, "scatter_add_accum_reference"),
                  (sc, "scatter_add_vjp_reference")]
    with contextlib.ExitStack() as stack:
        for module, name in spies:
            stack.enter_context(spied(
                module, name,
                lambda args, name=name: calls.append(name)
                if on_card(args) else None))
        name = "regrid_vjp_reference"
        stack.enter_context(spied(
            rc, name, lambda args: (
                CREATE_GRAPH_PLAIN if torch.is_grad_enabled() else calls
            ).append(name) if on_card(args) else None))
        # the grid, anisotropic and snapshot passes' step loop (their
        # kernels' plain version) on a bucket that runs its kernels there
        from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
        for name in ("_bucket_pass", "_bucket_vjp"):
            stack.enter_context(spied(
                tgcm, name, lambda args, name=name: calls.append(name)
                if tgcm._on_kernel(args[0], args[1]) else None))
        yield calls


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms for the block: the regrid then takes its
    deterministic route on the card (each pixel's rows summed in the
    order of their keys)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def bucket_inputs(T, torch, runner, table):
    """The cell-major pass's inputs of each bucket of a staged shell
    runner, as process_device() makes them from ``table``:
    [dict(pix, dense, counts, F, recs, rows, g0, dg, rad_hi)]."""
    from baryonification_tpu_torch.runners import shell_cellmajor as tcm
    dt, dev = runner.dtype, runner.device
    nside = runner.LightconeShell.NSIDE
    arrs = runner._halo_arrays(T.Cosmology.from_dict(COSMO, device=dev))
    packed_all = runner._packed_records(arrs, dt)
    pix = runner._pixels_nested(nside, dt)
    grids = tuple(g.to(dev, dt) for g in runner.model._grids)
    t = table.detach().to(dev, dt)
    t = torch.where(torch.isfinite(t), t, 0.0)
    g2 = runner.model._grids[2].cpu().numpy()
    gh = grids[2].cpu()
    out = []
    for bi, (nside_c, jidx, r_b, rcm_max) in enumerate(
            runner._cm_groups(arrs, nside)):
        dense, counts, K, nsc = runner._dense_candidates(
            bi, nside_c, lambda jidx=jidx: {
                k: arrs[k][jidx].to(dt) for k in ('theta', 'phi', 'radius')},
            r_b)
        n_hi = runner._node_bound(g2, np.log(EPS_MAX * rcm_max), len(g2))
        packed = packed_all[jidx]
        out.append(dict(pix=pix, dense=dense, counts=counts,
                        F=(nside // nsc) ** 2,
                        recs=tcm.slot_records(packed, EPS_MAX),
                        rows=tcm.halo_rows(grids, t, packed, n_hi),
                        g0=float(gh[0]), dg=float(gh[1] - gh[0]),
                        rad_hi=float(gh[n_hi - 1])))
    return out


def timed(torch, fn):
    """(fn(), its milliseconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cell_range(c, n_pix):
    """The bucket inputs ``c`` cut to its first cells, about ``n_pix``
    pixels (whole cells): a part of the bucket that the plain double
    backward runs in seconds."""
    ncell = c["counts"].shape[0]
    n = max(1, min(ncell, n_pix // c["F"]))
    k_pad = c["dense"].shape[0] // ncell
    return dict(c, pix=tuple(v[:n * c["F"]] for v in c["pix"]),
                dense=c["dense"][:n * k_pad], counts=c["counts"][:n])


def pass_args(c):
    return (c["pix"], c["dense"], c["counts"], c["F"], c["recs"], c["rows"],
            c["g0"], c["dg"], c["rad_hi"])


def rel_err(got, want):
    """max|got - want| / max|want| over tensors (or tuples of them)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / \
        max(scale, 1e-300), scale


def adjoint_inputs(torch, c, seed=0):
    """Seeded random cotangent planes (offsets mode) and row direction u
    for the adjoint entries on the bucket inputs ``c``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = c["rows"]
    rnd = lambda shape: torch.randn(shape, generator=gen,
                                    dtype=torch.float64).to(rows)
    g = tuple(rnd(c["pix"][0].shape) for _ in range(3))
    return g, rnd(rows.shape)


def queued_ms(torch, fn, n_iter):
    """Mean milliseconds of fn() over n_iter launches by CUDA events, the
    launches queued behind a wait on the card (torch.cuda._sleep), so that
    the host's time between them does not count: the device's time, also
    where a launch takes less than its host call."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)       # ~20 ms at the card's clock
    start.record()
    for _ in range(n_iter):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter


def adjoint_tally(torch, cmc, c):
    """The adjoint kernel's own counts (cmc.TALLY: the slot-pixels that
    add to the rows, the global atomics made) of one offsets launch on
    the bucket inputs ``c``, or None for a package whose kernel does not
    count."""
    if not hasattr(cmc, "TALLY"):
        return None
    g, _ = adjoint_inputs(torch, c)
    tally = torch.zeros(len(cmc.TALLY), dtype=torch.int64,
                        device=c["rows"].device)
    cmc._launch_adjoint("cellmajor_vjp", "offsets", g, None, *pass_args(c),
                        tally=tally)
    return dict(zip(cmc.TALLY, (int(v) for v in tally.cpu())))


def check_adjoint(torch, cmc, c, dname, entry, label="grad", seed=0):
    """Kernel ``entry`` (cellmajor_vjp or cellmajor_vjp2) against its
    plain version on the bucket inputs ``c`` (offsets mode) with seeded
    random cotangents (and row direction), every output to ADJ_BAR of
    its largest plain value and finite. Returns (max absolute error,
    kernel ms on the device (queued_ms), plain ms)."""
    g, u = adjoint_inputs(torch, c, seed)
    args = pass_args(c)
    if entry == "cellmajor_vjp":
        k_fn = lambda: cmc.cellmajor_vjp("offsets", g, *args)
        p_fn = lambda: cmc.cellmajor_vjp_reference("offsets", g, *args)
    else:
        k_fn = lambda: cmc.cellmajor_vjp2("offsets", g, u, *args)
        p_fn = lambda: cmc.cellmajor_vjp2_reference("offsets", g, u, *args)
    got = k_fn()
    want, ms_p = timed(torch, p_fn)
    if entry == "cellmajor_vjp2":
        got, want = (got[1],) + got[0], (want[1],) + want[0]
    err, scale = rel_err(got, want)
    finite = all(bool(torch.isfinite(x).all())
                 for x in (got if isinstance(got, tuple) else (got,)))
    log(f"{label}: {entry} offsets {dname} vs its plain version: max|err| / "
        f"max|plain| = {err:.3e} (max|plain| {scale:.3e}; bar "
        f"{ADJ_BAR[dname]:g})")
    check(finite and err <= ADJ_BAR[dname],
          f"{entry} {dname} disagrees with its plain version: {err:.3e}")
    ms_k = queued_ms(torch, k_fn, 5)
    return err * scale, ms_k, ms_p


def adjoint_bound(c, census, dname, flops_inside):
    """(ms, 'operations' or 'bytes') of one adjoint entry on bucket ``c``:
    the forward's tests for every slot-pixel (CM_ANG_FLOPS, and
    CM_DISC_FLOPS past the angular test) and ``flops_inside`` for each
    slot inside its disc; bytes: the pixel and cotangent planes, the
    candidate lists, the records and the rows read once, the rows'
    gradient written once."""
    t = 8 if dname == "float64" else 4
    npix, ncell = c["pix"][0].shape[0], c["counts"].shape[0]
    H, n_hi = c["rows"].shape
    flops = (census["slots"] * CM_ANG_FLOPS
             + census["angular"] * CM_DISC_FLOPS["offsets"]
             + census["inside"] * flops_inside)
    n_bytes = (npix * 6 * t + ncell * 4 + int(c["counts"].sum()) * 4
               + H * c["recs"].shape[1] * t + 2 * H * n_hi * t)
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes")), flops, n_bytes


def grad_path(T, torch, cmc, device, n_halo, nside, issue_bound=False):
    """bench.py's shell (NSIDE 1024, 1e6 halos, seed 7, eps_max 20) and
    BENCH_GRID table: chi^2 = sum (map(ln M_c) - map(ln M_c,true))^2
    through build_table_device -> process_device, with example 14's truth
    and start. A cold and a warm value_and_grad in float32 (the path's
    run: launches, forward and backward seconds, peak memory,
    registrations in the warm step), the float64 gradient against central
    differences at three steps, float32 against float64;
    process_device == process() bit for bit in both precisions; the
    adjoint kernel against its plain version at the largest bucket, and
    the second-order kernel on 2^20 pixels of the smallest, in both
    precisions. At the largest bucket also the adjoint's census and its
    own counts of the slot-pixels that add and of its global atomics
    (adjoint_tally), the forward kernel's time on the same inputs, and
    with ``issue_bound`` its issue bound from the SASS of this build
    (adjoint_sass). Returns the kernels-line record of cellmajor_vjp."""
    from baryonification_tpu_torch.runners import shell_cellmajor as tcm
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    model = model_for(T, device, BENCH_GRID)
    cat, shell = catalog(T, n_halo, nside)
    f64 = dict(dtype=torch.float64, device=device)
    runners = {p: T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                                   model=model, verbose=False, device=device,
                                   precision=p, method="cellmajor")
               for p in ("float32", "float64")}
    tab = lambda x: table_of(T, cosmo, BENCH_GRID,
                             dict(PAR, M_c=torch.exp(x)))
    with torch.no_grad():
        truth = tab(torch.tensor(LN_MC_TRUE, **f64))

    def chi2(p, x, target):
        m = runners[p].process_device(tab(x)).to(torch.float64)
        return ((m - target) ** 2).sum()

    def value_and_grad(p, target):
        x = torch.tensor(LN_MC_START, **f64, requires_grad=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = chi2(p, x, target)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (g,) = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        return (float(loss.detach()), float(g), t1 - t0,
                time.perf_counter() - t1)

    # the path's run: float32, a cold then a warm step
    regs = []
    reset_counts()
    with plain_on_card(cmc) as plain, spied(tcm, "coarse_halo_index",
                                            regs.append):
        with torch.no_grad():
            target32 = runners["float32"].process_device(truth).double()
        regs_cold = len(regs)
        cold = value_and_grad("float32", target32)
        regs.clear()
        torch.cuda.reset_peak_memory_stats()
        warm = value_and_grad("float32", target32)
        peak = torch.cuda.max_memory_allocated() / 2**30
        regs_warm = len(regs)
    launches = read_counts("grad (value_and_grad, float32)",
                           ("cellmajor_pass", "cellmajor_vjp", "regrid",
                            "regrid_vjp"))
    check(not plain, f"grad: plain versions ran on the card: {plain}")
    check(regs_warm == 0, f"grad: the warm step registered {regs_warm} "
          f"buckets")
    log(f"grad: NSIDE {nside}, {n_halo} halos, BENCH_GRID table "
        f"{tuple(truth.shape)}: chi2 at ln M_c = {LN_MC_START:.4f} "
        f"{warm[0]:.6e}, d chi2 / d ln M_c = {warm[1]:.6e} (float32 map); "
        f"cold step forward {cold[2]:.3f} s, backward {cold[3]:.3f} s "
        f"({regs_cold} registrations before it, in the truth's map); "
        f"warm step forward {warm[2]:.3f} s, backward {warm[3]:.3f} s, "
        f"peak memory {peak:.2f} GiB, registrations {regs_warm}; "
        f"launches {launches}")

    # float64: the gradient against central differences
    with torch.no_grad():
        target64 = runners["float64"].process_device(truth).double()
    value_and_grad("float64", target64)
    v64 = value_and_grad("float64", target64)
    g64 = v64[1]
    fds = []
    with torch.no_grad():
        for h in GRAD_FD_STEPS:
            fp = float(chi2("float64", torch.tensor(LN_MC_START + h, **f64),
                            target64))
            fm = float(chi2("float64", torch.tensor(LN_MC_START - h, **f64),
                            target64))
            fds.append((fp - fm) / (2 * h))
    spread = (max(fds) - min(fds)) / abs(fds[-1])
    kinks = spread > GRAD_FD_BAR
    bar = GRAD_FD_KINK_BAR if kinks else GRAD_FD_BAR
    errs = [abs(g64 - fd) / abs(fd) for fd in fds]
    log(f"grad: float64 d chi2 / d ln M_c = {g64:.10e} (warm step forward "
        f"{v64[2]:.3f} s, backward {v64[3]:.3f} s); central differences "
        + ", ".join(f"h={h:g}: {fd:.10e} (rel {e:.3e})"
                    for h, fd, e in zip(GRAD_FD_STEPS, fds, errs))
        + f"; spread of the differences {spread:.3e}: "
        + ("they depend on their step (the regrid's kinks), held at "
           if kinks else "held at ") + f"{bar:g}")
    check(np.isfinite(g64) and g64 != 0 and max(errs) <= bar,
          f"grad: float64 gradient {g64!r} against central differences "
          f"{fds} (bar {bar})")
    rel32 = abs(warm[1] - g64) / abs(g64)
    log(f"grad: float32 gradient {warm[1]:.10e}, {rel32:.3e} from float64")

    # process_device is process(), bit for bit
    for p, r in runners.items():
        with deterministic(torch):
            want = r.process()
            got = r.process_device()
        same = np.array_equal(got.to(torch.float64).cpu().numpy(), want)
        log(f"grad: process_device() {p} == process() bit for bit "
            f"(deterministic algorithms): {same}")
        check(same, f"grad: process_device() {p} differs from process()")

    # the kernels against their plain versions, at the path's buckets
    rec = dict(name="cellmajor_vjp", route="cuda",
               source="baryonification_tpu_torch/csrc/cellmajor_pass.cu",
               replaces=ADJ_REPLACES, library_ms=None)
    sass = adjoint_sass() if issue_bound else None
    for p in ("float32", "float64"):
        with torch.no_grad():
            table = tab(torch.tensor(LN_MC_START, **f64))
        buckets = bucket_inputs(T, torch, runners[p], table)
        size = [int(c["counts"].sum()) * c["F"] for c in buckets]
        big = buckets[int(np.argmax(size))]
        small = buckets[int(np.argmin([s if s else 1 << 62
                                       for s in size]))]
        err, ms_k, ms_p = check_adjoint(torch, cmc, big, p, "cellmajor_vjp")
        planes = tuple(torch.zeros_like(big["pix"][0]) for _ in range(3))
        ms_f = queued_ms(torch, lambda: cmc.cellmajor_pass(
            "offsets", planes, *pass_args(big)), 5)
        census = slot_census(torch, cmc, big, "offsets")
        (bound, by), flops, n_bytes = adjoint_bound(
            big, census, p, CM_ADJ_FLOPS["offsets"])
        log(f"grad: cellmajor_vjp offsets {p} at the largest bucket "
            f"(F={big['F']}, H={big['rows'].shape[0]}, "
            f"n_hi={big['rows'].shape[1]}, {census['slots']:.4e} "
            f"slot-pixels, {census['angular']:.4e} passing the angular "
            f"test, {census['inside']:.4e} inside their disc"
            + (f", {census['culled_patches']} of {census['patches']} "
               f"patch-slots culled" if census["P"] else "") + "): "
            f"kernel {ms_k:.4f} ms, the forward kernel {ms_f:.4f} ms on the "
            f"same inputs, plain {ms_p:.2f} ms; bound {bound:.4f} ms by {by}"
            f" ({flops:.3e} operations, {n_bytes / 1e6:.1f} MB); kernel at "
            f"{100 * bound / ms_k:.1f}% of the bound")
        tally = adjoint_tally(torch, cmc, big)
        if tally is not None:
            adds = tally["adds"]
            gap = abs(adds - census["inside"]) / census["inside"]
            log(f"grad: cellmajor_vjp offsets {p}: the kernel's count of "
                f"slot-pixels that add {adds} (the census's inside "
                f"{census['inside']}, {gap:.2e} apart); global atomics a "
                f"launch: the first design's two a slot-pixel that adds "
                f"{2 * adds:.4e}, this kernel's {tally['atomics']:.4e} "
                f"({tally['atomics'] / max(2 * adds, 1):.4f} of those)")
            check(gap <= 1e-4, f"grad: the adjoint adds {adds} slot-pixels,"
                  f" the census finds {census['inside']} inside")
        if sass and census["P"]:
            g_big = adjoint_inputs(torch, big)[0]
            cellmajor_issue_bound(
                torch, "offsets", p, census, sass[p],
                lambda: cmc.cellmajor_vjp("offsets", g_big, *pass_args(big)),
                ms_k, name="cellmajor_vjp", label="grad")
        if p == "float32":
            rec.update(max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                       bound_ms=bound, bound_by=by, forward_ms=ms_f)
        part = cell_range(small, 1 << 20)
        err2, ms2, ms2p = check_adjoint(torch, cmc, part, p,
                                        "cellmajor_vjp2")
        log(f"grad: cellmajor_vjp2 offsets {p} on the first "
            f"{part['counts'].shape[0]} cells of the smallest bucket "
            f"(F={part['F']}, {int(part['counts'].sum()) * part['F']:.4e}"
            f" slot-pixels): kernel {ms2:.4f} ms, plain {ms2p:.2f} ms")
    return rec


def ex_shell(T, device, seed, n_halo, nside):
    """The mock catalog and shell of examples 14, 16 (seed 7, NSIDE 32,
    30 halos) and 18 (seed 12, NSIDE 16, 15 halos)."""
    rng = np.random.default_rng(seed)
    cat = T.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n_halo),
        dec=np.degrees(np.arcsin(rng.uniform(-0.85, 0.85, n_halo))),
        M=10 ** rng.uniform(13.8, 14.9, n_halo),
        z=rng.uniform(0.15, 0.45, n_halo), cosmo=COSMO)
    shell = T.LightconeShell(map=rng.uniform(0.5, 1.5, 12 * nside ** 2),
                             cosmo=COSMO)
    return cat, shell


def ex_runner(T, device, grid, par, seed, n_halo, nside):
    """An example's staged runner: cell-major, float64, on the card, its
    model's table set up at the fiducial parameters."""
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    model = T.Baryonification2D(T.DarkMatterOnly(**par),
                                T.DarkMatterBaryon(**par), cosmo,
                                epsilon_max=EPS_MAX)
    model.setup_interpolator(**grid)
    cat, shell = ex_shell(T, device, seed, n_halo, nside)
    return T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                            method="cellmajor", verbose=False,
                            device=device, precision="float64"), cosmo


# example 18's Fisher forecast at the truth in the JAX package (its maps'
# central differences, CPU float64; tests/test_torch_fisher.py holds the
# port's to it): the example's own assert |corr| > 0.3 fails there too
# (ROADMAP C5), so the port is held to these values instead, to 1e-3
EX18_JAX_CORR = -0.188734
EX18_JAX_SIGMA = {"ln_Mc": 72.6890, "sigma8": 151.924}
# examples 14 and 16's table grid, and example 18's
EX14_GRID = dict(z_min=0.1, z_max=0.5, N_samples_z=3, M_min=1e13,
                 M_max=1e15, N_samples_Mass=6, R_min=1e-3, R_max=70,
                 N_samples_R=48)
EX18_GRID = dict(z_min=0.1, z_max=0.5, N_samples_z=2, M_min=1e13,
                 M_max=1e15, N_samples_Mass=5, R_min=1e-3, R_max=70,
                 N_samples_R=44)


def example14(T, torch, device):
    """examples/14_gradient_fit_Mc.py through the port, with its asserts.
    Returns (runner, the table at the fit, Adam seconds a step)."""
    runner, cosmo = ex_runner(T, device, EX14_GRID, PAR, 7, 30, 32)
    f64 = dict(dtype=torch.float64, device=device)
    tab = lambda x: table_of(T, cosmo, EX14_GRID, dict(PAR, M_c=torch.exp(x)))
    with torch.no_grad():
        target = runner.process_device(tab(torch.tensor(LN_MC_TRUE, **f64)))
    chi2 = lambda x: ((runner.process_device(tab(x)) - target) ** 2).sum() \
        * 1e6

    def value_and_grad(x0):
        x = torch.tensor(x0, **f64, requires_grad=True)
        v = chi2(x)
        return float(v.detach()), float(torch.autograd.grad(v, x)[0])

    _, g_true = value_and_grad(LN_MC_TRUE)
    c0, g_start = value_and_grad(LN_MC_START)
    log(f"fit: ex14: grad at truth {g_true:+.3e}, at start {g_start:+.3e}, "
        f"chi2 start {c0:.4e}")
    check(abs(g_true) < 0.05 * abs(g_start),
          "ex14: the gradient at the truth is not ~0")
    check(g_start * (LN_MC_START - LN_MC_TRUE) > 0,
          "ex14: the gradient at the start does not point to the truth")
    t0 = time.perf_counter()
    res = T.fit(chi2, torch.tensor(LN_MC_START, **f64), steps=25,
                learning_rate=0.15)
    per_step = (time.perf_counter() - t0) / 25
    err = abs(float(res.params) - LN_MC_TRUE)
    off0 = abs(LN_MC_START - LN_MC_TRUE)
    log(f"fit: ex14: ln M_c {float(res.params):.4f} (truth "
        f"{LN_MC_TRUE:.4f}; residual {err / off0:.1%} of the offset), chi2 "
        f"{c0:.4e} -> {res.loss:.4e} ({c0 / max(res.loss, 1e-300):.1f}x); "
        f"{per_step:.3f} s an Adam step")
    check(err < 0.05 * off0, "ex14: M_c not recovered")
    check(res.loss < c0 / 100, "ex14: chi2 did not drop 100x")
    _, sigma = T.laplace_covariance(chi2, res.params)
    sigma = float(sigma)
    log(f"fit: ex14: Laplace 1-sigma on ln M_c {sigma:.2e}")
    check(np.isfinite(sigma) and sigma > 0, "ex14: Laplace sigma")
    with torch.no_grad():
        table = tab(res.params.to(device))
    return runner, table, per_step


def example16(T, torch, device):
    """examples/16_joint_fit_Mc_thetaej.py through the port, with its
    asserts. Returns Adam seconds a step."""
    runner, cosmo = ex_runner(T, device, EX14_GRID, PAR, 7, 30, 32)
    f64 = dict(dtype=torch.float64, device=device)
    truth = {"lnMc": float(np.log(10 ** 13.8)), "ln_tej": float(np.log(4.0))}
    start = {"lnMc": float(np.log(10 ** 14.3)),
             "ln_tej": float(np.log(6.0))}
    tab = lambda p: table_of(T, cosmo, EX14_GRID, dict(
        PAR, M_c=torch.exp(p["lnMc"]), theta_ej=torch.exp(p["ln_tej"])))
    with torch.no_grad():
        target = runner.process_device(tab(
            {k: torch.tensor(v, **f64) for k, v in truth.items()}))
    chi2 = lambda p: ((runner.process_device(tab(p)) - target) ** 2).sum() \
        * 1e6
    t0 = time.perf_counter()
    res = T.fit(chi2, {k: torch.tensor(v, **f64) for k, v in start.items()},
                steps=40, learning_rate=0.12)
    per_step = (time.perf_counter() - t0) / 40
    c0, c_fin = res.history[0], res.loss
    err_tej = abs(float(res.params["ln_tej"]) - truth["ln_tej"])
    off_tej = abs(start["ln_tej"] - truth["ln_tej"])
    cov, sigma = T.laplace_covariance(chi2, res.params)
    corr = float(cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1]))
    sig = {k: float(v) for k, v in sigma.items()}
    resid = {k: abs(float(res.params[k]) - truth[k]) for k in truth}
    log(f"fit: ex16: chi2 {c0:.3e} -> {c_fin:.3e} ({c0 / c_fin:.0f}x); ln "
        f"theta_ej residual {err_tej / off_tej:.1%} of the offset; Laplace "
        f"sigma(ln M_c) {sig['lnMc']:.2f}, sigma(ln theta_ej) "
        f"{sig['ln_tej']:.2f}, corr {corr:+.3f}; residuals "
        + ", ".join(f"{k} {resid[k]:.3f} (3 sigma {3 * sig[k]:.3f})"
                    for k in truth) + f"; {per_step:.3f} s an Adam step")
    check(c_fin < c0 / 100, "ex16: chi2 did not drop 100x")
    check(err_tej < 0.25 * off_tej, "ex16: theta_ej not recovered")
    check(corr < -0.5, "ex16: the M_c-theta_ej degeneracy not flagged")
    for k in truth:
        check(resid[k] < 3.0 * sig[k], f"ex16: {k} residual outside 3 sigma")
    return per_step


def example18(T, torch, device):
    """examples/18_cosmo_baryon_fisher.py through the port (sigma8 through
    cosmology_device, ln M_c), with its asserts; the fourth (|corr| >
    0.3), which the JAX package fails too, is held to the JAX package's
    Fisher forecast instead (EX18_JAX_CORR, EX18_JAX_SIGMA)."""
    par = T.default_params()
    runner, _ = ex_runner(T, device, EX18_GRID, par, 12, 15, 16)
    f64 = dict(dtype=torch.float64, device=device)
    truth = dict(sigma8=0.8, ln_Mc=float(np.log(10 ** 13.8)))
    start = dict(sigma8=0.85, ln_Mc=float(np.log(10 ** 14.1)))

    def tab(p):
        c = T.cosmology_device({**COSMO, "sigma8": p["sigma8"]},
                               device=device)
        return table_of(T, c, EX18_GRID, dict(par, M_c=torch.exp(p["ln_Mc"])))

    with torch.no_grad():
        target = runner.process_device(tab(
            {k: torch.tensor(v, **f64) for k, v in truth.items()}))
    chi2 = lambda p: ((runner.process_device(tab(p)) - target) ** 2).sum() \
        * 1e8

    def grad(at):
        x = {k: torch.tensor(v, **f64, requires_grad=True)
             for k, v in at.items()}
        gs = torch.autograd.grad(chi2(x), list(x.values()))
        return {k: float(g) for k, g in zip(x, gs)}

    g = grad(start)
    for key, eps in (("sigma8", 2e-4), ("ln_Mc", 1e-3)):
        with torch.no_grad():
            fp = float(chi2({k: torch.tensor(v + (eps if k == key else 0),
                                             **f64)
                             for k, v in start.items()}))
            fm = float(chi2({k: torch.tensor(v - (eps if k == key else 0),
                                             **f64)
                             for k, v in start.items()}))
        fd = (fp - fm) / (2 * eps)
        rel = abs(g[key] - fd) / abs(fd)
        log(f"fit: ex18: d chi2/d{key} {g[key]:+.5e}, central difference "
            f"{fd:+.5e}, rel {rel:.2e}")
        check(rel < 5e-3, f"ex18: FD parity failed for {key}: {rel}")
    g0 = grad(truth)
    for key in truth:
        ratio = abs(g0[key]) / abs(g[key])
        log(f"fit: ex18: grad at truth / grad at start for {key}: "
            f"{ratio:.3e}")
        check(ratio < 0.05, f"ex18: the truth is not stationary in {key}")
    cov, sigma = T.laplace_covariance(
        chi2, {k: torch.tensor(v, **f64) for k, v in truth.items()})
    corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    log(f"fit: ex18: Fisher sigma(ln M_c) {float(sigma['ln_Mc']):.4f}, "
        f"sigma(sigma8) {float(sigma['sigma8']):.5f}, corr {corr:+.3f}")
    check(np.all(np.isfinite(cov)), "ex18: non-finite Fisher covariance")
    check(float(sigma["ln_Mc"]) > 0 and float(sigma["sigma8"]) > 0,
          "ex18: Fisher sigmas not positive")
    log(f"fit: ex18: the JAX package's corr {EX18_JAX_CORR:+.6f}, sigmas "
        f"{EX18_JAX_SIGMA} (the example's |corr| > 0.3 fails there too)")
    check(abs(corr - EX18_JAX_CORR) < 1e-3 and all(
        abs(float(sigma[k]) / v - 1) < 1e-3
        for k, v in EX18_JAX_SIGMA.items()),
        f"ex18: the Fisher forecast differs from the JAX package's: corr "
        f"{corr}, sigmas {sigma}")


def fit_path(T, torch, cmc, device):
    """Examples 14, 16 and 18 through the port on the card in float64 at
    their own sizes, every assert of theirs (example 18's fourth held to
    the JAX package's value, see example18); their Laplace covariances
    run the second-order kernel. Then the second-order kernel against
    its plain version at example 14's largest bucket (the table at its
    fit). Returns the kernels-line record of cellmajor_vjp2."""
    reset_counts()
    t0 = time.perf_counter()
    n_graph = len(CREATE_GRAPH_PLAIN)
    with plain_on_card(cmc) as plain:
        runner, table, s14 = example14(T, torch, device)
        t14 = time.perf_counter() - t0
        s16 = example16(T, torch, device)
        t16 = time.perf_counter() - t0 - t14
        example18(T, torch, device)
    t18 = time.perf_counter() - t0 - t14 - t16
    read_counts("fit (examples 14, 16, 18)",
                ("cellmajor_pass",) + ADJOINT + ("regrid", "regrid_vjp"))
    check(not plain, f"fit: plain versions ran on the card: {plain}")
    n_graph = len(CREATE_GRAPH_PLAIN) - n_graph
    log(f"fit: the regrid's backward under create_graph (the Laplace "
        f"covariances' reverse over reverse) ran its plain closed form on "
        f"the card {n_graph} times, the declared route")
    check(n_graph > 0, "fit: no Laplace covariance took the regrid's "
          "create_graph route")
    log(f"fit: examples 14, 16, 18 passed every assert in {t14:.1f}, "
        f"{t16:.1f}, {t18:.1f} s; Adam {s14:.3f} s a step (ex14), "
        f"{s16:.3f} s a step (ex16)")
    buckets = bucket_inputs(T, torch, runner, table)
    c = buckets[int(np.argmax([int(b["counts"].sum()) * b["F"]
                               for b in buckets]))]
    err, ms_k, ms_p = check_adjoint(torch, cmc, c, "float64",
                                    "cellmajor_vjp2", label="fit")
    census = slot_census(torch, cmc, c, "offsets")
    (bound, by), flops, n_bytes = adjoint_bound(c, census, "float64",
                                                CM_ADJ2_FLOPS["offsets"])
    log(f"fit: cellmajor_vjp2 offsets float64 at example 14's largest bucket "
        f"(F={c['F']}, {census['slots']:.4e} slot-pixels, "
        f"{census['inside']:.4e} inside): kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.2f} ms; bound {bound:.6f} ms by {by}")
    return dict(name="cellmajor_vjp2", route="cuda",
                source="baryonification_tpu_torch/csrc/cellmajor_pass.cu",
                replaces=ADJ_REPLACES,
                library_ms=None, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                bound_ms=bound, bound_by=by)


# ----- the differentiable grid and snapshot paths: gradgrid, gradsnap,
# ex15 -----

# examples/15_gradient_fit_dPk.py: its truth, start, table grid and sizes
EX15_LN_MC_TRUE = float(np.log(10 ** 13.6))
EX15_LN_MC_START = float(np.log(10 ** 14.4))
EX15_Z = np.geomspace(0.2, 0.3, 2)
EX15_M = np.geomspace(1e13, 1e15, 6)
EX15_R = np.geomspace(1e-2, 40, 48)
EX15_SIZE = dict(L=120.0, n_part=30_000, n_halo=25, Ng=48, seed=4)


def ex15_box(L, n_part, n_halo, seed):
    """The example's mock DMO box, drawn in its order from one generator:
    (halo positions (n_halo, 3), halo masses, particle positions
    (n_part, 3)); half the particles clustered around the halos."""
    rng = np.random.default_rng(seed)
    hx = rng.uniform(0, L, (n_halo, 3))
    hM = 10 ** rng.uniform(14.0, 14.9, n_halo)
    n_clust = n_part // 2
    host = rng.choice(n_halo, n_clust, p=hM / hM.sum())
    r_nfw = 0.9 * rng.power(0.8, n_clust)[:, None]
    dirs = rng.normal(size=(n_clust, 3))
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pos = np.concatenate([np.mod(hx[host] + r_nfw * dirs * 3.0, L),
                          rng.uniform(0, L, (n_part - n_clust, 3))])
    return hx, hM, pos


def ex15_bands(L, Ng):
    """The example's seven k-band masks over the rfftn grid, (7, Ng^2
    (Ng/2 + 1)) float64."""
    kf = 2 * np.pi / L
    kx = np.fft.fftfreq(Ng, d=1.0 / Ng)
    k2 = (kx[:, None, None] ** 2 + kx[None, :, None] ** 2
          + np.fft.rfftfreq(Ng, d=1.0 / Ng)[None, None, :] ** 2)
    binid = np.digitize((np.sqrt(k2) * kf).ravel(),
                        np.linspace(1.5 * kf, 12 * kf, 8))
    return np.stack([(binid == i + 1).astype(np.float64) for i in range(7)])


def pk_bands(T, torch, L, Ng, dt, device):
    """Example 15's P(k): a function of particle positions (x, y, z) that
    gives the seven bands of the power of their CIC density on Ng^3
    cells (cic_deposit_3d in ``dt``, the scatter kernel on the card, then
    rfftn), each band's mean over its modes."""
    masks = torch.as_tensor(ex15_bands(L, Ng), dtype=dt, device=device)
    n_modes = masks.sum(-1).clamp(min=1)
    res = L / Ng

    def pk(x, y, z):
        rho = T.ops.scatter.cic_deposit_3d(
            Ng, x / res - 0.5, y / res - 0.5, z / res - 0.5,
            torch.ones_like(x), dtype=dt)
        delta = rho - rho.mean()
        pw = torch.fft.rfftn(delta).abs().reshape(-1) ** 2
        return (masks * pw).sum(-1) / n_modes

    return pk


def ex15_chain(T, torch, device, L, n_part, n_halo, Ng, seed,
               precision="float64"):
    """The example's chain through the port on ``device``: returns
    (table_of, ratio_of, runner). ``table_of(lnMc)`` is the
    Baryonification3D table of Schneider19 with CollisionlessMatter
    (r_steps 1500, max_iter 6) through build_table_device on the
    example's 2 x 6 x 48 grid; ``ratio_of(table)`` the seven binned P(k)
    bands of the displaced particles' CIC density (process_device ->
    cic_deposit_3d -> rfftn) over those of the undisplaced box."""
    hx, hM, pos = ex15_box(L, n_part, n_halo, seed)
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    snap = T.ParticleSnapshot(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                              M=np.ones(n_part), L=L, redshift=0.25,
                              cosmo=COSMO)
    cat = T.HaloNDCatalog(x=hx[:, 0], y=hx[:, 1], z=hx[:, 2], M=hM,
                          redshift=0.25, cosmo=COSMO)
    model0 = T.Baryonification3D(T.DarkMatterOnly(**PAR),
                                 T.DarkMatterBaryon(**PAR), cosmo,
                                 epsilon_max=10)
    model0.setup_interpolator(
        z_min=EX15_Z[0], z_max=EX15_Z[-1], N_samples_z=len(EX15_Z),
        M_min=EX15_M[0], M_max=EX15_M[-1], N_samples_Mass=len(EX15_M),
        R_min=EX15_R[0], R_max=EX15_R[-1], N_samples_R=len(EX15_R),
        verbose=False)
    runner = T.BaryonifySnapshot(cat, snap, epsilon_max=10, model=model0,
                                 method="cellmajor", verbose=False,
                                 device=device, precision=precision)
    pk = pk_bands(T, torch, L, Ng, runner.dtype, device)
    p_dmo = pk(*(torch.as_tensor(snap.cat[c], dtype=runner.dtype,
                                 device=device) for c in "xyz"))

    def table_of(lnMc):
        par = dict(PAR, M_c=torch.exp(lnMc))
        clm = T.CollisionlessMatter(r_steps=1500, max_iter=6, **par)
        m = T.Baryonification3D(
            T.DarkMatterOnly(**par),
            T.DarkMatterBaryon(collisionlessmatter=clm, **par), cosmo,
            epsilon_max=10)
        return m.build_table_device(EX15_Z, EX15_M, EX15_R).reshape(
            len(EX15_Z), len(EX15_M), len(EX15_R))

    return table_of, (lambda table: pk(*runner.process_device(table))
                      / p_dmo), runner


# float32 bar, rms/mean, of process_device() against process() on the
# card: the same computation, whose atomic adds (the CIC, the windowed
# scatters) land in another order, so the maps differ by rounding only
DEVICE_F32_BAR = 1e-6
# the bounded sizes of the 2D paths and the paints (and of every scatter
# method), where process_device() is held against process() and one
# backward runs: cell -> (dim, N, box L [Mpc], halos), bench_runners'
# resolutions (grid2d's 0.49 Mpc cells, grid-256's 1.95 Mpc)
GRAD_SMALL = {"grid2d": (2, 512, 250.0, 20_000),
              "paint3d": (3, 64, 125.0, 2_000)}
# gradsnap: example 15's P(k) bands at this mesh over bench_snap's box
GRAD_SNAP_NG = 256
# the CIC deposit of more than 2^31 rows (8 N^3) that gradgrid runs
BIG_CIC_N = 700
# no TPU kernel replaced: the backward of the Pallas scatter-add
VJP_REPLACES = "baryonification_tpu/ops/scatter_pallas.py:204"


def value_and_grad(torch, loss_of, x0, device):
    """(loss, d loss / d x at x0, forward s, backward s) on the card."""
    x = torch.tensor(x0, dtype=torch.float64, device=device,
                     requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_of(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (g,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    return (float(loss.detach()), float(g), t1 - t0,
            time.perf_counter() - t1)


@contextlib.contextmanager
def synced_time(torch, module, name, times):
    """``module.name`` (a function of a module or a class) timed for the
    block: each call, synchronised before and after, adds its seconds to
    ``times``."""
    fn = getattr(module, name)

    def timed_fn(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed_fn)
    try:
        yield
    finally:
        setattr(module, name, fn)


def warm_value_and_grad(torch, label, loss_of, x0, device, reg_module,
                        reg_name, pass_module):
    """A cold and a warm value_and_grad of ``loss_of`` at ``x0`` with the
    registrations (calls of ``reg_module.reg_name``) of each, the peak
    device memory of the warm one, and then one more warm step with the
    passes' forwards and backwards timed (``pass_module``'s
    ``_bucket_pass`` and ``_bucket_vjp``, the grid and snapshot passes'
    step loops, and the kernels: the buckets' ``kernel_pass``,
    ``grid_vjp``, ``anis_vjp`` and ``snap_vjp``, synchronised: for the
    breakdown only). Returns (cold, warm, peak GiB)."""
    regs = []
    with spied(reg_module, reg_name, regs.append):
        cold = value_and_grad(torch, loss_of, x0, device)
        regs_cold = len(regs)
        regs.clear()
        torch.cuda.reset_peak_memory_stats()
        warm = value_and_grad(torch, loss_of, x0, device)
        peak = torch.cuda.max_memory_allocated() / 2**30
        regs_warm = len(regs)
    t_fwd, t_bwd = [], []
    from baryonification_tpu_torch.ops import anis_pass_cuda as apc
    from baryonification_tpu_torch.ops import grid_pass_cuda as gp
    from baryonification_tpu_torch.ops import snap_pass_cuda as spc
    from baryonification_tpu_torch.runners import snapshot_cellmajor as tscm
    timers = [(pass_module, "_bucket_pass", t_fwd),
              (pass_module, "_bucket_vjp", t_bwd),
              (pass_module._GridBucket, "kernel_pass", t_fwd),
              (pass_module._AnisBucket, "kernel_pass", t_fwd),
              (tscm._SnapBucket, "kernel_pass", t_fwd),
              (gp, "grid_vjp", t_bwd), (apc, "anis_vjp", t_bwd),
              (spc, "snap_vjp", t_bwd)]
    with contextlib.ExitStack() as stack:
        for module, name, times in timers:
            stack.enter_context(synced_time(torch, module, name, times))
        split = value_and_grad(torch, loss_of, x0, device)
    log(f"{label}: cold value_and_grad forward {cold[2]:.3f} s, backward "
        f"{cold[3]:.3f} s ({regs_cold} registrations); warm forward "
        f"{warm[2]:.3f} s, backward {warm[3]:.3f} s, peak memory "
        f"{peak:.2f} GiB, registrations {regs_warm}; loss {warm[0]:.6e}, "
        f"gradient {warm[1]:.6e}; a third step with the passes synced: "
        f"forward {split[2]:.3f} s of which the {len(t_fwd)} bucket passes "
        f"{sum(t_fwd):.3f} s, backward {split[3]:.3f} s of which their "
        f"{len(t_bwd)} adjoints {sum(t_bwd):.3f} s")
    check(regs_warm == 0, f"{label}: the warm step registered {regs_warm} "
          f"buckets")
    check(np.isfinite(warm[1]) and warm[1] != 0, f"{label}: gradient "
          f"{warm[1]!r}")
    return cold, warm, peak


@contextlib.contextmanager
def held_memory(torch, targets, held):
    """Each ``(owner, name)`` of ``targets`` (a module or a class)
    wrapped for the block: the device memory that a call leaves allocated
    beyond the tensors it returns (what autograd saved for the backward,
    and what the call keeps) is added to ``held[name]``."""
    saved = [(o, n, o.__dict__.get(n), getattr(o, n)) for o, n in targets]

    def wrap(name, fn):
        def f(*args, **kw):
            m0 = torch.cuda.memory_allocated()
            out = fn(*args, **kw)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            n_out = sum(o.untyped_storage().nbytes() for o in outs
                        if torch.is_tensor(o))
            held[name] = (held.get(name, 0) + torch.cuda.memory_allocated()
                          - m0 - n_out)
            return out
        return f

    for o, n, _, fn in saved:
        setattr(o, n, wrap(n, fn))
    try:
        yield
    finally:
        for o, n, own, _ in saved:
            if own is None:
                delattr(o, n)
            else:
                setattr(o, n, own)


def memory_split(torch, label, loss_of, x0, device, targets):
    """One more warm value_and_grad with the device memory split: what is
    allocated when it starts (the runners' caches, the targets), what the
    forward leaves for the backward (in all, and held by each of
    ``targets``' calls, see :func:`held_memory`), and the peaks of the
    forward and of the backward over the start. Returns a dict in GiB."""
    x = torch.tensor(x0, dtype=torch.float64, device=device,
                     requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    held = {}
    with held_memory(torch, targets, held):
        loss = loss_of(x)
    kept = torch.cuda.memory_allocated() - base
    peak_fwd = torch.cuda.max_memory_allocated() - base
    torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    gib = {k: v / 2**30 for k, v in held.items()}
    out = dict(start=base / 2**30, kept=kept / 2**30,
               peak_forward=peak_fwd / 2**30, peak=peak / 2**30, **gib)
    log(f"{label}: memory: {out['start']:.2f} GiB allocated at the start "
        f"of a warm step (runners, caches, targets); the forward keeps "
        f"{out['kept']:.2f} GiB for the backward, of which "
        + ", ".join(f"{k} {v:.2f} GiB" for k, v in gib.items())
        + f", the rest {out['kept'] - sum(gib.values()):.2f} GiB; peaks "
        f"over the start: forward {out['peak_forward']:.2f} GiB, backward "
        f"{out['peak']:.2f} GiB (so the step's peak is "
        f"{out['start'] + out['peak']:.2f} GiB)")
    return out


def check_fd(torch, label, loss_of, x0, g64, device):
    """The float64 gradient ``g64`` of ``loss_of`` at ``x0`` against
    central differences at GRAD_FD_STEPS: GRAD_FD_BAR, or
    GRAD_FD_KINK_BAR where the differences depend on their step (the
    CIC's floor() kinks). Returns the largest relative error."""
    f64 = dict(dtype=torch.float64, device=device)
    fds = []
    with torch.no_grad():
        for h in GRAD_FD_STEPS:
            fp = float(loss_of(torch.tensor(x0 + h, **f64)))
            fm = float(loss_of(torch.tensor(x0 - h, **f64)))
            fds.append((fp - fm) / (2 * h))
    spread = (max(fds) - min(fds)) / abs(fds[-1])
    bar = GRAD_FD_KINK_BAR if spread > GRAD_FD_BAR else GRAD_FD_BAR
    errs = [abs(g64 - fd) / abs(fd) for fd in fds]
    log(f"{label}: float64 gradient {g64:.10e}; central differences "
        + ", ".join(f"h={h:g}: {fd:.10e} (rel {e:.3e})"
                    for h, fd, e in zip(GRAD_FD_STEPS, fds, errs))
        + f"; spread {spread:.3e}, held at {bar:g}")
    check(np.isfinite(g64) and g64 != 0 and max(errs) <= bar,
          f"{label}: float64 gradient {g64!r} against central differences "
          f"{fds} (bar {bar})")
    return max(errs)


def check_scatter_vjp(T, torch, sc, device):
    """The backward kernel against its plain version on grid-256's CIC
    rows (8 calls of 1.68e7 rows, one a CIC corner, as the gradgrid
    path's backward hands them it), float32 and float64, exactly (a
    gather); the CUDA-event time of the 8 calls beside the plain
    version's, the library call's (one torch.where over an indexed
    gather a corner) and the bytes bound, with the device launches.
    Returns the kernels-line record."""
    corners, npix = cic_rows(T, torch, device)
    idxs = [i for i, _ in corners]
    del corners
    n = sum(i.shape[0] for i in idxs)
    n_live = sum(int((i < npix).sum()) for i in idxs)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for dt in (torch.float64, torch.float32):
        ct = torch.randn(npix, generator=gen, dtype=torch.float64).to(
            device, dt)
        err = 0.0
        for i in idxs:
            got = sc.scatter_add_vjp((ct,), i)[0]
            want = sc.scatter_add_vjp_reference((ct,), i)[0]
            err = max(err, float((got - want).abs().max()))
        log(f"gradgrid: scatter_add_vjp grid-256 CIC rows ({len(idxs)} "
            f"calls, {n} rows, {n_live} aimed at a pixel) {str(dt)[6:]} "
            f"against its plain version: max|err| {err:.3e} (bar 0: a "
            f"gather)")
        check(err == 0, f"scatter_add_vjp {dt} disagrees with its plain "
              f"version: {err:.3e}")
        del got, want

    def library():
        return [torch.where(i < npix, ct[torch.where(i < npix, i, 0)], 0.0)
                for i in idxs]

    fns = dict(call=lambda: [sc.scatter_add_vjp((ct,), i) for i in idxs],
               plain=lambda: [sc.scatter_add_vjp_reference((ct,), i)
                              for i in idxs],
               library=library)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {k: [] for k in fns}
    for k in ("plain", "library", "call", "call", "library", "plain"):
        runs[k].append(cuda_ms(torch, fns[k], 5))
    ms = {k: sum(r) / len(r) for k, r in runs.items()}
    n_dev = {k: device_launches(torch, fns[k]) for k in ("call", "library")}
    # every row's int32 index read and its float32 cotangent written once,
    # each row aimed at a pixel gathers one float32
    n_bytes = n * 4 + n_live * 4 + n * 4
    bound = n_bytes / PEAK_BYTES * 1e3
    on_dev = {k: ("device launches not measured" if c is None else
                  f"{c} device launches, {d:.4f} ms on the device")
              for k, (c, d, _) in n_dev.items()}
    log(f"gradgrid: scatter_add_vjp grid-256 CIC f32 C=1: the "
        f"{len(idxs)} calls {ms['call']:.4f} ms (runs "
        + ", ".join(f"{x:.4f}" for x in runs["call"])
        + f"; {on_dev['call']}); plain (mask, int64 ids, index_select, "
        f"where) {ms['plain']:.4f} ms; library (torch.where(ok, ct[safe], "
        f"0)) {ms['library']:.4f} ms ({on_dev['library']}); bound "
        f"{bound:.5f} ms ({n_bytes / 1e6:.2f} MB at {PEAK_BYTES / 1e12:.2f} "
        f"TB/s); kernel at {100 * bound / ms['call']:.1f}% of the bound")
    return dict(name="scatter_add_vjp", route="cuda",
                source="baryonification_tpu_torch/csrc/scatter_add.cu",
                replaces=VJP_REPLACES, max_abs_err=0.0, ms=ms["call"],
                plain_ms=ms["plain"], bound_ms=bound, bound_by="bytes",
                library_ms=ms["library"])


def check_scatter_big(T, torch, sc, device):
    """The scatter-add and its backward past the kernels' int row count,
    each in one call, and a CIC deposit of more than 2^31 rows, all
    checked exactly: (1) 2^31 + 2^20 rows of 1.0 aimed at 2^20 pixels
    (each pixel gets 2049: exact in float32) in ceil(rows / CHUNK_ROWS)
    launches; (2) the backward of those rows gathers each pixel's
    cotangent 2049 times; (3) cic_deposit_3d of unit cells shifted by a
    quarter cell on every axis at N = BIG_CIC_N, float32, whose every cell
    gets the eight weights (3/4 or 1/4 a axis) that sum to 1 exactly."""
    npix = 1 << 20
    reps = (1 << 11) + 1
    n = npix * reps
    launches = -(-n // sc.CHUNK_ROWS)
    idx = torch.arange(npix, dtype=torch.int32, device=device).repeat(reps)
    before = dict(sc.LAUNCHES)
    vals = torch.ones(n, dtype=torch.float32, device=device)
    acc = torch.zeros(npix, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    sc.scatter_add_accum((acc,), idx, (vals,))
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    del vals
    bad_fwd = int((acc != reps).sum())
    ct = torch.arange(npix, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    (out,) = sc.scatter_add_vjp((ct,), idx)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    bad_bwd = int((out.view(reps, npix) != ct).sum())
    del out, idx, acc, ct
    got = {k: sc.LAUNCHES[k] - before[k] for k in before}
    log(f"gradgrid: one scatter_add_accum of {n} rows (> 2^31) into "
        f"{npix} pixels: {got['scatter_add']} launches (CHUNK_ROWS "
        f"{sc.CHUNK_ROWS}, expected {launches}), {t_fwd * 1e3:.2f} ms, "
        f"{bad_fwd} pixels off {reps}; its scatter_add_vjp: "
        f"{got['scatter_add_vjp']} launches, {t_bwd * 1e3:.2f} ms, "
        f"{bad_bwd} rows off their cotangent")
    check(got["scatter_add"] == launches and bad_fwd == 0,
          "scatter_add_accum past 2^31 rows is wrong")
    check(got["scatter_add_vjp"] == launches and bad_bwd == 0,
          "scatter_add_vjp past 2^31 rows is wrong")
    N = BIG_CIC_N
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    i = torch.arange(N ** 3, device=device, dtype=torch.int32)
    pos = [((i // N ** (2 - d)) % N).to(torch.float32) + 0.25
           for d in range(3)]
    del i
    n0 = sc.LAUNCHES["scatter_add"]
    t0 = time.perf_counter()
    m = T.ops.scatter.cic_deposit_3d(N, *pos, torch.ones_like(pos[0]),
                                     dtype=torch.float32)
    torch.cuda.synchronize()
    t_cic = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    off = float((m - 1.0).abs().max())
    calls = sc.LAUNCHES["scatter_add"] - n0
    del m, pos
    torch.cuda.empty_cache()
    log(f"gradgrid: cic_deposit_3d at N={N} ({8 * N ** 3} rows, > 2^31) "
        f"float32: {calls} launches, {t_cic * 1e3:.2f} ms, peak "
        f"{peak:.2f} GiB over what was held before, max|cell - 1| {off!r}"
        f" (bar 0)")
    check(8 * N ** 3 > 2 ** 31 and off == 0.0,
          f"cic_deposit_3d at N={N}: max|cell - 1| {off!r}")


def device_vs_process(torch, label, runner, base):
    """process_device() against process() of one runner on the card,
    rms over ``base`` (the original map's mean, or the paint's), at
    DEVICE_F32_BAR (float32) or exactly 1e-12 (float64)."""
    got = runner.process_device().to(torch.float64).cpu().numpy()
    want = runner.process()
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{label}: process_device() of shape {got.shape}, not finite or "
          f"not process()'s {want.shape}")
    rms = np.sqrt(np.mean((got - want) ** 2)) / base(want)
    bar = DEVICE_F32_BAR if runner.dtype == torch.float32 else 1e-12
    log(f"{label}: process_device() against process() on the card "
        f"({str(runner.dtype)[6:]}): rms {rms:.3e} (bar {bar:g}; the "
        f"atomic adds land in another order)")
    check(rms <= bar, f"{label}: process_device() differs from process(): "
          f"{rms:.3e}")
    return rms


def grad_small(T, torch, device):
    """The 2D baryonify (grid2d's model) and both paints (the tSZ table
    in 2D, the Gas table in 3D) at GRAD_SMALL's sizes, both methods,
    float32: process_device() against process(), and one backward of a
    table scale (finite, not 0). Returns the launch counts."""
    reset_counts()
    dim2, N2, L2, H2 = GRAD_SMALL["grid2d"]
    dim3, N3, L3, H3 = GRAD_SMALL["paint3d"]
    cat2, gm2 = nd_catalog(T, dim2, N2, L2, H2)
    cat3, gm3 = nd_catalog(T, dim3, N3, L3, H3)
    cases = [("grid2d BaryonifyGrid", "BaryonifyGrid", cat2, gm2,
              grid_model(T, torch, device, 2), GRID_EPS, "_table"),
             ("grid2d PaintProfilesGrid tsz_model(32)", "PaintProfilesGrid",
              cat2, gm2, tsz_model(T, torch, device, 32), GRID_PAINT_EPS,
              "_ln2D"),
             ("paint3d PaintProfilesGrid Gas", "PaintProfilesGrid", cat3,
              gm3, grid_model(T, torch, device, 3, "gas"), GRID_PAINT_EPS,
              "_ln3D")]
    for label, cls, cat, gm, mdl, eps, attr in cases:
        paint = cls == "PaintProfilesGrid"
        for method in ("auto", "scatter"):
            runner = getattr(T, cls)(cat, gm, epsilon_max=eps, model=mdl,
                                     verbose=False, device=device,
                                     method=method)
            name = (f"{label} ({runner.method}, N={gm.Npix}, "
                    f"{cat.cat.size} halos)")
            base = (lambda m: m.mean()) if paint else \
                (lambda m, g=gm: g.map.mean())
            device_vs_process(torch, f"gradgrid: {name}", runner, base)
            tab = getattr(mdl, attr)
            loss = (lambda m: m.double().sum()) if paint else \
                (lambda m: (m.double() ** 2).sum())
            res = value_and_grad(
                torch, lambda s: loss(runner.process_device(tab * s)), 1.0,
                device)
            log(f"gradgrid: {name}: d loss / d table scale {res[1]:.6e} "
                f"(forward {res[2]:.3f} s, backward {res[3]:.3f} s)")
            check(np.isfinite(res[1]) and res[1] != 0,
                  f"gradgrid: {name}: gradient {res[1]!r}")
    return read_counts("gradgrid small sizes (2D, paints, scatter methods)",
                       ["scatter_add", "scatter_add_vjp"] + GRID
                       + ["grid_vjp"])


def gradgrid_path(T, torch, sc, device):
    """grid-256 (bench_runners.py's bench_grid: 256^3, 1e5 halos, eps_max
    15, the RUNNERS_GRID table grid) differentiated: chi^2 = sum (map(ln
    M_c) - map(ln M_c,true))^2 through float64 build_table_device and
    float32 process_device under ``auto`` (cell-major): a cold and a warm
    value_and_grad (seconds, peak memory, no registration in the warm
    step; the scatter and its backward kernel launched), the float64
    gradient against central differences, process_device() against
    process(); then the backward kernel against its plain version on the
    CIC's rows, grid_vjp against its plain version on the largest bucket,
    and the 2D path and both paints at
    GRAD_SMALL. Returns the kernels-line record of scatter_add_vjp and
    grid_vjp's check."""
    from baryonification_tpu_torch.runners import grid as tgrid
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    dim, N, L, n_halo = GRID_CELLS["grid"]
    model = grid_model(T, torch, device, dim)
    cat, gm = nd_catalog(T, dim, N, L, n_halo)
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    runners = {p: T.BaryonifyGrid(cat, gm, epsilon_max=GRID_EPS, model=model,
                                  verbose=False, device=device, precision=p)
               for p in ("float32", "float64")}
    auto = T.BaryonifyGrid(cat, gm, epsilon_max=GRID_EPS, model=model,
                           verbose=False, device=device)
    check(auto.method == "cellmajor" and auto.dtype == torch.float32,
          f"gradgrid: auto is {auto.method} in {auto.dtype}")
    runners["float32"] = auto
    tab = lambda x: table_of(T, cosmo, RUNNERS_GRID,
                             dict(PAR, M_c=torch.exp(x)), dim, GRID_EPS)
    with torch.no_grad():
        truth = tab(torch.tensor(LN_MC_TRUE, **f64))
        targets = {p: r.process_device(truth).double()
                   for p, r in runners.items()}
    chi2 = lambda p: lambda x: ((runners[p].process_device(tab(x)).double()
                                 - targets[p]) ** 2).sum()
    label = (f"gradgrid (grid-256: N={N}^3, {n_halo} halos, table "
             f"{tuple(truth.shape)})")
    reset_counts()
    cold, warm, peak = warm_value_and_grad(
        torch, label, chi2("float32"), LN_MC_START, device, tgcm,
        "register_halos_grid", tgcm)
    read_counts("gradgrid (value_and_grad, float32)",
                ["scatter_add", "scatter_add_vjp"] + GRID + ["grid_vjp"])
    mem = memory_split(torch, label, chi2("float32"), LN_MC_START, device,
                       [(T.Baryonification3D, "build_table_device"),
                        (tgcm, "grid_pass_diff"),
                        (tgrid, "cic_deposit_3d")])
    v64 = value_and_grad(torch, chi2("float64"), LN_MC_START, device)
    rel32 = abs(warm[1] - v64[1]) / abs(v64[1])
    log(f"{label}: float64 value_and_grad forward {v64[2]:.3f} s, backward "
        f"{v64[3]:.3f} s; float32 gradient {rel32:.3e} from float64")
    check_fd(torch, label, chi2("float64"), LN_MC_START, v64[1], device)
    for p, r in runners.items():
        device_vs_process(torch, f"{label} {p}", r,
                          lambda m: gm.map.mean())
    # grid_vjp (and grid_pass) against the step loop on the largest
    # bucket, its rows from build_table_device's float32 table
    calls = []
    with torch.no_grad(), spied(tgcm, "grid_pass_diff", calls.append):
        chi2("float32")(torch.tensor(LN_MC_START, **f64))
    vjp = check_grid_bucket(torch, "gradgrid: grad-grid-256",
                            largest_bucket(calls), calls[0][0],
                            torch.float32)["vjp"]
    del calls
    del runners, auto, targets
    torch.cuda.empty_cache()
    rec = check_scatter_vjp(T, torch, sc, device)
    rec.update(forward_s=warm[2], backward_s=warm[3], peak_gib=peak,
               memory_gib=mem)
    torch.cuda.empty_cache()
    check_scatter_big(T, torch, sc, device)
    grad_small(T, torch, device)
    return rec, vjp


def gradsnap_path(T, torch, device):
    """snap-5e6 (bench_runners.py's bench_snap: 5e6 particles, 1e5 halos,
    L = 500, eps_max 15, the RUNNERS_GRID table grid) differentiated:
    chi^2 = 1e4 sum (ratio(ln M_c) - ratio(ln M_c,true))^2 on example
    15's seven P(k) bands at Ng = GRAD_SNAP_NG, through float64
    build_table_device and float32 process_device under ``auto``: a cold
    and a warm value_and_grad (the snap_pass kernel forward and the
    snap_vjp kernel backward, one launch a bucket each, and no plain step
    loop or other plain version on the card: the scatter_add_vjp
    launches are the CIC's alone), the float64 gradient against central
    differences, process_device() against process() (float64 bit for
    bit; float32 within the positions' rounding); then snap_vjp against
    the step loop at the largest bucket with the float32 rows of
    build_table_device (the kernels line's snap_vjp record). Returns
    check_snap_bucket's snap_vjp result."""
    from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
    from baryonification_tpu_torch.ops import scatter_cuda as sc
    from baryonification_tpu_torch.ops import snap_pass_cuda as spc
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    from baryonification_tpu_torch.runners import snapshot_cellmajor as tscm
    model = grid_model(T, torch, device, 3)
    L, n_part, n_halo = SNAP_CELL
    cat, snap = snap_inputs(T, L, n_part, n_halo, seed=3)
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    runners = {p: T.BaryonifySnapshot(cat, snap, epsilon_max=SNAP_EPS,
                                      model=model, verbose=False,
                                      device=device, precision=p)
               for p in ("float32", "float64")}
    check(runners["float32"].method == "cellmajor", "gradsnap: not "
          "cell-major")
    tab = lambda x: table_of(T, cosmo, RUNNERS_GRID,
                             dict(PAR, M_c=torch.exp(x)), 3, GRID_EPS)
    pks, targets = {}, {}
    with torch.no_grad():
        truth = tab(torch.tensor(LN_MC_TRUE, **f64))
        for p, r in runners.items():
            pk = pk_bands(T, torch, L, GRAD_SNAP_NG, r.dtype, device)
            p_dmo = pk(*r._positions(r.dtype))
            pks[p] = (lambda table, pk=pk, r=r, p_dmo=p_dmo:
                      (pk(*r.process_device(table)) / p_dmo).double())
            targets[p] = pks[p](truth)
    sig = float((targets["float64"] - 1).abs().max())
    log(f"gradsnap: max |P_B/P_DMO - 1| over the bands at the truth "
        f"{sig:.4e} (float64)")
    check(sig > 0, "gradsnap: no suppression")
    chi2 = lambda p: lambda x: ((pks[p](tab(x)) - targets[p]) ** 2).sum() \
        * 1e4
    label = (f"gradsnap (snap-5e6: {n_part} particles, {n_halo} halos, "
             f"P(k) bands on {GRAD_SNAP_NG}^3)")
    reset_counts()
    passes = []
    with plain_on_card(cmc, sc) as plain, \
            spied(tscm, "snapshot_pass_diff", passes.append):
        cold, warm, peak = warm_value_and_grad(
            torch, label, chi2("float32"), LN_MC_START, device, tgcm,
            "register_halos_grid", tgcm)
    launches = read_counts("gradsnap (value_and_grad, float32)",
                           ("scatter_add", "scatter_add_vjp", "snap_pass",
                            "snap_vjp"))
    # three value_and_grads (cold, warm, and one with the passes synced)
    steps = 3
    log(f"{label}: launches a value_and_grad: snap_pass "
        f"{launches['snap_pass'] / steps:g}, snap_vjp "
        f"{launches['snap_vjp'] / steps:g} ({len(passes) / steps:g} "
        f"buckets), scatter_add_vjp {launches['scatter_add_vjp'] / steps:g}"
        f" (the CIC's backward); plain versions on the card: {plain}")
    check(not plain, f"gradsnap: plain versions ran on the card: {plain}")
    check(launches["snap_vjp"] == launches["snap_pass"] == len(passes),
          f"gradsnap: snap_pass {launches['snap_pass']} and snap_vjp "
          f"{launches['snap_vjp']} launches for {len(passes)} bucket "
          f"passes")
    del passes
    mem = memory_split(torch, label, chi2("float32"), LN_MC_START, device,
                       [(T.Baryonification3D, "build_table_device"),
                        (tscm, "snapshot_pass_diff"),
                        (T.ops.scatter, "cic_deposit_3d")])
    v64 = value_and_grad(torch, chi2("float64"), LN_MC_START, device)
    rel32 = abs(warm[1] - v64[1]) / abs(v64[1])
    log(f"{label}: float64 value_and_grad forward {v64[2]:.3f} s, backward "
        f"{v64[3]:.3f} s; float32 gradient {rel32:.3e} from float64")
    check_fd(torch, label, chi2("float64"), LN_MC_START, v64[1], device)
    for p, r in runners.items():
        got = [x.double().cpu().numpy() for x in r.process_device()]
        want = r.process()
        # minimum image: a position that rounds onto the box edge wraps to
        # 0 in one precision and stays at L in the other
        diff = max(float(np.abs(d - L * np.round(d / L)).max())
                   for d in (g - want[c] for g, c in zip(got, "xyz")))
        bar = 0.0 if p == "float64" else 4 * L * 2.0 ** -24
        log(f"gradsnap: process_device() against process() {p}: max|diff| "
            f"{diff:.3e} Mpc, minimum image (bar {bar:.3e}: "
            + ("bit for bit)" if p == "float64" else
               "process() adds the offsets in float64 on the host, "
               "process_device() to the float32 positions on the card)"))
        check(diff <= bar, f"gradsnap: process_device() {p} differs from "
              f"process(): {diff:.3e}")
    # snap_vjp (and snap_pass) against the step loop on the largest
    # bucket, its rows from build_table_device's float32 table
    calls = []
    with torch.no_grad(), spied(tscm, "snapshot_pass_diff", calls.append):
        chi2("float32")(torch.tensor(LN_MC_START, **f64))
    args = max(calls, key=lambda a: int(
        (a[7].long() * a[4].long()).sum()))
    del calls
    vjp = check_snap_bucket(torch, "gradsnap: grad-snap-5e6", args,
                            torch.float32)["vjp"]
    del args, runners
    torch.cuda.empty_cache()
    log(f"{label}: " + json.dumps(dict(
        forward_s=warm[2], backward_s=warm[3], peak_gib=peak,
        memory_gib=mem), default=float))
    return vjp


def example15(T, torch, device):
    """examples/15_gradient_fit_dPk.py through the port on the card at its
    sizes (L 120, 30,000 particles, 25 halos, Ng 48, seed 4), float64,
    the full tier (20 Adam steps at lr 0.2), with its three asserts."""
    f64 = dict(dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    table_of, ratio_of, _ = ex15_chain(T, torch, device, **EX15_SIZE)
    with torch.no_grad():
        target = ratio_of(table_of(torch.tensor(EX15_LN_MC_TRUE, **f64)))
    sig = float((target - 1).abs().max())
    log(f"ex15: suppression signal at truth: max |P_B/P_DMO - 1| = "
        f"{sig:.4f} (staging and the truth's chain "
        f"{time.perf_counter() - t0:.2f} s)")
    check(sig > 0.015, "ex15: mock suppression too small to fit")
    chi2 = lambda x: ((ratio_of(table_of(x)) - target) ** 2).sum() * 1e4
    start = []

    def progress(step, params, loss, grad):
        if step == 0:
            start.append((loss, float(grad)))
            check(start[0][1] * (EX15_LN_MC_START - EX15_LN_MC_TRUE) > 0,
                  "ex15: gradient must point back toward the truth")
        if step % 4 == 0 or step == 19:
            log(f"ex15: step {step:2d}: ln M_c = {float(params):.4f} "
                f"(truth {EX15_LN_MC_TRUE:.4f}), chi2 = {loss:.4e}")

    t0 = time.perf_counter()
    res = T.fit(chi2, torch.tensor(EX15_LN_MC_START, **f64), steps=20,
                learning_rate=0.2, callback=progress)
    per_step = (time.perf_counter() - t0) / 20
    err = abs(float(res.params) - EX15_LN_MC_TRUE)
    off = abs(EX15_LN_MC_START - EX15_LN_MC_TRUE)
    log(f"ex15: chi2 start {start[0][0]:.4e}, gradient {start[0][1]:+.3e}; "
        f"recovered ln M_c = {float(res.params):.4f} (truth "
        f"{EX15_LN_MC_TRUE:.4f}; residual {err:.4f} = {err / off:.1%} of "
        f"the injected offset), chi2 {res.loss:.4e}; {per_step:.3f} s an "
        f"Adam step (full tier, 20 steps)")
    check(err < 0.10 * off, "ex15: M_c not recovered from dP(k)")
    return per_step


def ex15_path(T, torch, device):
    """Example 15 on the card; the scatter kernel and its backward (the
    CIC deposits of its P(k)) and the snapshot kernels must have been
    launched."""
    reset_counts()
    example15(T, torch, device)
    read_counts("ex15 (example 15, full tier)",
                ("scatter_add", "scatter_add_vjp", "snap_pass", "snap_vjp"))


# ----- the density-dependent paint: anis, ex17 -----

# anis-2048: bench_runners.py's bench_anis (L = 1000 Mpc, 2048^2 pixels,
# 2e5 halos from grid2d-2048's catalog draw, eps_max 5, tsz_model(32)
# painted on a TabulatedProfile(DarkMatter) canvas on RUNNERS_GRID, the
# canvas map 10^U(12, 14.5))
ANIS_CELL = (2048, 1000.0, 200_000)
# the loop (method "scatter") against the cell-major method in float64 on
# this many of the catalog's halos, at the JAX tests' blended-mass bars on
# the pixels both paint: max and rms of |cell-major / loop - 1|
ANIS_METHODS_HALOS = 2000
ANIS_METHODS_BAR = (2e-2, 5e-3)
# operations the anisotropic pass needs (a sqrt, log, exp or division
# counted as one), from runners/grid_cellmajor.py's _AnisBucket: every
# listed pixel-slot takes its offsets (3 an axis: the window place less
# the halo's half, times res, squared), their sum, the sqrt and the
# compare against eps_max R, and the window test (3); every pixel of
# every bucket the log of its canvas value, t (2), its clamp (2), floor
# and weight (2); every slot that passes the geometry the lerp (3), the
# range tests (2), exp and the add
ANIS_TEST_FLOPS = 2 * 3 + 1 + 1 + 1 + 3
ANIS_PIXEL_FLOPS = 1 + 2 + 2 + 2
ANIS_READ_FLOPS = 3 + 2 + 1 + 1
# the adjoint's more: a slot inside the share g = ct paint, g (b - a) and
# its sum, 1 - w and the two shares (6); a pixel the clamp's mask, 1 / dq
# and 1 / v (3)
ANIS_VJP_FLOPS = 6
ANIS_VJP_PIXEL_FLOPS = 3
# the anis_pass and anis_vjp kernels against the plain step loop on the
# card, of max|plain| (the grid kernels' bars): the same arithmetic a
# pixel-slot (the geometry bit for bit), summed in another order: a
# pixel's slots (the pass and the canvas gradient), a node's shares from
# many pixel-slots by atomic adds in no fixed order (the rows' gradient)
ANIS_PASS_BAR = {"float64": 1e-12, "float32": 1e-5}
ANIS_VJP_BAR = {"float64": 1e-10, "float32": 1e-4}
ANIS_PASS_SOURCE = "baryonification_tpu_torch/csrc/anis_pass.cu"
ANIS_PASS_REPLACES = "baryonification_tpu/runners/grid_cellmajor.py:722"


def anis_flops(slots, inside, npix, vjp=False):
    """Operations of one anisotropic pass (its adjoint where ``vjp``) over
    ``npix`` pixels listing ``slots`` pixel-slots, ``inside`` of them
    inside: ANIS_TEST_FLOPS a slot, ANIS_PIXEL_FLOPS a pixel,
    ANIS_READ_FLOPS a slot inside (the adjoint ANIS_VJP_FLOPS and
    ANIS_VJP_PIXEL_FLOPS more)."""
    flops = (slots * ANIS_TEST_FLOPS + inside * ANIS_READ_FLOPS
             + npix * ANIS_PIXEL_FLOPS)
    if vjp:
        flops += inside * ANIS_VJP_FLOPS + npix * ANIS_VJP_PIXEL_FLOPS
    return flops


def anis_catalog(T):
    """anis-2048's catalog (grid2d-2048's draw) and canvas map."""
    N, L, n_halo = ANIS_CELL
    cat, _ = nd_catalog(T, 2, N, L, n_halo)
    rng = np.random.default_rng(4)
    gm = T.GriddedMap(map=10 ** rng.uniform(12.0, 14.5, (N, N)),
                      redshift=0.25, bins=(np.arange(N) + 0.5) * (L / N),
                      cosmo=COSMO)
    return cat, gm


def anis_census(torch, runner, label):
    """One more warm process() with the pass's census (on the card the
    kernel's tally: it synchronises once a bucket) and the peak device
    memory, one under torch.profiler; logs the counts, the operations
    bound, the launches and the idle share. Fails unless the census call
    launched anis_pass once a bucket. Returns (operations bound ms, census
    totals)."""
    from baryonification_tpu_torch.ops import anis_pass_cuda as apc
    census, peak, n_warm, n_launch, dev_ms, idle = census_run(
        torch, runner, apc.LAUNCHES, "anis_pass")
    log(f"anis: {label}: anis_pass launches a warm process() {n_warm} "
        f"({len(census)} buckets)")
    check(n_warm == len(census) > 0, f"{label}: a warm process() launched "
          f"anis_pass {n_warm} times for {len(census)} buckets")
    N = runner.GriddedMap.Npix
    slots = sum(c["slots"] for c in census)
    inside = sum(c["inside"] for c in census)
    flops = anis_flops(slots, inside, len(census) * N * N)
    bound = flops / PEAK_FLOPS["float32"] * 1e3
    for c in census:
        log(f"anis: {label} census bucket {c['bucket']}: H={c['H']}, "
            f"B={c['B']}->{c['B_eff']}, K={c['K']}, F={c['F']}: pixel-slots "
            f"{c['slots']:.4e}, inside {c['inside']:.4e}, {c['steps']} steps")
    log(f"anis: {label}: the pass lists {slots:.4e} pixel-slots, "
        f"{inside:.4e} inside; operations bound {bound:.4f} ms "
        f"({flops:.3e} flops at {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s); one warm process() puts {n_launch} device launches on "
        f"the card, {dev_ms if dev_ms is None else round(dev_ms, 3)} ms "
        f"busy; device idle {idle}; peak device memory {peak:.2f} GiB")
    return bound, dict(buckets=len(census), slots=slots, inside=inside,
                       launches=n_launch, busy_ms=dev_ms, idle=idle,
                       peak_gib=peak)


def anis_kernel_bounds(c, dname, vjp):
    """(operations ms, bytes ms) of one anisotropic kernel launch on a
    bucket whose counts are ``c`` (pixel-slots listed and inside, and its
    sizes): anis_flops; bytes: each input read once (the canvas, the
    adjoint's cotangent plane; the candidate ids within their counts, the
    counts; the per-halo half-window, window start, reach and live flag;
    the rows), each output written once (the plane; the adjoint's canvas
    gradient and rows)."""
    t = 8 if dname == "float64" else 4
    flops = anis_flops(c["slots"], c["inside"], c["npix"], vjp)
    n_bytes = (c["npix"] * t * (3 if vjp else 2) + c["ids"] * 4
               + c["ncell"] * 4 + c["H"] * (4 + 8 + t + 1)
               + c["H"] * c["S"] * t * (1 + vjp))
    return flops / PEAK_FLOPS[dname] * 1e3, n_bytes / PEAK_BYTES * 1e3


def check_anis_bucket(torch, label, args, dt, seed=0):
    """anis_pass and anis_vjp against the plain step loop on an
    _AnisBucket (check_bucket_kernels, within ANIS_PASS_BAR /
    ANIS_VJP_BAR; the adjoint's rows and canvas gradients each) at one
    bucket of a run: ``args`` the runner's grid_anis_paint_pass_2d
    arguments, its records, rows and canvas cast to ``dt``. Returns
    check_bucket_kernels' results."""
    from baryonification_tpu_torch.ops import anis_pass_cuda as apc
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    (B, n_hi, N, dense, counts, counts_host, pk, rows, live_h, q0, dq, eps,
     res, canvas) = args
    dname = str(dt).split(".")[1]
    bk = tgcm._AnisBucket(B, n_hi, N, dense, counts, counts_host, pk.to(dt),
                          live_h, q0, dq, eps, res)
    rows = rows.detach().to(dt).contiguous()
    canvas = canvas.detach().to(dt).contiguous()
    head, tail = bk.kernel_args(rows, canvas), bk.kernel_scalars()
    sizes = dict(npix=bk.ncell * bk.F, ncell=bk.ncell,
                 ids=int(bk.counts.clamp(max=bk.K).sum()), H=rows.shape[0],
                 S=rows.shape[1])
    out, _ = check_bucket_kernels(
        torch, label, apc, bk, rows, (canvas,),
        lambda t: (apc.anis_pass(*head, *tail, tally=t),),
        lambda c, t: apc.anis_vjp(*head, c[0], *tail, tally=t),
        (ANIS_PASS_BAR, ANIS_VJP_BAR),
        lambda kt, v: anis_kernel_bounds(
            dict(sizes, slots=kt[0], inside=kt[1]), dname, v),
        f"H={rows.shape[0]}, ncell={bk.ncell}, B={B}, K={bk.K}, "
        f"n_hi={n_hi}; {sizes['ids']} candidate ids listed", seed)
    return out


def check_remap_device(T, torch, runner, label):
    """build_remap_device() against the host build's table on the card
    (the same sentinels, then 1e-8), each timed."""
    cosmo = T.Cosmology.from_dict(COSMO, device=runner.device)
    a = 1.0 / (1.0 + runner.HaloNDCatalog.redshift)
    t0 = time.perf_counter()
    host = runner._anis_remap_table_impl(cosmo, a)[3]
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = runner.build_remap_device()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    host, dev = host.cpu().numpy(), dev.cpu().numpy()
    same = (np.array_equal(host <= -1e29, dev <= -1e29)
            and np.array_equal(host >= 1e29, dev >= 1e29))
    ok = (host > -1e29) & (host < 1e29)
    err = float(np.abs(host[ok] - dev[ok]).max())
    log(f"anis: {label}: remap table {host.shape}: the host build "
        f"{t_host:.3f} s, build_remap_device {t_dev:.3f} s; the same "
        f"sentinels {same} ({int((~ok).sum())} entries), max|diff| "
        f"{err:.3e} elsewhere (bar 1e-8)")
    check(same and err < 1e-8, f"anis: {label}: build_remap_device differs "
          f"from the host build")
    return t_host, t_dev


def anis_methods(T, torch, device, cat, gm, paint, canvas):
    """The loop (method "scatter", one scatter launch a halo) against the
    cell-major method on the first ANIS_METHODS_HALOS halos, float64."""
    sub = cat[:ANIS_METHODS_HALOS]
    maps = {}
    for method in ("scatter", "cellmajor"):
        r = T.PaintProfilesAnisGrid(sub, gm, epsilon_max=GRID_PAINT_EPS,
                                    Painting_model=paint,
                                    Canvas_model=canvas, verbose=False,
                                    device=device, method=method,
                                    precision="float64")
        reset_counts()
        t0 = time.perf_counter()
        maps[method] = r.process()
        t = time.perf_counter() - t0
        read_counts(f"anis {method} ({len(sub)} halos, float64)",
                    SCATTER if method == "scatter" else ANIS)
        log(f"anis: {method} float64 on {len(sub)} halos: process() "
            f"{t:.2f} s ({t / len(sub) * 1e3:.2f} ms a halo)")
    host, cm = maps["scatter"], maps["cellmajor"]
    b_h, b_c = host != 0, cm != 0
    both = b_h & b_c
    rel = np.abs(cm[both] / host[both] - 1)
    mx, rms = float(rel.max()), float(np.sqrt((rel ** 2).mean()))
    only = int((b_h ^ b_c).sum())
    log(f"anis: cell-major against the loop (float64, {len(sub)} halos): "
        f"{int(b_h.sum())} pixels painted by the loop, {int(b_c.sum())} by "
        f"the cell-major pass, {only} by one only; on the {int(both.sum())} "
        f"both paint |cm/loop - 1| max {mx:.3e}, rms {rms:.3e} (bars "
        f"{ANIS_METHODS_BAR[0]:g}, {ANIS_METHODS_BAR[1]:g})")
    check(b_h.sum() > 0 and mx < ANIS_METHODS_BAR[0]
          and rms < ANIS_METHODS_BAR[1], "anis: the two methods differ")
    return dict(max=mx, rms=rms, only=only, painted=int(b_h.sum()))


def anis_path(T, torch, cmc, sc, device):
    """bench_runners.py's bench_anis at full width (anis-2048): the remap
    built on the card (host build and build_remap_device, held
    together), PaintProfilesAnisGrid cold and warm with stages under
    ``auto`` (the cell-major pass: the anis_pass kernel, one launch a
    bucket, no plain version on the card), the census (the kernel's
    tally) with its operations bound, launches, idle share and peak memory
    of a warm call; anis_pass and anis_vjp against the step loop at the
    run's largest bucket in both dtypes (check_anis_bucket); a cold and a
    warm float32 value_and_grad of sum(process_device(...)) in a canvas
    scale and in a remap scale (the anis_vjp kernel, one launch a bucket a
    backward, no scatter_add_vjp); the float32 map against a float64
    paint; the loop against the cell-major method on the first
    ANIS_METHODS_HALOS halos in float64. Returns (a dict of the numbers,
    {dtype name: check_anis_bucket's result})."""
    from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
    cat, gm = anis_catalog(T)
    paint = tsz_model(T, torch, device, 32)
    canvas = grid_model(T, torch, device, 2, "dm")
    mk = lambda **kw: T.PaintProfilesAnisGrid(
        cat, gm, epsilon_max=GRID_PAINT_EPS, Painting_model=paint,
        Canvas_model=canvas, verbose=False, device=device, **kw)
    runner = mk()
    check(runner.method == "cellmajor" and runner.dtype == torch.float32,
          f"anis: auto is {runner.method} in {runner.dtype}")
    label = "anis (auto = cellmajor)"
    with plain_on_card(cmc, sc) as plain:
        y, _, t_warm = run_process(torch, runner, label, ANIS,
                                   CELLMAJOR + SCATTER, paint=True)
    check(not plain, f"{label}: plain versions ran on the card: {plain}")
    out = dict(warm_s=t_warm, pass_s=sum(
        v for k, v in runner.stage_times if k.startswith("pass[")))
    out["remap_host_s"], out["remap_device_s"] = check_remap_device(
        T, torch, runner, label)
    out["bound_ms"], out["census"] = anis_census(torch, runner, label)
    calls = []
    with spied(tgcm, "grid_anis_paint_pass_2d", calls.append):
        runner.process()
    # the bucket that lists the most pixel-slots
    args = max(calls, key=lambda a: int(a[4].sum()) * a[0] ** 2)
    del calls
    kernels = {}
    for dt in (torch.float32, torch.float64):
        kernels[str(dt).split(".")[1]] = check_anis_bucket(
            torch, f"anis {label}", args, dt)
        torch.cuda.empty_cache()
    del args
    t0 = time.perf_counter()
    y64 = mk(precision="float64").process()
    rms, rel = map_diff(y, y64)
    log(f"anis: float64 (cell-major) {time.perf_counter() - t0:.2f} s; "
        f"float32 vs float64: rms/mean {rms:.3e}, max|diff|/max {rel:.3e} "
        f"(bar rms/mean {GRID_PAINT_F32_BAR:g}); {int((y > 0).sum())} of "
        f"{y.size} pixels painted")
    check(rms < GRID_PAINT_F32_BAR, f"anis float32 vs float64: rms/mean "
          f"{rms:.3e}")
    out["f32_rms"] = rms
    c0 = torch.as_tensor(gm.map, dtype=torch.float32, device=device)
    remap0 = runner.build_remap_device()
    nq = remap0.shape[1] - 2
    losses = {
        "canvas": lambda s: runner.process_device(canvas=c0 * s)
        .double().sum(),
        "remap": lambda s: runner.process_device(remap=torch.cat(
            [remap0[:, :nq] * s, remap0[:, nq:]], dim=1)).double().sum()}
    for name, loss in losses.items():
        reset_counts()
        with plain_on_card(cmc, sc) as plain:
            cold, warm, peak = warm_value_and_grad(
                torch, f"anis value_and_grad in a {name} scale", loss, 1.0,
                device, tgcm, "register_halos_grid_2d", tgcm)
        n = read_counts(f"anis (value_and_grad in a {name} scale, float32)",
                        ("anis_pass", "anis_vjp"))
        check(not plain, f"anis value_and_grad in a {name} scale: plain "
              f"versions ran on the card: {plain}")
        # three value_and_grads (cold, warm, synced): one anis_pass and one
        # anis_vjp launch a bucket each
        nb = 3 * out["census"]["buckets"]
        check(n["anis_pass"] == n["anis_vjp"] == nb
              and n["scatter_add_vjp"] == 0, f"anis value_and_grad in a "
              f"{name} scale: {n['anis_pass']} anis_pass, {n['anis_vjp']} "
              f"anis_vjp and {n['scatter_add_vjp']} scatter_add_vjp "
              f"launches ({nb // 3} buckets)")
        out[f"grad_{name}"] = dict(forward_s=warm[2], backward_s=warm[3],
                                   peak_gib=peak)
    del runner
    torch.cuda.empty_cache()
    out["methods"] = anis_methods(T, torch, device, cat, gm, paint, canvas)
    return out, kernels


def ex17_chain(T, torch, device, precision="float64"):
    """examples/17_anis_paint_composition.py's chain through the port on
    ``device`` (float64 by default): the scene (10 halos on 48^2, seed 17,
    a TabulatedProfile(DarkMatter) painted by PaintProfilesGrid), then
    ``y_map(lnMc)`` = PaintProfilesAnisGrid.process_device (cell-major, a
    TabulatedProfile(Gas) painted on the DarkMatter canvas, its remap from
    build_remap_device held fixed) of the canvas
    BaryonifyGrid.process_device(build_table_device of Schneider19 at M_c
    = exp(lnMc)), every table on the example's 3 x 6 x 48 grid
    (EX14_GRID). The other runners take method "auto". Returns (y_map,
    the scene map)."""
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    N, L = 48, 60.0
    bins = (np.arange(N) + 0.5) * (L / N)
    rng = np.random.default_rng(17)
    cat = T.HaloNDCatalog(x=rng.uniform(6, 54, 10), y=rng.uniform(6, 54, 10),
                          M=10 ** rng.uniform(13.8, 14.7, 10),
                          redshift=0.25, cosmo=COSMO)
    kw = dict(verbose=False, device=device, precision=precision)
    models = {}
    for name in ("DarkMatter", "Gas"):
        models[name] = T.TabulatedProfile(getattr(T, name)(**PAR), cosmo)
        models[name].setup_interpolator(verbose=False, **EX14_GRID)
    gm0 = T.GriddedMap(map=np.zeros((N, N)), redshift=0.25, bins=bins,
                       cosmo=COSMO)
    base = T.PaintProfilesGrid(cat, gm0, epsilon_max=5,
                               model=models["DarkMatter"], **kw).process()
    gm = T.GriddedMap(map=base, redshift=0.25, bins=bins, cosmo=COSMO)
    model0 = T.Baryonification2D(T.DarkMatterOnly(**PAR),
                                 T.DarkMatterBaryon(**PAR), cosmo,
                                 epsilon_max=10)
    model0.setup_interpolator(verbose=False, **EX14_GRID)
    bary = T.BaryonifyGrid(cat, gm, epsilon_max=10, model=model0, **kw)
    anis = T.PaintProfilesAnisGrid(cat, gm, epsilon_max=5,
                                   Painting_model=models["Gas"],
                                   Canvas_model=models["DarkMatter"],
                                   method="cellmajor", **kw)
    remap = anis.build_remap_device().detach()

    def y_map(lnMc):
        table = table_of(T, cosmo, EX14_GRID, dict(PAR, M_c=torch.exp(lnMc)),
                         2, 10)
        return anis.process_device(remap=remap,
                                   canvas=bary.process_device(table=table))

    return y_map, base


def example17(T, torch, device):
    """examples/17_anis_paint_composition.py through the port on the card
    at its size, float64, with its three asserts and the gradient at the
    start against central differences. Returns seconds an Adam step."""
    f64 = dict(dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    y_map, base = ex17_chain(T, torch, device)
    check(int((base > 0).sum()) > 100, "ex17: scene painting failed")
    with torch.no_grad():
        data = y_map(torch.tensor(LN_MC_TRUE, **f64))
    check(bool(torch.isfinite(data).all()) and int((data > 0).sum()) > 50,
          "ex17: mock observable empty")
    log(f"ex17: staging and the truth's chain "
        f"{time.perf_counter() - t0:.2f} s; {int((data > 0).sum())} pixels "
        f"painted")
    scale = 1.0 / float(data.max()) ** 2
    chi2 = lambda x: ((y_map(x) - data) ** 2).sum() * scale * 1e6
    _, g_true = value_and_grad(torch, chi2, LN_MC_TRUE, device)[:2]
    c0, g_start = value_and_grad(torch, chi2, LN_MC_START, device)[:2]
    log(f"ex17: grad at truth {g_true:+.3e}, at start {g_start:+.3e}, chi2 "
        f"start {c0:.4e}")
    check(abs(g_true) < 0.05 * abs(g_start),
          "ex17: the gradient at the truth is not ~0")
    check(g_start * (LN_MC_START - LN_MC_TRUE) > 0,
          "ex17: the gradient at the start does not point to the truth")
    check_fd(torch, "ex17", chi2, LN_MC_START, g_start, device)

    def progress(step, params, loss, grad):
        if step % 5 == 0 or step == 24:
            log(f"ex17: step {step:2d}: ln M_c = {float(params):.4f} (truth "
                f"{LN_MC_TRUE:.4f}), chi2 = {loss:.4e}")

    t0 = time.perf_counter()
    res = T.fit(chi2, torch.tensor(LN_MC_START, **f64), steps=25,
                learning_rate=0.15, callback=progress)
    per_step = (time.perf_counter() - t0) / 25
    err = abs(float(res.params) - LN_MC_TRUE)
    off0 = abs(LN_MC_START - LN_MC_TRUE)
    log(f"ex17: recovered ln M_c = {float(res.params):.4f} (truth "
        f"{LN_MC_TRUE:.4f}; residual {err / off0:.1%} of the offset), chi2 "
        f"{c0:.4e} -> {res.loss:.4e} ({c0 / max(res.loss, 1e-300):.1f}x); "
        f"{per_step:.3f} s an Adam step")
    check(err < 0.10 * off0, "ex17: M_c not recovered through the "
          "composition")
    check(res.loss < c0 / 30, "ex17: chi2 did not drop 30x")
    return per_step


def ex17_path(T, torch, device):
    """Example 17 on the card; the scatter kernel and its backward (the
    CIC of BaryonifyGrid) and the anisotropic paint's kernels must have
    been launched."""
    reset_counts()
    per_step = example17(T, torch, device)
    read_counts("ex17 (example 17)", ("scatter_add", "scatter_add_vjp",
                                      "anis_pass", "anis_vjp"))
    return per_step


# ----- the asserted examples of the model layer (01, 03, 07, 08, 11, 13) -----

EX_COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
                w0=-1.0)
EX_A20 = dict(alpha_g=2, epsilon_h=0.015, M1_0=2.2e11 / 0.7, alpha_sat=1,
              M_c=1.2e14 / 0.7, eta=0.6, mu=0.31, beta=0.6,
              epsilon_hydro=np.sqrt(5), M_inn=3.3e13 / 0.7, M_r=1e30,
              beta_r=2, theta_inn=0.1, theta_out=1, theta_rg=0.3,
              sigma_rg=0.1, a=0.3, n=2, p=0.3, q=0.707)
EX_MASSES = np.array([1e13, 1e14, 1e15])
FIG1_CSV = ROOT / "examples" / "data" / "S19_Fig1_Scrapped.csv"
# examples/08_schneider19_profiles.py: curve -> (model key, RMS bar, dex)
FIG1_CURVES = {'STAR': ('star', 0.105), 'GAS1': ('gas_b3', 0.055),
               'GAS2': ('gas_b15', 0.055), 'GAS3': ('gas_b0', 0.055),
               '2HALO': ('twohalo', 0.032), 'DMO': ('dmo', 0.012),
               'DMB1': ('dmb_b3', 0.012), 'DMB2': ('dmb_b15', 0.012),
               'DMB3': ('dmb_b0', 0.012)}
FIG1_PANELS = {'components': ['STAR', 'GAS1', 'GAS2', 'GAS3', '2HALO'],
               'dm': ['DMO', 'DMB1', 'DMB2', 'DMB3']}


def host(x):
    """A tensor's values as float64 numpy (numpy input unchanged)."""
    return (x.detach().double().cpu().numpy() if hasattr(x, "detach")
            else np.asarray(x, dtype=np.float64))


def enclosed(cosmo, prof, r_max, masses, a, n=6000):
    """M(< r_max[i]) of ``prof`` at each mass: the trapezoid of 4 pi r^2
    rho on geomspace(1e-6, r_max, n), as examples 11 and 13 take it."""
    out = np.empty(len(masses))
    for i, (Mi, Ri) in enumerate(zip(masses, r_max)):
        rr = np.geomspace(1e-6, Ri, n)
        out[i] = np.trapezoid(4 * np.pi * rr ** 2
                              * host(prof.real(cosmo, rr, Mi, a)), rr)
    return out


def example01(T, device):
    """examples/01_profiles.py: the truncated NFW's M(<R_200c) = M, the
    baryon budget gas + stars = f_bar M_tot, and the one-halo DMB mass =
    the DMO's, each to 2%. Returns (values, failures)."""
    cosmo = T.Cosmology(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8,
                        n_s=0.96, device=device)
    S19 = T.profiles.Schneider19
    par = T.default_params()
    a = 1 / (1 + 0.25)
    m = EX_MASSES
    r_wide = np.geomspace(1e-6, 1000, 4000)
    fails, out = [], {}
    dm = S19.DarkMatter(**par)
    R200 = host(dm.mass_def.get_radius(cosmo, m, a)) / a
    rho_dm = host(dm.real(cosmo, r_wide, m, a))
    out["nfw"] = []
    for i, Mi in enumerate(m):
        sel = r_wide < R200[i]
        menc = np.trapezoid(4 * np.pi * r_wide[sel] ** 2 * rho_dm[i][sel],
                            r_wide[sel]) / Mi
        out["nfw"].append(menc)
        if abs(menc - 1) > 0.02:
            fails.append(f"NFW closure off at M={Mi:.1e}: {menc:.4f}")

    def sph_mass(prof, r_int):
        rho = host(prof.real(cosmo, r_int, m, a))
        return np.trapezoid(4 * np.pi * r_int ** 2 * rho, r_int, axis=-1)

    M_tot = sph_mass(dm, r_wide)
    M_gas = sph_mass(S19.Gas(**par), r_wide)
    M_str = sph_mass(S19.Stars(**par), np.geomspace(1e-6, 10, 4000))
    A_, M1_, tau_, eta_ = par["A"], par["M1"], par["tau"], par["eta"]
    f_star = 2 * A_ / ((m / M1_) ** tau_ + (m / M1_) ** eta_)
    f_cga = 2 * A_ / ((m / M1_) ** (tau_ + par["tau_delta"])
                      + (m / M1_) ** (eta_ + par["eta_delta"]))
    f_bar = cosmo.Omega_b / cosmo.Omega_m
    budget = ((M_gas + M_str) / M_tot + (f_star - f_cga)) / f_bar
    out["budget"] = budget.tolist()
    if np.any(np.abs(budget - 1) > 0.02):
        fails.append(f"baryon budget violated: {budget}")
    r_m = np.geomspace(1e-6, 100, 4000)
    th = host(S19.TwoHalo(**par).real(cosmo, r_m, m, a))
    rho_dmb = host(S19.DarkMatterBaryon(**par).real(cosmo, r_m, m, a)) - th
    rho_dmo = host(S19.DarkMatterOnly(**par).real(cosmo, r_m, m, a)) - th
    closure = (np.trapezoid(4 * np.pi * r_m ** 2 * rho_dmb, r_m, axis=-1)
               / np.trapezoid(4 * np.pi * r_m ** 2 * rho_dmo, r_m, axis=-1))
    out["closure"] = closure.tolist()
    if np.any(np.abs(closure - 1) > 0.02):
        fails.append(f"DMB/DMO one-halo mass closure violated: {closure}")
    return out, fails


class GaussianProfile:
    """examples/03's smooth compact test profile exp(-r^2 / 2 s^2), in
    torch (the example's own is in jax.numpy)."""

    def __init__(self, s, proto):
        self.s = s
        self.precision_fftlog = proto.precision_fftlog

    def projected(self, cosmo, r, M, a):
        import torch
        return torch.exp(-cosmo.tensor(r) ** 2 / (2.0 * self.s ** 2))


def hankel_convolve(torch, theta_src, sigma_src, beam_of_ell, ell,
                    theta_query, device, chunk=256):
    """examples/03's brute-force flat-sky convolution by direct quadrature
    (forward J0 Hankel of the profile, times the beam, J0 back), with the
    example's trapezoid weights and ell chunks, on ``device`` in float64
    (``torch.special.bessel_j0`` in place of scipy's j0)."""
    f64 = dict(dtype=torch.float64, device=device)
    w = torch.as_tensor(np.gradient(theta_src) * theta_src * sigma_src, **f64)
    th = torch.as_tensor(theta_src, **f64)
    ell_t = torch.as_tensor(ell, **f64)
    g = torch.empty_like(ell_t)
    for i0 in range(0, len(ell), chunk):
        g[i0:i0 + chunk] = torch.special.bessel_j0(
            torch.outer(ell_t[i0:i0 + chunk], th)) @ w
    integ = ell_t * torch.as_tensor(beam_of_ell(ell), **f64) * g
    back = torch.special.bessel_j0(torch.outer(
        torch.as_tensor(theta_query, **f64), ell_t))
    return host(torch.trapezoid(back * integ, ell_t, dim=1))


def example03(T, torch, device, anchors=(1, 2, 3)):
    """examples/03_pixel_smoothing.py: the pixel-window pipeline
    (ConvolvedProfile) against brute-force Hankel quadrature (anchors 1-3:
    harmonic and tophat machinery on Gaussian sources, < 5e-4 and < 2e-4,
    and the S19 Gas profile through HealPixel(128), < 2e-2), the tophat's
    2D-integral conservation (< 5e-3), and the shape of the suppression.
    ``anchors`` names the quadratures to run. Returns (values,
    failures)."""
    cosmo = T.Cosmology.from_dict(EX_COSMO, device=device)
    gas = T.Gas(**T.default_params())
    M, a = 1e14, 0.8
    r = np.geomspace(0.05, 5, 10)
    raw = host(gas.projected(cosmo, r, M, a))
    grid = host(T.ConvolvedProfile(gas, T.GridPixelApprox(0.3))
                .projected(cosmo, r, M, a))
    px_hp = T.HealPixel(NSIDE=128)
    beam = host(T.ConvolvedProfile(gas, px_hp).projected(cosmo, r, M, a))
    fails, out = [], {}
    D_A = float(host(cosmo.comoving_angular_distance(a)))
    sig_beam = px_hp.size / np.sqrt(8 * np.log(2)) / np.sqrt(2)
    hp_beam = lambda ell: np.exp(-ell * (1 + ell) / 2 * sig_beam ** 2)
    if 1 in anchors:
        gsrc = GaussianProfile(3.0, gas)
        r_q1 = np.geomspace(2.2, 11.0, 10)
        got1 = host(T.ConvolvedProfile(gsrc, px_hp)
                    .projected(cosmo, r_q1, M, a))
        th = np.geomspace(1e-6, 0.2, 40000)
        want1 = hankel_convolve(
            torch, th, np.exp(-(th * D_A) ** 2 / (2 * gsrc.s ** 2)),
            hp_beam, np.arange(0.25, 4000.0, 0.5), r_q1 / D_A, device)
        out["anchor1"] = float(np.max(np.abs(got1 / want1 - 1)))
        if not out["anchor1"] < 5e-4:
            fails.append(f"harmonic-branch machinery: {out['anchor1']:.3e}")
    if 2 in anchors:
        gsrc2 = GaussianProfile(0.5, gas)
        px_g = T.GridPixelApprox(0.3)
        r_q2 = np.geomspace(0.1, 1.2, 10)
        got2 = host(T.ConvolvedProfile(gsrc2, px_g)
                    .projected(cosmo, r_q2, M, a))
        th2 = np.geomspace(1e-5, 20.0, 40000)
        want2 = hankel_convolve(
            torch, th2, np.exp(-th2 ** 2 / (2 * gsrc2.s ** 2)),
            lambda k: host(px_g.projected(torch.as_tensor(k))),
            np.arange(0.005, 80.0, 0.01), r_q2, device)
        out["anchor2"] = float(np.max(np.abs(got2 / want2 - 1)))
        if not out["anchor2"] < 2e-4:
            fails.append(f"tophat-branch machinery: {out['anchor2']:.3e}")
    if 3 in anchors:
        r_src = np.geomspace(1e-4, 1000.0, 80000)
        sig_src = host(gas.projected(cosmo, r_src, M, a))
        r_q3 = np.geomspace(2.2, 20.0, 12)
        got3 = host(T.ConvolvedProfile(gas, px_hp)
                    .projected(cosmo, r_q3, M, a))
        want3 = hankel_convolve(torch, r_src / D_A, sig_src, hp_beam,
                                np.arange(0.25, 6000.0, 0.5), r_q3 / D_A,
                                device)
        out["anchor3"] = float(np.max(np.abs(got3 / want3 - 1)))
        if not out["anchor3"] < 2e-2:
            fails.append(f"Gas harmonic-pipeline parity: "
                         f"{out['anchor3']:.3e}")
    r_wide = np.geomspace(0.45, 60.0, 400)
    m_raw = np.trapezoid(2 * np.pi * r_wide
                         * host(gas.projected(cosmo, r_wide, M, a)), r_wide)
    m_s = np.trapezoid(2 * np.pi * r_wide
                       * host(T.ConvolvedProfile(gas, T.GridPixelApprox(0.3))
                              .projected(cosmo, r_wide, M, a)), r_wide)
    out["conservation"] = float(m_s / m_raw - 1)
    if not abs(out["conservation"]) < 5e-3:
        fails.append("tophat conservation broken")
    ratio = beam / raw
    out["ratio_hp"] = ratio.tolist()
    for ok, what in ((ratio[0] < 0.15, "no deep small-scale suppression at "
                      "NSIDE=128"),
                     (grid[0] / raw[0] < 0.95, "no small-scale suppression "
                      "at size=0.3"),
                     (np.all(np.diff(ratio) > 0), "beam suppression not "
                      "monotone in r"),
                     (ratio[7] < 0.8 and ratio[9] > 1.3,
                      "beam crossover moved")):
        if not ok:
            fails.append(what)
    return out, fails


def example07(T, device):
    """examples/07_shocks.py: ShockedGas over Gas has the Rankine-Hugoniot
    0.25 floor and an unshocked core (1e-3), the 0.625 midpoint at
    epsilon_shock R_200c (1e-6), the analytic logistic slope (2%), and a
    half-drop radius that scales with epsilon_shock (2%). Returns (values,
    failures)."""
    cosmo = T.Cosmology.from_dict(EX_COSMO, device=device)
    par = T.default_params()
    M, a, width = 1e14, 0.8, 0.1
    gas = T.Gas(**par)
    R = float(host(gas.mass_def.get_radius(cosmo, M, a))) / a
    fails, out = [], {}
    for eps in (2.0, 4.0, 6.0):
        sg = T.ShockedGas(epsilon_shock=eps, width_shock=width, **par)
        r_sh = eps * R

        def ratio(rq):
            rq = np.atleast_1d(np.asarray(rq, dtype=float))
            return float((host(sg.real(cosmo, rq, M, a))
                          / host(gas.real(cosmo, rq, M, a)))[0])

        far = ratio(r_sh * np.exp(10 * width))
        inner = ratio(r_sh * np.exp(-10 * width))
        mid = ratio(r_sh)
        h = 0.02 * width
        slope = (ratio(r_sh * np.exp(h)) - ratio(r_sh * np.exp(-h))) / (2 * h)
        slope_want = -(1 - 0.25) / (4 * width)
        out[f"eps{eps:g}"] = dict(floor=far, core=inner, mid=mid,
                                  slope=slope)
        if abs(far - 0.25) > 1e-3:
            fails.append(f"eps={eps}: floor {far} != 0.25")
        if abs(inner - 1.0) > 1e-3:
            fails.append(f"eps={eps}: core {inner} != 1")
        if abs(mid - 0.625) > 1e-6:
            fails.append(f"eps={eps}: midpoint {mid} != 0.625")
        if abs(slope - slope_want) > 0.02 * abs(slope_want):
            fails.append(f"eps={eps}: slope {slope} != {slope_want}")
    r_scan = np.geomspace(0.05 * R, 40 * R, 4000)
    g_scan = host(gas.real(cosmo, r_scan, M, a))
    for e1, e2 in ((2.0, 4.0), (4.0, 6.0)):
        mids = []
        for e in (e1, e2):
            sg = T.ShockedGas(epsilon_shock=e, width_shock=width, **par)
            rat = host(sg.real(cosmo, r_scan, M, a)) / g_scan
            mids.append(r_scan[np.argmin(np.abs(rat - 0.625))])
        got = mids[1] / mids[0]
        out[f"scaling{e1:g}-{e2:g}"] = float(got)
        if abs(got - e2 / e1) > 0.02 * (e2 / e1):
            fails.append(f"shock radius ratio {got} != {e2 / e1}")
    return out, fails


def load_scraped_fig1(path=FIG1_CSV):
    """examples/08's scraped S19 Fig. 1 curves as {name: (X, Y)}, NaN rows
    dropped (X in Mpc/h)."""
    names = ['STAR', 'GAS1', 'GAS2', 'GAS3', '2HALO', 'TOTAL', 'R200',
             'DMO', 'DMB1', 'DMB2', 'DMB3']
    raw = np.genfromtxt(path, delimiter=',', skip_header=2)
    out = {}
    for i, nm in enumerate(names):
        X, Y = raw[:, 2 * i], raw[:, 2 * i + 1]
        ok = np.isfinite(X) & np.isfinite(Y)
        out[nm] = (X[ok], Y[ok])
    return out


def fig1_curves(T, device, r):
    """examples/08's nine Fig. 1 model curves rho(r) at M = 1e14/h, z = 0
    (its notebook cosmology and parameters), on ``device``."""
    h = 0.67
    cosmo = T.Cosmology(Omega_m=0.32, Omega_b=0.048, h=h, sigma8=0.83,
                        n_s=0.96, device=device)
    bpar = dict(theta_ej=4, theta_co=0.1, mu_beta=1, eta=0.3, eta_delta=0.3,
                tau=0, tau_delta=0, A=0.09 / 2, M1=2.5e11 / h,
                epsilon_h=0.015, a=0.3, n=2, epsilon=4, p=0.3, q=0.707,
                cdelta=6.71, gamma=2, delta=7)
    models = {
        'gas_b0': T.Gas(M_c=np.inf, **bpar),
        'gas_b15': T.Gas(M_c=1e14 / h, **bpar),
        'gas_b3': T.Gas(M_c=1e-10, **bpar),
        'star': T.Stars(**bpar),
        'twohalo': T.TwoHalo(**bpar),
        'dmo': T.DarkMatterOnly(**bpar),
        'dmb_b0': T.DarkMatterBaryon(M_c=np.inf, **bpar),
        'dmb_b15': T.DarkMatterBaryon(M_c=1e14 / h, **bpar),
        'dmb_b3': T.DarkMatterBaryon(M_c=1e-10, **bpar)}
    return {k: host(v.real(cosmo, r, 1e14 / h, 1.0))
            for k, v in models.items()}, h


def fig1_points(scraped, r, curves, h):
    """Per Fig. 1 curve: (the model curve's log-slope, log10 model /
    scraped) at the scraped points (examples/08's _curve_points)."""
    pts = {}
    for nm, (key, _) in FIG1_CURVES.items():
        X, Y = scraped[nm]
        if nm == '2HALO':
            keep = X > 0.01
            X, Y = X[keep], Y[keep]
        r_mpc = X / h
        mfull = r ** 2 * curves[key] if nm.startswith('DM') \
            else curves[key] / h ** 2
        res = np.log10(np.interp(np.log(r_mpc), np.log(r), mfull) / Y)
        lnr, lnm = np.log(r), np.log(np.maximum(mfull, 1e-300))
        slope = np.interp(np.log(r_mpc), 0.5 * (lnr[1:] + lnr[:-1]),
                          np.diff(lnm) / np.diff(lnr))
        pts[nm] = (slope, res)
    return pts


def example08(T, device):
    """examples/08_schneider19_profiles.py: each Fig. 1 curve's RMS log10
    deviation from the scraped points within its bar, and the
    scrape-jitter fit's normalised residual std in [0.8, 1.2] on both
    panels (scipy's Nelder-Mead, as the example). Returns (values,
    failures)."""
    from scipy.optimize import minimize
    r = np.geomspace(1e-3, 50, 1000)
    curves, h = fig1_curves(T, device, r)
    pts = fig1_points(load_scraped_fig1(), r, curves, h)
    fails, out = [], {"rms": {}, "jitter": {}}
    for nm, (key, tol) in FIG1_CURVES.items():
        rms = float(np.sqrt(np.mean(pts[nm][1] ** 2)))
        out["rms"][nm] = rms
        if not rms < tol:
            fails.append(f"Fig. 1 {nm}: RMS {rms:.4f} dex >= {tol}")
    for panel, names in FIG1_PANELS.items():
        s = np.concatenate([pts[n][0] for n in names])
        q = np.concatenate([pts[n][1] for n in names])

        def nll(p):
            sx, sy = np.abs(p)
            var = sy ** 2 + (s * sx) ** 2
            return np.sum(0.5 * np.log(var) + 0.5 * q ** 2 / var)

        sx, sy = np.abs(minimize(nll, [0.01, 0.01],
                                 method='Nelder-Mead').x)
        z_std = float(np.std(q / np.sqrt(sy ** 2 + (s * sx) ** 2)))
        out["jitter"][panel] = (float(sx), float(sy), z_std)
        if not 0.8 < z_std < 1.2:
            fails.append(f"jitter:{panel} std {z_std:.3f}")
    return out, fails


def example11(T, device):
    """examples/11_arico_profiles.py: each Arico20 gas and stellar
    component integrates to its bookkeeping fraction, and the budget
    closes at f_bar, each to 2%. Returns (values, failures)."""
    cosmo = T.Cosmology.from_dict(EX_COSMO, device=device)
    A20 = T.profiles.Arico20
    apar = dict(EX_A20, A_nt=0.495, alpha_nt=0.1,
                mean_molecular_weight=0.59)
    a = 0.8
    z = 1 / a - 1
    m = EX_MASSES
    bg = A20.BoundGas(**apar)
    mt = cosmo.tensor(m)
    fr = {k: host(v) for k, v in bg._gas_fractions(cosmo, mt, z).items()}
    f_cg = host(bg._get_star_frac(mt, z))
    f_sg = host(bg._get_star_frac(mt, z, satellite=True))
    R200 = host(bg.mass_def.get_radius(cosmo, m, a)) / a
    checks = [("BoundGas(<R) = f_bg M", bg, R200, fr["f_bg"]),
              ("ReaccretedGas(<R) = f_rg M", A20.ReaccretedGas(**apar), R200,
               fr["f_rg"]),
              ("EjectedGas(tot) = f_eg M", A20.EjectedGas(**apar),
               60 * R200, fr["f_eg"]),
              ("Stars(tot) = f_cg M", A20.Stars(**apar), 20 * R200, f_cg)]
    fails, out = [], {}
    tot = np.zeros(len(m))
    for name, prof, r_max, want in checks:
        got = enclosed(cosmo, prof, r_max, m, a)
        ratio = got / (want * m)
        tot += got / m
        out[name] = ratio.tolist()
        if np.any(np.abs(ratio - 1) > 0.02):
            fails.append(f"{name}: {ratio}")
    budget = (tot + f_sg) / fr["f_bar"]
    out["budget"] = budget.tolist()
    if np.any(np.abs(budget - 1) > 0.02):
        fails.append(f"baryon budget: {budget}")
    return out, fails


def example13(T, device):
    """examples/13_mead_profiles.py: for both TAGN calibrations, each
    Mead20 component integrates to its bookkeeping fraction and the
    components close at M, each to 2%. Returns (values, failures)."""
    cosmo = T.Cosmology.from_dict(EX_COSMO, device=device)
    M20 = T.profiles.Mead20
    a = 0.8
    m = EX_MASSES
    mt = cosmo.tensor(m)
    fails, out = [], {}
    for name in ("Params_TAGN_7p6", "Params_TAGN_8p0"):
        par = dict(getattr(M20, name))
        dm = M20.DarkMatter(**par)
        R200 = host(dm.mass_def.get_radius(cosmo, m, a)) / a
        f_str, f_cen, f_sat = (host(x) for x in dm._get_fstar(mt, a))
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        f_bnd = host(dm._f_bnd(cosmo, mt, a))
        checks = [
            ("DM M_enc(R) = M", dm, R200, np.ones(3)),
            ("BoundGas(<R) = f_bnd M", M20.BoundGas(**par), R200, f_bnd),
            ("EjectedGas(tot) = f_ej M", M20.EjectedGas(**par), 400 * R200,
             f_bar - f_str - f_bnd),
            ("Stars(tot) = f_cen M", M20.Stars(**par), 20 * R200, f_cen),
            ("CLM(<R) = (1 - f_bar + f_sat) M",
             M20.CollisionlessMatter(**par), R200, 1 - f_bar + f_sat)]
        tot = np.zeros(len(m))
        for label, prof, r_max, want in checks:
            got = enclosed(cosmo, prof, r_max, m, a)
            ratio = got / (want * m)
            if label != "DM M_enc(R) = M":
                tot += got / m
            out[f"{name} {label}"] = ratio.tolist()
            if np.any(np.abs(ratio - 1) > 0.02):
                fails.append(f"{name} {label}: {ratio}")
        out[f"{name} total"] = tot.tolist()
        if np.any(np.abs(tot - 1) > 0.02):
            fails.append(f"{name} total closure: {tot}")
    return out, fails


def examples_path(T, torch, device):
    """The asserts of examples 01, 03, 07, 08, 11 and 13 through the port
    on the card, at the scripts' own bars (examples 03's three Hankel
    quadratures on the card in float64). Fails if any assert misses.
    Returns {example: seconds}."""
    seconds = {}
    for name, fn in (("01", lambda: example01(T, device)),
                     ("03", lambda: example03(T, torch, device)),
                     ("07", lambda: example07(T, device)),
                     ("08", lambda: example08(T, device)),
                     ("11", lambda: example11(T, device)),
                     ("13", lambda: example13(T, device))):
        t0 = time.perf_counter()
        values, fails = fn()
        sync(torch)
        seconds[name] = time.perf_counter() - t0
        log(f"examples: {name} in {seconds[name]:.2f} s: "
            + json.dumps(values, default=float))
        check(not fails, f"example {name}: " + "; ".join(fails))
    return seconds


# ----- the mesh path: mesh= on the runners (parallel.py) -----

# a 2-rank float32 result against the same inputs' 1-rank or single-device
# run, rms/mean of the map (rms over rms of the offsets, for the
# snapshot): every rank's passes take the same values as one device's,
# but the joins add the partial maps in another grouping and the grid
# and snapshot passes group their slot sums by the rank's chunks, so
# float32 rounds apart by a few ulps a value (~1e-7 relative)
MESH_F32_BAR = 1e-5
# the gradient (in ln M_c, or a table scale) of a 2-rank float32 step
# against the 1-rank or single-device step, relative
MESH_GRAD_BAR = 1e-5
MESH_RANKS = 2
MESH_TIMEOUT_S = 300


def sync(torch):
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class TableModel:
    """A displacement model that is its table (what the runners read of
    one), rebuilt from arrays that another process made."""

    p_keys = []
    Rdelta_sampling = False

    def __init__(self, torch, device, grids, table):
        self._grids = tuple(torch.as_tensor(g, device=device) for g in grids)
        self._table = torch.as_tensor(table, device=device)


def mesh_inputs(T, torch, device, path):
    """Build the tables of the mesh runs on the card once (shell-1e6's,
    grid-256's and snap-5e6's, grid2d's, the tSZ tables at NSIDE 1024 and
    32 and anis-2048's canvas) and save their arrays to ``path`` for the
    ranks. Returns the shell's model."""
    arrs = {}

    def put(name, grids, *tabs):
        for i, g in enumerate(grids):
            arrs[f"{name}_g{i}"] = host(g)
        for i, t in enumerate(tabs):
            arrs[f"{name}_t{i}"] = host(t)

    shell = model_for(T, device, BENCH_GRID)
    put("shell", shell._grids, shell._table)
    for dim in (3, 2):
        m = grid_model(T, torch, device, dim)
        put(f"grid{dim}d", m._grids, m._table)
    for name, m in (("tsz1024", tsz_model(T, torch, device, 1024)),
                    ("tsz32", tsz_model(T, torch, device, 32)),
                    ("dm", grid_model(T, torch, device, 2, "dm"))):
        put(name, m._grids, m._ln3D, m._ln2D)
    np.savez(path, **arrs)
    return shell


def mesh_models(T, torch, device, path):
    """The models of :func:`mesh_inputs` from its arrays, on ``device``."""
    z = np.load(path)
    cosmo = T.Cosmology.from_dict(COSMO, device=device)

    def grids(name):
        return [z[f"{name}_g{i}"] for i in range(3)]

    out = {n: TableModel(torch, device, grids(n), z[f"{n}_t0"])
           for n in ("shell", "grid3d", "grid2d")}
    for n in ("tsz1024", "tsz32", "dm"):
        out[n] = T.TabulatedProfile(T.Gas(), cosmo).from_arrays(
            grids(n), z[f"{n}_t0"], z[f"{n}_t1"])
    return out


def shell_value_and_grad(T, torch, runner, device):
    """The grad phase's float32 step on a shell runner: chi^2 of the map
    in ln M_c (build_table_device -> process_device) at example 14's
    start against its truth's map. Returns (chi^2, d chi^2 / d ln M_c,
    seconds of the step)."""
    cosmo = T.Cosmology.from_dict(COSMO, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    tab = lambda x: table_of(T, cosmo, BENCH_GRID, dict(PAR, M_c=torch.exp(x)))
    with torch.no_grad():
        target = runner.process_device(
            tab(torch.tensor(LN_MC_TRUE, **f64))).double()
    x = torch.tensor(LN_MC_START, **f64, requires_grad=True)
    sync(torch)
    t0 = time.perf_counter()
    loss = ((runner.process_device(tab(x)).double() - target) ** 2).sum()
    (g,) = torch.autograd.grad(loss, x)
    sync(torch)
    return float(loss.detach()), float(g), time.perf_counter() - t0


def scale_value_and_grad(torch, runner, device, seed=0):
    """value_and_grad of sum(w * map(table * s)) at s = 1, w a fixed
    random weighting (float32 process_device of a grid runner). Returns
    (value, gradient, seconds)."""
    shape = runner.GriddedMap.map.shape
    w = torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                        dtype=torch.float64, device=device)
    s = torch.tensor(1.0, dtype=torch.float64, device=device,
                     requires_grad=True)
    sync(torch)
    t0 = time.perf_counter()
    loss = (w * runner.process_device(
        table=runner.model._table * s).double()).sum()
    (g,) = torch.autograd.grad(loss, s)
    sync(torch)
    return float(loss.detach()), float(g), time.perf_counter() - t0


def digest(a):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def warm_stages(runner):
    """One more process() with the runner's stages: (seconds, stages)."""
    runner.profile, runner.stage_times = True, []
    t0 = time.perf_counter()
    runner.process()
    t = time.perf_counter() - t0
    runner.profile = False
    return t, [(k, round(v, 4)) for k, v in runner.stage_times]


def mesh_rank_runs(T, torch, cmc, sc, mesh, device, rank, world, work,
                   n_halo, nside):
    """One rank's share of the mesh phase: each run through ``mesh=`` with
    this rank's launch counts read after it, held against the 1-rank run
    (the shell, from ``work``) or rank 0's single-device run of the same
    inputs (the others). Returns a dict for the phase's record."""
    from baryonification_tpu_torch import parallel as tp
    models = mesh_models(T, torch, device, work / "inputs.npz")
    ref = json.loads((work / "parent.json").read_text())
    tag = f"({world} gloo ranks on one card, rank {rank})"
    out = {"launches": PATH_LAUNCHES, "digests": {}}

    def timed_run(label, runner, expected):
        reset_counts()
        with plain_on_card(cmc, sc) as plain:
            t0 = time.perf_counter()
            res = runner.process()
            cold = time.perf_counter() - t0
        read_counts(f"mesh {label} {tag}", expected)
        check(not plain, f"mesh {label}: plain versions ran on the card: "
              f"{plain}")
        return res, cold

    def against_single(label, res, mk, diff):
        """Rank 0: the single-device run of the same inputs, and the
        2-rank result's distance from it (bar MESH_F32_BAR)."""
        if rank != 0:
            return None
        single = mk(None).process()
        d = diff(res, single)
        log(f"mesh: {label}: {world} ranks against one device: {d:.3e} "
            f"(bar {MESH_F32_BAR:g})")
        check(d < MESH_F32_BAR, f"mesh {label}: {world} ranks differ from "
              f"one device by {d:.3e}")
        return d

    # shell-1e6, held against the 1-rank run's map
    cat, shell = catalog(T, n_halo, nside)
    runner = T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                              model=models["shell"], verbose=False,
                              device=device, mesh=mesh)
    check(runner.method == "cellmajor", "mesh: auto is not cellmajor")
    with deterministic(torch):
        # the rank's first regrid: it fills the process's ring table
        m, cold = timed_run("shell-1e6", runner,
                            CELLMAJOR + REGRID_DET + ["regrid_rings"])
        warm, stages = warm_stages(runner)
    one = np.load(work / "shell_1rank.npy").astype(np.float64)
    rms, rel = map_diff(m, one)
    check(rms < MESH_F32_BAR, f"mesh shell-1e6: {world} ranks against 1: "
          f"rms/mean {rms:.3e}")
    out["digests"]["shell"] = digest(m)
    out["shell"] = dict(cold_s=cold, warm_s=warm, stages=stages,
                        passes_s=sum(v for k, v in stages
                                     if k.startswith("pass[")),
                        rms_vs_1rank=rms, max_vs_1rank=rel,
                        bitwise_vs_1rank=bool(np.array_equal(m, one)))
    # the join alone: one sum of a full-size float32 map over the group
    x = torch.ones(12 * nside ** 2, dtype=torch.float32, device=device)
    tp.mesh_sum(mesh, "cells", x)
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(5):
        tp.mesh_sum(mesh, "cells", x)
    sync(torch)
    out["shell"]["join_s"] = (time.perf_counter() - t0) / 5
    reset_counts()
    with plain_on_card(cmc, sc) as plain:
        loss, g, secs = shell_value_and_grad(T, torch, runner, device)
    read_counts(f"mesh grad shell-1e6 {tag}",
                ("cellmajor_pass", "cellmajor_vjp", "regrid", "regrid_vjp"))
    check(not plain, f"mesh grad: plain versions ran on the card: {plain}")
    dg = abs(g - ref["grad"]) / abs(ref["grad"])
    check(dg < MESH_GRAD_BAR, f"mesh grad shell-1e6: {world} ranks "
          f"against 1: {dg:.3e}")
    out["grad_shell"] = dict(loss=loss, grad=g, step_s=secs, rel_vs_1rank=dg)
    del runner, x
    torch.cuda.empty_cache()

    # grid-256 (the CIC's scatter launches on every rank)
    dim, N, L, H = GRID_CELLS["grid"]
    cat, gm = nd_catalog(T, dim, N, L, H)
    mk = lambda mesh_: T.BaryonifyGrid(
        cat, gm, epsilon_max=GRID_EPS, model=models["grid3d"],
        verbose=False, device=device, mesh=mesh_, method="cellmajor")
    r = mk(mesh)
    g_map, cold = timed_run("grid-256", r, SCATTER + GRID)
    warm, stages = warm_stages(r)
    out["digests"]["grid"] = digest(g_map)
    out["grid"] = dict(cold_s=cold, warm_s=warm, stages=stages,
                       rms_vs_single=against_single(
                           "grid-256", g_map, mk,
                           lambda a, b: map_diff(a, b)[0]))
    del r, g_map
    torch.cuda.empty_cache()

    # a gradient step of grid2d at GRAD_SMALL's size (the CIC's backward
    # and the pass's row reads: scatter_add_vjp)
    dim, N, L, H = GRAD_SMALL["grid2d"]
    cat, gm = nd_catalog(T, dim, N, L, H)
    mk = lambda mesh_: T.BaryonifyGrid(
        cat, gm, epsilon_max=GRID_EPS, model=models["grid2d"],
        verbose=False, device=device, mesh=mesh_, method="cellmajor")
    reset_counts()
    with plain_on_card(cmc, sc) as plain:
        val, g, secs = scale_value_and_grad(torch, mk(mesh), device)
    read_counts(f"mesh grad grid2d-{N} {tag}",
                ["scatter_add", "scatter_add_vjp"] + GRID + ["grid_vjp"])
    check(not plain, f"mesh grad grid2d: plain versions ran on the card: "
          f"{plain}")
    out["grad_grid2d"] = dict(value=val, grad=g, step_s=secs)
    if rank == 0:
        _, g1, _ = scale_value_and_grad(torch, mk(None), device)
        dg = abs(g - g1) / abs(g1)
        check(dg < MESH_GRAD_BAR, f"mesh grad grid2d: {world} ranks "
              f"against one device: {dg:.3e}")
        out["grad_grid2d"]["rel_vs_single"] = dg

    # snap-5e6
    L, n_part, n_h = SNAP_CELL
    cat, snap = snap_inputs(T, L, n_part, n_h, seed=3)
    mk = lambda mesh_: T.BaryonifySnapshot(
        cat, snap, epsilon_max=SNAP_EPS, model=models["grid3d"],
        verbose=False, device=device, mesh=mesh_, method="cellmajor")
    new, cold = timed_run("snap-5e6", mk(mesh), SNAP)
    off = snap_offsets(snap, new)
    out["digests"]["snap"] = digest(off)
    out["snap"] = dict(cold_s=cold, rms_vs_single=against_single(
        "snap-5e6", off, mk,
        lambda a, b: offsets_diff(a, snap_offsets(snap, b))))
    del new, off
    torch.cuda.empty_cache()

    # tsz-1024's paint
    halos = tsz_catalog(n_halo)
    zero = T.LightconeShell(map=np.zeros(12 * nside ** 2), cosmo=COSMO)
    mk = lambda mesh_: T.PaintProfilesShell(
        T.HaloLightConeCatalog(cosmo=COSMO, **halos), zero,
        epsilon_max=GRID_PAINT_EPS, model=models["tsz1024"], verbose=False,
        device=device, mesh=mesh_, method="cellmajor")
    y, cold = timed_run("tsz-1024", mk(mesh), CELLMAJOR)
    check(y.sum() > 0 and y.min() >= 0, "mesh tsz: empty or negative")
    out["digests"]["tsz"] = digest(y)
    out["tsz"] = dict(cold_s=cold, rms_vs_single=against_single(
        "tsz-1024", y, mk, lambda a, b: map_diff(a, b)[0]))
    del y

    # anis-2048
    cat, gm = anis_catalog(T)
    mk = lambda mesh_: T.PaintProfilesAnisGrid(
        cat, gm, epsilon_max=GRID_PAINT_EPS, Painting_model=models["tsz32"],
        Canvas_model=models["dm"], verbose=False, device=device, mesh=mesh_,
        method="cellmajor")
    y, cold = timed_run("anis-2048", mk(mesh), ANIS)
    check(y.sum() > 0 and y.min() >= 0, "mesh anis: empty or negative")
    out["digests"]["anis"] = digest(y)
    out["anis"] = dict(cold_s=cold, rms_vs_single=against_single(
        "anis-2048", y, mk, lambda a, b: map_diff(a, b)[0]))
    return out


def mesh_rank_main(rank, world, init_file, root, work, n_halo, nside,
                   device_type="cuda"):
    """One gloo rank of the mesh phase, on cuda:0 (the card's machine has
    one card, and NCCL takes one rank a card; ``device_type`` "cpu" for a
    rehearsal): joins the group from a ``file://`` store, builds the 1-D
    mesh "cells", runs :func:`mesh_rank_runs` and writes its record to
    ``work/rank{rank}.json``. An exception ends the rank, and the
    phase."""
    sys.modules["jax"] = None
    sys.path.insert(0, root)
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import baryonification_tpu_torch as T
    from baryonification_tpu_torch.ops import anis_pass_cuda as apc
    from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
    from baryonification_tpu_torch.ops import grid_pass_cuda as gp
    from baryonification_tpu_torch.ops import regrid_cuda as rc
    from baryonification_tpu_torch.ops import scatter_cuda as sc
    from baryonification_tpu_torch.ops import snap_pass_cuda as spc

    COUNTERS.extend([sc.LAUNCHES, cmc.LAUNCHES, gp.LAUNCHES, rc.LAUNCHES,
                     spc.LAUNCHES, apc.LAUNCHES])
    SCATTER.append("scatter_add")
    CELLMAJOR.append("cellmajor_pass")
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device.type, (world,),
                                mesh_dim_names=("cells",))
        out = mesh_rank_runs(T, torch, cmc, sc, mesh, device, rank, world,
                             Path(work), n_halo, nside)
        (Path(work) / f"rank{rank}.json").write_text(
            json.dumps(out, default=float))
    finally:
        dist.destroy_process_group()


def mesh_path(T, torch, cmc, sc, device, root, n_halo, nside):
    """shell-1e6 (bench.py's table and catalog) through ``mesh=``: on a
    1-rank NCCL mesh in this process, held to process() bit for bit under
    deterministic algorithms, with a float32 gradient step; then on
    MESH_RANKS gloo ranks spawned on cuda:0, each also running grid-256, a
    grid2d gradient step, snap-5e6, tsz-1024's paint and anis-2048 once
    (see :func:`mesh_rank_runs`). Fails if a rank fails or the ranks'
    outputs differ. Returns the phase's record."""
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    work = ROOT / ".scratch" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_start = time.perf_counter()
    model = mesh_inputs(T, torch, device, work / "inputs.npz")
    cat, shell = catalog(T, n_halo, nside)
    mk = lambda mesh_: T.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                                        model=model, verbose=False,
                                        device=device, mesh=mesh_,
                                        method="cellmajor")
    out = {}
    single = mk(None)
    with deterministic(torch):
        ref = single.process()
        out["process_warm_s"], _ = warm_stages(single)
    del single
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{work}/store1",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh(device.type, (1,), mesh_dim_names=("cells",))
        runner = mk(mesh)
        reset_counts()
        with plain_on_card(cmc, sc) as plain, deterministic(torch):
            m1 = runner.process()
            warm, stages = warm_stages(runner)
        read_counts(f"mesh shell-1e6 (1 {backend} rank)",
                    CELLMAJOR + REGRID_DET)
        check(not plain, f"mesh: plain versions ran on the card: {plain}")
        check(np.array_equal(m1, ref), "mesh shell-1e6: the 1-rank mesh "
              "differs from process() (deterministic algorithms)")
        out["1rank"] = dict(warm_s=warm, stages=stages)
        reset_counts()
        with plain_on_card(cmc, sc) as plain:
            loss, g, secs = shell_value_and_grad(T, torch, runner, device)
        read_counts(f"mesh grad shell-1e6 (1 {backend} rank)",
                    ("cellmajor_pass", "cellmajor_vjp", "regrid",
                     "regrid_vjp"))
        check(not plain, f"mesh grad: plain versions ran on the card: "
              f"{plain}")
        out["1rank"].update(loss=loss, grad=g, step_s=secs)
    finally:
        dist.destroy_process_group()
    np.save(work / "shell_1rank.npy", m1.astype(np.float32))
    (work / "parent.json").write_text(json.dumps(dict(loss=loss, grad=g)))
    del runner, m1, ref
    torch.cuda.empty_cache()
    log(f"mesh: 1 {backend} rank: process() warm {out['process_warm_s']:.3f} s, "
        f"through mesh= {out['1rank']['warm_s']:.3f} s, bit for bit; "
        f"value_and_grad {secs:.3f} s, chi^2 {loss:.6e}, grad {g:+.6e}")

    t0 = time.perf_counter()
    mp.start_processes(mesh_rank_main,
                       args=(MESH_RANKS, str(work / "store2"), str(root),
                             str(work), n_halo, nside, device.type),
                       nprocs=MESH_RANKS, join=True, start_method="spawn")
    out["ranks_s"] = time.perf_counter() - t0
    recs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(MESH_RANKS)]
    digests = [rec.pop("digests") for rec in recs]
    for r, rec in enumerate(recs):
        check(digests[r] == digests[0],
              f"mesh: rank {r}'s outputs differ from rank 0's")
        for path, counts in rec.pop("launches").items():
            check(path not in PATH_LAUNCHES, f"path {path!r} read twice")
            PATH_LAUNCHES[path] = counts
        out[f"rank{r}"] = rec
    shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_start
    log("mesh: " + json.dumps(out, default=float))
    return out


def ptxas_summary(build_log):
    """[(kernel<type, rings per thread>, registers, spill bytes, static
    shared bytes)] from the output of ``ptxas -v``."""
    import re
    out, entry, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)I([fd])Li(\d+)", m.group(1))
            b = re.search(r"\d(cellmajor_kernel|adjoint_kernel)I([fd])"
                          r"Lb([01])ELb([01])ELb([01])E(Li([12])E)?",
                          m.group(1))
            g = re.search(r"\dgrid_kernelI([fd])Li([23])ELi([012])ELb([01])E",
                          m.group(1))
            rg = re.search(r"\d(regrid\w*_kernel)I([fd])E", m.group(1))
            sn = re.search(r"\dsnap_kernelI([fd])Lb([01])ELb([01])E",
                           m.group(1))
            an = re.search(r"\danis_kernelI([fd])Lb([01])E", m.group(1))
            entry = (f"{rg.group(1)}<{rg.group(2)}>" if rg else
                     f"anis_{('pass', 'vjp')[int(an.group(2))]}<"
                     f"{an.group(1)}>" if an else
                     f"snap_{('pass', 'vjp')[int(sn.group(3))]}<"
                     f"{sn.group(1)},rdelta={sn.group(2)}>" if sn else
                     f"grid_{('pass', 'vjp')[int(g.group(4))]}<{g.group(1)},"
                     f"dim={g.group(2)},mode={g.group(3)}>" if g else
                     f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k else
                     f"{b.group(1)}<{b.group(2)},paint={b.group(3)},"
                     f"rdelta={b.group(4)},patch={b.group(5)}"
                     + (f",order={b.group(7)}" if b.group(7) else "") + ">"
                     if b else m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out.append((entry, int(m.group(1)), spill,
                        int(sm.group(1)) if sm else 0))
    return out


def build_all(torch, sc, lc, cmc, gp, rc, spc, apc):
    """Compile every kernel source at once (one nvcc each, in parallel),
    then bind each kernel in both dtypes. The kernels of the paths (the
    scatter, the cell-major pass, the Legendre kernels at 8 rings per
    thread) must not spill registers."""
    from concurrent.futures import ThreadPoolExecutor
    from baryonification_tpu_torch import _cuda_build as cb

    def build(name):
        t0 = time.perf_counter()
        cb.load_library(name)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    names = sorted(p.stem for p in cb._CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        times = list(pool.map(build, names))
    for dt in (torch.float32, torch.float64):
        sc._kernel(dt)
        if "scatter_add_vjp" in sc.LAUNCHES:
            sc._kernel(dt, "scatter_add_vjp")
        cmc._kernel(dt)
        for entry in ADJOINT:
            if entry in cmc.LAUNCHES:
                cmc._kernel(dt, entry)
        lc._kernel("legendre_alm", dt)
        lc._kernel("legendre_synth", dt)
        for entry in gp.LAUNCHES:
            gp._kernel(dt, entry)
        for entry in rc._ARGTYPES:
            rc._kernel(dt, entry)
        for entry in spc.LAUNCHES:
            spc._kernel(dt, entry)
        for entry in apc.LAUNCHES:
            apc._kernel(dt, entry)
    log("build: " + ", ".join(f"{n}.cu {t:.2f} s" for n, t in times)
        + f"; all built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, text in getattr(cb, "BUILD_LOG", {}).items():
        rows = ptxas_summary(text)
        log(f"build: {name}.cu registers (spill bytes, static shared "
            f"bytes): " + ", ".join(f"{e} {r} ({sp}, {sm})"
                                    for e, r, sp, sm in rows))
        for e, r, sp, _ in rows:
            if e.startswith(("scatter_add", "cellmajor", "adjoint", "grid_",
                             "regrid", "snap_", "anis_")) \
                    or e.endswith(("<f,8>", "<d,8>")):
                check(sp == 0, f"{e} spills {sp} bytes of registers")


PHASES = ("kernels", "shell", "grad", "fit", "grid", "grid2d", "tsz",
          "families", "snap", "gradgrid", "gradsnap", "ex15", "anis", "pk",
          "cl", "synth", "reference", "examples", "mesh")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--halos", type=int, default=1_000_000)
    ap.add_argument("--nside", type=int, default=1024)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="directory that holds the package (default: this "
                         "script's); another checkout's package is then "
                         "driven and timed by this script, on its inputs")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import baryonification_tpu_torch as T
    from baryonification_tpu_torch.ops import anis_pass_cuda as apc
    from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
    from baryonification_tpu_torch.ops import grid_pass_cuda as gp
    from baryonification_tpu_torch.ops import legendre_cuda as lc
    from baryonification_tpu_torch.ops import regrid_cuda as rc
    from baryonification_tpu_torch.ops import scatter_cuda as sc
    from baryonification_tpu_torch.ops import snap_pass_cuda as spc
    from baryonification_tpu_torch.ops import spectra as sp
    check("jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                        if v is not None}, "JAX was imported")
    COUNTERS.extend([sc.LAUNCHES, lc.LAUNCHES, cmc.LAUNCHES, gp.LAUNCHES,
                     rc.LAUNCHES, spc.LAUNCHES, apc.LAUNCHES])
    SCATTER.append("scatter_add")
    CELLMAJOR.append("cellmajor_pass")

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()}), torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi_line}")

    build_all(torch, sc, lc, cmc, gp, rc, spc, apc)
    records = {}
    phase_s, mark = {}, [None, time.perf_counter()]

    def run(name):
        """True where phase ``name`` is asked for; the seconds since the
        previous phase began are that phase's."""
        now = time.perf_counter()
        if mark[0] in phases:
            phase_s[mark[0]] = round(now - mark[1], 1)
        mark[:] = [name, now]
        return name in phases

    if run("kernels"):
        records["scatter_add"] = check_scatter(T, torch, sc, device,
                                               args.halos, args.nside)
        records.update(check_legendre(
            torch, lc, sp, device, issue_bound=args.root.resolve() == ROOT))
        records["cellmajor_pass"] = check_cellmajor(
            T, torch, cmc, device, args.halos, args.nside,
            issue_bound=args.root.resolve() == ROOT)
        records.update(check_regrid(T, torch, rc, device, args.halos,
                                    args.nside,
                                    issue_bound=args.root.resolve() == ROOT))
    if args.halos != 1_000_000 or args.nside != 1024:
        log(f"cut: paths at NSIDE {args.nside}, shell path at "
            f"{args.halos} halos")
    if run("shell"):
        main_path(T, torch, device, args.halos, args.nside)
    if run("grad"):
        records["cellmajor_vjp"] = grad_path(
            T, torch, cmc, device, args.halos, args.nside,
            issue_bound=args.root.resolve() == ROOT)
    if run("fit"):
        records["cellmajor_vjp2"] = fit_path(T, torch, cmc, device)
    grid_checks = {}
    for cell in ("grid", "grid2d"):
        if run(cell):
            runs, grid_checks[cell] = grid_path(T, torch, device, cell)
            log(f"{cell}: scatter_add launches by run: " + ", ".join(
                f"{k} {c['scatter_add']}" for k, c in runs.items()))
    if grid_checks.get("grid"):
        # the timed run's bucket: grid-256's BaryonifyGrid (offsets),
        # float32
        res = grid_checks["grid"]["offsets", "float32"]
        records["grid_pass"] = kernel_record(
            "grid_pass", GRID_PASS_SOURCE, GRID_PASS_REPLACES, res["pass_"])
        records["grid_vjp"] = kernel_record(
            "grid_vjp", GRID_PASS_SOURCE, GRID_PASS_REPLACES, res["vjp"])
    if run("tsz"):
        tsz_path(T, torch, sp, sc, cmc, device, args.halos, args.nside)
    if run("families"):
        families_path(T, torch, device)
    if run("snap"):
        runs, snap_checks = snap_path(T, torch, sc, device)
        log("snap: scatter_add launches by run: " + ", ".join(
            f"{k} {c['scatter_add']}" for k, c in runs.items()))
        # the timed run's largest bucket: snap-5e6 (auto = cellmajor),
        # float32 (snap_vjp's record is gradsnap's)
        records["snap_pass"] = kernel_record(
            "snap_pass", SNAP_PASS_SOURCE, SNAP_PASS_REPLACES,
            snap_checks["float32"]["pass_"])
    if run("gradgrid"):
        records["scatter_add_vjp"], vjp = gradgrid_path(T, torch, sc, device)
        if vjp is not None:
            records["grid_vjp"] = kernel_record(
                "grid_vjp", GRID_PASS_SOURCE, GRID_PASS_REPLACES, vjp)
    if run("gradsnap"):
        records["snap_vjp"] = kernel_record(
            "snap_vjp", SNAP_PASS_SOURCE, SNAP_PASS_REPLACES,
            gradsnap_path(T, torch, device))
    if run("ex15"):
        ex15_path(T, torch, device)
    if run("anis"):
        anis, anis_checks = anis_path(T, torch, cmc, sc, device)
        anis["ex17_step_s"] = ex17_path(T, torch, device)
        log("anis: " + json.dumps(anis, default=str))
        # the timed runs' largest bucket: anis-2048 (auto = cellmajor),
        # float32
        for name, part in (("anis_pass", "pass_"), ("anis_vjp", "vjp")):
            records[name] = kernel_record(
                name, ANIS_PASS_SOURCE, ANIS_PASS_REPLACES,
                anis_checks["float32"][part])
    if run("pk"):
        pk_path(T, torch, device)
    if run("cl"):
        cl_path(T, torch, sp, device, args.nside)
    if run("synth"):
        synth_path(T, torch, sp, device, args.nside)
    if run("reference"):
        reference_check(T, torch, device)
        reference_spectra(T, torch, sp, device)
        reference_grid(T, torch, device)
        reference_models(T, torch, device)
    if run("examples"):
        secs = examples_path(T, torch, device)
        log("examples: seconds " + json.dumps(secs))
    if run("mesh"):
        mesh_path(T, torch, cmc, sc, device, args.root.resolve(),
                  args.halos, args.nside)

    run(None)
    log("phase seconds: " + json.dumps(phase_s))

    # each kernel's launches on every path that was driven, each path run
    # with the counts set to 0 just before it and read just after; the
    # line's launches are those of the run whose inputs give its time
    kernel_of = {k: k for k in sc.LAUNCHES}
    kernel_of.update({k: k for k in cmc.LAUNCHES})
    kernel_of.update({k: k for k in lc.LAUNCHES})
    kernel_of.update({k: k for k in gp.LAUNCHES})
    kernel_of.update({k: k for k in rc.LAUNCHES})
    kernel_of.update({k: k for k in spc.LAUNCHES})
    kernel_of.update({k: k for k in apc.LAUNCHES})
    for path, counts in PATH_LAUNCHES.items():
        for k, n in counts.items():
            if n:
                rec = records.setdefault(kernel_of[k], {})
                rec.setdefault("launches_by_path", {})[path] = n
    for name, rec in records.items():
        by_path = rec.get("launches_by_path", {})
        rec["launches"] = by_path.get(TIMED_RUN[name], 0)
        log(f"kernels line: {name} launches {rec['launches']} (the "
            f"{TIMED_RUN[name]!r} run, whose inputs give its time); "
            f"{sum(by_path.values())} on all paths: {by_path}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    kernels = {"kernels": [{k: rec.get(k) for k in keys}
                           for rec in records.values()]}
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi_line)
    if set(phases) != set(PHASES) or args.root.resolve() != ROOT:
        log(f"partial run (phases {phases}, package of {args.root}): no ok "
            f"record")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
