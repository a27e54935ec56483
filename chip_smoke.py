#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Drives the port's main path (baryonification_tpu_torch; no JAX) on the
card and fails on any fault:

  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the main path from csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes, with both times (CUDA events);
  4. main path: the Schneider19 displacement table built on the card
     (bench.py's grid) and BaryonifyShell.process() on an NSIDE-1024
     full-sky shell with bench.py's 1e6-halo catalog, cold and warm;
     asserts mass conservation, that the map changed, and that the
     kernels were launched;
  5. reference: a small shell on the card (float64 and float32) against
     the port's CPU float64 run, and a small table built on the card
     against the same table built on the CPU.

The last lines are a JSON record of the kernels, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None        # the port must run without JAX

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


def scatter_inputs(torch, device, npix, n_rows, seed=0):
    """~n_rows destination rows shaped like stage B of the main path:
    overlapping windows of consecutive pixels clustered on part of the
    sky (heavy duplicates), plus 30% out-of-range sentinel rows."""
    rng = np.random.default_rng(seed)
    n_sent = int(0.3 * n_rows)
    width = 700
    n_win = (n_rows - n_sent) // width
    centres = rng.integers(0, npix // 32, n_win)
    idx = (centres[:, None] + np.arange(width)[None, :]).reshape(-1)
    idx = np.concatenate([idx, np.full(n_sent, npix)])
    rng.shuffle(idx)
    vals = [rng.uniform(0.5, 1.5, idx.size) for _ in range(3)]
    base = [rng.uniform(0.0, 1.0, npix) for _ in range(3)]
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    return idx, vals, base, t


def check_scatter(torch, sc, device):
    """Kernel vs plain version at the main path's shapes; returns the
    record for the kernels line."""
    npix = 12 * 1024**2
    idx, vals, base, t = scatter_inputs(torch, device, npix, 4_000_000)
    idx_s, order = torch.sort(t(idx, torch.int32))
    per_pix = np.bincount(idx[idx < npix], minlength=npix)
    log(f"kernels: sorted_scatter_add inputs: Npix={npix} C=3 "
        f"rows={idx.size} sentinel={int((idx >= npix).sum())} "
        f"max rows/pixel={per_pix.max()} mean rows/touched pixel="
        f"{per_pix[per_pix > 0].mean():.2f}")
    errs = {}
    for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        v = tuple(t(x, dt)[order] for x in vals)
        acc_k = tuple(t(b, dt) for b in base)
        acc_p = tuple(t(b, dt) for b in base)
        sc.sorted_scatter_add(acc_k, idx_s, v)
        sc.scatter_add_accum_reference(acc_p, idx_s, v)
        acc_u = tuple(t(b, dt) for b in base)    # unsorted wrapper path
        sc.scatter_add_accum(acc_u, t(idx, torch.int32),
                             tuple(t(x, dt) for x in vals))
        torch.cuda.synchronize()
        for got_planes in (acc_k, acc_u):
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
                check(not bad, f"sorted_scatter_add {name} disagrees with "
                      f"the plain version: max err {float(err.max()):.3e} "
                      f"({tol})")
        log(f"kernels: sorted_scatter_add {name} agrees with plain "
            f"index_add_: max|err|={errs[name]:.3e} ({tol})")

    # times at the main path's dtype (float32), same sorted inputs
    v32 = tuple(t(x, torch.float32)[order] for x in vals)
    acc = tuple(t(b, torch.float32) for b in base)
    kern = lambda: sc.sorted_scatter_add(acc, idx_s, v32)
    plain = lambda: sc.scatter_add_accum_reference(acc, idx_s, v32)
    idx_u = t(idx, torch.int32)
    v32u = tuple(t(x, torch.float32) for x in vals)
    full = lambda: sc.scatter_add_accum(acc, idx_u, v32u)
    for fn in (kern, plain, full):
        fn()
    torch.cuda.synchronize()
    n = 20
    ms_p1, ms_k1 = cuda_ms(torch, plain, n), cuda_ms(torch, kern, n)
    ms_k2, ms_p2 = cuda_ms(torch, kern, n), cuda_ms(torch, plain, n)
    ms_full = cuda_ms(torch, full, n)
    ms_k, ms_p = (ms_k1 + ms_k2) / 2, (ms_p1 + ms_p2) / 2
    log(f"kernels: sorted_scatter_add f32 C=3 4M rows: kernel {ms_k:.4f} ms "
        f"(runs {ms_k1:.4f}, {ms_k2:.4f}), plain index_add_ {ms_p:.4f} ms "
        f"(runs {ms_p1:.4f}, {ms_p2:.4f}); with the sort "
        f"(scatter_add_accum) {ms_full:.4f} ms")
    return dict(name="sorted_scatter_add", route="cuda",
                source="baryonification_tpu_torch/csrc/sorted_scatter_add.cu",
                replaces="baryonification_tpu/ops/scatter_pallas.py:117",
                max_abs_err=errs["f32"], ms=ms_k, plain_ms=ms_p)


def main_path(T, torch, sc, device, n_halo, nside):
    """Table build on the card, then process() cold and warm. Returns the
    kernel launch counts of the cold run."""
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
    for k in sc.LAUNCHES:
        sc.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    new_map = runner.process()
    t_cold = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    log(f"main: process() cold {t_cold:.2f} s, NSIDE={nside}, "
        f"{n_halo} halos, method={runner.method}, dtype={runner.dtype}, "
        f"kernel launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"the main path launched kernel {k} no time")
    check(new_map.shape == shell.map.shape and np.isfinite(new_map).all(),
          "map of the wrong shape or not finite")
    new_sum, old_sum = new_map.sum(), shell.map.sum()
    check(np.isclose(new_sum, old_sum),
          f"mass not conserved: {new_sum!r} != {old_sum!r}")
    check(not np.allclose(new_map, shell.map), "the map did not change")
    log(f"main: mass conserved: sum(new)={new_sum:.10e} "
        f"sum(old)={old_sum:.10e} (np.isclose); max|change|="
        f"{np.abs(new_map - shell.map).max():.4e}")

    runner.profile = True
    runner.stage_times = []
    t0 = time.perf_counter()
    warm_map = runner.process()
    t_warm = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in runner.stage_times)
    log(f"main: process() warm {t_warm:.2f} s (stages, synced: {stages})")
    check(np.isclose(warm_map.sum(), old_sum), "warm run lost mass")
    return launches


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
    want = T.BaryonifyShell(cat, shell, device="cpu", **kw).process()
    scale = shell.map.mean()
    for prec, bar in (("float64", 1e-10), ("float32", 5e-5)):
        got = T.BaryonifyShell(cat, shell, device=device, precision=prec,
                               **kw).process()
        rms = np.sqrt(np.mean((got - want) ** 2)) / scale
        # float32 geometry and offsets: 1.1e-5 rms/mean against float64
        # on the CPU at this size
        log(f"reference: NSIDE 64 shell on {device} in {prec} vs cpu "
            f"float64: rms/mean = {rms:.3e} (bar {bar:g})")
        check(np.isfinite(got).all() and rms < bar,
              f"{prec} shell on the card differs: {rms:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--halos", type=int, default=1_000_000)
    ap.add_argument("--nside", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import baryonification_tpu_torch as T
    from baryonification_tpu_torch.ops import scatter_cuda as sc
    check("jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                        if v is not None}, "JAX was imported")

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()}), torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi_line}")

    t0 = time.perf_counter()
    for dt in (torch.float32, torch.float64):
        sc._kernel(dt)
    log(f"build: sorted_scatter_add.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    record = check_scatter(torch, sc, device)
    if args.halos != 1_000_000 or args.nside != 1024:
        log(f"cut: main path at {args.halos} halos, NSIDE {args.nside}")
    launches = main_path(T, torch, sc, device, args.halos, args.nside)
    reference_check(T, torch, device)

    record["launches"] = launches["sorted_scatter_add"]
    kernels = {"kernels": [{k: record[k] for k in
                            ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}]}
    print(json.dumps(kernels))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
