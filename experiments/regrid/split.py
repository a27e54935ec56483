"""Split the shell regrid kernel's time on an H100 (run from the repo root):

    python3 experiments/regrid/split.py [--root CHECKOUT]

``--root`` names another checkout whose package is measured (e.g. the
parent commit unpacked with ``git archive`` into the git-ignored
``.chipcheck/``); by default this one's.

At the inputs of one shell-1e6 process() (chip_smoke.regrid_inputs: NSIDE
1024, 1e6 halos, 12,582,912 NESTED pixels), float32 and float64, by CUDA
events with the launches queued (chip_smoke.queued_ms):

- the wrapper regrid_shell (the map's torch.zeros and the kernel), the
  map's torch.zeros alone and the kernel alone;
- the corners alone (split.cu's regrid_compute: no add);
- the adds alone, fed the check entry's rows (int32 ids and the values
  w_k m): one red.global.add a row, merged a corner at a time
  (__match_any_sync), merged across a warp's four corners through a table
  in shared memory (the merge measured first), merged by the package's
  merge_rows (four rounds of __match_any_sync; a source with the ring
  table only), and the adds of a perfect merge (each (warp, destination)
  once), with the number of adds each issues;
- the issue bounds of the package's entries and of the variants, from
  the fast path of their SASS (chip_smoke.fast_path, cuobjdump -sass).

Builds split.cu (which includes the package's csrc/regrid.cu) with the
package's flags into .scratch/regrid_split/, prints one line a number and
writes them all to chiprun_out/regrid_split.json.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build(cb, pkg, table):
    """The variants' library on the regrid source of package directory
    ``pkg`` (``table``: a source with the ring table), built as the
    package builds regrid.cu."""
    out = ROOT / ".scratch" / "regrid_split"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libregrid_split_{int(table)}.so"
    src = Path(__file__).with_name("split.cu")
    cmd = [cb.nvcc_path(), *cb._ARCH_FLAGS, *cb._SOURCE_FLAGS["regrid"],
           "-std=c++17", "-O3", "-shared", "-Xptxas", "-v", "-Xcompiler",
           "-fPIC", "-I", str(pkg), *(["-DREGRID_TABLE"] if table else []),
           "-o", str(lib), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed: {proc.stderr[-2000:]}")
    cs.log(f"split: built split.cu in {time.perf_counter() - t0:.1f} s; "
           "registers (spill bytes, static shared bytes): " + ", ".join(
               f"{e} {r} ({sp}, {sm})"
               for e, r, sp, sm in cs.ptxas_summary(proc.stderr)))
    return str(lib)


def sass_counts(funcs, pattern):
    """{(kernel, dtype letter): fast_path counts} of the functions whose
    mangled name holds ``pattern``<f|d>E."""
    import re
    out = {}
    for name, ins in funcs.items():
        m = re.search(r"\d(" + pattern + r")I([fd])E", name)
        if m:
            try:
                out[m.group(1), m.group(2)] = cs.fast_path(ins)
            except (RuntimeError, KeyError, IndexError) as e:
                cs.log(f"split: no fast path read from {name}: {e!r}")
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.root.resolve()))
    import baryonification_tpu_torch as T
    from baryonification_tpu_torch import _cuda_build as cb
    from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
    from baryonification_tpu_torch.ops import grid_pass_cuda as gp
    from baryonification_tpu_torch.ops import legendre_cuda as lc
    from baryonification_tpu_torch.ops import regrid_cuda as rc
    from baryonification_tpu_torch.ops import scatter_cuda as sc

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    cs.log(f"split: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    cs.build_all(torch, sc, lc, cmc, gp, rc)
    table = hasattr(rc, "_ring_table")
    cs.log(f"split: the package of {Path(T.__file__).parent} (ring table: "
           f"{table})")
    lib = ctypes.CDLL(build(cb, Path(T.__file__).parent, table))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for sfx in ("f32", "f64"):
        f = getattr(lib, "regrid_compute_" + sfx)
        f.argtypes, f.restype = [I, L, P, P, P, P], I
        g = getattr(lib, "regrid_adds_" + sfx)
        g.argtypes, g.restype = [I, L, P, P, P, P, P], I
        fns[sfx] = f, g

    def ok(err):
        cs.check(err == 0, f"launch failed: CUDA error {err}")

    base = cs.regrid_inputs(T, torch, device, 1_000_000, 1024)
    nside = base[0]
    npix = 12 * nside ** 2
    res = {"device": smi}
    sass = {}
    for libname, pattern in (
            ("regrid", r"regrid_kernel|regrid_vjp_kernel|regrid_parts_kernel"),
            (str(lib._name), r"compute_kernel|adds\w*_kernel")):
        sass.update(sass_counts(cs.library_sass(libname), pattern))
    for (kname, d), c in sorted(sass.items()):
        cs.log(f"split: SASS fast path of {kname}<{d}>: {c[0]} "
               f"instructions ({c[1]} FP64, {c[2]} MUFU)")
        res[f"sass {kname}<{d}>"] = c
    for dname, dt, sfx, d in (("float32", torch.float32, "f32", "f"),
                              ("float64", torch.float64, "f64", "d")):
        compute, adds = fns[sfx]
        vx, vy, vz, m = (x.to(dt) for x in base[1:5])
        off = tuple(o.to(dt) for o in base[5])
        n = m.shape[0]
        args = (nside, vx, vy, vz, m, off)
        planes, _, _ = rc._planes("split", vx, vy, vz, m, off)
        ptrs = rc._ptrs(planes)
        stream = rc._stream(m)
        r = {}
        r["wrapper_ms"] = cs.queued_ms(torch, lambda: rc.regrid_shell(*args),
                                       20)
        r["zeros_ms"] = cs.queued_ms(
            torch, lambda: torch.zeros(npix, dtype=dt, device=device), 20)
        rings = rc._ring_table(nside, dt, device).data_ptr() if table \
            else None
        acc = torch.zeros(npix, dtype=dt, device=device)
        kernel_args = ((nside, n, ptrs, rings, acc.data_ptr(), None, stream)
                       if table else (nside, n, ptrs, acc.data_ptr(), stream))
        r["kernel_ms"] = cs.queued_ms(
            torch, lambda: rc._call("regrid", dt, *kernel_args), 20)
        sink = torch.zeros(1, dtype=dt, device=device)
        r["compute_ms"] = cs.queued_ms(torch, lambda: ok(compute(
            nside, n, ptrs, rings, sink.data_ptr(), stream)), 20)
        ids, w = rc._regrid_parts(nside, vx, vy, vz, off)
        vals = (w * m).contiguous()
        ids32 = ids.to(torch.int32).contiguous()
        live = vals != 0
        r["rows"] = int(live.sum())
        # adds of a merge a corner at a time and of a perfect one: the
        # distinct (warp, corner, destination) and (warp, destination)
        warp = (torch.arange(n, device=device) // 32).expand(4, n)
        key = warp * npix + ids
        r["adds_corner_merge"] = sum(
            int(torch.unique(key[k][live[k]]).numel()) for k in range(4))
        uniq, inv = torch.unique(key[live], return_inverse=True)
        r["adds_perfect_merge"] = int(uniq.numel())
        sums = torch.zeros(uniq.numel(), dtype=dt, device=device).index_add_(
            0, inv, vals[live])
        merged_ids = (uniq % npix).to(torch.int32).contiguous()
        del key, inv, uniq, warp
        # each pixel's first ring (the ring of its first id), as the
        # package's merge reads it
        starts = T.ops.healpix.ring_info(
            nside, torch.arange(1, 4 * nside, device=device))[1]
        ring1 = torch.searchsorted(starts, ids[0], right=True).to(
            torch.int32).contiguous()
        want = rc.regrid_shell_reference(*args)
        scale = float(want.abs().max())
        uniq_n = merged_ids.numel()
        variants = [(0, "adds", n, ids32, vals),
                    (1, "adds_match", n, ids32, vals),
                    (2, "adds_table", n, ids32, vals),
                    (3, "adds_perfect_rows", uniq_n, merged_ids, sums)]
        if table:
            variants.append((4, "adds_parity", n, ids32, vals))
        for v, label, nr, iv, vv in variants:
            out = torch.zeros(npix, dtype=dt, device=device)
            ok(adds(v, nr, iv.data_ptr(), vv.data_ptr(), ring1.data_ptr(),
                    out.data_ptr(), stream))
            r[label + "_err"] = float((out - want).abs().max()) / scale
            r[label + "_ms"] = cs.queued_ms(torch, lambda: ok(adds(
                v, nr, iv.data_ptr(), vv.data_ptr(), ring1.data_ptr(),
                out.data_ptr(), stream)), 20)
        t = dt.itemsize
        r["adds_bytes"] = 4 * n * (4 + t) + npix * t
        r["perfect_rows_bytes"] = uniq_n * (4 + t) + npix * t
        mhz = cs.sm_clock_under(torch, lambda: rc.regrid_shell(*args), 200)
        r["sm_mhz"] = mhz
        for kname in ("regrid_kernel", "regrid_vjp_kernel", "compute_kernel",
                      "adds_kernel", "adds_match_kernel",
                      "adds_table_kernel", "adds_parity_kernel"):
            if (kname, d) in sass:
                r[f"issue_ms {kname}"], r[f"mufu_ms {kname}"] = \
                    cs.lane_issue_ms(sass[kname, d], n, mhz)
        (r["bound_ms"], r["bound_by"]), _, _ = cs.regrid_bound(n, npix, dname)
        for k, v in r.items():
            cs.log(f"split {dname}: {k} {v}")
        res[dname] = r
        del ids, w, vals, ids32, live, sums, merged_ids, want, acc, ring1
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = "" if opts.root.resolve() == ROOT else "_" + opts.root.name
    (out / f"regrid_split{tag}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
