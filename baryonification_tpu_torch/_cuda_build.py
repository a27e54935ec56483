"""Build-at-first-use of the package's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (git-ignored) inside the package, named by a hash of the
source, and loaded with ``ctypes``. Nothing is built when a module is
imported: the first launch builds, later calls reuse the library.
``BUILD_LOG`` keeps what ``ptxas -v`` said of each source built by this
process (registers, shared memory and spills of every kernel).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "nvcc_path", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# flags of one source only: the cell-major shell, grid, anisotropic paint
# and snapshot passes and the regrid round operation for operation as
# their plain PyTorch versions do, so nothing is contracted into an FMA
# there
_SOURCE_FLAGS = {"anis_pass": ["--fmad=false"],
                 "cellmajor_pass": ["--fmad=false"],
                 "grid_pass": ["--fmad=false"],
                 "regrid": ["--fmad=false"],
                 "snap_pass": ["--fmad=false"]}
_LIBS = {}
#: source name -> the compiler's output of this process's build
BUILD_LOG = {}


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` (or
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    if name in _LIBS:
        return _LIBS[name]
    src = _CSRC / f"{name}.cu"
    flags = _ARCH_FLAGS + _SOURCE_FLAGS.get(name, [])
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    _BUILD.mkdir(exist_ok=True)
    lib_path = _BUILD / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        tmp = _BUILD / f".lib{name}_{digest}.{os.getpid()}.so"
        cmd = [nvcc_path(), *flags, "-std=c++17", "-O3", "-shared",
               "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-o", str(tmp),
               str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        BUILD_LOG[name] = proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib
