"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface.  On first use it is
compiled with nvcc for sm_90a (Hopper) into a shared library under
`build/kernels/` beside the package (listed in .gitignore), keyed by a hash
of the source, the shared headers (`csrc/*.cuh`) and the flags, and loaded
with ctypes.  Only sources in this
repository are built; nothing is downloaded.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# a source's own flags: the free-dynamics kernel rounds every product and
# sum apart, as PyTorch's elementwise kernels do, so that it gives plain
# torch's bits (csrc/free_dynamics.cu)
SOURCE_FLAGS = {"free_dynamics": ["--fmad=false"]}

_LIBS = {}
ptxas_info = {}        # name (and defines) -> nvcc's resource report, for libraries
                       # built by this process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, building it if needed, with the
    preprocessor macros `defines` (a build of its own)."""
    key = (name, *defines)
    if key in _LIBS:
        return _LIBS[key]
    src = os.path.join(CSRC, f"{name}.cu")
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, []) + [f"-D{d}" for d in defines]
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run([_nvcc(), *flags, "-o", tmp, src], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
        ptxas_info[" ".join(key)] = res.stderr
        os.replace(tmp, out)
    _LIBS[key] = ctypes.CDLL(out)
    return _LIBS[key]
