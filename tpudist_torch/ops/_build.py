"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``ops/csrc/`` is compiled on first use into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), in the ``build/`` directory beside the package. The library's
name carries a hash of its source, the headers under ``csrc/`` and the
flags, so an edited kernel or header is rebuilt and a built one is
reused. ``build_all`` starts one ``nvcc`` per source at once and waits
for all of them.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tpudist_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The kernels of the port, by name: the source file under csrc/.
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "fused_norm": "fused_norm.cu"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in (SOURCES[name], *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, SOURCES[name])]
    return out, (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))


def build_all(names=None) -> tuple[dict[str, str], dict[str, str]]:
    """Compile every named kernel (all by default) in parallel. Returns
    the path of each library and nvcc's output (the ``-Xptxas -v`` report:
    registers, shared memory, spills) for each one built now. Raises with
    nvcc's output on a failure."""
    names = list(SOURCES if names is None else names)
    started = {n: _start(n) for n in names}
    paths, logs, errors = {}, {}, []
    for n, (out, job) in started.items():
        if job is not None:
            tmp, proc = job
            logs[n], _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[n]} "
                              f"(exit {proc.returncode}):\n{logs[n]}")
                if os.path.exists(tmp):
                    os.remove(tmp)
                continue
            os.replace(tmp, out)
        paths[n] = out
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths, logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and then cached."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[0][name])
            _libs[name] = lib
        return lib
