"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use into `build/
torch_kernels/` at the root of the checkout (listed in `.gitignore`). The
library's file name carries a hash of its source and of the headers in
`csrc/`, so an edited source is rebuilt and a stale build is never loaded; nvcc's log (with `ptxas -v`)
sits beside it under the same name. `build_all()` starts one nvcc per
source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's log of the library that `load(name)` loads."""
    return _lib_path(name).with_suffix(".log")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp output, final path,
    log file) or None when the library is already built."""
    final = _lib_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = open(log_path(name), "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, final, log


def _finish(name: str, job) -> None:
    proc, tmp, final, log = job
    rc = proc.wait()
    log.close()
    text = Path(log.name).read_text()
    if rc != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {rc}):\n{text}")
    os.replace(tmp, final)


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel. Returns {name: nvcc log} for
    the sources built by this call."""
    jobs = {name: _start(name) for name in sources()}
    logs = {}
    try:
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
                logs[name] = Path(job[3].name).read_text()
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
