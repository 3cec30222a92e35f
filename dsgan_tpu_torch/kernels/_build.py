"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by nvcc for Hopper (``sm_90a``) into
``dsgan_tpu_torch/_build/`` and loaded with ctypes. The sources may
include the headers beside them (``csrc/*.cuh``). A library is rebuilt
when its source, a header or the flags change (the file name carries
their hash), and several missing libraries build in parallel, one nvcc
each. No library links against the driver: the Hopper kernels reach
``cuTensorMapEncodeTiled`` through the runtime's driver entry point.

Nothing here runs at import: the module imports on a machine without
nvcc, triton or CUDA, and only a launch on a CUDA tensor reaches it.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to, named by the hash of source,
    headers and flags."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every missing library among ``names`` (default: all of
    ``csrc/*.cu``), one nvcc each, all started together. Returns the
    paths. Raises with nvcc's output if a build fails."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # build under a temporary name and rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [library_path(n) for n in names]


@functools.cache
def load(name):
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    (path,) = build([name])
    return ctypes.CDLL(str(path))
