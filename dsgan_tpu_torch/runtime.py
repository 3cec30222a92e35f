"""The native batch decoder (port of ``dsgan_tpu/runtime``): a ctypes
binding of ``csrc/loader.cpp``, which decodes, crops and flips a whole
batch into one contiguous uint8 NHWC array on C++ threads. A ctypes call
releases the interpreter lock, so the loader's decoding does not hold up
the thread that dispatches the step.

The library is built with g++ at first use into ``dsgan_tpu_torch/_build/``
(``-O3 -fPIC -shared -std=c++17 -lpthread``), named by the hash of its
source and flags, as ``kernels/_build.py`` names the kernels. PNG needs
nothing else; JPEG is built in (``-DDSGAN_WITH_JPEG -ljpeg``) where
``jpeglib.h`` is found. Nothing runs at import. Where the library cannot
be built, ``available()`` is false and says why in ``reason()``.

``load_batch_u8`` counts its calls in ``load_batch_u8.calls``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_INCLUDE_DIRS = ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu")


def _jpeg_flags():
    if any(os.path.exists(os.path.join(d, "jpeglib.h")) for d in _INCLUDE_DIRS):
        return ("-DDSGAN_WITH_JPEG",), ("-ljpeg",)
    return (), ()


def library_path(defines=()):
    """Where the library builds to, named by the hash of source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"libdsgan_loader-{digest.hexdigest()[:16]}.so"


def build():
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError with the compiler's output (or its absence)."""
    defines, libs = _jpeg_flags()
    out = library_path(defines)
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, *defines, "-o", tmp, str(SOURCE), "-lpthread", *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _load():
    """(library, None) or (None, why it could not be built)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        return None, str(e)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.dsgan_load_batch_u8.restype = ctypes.c_int
    lib.dsgan_load_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ints, ints, ints, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.dsgan_probe.restype = ctypes.c_int
    lib.dsgan_probe.argtypes = [ctypes.c_char_p, ints, ints]
    lib.dsgan_formats.restype = ctypes.c_int
    lib.dsgan_formats.argtypes = []
    return lib, None


def available():
    return _load()[0] is not None


def reason():
    """Why the library is not available (None when it is)."""
    return _load()[1]


def formats():
    """The formats the built library reads: a subset of {"png", "jpeg"}."""
    lib = _load()[0]
    if lib is None:
        return set()
    bits = lib.dsgan_formats()
    return {name for bit, name in ((1, "png"), (2, "jpeg")) if bits & bit}


def _lib():
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"the native decoder is not available: {why}")
    return lib


def probe(path):
    """(width, height) of the image at ``path``, or None if it does not
    decode."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if _lib().dsgan_probe(os.fsencode(path), ctypes.byref(w), ctypes.byref(h)):
        return w.value, h.value
    return None


def load_batch_u8(paths, offs_y, offs_x, flips, crop_h, crop_w, num_threads=4):
    """Decode, crop at (offs_y, offs_x) and flip each image: a (n, crop_h,
    crop_w, 3) uint8 array and the count decoded (a failed image's slot is
    zeros)."""
    n = len(paths)
    if not (len(offs_y) == len(offs_x) == len(flips) == n) or crop_h < 1 or crop_w < 1:
        raise ValueError("one offset pair and one flip per path, and a crop of at least 1x1")
    lib = _lib()
    out = np.empty((n, crop_h, crop_w, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_oy, c_ox, c_fl = ((ctypes.c_int * n)(*[int(v) for v in vals])
                        for vals in (offs_y, offs_x, flips))
    ok = lib.dsgan_load_batch_u8(c_paths, n, c_oy, c_ox, c_fl, int(crop_h), int(crop_w),
                                 int(num_threads), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    load_batch_u8.calls += 1
    return out, ok


# Calls since the last reset (a caller sets it to 0).
load_batch_u8.calls = 0
