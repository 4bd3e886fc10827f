"""The port's host libraries, built at first use and loaded with ctypes.

  * `bpe.cpp`: the BPE merge loop of `data/tokenizer.py` (the port's copy
    of lcasr_tpu/native/bpe_native.cpp), one string or a batch per call;
  * `npy.cpp`: a thread pool that reads the data of a batch of `.npy`
    files into buffers the caller made (lcasr_tpu/native/npy_native.cpp).

The sources are plain C++ behind an `extern "C"` API: no Python.h and no
numpy C-API, so `g++` alone builds them.  A library is named by a digest
of its source and flags, written under a name of its own process and moved
into place with `os.replace`: processes that build at once (test workers)
never load a half-written file.  The build goes to
`build/lcasr_torch_host/` beside the package, at first use, never at
import.  A failed build raises with the compiler's message; the Python
paths are the plain versions, chosen by the caller (`use_native=False`),
never taken silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "lcasr_torch_host"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
SOURCES = ("bpe", "npy")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `name`.cpp where its library is missing; returns its path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library {name} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `name`.cpp, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = _bind(name, ctypes.CDLL(str(build(name))))
        return _libs[name]


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "bpe":
        lib.bpe_init.argtypes = [p, p, i, p, p, i]
        lib.bpe_init.restype = p
        lib.bpe_encode.argtypes = [p, p, ll, p, ll]
        lib.bpe_encode.restype = ll
        lib.bpe_encode_batch.argtypes = [p, p, p, i, p, ll, p]
        lib.bpe_encode_batch.restype = ll
        lib.bpe_free.argtypes = [p]
        lib.bpe_free.restype = None
    elif name == "npy":
        lib.npy_read_batch.argtypes = [i, p, p, p, p, i, p]
        lib.npy_read_batch.restype = i
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# .npy batch reader
# ---------------------------------------------------------------------------
# the dtypes the JAX reader takes (lcasr_tpu/native/npy_native.cpp)
NPY_DTYPES = ("<f4", "<f2", "<i4", "<i2", "|i1", "|u1")


def npy_header(path: str):
    """(dtype, shape, offset of the data) of a C-order `.npy` file; raises
    FileNotFoundError, or ValueError on a file that is not `.npy`, Fortran
    order or a dtype outside NPY_DTYPES."""
    from numpy.lib import format as npy_format

    with open(path, "rb") as f:
        try:
            version = npy_format.read_magic(f)
            read = (npy_format.read_array_header_1_0 if version == (1, 0)
                    else npy_format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
        except ValueError as e:
            raise ValueError(f"{path}: not an .npy file ({e})") from None
        if fortran:
            raise ValueError(f"{path}: fortran_order not supported")
        if dtype.str not in NPY_DTYPES:
            raise ValueError(f"{path}: unsupported descr {dtype.str}")
        return dtype, tuple(shape), f.tell()


def read_npy_batch(paths: Sequence[str], threads: int = 8) -> List[np.ndarray]:
    """The arrays of `paths`, read by a pool of up to `threads` threads with
    the GIL released (ctypes releases it).  Python parses the headers and
    allocates the destinations."""
    heads = [npy_header(p) for p in paths]
    arrays = [np.empty(shape, dtype) for dtype, shape, _ in heads]
    n = len(paths)
    if n == 0:
        return arrays
    encoded = [os.fsencode(p) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*encoded)
    offsets = np.array([h[2] for h in heads], np.int64)
    nbytes = np.array([a.nbytes for a in arrays], np.int64)
    dests = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    errors = np.zeros(n, np.int32)
    bad = library("npy").npy_read_batch(n, c_paths, _ptr(offsets), _ptr(nbytes), dests,
                                        max(1, min(threads, n)), _ptr(errors))
    if bad:
        i = bad - 1
        raise OSError(int(errors[i]), f"reading the data of {paths[i]} failed: "
                      f"{os.strerror(int(errors[i])) if errors[i] > 0 else 'file too short'}")
    return arrays
