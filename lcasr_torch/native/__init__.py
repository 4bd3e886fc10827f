"""The port's host libraries, built at first use and loaded with ctypes.

  * `bpe.cpp`: the BPE merge loop of `data/tokenizer.py` (the port's copy
    of lcasr_tpu/native/bpe_native.cpp), one string or a batch per call;
  * `npy.cpp`: a thread pool that reads the data of a batch of `.npy`
    files into buffers the caller made (lcasr_tpu/native/npy_native.cpp);
  * `beam.cpp`: the no-LM CTC prefix-beam block advance of
    `decoding/beam_search.py` (lcasr_tpu/native/beam_native.cpp), flat
    arrays in, a result handle sized and filled by two more calls.

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
from typing import Dict, List, Optional, Sequence

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "lcasr_torch_host"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
SOURCES = ("bpe", "npy", "beam")

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
    elif name == "beam":
        d = ctypes.c_double
        lib.beam_advance.argtypes = [ll, p, p, p, p, p, p, p, ll, ll, ll, i, i, d, i, d, i]
        lib.beam_advance.restype = p
        lib.beam_result_sizes.argtypes = [p, p, p, p]
        lib.beam_result_sizes.restype = None
        lib.beam_result_fill.argtypes = [p, p, p, p, p, p, p]
        lib.beam_result_fill.restype = None
        lib.beam_result_free.argtypes = [p]
        lib.beam_result_free.restype = None
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


# ---------------------------------------------------------------------------
# no-LM CTC prefix-beam block advance
# ---------------------------------------------------------------------------
def beam_advance(beams: Sequence[tuple], log_probs: np.ndarray, t0: int, blank: int,
                 pad: int, threshold: float, width: int, prune_less_than: Optional[float]
                 ) -> List[tuple]:
    """`BeamSearch.advance` without an LM over a float32 (T, C) block, in
    C++.  `beams`: (prefix, p_blank, p_non_blank, frames) in the search's
    insertion order; returns the surviving beams in the same form, ranked.
    `pad` -1: no pad filter; `prune_less_than` None: no score margin."""
    lib = library("beam")
    lp = np.ascontiguousarray(log_probs, np.float32)
    T, C = lp.shape
    n = len(beams)
    tok_off = np.zeros(n + 1, np.int64)
    fr_off = np.zeros(n + 1, np.int64)
    tok_off[1:] = np.cumsum([len(b[0]) for b in beams])
    fr_off[1:] = np.cumsum([len(b[3]) for b in beams])
    toks = np.fromiter((t for b in beams for t in b[0]), np.int32, int(tok_off[-1]))
    frs = np.fromiter((f for b in beams for f in b[3]), np.int32, int(fr_off[-1]))
    p_b = np.array([b[1] for b in beams], np.float64)
    p_nb = np.array([b[2] for b in beams], np.float64)
    handle = lib.beam_advance(n, _ptr(toks), _ptr(tok_off), _ptr(p_b), _ptr(p_nb), _ptr(frs),
                              _ptr(fr_off), _ptr(lp), T, C, t0, blank, pad, float(threshold),
                              width, 0.0 if prune_less_than is None else float(prune_less_than),
                              int(prune_less_than is not None))
    if not handle:
        raise MemoryError("the native beam advance ran out of memory")
    try:
        sizes = [ctypes.c_longlong() for _ in range(3)]
        lib.beam_result_sizes(handle, *map(ctypes.byref, sizes))
        nb, nt, nf = (s.value for s in sizes)
        o_tok, o_tok_off = np.empty(nt, np.int32), np.empty(nb + 1, np.int64)
        o_pb, o_pnb = np.empty(nb, np.float64), np.empty(nb, np.float64)
        o_fr, o_fr_off = np.empty(nf, np.int32), np.empty(nb + 1, np.int64)
        lib.beam_result_fill(handle, _ptr(o_tok), _ptr(o_tok_off), _ptr(o_pb), _ptr(o_pnb),
                             _ptr(o_fr), _ptr(o_fr_off))
    finally:
        lib.beam_result_free(handle)
    tok_l, fr_l = o_tok.tolist(), o_fr.tolist()
    return [(tuple(tok_l[o_tok_off[i]:o_tok_off[i + 1]]), float(o_pb[i]), float(o_pnb[i]),
             tuple(fr_l[o_fr_off[i]:o_fr_off[i + 1]])) for i in range(nb)]
