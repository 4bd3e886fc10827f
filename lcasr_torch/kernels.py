"""Build and bind the port's hand-written CUDA kernels.

Every source in `lcasr_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, and loaded with
`ctypes`.  One `nvcc` runs per source, all started together.  A library is
named by a hash of the sources and flags, so an edited kernel is rebuilt and
an unchanged one is reused.  The build goes to `build/lcasr_torch_kernels/`
beside the package and happens at first use, never at import: the package
imports on a host without CUDA.

`launch_counts` holds one plain integer per kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a caller can show that a run went
through the kernel (`reset_launch_counts()` before, read after).  An op that
has no kernel of its own yet counts its calls there too
(`rel_pos_attention`, ops/rel_pos_attention.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lcasr_torch_kernels"
SOURCES = ("flash_attn_fwd.cu", "flash_attn_fwd_db.cu", "flash_attn_bwd.cu",
           "selective_scan.cu", "subsampling_fused.cu", "ctc.cu", "norms.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

launch_counts: Dict[str, int] = {
    "flash_attention_fwd": 0,
    "flash_attention_fwd_db": 0,
    "flash_attention_bwd_fused": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkv": 0,
    "selective_scan_fwd": 0,
    "selective_scan_bwd": 0,
    "subsampling_fused": 0,
    "ctc_alpha": 0,
    "ctc_beta": 0,
    "rel_pos_attention": 0,
    "layer_norm_fwd": 0,
    "layer_norm_bwd": 0,
    "rms_norm_fwd": 0,
    "rms_norm_bwd": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source (ptxas registers, spills, advisories), kept beside
# the library so that a cached build still has it
build_log: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",  # the toolkit's default prefix
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> float:
    """Compile (where needed) and load every kernel library; returns seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    outputs = {src: BUILD_DIR / f"{Path(src).stem}-{digest}.so" for src in SOURCES}
    procs = {}
    for src, out in outputs.items():
        if src in _libs:
            continue
        if out.exists():
            log_file = out.with_suffix(".log")
            build_log.setdefault(src, log_file.read_text() if log_file.exists() else "(cached)")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for src, (proc, tmp) in procs.items():
        out_text, err_text = proc.communicate()
        build_log[src] = out_text + err_text
        if proc.returncode != 0:
            failed.append(f"{src}:\n{err_text}")
        else:
            outputs[src].with_suffix(".log").write_text(build_log[src])
            os.replace(tmp, outputs[src])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src, out in outputs.items():
        if src not in _libs:
            _libs[src] = _bind(src, ctypes.CDLL(str(out)))
    return time.perf_counter() - t0


def _bind(src: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if src in ("flash_attn_fwd.cu", "flash_attn_fwd_db.cu"):  # one signature
        fn = lib.lcasr_flash_attn_fwd if src == "flash_attn_fwd.cu" else lib.lcasr_flash_attn_fwd_db
        fn.argtypes = [p] * 6 + [i] * 6 + [ll] * 9 + [i] * 4 + [p]
        fn.restype = i
    elif src == "flash_attn_bwd.cu":
        lib.lcasr_flash_attn_bwd.argtypes = (
            [i] + [p] * 10 + [i] * 6 + [ll] * 12 + [i] * 4 + [p]
        )
        lib.lcasr_flash_attn_bwd.restype = i
    elif src == "selective_scan.cu":
        tail = [i] * 5 + [ll] * 8 + [p]  # sizes, B/C dtype flag, strides, stream
        # x, delta, A, B, C, y, states, workspace; segments
        lib.lcasr_selective_scan_fwd.argtypes = [p] * 8 + [i] + tail
        lib.lcasr_selective_scan_fwd.restype = i
        lib.lcasr_selective_scan_fwd_workspace.argtypes = [i] * 5  # Bt, L, D, N, segments
        lib.lcasr_selective_scan_fwd_workspace.restype = ll
        lib.lcasr_selective_scan_fwd_grid.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.lcasr_selective_scan_fwd_grid.restype = i
        lib.lcasr_selective_scan_bwd.argtypes = [p] * 13 + tail
        lib.lcasr_selective_scan_bwd.restype = i
        lib.lcasr_selective_scan_bwd_workspace.argtypes = [i] * 4  # Bt, L, D, N
        lib.lcasr_selective_scan_bwd_workspace.restype = ll
    elif src == "subsampling_fused.cu":
        # x, out, 10 parameters; B, T, F, C, fp32 flag, activation, tile; stream
        lib.lcasr_subsampling_fused.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.lcasr_subsampling_fused.restype = i
    elif src == "ctc.cu":
        # lp, labels, input_lengths, label_lengths; B, T, C, U, blank; the
        # partition (cluster, threads, per_thread, tiles); stream
        sizes = [i] * 9 + [p]
        lib.lcasr_ctc_alpha.argtypes = [p] * 6 + sizes  # + alpha, nll
        lib.lcasr_ctc_alpha.restype = i
        lib.lcasr_ctc_lattice.argtypes = [p] * 9 + sizes  # + sums, nll, grad, edge, flags
        lib.lcasr_ctc_lattice.restype = i
        lib.lcasr_ctc_active_clusters.argtypes = [i] * 3 + [ctypes.POINTER(i)]
        lib.lcasr_ctc_active_clusters.restype = i
    elif src == "norms.cu":
        # the launch shape (elems, block rows, threads, grid); stream
        shape = [i] * 5 + [p]
        # x, scale, bias, y, mean, rstd; rows, D, eps, rms
        lib.lcasr_row_norm_fwd.argtypes = [p] * 6 + [ll, i, ctypes.c_float, i] + shape
        lib.lcasr_row_norm_fwd.restype = i
        # x, dy, mean, rstd, scale, dx, dscale, dbias, part; rows, D, rms
        lib.lcasr_row_norm_bwd.argtypes = [p] * 9 + [ll, i, i] + shape
        lib.lcasr_row_norm_bwd.restype = i
        lib.lcasr_row_norm_blocks_per_sm.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.lcasr_row_norm_blocks_per_sm.restype = i
    lib.lcasr_cuda_error_string.argtypes = [i]
    lib.lcasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    if src not in _libs:
        build()
    return _libs[src]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.lcasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
