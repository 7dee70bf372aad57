"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled by hand with nvcc for ``sm_90a``, one nvcc
per source and all at once, then linked into one shared library with a
plain C interface, loaded with ctypes. The library goes to
``csrc/build/``, named by a hash of the sources, the headers they
include (``csrc/*.cuh``) and the flags, on first use.
Nothing here runs at import: the CPU tests import every module of the
port, and this machine may have no nvcc.

Each C entry point returns the ``cudaError_t`` of its launch;
:func:`launch` raises unless it is 0.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# kernel 1's arguments (chars, S, W, slen, goto, A1, rec, pops_flat, sharp,
# n_sharp, root_p, root_sharp, unk_id, cap, max_steps, unk_ovf,
# rows_per_block, ws, st), then each form's outputs and the stream
_SCAN = [_P, _I64, _I64, _P, _P, _I64, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _I, _I, _I]
_SCAN_ARGS = [*_SCAN, _P, _P, _P, _P, _P, _P]
_SCAN_COMPACT_ARGS = [*_SCAN, _P, _P, _P, _P, _I, _P]
# kernel 6's arguments (ids, W, L, wlen, rec, A1, jump, hash_aid, cap,
# max_iter, rows_per_block, ws, st), then each form's outputs and the stream
_MATCH = [_P, _I64, _I64, _P, _P, _I64, _P, _I, _I, _I64, _I, _I, _I]
# K1's table to fill (keys, counts, pos, T, claims, two counters) and the
# one to empty (keys, counts, pos, claims, its counter)
_TABLE_ARGS = [_P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P]
SIGNATURES = {
    "swt_wp_e2e_scan_u16": _SCAN_ARGS,
    "swt_wp_e2e_scan_i32": _SCAN_ARGS,
    "swt_wp_e2e_scan_compact_u16": _SCAN_COMPACT_ARGS,
    "swt_wp_e2e_scan_compact_i32": _SCAN_COMPACT_ARGS,
    "swt_compact": [_P, _I64, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "swt_pair_stats": [_P, _P, _P, _I64, *_TABLE_ARGS, _I, _P],
    "swt_pair_stats_runs": [_P, _P, _P, _I64, *_TABLE_ARGS, _P],
    "swt_pair_rows": [_P, _P, _I64, _I64, _I64, _P, _P, _I64, _I64, _P],
    "swt_lookup_reduce": [_P, _I64, _P, _I, _P, _P, _P],
    "swt_compact_tables": [_P, _I, _I, _I64, _P, _P, _P, _P, _P],
    "swt_launch_floor": [_I, _P],
    "swt_nominate": [_P, _I, _I64, _P, _P, _P, _P],
    "swt_certificate": [_P, _I, _P, _P, _I64, _P, _P, _I, _I, _P],
    "swt_select_unify": [_P, _P, _P, _I64, _P, _P, _P, _I, _P, _P, _P, _I64,
                         _P, _P, _P, _I64, _I64, _P, _I, _P, _I, _I64, _I64,
                         _I, _P, _P, _I, _I, _P],
    "swt_score_bits": [_P, _P, _P, _I64, _P, _P],
    "swt_merge_apply": [_P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P],
    "swt_skip_guard": [_P, _P, _P, _I64, _P, _P, _P],
    "swt_skip_close": [_P, _P, _P, _I64, _P, _P, _P],
    "swt_merge_skip": [_P, _P, _P, _I64, _I, _P, _P, _P, _P],
    "swt_merge_rows": [_P, _I64, _I64, _P, _I, _I, _I, _P],
    "swt_symbol_freqs": [_P, _P, _I64, _I64, _I64, _P, _P, _I64, _P],
    "swt_bpe_encode": [_P, _I64, _I64, _P, _P, _P, _I64, _I, _I, _P, _P,
                       _P, _I, _P],
    "swt_wp_match": [*_MATCH, _P, _P, _P, _P, _P],
    "swt_wp_match_compact": [*_MATCH, _P, _P, _P, _P, _I, _P],
    "swt_gather_take2d": [_P, _I64, _I64, _P, _P, _I64, _P, _P],
    "swt_gather_loop": [_P, _I64, _P, _I64, _I, _I, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register and spill report)


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc() -> str:
    path = shutil.which("nvcc")
    home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if path is None and os.path.exists(home_nvcc):
        path = home_nvcc
    if path is None:
        raise RuntimeError("nvcc is needed to build the CUDA kernels")
    return path


def _so_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"kernels-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if their library is not built yet; return its
    path. Raises with nvcc's output when the build fails."""
    global build_log
    so_path = _so_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc(), *FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        for src, p, log in zip(_sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({p.returncode}):\n{log[-6000:]}")
        tmp = os.path.join(tmpdir, "kernels.so")
        proc = subprocess.run([nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{(proc.stdout + proc.stderr)[-6000:]}")
        os.replace(tmp, so_path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = cdll
    return _lib


def launch(name: str, *args) -> None:
    """Call a C entry point on the current CUDA stream (appended as the
    last argument); raise if the launch was refused."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
