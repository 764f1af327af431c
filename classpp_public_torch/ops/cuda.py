"""Build and load the hand-written CUDA kernels in `csrc/`.

The kernels are compiled with nvcc for sm_90a (one nvcc per source, all
started together) and linked into one shared library with a plain C
interface, loaded through ctypes. The build runs at the first launch (never
at import), into `classpp_public_torch/_build/`, keyed by a hash of the
sources so an edited kernel is rebuilt. A failed build raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()

# C signatures: (argtypes) of each exported launcher; every one returns the
# cudaError_t of its launches as an int
_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
SIGNATURES = {
    "transfer_los_launch": [_P, _P, _D, _P, _P, _P, _P, _D, _I, _I, _I, _I, _P, _P],
    "lensing_wigner_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "perturb_ark_launch": [_P, _P, _P, _P, _P, _D, _D, _I, _P, _P, _D, _D, _I, _P, _P, _P,
                           _P, _P, _D, _D, _I, _I, _L, _I, _I, _P, _P, _P, _P],
    "halofit_sigma_launch": [_P, _P, _P, _I, _I, _I, _P, _P],
    "recfast_history_launch": [_P, _P, _P, _D, _D, _I, _P, _P, _D, _D, _I, _I, _P, _P],
    "hyrec_history_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P],
    "tb_march_launch": [_P, _P, _P, _P, _P, _P, _I, _D, _I, _P, _P, _P],
    "tensor_rkck_launch": [_P, _P, _P, _P, _P, _D, _D, _I, _P, _P, _D, _D, _I, _P, _D, _D, _I,
                           _L, _I, _I, _P, _P, _P, _P],
    "transfer_tensor_los_launch": [_P, _P, _D, _P, _P, _P, _D, _P, _I, _I, _I, _I, _P, _P],
    "transfer_los_curved_launch": [_P, _P, _D, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _I,
                                   _P, _P],
    "transfer_tensor_los_curved_launch": [_P, _P, _D, _P, _P, _P, _P, _D, _P, _D, _I, _I, _I, _I,
                                          _I, _P, _P],
    "nc_scan_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "growth_march_launch": [_P, _P, _D, _D, _I, _P, _P, _I, _I, _D, _D, _P, _P, _P, _P],
    "hmcode_sigma_launch": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "hmcode_onehalo_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "scf_march_launch": [_P, _P, _P, _I, _D, _P, _I, _D, _D, _D, _I, _P, _P, _P],
    "idm_march_launch": [_P, _P, _P, _P, _I, _D, _D, _D, _P, _P, _P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA "
                       "toolkit's nvcc (set NVCC or put it on PATH)")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into _build/libclasspp_kernels_<hash>.so (cached)."""
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libclasspp_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
                              + ["-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[1] for p in procs]
    failed = [f"{s.name} ({p.returncode}):\n{log}"
              for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    if verbose:
        print("\n".join(logs), flush=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp)] + [str(o) for o in objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
