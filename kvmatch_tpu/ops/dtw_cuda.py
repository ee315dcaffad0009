"""Banded DTW as a CUDA kernel called through JAX's foreign function interface.

The kernel (``cuda/dtw_band.cu``) runs one warp per candidate window with the
whole band in registers and walks the DP by anti-diagonals, so a candidate
reads its window once and no DP state touches device memory.  The XLA form
(ops/dtw.dtw_banded_batch_multi) is an L-step ``lax.scan`` whose (B, W) carry
and prefix-scan temporaries round-trip device memory on every row.

The shared library is built from the committed source with ``nvcc`` at first
use into ``build/cuda/`` of the checkout (listed in .gitignore), keyed by a
hash of the source and the compiler flags.  A build or registration failure
raises: the engines never fall back silently (ops/dtw.dtw_kernel_for decides
the route from the platform and the band width).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("cuda") / "dtw_band.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
_TARGET = "kvmatch_dtw_band"
#: Widest band (2r + 1) the kernel holds: 32 lanes x 32 cells per lane.
MAX_BAND = 32 * 32
_STATE: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA DTW kernel cannot be built")
    return path


def build_library() -> Path:
    """Compile the kernel library if this source/flag combination is new."""
    import jax.ffi

    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir()]
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join(flags).encode()
                       ).hexdigest()[:12]
    so = _BUILD_DIR / f"libkvmatch_dtw_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def _register() -> None:
    if _STATE.get("registered"):
        return
    import jax.ffi

    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.KvmatchDtwBand), platform="CUDA")
    _STATE["lib"] = lib
    _STATE["registered"] = True


def dtw_banded_cuda(x, qm, qids, r: int):
    """Squared banded DTW of each row of ``x`` (B, L) against ``qm[qids]``.

    ``qm`` is (Q, L), ``qids`` (B,) int32.  Builds and registers the kernel
    on first use (safe inside a trace), then lowers to one custom call."""
    _register()
    return _ffi_call(x, qm, qids, r)


def _ffi_call(x, qm, qids, r: int):
    import jax
    import jax.numpy as jnp

    B, L = x.shape
    r = min(int(r), L - 1)
    if 2 * r + 1 > MAX_BAND:
        raise ValueError(f"band 2r+1={2 * r + 1} exceeds MAX_BAND={MAX_BAND}")
    return jax.ffi.ffi_call(_TARGET, jax.ShapeDtypeStruct((B,), jnp.float32))(
        x.astype(jnp.float32), qm.astype(jnp.float32),
        qids.astype(jnp.int32), r=np.int32(r))


def wavefront_reference(a: np.ndarray, q: np.ndarray, r: int) -> float:
    """NumPy float32 twin of the kernel's arithmetic for one window: the same
    anti-diagonal cells, systolic operand shifts, edge/middle validity and
    BIG sentinel, with the 32 lanes x CPL cells laid out as one K-cell row.
    Tests compare it with the float64 DP; the card compares the kernel."""
    BIG = np.float32(1e30)
    a = np.asarray(a, np.float32)
    q = np.asarray(q, np.float32)
    L = a.size
    r = min(int(r), L - 1)
    W = 2 * r + 1
    K = 32 * -(-W // 32)
    k = np.arange(K)
    d1 = np.full(K, BIG, np.float32)
    d2 = np.where(k == r, 0, BIG).astype(np.float32)
    av = a[np.clip((r - 1 - k) >> 1, 0, L - 1)]
    qv = q[np.clip((k - r - 1) >> 1, 0, L - 1)]
    S = 2 * L - 1
    mid0, mid1 = min(r, S), min(2 * L - r, S)
    for s in range(S):
        av = np.concatenate([[a[min((s + r) >> 1, L - 1)]], av[:-1]])
        qv = np.concatenate([qv[1:], [q[min((s + K - 1 - r) >> 1, L - 1)]]])
        left = np.concatenate([[BIG], d1[:-1]])
        right = np.concatenate([d1[1:], [BIG]])
        m = np.minimum(np.minimum(left, right), d2)
        diff = av - qv
        v = np.minimum(diff * diff + m, BIG)
        valid = k < W
        if s < mid0 or s >= mid1:
            ti, tj = s - k + r, s + k - r
            valid &= (ti >= 0) & (ti < 2 * L) & (tj >= 0) & (tj < 2 * L)
        d2, d1 = d1, np.where(valid, v, BIG).astype(np.float32)
    return float(d1[r])
