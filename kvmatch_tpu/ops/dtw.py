"""Banded DTW + lower-bound cascade, batched for the accelerator.

Batched redesign of the UCR-suite kernels (utils/DtwUtils.java:22-338).  The reference
runs one candidate at a time with data-dependent early abandoning; that shape doesn't
vectorize, so here a *batch* of candidate windows moves through the cascade together:

  lb_kim   ->   lb_keogh (query envelope)   ->   full banded DTW on survivors

and each stage is a fixed-shape fused kernel.  Early abandoning is replaced by
between-stage batch compaction (survivors are gathered on the host and re-batched),
which is the accelerator-idiomatic trade: bounded dense work at device-memory
bandwidth beats serial branchy work.

The banded DP itself uses a prefix-scan formulation of the row recurrence.  With
band coordinate k (j = i - r + k) the classic recurrence

    D[k] = dist[k] + min(P[k], P[k+1], D[k-1])        (DtwUtils.java:286-321)

has a serial horizontal dependency; defining M[k] = min(P[k], P[k+1]) and
C = cumsum(dist) it unrolls to

    D[k] = C[k] + min_{j<=k} (M[j] - C[j-1]),

i.e. one cumulative sum + one cumulative min per row — log-depth vector work, no
scalar loop.  A float64 NumPy twin (`dtw_banded_batch_f64`) provides the exact
host confirmation for near-threshold candidates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = 1e30


def _band_dtw_rows(a_batch, q, r: int):
    """Shared scan body builder: a_batch (B, L) vs q (L,), band radius r."""
    Bsz, L = a_batch.shape
    W = 2 * r + 1
    ks = jnp.arange(W)

    def row(carry, i):
        P = carry
        j = i - r + ks                          # query index per band slot
        valid = (j >= 0) & (j < L)
        qv = q[jnp.clip(j, 0, L - 1)]
        d = (a_batch[:, i][:, None] - qv[None, :]) ** 2
        d = jnp.where(valid[None, :], d, 0.0)
        shifted = jnp.concatenate([P[:, 1:], jnp.full((Bsz, 1), BIG)], axis=1)
        M = jnp.minimum(P, shifted)
        M = jnp.where(i == 0, jnp.where(ks == r, 0.0, BIG)[None, :], M)
        C = jnp.cumsum(d, axis=1)
        Cprev = jnp.concatenate([jnp.zeros((Bsz, 1)), C[:, :-1]], axis=1)
        G = M - Cprev
        D = C + jax.lax.cummin(G, axis=1)
        D = jnp.where(valid[None, :], D, BIG)
        D = jnp.minimum(D, BIG)
        return D, None

    return row, W


# Rows evaluated per lax.scan step.  One row per step leaves the program
# latency-bound (L tiny steps of (B, W) vector work); unrolling amortizes the
# per-step scan overhead across UNROLL rows while computing bit-identical
# values (the row recurrence is simply inlined UNROLL times per step).
DTW_UNROLL = 8


@functools.partial(jax.jit, static_argnames=("r",))
def dtw_banded_batch(a_batch: jnp.ndarray, q: jnp.ndarray, r: int) -> jnp.ndarray:
    """Squared banded DTW distances for a (B, L) batch against one query (L,)."""
    Bsz, L = a_batch.shape
    row, W = _band_dtw_rows(a_batch, q, r)
    U = DTW_UNROLL
    steps = -(-L // U)

    def step(P, s):
        for t in range(U):
            i = s * U + t
            D, _ = row(P, i)
            P = jnp.where(i < L, D, P)
        return P, None

    # Derive the carry from a_batch so its sharding/vary-type matches the scan
    # body's output when this runs inside shard_map (shard-varying operand).
    P0 = jnp.full((Bsz, W), BIG) + 0.0 * a_batch[:, :1]
    P, _ = jax.lax.scan(step, P0, jnp.arange(steps))
    return P[:, r]


def _band_dtw_rows_multi(a_batch, q_batch, r: int):
    """Row recurrence with a per-row query; see _band_dtw_rows."""
    Bsz, L = a_batch.shape
    W = 2 * r + 1
    ks = jnp.arange(W)

    def row(P, i):
        j = i - r + ks
        valid = (j >= 0) & (j < L)
        qv = q_batch[:, jnp.clip(j, 0, L - 1)]     # (B, W)
        d = (a_batch[:, i][:, None] - qv) ** 2
        d = jnp.where(valid[None, :], d, 0.0)
        shifted = jnp.concatenate([P[:, 1:], jnp.full((Bsz, 1), BIG)], axis=1)
        M = jnp.minimum(P, shifted)
        M = jnp.where(i == 0, jnp.where(ks == r, 0.0, BIG)[None, :], M)
        C = jnp.cumsum(d, axis=1)
        Cprev = jnp.concatenate([jnp.zeros((Bsz, 1)), C[:, :-1]], axis=1)
        D = jnp.minimum(C + jax.lax.cummin(M - Cprev, axis=1), BIG)
        D = jnp.where(valid[None, :], D, BIG)
        return D, None

    return row, W


@functools.partial(jax.jit, static_argnames=("r",))
def dtw_banded_batch_multi(a_batch: jnp.ndarray, q_batch: jnp.ndarray,
                           r: int) -> jnp.ndarray:
    """Banded DTW where every batch row has its OWN query: a_batch (B, L) vs
    q_batch (B, L) — the multi-query phase-2 path (one launch per query batch)."""
    Bsz, L = a_batch.shape
    row, W = _band_dtw_rows_multi(a_batch, q_batch, r)
    U = DTW_UNROLL
    steps = -(-L // U)

    def step(P, s):
        for t in range(U):
            i = s * U + t
            D, _ = row(P, i)
            P = jnp.where(i < L, D, P)
        return P, None

    P0 = jnp.full((Bsz, W), BIG)
    P, _ = jax.lax.scan(step, P0, jnp.arange(steps))
    return P[:, r]


# ---------------------------------------------------------------------------
# Double-single (f32x2) banded DTW: near-exact DEVICE confirmation.
#
# The f32 DP's rounding error scales like eps32 * L * (d2 + cell magnitude)
# (measured: scripts/measure_dtw_f32_error.py), which forces a guard band of
# ~0.1-1.0 around eps^2 at L=8192 — and every candidate inside the band used
# to pay a ~28 ms scalar f64 host confirmation (the round-2 cNSM-DTW wall:
# ~292 candidates/query, ROADMAP round-2 notes).  Instead of shrinking the
# band, this kernel re-runs the DP on device with DOUBLE-SINGLE accumulation:
# every DP value is an unevaluated f32 pair (hi, lo) with |lo| <= ulp(hi)/2,
# summed with TwoSum and compared lexicographically, giving ~2^-46 effective
# accumulation precision at ~5x the f32 cell cost.  Residual error comes only
# from the f32 INPUTS (cells, z-normalization) and is bounded well under 1e-3
# for every workload shape (property tests in tests/test_dtw_guard.py), so
# only candidates within +-guard_ds of eps^2 — typically none — still need
# the host f64 pass.  Replaces the per-candidate early-abandon confirm loop
# of QueryEngineDtw.java:385-452 at device batch throughput.


def _ds_two_sum(ah, al, bh, bl):
    """(ah + al) + (bh + bl) as a normalized double-single pair (Knuth TwoSum
    on the high parts, error folded into the low parts, Fast2Sum renorm)."""
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    lo = e + (al + bl)
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo


def _ds_min(ah, al, bh, bl):
    take_a = (ah < bh) | ((ah == bh) & (al <= bl))
    return jnp.where(take_a, ah, bh), jnp.where(take_a, al, bl)


def _ds_cumsum(x, axis=1):
    zero = jnp.zeros_like(x)
    return jax.lax.associative_scan(
        lambda a, b: _ds_two_sum(a[0], a[1], b[0], b[1]), (x, zero), axis=axis)


def _ds_cummin(h, l, axis=1):
    return jax.lax.associative_scan(
        lambda a, b: _ds_min(a[0], a[1], b[0], b[1]), (h, l), axis=axis)


@functools.partial(jax.jit, static_argnames=("r",))
def dtw_banded_batch_ds_multi(a_batch: jnp.ndarray, q_batch: jnp.ndarray,
                              r: int):
    """Banded DTW with double-single accumulation; returns the (hi, lo) f32
    pair per candidate (combine as float64 on the host — f64 dtypes don't
    exist on device without global x64).  The accumulation is exact to
    ~2^-40 relative; each cell (a - q)^2 is still rounded to f32 (<= 2^-24
    relative), so against the float64 DP on the same f32 inputs the result
    differs by ~1e-8 relative (measured on an H100, PERF.md) — the input-
    rounding term that verify.ds_guard bounds."""
    Bsz, L = a_batch.shape
    W = 2 * r + 1
    ks = jnp.arange(W)

    def row(carry, i):
        Ph, Pl = carry
        j = i - r + ks
        valid = (j >= 0) & (j < L)
        qv = q_batch[:, jnp.clip(j, 0, L - 1)]
        d = (a_batch[:, i][:, None] - qv) ** 2
        d = jnp.where(valid[None, :], d, 0.0)
        sh = jnp.concatenate([Ph[:, 1:], jnp.full((Bsz, 1), BIG, Ph.dtype)], axis=1)
        sl = jnp.concatenate([Pl[:, 1:], jnp.zeros((Bsz, 1), Pl.dtype)], axis=1)
        Mh, Ml = _ds_min(Ph, Pl, sh, sl)
        first = jnp.where(ks == r, 0.0, BIG)[None, :]
        Mh = jnp.where(i == 0, first, Mh)
        Ml = jnp.where(i == 0, 0.0, Ml)
        Ch, Cl = _ds_cumsum(d)
        zero_col = jnp.zeros((Bsz, 1), d.dtype)
        Cph = jnp.concatenate([zero_col, Ch[:, :-1]], axis=1)
        Cpl = jnp.concatenate([zero_col, Cl[:, :-1]], axis=1)
        Gh, Gl = _ds_two_sum(Mh, Ml, -Cph, -Cpl)
        Gmh, Gml = _ds_cummin(Gh, Gl)
        Dh, Dl = _ds_two_sum(Ch, Cl, Gmh, Gml)
        Dh = jnp.where(valid[None, :], jnp.minimum(Dh, BIG), BIG)
        Dl = jnp.where(valid[None, :] & (Dh < BIG), Dl, 0.0)
        return (Dh, Dl), None

    P0 = (jnp.full((Bsz, W), BIG, jnp.float32), jnp.zeros((Bsz, W), jnp.float32))
    (Ph, Pl), _ = jax.lax.scan(row, P0, jnp.arange(L))
    return Ph[:, r], Pl[:, r]


def ds_value(hi, lo) -> np.ndarray:
    """Combine a device (hi, lo) double-single pair into host float64."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def lb_keogh_multi(a_batch: jnp.ndarray, lo_batch: jnp.ndarray,
                   hi_batch: jnp.ndarray) -> jnp.ndarray:
    """LB_Keogh with a per-row query envelope ((B, L) each)."""
    exc = jnp.maximum(jnp.maximum(a_batch - hi_batch, lo_batch - a_batch), 0.0)
    return jnp.sum(exc * exc, axis=1)


def lb_kim_multi(a_batch: jnp.ndarray, q_batch: jnp.ndarray) -> jnp.ndarray:
    """LB_Kim with a per-row query ((B, L))."""
    def dist(x, y):
        return (x - y) ** 2
    x = [a_batch[:, t] for t in range(3)]
    y = [a_batch[:, -1 - t] for t in range(3)]
    q = [q_batch[:, t] for t in range(3)]
    p = [q_batch[:, -1 - t] for t in range(3)]
    lb = dist(x[0], q[0]) + dist(y[0], p[0])
    lb += jnp.minimum(jnp.minimum(dist(x[1], q[0]), dist(x[0], q[1])),
                      dist(x[1], q[1]))
    lb += jnp.minimum(jnp.minimum(dist(y[1], p[0]), dist(y[0], p[1])),
                      dist(y[1], p[1]))
    d = jnp.minimum(jnp.minimum(dist(x[0], q[2]), dist(x[1], q[2])), dist(x[2], q[2]))
    lb += jnp.minimum(d, jnp.minimum(dist(x[2], q[1]), dist(x[2], q[0])))
    d = jnp.minimum(jnp.minimum(dist(y[0], p[2]), dist(y[1], p[2])), dist(y[2], p[2]))
    lb += jnp.minimum(d, jnp.minimum(dist(y[2], p[1]), dist(y[2], p[0])))
    return lb


def dtw_banded_batch_f64(a_batch: np.ndarray, q: np.ndarray, r: int,
                         ub: float = float("inf")) -> np.ndarray:
    """Float64 banded DTW for host confirmation: native C per-candidate DP when
    available (200x the NumPy row loop), exact-match NumPy twin otherwise.
    A finite ``ub`` enables sound early abandon: windows whose distance
    provably exceeds ub report a value > ub instead of the exact distance —
    valid whenever the caller only keeps distances <= ub."""
    from ..native import dtw_band_f64
    res = dtw_band_f64(a_batch, q, r, ub)
    if res is not None:
        return res
    return _dtw_banded_batch_f64_np(a_batch, q, r)


def _dtw_banded_batch_f64_np(a_batch: np.ndarray, q: np.ndarray, r: int) -> np.ndarray:
    """NumPy twin (kept as the reference implementation for tests)."""
    a_batch = np.asarray(a_batch, np.float64)
    q = np.asarray(q, np.float64)
    Bsz, L = a_batch.shape
    W = 2 * r + 1
    ks = np.arange(W)
    P = np.full((Bsz, W), np.inf)
    for i in range(L):
        j = i - r + ks
        valid = (j >= 0) & (j < L)
        qv = q[np.clip(j, 0, L - 1)]
        d = (a_batch[:, i][:, None] - qv[None, :]) ** 2
        d[:, ~valid] = 0.0
        shifted = np.concatenate([P[:, 1:], np.full((Bsz, 1), np.inf)], axis=1)
        M = np.minimum(P, shifted)
        if i == 0:
            M = np.where(ks == r, 0.0, np.inf)[None, :].repeat(Bsz, 0)
        C = np.cumsum(d, axis=1)
        Cprev = np.concatenate([np.zeros((Bsz, 1)), C[:, :-1]], axis=1)
        with np.errstate(invalid="ignore"):
            D = C + np.minimum.accumulate(M - Cprev, axis=1)
        D[:, ~valid] = np.inf
        P = D
    return P[:, r]


@functools.partial(jax.jit, static_argnames=())
def lb_kim(a_batch: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Batched LB_Kim endpoint bound (DtwUtils.lbKimHierarchy, DtwUtils.java:149-189)
    without the early exits — the full 3-front/3-back sum is the same valid lower
    bound and prunes at least as much."""
    def dist(x, y):
        return (x - y) ** 2
    x0, x1, x2 = a_batch[:, 0], a_batch[:, 1], a_batch[:, 2]
    y0, y1, y2 = a_batch[:, -1], a_batch[:, -2], a_batch[:, -3]
    q0, q1, q2 = q[0], q[1], q[2]
    p0, p1, p2 = q[-1], q[-2], q[-3]
    lb = dist(x0, q0) + dist(y0, p0)
    d = jnp.minimum(jnp.minimum(dist(x1, q0), dist(x0, q1)), dist(x1, q1))
    lb += d
    d = jnp.minimum(jnp.minimum(dist(y1, p0), dist(y0, p1)), dist(y1, p1))
    lb += d
    d = jnp.minimum(jnp.minimum(dist(x0, q2), dist(x1, q2)), dist(x2, q2))
    d = jnp.minimum(d, jnp.minimum(dist(x2, q1), dist(x2, q0)))
    lb += d
    d = jnp.minimum(jnp.minimum(dist(y0, p2), dist(y1, p2)), dist(y2, p2))
    d = jnp.minimum(d, jnp.minimum(dist(y2, p1), dist(y2, p0)))
    lb += d
    return lb


@jax.jit
def lb_keogh(a_batch: jnp.ndarray, q_lo: jnp.ndarray, q_hi: jnp.ndarray) -> jnp.ndarray:
    """Batched LB_Keogh against the query envelope (DtwUtils.lbKeoghCumulative,
    DtwUtils.java:206-222, fully summed)."""
    over = jnp.maximum(a_batch - q_hi[None, :], 0.0)
    under = jnp.maximum(q_lo[None, :] - a_batch, 0.0)
    exc = jnp.maximum(over, under)
    return jnp.sum(exc * exc, axis=1)


# ---------------------------------------------------------------------------
# Module-level jitted verify stages.  Defining these inside the engine methods
# would create a fresh jit cache entry per CALL (full retrace+recompile every
# query); at module level the cache is keyed by shapes only.

@functools.partial(jax.jit, static_argnames=("length",))
def lb_stage_multi(data, env_lo, env_hi, qm, lo_m, hi_m, offs, qids, length: int):
    """max(LB_Kim, query-envelope LB_Keogh, data-envelope LB_Keogh) per candidate.

    ``env_lo``/``env_hi`` are the GLOBAL Sakoe-Chiba envelope of the series
    (ops/sliding.sliding_min_max).  A gathered window of the global envelope
    encloses the window-local envelope (the extra out-of-window points near the
    window edges can only widen it), so LB_Keogh of the query against it stays a
    valid banded-DTW lower bound — the batch form of the reference's data-side
    Keogh stage (DtwUtils.java:238-257, applied at QueryEngineDtw.java:422) with
    the full-sum cumulative bound and a per-candidate max of the two Keogh
    directions instead of per-candidate early abandoning.
    """
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    e_lo = _gather_windows(env_lo, offs, length)
    e_hi = _gather_windows(env_hi, offs, length)
    q = qm[qids]
    lb = jnp.maximum(lb_kim_multi(x, q), lb_keogh_multi(x, lo_m[qids], hi_m[qids]))
    return jnp.maximum(lb, lb_keogh_multi(q, e_lo, e_hi))


def dtw_kernel_for(platform: str, r: int, length: int) -> str:
    """Route of the f32 banded-DP stage: ``'cuda'`` (the register-resident
    wavefront kernel, ops/dtw_cuda.py) on a GPU when the band fits it,
    ``'xla'`` (the prefix-scan formulation above) otherwise."""
    from .dtw_cuda import MAX_BAND
    if platform == "gpu":
        return "cuda" if 2 * min(r, length - 1) + 1 <= MAX_BAND else "xla"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no banded-DTW route for platform {platform!r}")


@functools.partial(jax.jit, static_argnames=("length", "r"))
def _dtw_stage_multi_xla(data, qm, offs, qids, length: int, r: int):
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    return dtw_banded_batch_multi(x, qm[qids], r)


@functools.partial(jax.jit, static_argnames=("length", "r"))
def _dtw_stage_multi_cuda(data, qm, offs, qids, length: int, r: int):
    from .dtw_cuda import dtw_banded_cuda
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    return dtw_banded_cuda(x, qm, qids, r)


def dtw_stage_multi(data, qm, offs, qids, length: int, r: int):
    """f32 banded-DP stage, routed by dtw_kernel_for.  Both routes compute the
    same recurrence; f32 rounding differs only in summation order, which the
    engines' guard band (vf.guard_threshold) absorbs — near-threshold
    candidates go to the DS/f64 confirm either way."""
    if dtw_kernel_for(jax.default_backend(), r, length) == "cuda":
        return _dtw_stage_multi_cuda(data, qm, offs, qids, length, r)
    return _dtw_stage_multi_xla(data, qm, offs, qids, length, r)


def _znorm_rows(x, length: int):
    inv_l = np.float32(1.0 / length)
    mean = jnp.sum(x, axis=1) * inv_l
    centered = x - mean[:, None]
    var = jnp.sum(centered * centered, axis=1) * inv_l
    std = jnp.sqrt(var)
    safe = jnp.where(std > 0, std, 1.0)
    return centered / safe[:, None], mean, std


@functools.partial(jax.jit, static_argnames=("length",))
def lb_stage_znorm_multi(data, env_lo, env_hi, zq_m, lo_m, hi_m, cons, offs,
                         qids, length: int):
    """cons rows: (alpha, beta, mu_q, sd_q, cg); returns inf where constraints
    fail (guarded), else max(LB_Kim, query-env LB_Keogh, data-env LB_Keogh) on
    z-normalized windows.

    The data envelope is gathered from the raw-series global envelope and
    z-normalized with the WINDOW's own (mean, std): z-normalization is a
    monotone affine map for std > 0, so the image of a (wider) raw envelope
    still encloses the z-window's local envelope — the bound stays valid
    (data-side Keogh of DtwUtils.java:238-257 in z-space)."""
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    z, mean, std = _znorm_rows(x, length)
    a = cons[qids, 0]
    b = cons[qids, 1]
    mq = cons[qids, 2]
    sq = cons[qids, 3]
    cg = cons[qids, 4]
    ratio = std / sq
    ok = ((jnp.abs(mean - mq) <= b + cg) & (ratio <= a + cg)
          & (ratio >= 1.0 / a - cg) & (std > 0))
    zq = zq_m[qids]
    lb = jnp.maximum(lb_kim_multi(z, zq),
                     lb_keogh_multi(z, lo_m[qids], hi_m[qids]))
    safe = jnp.where(std > 0, std, 1.0)[:, None]
    z_elo = (_gather_windows(env_lo, offs, length) - mean[:, None]) / safe
    z_ehi = (_gather_windows(env_hi, offs, length) - mean[:, None]) / safe
    lb = jnp.maximum(lb, lb_keogh_multi(zq, z_elo, z_ehi))
    return jnp.where(ok, lb, np.float32(np.inf))


@functools.partial(jax.jit, static_argnames=("length", "r"))
def _dtw_stage_znorm_multi_xla(data, zq_m, offs, qids, length: int, r: int):
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    z, _, _ = _znorm_rows(x, length)
    return dtw_banded_batch_multi(z, zq_m[qids], r)


@functools.partial(jax.jit, static_argnames=("length", "r"))
def _dtw_stage_znorm_multi_cuda(data, zq_m, offs, qids, length: int, r: int):
    from .dtw_cuda import dtw_banded_cuda
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    z, _, _ = _znorm_rows(x, length)
    return dtw_banded_cuda(z, zq_m, qids, r)


def dtw_stage_znorm_multi(data, zq_m, offs, qids, length: int, r: int):
    """z-normalized f32 banded-DP stage; see dtw_stage_multi for dispatch."""
    if dtw_kernel_for(jax.default_backend(), r, length) == "cuda":
        return _dtw_stage_znorm_multi_cuda(data, zq_m, offs, qids, length, r)
    return _dtw_stage_znorm_multi_xla(data, zq_m, offs, qids, length, r)


@functools.partial(jax.jit, static_argnames=("length", "r"))
def dtw_stage_ds_multi(data, qm, offs, qids, length: int, r: int):
    """Double-single DTW confirm stage (raw windows).

    Returns (hi, lo, amax): the DS distance pair plus each window's max |value|
    — the input-amplitude term of the guard bound (verify.ds_guard)."""
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    hi, lo = dtw_banded_batch_ds_multi(x, qm[qids], r)
    return hi, lo, jnp.max(jnp.abs(x), axis=1)


@functools.partial(jax.jit, static_argnames=("length", "r"))
def dtw_stage_znorm_ds_multi(data, zq_m, offs, qids, mu, sd, length: int,
                             r: int):
    """Double-single DTW confirm stage on z-normalized windows.

    ``mu``/``sd`` are per-candidate window statistics computed EXACTLY on the
    host (f64 prefix sums, rounded to f32): an on-device f32 mean of an
    L=8192 window could drift by ~L*eps32 and shift every z coherently, which
    would dominate the guard band; host stats reduce the input error to
    elementwise f32 rounding.  Returns (hi, lo, amp) with
    amp = (max|x| + |mu| + sd) / sd per row — the z-space image of the RAW
    data's f32 rounding (delta_z ~ eps32 * (|x| + |mu|) / sd, which dominates
    eps32 * |z| whenever the series rides a large common-mode offset) for the
    guard bound (verify.ds_guard)."""
    from .ed import _gather_windows
    x = _gather_windows(data, offs, length)
    z = (x - mu[:, None]) / sd[:, None]
    hi, lo = dtw_banded_batch_ds_multi(z, zq_m[qids], r)
    amp = (jnp.max(jnp.abs(x), axis=1) + jnp.abs(mu) + sd) / sd
    return hi, lo, amp
