"""Device-side sliding-window primitives (JAX/XLA).

The reference computes sliding window sums with a serial running accumulator and a
circular buffer, restarting every EPOCH=100000 points to bound float error
(IndexBuilder.java:135-136, 233-291).  On the device we replace that scalar loop with a
log-depth *doubling* scheme over the whole series at once:

    S_u[i]    = sum(T[i:i+u])                  (one tree-reduction window op)
    S_{2w}[i] = S_w[i] + S_w[i+w]              (one shifted add per doubling)

so all scales in Sigma = {25, 50, 100, 200, 400} come out of one base pass plus four
vector adds.  Every element is produced by a balanced-tree summation of at most
w leaves, which keeps float32 error at the eps*log2(w) level instead of the
eps*EPOCH level of a running sum — this is what makes the f32 device build safe when
combined with the engine's probe guard (config.IndexConfig.probe_guard).

All functions are jit-compatible and shard_map-compatible (pure, static shapes).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _unit_sliding_sum(x: jnp.ndarray, u: int) -> jnp.ndarray:
    """Sliding sum of width ``u`` at every offset, via log-depth doubling.

    Returns S[i] = sum(x[i:i+u]) for i in [0, n-u]; length n-u+1.
    """
    n = x.shape[0]
    # Power-of-two sliding sums up to u, each one shifted add of the previous.
    pow_sums = {1: x}
    width = 1
    while width * 2 <= u:
        s = pow_sums[width]
        pow_sums[width * 2] = s[: n - 2 * width + 1] + s[width: n - width + 1]
        width *= 2
    # Combine the binary decomposition of u (static Python offsets -> plain slices).
    out_len = n - u + 1
    acc = None
    offset, rem = 0, u
    for w in sorted(pow_sums, reverse=True):
        if rem >= w:
            piece = pow_sums[w][offset: offset + out_len]
            acc = piece if acc is None else acc + piece
            offset += w
            rem -= w
    return acc


def sliding_sums(data: jnp.ndarray, scales: Sequence[int]) -> Dict[int, jnp.ndarray]:
    """Sliding sums for every scale in ``scales`` from one base pass.

    Scales must all be multiples of the smallest scale u (the reference's WuList
    invariant, QueryEngine.java:51).  Output[w][i] = sum(data[i:i+w]), length n-w+1.
    """
    scales = sorted(scales)
    u = scales[0]
    n = data.shape[0]
    base = _unit_sliding_sum(data, u)  # length n-u+1
    # Power-of-two multiples of the base.
    pow_sums = {1: base}
    max_k = scales[-1] // u
    k = 1
    while k * 2 <= max_k:
        s = pow_sums[k]
        step = k * u
        m = n - 2 * k * u + 1
        pow_sums[k * 2] = s[:m] + s[step: step + m]
        k *= 2
    out = {}
    for w in scales:
        kk = w // u
        out_len = n - w + 1
        acc = None
        offset, rem = 0, kk
        for p in sorted(pow_sums, reverse=True):
            if rem >= p:
                piece = pow_sums[p][offset: offset + out_len]
                acc = piece if acc is None else acc + piece
                offset += p * u
                rem -= p
        out[w] = acc
    return out


def bucketize_means(window_sums: jnp.ndarray, w: int, pos_of_d: int) -> jnp.ndarray:
    """Map window sums to int32 mean-bucket ids on device.

    bucket = 2*floor(mean*s) + (frac >= 0.5), s = 10^(pos_of_d-1), so that
    bucket * d/1 reproduces MeanIntervalUtils.toRound (MeanIntervalUtils.java:51-61)
    with d = 0.5/s.
    """
    scale = np.float32(10.0 ** (pos_of_d - 1))
    v = window_sums * (scale / np.float32(w))
    iv = jnp.floor(v)
    half = (v - iv >= 0.5).astype(jnp.int32)
    return 2 * iv.astype(jnp.int32) + half


@functools.partial(jax.jit, static_argnames=("scales", "pos_of_d"))
def build_buckets(data: jnp.ndarray, scales: Tuple[int, ...], pos_of_d: int
                  ) -> Dict[int, jnp.ndarray]:
    """One fused pass: data -> per-scale int32 bucket ids for every window start."""
    sums = sliding_sums(data, scales)
    return {w: bucketize_means(s, w, pos_of_d) for w, s in sums.items()}


def _forward_extreme(x: jnp.ndarray, L: int, op) -> jnp.ndarray:
    """Forward-window extreme: out[i] = op-reduce(x[i:i+L]); length n-L+1.

    Log-depth doubling; min/max are idempotent so the final combine uses two
    OVERLAPPING power-of-two windows covering [0, L)."""
    n = x.shape[0]
    pow_ = {1: x}
    w = 1
    while w * 2 <= L:
        s = pow_[w]
        pow_[w * 2] = op(s[: n - 2 * w + 1], s[w: n - w + 1])
        w *= 2
    out_len = n - L + 1
    s = pow_[w]
    return op(s[:out_len], s[L - w: L - w + out_len])


def sliding_window_stats_fwd(x: jnp.ndarray, L: int
                             ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                        jnp.ndarray, jnp.ndarray]:
    """Per-offset width-L window statistics: (sum, sum-of-squares, min, max),
    each length n-L+1, all via log-depth doubling (balanced-tree f32 error —
    the soundness basis for the device constraint prefilter's tolerance:
    |sum error| <= eps32 * ~log2(L) * L * max|x in window|, so a guard scaled
    by the window's own max-abs (from the min/max tracks) can never falsely
    dismiss; see parallel/query.make_dense_probe_step_flags_pallas)."""
    s1 = _unit_sliding_sum(x, L)
    s2 = _unit_sliding_sum(x * x, L)
    lo = _forward_extreme(x, L, jnp.minimum)
    hi = _forward_extreme(x, L, jnp.maximum)
    return s1, s2, lo, hi


def sliding_min_max(data: jnp.ndarray, radius: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lemire envelope on device: l[i] = min(data[i-r : i+r+1]), u[i] = max(...),
    with edge clamping (same output as DtwUtils.lowerUpperLemire, DtwUtils.java:50-91,
    computed with a log-depth tree instead of a serial monotonic deque).
    """
    window = 2 * radius + 1
    lo = jax.lax.reduce_window(data, jnp.inf, jax.lax.min, (window,), (1,),
                               [(radius, radius)])
    hi = jax.lax.reduce_window(data, -jnp.inf, jax.lax.max, (window,), (1,),
                               [(radius, radius)])
    return lo, hi
