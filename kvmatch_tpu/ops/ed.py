"""Batched Euclidean-distance verification kernels (phase 2, ED engines).

Batched redesign of the reference's scalar early-abandon loops
(QueryEngine.java:343-363, NormQueryEngine.java:484-527): instead of one
data-dependent loop per offset, all candidate windows are verified as one padded
(B, L) batch of fused vector ops.  Early abandoning does not vectorize; the win on
device comes from doing the full O(B*L) work at memory bandwidth and batching many
candidates (and many queries) per launch.

The z-normalized distance uses the closed form (MASS-style):

    d^2(i) = 2L - 2 * (X_i . q_hat) / sigma_i        with q_hat = (Q-muQ)/sigmaQ,

which follows from sum(q_hat)=0, sum(q_hat^2)=L, sum((x-mu_i)^2)=L*sigma_i^2 —
one matvec replaces the per-point normalize-subtract-square loop
(NormQueryEngine.java:511-517).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _gather_windows(data: jnp.ndarray, offsets: jnp.ndarray, length: int) -> jnp.ndarray:
    """(B, L) windows data[offsets[b] : offsets[b]+L], one dynamic_slice per
    window.  XLA's GPU gather of these contiguous windows is coalesced; a
    tiled covering-row gather with barrel-shift realignment measured slower
    on most phase-2 shapes (PERF.md, Kernel decisions)."""
    return jax.vmap(lambda o: jax.lax.dynamic_slice(data, (o,), (length,)))(
        offsets)


@functools.partial(jax.jit, static_argnames=("length",))
def ed_distances(data: jnp.ndarray, query: jnp.ndarray, offsets: jnp.ndarray,
                 length: int) -> jnp.ndarray:
    """Raw squared Euclidean distances for a batch of candidate offsets."""
    x = _gather_windows(data, offsets, length)
    diff = x - query[None, :]
    return jnp.sum(diff * diff, axis=1)


@functools.partial(jax.jit, static_argnames=("length",))
def ed_distances_multi(data: jnp.ndarray, queries: jnp.ndarray,
                       offsets: jnp.ndarray, qids: jnp.ndarray,
                       length: int) -> jnp.ndarray:
    """Raw squared distances for candidates belonging to *different* queries:
    one launch serves a whole query batch (queries: (Q, L), qids: (B,))."""
    x = _gather_windows(data, offsets, length)
    diff = x - queries[qids]
    return jnp.sum(diff * diff, axis=1)


@functools.partial(jax.jit, static_argnames=("length",))
def znorm_ed_distances_multi(data: jnp.ndarray, queries_hat: jnp.ndarray,
                             offsets: jnp.ndarray, qids: jnp.ndarray,
                             length: int):
    """Batched z-normalized distances across a query batch; returns
    (d2, mean, std) like znorm_ed_distances."""
    x = _gather_windows(data, offsets, length)
    inv_l = np.float32(1.0 / length)
    mean = jnp.sum(x, axis=1) * inv_l
    centered = x - mean[:, None]
    var = jnp.sum(centered * centered, axis=1) * inv_l
    std = jnp.sqrt(var)
    safe = jnp.where(std > 0, std, 1.0)
    zdiff = centered / safe[:, None] - queries_hat[qids]
    d2 = jnp.sum(zdiff * zdiff, axis=1)
    d2 = jnp.where(std > 0, d2, jnp.inf)
    return d2, mean, std


@functools.partial(jax.jit, static_argnames=("length",))
def znorm_ed_distances(data: jnp.ndarray, query_hat: jnp.ndarray,
                       offsets: jnp.ndarray, length: int):
    """Z-normalized squared distances + window mean/std for a candidate batch.

    ``query_hat`` must already be z-normalized ((Q-muQ)/sigmaQ, population std).
    Returns (d2, mean, std); d2 is inf where std == 0.
    """
    x = _gather_windows(data, offsets, length)
    inv_l = np.float32(1.0 / length)
    mean = jnp.sum(x, axis=1) * inv_l
    centered = x - mean[:, None]
    var = jnp.sum(centered * centered, axis=1) * inv_l
    std = jnp.sqrt(var)
    safe = jnp.where(std > 0, std, 1.0)
    # Direct z-diff sum: numerically far better conditioned than the MASS
    # closed form 2L - 2*dot/sigma, whose cancellation at small d^2 would blow
    # past the f32 guard band for long queries.
    zdiff = centered / safe[:, None] - query_hat[None, :]
    d2 = jnp.sum(zdiff * zdiff, axis=1)
    d2 = jnp.where(std > 0, d2, jnp.inf)
    return d2, mean, std
