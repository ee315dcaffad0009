"""Fused dense phase-1 probe (bound + flag emission) in Pallas through Triton.

The XLA flags step (parallel/query.py:make_dense_probe_step_flags) evaluates
the accumulated epsilon lower bound for every position with per-segment
TRACED addressing — a traced row pick into the bucket stack plus a
traced-start shift.  XLA cannot fuse that addressing: every segment's shifted
window and each query's accumulators pass through device memory, about
Q * S * n int32 of window traffic per pass (~100 GB at n=1e8, Q=8, S=30)
against 2 GB for one read of the 5-scale stack.  This kernel is the fused
pass:

  program t = one TILE-position tile.  For every query, a loop over the
  padded segment table loads that segment's window straight from the bucket
  stack (row ``scale_idx``, columns ``tile + (order - 1) * unit``: Triton
  loads at any dynamic offset, so no staging or lane rotation is needed),
  and accumulates the z-space bound (and the Ex/Ex2 std-filter tracks for the
  cNSM variant) in registers.  Neighbouring tiles read overlapping windows,
  which the L2 cache serves.

Each program writes per-FLAG candidate flags (the overflow-proof bitmap phase
2 rejects over-coverage from) and its exact per-query candidate counts; the
counts of all tiles are summed by the caller (blocks run in no order, so
nothing is carried across programs).

Numerics match parallel/query.py:_dense_probe_norm / _dense_probe op-for-op
in f32 (scalar reciprocals, the same where-free min/max forms); bucket
windows come from the same XLA build_buckets, so phase-1 soundness
(probe_guard slack) is unchanged.

Reference: the probe replaces the index KV range scans + interval
intersection of QueryEngine.java:270-327 / NormQueryEngine.java:120-180 in
flood regimes where host interval algebra is the bottleneck.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE = 1024          # positions per program (power of two)
FLAG = 128           # flag granularity
FL = TILE // FLAG    # flags per program


def probe_kernel_for(platform: str) -> str:
    """Route of the flood flag probe: ``'triton'`` (this kernel) on a GPU,
    ``'xla'`` (parallel/query.make_dense_probe_step_flags) on the CPU."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no flag-probe route for platform {platform!r}")


def _probe_kernel(Q: int, s_seg: int, length: int, unit: int, d: float,
                  slack: float, norm: bool):
    d32 = np.float32(d)
    slack32 = np.float32(slack)
    unit32 = np.float32(unit)
    qlen32 = np.float32(length)
    INF = np.float32(np.inf)

    def kernel(stack_ref, iscale_ref, iorder_ref, ivalid_ref, fmlo_ref,
               fmhi_ref, fwidth_ref, feps2_ref, fcons_ref, iscal_ref,
               flags_ref, counts_ref):
        t = pl.program_id(0)
        col0 = iscal_ref[0]          # stack column of the block's position 0
        p0 = iscal_ref[1]            # global position of the block
        m = iscal_ref[2]             # number of valid window starts
        lane = jax.lax.broadcasted_iota(jnp.int32, (TILE,), 0)
        pos = p0 + t * TILE + lane
        col = col0 + t * TILE
        zeros = jnp.zeros((TILE,), jnp.float32)

        for q in range(Q):
            alpha = fcons_ref[q, 0]
            beta = fcons_ref[q, 1]
            mu_q = fcons_ref[q, 2]
            sd_q = fcons_ref[q, 3]
            inv_big = np.float32(1.0) / (alpha * sd_q)
            inv_small = np.float32(1.0) / (sd_q / alpha)
            inv_sd = np.float32(1.0) / sd_q

            def seg_body(s, carry):
                acc, exlo, exup, ex2lo, punits = carry
                sidx = iscale_ref[q, s]
                shift = (iorder_ref[q, s] - 1) * unit
                vmul = jnp.where(ivalid_ref[q, s] != 0, np.float32(1.0),
                                 np.float32(0.0))
                bw = stack_ref[sidx, pl.ds(col + shift, TILE)]
                key_lo = bw.astype(jnp.float32) * d32 - slack32
                key_hi = key_lo + d32 + 2 * slack32
                mlo = fmlo_ref[q, s]
                mhi = fmhi_ref[q, s]
                width = fwidth_ref[q, s]
                k_units = width / unit32
                if norm:
                    n_lo = key_lo - (mu_q + beta)
                    n_hi = key_hi - (mu_q - beta)
                    # inv_small >= inv_big > 0 (alpha >= 1): the sign-
                    # dependent picks of _dense_probe_norm are a min / max.
                    z_lo = jnp.minimum(n_lo * inv_big, n_lo * inv_small)
                    z_hi = jnp.maximum(n_hi * inv_small, n_hi * inv_big)
                    zq_lo = (mlo - mu_q) * inv_sd
                    zq_hi = (mhi - mu_q) * inv_sd
                    delta = jnp.maximum(
                        jnp.maximum(z_lo - zq_hi, zq_lo - z_hi), 0.0)
                    acc = acc + vmul * (width * delta * delta)
                    exlo = exlo + vmul * (key_lo * k_units)
                    exup = exup + vmul * (key_hi * k_units)
                    # min-|value| of [key_lo, key_hi], squared
                    sq_r = jnp.maximum(key_lo, 0.0) + jnp.minimum(key_hi, 0.0)
                    ex2lo = ex2lo + vmul * (sq_r * sq_r * k_units)
                    punits = punits + vmul * k_units
                else:
                    delta = jnp.maximum(
                        jnp.maximum(key_lo - mhi, mlo - key_hi), 0.0)
                    acc = acc + vmul * (width * delta * delta)
                return acc, exlo, exup, ex2lo, punits

            carry0 = (zeros, zeros, zeros, zeros, jnp.float32(0.0))
            acc, exlo, exup, ex2lo, punits = jax.lax.fori_loop(
                0, s_seg, seg_body, carry0)

            if norm:
                punits = jnp.maximum(punits, 1.0)
                rest = qlen32 - punits * unit32
                limit = (alpha * sd_q) ** 2 + np.float32(1e-6)
                mean_lo = exlo / punits
                mean_up = exup / punits
                over = mean_lo > mu_q + beta
                under = mean_up < mu_q - beta
                rest_s = jnp.maximum(rest, 1.0)
                nv_o = mu_q + beta - (mean_lo - (mu_q + beta)) * punits * unit32 / rest_s
                var_o = (ex2lo * unit32 + rest * nv_o * nv_o) / qlen32 \
                    - (mu_q + beta) ** 2
                nv_u = mu_q - beta + ((mu_q - beta) - mean_up) * punits * unit32 / rest_s
                var_u = (ex2lo * unit32 + rest * nv_u * nv_u) / qlen32 \
                    - (mu_q - beta) ** 2
                bad_rest = (over & (var_o > limit)) | (under & (var_u > limit))
                bad_flat = (over & ((mean_lo - (mu_q + beta)) ** 2 > limit)) \
                    | (under & (((mu_q - beta) - mean_up) ** 2 > limit))
                std_bad = jnp.where(rest > 0, bad_rest, bad_flat)
                acc = jnp.where(std_bad, INF, acc)

            hit = ((acc <= feps2_ref[q]) & (pos < m)).astype(jnp.int32)
            counts_ref[t, q] = jnp.sum(hit)
            flags_ref[t, q, :] = jnp.max(hit.reshape(FL, FLAG), axis=1)

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "n_tiles", "length", "unit", "d", "slack", "norm", "interpret"))
def probe_flags_tiles(stack, iscale, iorder, ivalid, fmlo, fmhi, fwidth,
                      feps2, fcons, iscal, *, n_tiles: int, length: int,
                      unit: int, d: float, slack: float, norm: bool,
                      interpret: bool = False):
    """Fused probe over ``n_tiles`` TILE-position tiles.

    stack: (S, W) i32 bucket rows; tile t's position j reads column
    ``iscal[0] + t*TILE + j + shift``, so W must cover the block plus the
    largest segment shift (the caller pads with prune-everything fill).
    Segment tables (Q, S_SEG) i32/f32; feps2 (Q,); fcons (Q, 4); iscal (3,)
    = [column of position p0, p0, m].  Returns (flags (Q, n_tiles*FL) bool,
    counts (Q,) i32)."""
    Q, S_SEG = iscale.shape
    flags, counts = pl.pallas_call(
        _probe_kernel(Q, S_SEG, length, unit, d, slack, norm),
        grid=(n_tiles,),
        out_shape=[
            jax.ShapeDtypeStruct((n_tiles, Q, FL), jnp.int32),
            jax.ShapeDtypeStruct((n_tiles, Q), jnp.int32),
        ],
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        name="kvmatch_probe_flags",
    )(stack, iscale, iorder, ivalid, fmlo, fmhi, fwidth, feps2, fcons, iscal)
    flags = flags.transpose(1, 0, 2).reshape(Q, n_tiles * FL) > 0
    return flags, jnp.sum(counts, axis=0)
