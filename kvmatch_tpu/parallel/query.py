"""Dense, fully-jitted query step — single-chip and mesh-sharded (SPMD).

The host engines (engine/*.py) use ragged interval lists, which are fast but not
jittable.  This module is the device-pure alternative: phase 1 is evaluated *densely*
against the per-scale bucket arrays (the raw index) as fused elementwise ops, and
phase 2 verifies a bounded top-K candidate set in the same jit program:

  for each probe segment s:                    (lax.fori_loop, static max count)
      eps_acc[q] += w_s * dist(mean_s, bucket cell at q + (order_s-1)*unit)^2
  mask = eps_acc <= eps^2                      (no-false-dismissal lower bound)
  candidates = first K positions of mask       (jnp.nonzero, static K)
  d2 = batched ED on gathered windows          (phase 2)

Under ``jax.shard_map`` the series and bucket stack are sharded by offset range
with a right-halo ppermute, segment parameters are replicated, and each
shard emits its own top-K — the cross-shard "candidate all-gather" of SURVEY.md
section 2.6.  Deviations from the host engines, both sound: the probe range uses
the full epsilon budget for every segment (no sequential budget shrinking), and
candidate sets are truncated at K per shard (the returned count flags overflow).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import IndexConfig
from .mesh import AXIS

MAX_SEGMENTS = 30
# Fill value for positions past the end of a scale's bucket array: maps to an
# astronomically distant mean cell, so the probe assigns an epsilon far above any
# budget — out-of-range windows prune themselves.
BIG_BUCKET = np.int32(2 ** 30)


def pack_bucket_stack(buckets, scales, n: int, extra: int) -> np.ndarray:
    """Stack per-scale bucket arrays into (n_scales, n + extra) with BIG_BUCKET
    fill; ``extra`` must cover the largest segment shift (the query length)."""
    out = np.full((len(scales), n + extra), BIG_BUCKET, np.int32)
    for i, w in enumerate(scales):
        b = np.asarray(buckets[w], np.int32)
        out[i, : b.size] = b
    return out


class DenseSegments(NamedTuple):
    """Replicated segment parameters, padded to MAX_SEGMENTS."""
    scale_idx: jnp.ndarray  # i32[S] index into the scale list
    order: jnp.ndarray      # i32[S] 1-based unit offset
    mean_lo: jnp.ndarray    # f32[S]
    mean_hi: jnp.ndarray    # f32[S]
    width: jnp.ndarray      # f32[S] window width w
    valid: jnp.ndarray      # bool[S]


def pack_segments(segments, scales: Tuple[int, ...]) -> DenseSegments:
    S = MAX_SEGMENTS
    scale_pos = {w: i for i, w in enumerate(scales)}
    k = len(segments)
    return DenseSegments(
        scale_idx=jnp.asarray(np.array([scale_pos[s.w] for s in segments] + [0] * (S - k), np.int32)),
        order=jnp.asarray(np.array([s.order for s in segments] + [1] * (S - k), np.int32)),
        mean_lo=jnp.asarray(np.array([s.mean_lo for s in segments] + [0.0] * (S - k), np.float32)),
        mean_hi=jnp.asarray(np.array([s.mean_hi for s in segments] + [0.0] * (S - k), np.float32)),
        width=jnp.asarray(np.array([float(s.w) for s in segments] + [1.0] * (S - k), np.float32)),
        valid=jnp.asarray(np.array([True] * k + [False] * (S - k))),
    )


def _row_at_shift(bstack: jnp.ndarray, scale_idx, shift, out_len: int):
    """``bstack[scale_idx][shift : shift + out_len]`` for traced scale_idx /
    shift."""
    return jax.lax.dynamic_slice(bstack[scale_idx], (shift,), (out_len,))


def _dense_probe(bstack: jnp.ndarray, segs: DenseSegments, unit: int,
                 d: float, out_len: int, slack: float) -> jnp.ndarray:
    """Accumulated epsilon lower bound per local candidate position.

    Bucket ids advance by one per d-wide grid cell (utils/rounding.bucket_id), so
    the cell covered by bucket b is [b*d, b*d + d], widened by the probe slack."""
    def body(acc, sg):
        scale_idx, order, mean_lo, mean_hi, width, valid = sg
        shift = (order - 1) * unit
        b = _row_at_shift(bstack, scale_idx, shift,
                          out_len).astype(jnp.float32)
        key_lo = b * np.float32(d) - slack
        key_hi = key_lo + np.float32(d) + 2 * slack
        delta = jnp.maximum(jnp.maximum(key_lo - mean_hi,
                                        mean_lo - key_hi), 0.0)
        eps = width * delta * delta
        return acc + jnp.where(valid, eps, 0.0), None

    # Derive the accumulator from the (possibly shard-varying) bucket stack so
    # the scan carry has consistent manual-axis types under shard_map.  The
    # scan is FULLY UNROLLED: a rolled loop forces the (batched) accumulator
    # through HBM once per segment — 30x the mandatory traffic; unrolled, XLA
    # fuses all segment contributions into one pass over the block.
    acc0 = jnp.zeros(out_len, jnp.float32) + 0.0 * bstack[0, :out_len].astype(jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, segs, unroll=True)
    return acc


def make_dense_query_step(icfg: IndexConfig, length: int, top_k: int = 2048,
                          scales: Tuple[int, ...] | None = None):
    """Single-device jittable query step.

    Args to the returned fn: (data f32[n], bstack i32[n_scales, n], query f32[L],
    segs DenseSegments, eps2 f32[]) -> (count i32, offsets i32[K], d2 f32[K]).
    """
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    slack = np.float32(icfg.probe_guard)

    def step(data, bstack, query, segs: DenseSegments, eps2):
        n = data.shape[0]
        m = n - length + 1
        k = min(top_k, n)  # oversized K degrades gracefully
        eps_acc = _dense_probe(bstack, segs, unit, icfg.d, n, slack)
        pos = jnp.arange(n, dtype=jnp.int32)
        mask = (eps_acc <= eps2) & (pos < m)
        count = jnp.sum(mask.astype(jnp.int32))
        (idx,) = jnp.nonzero(mask, size=k, fill_value=n - length)
        x = data[idx[:, None] + jnp.arange(length, dtype=jnp.int32)[None, :]]
        diff = x - query[None, :]
        d2 = jnp.sum(diff * diff, axis=1)
        live = jnp.arange(k) < count
        d2 = jnp.where(live, d2, jnp.inf)
        return count, idx, d2

    return jax.jit(step)


def pack_segments_batch(segment_lists, scales: Tuple[int, ...]) -> DenseSegments:
    """Stack per-query DenseSegments into leading-Q arrays for the batched step.

    Built entirely in NumPy with ONE device transfer per field: a per-query
    pack + jnp.stack would issue ~6 * (Q + 1) tiny device ops per batch."""
    S = MAX_SEGMENTS
    scale_pos = {w: i for i, w in enumerate(scales)}
    Q = len(segment_lists)
    scale_idx = np.zeros((Q, S), np.int32)
    order = np.ones((Q, S), np.int32)
    mean_lo = np.zeros((Q, S), np.float32)
    mean_hi = np.zeros((Q, S), np.float32)
    width = np.ones((Q, S), np.float32)
    valid = np.zeros((Q, S), bool)
    for qi, segs in enumerate(segment_lists):
        k = len(segs)
        scale_idx[qi, :k] = [scale_pos[s.w] for s in segs]
        order[qi, :k] = [s.order for s in segs]
        mean_lo[qi, :k] = [s.mean_lo for s in segs]
        mean_hi[qi, :k] = [s.mean_hi for s in segs]
        width[qi, :k] = [float(s.w) for s in segs]
        valid[qi, :k] = True
    return DenseSegments(*(jnp.asarray(a) for a in (
        scale_idx, order, mean_lo, mean_hi, width, valid)))


def make_dense_query_step_batched(icfg: IndexConfig, length: int,
                                  top_k: int = 1024,
                                  scales: Tuple[int, ...] | None = None):
    """Single-device, MULTI-QUERY jittable step: phase 1 for a whole query batch
    as one fused program (vmap of the dense probe over the query dimension).

    Args: (data f32[n], bstack i32[S, n+pad], queries f32[Q, L],
    segs DenseSegments with leading Q dims, eps2 f32[Q])
    -> (counts i32[Q], offsets i32[Q, K], d2 f32[Q, K]).
    """
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    slack = np.float32(icfg.probe_guard)

    def step(data, bstack, queries, segs: DenseSegments, eps2):
        n = data.shape[0]
        m = n - length + 1
        k = min(top_k, n)  # oversized K degrades gracefully
        eps_acc = jax.vmap(
            lambda sg: _dense_probe(bstack, sg, unit, icfg.d, n, slack))(segs)
        pos = jnp.arange(n, dtype=jnp.int32)
        mask = (eps_acc <= eps2[:, None]) & (pos[None, :] < m)
        counts = jnp.sum(mask.astype(jnp.int32), axis=1)
        # top_k over masked scores gives each query's K candidate positions
        # (jnp.nonzero is not vmappable; top-k by smallest accumulated bound is).
        scores = jnp.where(mask, -eps_acc, -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        idx = jnp.minimum(idx.astype(jnp.int32), m - 1)

        def one(q_row, idx_row):
            x = jax.vmap(lambda o: jax.lax.dynamic_slice(data, (o,), (length,)))(idx_row)
            diff = x - q_row[None, :]
            return jnp.sum(diff * diff, axis=1)

        d2 = jax.vmap(one)(queries, idx)
        live = jnp.arange(k)[None, :] < jnp.minimum(counts, k)[:, None]
        d2 = jnp.where(live, d2, jnp.inf)
        return counts, idx, d2

    return jax.jit(step)


def _dense_probe_norm(bstack: jnp.ndarray, segs: DenseSegments, unit: int,
                      d: float, out_len: int, slack: float,
                      alpha, beta, mu_q, sd_q, qlen: int):
    """Dense cNSM probe: accumulate the z-space epsilon lower bound and the
    Ex/Ex2 bound tracks for every candidate position (the elementwise form of
    engine/norm_ed.py's _scan + _combine filters)."""
    s_small = sd_q / alpha
    s_big = alpha * sd_q
    # Scalar reciprocals once: a vector/scalar divide per segment is a
    # multi-cycle op; multiply-by-reciprocal is one.  The <= 1-ulp
    # difference is far inside the probe_guard slack (and the probe kernel
    # computes the identical expression, keeping the two routes bit-equal).
    inv_big = 1.0 / s_big
    inv_small = 1.0 / s_small
    inv_sd = 1.0 / sd_q

    def body(carry, sg):
        acc, exlo, exup, ex2lo, punits = carry
        scale_idx, order, mean_lo_s, mean_hi_s, width, valid = sg
        shift = (order - 1) * unit
        b = _row_at_shift(bstack, scale_idx, shift,
                          out_len).astype(jnp.float32)
        key_lo = b * np.float32(d) - slack
        key_hi = key_lo + np.float32(d) + 2 * slack
        n_lo = key_lo - (mu_q + beta)
        n_hi = key_hi - (mu_q - beta)
        z_lo = jnp.where(n_lo >= 0, n_lo * inv_big, n_lo * inv_small)
        z_hi = jnp.where(n_hi >= 0, n_hi * inv_small, n_hi * inv_big)
        zq_lo = (mean_lo_s - mu_q) * inv_sd
        zq_hi = (mean_hi_s - mu_q) * inv_sd
        delta = jnp.maximum(jnp.maximum(z_lo - zq_hi, zq_lo - z_hi), 0.0)
        v = valid
        k_units = width / unit
        acc = acc + jnp.where(v, width * delta * delta, 0.0)
        exlo = exlo + jnp.where(v, key_lo * k_units, 0.0)
        exup = exup + jnp.where(v, key_hi * k_units, 0.0)
        sq = jnp.where(key_lo > 0, key_lo * key_lo,
                       jnp.where(key_hi < 0, key_hi * key_hi, 0.0))
        ex2lo = ex2lo + jnp.where(v, sq * k_units, 0.0)
        punits = punits + jnp.where(v, k_units, 0.0)
        return (acc, exlo, exup, ex2lo, punits), None

    # Fully unrolled for the same fusion reason as _dense_probe — with FIVE
    # carried tracks the rolled loop costs ~5x more spurious HBM traffic here.
    zero = jnp.zeros(out_len, jnp.float32) + 0.0 * bstack[0, :out_len].astype(jnp.float32)
    (acc, exlo, exup, ex2lo, punits), _ = jax.lax.scan(
        body, (zero, zero, zero, zero, jnp.float32(0.0)), segs, unroll=True)
    punits = jnp.maximum(punits, 1.0)

    # Derived-sigma filter at full coverage (engine/norm_ed.py _std_filter).
    rest = qlen - punits * unit
    limit = (alpha * sd_q) ** 2 + 1e-6
    mean_lo = exlo / punits
    mean_up = exup / punits
    over = mean_lo > mu_q + beta
    nv_o = mu_q + beta - (mean_lo - (mu_q + beta)) * punits * unit / jnp.maximum(rest, 1.0)
    var_o = (ex2lo * unit + rest * nv_o * nv_o) / qlen - (mu_q + beta) ** 2
    under = mean_up < mu_q - beta
    nv_u = mu_q - beta + ((mu_q - beta) - mean_up) * punits * unit / jnp.maximum(rest, 1.0)
    var_u = (ex2lo * unit + rest * nv_u * nv_u) / qlen - (mu_q - beta) ** 2
    std_bad = jnp.where(rest > 0,
                        (over & (var_o > limit)) | (under & (var_u > limit)),
                        jnp.where(over, (mean_lo - (mu_q + beta)) ** 2 > limit,
                                  jnp.where(under, ((mu_q - beta) - mean_up) ** 2 > limit,
                                            False)))
    return jnp.where(std_bad, jnp.inf, acc)


# Largest per-query position block the dense probe materializes at once;
# the per-block working set is ~PROBE_TEMP_COUNT live (Q, block) temps (the
# fly probe's run compaction alone keeps the mask, two prefix scans + their
# shifted copies, two cumsum/destination pairs and both scatter operands
# alive, and the unrolled 30-segment norm probe carries FIVE accumulator
# tracks), so the per-temp budget divides detected device memory by that
# count.  Counting only one accumulator once compiled a Q=128 program whose
# real working set exceeded a 16 GB device; this width-aware cap fixes it.
PROBE_BLOCK_MAX = 1 << 22
PROBE_BLOCK_MIN = 1 << 18
PROBE_TEMP_COUNT = 24          # conservative live (Q, block)-temp count
PROBE_HBM_FRACTION = 0.5       # share of device memory the probe may touch
#: Device-memory stand-in on the CPU backend, where host RAM would otherwise
#: let trace-time block choices diverge from what a card can run.
CPU_DEVICE_MEM_BYTES = 16 << 30
_PROBE_MEM_BYTES = None        # detected once per process


def _device_mem_bytes(device=None) -> int:
    """Memory capacity of ``device`` (default: JAX's first device, cached):
    the allocator's ``bytes_limit`` on an accelerator, CPU_DEVICE_MEM_BYTES
    on the CPU.  An accelerator that reports no limit is an error."""
    global _PROBE_MEM_BYTES
    if device is None and _PROBE_MEM_BYTES is not None:
        return _PROBE_MEM_BYTES
    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        mem = CPU_DEVICE_MEM_BYTES
    else:
        mem = int((dev.memory_stats() or {}).get("bytes_limit", 0))
        if mem <= 0:
            raise RuntimeError(
                f"device {dev.device_kind!r} reports no memory bytes_limit")
    if device is None:
        _PROBE_MEM_BYTES = mem
    return mem


def probe_mem_budget() -> int:
    """Per-temp budget in f32 ELEMENTS for one (Q, block) probe temp."""
    per_temp = int(_device_mem_bytes() * PROBE_HBM_FRACTION) // PROBE_TEMP_COUNT
    return max(PROBE_BLOCK_MIN, per_temp // 4)


def probe_block_for(n: int, n_queries: int = 1) -> int:
    """Position-block size the blocked probe will pick (trace-time ints)."""
    blk = min(PROBE_BLOCK_MAX, max(PROBE_BLOCK_MIN,
                                   probe_mem_budget() // max(n_queries, 1)))
    return min(n, blk)


def probe_stack_extra(n: int, length: int) -> int:
    """Bucket-stack column padding that keeps every block slice in bounds for
    any batch size: worst-case block remainder plus the segment-shift halo."""
    return probe_block_for(n) + max(length, 8192)


def make_dense_probe_step_batched(icfg: IndexConfig, length: int,
                                  top_k: int = 4096, norm: bool = False,
                                  scales: Tuple[int, ...] | None = None):
    """Phase-1-only dense step: (counts i32[Q], offsets i32[Q, K]) with offsets
    ranked by smallest accumulated bound.  norm=True uses the z-space probe with
    the std filter (cons rows (alpha, beta, mu_q, sd_q)).

    Positions stream through fixed-size blocks (lax.fori_loop) with a running
    top-K merge, so device memory is O(Q * block + Q * K) instead of O(Q * n):
    the scale story of mapreduce/experiments/LongRandomQueryTest.java:33-50 on
    one chip.  Results are identical to the unblocked form (the merge keeps
    the K smallest accumulated bounds globally)."""
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    slack = np.float32(icfg.probe_guard)

    def step(data, bstack, segs: DenseSegments, eps2, cons):
        n = data.shape[0]
        m = n - length + 1
        Q = eps2.shape[0]
        blk = probe_block_for(n, Q)
        nb = -(-n // blk)
        k = min(top_k, blk)
        S = bstack.shape[0]
        if bstack.shape[1] < nb * blk + length:
            raise ValueError(
                f"bucket stack underpadded for blocked probe: have "
                f"{bstack.shape[1]} columns, need {nb * blk + length} "
                f"(pad with probe_stack_extra)")

        def probe_one(bwin, sg, c):
            if norm:
                return _dense_probe_norm(bwin, sg, unit, icfg.d, blk, slack,
                                         c[0], c[1], c[2], c[3], length)
            return _dense_probe(bwin, sg, unit, icfg.d, blk, slack)

        def body(b, carry):
            counts, best_s, best_i = carry
            p0 = b * blk
            bwin = jax.lax.dynamic_slice(bstack, (0, p0), (S, blk + length))
            eps_acc = jax.vmap(lambda sg, c: probe_one(bwin, sg, c))(segs, cons)
            pos = p0 + jnp.arange(blk, dtype=jnp.int32)
            mask = (eps_acc <= eps2[:, None]) & (pos[None, :] < m)
            counts = counts + jnp.sum(mask.astype(jnp.int32), axis=1)
            scores = jnp.where(mask, eps_acc, jnp.inf)
            loc_s, loc_j = jax.lax.top_k(-scores, k)        # k smallest bounds
            loc_i = p0 + loc_j.astype(jnp.int32)
            sel_s, sel_j = jax.lax.top_k(
                jnp.concatenate([-best_s, loc_s], axis=1), k)
            best_i = jnp.take_along_axis(
                jnp.concatenate([best_i, loc_i], axis=1), sel_j, axis=1)
            return counts, -sel_s, best_i

        carry0 = (jnp.zeros(Q, jnp.int32),
                  jnp.full((Q, k), jnp.inf, jnp.float32),
                  jnp.zeros((Q, k), jnp.int32))
        counts, _, best_i = jax.lax.fori_loop(0, nb, body, carry0)
        return counts, jnp.minimum(best_i, m - 1)

    return jax.jit(step)


# Padding fill for the on-the-fly probe's data copy: window means over the
# fill land in an astronomically distant key cell (bucket ~2e7, still int32),
# so padded positions prune themselves; they are also masked by pos < m.
FLY_FILL = np.float32(1e7)


def fly_pad_for(length: int, w_max: int) -> int:
    """Right padding the on-the-fly probe needs on its data copy: the maximum
    block size any batch can pick, plus the segment-shift and window halos
    (independent of n/Q so the padded copy serves every batch size)."""
    return PROBE_BLOCK_MAX + max(length, 8192) + w_max


def make_dense_probe_step_fly(icfg: IndexConfig, length: int,
                              cand_k: int = 1 << 20, norm: bool = False,
                              scales: Tuple[int, ...] | None = None):
    """Blocked dense phase 1 computing bucket ids ON THE FLY from the series.

    Unlike make_dense_probe_step_batched this needs NO precomputed bucket
    stack — each position block recomputes its (S, blk+L) bucket window from
    the f32 data via the doubling window-sum kernels (ops/sliding), so the
    device holds O(data) instead of O(S * n) (20 GB at n=1e9).

    Candidates are emitted as RUN-COMPRESSED INTERVALS via ordered compaction
    (cumsum + scatter of run starts/ends, with runs spanning block boundaries
    carried through the loop): dense candidate sets at large n have ~25-point
    gaps, so tens of millions of candidate offsets fit a 1M-run buffer.  The
    intervals come out position-sorted and disjoint — ready for phase 2.

    ``gap`` (traced i32 >= 1) makes the compaction GAP-TOLERANT: candidate
    runs separated by fewer than ``gap`` unmasked positions are coalesced
    into one interval.  Interior gap positions become
    over-coverage that the exact phase 2 rejects — sound by construction —
    while the run count drops enough that flood workloads (cNSM at n=1e8
    fragments into >8M runs/query at gap=1) stay inside the K-run buffer
    instead of falling back to host interval algebra.  Emitted left/right
    edges are always true candidate positions (no edge widening).

    Args: (data_padded f32[n + fly_pad_for(...)], segs DenseSegments (leading
    Q), eps2 f32[Q], cons f32[Q, 4], n_total i32, gap i32) ->
    (n_offsets i32[Q], n_runs i32[Q], run_left i32[Q, K], run_right
    i32[Q, K]); n_runs > K flags overflow (truncated output).
    """
    from ..ops.sliding import build_buckets

    scales = scales or tuple(icfg.scales)
    w_max = max(scales)
    unit = icfg.unit
    slack = np.float32(icfg.probe_guard)
    NEG = np.int32(-(1 << 30))
    POS = np.int32(1 << 30)

    def step(data_padded, segs: DenseSegments, eps2, cons, n_total, gap):
        Q = eps2.shape[0]
        npad = data_padded.shape[0]
        n_hi = npad - fly_pad_for(length, w_max)  # >= true n; bounds the loop
        blk = min(probe_block_for(npad, Q), PROBE_BLOCK_MAX)
        nb = -(-max(n_hi, 1) // blk)
        m = n_total - length + 1
        K = cand_k
        qrows = jnp.arange(Q)[:, None]
        # A whole empty block always separates runs (gap < blk assumed; the
        # engine clamps its retry schedule to blk // 2).
        gap = jnp.minimum(gap, jnp.int32(blk - 1))

        def probe_one(bwin, sg, c):
            if norm:
                return _dense_probe_norm(bwin, sg, unit, icfg.d, blk, slack,
                                         c[0], c[1], c[2], c[3], length)
            return _dense_probe(bwin, sg, unit, icfg.d, blk, slack)

        def body(b, carry):
            n_off, n_runs, n_ends, out_l, out_r, last_carry = carry
            p0 = b * blk
            need = blk + length + w_max
            piece = jax.lax.dynamic_slice(data_padded, (p0,), (need,))
            bk = build_buckets(piece, scales, icfg.pos_of_d)
            # every scale yields need - w + 1 >= blk + length + 1 ids: truncate
            bwin = jnp.stack([bk[w][: blk + length] for w in scales])
            eps_acc = jax.vmap(lambda sg, c: probe_one(bwin, sg, c))(segs, cons)
            pos = p0 + jnp.arange(blk, dtype=jnp.int32)
            mask = (eps_acc <= eps2[:, None]) & (pos[None, :] < m)

            # last masked position at-or-before each column (NEG when none),
            # seeded with the carried last masked position of earlier blocks
            posm = jnp.where(mask, pos[None, :], NEG)
            lastp = jax.lax.cummax(posm, axis=1)
            lastp_prev = jnp.concatenate(
                [last_carry[:, None], jnp.maximum(lastp[:, :-1],
                                                  last_carry[:, None])], axis=1)
            # next masked position at-or-after each column (POS when none)
            posM = jnp.where(mask, pos[None, :], POS)
            nextp = jax.lax.cummin(posM, axis=1, reverse=True)
            nextp_next = jnp.concatenate(
                [nextp[:, 1:], jnp.full((Q, 1), POS, jnp.int32)], axis=1)

            # Run starts: masked with the previous masked position > gap back.
            starts_m = mask & (pos[None, :] - lastp_prev > gap)
            # Run ends resolved inside this block: the next masked position is
            # known AND > gap ahead.  The block's last masked position always
            # defers to the carry (its successor may be in a later block).
            ends_m = mask & (nextp_next - pos[None, :] > gap) & (nextp_next < POS)
            # The carried run closes at last_carry when this block proves the
            # gap: first masked position (or block end, if empty) > gap away.
            first_pos = jnp.minimum(nextp[:, 0], p0 + blk)
            close_prev = (last_carry > NEG) & (first_pos - last_carry > gap)

            loc_s = jnp.cumsum(starts_m.astype(jnp.int32), axis=1) - 1
            dest_s = jnp.where(starts_m, n_runs[:, None] + loc_s, K)
            out_l = out_l.at[qrows, jnp.minimum(dest_s, K)].set(
                jnp.broadcast_to(pos[None, :], (Q, blk)), mode="drop")

            e_base = n_ends + close_prev.astype(jnp.int32)
            out_r = out_r.at[jnp.arange(Q), jnp.minimum(
                jnp.where(close_prev, n_ends, K), K)].set(last_carry,
                                                          mode="drop")
            loc_e = jnp.cumsum(ends_m.astype(jnp.int32), axis=1) - 1
            dest_e = jnp.where(ends_m, e_base[:, None] + loc_e, K)
            out_r = out_r.at[qrows, jnp.minimum(dest_e, K)].set(
                jnp.broadcast_to(pos[None, :], (Q, blk)), mode="drop")

            n_off = n_off + jnp.sum(mask.astype(jnp.int32), axis=1)
            n_runs = n_runs + jnp.sum(starts_m.astype(jnp.int32), axis=1)
            n_ends = e_base + jnp.sum(ends_m.astype(jnp.int32), axis=1)
            # New carry: last masked position in this block; if none, the old
            # carry survives only when it was not just closed.
            last_new = jnp.where(
                lastp[:, -1] > NEG, lastp[:, -1],
                jnp.where(close_prev, NEG, last_carry))
            return n_off, n_runs, n_ends, out_l, out_r, last_new

        carry0 = (jnp.zeros(Q, jnp.int32), jnp.zeros(Q, jnp.int32),
                  jnp.zeros(Q, jnp.int32),
                  jnp.zeros((Q, K + 1), jnp.int32),
                  jnp.zeros((Q, K + 1), jnp.int32),
                  jnp.full(Q, NEG, jnp.int32))
        n_off, n_runs, n_ends, out_l, out_r, last_carry = jax.lax.fori_loop(
            0, nb, body, carry0)
        # Epilogue: a run still open after the last block ends at the last
        # masked position seen.
        out_r = out_r.at[jnp.arange(Q), jnp.minimum(
            jnp.where(last_carry > NEG, n_ends, K), K)].set(last_carry,
                                                            mode="drop")
        return n_off, n_runs, out_l[:, :K], out_r[:, :K]

    return jax.jit(step, static_argnames=())


def make_dense_probe_step_flags(icfg: IndexConfig, length: int,
                                flag_block: int = 256, norm: bool = False,
                                scales: Tuple[int, ...] | None = None):
    """Flood-mode dense phase 1 emitting PER-BLOCK CANDIDATE FLAGS.

    Same on-the-fly bucket probe as make_dense_probe_step_fly, but instead of
    run-compressing the candidate mask (prefix scans + scattered writes into a
    K-run buffer that a 21M-candidate flood overflows), each ``flag_block``-wide
    position block reduces to one boolean: "does this block hold at least one
    candidate?".  The output is a fixed-size (Q, n/flag_block) flag matrix
    written with dense dynamic_update_slice stores — no scatter, no overflow,
    one pass regardless of candidate density.

    Flags over-cover candidates to flag_block granularity; the exact phase 2
    rejects the interior positions (sound by construction), and its region
    path gap-coalesces candidate intervals to region width anyway, so at flood
    density the verified coverage is essentially unchanged.  The engine routes
    only flood-predicted plans (or run-probe overflows) here; selective plans
    keep the exact-edged run probe.

    Args: (data_padded f32[n + fly_pad_for(...)], segs DenseSegments (leading
    Q), eps2 f32[Q], cons f32[Q, 4], n_total i32) ->
    (n_offsets i32[Q] exact candidate counts, flags bool[Q, NF]) where
    NF = (probe blocks) * (block/flag_block) and flag j covers positions
    [j*flag_block, (j+1)*flag_block).  The probe block is floor-aligned to a
    flag_block multiple so the global flag grid stays aligned (flag_block
    must be a power of two <= PROBE_BLOCK_MIN).
    """
    from ..ops.sliding import build_buckets

    scales = scales or tuple(icfg.scales)
    w_max = max(scales)
    unit = icfg.unit
    slack = np.float32(icfg.probe_guard)
    F = int(flag_block)

    def step(data_padded, segs: DenseSegments, eps2, cons, n_total):
        Q = eps2.shape[0]
        npad = data_padded.shape[0]
        n_hi = npad - fly_pad_for(length, w_max)  # >= true n; bounds the loop
        if F > PROBE_BLOCK_MIN or F & (F - 1):
            raise ValueError(
                f"flag_block must be a power of two <= {PROBE_BLOCK_MIN}, "
                f"got {F}")
        blk = min(probe_block_for(npad, Q), PROBE_BLOCK_MAX) // F * F
        nf_blk = blk // F
        nb = -(-max(n_hi, 1) // blk)
        m = n_total - length + 1

        def probe_one(bwin, sg, c):
            if norm:
                return _dense_probe_norm(bwin, sg, unit, icfg.d, blk, slack,
                                         c[0], c[1], c[2], c[3], length)
            return _dense_probe(bwin, sg, unit, icfg.d, blk, slack)

        def body(b, carry):
            n_off, flags = carry
            p0 = b * blk
            need = blk + length + w_max
            piece = jax.lax.dynamic_slice(data_padded, (p0,), (need,))
            bk = build_buckets(piece, scales, icfg.pos_of_d)
            bwin = jnp.stack([bk[w][: blk + length] for w in scales])
            eps_acc = jax.vmap(lambda sg, c: probe_one(bwin, sg, c))(segs, cons)
            pos = p0 + jnp.arange(blk, dtype=jnp.int32)
            mask = (eps_acc <= eps2[:, None]) & (pos[None, :] < m)
            n_off = n_off + jnp.sum(mask.astype(jnp.int32), axis=1)
            f = jnp.any(mask.reshape(Q, nf_blk, F), axis=2)
            flags = jax.lax.dynamic_update_slice(flags, f, (0, b * nf_blk))
            return n_off, flags

        carry0 = (jnp.zeros(Q, jnp.int32),
                  jnp.zeros((Q, nb * nf_blk), jnp.bool_))
        n_off, flags = jax.lax.fori_loop(0, nb, body, carry0)
        return n_off, flags

    return jax.jit(step, static_argnames=())


def make_cons_stats_prog(length: int):
    """One-time builder for the cached constraint-stat stack: f32[3, npad]
    rows (window sum, window sum-of-squares, window max|x|) at width
    ``length`` over the padded series.  Positions whose window crosses the
    fly padding produce garbage rows — they are masked by pos < m in the
    consumer.  ~12 bytes/point of HBM; engines cache it per (data, L) so the
    flag probe's constraint AND reads precomputed rows instead of recomputing
    the ~50 doubling passes per batch (measured ~1.5 s/batch at n=1e8)."""
    import functools

    @functools.partial(jax.jit)
    def prog(data_padded):
        from ..ops.sliding import sliding_window_stats_fwd
        npad = data_padded.shape[0]
        s1, s2, lo, hi = sliding_window_stats_fwd(data_padded, length)
        amax = jnp.maximum(jnp.abs(lo), jnp.abs(hi))
        pad = npad - s1.shape[0]
        out = jnp.stack([jnp.pad(s1, (0, pad)), jnp.pad(s2, (0, pad)),
                         jnp.pad(amax, (0, pad))])
        return out

    return prog


def make_bucket_stack_prog(icfg: IndexConfig,
                           scales: Tuple[int, ...] | None = None):
    """One-time builder for the cached bucket-window stack: i32[S, npad]
    per-scale bucket ids over the padded series.  The stack is QUERY-
    INDEPENDENT — recomputing it inside every probe pass (sliding sums +
    bucketize per block, ~24 blocks at n=1e8) is pure repeated work once a
    series serves more than one batch.  4*S bytes/point of HBM; positions in
    the fly padding bucketize the FLY_FILL sentinel (prune-everything), same
    as the per-block recompute."""
    import functools

    scales = tuple(scales or icfg.scales)

    @functools.partial(jax.jit)
    def prog(data_padded):
        from ..ops.sliding import build_buckets
        npad = data_padded.shape[0]
        bk = build_buckets(data_padded, scales, icfg.pos_of_d)
        return jnp.stack([jnp.pad(bk[w], (0, npad - bk[w].shape[0]),
                                  constant_values=np.int32(2**30))
                          for w in scales])

    return prog


def make_dense_probe_step_flags_pallas(icfg: IndexConfig, length: int,
                                       norm: bool = False,
                                       scales: Tuple[int, ...] | None = None,
                                       interpret: bool = False,
                                       cached_stats: bool = False,
                                       cached_buckets: bool = False):
    """Flood-mode dense phase 1 via the FUSED probe kernel.

    Identical contract to ``make_dense_probe_step_flags`` (same bucket
    windows, same probe math per ops/probe_pallas.py's module doc), but the
    per-position bound accumulation runs as one Pallas/Triton kernel that
    reads each segment's window straight from the bucket stack and keeps the
    accumulators in registers — no per-segment device-memory round trips.
    Flags come out at FLAG=128-position granularity instead of the XLA
    step's 256.

    For the cNSM variant (norm=True) each block additionally evaluates the
    EXACT alpha/beta constraint test per position — width-L window mean/sigma
    from log-depth sliding sums, widened by a per-window rounding bound
    scaled by the window's own max-|x| (ops/sliding.sliding_window_stats_fwd)
    so a true answer can never be dismissed — and ANDs it into the flag
    bitmap.  At flood shapes this is the filter that makes the reference's
    scalar phase 2 fast (NormQueryEngine.java:484-527's running-stats
    constraint test), applied wholesale at memory bandwidth.  Counts stay
    PROBE-only (the exact phase-1 bound's candidate count, comparable across
    routes).

    Args: (data_padded f32[n + fly_pad_for(...)], segs DenseSegments (leading
    Q), eps2 f32[Q], cons f32[Q, 4], n_total i32, stats3 / bstack3 when
    cached) -> (n_offsets i32[Q] exact candidate counts, flags bool[Q, NF])
    with flag j covering positions [j*128, (j+1)*128).
    """
    from ..ops.probe_pallas import FLAG, TILE, probe_flags_tiles
    from ..ops.sliding import build_buckets, sliding_window_stats_fwd

    scales = scales or tuple(icfg.scales)
    w_max = max(scales)
    unit = icfg.unit
    inv_l = np.float32(1.0 / length)
    # f32 rounding-bound multipliers for the constraint guard: balanced-tree
    # window sums err below eps32 * (log2(L) + 2) * L * max|x|; factor-4
    # safety covers the f32 data rounding and the mean/var compositions.
    KM = np.float32(4 * (np.log2(max(length, 2)) + 2) * np.finfo(np.float32).eps)
    KV = np.float32(8 * (np.log2(max(length, 2)) + 2) * np.finfo(np.float32).eps)

    def step(data_padded, segs: DenseSegments, eps2, cons, n_total,
             stats3=None, bstack3=None):
        Q = eps2.shape[0]
        npad = data_padded.shape[0]
        n_hi = npad - fly_pad_for(length, w_max)  # >= true n; bounds the loop
        # Block size: multiple of TILE, capped at PROBE_BLOCK_MAX (the
        # fly_pad_for padding keeps every block's window reads in bounds).
        blk = min(PROBE_BLOCK_MAX, -(-max(n_hi, 1) // TILE) * TILE)
        NT = blk // TILE
        nf_blk = blk // FLAG
        nb = -(-max(n_hi, 1) // blk)
        m = n_total - length + 1
        ivalid = segs.valid.astype(jnp.int32)

        def cons_flags(piece, p0, pos_ok):
            """bool[Q, blk//FLAG]: block holds >= 1 position passing the
            guarded alpha/beta window constraint (norm only)."""
            if cached_stats:
                st = jax.lax.dynamic_slice(stats3, (0, p0), (3, blk))
                s1, s2, amax = st[0], st[1], st[2]
            else:
                s1, s2, lo, hi = sliding_window_stats_fwd(
                    piece[: blk + length], length)
                s1, s2 = s1[:blk], s2[:blk]
                amax = jnp.maximum(jnp.abs(lo[:blk]), jnp.abs(hi[:blk]))
            mean = s1 * inv_l
            var = jnp.maximum(s2 * inv_l - mean * mean, 0.0)
            m_tol = KM * amax + np.float32(1e-7)
            v_tol = KV * amax * amax + 2 * amax * m_tol + np.float32(1e-7)
            alpha = cons[:, 0][:, None]
            beta = cons[:, 1][:, None]
            mu_q = cons[:, 2][:, None]
            sd_q = cons[:, 3][:, None]
            ok = ((jnp.abs(mean[None, :] - mu_q) <= beta + m_tol[None, :])
                  & (var[None, :] <= (alpha * sd_q) ** 2 + v_tol[None, :])
                  & (var[None, :] >= (sd_q / alpha) ** 2 - v_tol[None, :]))
            ok = ok & pos_ok[None, :]
            return jnp.any(ok.reshape(Q, nf_blk, FLAG), axis=2)

        def body(b, carry):
            n_off, flags = carry
            p0 = b * blk
            piece = None
            if not cached_buckets or (norm and not cached_stats):
                piece = jax.lax.dynamic_slice(data_padded, (p0,),
                                              (blk + length + w_max,))
            if cached_buckets:
                # Query-independent bucket windows precomputed once per
                # series (make_bucket_stack_prog): the kernel reads the
                # stack in place.
                stack, col0 = bstack3, p0
            else:
                bk = build_buckets(piece, scales, icfg.pos_of_d)
                stack = jnp.stack([bk[w][: blk + length] for w in scales])
                col0 = jnp.int32(0)
            iscal = jnp.stack([col0, p0, m]).astype(jnp.int32)
            f, counts = probe_flags_tiles(
                stack, segs.scale_idx, segs.order, ivalid,
                segs.mean_lo, segs.mean_hi, segs.width, eps2, cons, iscal,
                n_tiles=NT, length=length, unit=unit, d=icfg.d,
                slack=float(icfg.probe_guard), norm=norm,
                interpret=interpret)
            if norm:
                pos_ok = p0 + jnp.arange(blk, dtype=jnp.int32) < m
                f = f & cons_flags(piece, p0, pos_ok)
            flags = jax.lax.dynamic_update_slice(flags, f, (0, b * nf_blk))
            return n_off + counts, flags

        carry0 = (jnp.zeros(Q, jnp.int32),
                  jnp.zeros((Q, nb * nf_blk), jnp.bool_))
        return jax.lax.fori_loop(0, nb, body, carry0)

    return jax.jit(step, static_argnames=())


def make_dense_query_step_norm_batched(icfg: IndexConfig, length: int,
                                       top_k: int = 2048,
                                       scales: Tuple[int, ...] | None = None):
    """Single-device, multi-query cNSM step: dense z-space probe + std filter on
    device, then guarded z-norm verification of each query's top-K candidates.

    Args: (data f32[n], bstack i32[S, n+pad], queries_hat f32[Q, L] z-normalized,
    segs DenseSegments (leading Q), eps2 f32[Q], cons f32[Q, 4] rows of
    (alpha, beta, mu_q, sd_q)) -> (counts i32[Q], offsets i32[Q, K], d2 f32[Q, K],
    mean f32[Q, K], std f32[Q, K]).
    """
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    slack = np.float32(icfg.probe_guard)

    def step(data, bstack, queries_hat, segs: DenseSegments, eps2, cons):
        n = data.shape[0]
        m = n - length + 1
        k = min(top_k, n)  # oversized K degrades gracefully

        def probe_one(sg, c):
            return _dense_probe_norm(bstack, sg, unit, icfg.d, n, slack,
                                     c[0], c[1], c[2], c[3], length)

        eps_acc = jax.vmap(probe_one)(segs, cons)          # (Q, n)
        pos = jnp.arange(n, dtype=jnp.int32)
        mask = (eps_acc <= eps2[:, None]) & (pos[None, :] < m)
        counts = jnp.sum(mask.astype(jnp.int32), axis=1)
        scores = jnp.where(mask, -eps_acc, -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        idx = jnp.minimum(idx.astype(jnp.int32), m - 1)

        inv_l = np.float32(1.0 / length)

        def verify_one(qh, idx_row):
            x = jax.vmap(lambda o: jax.lax.dynamic_slice(data, (o,), (length,)))(idx_row)
            mean = jnp.sum(x, axis=1) * inv_l
            centered = x - mean[:, None]
            var = jnp.sum(centered * centered, axis=1) * inv_l
            std = jnp.sqrt(var)
            safe = jnp.where(std > 0, std, 1.0)
            zdiff = centered / safe[:, None] - qh[None, :]
            d2 = jnp.sum(zdiff * zdiff, axis=1)
            return jnp.where(std > 0, d2, jnp.inf), mean, std

        d2, mean, std = jax.vmap(verify_one)(queries_hat, idx)
        live = jnp.arange(k)[None, :] < jnp.minimum(counts, k)[:, None]
        d2 = jnp.where(live, d2, jnp.inf)
        return counts, idx, d2, mean, std

    return jax.jit(step)


def make_sharded_query_step_batched(mesh: Mesh, icfg: IndexConfig, length: int,
                                    top_k: int = 256,
                                    scales: Tuple[int, ...] | None = None):
    """Mesh-sharded multi-query step: offset-range sharding x query batching.

    Each shard evaluates the dense probe for EVERY query over its own positions
    (vmap over the query dim), verifies its local top-K per query, and emits
    per-shard results; concatenating across shards is the candidate all-gather.
    """
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    halo = length
    slack = np.float32(icfg.probe_guard)
    n_sh = mesh.devices.size

    def per_shard(data, bstack, queries, segs: DenseSegments, eps2, n_total):
        per = data.shape[0]
        k = min(top_k, per)  # oversized K degrades gracefully
        shard_id = jax.lax.axis_index(AXIS)
        src_dst = [(i, (i - 1) % n_sh) for i in range(n_sh)]
        data_h = jnp.concatenate([data, jax.lax.ppermute(data[:halo], AXIS, src_dst)])
        b_h = jnp.concatenate(
            [bstack, jax.lax.ppermute(bstack[:, :halo], AXIS, src_dst)], axis=1)
        eps_acc = jax.vmap(
            lambda sg: _dense_probe(b_h, sg, unit, icfg.d, per, slack))(segs)
        gpos = shard_id * per + jnp.arange(per, dtype=jnp.int32)
        mask = (eps_acc <= eps2[:, None]) & (gpos[None, :] < n_total - length + 1)
        counts = jnp.sum(mask.astype(jnp.int32), axis=1)
        scores = jnp.where(mask, -eps_acc, -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        idx = idx.astype(jnp.int32)

        def one(q_row, idx_row):
            x = jax.vmap(lambda o: jax.lax.dynamic_slice(data_h, (o,), (length,)))(idx_row)
            diff = x - q_row[None, :]
            return jnp.sum(diff * diff, axis=1)

        d2 = jax.vmap(one)(queries, idx)
        live = jnp.arange(k)[None, :] < jnp.minimum(counts, k)[:, None]
        d2 = jnp.where(live, d2, jnp.inf)
        totals = jax.lax.psum(counts, AXIS)
        return totals, (shard_id * per + idx)[None], d2[None]

    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(AXIS), P(None, AXIS), P(), P(), P(), P()),
        out_specs=(P(), P(AXIS), P(AXIS)))
    return jax.jit(fn)


def make_sharded_query_step(mesh: Mesh, icfg: IndexConfig, length: int,
                            top_k: int = 1024,
                            scales: Tuple[int, ...] | None = None):
    """Mesh-sharded jittable query step (SPMD over offset ranges).

    data/bstack are sharded along the offset axis; query/segments/eps are
    replicated.  Each shard probes its own positions, pulls a ``length``-point
    right halo for window gathers, and emits its local top-K candidates;
    outputs are sharded so the concatenation is the candidate all-gather.

    Counts are returned PER SHARD (i32[n_sh]) — like the batched variants — so a
    single shard overflowing its ``top_k`` is detectable by the caller
    (``counts[i] > top_k`` means shard i truncated).  Sum for the global total.
    """
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    halo = length  # covers both the window gather (L) and segment shifts (< L)
    slack = np.float32(icfg.probe_guard)
    n_sh = mesh.devices.size

    def per_shard(data, bstack, query, segs: DenseSegments, eps2, n_total):
        per = data.shape[0]
        k = min(top_k, per)  # oversized K degrades gracefully
        shard_id = jax.lax.axis_index(AXIS)
        src_dst = [(i, (i - 1) % n_sh) for i in range(n_sh)]
        data_h = jnp.concatenate([data, jax.lax.ppermute(data[:halo], AXIS, src_dst)])
        b_h = jnp.concatenate(
            [bstack, jax.lax.ppermute(bstack[:, :halo], AXIS, src_dst)], axis=1)
        eps_acc = _dense_probe(b_h, segs, unit, icfg.d, per, slack)
        gpos = shard_id * per + jnp.arange(per, dtype=jnp.int32)
        mask = (eps_acc <= eps2) & (gpos < n_total - length + 1)
        count = jnp.sum(mask.astype(jnp.int32))
        (idx,) = jnp.nonzero(mask, size=k, fill_value=0)
        x = data_h[idx[:, None] + jnp.arange(length, dtype=jnp.int32)[None, :]]
        diff = x - query[None, :]
        d2 = jnp.sum(diff * diff, axis=1)
        live = jnp.arange(k) < count
        d2 = jnp.where(live, d2, jnp.inf)
        return count[None], (shard_id * per + idx)[None, :], d2[None, :]

    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(AXIS), P(None, AXIS), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)))
    return jax.jit(fn)


def run_sharded_step_with_recovery(factory, inputs, *, top_k: int, k_cap: int,
                                   counts_pos: int = 0, growth: int = 4,
                                   host_fallback=None):
    """Run a sharded query step with the documented top-K overflow recovery.

    Every ``make_sharded_query_step*`` variant returns per-shard candidate
    counts as ``outputs[counts_pos]`` (i32[n_sh] or i32[n_sh, Q]); a count
    above the step's static ``top_k`` means that shard TRUNCATED its local
    candidate list and the concatenated answer set may be incomplete.  The
    recovery policy:

      1. run the step at ``top_k``;
      2. on overflow, rebuild via ``factory(new_k)`` with ``new_k = top_k *
         growth`` (capped at ``k_cap``, normally the per-shard position count,
         at which truncation is impossible) and re-run;
      3. if even ``k_cap`` overflows (cannot happen when k_cap >= per-shard
         positions) call ``host_fallback()`` when given — its return value is
         passed through verbatim with used_k = 0 — else raise ``OverflowError``.

    ``factory``: ``top_k -> step`` (e.g. ``lambda k: make_sharded_query_step(
    mesh, icfg, L, top_k=k)``).  Returns ``(outputs, used_top_k)``.  Step
    rebuilds recompile; recovery is the exceptional path — size the initial K
    from the planner's candidate estimate to make overflow rare.
    """
    k = int(top_k)
    while True:
        step = factory(k)
        out = step(*inputs)
        counts = np.asarray(out[counts_pos])
        if counts.size == 0 or int(counts.max()) <= k:
            return out, k
        if k >= k_cap:
            if host_fallback is not None:
                return host_fallback(), 0
            raise OverflowError(
                f"sharded step overflowed top_k={k} at the cap k_cap={k_cap} "
                f"(max per-shard count {int(counts.max())}) and no "
                f"host_fallback was provided")
        k = min(k * growth, int(k_cap))


def make_sharded_query_step_norm_dtw_batched(mesh: Mesh, icfg: IndexConfig,
                                             length: int, rho: int,
                                             top_k: int = 256,
                                             scales: Tuple[int, ...] | None = None):
    """Mesh-sharded multi-query cNSM-DTW step (SPMD over offset ranges).

    The fourth sharded engine variant (reference NormQueryEngineDtw.java:44):
    phase 1 composes the z-space alpha/beta probe (``_dense_probe_norm``) with
    ENVELOPE segments — each segment's [mean_lo, mean_hi] are Sakoe-Chiba
    envelope unit sums from the cNSM-DTW planner (engine/norm_dtw.py
    ``_plan_inputs``), so the accumulated z-space bound lower-bounds
    z-normalized banded DTW under the constraints.  Phase 2 z-normalizes each
    shard's local top-K windows, applies the alpha/beta constraint test
    (widened by a float32 tolerance so borderline offsets survive for host
    recheck — no false dismissals), and runs the banded prefix-scan DP against
    the z-normalized query (NormQueryEngineDtw.java:538-601's cascade, with
    the LB stages subsumed by the probe bound at this candidate scale).

    Args: (data f32[n] sharded, bstack i32[S, n+pad] sharded on axis 1,
    queries_hat f32[Q, L] z-normalized replicated, segs DenseSegments with
    leading Q, eps2 f32[Q], cons f32[Q, 4] rows (alpha, beta, mu_q, sd_q),
    n_total i32) -> (counts i32[n_sh, Q] per shard (top-K overflow detection —
    see run_sharded_step_with_recovery), offsets i32[n_sh, Q, K] global,
    d2 f32[n_sh, Q, K] (inf where the constraints fail), mean f32[n_sh, Q, K],
    std f32[n_sh, Q, K]).
    """
    from ..ops.dtw import dtw_banded_batch
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    halo = length
    slack = np.float32(icfg.probe_guard)
    n_sh = mesh.devices.size
    inv_l = np.float32(1.0 / length)

    def per_shard(data, bstack, queries_hat, segs: DenseSegments, eps2, cons,
                  n_total):
        per = data.shape[0]
        k = min(top_k, per)  # oversized K degrades gracefully
        shard_id = jax.lax.axis_index(AXIS)
        src_dst = [(i, (i - 1) % n_sh) for i in range(n_sh)]
        data_h = jnp.concatenate([data, jax.lax.ppermute(data[:halo], AXIS, src_dst)])
        b_h = jnp.concatenate(
            [bstack, jax.lax.ppermute(bstack[:, :halo], AXIS, src_dst)], axis=1)

        def probe_one(sg, c):
            return _dense_probe_norm(b_h, sg, unit, icfg.d, per, slack,
                                     c[0], c[1], c[2], c[3], length)

        eps_acc = jax.vmap(probe_one)(segs, cons)          # (Q, per)
        gpos = shard_id * per + jnp.arange(per, dtype=jnp.int32)
        mask = (eps_acc <= eps2[:, None]) & (gpos[None, :] < n_total - length + 1)
        counts = jnp.sum(mask.astype(jnp.int32), axis=1)
        scores = jnp.where(mask, -eps_acc, -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        idx = idx.astype(jnp.int32)

        def verify_one(qh, idx_row, c):
            alpha, beta, mu_q, sd_q = c[0], c[1], c[2], c[3]
            tol = np.float32(1e-3) * (1.0 + jnp.abs(mu_q) + sd_q)
            x = jax.vmap(lambda o: jax.lax.dynamic_slice(data_h, (o,), (length,)))(idx_row)
            mean = jnp.sum(x, axis=1) * inv_l
            centered = x - mean[:, None]
            var = jnp.sum(centered * centered, axis=1) * inv_l
            std = jnp.sqrt(var)
            safe = jnp.where(std > 0, std, 1.0)
            ok = ((jnp.abs(mean - mu_q) <= beta + tol)
                  & (std <= alpha * sd_q + tol)
                  & (std >= sd_q / alpha - tol)
                  & (std > 0))
            z = centered / safe[:, None]
            d2 = dtw_banded_batch(z, qh, rho)
            return jnp.where(ok, d2, jnp.inf), mean, std

        d2, mean, std = jax.vmap(verify_one)(queries_hat, idx, cons)
        live = jnp.arange(k)[None, :] < jnp.minimum(counts, k)[:, None]
        d2 = jnp.where(live, d2, jnp.inf)
        return (counts[None], (shard_id * per + idx)[None], d2[None],
                mean[None], std[None])

    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(AXIS), P(None, AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)))
    return jax.jit(fn)


def make_sharded_query_step_norm_batched(mesh: Mesh, icfg: IndexConfig,
                                         length: int, top_k: int = 256,
                                         scales: Tuple[int, ...] | None = None):
    """Mesh-sharded multi-query cNSM step (SPMD over offset ranges).

    The z-space probe (engine/norm_ed.py's phase-1 bound, elementwise form) and
    the derived-sigma filter run per shard over the shard's own positions, with
    a ``length``-point right halo pulled from the next shard; each shard then z-normalizes
    and verifies its local top-K per query.  Outputs are sharded along the
    device axis so concatenation is the candidate all-gather
    (SURVEY.md section 2.6; constraints per CsvTester.java:69-114).

    Args: (data f32[n] sharded, bstack i32[S, n+pad] sharded on axis 1,
    queries_hat f32[Q, L] z-normalized replicated, segs DenseSegments with
    leading Q, eps2 f32[Q], cons f32[Q, 4] rows (alpha, beta, mu_q, sd_q),
    n_total i32) -> (counts i32[n_sh, Q] per shard (detects top-K
    overflow), offsets i32[n_sh, Q, K] global,
    d2 f32[n_sh, Q, K], mean f32[n_sh, Q, K], std f32[n_sh, Q, K]).
    """
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    halo = length
    slack = np.float32(icfg.probe_guard)
    n_sh = mesh.devices.size
    inv_l = np.float32(1.0 / length)

    def per_shard(data, bstack, queries_hat, segs: DenseSegments, eps2, cons,
                  n_total):
        per = data.shape[0]
        k = min(top_k, per)  # oversized K degrades gracefully
        shard_id = jax.lax.axis_index(AXIS)
        src_dst = [(i, (i - 1) % n_sh) for i in range(n_sh)]
        data_h = jnp.concatenate([data, jax.lax.ppermute(data[:halo], AXIS, src_dst)])
        b_h = jnp.concatenate(
            [bstack, jax.lax.ppermute(bstack[:, :halo], AXIS, src_dst)], axis=1)

        def probe_one(sg, c):
            return _dense_probe_norm(b_h, sg, unit, icfg.d, per, slack,
                                     c[0], c[1], c[2], c[3], length)

        eps_acc = jax.vmap(probe_one)(segs, cons)          # (Q, per)
        gpos = shard_id * per + jnp.arange(per, dtype=jnp.int32)
        mask = (eps_acc <= eps2[:, None]) & (gpos[None, :] < n_total - length + 1)
        counts = jnp.sum(mask.astype(jnp.int32), axis=1)
        scores = jnp.where(mask, -eps_acc, -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        idx = idx.astype(jnp.int32)

        def verify_one(qh, idx_row):
            x = jax.vmap(lambda o: jax.lax.dynamic_slice(data_h, (o,), (length,)))(idx_row)
            mean = jnp.sum(x, axis=1) * inv_l
            centered = x - mean[:, None]
            var = jnp.sum(centered * centered, axis=1) * inv_l
            std = jnp.sqrt(var)
            safe = jnp.where(std > 0, std, 1.0)
            zdiff = centered / safe[:, None] - qh[None, :]
            d2 = jnp.sum(zdiff * zdiff, axis=1)
            return jnp.where(std > 0, d2, jnp.inf), mean, std

        d2, mean, std = jax.vmap(verify_one)(queries_hat, idx)
        live = jnp.arange(k)[None, :] < jnp.minimum(counts, k)[:, None]
        d2 = jnp.where(live, d2, jnp.inf)
        return (counts[None], (shard_id * per + idx)[None], d2[None],
                mean[None], std[None])

    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(AXIS), P(None, AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)))
    return jax.jit(fn)


def make_sharded_query_step_dtw_batched(mesh: Mesh, icfg: IndexConfig,
                                        length: int, rho: int, top_k: int = 256,
                                        scales: Tuple[int, ...] | None = None):
    """Mesh-sharded multi-query RSM-DTW step (SPMD over offset ranges).

    Phase 1 is the same dense probe as the ED step but driven by *envelope*
    segments (engine/rsm_dtw.py's plan: per-segment [mean_lo, mean_hi] come from
    the Sakoe-Chiba envelope sums, so the accumulated bound lower-bounds banded
    DTW — DtwQueryEngine.java:103-132's bound in elementwise form).  Each shard
    verifies its local top-K with the banded prefix-scan DP on device.

    Args mirror make_sharded_query_step_batched plus the static band ``rho``;
    queries are the raw (not normalized) query rows.  Counts are returned
    PER SHARD (i32[n_sh, Q]) so callers can detect per-shard top-K overflow
    (the envelope bound is weaker than the ED bound, so DTW candidate sets
    are larger at equal epsilon).
    """
    from ..ops.dtw import dtw_banded_batch
    scales = scales or tuple(icfg.scales)
    unit = icfg.unit
    halo = length
    slack = np.float32(icfg.probe_guard)
    n_sh = mesh.devices.size

    def per_shard(data, bstack, queries, segs: DenseSegments, eps2, n_total):
        per = data.shape[0]
        k = min(top_k, per)  # oversized K degrades gracefully
        shard_id = jax.lax.axis_index(AXIS)
        src_dst = [(i, (i - 1) % n_sh) for i in range(n_sh)]
        data_h = jnp.concatenate([data, jax.lax.ppermute(data[:halo], AXIS, src_dst)])
        b_h = jnp.concatenate(
            [bstack, jax.lax.ppermute(bstack[:, :halo], AXIS, src_dst)], axis=1)
        eps_acc = jax.vmap(
            lambda sg: _dense_probe(b_h, sg, unit, icfg.d, per, slack))(segs)
        gpos = shard_id * per + jnp.arange(per, dtype=jnp.int32)
        mask = (eps_acc <= eps2[:, None]) & (gpos[None, :] < n_total - length + 1)
        counts = jnp.sum(mask.astype(jnp.int32), axis=1)
        scores = jnp.where(mask, -eps_acc, -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        idx = idx.astype(jnp.int32)

        def one(q_row, idx_row):
            x = jax.vmap(lambda o: jax.lax.dynamic_slice(data_h, (o,), (length,)))(idx_row)
            return dtw_banded_batch(x, q_row, rho)

        d2 = jax.vmap(one)(queries, idx)
        live = jnp.arange(k)[None, :] < jnp.minimum(counts, k)[:, None]
        d2 = jnp.where(live, d2, jnp.inf)
        return counts[None], (shard_id * per + idx)[None], d2[None]

    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(AXIS), P(None, AXIS), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)))
    return jax.jit(fn)
