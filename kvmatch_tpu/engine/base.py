"""Shared engine machinery: two-phase query skeleton over the KV-index.

This is the accelerator shape of the reference's four engine classes
(QueryEngine.java:162-380 and siblings): a generic phase-1 loop over probe
segments with vectorized interval intersection, followed by a batched device
verification (phase 2) plus an exact float64 host confirmation of near-threshold
candidates — which makes the final answer set exact even though the heavy
distance work runs in float32 on the device.

Subclasses provide four hooks:
  _plan(query, ctx)          -> List[QuerySegment]
  _scan(segment, ctx)        -> interval set with payload columns
  _combine(pieces, a, b, ia, ib, ctx) -> filtered pieces (the CS x CS_i step)
  _verify(offsets, ctx)      -> (answer_offsets, distances)  [exact]
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import lru_cache as _functools_lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import IndexConfig, QueryConfig, DEFAULT_INDEX_CONFIG, DEFAULT_QUERY_CONFIG
from ..index.build import build_index_tpu
from ..index.structure import Index, IndexScale
from ..plan import QuerySegment
from ..utils import intervals as iv

logger = logging.getLogger("kvmatch_tpu")


@_functools_lru_cache(maxsize=None)
def _run_slice_prog(k: int):
    """Tiny jitted column slice used to bound the fly probe's run-buffer D2H
    (one cached executable per power-of-two slice width)."""
    import jax

    def prog(run_l, run_r):
        return run_l[:, :k], run_r[:, :k]

    return jax.jit(prog)


def dense_emit_for(platform: str) -> str:
    """Dense phase-1 emission for QueryConfig.dense_probe_emit='auto':
    ``'flags'`` (one fused flag-probe pass) on a GPU, where the run ladder's
    scatter compaction measured ~5x slower end to end (PERF.md); ``'runs'``
    (exact-edged run compaction with the overflow ladder) on the CPU, where
    scatters are cheap and exact edges keep phase 2 tight."""
    if platform == "gpu":
        return "flags"
    if platform == "cpu":
        return "runs"
    raise ValueError(f"no dense emission route for platform {platform!r}")


@dataclasses.dataclass
class QueryStats:
    """Per-query observability counters — the six StatisticInfo slots of the
    reference (QueryEngine.java:136-140, 365-371) plus extras."""
    t_total_ms: float = 0.0
    t_phase1_ms: float = 0.0
    t_phase2_ms: float = 0.0
    n_candidates: int = 0
    n_disjoint: int = 0
    n_answers: int = 0
    n_scans: int = 0
    n_joins: int = 0           # segments served by the fused join kernels
    n_segments_used: int = 0
    n_device_checked: int = 0
    n_host_rechecked: int = 0
    # Candidates verified ENTIRELY on host (exact f64, no device launch) by the
    # tiny-load fast path (QueryConfig.host_verify_max_points).
    n_host_checked: int = 0
    early_terminated: bool = False


@dataclasses.dataclass
class QueryResult:
    offsets: np.ndarray    # 0-based answer offsets, sorted by distance
    distances: np.ndarray  # exact float64 distances
    stats: QueryStats

    @property
    def found(self) -> bool:
        return self.offsets.size > 0

    def best(self) -> Optional[Tuple[int, float]]:
        if not self.found:
            return None
        return int(self.offsets[0]), float(self.distances[0])


@dataclasses.dataclass
class _Ctx:
    """Per-query context threaded through the hooks."""
    query: np.ndarray
    length: int
    epsilon: float
    eps2: float
    params: dict
    stats: QueryStats
    last_min_eps: float = 0.0
    processed_units: int = 0
    # Current candidate span (min left, max right) in the frame of the NEXT
    # segment to scan; lets _gather_rows use the position-sorted index view.
    span: tuple = None


class BaseEngine:
    """Common state: the series (f64 on host + f32 in device HBM) and the index."""

    payloads: Tuple[str, ...] = ("eps",)
    use_dtw_cost_model = False

    def __init__(self, data: np.ndarray, index: Optional[Index] = None,
                 icfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                 qcfg: QueryConfig = DEFAULT_QUERY_CONFIG,
                 device_data=None):
        import jax.numpy as jnp
        stream = isinstance(device_data, str) and device_data in ("stream",
                                                                  "host")
        # device_data="host": no device at all — phase 1 is host interval
        # algebra as in stream mode, and phase 2 must take the tiny-load host
        # f64 route (_host_verify_ok); larger candidate loads raise instead of
        # silently touching a device that may not exist.
        self.host_only = device_data == "host"
        data = np.asarray(data)
        if stream and data.dtype == np.float32:
            # Series larger than device HBM: keep the host copy f32 (an f64
            # shadow would double a 40 GB array); exact confirms promote the
            # f32 values per window — the same storage/math split as the
            # reference's float family (FloatTimeSeriesNode.java:28-66).
            self.data = np.ascontiguousarray(data)
        else:
            self.data = np.ascontiguousarray(np.asarray(data, np.float64))
        self.n = self.data.size
        self.icfg = icfg
        self.qcfg = qcfg
        if index is None and stream:
            raise ValueError("device_data='stream' requires a prebuilt index "
                             "(use index.streaming.StreamingIndexBuilder)")
        self.index = index if index is not None else build_index_tpu(self.data, icfg)
        if stream:
            # Streamed phase 2: the series stays on host; candidate regions
            # travel H2D per query batch (_verify_multi_streamed).
            self.data_dev = None
        else:
            self.data_dev = (device_data if device_data is not None
                             else jnp.asarray(self.data, jnp.float32))

    # ------------------------------------------------------------------ helpers
    def scale(self, w: int) -> IndexScale:
        return self.index[w]

    def data_envelope_dev(self, rho: int):
        """Global Sakoe-Chiba envelope of the series, device-resident, cached
        per band radius.  Consumed by the DTW LB cascade's data-side Keogh
        stage (ops/dtw.lb_stage_multi); computed once per (engine, rho) at HBM
        bandwidth via the log-depth sliding min/max."""
        import jax
        cache = getattr(self, "_env_dev_cache", None)
        if cache is None:
            cache = self._env_dev_cache = {}
        if rho not in cache:
            from ..ops.sliding import sliding_min_max
            lo, hi = jax.jit(sliding_min_max, static_argnums=1)(self.data_dev, rho)
            cache[rho] = (lo, hi)
        return cache[rho]

    def _row_bounds(self, sc: IndexScale, rows: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row mean range [key_i - slack, next_key + slack]; the slack widens the
        reference's [key, toUpper(key)] (QueryEngine.java:578-591) to absorb f32
        build-side bucket flips — sound: it can only weaken lower bounds."""
        slack = self.icfg.probe_guard
        keys = sc.keys
        lo = keys[rows] - slack
        hi = np.where(rows + 1 < keys.size,
                      keys[np.minimum(rows + 1, keys.size - 1)],
                      sc.mean_upper_bound) + slack
        return lo, hi

    # Scans below this interval count are served per-row (C k-way merge over
    # just the probed rows); a scale's GLOBAL position-sorted view — whose
    # build costs O(T log R) over ALL intervals (~10 s/scale at n=1e9) — is
    # materialized only when a single scan is huge (POS_VIEW_MIN) or when the
    # cumulative per-row-merge work on that scale has exceeded ~2x its
    # interval count (the build then amortizes across the workload).
    POS_VIEW_MIN = 1 << 22

    def _use_pos_view(self, sc: IndexScale, row_total: int) -> bool:
        if sc.has_pos_sorted or row_total > self.POS_VIEW_MIN:
            return True
        sc.gather_work += row_total
        return sc.gather_work > 2 * sc.num_intervals

    def _gather_rows(self, sc: IndexScale, rows: np.ndarray, ctx: "_Ctx" = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flatten the interval lists of the probed rows.  Returns
        (row_of_interval, left, right) with row_of_interval indexing into ``rows``.

        When the running candidate span (ctx.span) is narrower than the rows'
        total interval count, switch to the position-sorted view and materialize
        only intervals overlapping the span — intervals are <= maximum_diff wide,
        so the span selection is two binary searches on the left edges."""
        if rows.size == 0:
            e = np.empty(0, np.int64)
            return e, e, e
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        row_total = int(sc.row_ptr[i1] - sc.row_ptr[i0])
        if sc.has_pos_sorted:
            p_left, p_right, p_row = sc.pos_sorted()
            if ctx is not None and ctx.span is not None:
                lo, hi = ctx.span
                a = np.searchsorted(p_left, lo - self.icfg.maximum_diff, side="left")
                b = np.searchsorted(p_left, hi, side="right")
                if (b - a) < row_total:
                    sl_row = p_row[a:b]
                    keep = (sl_row >= i0) & (sl_row < i1) & (p_right[a:b] >= lo)
                    return (sl_row[keep] - i0, p_left[a:b][keep], p_right[a:b][keep])
            # A scale's intervals are mutually DISJOINT (every position has
            # exactly one bucket), so the position-sorted view filtered to the
            # probed rows is already sorted AND disjoint.  Use the linear
            # filter when the selected fraction is large.
            if row_total * 16 > p_row.size:
                keep = (p_row >= i0) & (p_row < i1)
                return p_row[keep] - i0, p_left[keep], p_right[keep]
        # Rows are internally position-sorted and mutually disjoint, so the
        # left-sorted union is a k-way merge — O(T log R) in C, no argsort.
        from .. import native
        mr = native.merge_rows(sc.row_ptr[rows], sc.row_ptr[rows + 1],
                               sc.left, sc.right)
        if mr is not None:
            return mr
        # Probed rows are contiguous (probe_rows returns a key range), so their
        # CSR interval block is one contiguous slice — no index arithmetic.
        counts = sc.row_ptr[rows + 1] - sc.row_ptr[rows]
        rep_rows = np.repeat(np.arange(rows.size), counts)
        sl = slice(int(sc.row_ptr[i0]), int(sc.row_ptr[i1]))
        left = sc.left[sl]
        # Invariant: every scan returns intervals sorted by left (and disjoint,
        # since a scale's intervals partition the positions).  The pos-sorted
        # paths above are sorted for free; this small-selection fallback sorts.
        order = np.argsort(left, kind="stable")
        return rep_rows[order], left[order], sc.right[sl][order]

    def _scan_fill(self, sc: IndexScale, rows: np.ndarray, ctx: "_Ctx",
                   row_payloads: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Emit the probed rows' intervals with per-row payload columns attached.

        Uses the fused native walk over the position-sorted view when available
        (native/interval_kernels.c scan_fill); otherwise expands payloads through
        the NumPy gather path.  Output is sorted by left and disjoint."""
        cols = tuple(row_payloads)
        if rows.size == 0:
            return iv.empty_set(cols)
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        row_total = int(sc.row_ptr[i1] - sc.row_ptr[i0])
        if self._use_pos_view(sc, row_total):
            p_left, p_right, p_row = sc.pos_sorted()
            a, b, min_right = 0, int(p_row.size), 0
            span_ok = False
            if ctx is not None and ctx.span is not None:
                lo, hi = ctx.span
                a2 = int(np.searchsorted(p_left, lo - self.icfg.maximum_diff, side="left"))
                b2 = int(np.searchsorted(p_left, hi, side="right"))
                if (b2 - a2) < row_total:
                    a, b, min_right = a2, b2, int(lo)
                    span_ok = True
            if span_ok or row_total * 16 > p_row.size:
                from .. import native
                res = native.scan_fill(p_left, p_right, p_row, a, b, i0, i1,
                                       min_right, row_payloads)
                if res is not None:
                    return res
        rep_rows, left, right = self._gather_rows(sc, rows, ctx)
        out = {"left": left, "right": right}
        for name, colv in row_payloads.items():
            out[name] = colv[rep_rows]
        return out

    CONFIRM_CHUNK = 32768  # caps host (chunk, L) f64 gathers at ~2 GB for L=8192

    @classmethod
    def _chunked_confirm(cls, near: np.ndarray, piece_fn):
        """Run an exact host confirmation over ``near`` in bounded chunks so a
        candidate flood (possible at n=1e9 with a loose epsilon) cannot
        materialize a (near, L) float64 matrix of tens of GB.  ``piece_fn``
        maps a chunk of offsets to (kept_offsets, distances)."""
        if near.size <= cls.CONFIRM_CHUNK:
            return piece_fn(near)
        offs, dists = [], []
        for s in range(0, near.size, cls.CONFIRM_CHUNK):
            o, d = piece_fn(near[s: s + cls.CONFIRM_CHUNK])
            offs.append(o)
            dists.append(d)
        return np.concatenate(offs), np.concatenate(dists)

    def _cost_normalizer(self) -> float:
        """Total interval count of the w=100 index (or the closest enabled scale) —
        the denominator of the DP's log-selectivity (QueryEngine.java:409)."""
        scales = sorted(self.index)
        ref_w = 100 if 100 in self.index else scales[len(scales) // 2]
        sc = self.index[ref_w]
        return float(sc.cum_intervals[-1]) if sc.num_rows else 1.0

    # ------------------------------------------------------------------ hooks
    def _plan_inputs(self, ctx: _Ctx):
        """(sums_lo, sums_hi, cost_batch_fn) for the segmentation DP."""
        raise NotImplementedError

    def _plan(self, ctx: _Ctx) -> List[QuerySegment]:
        from ..plan import determine_query_plan
        lo, hi, fn = self._plan_inputs(ctx)
        return determine_query_plan(ctx.length, lo, hi, fn,
                                    self.icfg, self.qcfg)

    def _cost_batch_multi(self, ctxs):
        """Optional whole-batch cost function for the stacked DP: engines that
        can evaluate all queries' probe-range costs in one (Q, S) vectorized
        call per scale return it here; None keeps the per-query loop."""
        return None

    def _plan_batch(self, ctxs) -> list:
        """Plan a same-length query batch with the stacked DP (identical
        output to per-query _plan; the 30x5 transition ops amortize)."""
        from ..plan import determine_query_plans_batched
        parts = [self._plan_inputs(c) for c in ctxs]
        lo = np.stack([pt[0] for pt in parts])
        hi = np.stack([pt[1] for pt in parts])
        return determine_query_plans_batched(
            ctxs[0].length, lo, hi, [pt[2] for pt in parts],
            self.icfg, self.qcfg,
            cost_batch_multi=self._cost_batch_multi(ctxs))

    def _scan(self, seg: QuerySegment, ctx: _Ctx) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _combine(self, pieces, a, b, ia, ib, ctx: _Ctx) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _intersect_native(self, cs, positions, ctx: _Ctx, delta: int = 0):
        """Fused C two-pointer CS x CS_i step (native/interval_kernels.c),
        with the frame shift and phase-1 bookkeeping folded in; returns
        (cs_dict_shifted, n_offsets, min_eps) or None for the NumPy path."""
        return None

    def _scan_join(self, seg: QuerySegment, cs, ctx: _Ctx):
        """Fused scan+intersect join against the current candidate set (engines
        with a native join kernel override); None falls back to scan+intersect."""
        return None

    # Use the join when the candidate set is this many times smaller than the
    # segment's planned interval count (the join is O(|CS| log P) vs the
    # scan's O(P) view walk).
    JOIN_CS_RATIO = 16

    def _verify(self, offsets: np.ndarray, ctx: _Ctx
                ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _track_min_eps(self, cs: Dict[str, np.ndarray], ctx: _Ctx) -> None:
        if "eps" in cs and cs["eps"].size:
            ctx.last_min_eps = float(cs["eps"].min())

    def _candidate_intervals(self, cs: Dict[str, np.ndarray], last_segment: int,
                             length: int) -> Tuple[np.ndarray, np.ndarray]:
        """Translate the final CS to query-offset frame, clipped to valid starts."""
        if cs["left"].size == 0:
            e = np.empty(0, np.int64)
            return e, e
        base = (last_segment - 1) * self.icfg.unit
        left = np.maximum(cs["left"] - base, 0)
        right = np.minimum(cs["right"] - base, self.n - length)
        keep = left <= right
        return left[keep], right[keep]

    def _data_center(self) -> float:
        if not hasattr(self, "_center"):
            self._center = float(self.data.mean())
        return self._center

    REGION_M = 512
    # Gather-vs-region choice by DEVICE TRAFFIC: a region row reads M+L-1
    # points and serves up to M offsets (one FFT ~ the cost of 2-3 candidate
    # gathers — the fudge factor); the gather path reads L points per offset.
    # Intervals are gap-coalesced first (gap <= M), so dense-but-fragmented
    # candidate sets (millions of short intervals a few positions apart at
    # n=1e9) pack into shared regions instead of one region per interval.
    # The norm engines use a larger fudge: their scattered path prunes with an
    # exact host constraint prefilter before gathering.
    REGION_MIN_OFFSETS = 2048
    REGION_TRAFFIC_FUDGE = 2.0

    def _region_m(self, L: int, avg_run: float) -> int:
        """Region width.  The FFT length is next_pow2(M + L - 1), so for DENSE
        candidate runs M = next_pow2(L) costs the SAME transform as M = 512
        while serving up to 16x more offsets per region row (the N-point FFT
        is ~fully utilized: M + L - 1 = 2*next_pow2(L) - 1).  Short scattered
        runs keep the small M: an isolated hit then reads M + L - 1 points
        instead of ~2L."""
        base = self.REGION_M
        if avg_run >= 2 * base:
            return max(base, 1 << int(np.ceil(np.log2(max(L, 2)))))
        return base

    def _region_plan(self, cand_ivs, L: int):
        """Decide gather vs region path and, for the region path, pack all
        queries' gap-coalesced intervals into fixed-M region rows.  Returns
        (starts, valid_from, valid_to, qids, M) or None for the gather path."""
        from ..ops.regions import coalesce_intervals, pack_regions
        n_offsets = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
        if n_offsets < self.REGION_MIN_OFFSETS:
            return None
        merged = [coalesce_intervals(l, r, self.REGION_M) if l.size else (l, r)
                  for l, r in cand_ivs]
        n_runs = sum(l.size for l, _ in merged)
        run_len = sum(int(np.sum(r - l + 1)) for l, r in merged if l.size)
        if n_runs == 0:
            return None
        M = self._region_m(L, run_len / n_runs)
        if M > self.REGION_M:  # re-coalesce at the wider gap
            merged = [coalesce_intervals(l, r, M) if l.size else (l, r)
                      for l, r in merged]
        n_regions = sum(int(np.sum((r - l + 1 + M - 1) // M))
                        for l, r in merged if l.size)
        if (n_regions == 0
                or n_regions * (M + L - 1) * self.REGION_TRAFFIC_FUDGE
                    > n_offsets * L):
            return None
        starts, vfrom, vto, qids = [], [], [], []
        for qi, (l, r) in enumerate(merged):
            if l.size == 0:
                continue
            s, a, b = pack_regions(l, r, self.n, L, M)
            starts.append(s)
            vfrom.append(a)
            vto.append(b)
            qids.append(np.full(s.size, qi, np.int32))
        return (np.concatenate(starts), np.concatenate(vfrom),
                np.concatenate(vto), np.concatenate(qids), M)

    #: Above this series length the cumsum-based host prefilters (PAA,
    #: constraint) are skipped on the host verify route: the cached f64
    #: prefix sums cost 16 bytes/point (two 80 GB arrays at n=1e10) while the
    #: route only ever sees tiny candidate sets the exact kernel handles
    #: directly.
    PREFILTER_CUMSUM_MAX_N = 1 << 31

    def _host_verify_ok(self, cand_ivs, L: int) -> bool:
        """True when the batch's whole phase-2 load is small enough that the
        exact f64 host kernel undercuts even ONE device launch (the fixed
        dispatch floor) — see QueryConfig.host_verify_max_points.  Sound in
        both directions: the host kernel IS the exact confirmation step the
        device route ends with anyway."""
        cap = self.qcfg.host_verify_max_points
        if cap <= 0:
            return False
        total = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
        return total * L <= cap

    #: Staged-point budget for the host prefilter tier's run-local prefix
    #: sums (utils/sparse_prefix.py): 2.5e8 f64 points = 2 GB per array.
    HOST_PREFILTER_MAX_STAGED = 250_000_000

    def _host_prefilter_prefix(self, cand_ivs, L: int, want_sq: bool):
        """Run-local prefix views ``(c1, c2)`` for the host-only prefilter
        tier, or None when the load is outside the tier (too many offsets,
        or too much coverage to stage within the budget).  The tier lets a
        host-only engine answer mid-size candidate loads at any n — the
        full-series cumsums the regular prefilters use are unaffordable at
        n=1e10 (80 GB/array) — by staging only the candidate runs.  See
        QueryConfig.host_prefilter_max_offsets."""
        lim = self.qcfg.host_prefilter_max_offsets
        if lim <= 0:
            return None
        total = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
        if total == 0 or total > lim:
            return None
        from ..utils.sparse_prefix import sparse_prefixes
        alll = np.concatenate([l for l, r in cand_ivs if l.size])
        allr = np.concatenate([r for l, r in cand_ivs if l.size])
        c1, c2, _staged = sparse_prefixes(
            self.data, alll, allr, L, want_sq=want_sq,
            max_staged=self.HOST_PREFILTER_MAX_STAGED)
        if c1 is None:
            return None
        return c1, c2

    def _verify_intervals(self, left: np.ndarray, right: np.ndarray, ctx: _Ctx
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Default phase 2: expand intervals to offsets and run the per-candidate
        gather kernel.  ED engines override to pick the region/conv path when
        candidates are clustered (ops/regions.py)."""
        offsets = iv.expand_offsets({"left": left, "right": right})
        return self._verify(offsets, ctx)

    # ------------------------------------------------------------- streamed p2
    # Staged points per verification group: 1 GB f32 on device + the f64 host
    # copy.  Groups beyond this are verified sequentially.
    STREAM_MAX_STAGE = 1 << 28

    def _verify_multi_streamed(self, cand_ivs, ctxs):
        """Phase 2 for series LARGER THAN DEVICE HBM (device_data='stream').

        Candidate intervals from all queries are coalesced into runs; each run
        is staged with halos (rho for DTW envelopes, a region-width tail for
        the packed-region kernels) into a compact host f64 buffer, shipped H2D
        once, and verified by a sub-engine of the same class in LOCAL
        coordinates — the full device cascade (region/FFT, LB stages, banded
        DP, DS confirm, exact host confirms) runs unchanged because every
        read a valid candidate triggers stays inside its own staged run.
        Near-series-edge halos replicate the boundary point, which reproduces
        the clamped global envelope exactly.  This is the HBM-era analog of
        the reference's batched storage reads at n=1e10+ scales
        (NormQueryEngine.java:454-479, LongRandomQueryTest.java:33-50)."""
        if getattr(self, "host_only", False):
            total = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
            raise RuntimeError(
                f"host-only engine: candidate load ({total} offsets x "
                f"L={ctxs[0].length}) exceeds host_verify_max_points="
                f"{self.qcfg.host_verify_max_points}; phase 2 would need the "
                f"device (device_data='stream')")
        import jax.numpy as jnp

        L = ctxs[0].length
        rho = int(ctxs[0].params.get("rho", 0) or 0)
        halo = rho
        # Gap/tail >= any region width _region_plan can pick (next_pow2(L)),
        # so per-query region packing never crosses staged-run boundaries and
        # region-row tail reads stay inside the buffer (masked columns).
        G = 1 << int(np.ceil(np.log2(max(L, 2 * self.REGION_M))))
        tail = L - 1 + G + halo
        empty = (np.empty(0, np.int64), np.empty(0))
        nz = [(l, r) for l, r in cand_ivs if l.size]
        if not nz:
            return [empty for _ in ctxs]
        alll = np.concatenate([l for l, _ in nz])
        allr = np.concatenate([r for _, r in nz])
        order = np.argsort(alll, kind="stable")
        alll, allr = alll[order], np.maximum.accumulate(allr[order])
        new = np.empty(alll.size, bool)
        new[0] = True
        np.greater(alll[1:], allr[:-1] + G, out=new[1:])
        starts = np.flatnonzero(new)
        run_lo = alll[starts]
        run_hi = allr[np.concatenate((starts[1:] - 1, [alll.size - 1]))]
        stg_lo = run_lo - halo                      # virtual (may be < 0)
        ext = (run_hi - stg_lo + 1) + tail          # staged length per run

        # Split runs into groups under the staging budget (a single run wider
        # than the budget still forms its own group — device HBM permitting).
        bounds = [0]
        acc = 0
        for i, e in enumerate(ext):
            if acc and acc + e > self.STREAM_MAX_STAGE:
                bounds.append(i)
                acc = 0
            acc += int(e)
        bounds.append(ext.size)

        results = [[] for _ in ctxs]
        acc_dev = [0] * len(ctxs)
        acc_host = [0] * len(ctxs)
        for g0, g1 in zip(bounds[:-1], bounds[1:]):
            g_stg_lo = stg_lo[g0:g1]
            g_ext = ext[g0:g1]
            loc0 = np.concatenate(([0], np.cumsum(g_ext)[:-1]))
            buf = np.empty(int(g_ext.sum()), np.float64)
            for i in range(g_ext.size):
                a = int(g_stg_lo[i])
                b = a + int(g_ext[i])
                dst = buf[int(loc0[i]): int(loc0[i]) + (b - a)]
                s, e = max(a, 0), min(b, self.n)
                dst[s - a: s - a + (e - s)] = self.data[s:e]
                if s > a:
                    dst[: s - a] = self.data[0]
                if b > e:
                    dst[e - a:] = self.data[self.n - 1]
            sub = object.__new__(type(self))
            sub.data = buf
            sub.n = buf.size
            sub.icfg = self.icfg
            sub.qcfg = self.qcfg
            sub.index = {}
            sub.data_dev = jnp.asarray(buf, jnp.float32)
            lo_g, hi_g = int(run_lo[g0]), int(run_hi[g1 - 1])
            local_ivs = []
            for l, r in cand_ivs:
                sel = (l >= lo_g) & (l <= hi_g) if l.size else np.zeros(0, bool)
                li, ri = l[sel], r[sel]
                ridx = np.searchsorted(run_lo[g0:g1], li, side="right") - 1
                local_ivs.append((li - g_stg_lo[ridx] + loc0[ridx],
                                  ri - g_stg_lo[ridx] + loc0[ridx]))
            sub_res = sub._verify_multi(local_ivs, ctxs)
            for qi, (lo_offs, dists) in enumerate(sub_res):
                acc_dev[qi] += ctxs[qi].stats.n_device_checked
                acc_host[qi] += ctxs[qi].stats.n_host_rechecked
                if lo_offs.size:
                    ridx = np.searchsorted(loc0, lo_offs, side="right") - 1
                    results[qi].append((lo_offs - loc0[ridx] + g_stg_lo[ridx],
                                        dists))
        out = []
        for qi, parts in enumerate(results):
            ctxs[qi].stats.n_device_checked = acc_dev[qi]
            ctxs[qi].stats.n_host_rechecked = acc_host[qi]
            if parts:
                out.append((np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts])))
            else:
                out.append(empty)
        return out

    # ------------------------------------------------------------------ phase 1
    def _phase1(self, segments: List[QuerySegment], ctx: _Ctx
                ) -> Tuple[Dict[str, np.ndarray], int]:
        unit = self.icfg.unit
        qcfg = self.qcfg
        t0 = time.perf_counter()
        cs: Optional[Dict[str, np.ndarray]] = None
        last_segment = segments[-1].order
        last_estimate = float("inf")
        cost_a = qcfg.phase2_cost_a_dtw if self.use_dtw_cost_model else qcfg.phase2_cost_a
        cost_b = qcfg.phase2_cost_b_dtw if self.use_dtw_cost_model else qcfg.phase2_cost_b
        if self.host_only:
            # tuned()'s per-offset slopes are calibrated for the DEVICE
            # verify kernels; the host-only route verifies through the
            # sparse-prefix prefilters + exact f64 kernels at roughly 25x the
            # per-offset cost (measured n=1e7: 1M leftover candidates cost
            # ~1.1 s host vs the ~41 ms the device slope predicts).  Scaling
            # the estimate keeps early termination probing further before
            # handing a flood to the slow route; with the reference default
            # constants (already host-calibrated) this is a no-op-ish
            # overestimate that only delays termination, never unsoundness
            # (phase 2 is exact either way).
            cost_b *= qcfg.host_cost_scale

        est2_now = float("inf")  # phase-2 estimate of the CURRENT cs
        for i, seg in enumerate(segments):
            # Marginal-scan termination (see QueryConfig): the NEXT scan's
            # predicted cost already exceeds verifying the current cs exactly.
            if (qcfg.enable_early_termination and i >= 1
                    and seg.count * qcfg.phase1_scan_cost_ms_per_interval
                        > est2_now):
                last_segment = seg.order  # cs is framed at this segment
                ctx.stats.early_terminated = True
                break
            delta = 0 if i == len(segments) - 1 else \
                (segments[i + 1].order - seg.order) * unit
            ctx.processed_units += seg.w // unit
            fused = None  # (n_disjoint, n_offsets, min_eps) from the C step

            if i == 0:
                positions = self._scan(seg, ctx)
                ctx.stats.n_scans += 1
                # Only the first segment's set becomes the running CS and needs
                # sort+merge; later raw scans intersect against it unsorted.
                positions = iv.merge_intervals(positions)
                base = (seg.order - 1) * unit
                lo, hi = base, self.n - ctx.length + base  # valid window starts, 0-based
                left = np.maximum(positions["left"], lo)
                right = np.minimum(positions["right"], hi)
                keep = left <= right
                nxt = {k: v[keep] for k, v in positions.items()}
                nxt["left"], nxt["right"] = left[keep], right[keep]
            else:
                nxt = None
                # Join only when its O(|CS| log T) beats the per-row merge AND
                # the scale's position-sorted view is warranted (building it
                # costs O(T log R) once — POS_VIEW_MIN gates that, as in
                # _scan_fill/_gather_rows).
                if (cs["left"].size * self.JOIN_CS_RATIO < seg.count
                        and (self.index[seg.w].has_pos_sorted
                             or seg.count > self.POS_VIEW_MIN)):
                    nxt = self._scan_join(seg, cs, ctx)
                if nxt is not None:
                    ctx.stats.n_scans += 1
                    ctx.stats.n_joins += 1
                else:
                    positions = self._scan(seg, ctx)
                    ctx.stats.n_scans += 1
                    nat = self._intersect_native(cs, positions, ctx, delta)
                    if nat is not None:
                        # The C kernel emitted the shifted, sorted-disjoint
                        # set AND its bookkeeping in one pass: no extra
                        # shift/merge/count/min-eps array passes.
                        nxt, n_off_c, emin_c = nat
                        fused = (nxt["left"].size, n_off_c, emin_c)
                    else:
                        pieces, ia, ib = iv.intersect_with_sorted(cs, positions)
                        nxt = self._combine(pieces, cs, positions, ia, ib, ctx)

            if fused is not None:
                if np.isfinite(fused[2]) and nxt["left"].size:
                    ctx.last_min_eps = fused[2]
                cs = nxt  # already in the next segment's frame
            else:
                self._track_min_eps(nxt, ctx)
                # NOTE: on the join path nxt's payload columns are ping-pong
                # scratch views (native._PING), and shift/merge_intervals may
                # return them UNCOPIED — cs can alias the pools until the next
                # native call flips the generation.  Sound only under the
                # shared-ping invariant documented at native._PING.
                cs = iv.merge_intervals(iv.shift(nxt, delta))
            ctx.stats.n_segments_used = i + 1
            if cs["left"].size:
                ctx.span = (int(cs["left"][0]), int(cs["right"][-1]))

            if cs["left"].size == 0:
                ctx.stats.t_phase1_ms = (time.perf_counter() - t0) * 1e3
                return cs, (segments[i + 1].order if i + 1 < len(segments) else seg.order)

            n_disjoint, n_offsets = fused[:2] if fused is not None \
                else iv.count_stats(cs)
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug("segment %d (order=%d w=%d): %d disjoint ranges, "
                             "%d offsets", i + 1, seg.order, seg.w,
                             n_disjoint, n_offsets)
            if qcfg.enable_early_termination:
                t1_ms = (time.perf_counter() - t0) * 1e3
                est2 = (cost_a * n_disjoint +
                        cost_b * n_offsets / 1e5 * ctx.length +
                        qcfg.phase2_cost_intercept)
                if (qcfg.phase2_cost_region is not None
                        and self.data_dev is not None and not self.host_only
                        and not self.use_dtw_cost_model):
                    # Clustered candidates take the region route (see
                    # QueryConfig.phase2_cost_region): flat per-offset rate,
                    # ~L-independent.
                    est2 = min(est2, qcfg.phase2_cost_region * n_offsets
                               + qcfg.phase2_cost_intercept)
                est2_now = est2
                estimate = t1_ms + est2
                if logger.isEnabledFor(logging.DEBUG):
                    logger.debug("estimate after segment %d: t1=%.1fms "
                                 "est2=%.1fms", i + 1, t1_ms, est2)
                if (i >= qcfg.min_segments_before_termination
                        and estimate > last_estimate):
                    last_segment = (segments[i + 1].order if i + 1 < len(segments)
                                    else seg.order)
                    ctx.stats.early_terminated = True
                    break
                last_estimate = estimate
        else:
            last_segment = segments[-1].order

        ctx.stats.t_phase1_ms = (time.perf_counter() - t0) * 1e3
        return cs, last_segment

    # ------------------------------------------------- dense-on-device phase 1
    DENSE_PROBE_K = 1 << 20      # baseline candidate capacity of the fly probe
    DENSE_PROBE_K_BUDGET = 1 << 28  # total capacity elements across a batch
    DENSE_PROBE_GROUP = 32       # dense queries probed per device program

    def _dense_probe_k(self, n_queries: int) -> int:
        """Adaptive candidate capacity: single queries get deep buffers (a
        dense query can hold tens of millions of candidates), large batches
        split a fixed budget."""
        return max(self.DENSE_PROBE_K,
                   min(1 << 25, self.DENSE_PROBE_K_BUDGET // max(n_queries, 1)))

    def _dense_route(self, segments) -> bool:
        """True when phase 1 should run as the device dense probe: even the
        most selective plan segment is dense enough that host interval algebra
        would churn through 1e8-interval intermediates."""
        if self.data_dev is None:  # streamed mode: phase 1 stays on host
            return False
        cutoff = self.qcfg.dense_probe_min_count
        return (cutoff is not None and bool(segments)
                and min(s.count for s in segments) > cutoff)

    def _fly_padded_dev(self, length: int):
        """Lazily cached right-padded f32 series for the on-the-fly probe."""
        import jax.numpy as jnp
        from ..parallel.query import FLY_FILL, fly_pad_for
        w_max = max(self.icfg.scales)
        pad = fly_pad_for(length, w_max)
        cur = getattr(self, "_fly_data", None)
        if cur is None or cur[0] < pad:
            self._fly_data = (pad, jnp.concatenate(
                [self.data_dev, jnp.full(pad, FLY_FILL, jnp.float32)]))
        return self._fly_data[1]

    def _device_dense_phase1(self, ctxs, seg_lists, gap: int = 1):
        """Run the fly dense probe for a same-length query group; returns
        (counts i32[Q], positions i32[Q, K] position-ordered)."""
        import jax.numpy as jnp
        from ..parallel.query import (make_dense_probe_step_fly,
                                      pack_segments_batch)
        L = ctxs[0].length
        norm = "alpha" in ctxs[0].params
        if not hasattr(self, "_fly_steps"):
            self._fly_steps = {}
        cand_k = self._dense_probe_k(len(ctxs))
        key = (L, norm, len(ctxs), cand_k)
        if key not in self._fly_steps:
            self._fly_steps[key] = make_dense_probe_step_fly(
                self.icfg, L, cand_k=cand_k, norm=norm)
        step = self._fly_steps[key]
        data_p = self._fly_padded_dev(L)
        segs = pack_segments_batch(seg_lists, tuple(self.icfg.scales))
        eps2 = jnp.asarray([c.eps2 for c in ctxs], jnp.float32)
        if norm:
            cons = jnp.asarray([[c.params["alpha"], c.params["beta"],
                                 c.params["_mu_q"], c.params["_sd_q"]]
                                for c in ctxs], jnp.float32)
        else:
            cons = jnp.zeros((len(ctxs), 4), jnp.float32)
        n_off, n_runs, run_l, run_r = step(data_p, segs, eps2, cons,
                                           jnp.int32(self.n), jnp.int32(gap))
        # Pull only the live run prefix: the buffers are (Q, cand_k) with
        # cand_k up to 2^25 — a full pull is GBs of device-to-host traffic
        # while selective plans fill a few thousand runs.  Runs are
        # left-compacted per query, so a power-of-two column slice >= the
        # batch max preserves every caller-visible prefix.
        n_runs = np.asarray(n_runs)
        # overflowing queries' buffers are never read (callers re-probe them),
        # so only live prefixes of non-overflowing queries bound the slice
        live = n_runs[n_runs <= cand_k]
        kmax = int(live.max()) if live.size else 0
        k_slice = min(cand_k, max(4096, 1 << max(kmax - 1, 0).bit_length()))
        if k_slice < cand_k:
            run_l, run_r = _run_slice_prog(k_slice)(run_l, run_r)
        return (np.asarray(n_off), n_runs, np.asarray(run_l),
                np.asarray(run_r), cand_k)

    def _dense_probe_retry(self, ctxs, seg_lists):
        """Dense phase 1 emission, route per QueryConfig.dense_probe_emit.

        'flags' (the GPU default, dense_emit_for): every query takes the FLAG
        probe directly — one fused pass emitting a fixed-size per-128-position
        candidate bitmap (plus the device constraint AND for cNSM), no run
        buffers, no overflow at any density.  Flag-block over-coverage is
        rejected by the exact phase 2 (tests/test_probe_pallas.py asserts
        soundness and subset-ness; tests/test_dense_route.py covers bitmap
        semantics).

        'runs' (the CPU default): the run-compressed emission keeps exact
        interval edges, with the overflow ladder: gap=1, then gap-coalesced
        (< unit), then the flag probe as the density-proof backstop.
        Returns {query_index_in_group: (left i64, right i64)}; every query in
        the group is present (no host fallback needed)."""
        import jax

        out = {}
        pending = set(range(len(ctxs)))
        unit = self.icfg.unit
        emit = self.qcfg.dense_probe_emit
        if emit == "auto":
            emit = dense_emit_for(jax.default_backend())
        gaps = (1, unit) if emit == "runs" else ()
        # Re-probe the FULL group each round: the probe program is shape-keyed
        # on Q, so shrinking the group would recompile; one redundant pass
        # over solved queries is far cheaper.
        for gap in gaps:
            n_off, n_runs, run_l, run_r, cand_k = self._device_dense_phase1(
                ctxs, seg_lists, gap=gap)
            for qi in sorted(pending):
                ctxs[qi].stats.n_candidates = int(n_off[qi])
                if n_runs[qi] <= cand_k:
                    k = int(n_runs[qi])
                    out[qi] = (run_l[qi][:k].astype(np.int64),
                               run_r[qi][:k].astype(np.int64))
            pending -= set(out)
            if not pending:
                break
        if pending:
            n_off, flags, fgran = self._device_dense_phase1_flags(ctxs,
                                                                  seg_lists)
            m = self.n - ctxs[0].length + 1
            for qi in sorted(pending):
                ctxs[qi].stats.n_candidates = int(n_off[qi])
                out[qi] = self._flags_to_intervals(flags[qi], m, fgran)
        return out

    FLAG_BLOCK = 256  # position granularity of the XLA flag probe

    def _fly_cons_stats(self, length: int):
        """Cached f32[3, npad] width-L window-stat stack (sum, sum-of-squares,
        max|x|) for the Pallas flag probe's constraint AND, or None when it
        would not fit the HBM budget (12 bytes/point; recomputing per block
        costs ~1.5 s/batch at n=1e8, so the cache pays off after one batch)."""
        from ..parallel.query import _device_mem_bytes, make_cons_stats_prog
        data_p = self._fly_padded_dev(length)
        if int(data_p.shape[0]) * 12 > 0.2 * _device_mem_bytes():
            return None
        cache = getattr(self, "_cons_stats_cache", None)
        if cache is None:
            cache = self._cons_stats_cache = {}
        if length not in cache:
            cache[length] = make_cons_stats_prog(length)(data_p)
        return cache[length]

    def _fly_bucket_stack(self, length: int):
        """Cached i32[S, npad] per-scale bucket-window stack for the Pallas
        flag probe, or None when it would not fit the HBM budget (4*S
        bytes/point).  Query-independent: recomputing it per pass costs the
        sliding-sum + bucketize passes on every one of the ~24 blocks at
        n=1e8, every batch."""
        from ..parallel.query import _device_mem_bytes, make_bucket_stack_prog
        data_p = self._fly_padded_dev(length)
        nbytes = int(data_p.shape[0]) * 4 * len(self.icfg.scales)
        if nbytes > 0.2 * _device_mem_bytes():
            return None
        cache = getattr(self, "_bucket_stack_cache", None)
        if cache is None:
            cache = self._bucket_stack_cache = {}
        if length not in cache:
            cache[length] = make_bucket_stack_prog(
                self.icfg, tuple(self.icfg.scales))(data_p)
        return cache[length]

    def _device_dense_phase1_flags(self, ctxs, seg_lists):
        """Overflow-proof flood phase 1: one fly-probe pass emitting per-block
        candidate flags (bool[Q, NF]) plus exact candidate counts.  Output
        size is fixed at any candidate density — ~0.4 MB/query at n=1e8 vs
        256 MB/query of run buffers.  The route comes from
        ops/probe_pallas.probe_kernel_for: the fused kernel (flag granularity
        128) on a GPU, the XLA flags step (granularity FLAG_BLOCK=256) on the
        CPU.  Returns (n_off i32[Q], flags bool[Q, NF], flag_granularity)."""
        import jax
        import jax.numpy as jnp
        from ..ops.probe_pallas import FLAG, probe_kernel_for
        from ..parallel.query import (make_dense_probe_step_flags,
                                      make_dense_probe_step_flags_pallas,
                                      pack_segments_batch)
        L = ctxs[0].length
        norm = "alpha" in ctxs[0].params
        use_kernel = probe_kernel_for(jax.default_backend()) == "triton"
        stats3 = self._fly_cons_stats(L) if (use_kernel and norm) else None
        bstack3 = self._fly_bucket_stack(L) if use_kernel else None
        if not hasattr(self, "_flag_steps"):
            self._flag_steps = {}
        key = (L, norm, len(ctxs), use_kernel, stats3 is not None,
               bstack3 is not None)
        if key not in self._flag_steps:
            if use_kernel:
                self._flag_steps[key] = make_dense_probe_step_flags_pallas(
                    self.icfg, L, norm=norm,
                    cached_stats=stats3 is not None,
                    cached_buckets=bstack3 is not None)
            else:
                self._flag_steps[key] = make_dense_probe_step_flags(
                    self.icfg, L, flag_block=self.FLAG_BLOCK, norm=norm)
        step = self._flag_steps[key]
        data_p = self._fly_padded_dev(L)
        segs = pack_segments_batch(seg_lists, tuple(self.icfg.scales))
        eps2 = jnp.asarray([c.eps2 for c in ctxs], jnp.float32)
        if norm:
            cons = jnp.asarray([[c.params["alpha"], c.params["beta"],
                                 c.params["_mu_q"], c.params["_sd_q"]]
                                for c in ctxs], jnp.float32)
        else:
            cons = jnp.zeros((len(ctxs), 4), jnp.float32)
        if use_kernel:
            n_off, flags = step(data_p, segs, eps2, cons, jnp.int32(self.n),
                                stats3=stats3, bstack3=bstack3)
        else:
            n_off, flags = step(data_p, segs, eps2, cons, jnp.int32(self.n))
        return (np.asarray(n_off), np.asarray(flags),
                FLAG if use_kernel else self.FLAG_BLOCK)

    def _flags_to_intervals(self, flags_row: np.ndarray, m: int,
                            fgran: int | None = None):
        """Expand one query's flag bitmap into disjoint candidate intervals
        (adjacent flagged blocks coalesce; right edges clip to the last valid
        window start m-1)."""
        F = fgran if fgran is not None else self.FLAG_BLOCK
        idx = np.flatnonzero(flags_row)
        if idx.size == 0:
            e = np.empty(0, np.int64)
            return e, e
        breaks = np.flatnonzero(np.diff(idx) > 1)
        left = idx[np.concatenate(([0], breaks + 1))].astype(np.int64) * F
        right = np.minimum(
            (idx[np.concatenate((breaks, [idx.size - 1]))].astype(np.int64)
             + 1) * F - 1, m - 1)
        return left, right

    @staticmethod
    def _positions_to_intervals(offs: np.ndarray):
        """Compress sorted candidate positions into (left, right) runs."""
        if offs.size == 0:
            e = np.empty(0, np.int64)
            return e, e
        offs = offs.astype(np.int64)
        breaks = np.flatnonzero(np.diff(offs) > 1)
        left = offs[np.concatenate(([0], breaks + 1))]
        right = offs[np.concatenate((breaks, [offs.size - 1]))]
        return left, right

    def _phase1_routed(self, segments, ctx: _Ctx):
        """Host phase 1, or the device dense probe for dense plans.  Returns
        (c_left, c_right) candidate intervals in the global (query-start)
        frame."""
        if self._dense_route(segments):
            t0 = time.perf_counter()
            res = self._dense_probe_retry([ctx], [segments])
            if 0 in res:
                ctx.stats.t_phase1_ms = (time.perf_counter() - t0) * 1e3
                ctx.stats.n_scans = len(segments)
                ctx.stats.n_segments_used = len(segments)
                return res[0]
            # overflow at every coalescing gap: exact host fallback
        cs, last_segment = self._phase1(segments, ctx)
        return self._candidate_intervals(cs, last_segment, ctx.length)

    # ------------------------------------------------------------------ driver
    def query(self, query: np.ndarray, epsilon: float, **params) -> QueryResult:
        query = np.asarray(query, np.float64)
        if query.size < self.icfg.unit:
            raise ValueError(
                f"query length {query.size} is below the smallest index scale "
                f"({self.icfg.unit}); KV-match requires L >= {self.icfg.unit} "
                f"(QueryEngine.java:121-123)")
        if epsilon < 0:
            raise ValueError("epsilon must be >= 0")
        stats = QueryStats()
        ctx = _Ctx(query=query, length=query.size, epsilon=float(epsilon),
                   eps2=float(epsilon) ** 2, params=params, stats=stats)
        t0 = time.perf_counter()

        segments = self._plan(ctx)
        c_l, c_r = self._phase1_routed(segments, ctx)

        t2 = time.perf_counter()
        stats.n_candidates = int(np.sum(c_r - c_l + 1)) if c_l.size else 0
        stats.n_disjoint = int(c_l.size)
        if c_l.size:
            ans_off, ans_dist = self._verify_intervals(c_l, c_r, ctx)
        else:
            ans_off, ans_dist = np.empty(0, np.int64), np.empty(0)
        stats.t_phase2_ms = (time.perf_counter() - t2) * 1e3

        order = np.argsort(ans_dist, kind="stable")
        ans_off, ans_dist = ans_off[order], ans_dist[order]
        stats.n_answers = int(ans_off.size)
        stats.t_total_ms = (time.perf_counter() - t0) * 1e3
        return QueryResult(offsets=ans_off, distances=ans_dist, stats=stats)

    # ------------------------------------------------ device-probe batched driver
    def query_batch_device(self, queries: np.ndarray, epsilon,
                           top_k: int = 4096, **params):
        """Batched querying with PHASE 1 ON DEVICE for every query: the fly
        dense probe (on-the-fly bucket windows, ordered compaction — no
        (S, n) stack upload) hands each query's candidates to the engine's
        normal batched verification.  Queries that overflow the candidate
        capacity transparently rerun through the exact host phase-1 path, so
        results are always complete.  ``top_k`` is kept for API compatibility;
        capacity is max(top_k, DENSE_PROBE_K)."""
        if self.data_dev is None:  # streamed mode: no device-resident series
            return self.query_batch(queries, epsilon, **params)
        import time as _time
        queries = np.atleast_2d(np.asarray(queries, np.float64))
        nq, L = queries.shape
        eps = np.broadcast_to(np.asarray(epsilon, np.float64), (nq,))
        t0 = _time.perf_counter()
        ctxs = []
        for qi in range(nq):
            ctxs.append(_Ctx(query=queries[qi], length=L, epsilon=float(eps[qi]),
                             eps2=float(eps[qi]) ** 2, params=dict(params),
                             stats=QueryStats()))
        seg_lists = self._plan_batch(ctxs)
        # Probe in DENSE_PROBE_GROUP-query programs, same as query_batch: one
        # full-batch program at Q=128 compiles a fly-probe working set far
        # over device memory.
        dense_res: dict = {}
        for g in range(0, nq, self.DENSE_PROBE_GROUP):
            grp = list(range(g, min(g + self.DENSE_PROBE_GROUP, nq)))
            grp_res = self._dense_probe_retry([ctxs[qi] for qi in grp],
                                              [seg_lists[qi] for qi in grp])
            for j, qi in enumerate(grp):
                if j in grp_res:
                    dense_res[qi] = grp_res[j]

        cand_ivs = []
        for qi, ctx in enumerate(ctxs):
            if qi in dense_res:
                cand_ivs.append(dense_res[qi])
            else:
                cs, last = self._phase1(seg_lists[qi], ctx)
                cand_ivs.append(self._candidate_intervals(cs, last, L))
        per_query = self._verify_multi(cand_ivs, ctxs)
        t_end = _time.perf_counter()
        results = []
        for qi, (ans_off, ans_dist) in enumerate(per_query):
            order = np.argsort(ans_dist, kind="stable")
            stats = ctxs[qi].stats
            stats.n_answers = int(ans_off.size)
            stats.t_total_ms = (t_end - t0) * 1e3 / nq
            results.append(QueryResult(offsets=ans_off[order],
                                       distances=ans_dist[order], stats=stats))
        return results

    # ------------------------------------------------------------ batched driver
    def query_batch(self, queries: np.ndarray, epsilon, **params) -> List[QueryResult]:
        """Throughput path: run phases 0/1 per query on the host, then verify ALL
        queries' candidates in shared device launches (one padded batch stream
        instead of one launch per query).  ``queries`` is (Q, L); ``epsilon`` may
        be a scalar or per-query array.  Returns one QueryResult per query."""
        queries = np.atleast_2d(np.asarray(queries, np.float64))
        nq = queries.shape[0]
        eps = np.broadcast_to(np.asarray(epsilon, np.float64), (nq,))
        ctxs: List[_Ctx] = []
        cand_ivs: List[Tuple[np.ndarray, np.ndarray]] = []
        t0 = time.perf_counter()
        for qi in range(nq):
            ctxs.append(_Ctx(query=queries[qi], length=queries.shape[1],
                             epsilon=float(eps[qi]), eps2=float(eps[qi]) ** 2,
                             params=dict(params), stats=QueryStats()))
        seg_lists = self._plan_batch(ctxs)
        # Dense plans run the device probe as ONE batched program; the rest
        # (and any probe overflowing its candidate capacity) take host phase 1.
        dense_q = [qi for qi in range(nq) if self._dense_route(seg_lists[qi])]
        dense_res: dict = {}
        # Sub-batch dense queries so each probe program keeps a deep run
        # buffer (capacity budget is split per query within a group).
        for g in range(0, len(dense_q), self.DENSE_PROBE_GROUP):
            grp = dense_q[g: g + self.DENSE_PROBE_GROUP]
            t0d = time.perf_counter()
            grp_res = self._dense_probe_retry([ctxs[qi] for qi in grp],
                                              [seg_lists[qi] for qi in grp])
            dt = (time.perf_counter() - t0d) * 1e3 / len(grp)
            for j, qi in enumerate(grp):
                if j in grp_res:
                    ctxs[qi].stats.t_phase1_ms = dt
                    ctxs[qi].stats.n_scans = len(seg_lists[qi])
                    ctxs[qi].stats.n_segments_used = len(seg_lists[qi])
                    dense_res[qi] = grp_res[j]
        for qi in range(nq):
            ctx = ctxs[qi]
            if qi in dense_res:
                c_l, c_r = dense_res[qi]
            else:
                cs, last_segment = self._phase1(seg_lists[qi], ctx)
                c_l, c_r = self._candidate_intervals(cs, last_segment, ctx.length)
            ctx.stats.n_candidates = int(np.sum(c_r - c_l + 1)) if c_l.size else 0
            ctx.stats.n_disjoint = int(c_l.size)
            cand_ivs.append((c_l, c_r))
        t_verify = time.perf_counter()
        per_query = self._verify_multi(cand_ivs, ctxs)
        t_end = time.perf_counter()
        results = []
        for qi, (ans_off, ans_dist) in enumerate(per_query):
            order = np.argsort(ans_dist, kind="stable")
            stats = ctxs[qi].stats
            stats.n_answers = int(ans_off.size)
            stats.t_phase2_ms = (t_end - t_verify) * 1e3 / nq
            stats.t_total_ms = (t_end - t0) * 1e3 / nq
            results.append(QueryResult(offsets=ans_off[order],
                                       distances=ans_dist[order], stats=stats))
        return results

    def _verify_multi(self, cand_ivs, ctxs: List[_Ctx]):
        """Default: per-query verification (engines override with a fused
        multi-query device path).  ``cand_ivs`` is one (left, right) interval
        pair per query."""
        return [self._verify_intervals(l, r, ctx) if l.size else
                (np.empty(0, np.int64), np.empty(0))
                for (l, r), ctx in zip(cand_ivs, ctxs)]

    def query_at(self, offset: int, length: int, epsilon: float, **params) -> QueryResult:
        """Self-query convenience: extract Q = data[offset : offset+length] first
        (the reference's query(statistics, offset, length, ...) overload,
        QueryEngine.java:155-160).  ``offset`` is 0-based."""
        if not (0 <= offset and offset + length <= self.n):
            raise ValueError("query window out of range")
        return self.query(self.data[offset: offset + length], epsilon, **params)
