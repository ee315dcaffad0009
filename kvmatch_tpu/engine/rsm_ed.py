"""RSM-ED engine: raw-subsequence matching under Euclidean distance.

Device-native equivalent of the reference QueryEngine (QueryEngine.java:46-711).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np

from ..ops.ed import ed_distances
from ..plan import QuerySegment, unit_sums
from ..utils import intervals as iv
from ..utils import rounding
from .. import verify as vf
from .base import BaseEngine, _Ctx


class QueryEngine(BaseEngine):
    payloads = ("eps",)

    # ---------------------------------------------------------------- phase 0
    def _cost_batch(self, ctx: _Ctx):
        """Vectorized DP cost: #index intervals with key in the segment's plain
        probe range (getCost/getCountsFromStatisticInfo, QueryEngine.java:382-422)."""
        norm = self._cost_normalizer()
        pos_of_d = self.icfg.pos_of_d

        def cost_batch(w, mean_lo, mean_hi):
            sc = self.index[w]
            rng = ctx.epsilon / math.sqrt(w)
            b = rounding.to_round(mean_lo - rng, pos_of_d)
            e = rounding.to_round(mean_hi + rng, pos_of_d)
            cnt_i, _ = sc.counts_between_batch(b, e)
            with np.errstate(divide="ignore"):
                log_cost = np.log(cnt_i / norm)
            return log_cost, cnt_i

        return cost_batch

    def _cost_batch_multi(self, ctxs):
        """Whole-batch DP cost: one (Q, S) searchsorted pass per scale instead
        of a per-query Python loop (same arithmetic as _cost_batch)."""
        norm = self._cost_normalizer()
        pos_of_d = self.icfg.pos_of_d
        eps = np.asarray([c.epsilon for c in ctxs], np.float64)[:, None]

        def cost_batch_multi(w, mean_lo, mean_hi):
            sc = self.index[w]
            rng = eps / math.sqrt(w)
            b = rounding.to_round(mean_lo - rng, pos_of_d)
            e = rounding.to_round(mean_hi + rng, pos_of_d)
            cnt_i, _ = sc.counts_between_batch(b, e)
            with np.errstate(divide="ignore"):
                log_cost = np.log(cnt_i / norm)
            return log_cost, cnt_i

        return cost_batch_multi

    def _plan_inputs(self, ctx: _Ctx):
        sums = unit_sums(ctx.query, self.icfg.unit)
        return sums, sums, self._cost_batch(ctx)

    # ---------------------------------------------------------------- phase 1
    def _probe_rows_eps(self, seg: QuerySegment, ctx: _Ctx):
        """Probed row range + per-row distance lower bound for a segment
        (QueryEngine.java:199-202, 578-591); the probe range shrinks with the
        best epsilon lower bound accumulated so far."""
        sc = self.index[seg.w]
        budget = max(ctx.eps2 - ctx.last_min_eps, 0.0)
        rng = math.sqrt(budget / seg.w) + self.icfg.probe_guard
        begin = float(rounding.snap_down(seg.mean_lo - rng, sc.keys, self.icfg.pos_of_d))
        end = float(rounding.to_round(seg.mean_hi + rng, self.icfg.pos_of_d))
        rows = sc.probe_rows(begin, end)
        if rows.size == 0:
            return sc, rows, None
        lo, hi = self._row_bounds(sc, rows)
        # Distance lower bound per row: w * dist(query mean, [lo, hi])^2
        delta = np.maximum(np.maximum(lo - seg.mean_hi, seg.mean_lo - hi), 0.0)
        eps_row = seg.w * delta * delta
        return sc, rows, eps_row

    def _scan(self, seg: QuerySegment, ctx: _Ctx) -> Dict[str, np.ndarray]:
        """Probe rows with key in [mean - range, mean + range]
        (QueryEngine.java:199-202, 504-518)."""
        sc, rows, eps_row = self._probe_rows_eps(seg, ctx)
        if rows.size == 0:
            return iv.empty_set(("eps",))
        return self._scan_fill(sc, rows, ctx, {"eps": eps_row})

    def _scan_join(self, seg: QuerySegment, cs, ctx: _Ctx):
        """Fused scan+intersect via the position-sorted view: binary search per
        CS interval instead of materializing the segment's (possibly 1e8+
        interval) scan — O(|CS| log P).  None falls back to scan+intersect."""
        from .. import native
        sc, rows, eps_row = self._probe_rows_eps(seg, ctx)
        if rows.size == 0:
            return iv.empty_set(("eps",))
        p_left, p_right, p_row = sc.pos_sorted()
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        return native.join_ed(cs, p_left, p_right, p_row, i0, i1, eps_row,
                              ctx.eps2, self.icfg.maximum_diff,
                              row_total=int(sc.row_ptr[i1] - sc.row_ptr[i0]))

    def _combine(self, pieces, a, b, ia, ib, ctx: _Ctx) -> Dict[str, np.ndarray]:
        eps_sum = a["eps"][ia] + b["eps"][ib]
        keep = eps_sum <= ctx.eps2
        return {"left": pieces["left"][keep], "right": pieces["right"][keep],
                "eps": eps_sum[keep]}

    def _intersect_native(self, cs, positions, ctx: _Ctx, delta: int = 0):
        from .. import native
        return native.intersect_ed(cs, positions, ctx.eps2, delta)

    # ---------------------------------------------------------------- phase 2
    @functools.lru_cache(maxsize=8)
    def _kernel(self, length: int):
        import jax.numpy as jnp
        data_dev = self.data_dev
        def run(query_f32, offs):
            return ed_distances(data_dev, query_f32, offs, length)
        return run

    def _confirm_ed(self, near: np.ndarray, ctx: _Ctx):
        """Exact float64 host confirmation of near-threshold candidates
        (chunked — see BaseEngine._chunked_confirm)."""
        ctx.stats.n_host_rechecked = int(near.size)
        if near.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        cols = np.arange(ctx.length)

        def piece(p):
            diff = self.data[p[:, None] + cols[None, :]].astype(
                np.float64, copy=False) - ctx.query[None, :]
            d2h = np.einsum("ij,ij->i", diff, diff)
            keep = d2h <= ctx.eps2
            return p[keep], np.sqrt(d2h[keep])

        return self._chunked_confirm(near, piece)

    def _verify_intervals(self, left, right, ctx):
        return self._verify_multi([(left, right)], [ctx])[0]

    def _paa_prefilter(self, offsets: np.ndarray, ctx: _Ctx, thresh: float,
                       blocks: int = 16, env=None, prefix=None) -> np.ndarray:
        """Raw-space PAA lower bound from prefix sums (no window gather): by
        Jensen, ED^2 >= c * sum_k (blk_mean(T) - blk_mean(Q))^2 over whole
        blocks of width c (PaaUcrEdQueryExecutor.java:104-120 moved inside the
        engine).  With env=(lo_blk, hi_blk) (block means of the Sakoe-Chiba
        envelope) the per-block distance becomes the envelope form, which
        lower-bounds banded DTW (PaaUcrDtwQueryExecutor.java:413)."""
        L = ctx.length
        c = L // blocks
        if offsets.size == 0 or c < 4:
            return offsets
        nblk = L // c
        if prefix is not None:
            c1 = prefix  # run-local view (utils/sparse_prefix.py): any-n mode
        else:
            if not hasattr(self, "_c1_paa"):
                self._c1_paa = np.concatenate(([0.0], np.cumsum(self.data)))
            c1 = self._c1_paa
        if env is not None:
            lo_blk, hi_blk = env
            qb = None
        else:
            qb = ctx.params.get("_q_blk")
            if qb is None or qb.size != nblk:
                qb = ctx.query[: nblk * c].reshape(nblk, c).mean(axis=1)
                ctx.params["_q_blk"] = qb
        # Chunked: a dense candidate set (tens of millions of offsets at
        # n=1e9) would otherwise materialize (B, nblk) temporaries of tens of
        # GB; 1M-offset pieces keep the working set cache-friendly.
        CHUNK = 1 << 20
        cols = np.arange(nblk) * c
        lb = np.empty(offsets.size)
        for s in range(0, offsets.size, CHUNK):
            o = offsets[s: s + CHUNK, None] + cols[None, :]
            blk = (c1[o + c] - c1[o]) / c
            if env is not None:
                d = np.maximum(np.maximum(blk - hi_blk[None, :],
                                          lo_blk[None, :] - blk), 0.0)
            else:
                d = blk - qb[None, :]
            lb[s: s + CHUNK] = c * np.einsum("ij,ij->i", d, d)
        return offsets[lb <= thresh * (1.0 + 1e-9) + 1e-9]

    def _host_ed_prefilter_tier(self, cand_ivs, ctxs):
        """Host-only mid-size loads: run-local PAA lower bound prunes the
        load to what the exact f64 kernel can verify; None when the load is
        outside the tier (QueryConfig.host_prefilter_max_offsets) or too
        many candidates survive."""
        L = ctxs[0].length
        pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=False)
        if pre is None:
            return None
        c1 = pre[0]
        surv = []
        for (l, r), c in zip(cand_ivs, ctxs):
            offs = iv.expand_offsets({"left": l, "right": r})
            c.stats.n_host_checked = int(offs.size)
            surv.append(self._paa_prefilter(offs, c, c.eps2, prefix=c1))
        if sum(o.size for o in surv) * L > self.qcfg.host_confirm_max_points:
            return None  # falls through to the streamed-path skip error
        return [self._confirm_ed(o, c) for o, c in zip(surv, ctxs)]

    def _verify_multi(self, cand_ivs, ctxs):
        """Fused multi-query verification.  Clustered candidate sets go through
        the region path (batched FFT sliding correlation, ops/regions.py); scattered
        ones through the per-candidate gather kernel."""
        L = ctxs[0].length
        if self._host_verify_ok(cand_ivs, L):
            # Tiny load: exact f64 host kernel beats a device launch's fixed cost
            # (see QueryConfig.host_verify_max_points).  PAA prefilter first —
            # it needs only prefix sums, no window gather.  Past
            # PREFILTER_CUMSUM_MAX_N the full-series cumsum is unaffordable
            # (80 GB at n=1e10); run-local views keep the prefilter live.
            prefix = None
            if self.n > self.PREFILTER_CUMSUM_MAX_N:
                pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=False)
                prefix = pre[0] if pre is not None else None
            paa_ok = prefix is not None or self.n <= self.PREFILTER_CUMSUM_MAX_N
            out = []
            for (l, r), c in zip(cand_ivs, ctxs):
                offs = iv.expand_offsets({"left": l, "right": r})
                c.stats.n_host_checked = int(offs.size)
                if paa_ok:
                    offs = self._paa_prefilter(offs, c, c.eps2, prefix=prefix)
                out.append(self._confirm_ed(offs, c))
            return out
        if getattr(self, "host_only", False):
            tier = self._host_ed_prefilter_tier(cand_ivs, ctxs)
            if tier is not None:
                return tier
        if self.data_dev is None:
            return self._verify_multi_streamed(cand_ivs, ctxs)
        import jax.numpy as jnp
        threshs = np.array([c.eps2 + vf.guard_threshold(c.eps2, L, self.qcfg.verify_guard)
                            for c in ctxs])
        for (l, r), ctx in zip(cand_ivs, ctxs):
            ctx.stats.n_device_checked = int(np.sum(r - l + 1)) if l.size else 0
        region = self._region_plan(cand_ivs, L)
        data_dev = self.data_dev

        if region is not None:
            import logging
            import time as _t
            logger = logging.getLogger("kvmatch_tpu")
            from ..ops.regions import (region_ed_distances_multi,
                                       region_ed_near_multi)
            starts, vfrom, vto, qids, M = region
            c = np.float32(self._data_center())
            qm = jnp.asarray(np.stack([ctx.query for ctx in ctxs]) - float(c),
                             jnp.float32)
            th_dev = jnp.asarray(threshs, jnp.float32)
            NEAR_K = 16384
            t0 = _t.perf_counter()
            near = vf.run_region_near(
                lambda s_, q_, vf_, vt_: region_ed_near_multi(
                    data_dev, qm, s_, q_, vf_, vt_, th_dev, L, M, NEAR_K, c),
                starts, vfrom, vto, qids, NEAR_K, width=M + L - 1)
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug("region near path: %d regions, %.2fs, overflow=%s",
                             starts.size, _t.perf_counter() - t0, near is None)
            if near is not None:
                near_off, near_qid = near
                return [self._confirm_ed(np.sort(near_off[near_qid == qi]), ctx)
                        for qi, ctx in enumerate(ctxs)]
            # Overflowed the on-device near cap: full-matrix fallback.
            d2, err = vf.run_bucketed(
                lambda s_, q_: region_ed_distances_multi(
                    data_dev, qm, s_, q_, L, M, c),
                starts.size, starts.astype(np.int32), qids, lo=32, hi=2048,
                width=M + L - 1)
            col = np.arange(M)[None, :]
            nearm = ((col >= vfrom[:, None]) & (col < vto[:, None]) &
                     (d2 <= threshs[qids][:, None] + err))
            rows, cols = np.nonzero(nearm)
            near_off = starts[rows] + cols
            near_qid = qids[rows]
            return [self._confirm_ed(np.sort(near_off[near_qid == qi]), ctx)
                    for qi, ctx in enumerate(ctxs)]

        # Scattered: PAA prefilter (no gather), then the gather kernel over the
        # concatenated survivor offsets.
        from ..ops.ed import ed_distances_multi
        cand_offs = [self._paa_prefilter(
            iv.expand_offsets({"left": l, "right": r}), c, float(th))
            for (l, r), c, th in zip(cand_ivs, ctxs, threshs)]
        counts = [o.size for o in cand_offs]
        total = int(sum(counts))
        if total == 0:
            return [(np.empty(0, np.int64), np.empty(0)) for _ in ctxs]
        offsets = np.concatenate(cand_offs)
        qids = np.repeat(np.arange(len(ctxs), dtype=np.int32), counts)
        qm = jnp.asarray(np.stack([c.query for c in ctxs]), jnp.float32)
        d2 = vf.run_bucketed(
            lambda o, q: ed_distances_multi(data_dev, qm, o, q, L),
            total, offsets.astype(np.int32), qids,
            lo=self.qcfg.verify_batch, width=L)
        results = []
        start = 0
        for qi, ctx in enumerate(ctxs):
            cnt = counts[qi]
            d2_q = d2[start:start + cnt]
            near = cand_offs[qi][d2_q <= threshs[qi]]
            start += cnt
            results.append(self._confirm_ed(near, ctx))
        return results

    def _verify(self, offsets: np.ndarray, ctx: _Ctx) -> Tuple[np.ndarray, np.ndarray]:
        import jax.numpy as jnp
        q32 = jnp.asarray(ctx.query, jnp.float32)
        kernel = self._kernel(ctx.length)
        d2 = vf.device_distances(offsets, self.qcfg.verify_batch,
                                 lambda o: kernel(q32, o), width=ctx.length)
        ctx.stats.n_device_checked = int(offsets.size)
        thresh = ctx.eps2 + vf.guard_threshold(ctx.eps2, ctx.length, self.qcfg.verify_guard)
        near = offsets[d2 <= thresh]
        return self._confirm_ed(near, ctx)
