"""RSM-DTW engine: raw-subsequence matching under banded dynamic time warping.

Device-native equivalent of the reference QueryEngineDtw (QueryEngineDtw.java:44-854).
Phase 0/1 reuse the RSM-ED machinery with the query's Lemire envelope as the
per-segment mean *range* (RangeQuerySegment, QueryEngineDtw.java:515-644); phase 2
is the batched LB cascade + banded-DTW kernel (ops/dtw.py) with exact float64
confirmation of near-threshold survivors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.dtw import dtw_banded_batch_f64
from ..plan import QuerySegment, envelope, unit_sums
from .. import verify as vf
from .base import _Ctx
from .rsm_ed import QueryEngine


class QueryEngineDtw(QueryEngine):
    use_dtw_cost_model = True

    # ---------------------------------------------------------------- phase 0
    def _plan_inputs(self, ctx: _Ctx):
        rho = ctx.params["rho"]
        env_lo, env_hi = envelope(ctx.query, rho)
        return (unit_sums(env_lo, self.icfg.unit),
                unit_sums(env_hi, self.icfg.unit), self._cost_batch(ctx))

    # ---------------------------------------------------------------- phase 1
    def _probe_rows_eps(self, seg: QuerySegment, ctx: _Ctx):
        # Reset guard: a stale minimum epsilon above the budget would produce a
        # negative range (QueryEngineDtw.java:210).  Placed here so both the
        # scan and the fused join paths get it.
        if ctx.last_min_eps > ctx.eps2:
            ctx.last_min_eps = 0.0
        return super()._probe_rows_eps(seg, ctx)

    # ---------------------------------------------------------------- phase 2
    def _host_verify_dtw(self, offsets: np.ndarray, ctx: _Ctx):
        """Exact host verification (host-only mode): f64 query-envelope
        LB_Keogh prefilter, then the early-abandoning f64 banded DP — no
        device at all.  Numpy on one core is far slower per candidate than
        the device cascade, so this route is gated to host_only engines with
        tiny loads (series larger than device memory)."""
        ctx.stats.n_host_checked = int(offsets.size)
        if offsets.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        rho = ctx.params["rho"]
        L = ctx.length
        lo, hi = envelope(ctx.query, rho)
        cols = np.arange(L)

        def piece(p):
            x = self.data[p[:, None] + cols[None, :]].astype(
                np.float64, copy=False)
            exc = np.maximum(np.maximum(x - hi[None, :], lo[None, :] - x), 0.0)
            lb = np.einsum("ij,ij->i", exc, exc)
            keep = lb <= ctx.eps2 * (1.0 + 1e-9) + 1e-9
            d2 = np.full(p.size, np.inf)
            if keep.any():
                d2[keep] = dtw_banded_batch_f64(x[keep], ctx.query, rho,
                                                ub=ctx.eps2)
            ans = d2 <= ctx.eps2
            return p[ans], np.sqrt(d2[ans])

        return self._chunked_confirm(offsets, piece)

    def _host_dtw_prefilter_tier(self, cand_ivs, ctxs):
        """Host-only mid-size loads: run-local PAA envelope bound (valid for
        banded DTW — the lbPaaDTW argument, PaaUcrDtwQueryExecutor.java:413)
        prunes the load to what the exact f64 route can verify; None when
        the load is outside the tier or too many candidates survive."""
        from ..utils import intervals as iv
        L = ctxs[0].length
        pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=False)
        if pre is None:
            return None
        c1 = pre[0]
        surv = []
        for (l, r), c in zip(cand_ivs, ctxs):
            offs = iv.expand_offsets({"left": l, "right": r})
            blocks = 16
            cw = L // blocks
            if cw >= 4 and offs.size:
                nblk = L // cw
                e_lo, e_hi = envelope(c.query, c.params["rho"])
                env_blk = (e_lo[: nblk * cw].reshape(nblk, cw).mean(axis=1),
                           e_hi[: nblk * cw].reshape(nblk, cw).mean(axis=1))
                offs = self._paa_prefilter(offs, c, float(c.eps2),
                                           env=env_blk, prefix=c1)
            surv.append(offs)
        if sum(o.size for o in surv) * L > self.qcfg.host_confirm_max_points:
            return None  # falls through to the streamed-path skip error
        return [self._host_verify_dtw(o, c) for o, c in zip(surv, ctxs)]

    def _verify_multi(self, cand_ivs, ctxs):
        """Fused multi-query DTW verification: LB cascade then banded DP, with
        per-candidate query rows so one launch stream serves the whole batch."""
        from ..utils import intervals as iv
        if getattr(self, "host_only", False):
            if self._host_verify_ok(cand_ivs, ctxs[0].length):
                return [self._host_verify_dtw(
                    iv.expand_offsets({"left": l, "right": r}), c)
                    for (l, r), c in zip(cand_ivs, ctxs)]
            tier = self._host_dtw_prefilter_tier(cand_ivs, ctxs)
            if tier is not None:
                return tier
        if self.data_dev is None:
            return self._verify_multi_streamed(cand_ivs, ctxs)
        import jax.numpy as jnp

        L = ctxs[0].length
        rho = ctxs[0].params["rho"]
        threshs0 = [c.eps2 + vf.guard_threshold(c.eps2, L, self.qcfg.verify_guard)
                    for c in ctxs]
        cand_offs = []
        for (l, r), c, th in zip(cand_ivs, ctxs, threshs0):
            offs0 = iv.expand_offsets({"left": l, "right": r})
            e_lo, e_hi = envelope(c.query, rho)
            blocks = 16
            cw = L // blocks
            if cw >= 4:
                nblk = L // cw
                env_blk = (e_lo[: nblk * cw].reshape(nblk, cw).mean(axis=1),
                           e_hi[: nblk * cw].reshape(nblk, cw).mean(axis=1))
                offs0 = self._paa_prefilter(offs0, c, float(th), env=env_blk)
            cand_offs.append(offs0)
        counts = [o.size for o in cand_offs]
        total = int(sum(counts))
        if total == 0:
            return [(np.empty(0, np.int64), np.empty(0)) for _ in ctxs]
        offsets = np.concatenate(cand_offs)
        qids = np.repeat(np.arange(len(ctxs), dtype=np.int32), counts)
        qm = jnp.asarray(np.stack([c.query for c in ctxs]), jnp.float32)
        envs = [envelope(c.query, rho) for c in ctxs]
        lo_m = jnp.asarray(np.stack([e[0] for e in envs]), jnp.float32)
        hi_m = jnp.asarray(np.stack([e[1] for e in envs]), jnp.float32)
        data_dev = self.data_dev
        threshs = np.array([c.eps2 + vf.guard_threshold(c.eps2, L, self.qcfg.verify_guard)
                            for c in ctxs])

        from ..ops.dtw import dtw_stage_multi, lb_stage_multi
        if total <= self.qcfg.dtw_skip_lb_max:
            # Tiny set: the DP on everything is cheaper than the LB launch
            # that would prune it (QueryConfig.dtw_skip_lb_max).
            s_off, s_qid = offsets, qids
        else:
            env_lo, env_hi = self.data_envelope_dev(rho)
            lb = vf.run_bucketed(
                lambda o, q: lb_stage_multi(data_dev, env_lo, env_hi, qm, lo_m,
                                            hi_m, o, q, L),
                total, offsets.astype(np.int32), qids,
                lo=self.qcfg.verify_batch, width=L)
            surv = lb <= threshs[qids]
            s_off, s_qid = offsets[surv], qids[surv]
        per_q = [(np.empty(0, np.int64), np.empty(0)) for _ in ctxs]
        for c, cnt in zip(ctxs, counts):
            c.stats.n_device_checked = cnt
        if s_off.size:
            d2 = vf.run_bucketed(
                lambda o, q: dtw_stage_multi(data_dev, qm, o, q, L, rho),
                s_off.size, s_off.astype(np.int32),
                s_qid, lo=min(self.qcfg.verify_batch, 1024), width=L)
            near_mask = d2 <= threshs[s_qid]
            n_off, n_qid = s_off[near_mask], s_qid[near_mask]
            cols = np.arange(L)
            # Double-single device confirm of the near-threshold set: one
            # batched launch replaces the per-candidate host f64 DP that was
            # the round-2 cNSM/RSM-DTW wall.  Only candidates inside the
            # (rigorously bounded, tests/test_dtw_guard.py) +-ds_guard band
            # around eps^2 still go to the exact host pass.
            acc_m = bor_m = None
            if n_off.size:
                from ..ops.dtw import ds_value, dtw_stage_ds_multi
                hi, lo_, amax = vf.run_bucketed(
                    lambda o, q: dtw_stage_ds_multi(data_dev, qm, o, q, L, rho),
                    n_off.size, n_off.astype(np.int32), n_qid,
                    lo=min(self.qcfg.verify_batch, 1024), width=2 * L)
                d2ds = ds_value(hi, lo_)
                qmax = np.array([float(np.abs(c.query).max()) for c in ctxs])
                g = vf.ds_guard(d2ds, L, amax.astype(np.float64)
                                + qmax[n_qid] + 1.0)
                eps2s = np.array([c.eps2 for c in ctxs])[n_qid]
                acc_m = d2ds <= eps2s - g
                bor_m = ~acc_m & (d2ds <= eps2s + g)
            for qi, ctx in enumerate(ctxs):
                mine = n_qid == qi
                if not mine.any():
                    ctx.stats.n_host_rechecked = 0
                    continue
                acc = n_off[mine & acc_m]
                border = n_off[mine & bor_m]
                ctx.stats.n_host_rechecked = int(border.size)
                parts = [(acc, np.sqrt(np.maximum(d2ds[mine & acc_m], 0.0)))]
                if border.size:
                    def piece(p, ctx=ctx):
                        d2h = dtw_banded_batch_f64(
                            self.data[p[:, None] + cols[None, :]].astype(
                                np.float64, copy=False), ctx.query,
                            rho, ub=ctx.eps2)
                        keep = d2h <= ctx.eps2
                        return p[keep], np.sqrt(d2h[keep])
                    parts.append(self._chunked_confirm(border, piece))
                offs_q = np.concatenate([p[0] for p in parts])
                dist_q = np.concatenate([p[1] for p in parts])
                order = np.argsort(offs_q)
                per_q[qi] = (offs_q[order], dist_q[order])
        return per_q

    def _verify(self, offsets: np.ndarray, ctx: _Ctx) -> Tuple[np.ndarray, np.ndarray]:
        """Single query = batch of one through the fused multi-query stages (the
        module-level jits keep the compile cache shape-keyed)."""
        runs = np.flatnonzero(np.diff(offsets) > 1)
        left = offsets[np.concatenate(([0], runs + 1))]
        right = offsets[np.concatenate((runs, [offsets.size - 1]))]
        return self._verify_multi([(left, right)], [ctx])[0]
