"""cNSM-DTW engine: constrained normalized matching under banded DTW.

Device-native equivalent of the reference NormQueryEngineDtw
(NormQueryEngineDtw.java:44-1065) — the union of the cNSM machinery
(alpha/beta probe bounds, Ex/Ex2 std-filter, beta partitions) and the DTW
machinery (envelope segments, LB cascade, banded DP on z-normalized windows).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.dtw import dtw_banded_batch_f64
from ..plan import envelope, unit_sums
from .. import verify as vf
from .base import _Ctx
from .norm_ed import NormQueryEngine


class NormQueryEngineDtw(NormQueryEngine):

    # ---------------------------------------------------------------- phase 0
    def _plan_inputs(self, ctx: _Ctx):
        q = ctx.query
        mu_q = float(q.mean())
        sd_q = float(np.sqrt(max(np.mean(q * q) - mu_q * mu_q, 0.0)))
        if sd_q == 0.0:
            raise ValueError(
                "query has zero standard deviation: z-normalized matching is "
                "undefined for a constant pattern")
        ctx.params["_mu_q"], ctx.params["_sd_q"] = mu_q, sd_q
        rho = ctx.params["rho"]
        env_lo, env_hi = envelope(q, rho)
        return (unit_sums(env_lo, self.icfg.unit),
                unit_sums(env_hi, self.icfg.unit), self._cost_batch(ctx))

    # ---------------------------------------------------------------- phase 2
    def _verify_multi(self, cand_ivs, ctxs):
        """Fused multi-query cNSM-DTW: exact host constraint prefilter, then
        z-normalized LB cascade + banded DP with per-candidate query rows."""
        from ..utils import intervals as iv
        if getattr(self, "host_only", False):
            if self._host_verify_ok(cand_ivs, ctxs[0].length):
                # Host-only tiny loads: _confirm_dtw IS the exact pipeline
                # (window stats + constraints + early-abandoning f64 z-DP).
                out = []
                for (l, r), c in zip(cand_ivs, ctxs):
                    offs = iv.expand_offsets({"left": l, "right": r})
                    c.stats.n_host_checked = int(offs.size)
                    o, d = self._confirm_dtw(offs, c)
                    order = np.argsort(o)
                    out.append((o[order], d[order]))
                return out
            tier = self._host_zdtw_prefilter_tier(cand_ivs, ctxs)
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
            offs0 = self._constraint_prefilter(
                iv.expand_offsets({"left": l, "right": r}), c)
            # PAA z-envelope bound (no gather): block means of the z-query's
            # Sakoe-Chiba envelope lower-bound banded z-DTW per block.
            zq = (c.query - c.params["_mu_q"]) / c.params["_sd_q"]
            e_lo, e_hi = envelope(zq, c.params["rho"])
            blocks = 16
            cw = L // blocks
            if cw >= 4:
                nblk = L // cw
                env_blk = (e_lo[: nblk * cw].reshape(nblk, cw).mean(axis=1),
                           e_hi[: nblk * cw].reshape(nblk, cw).mean(axis=1))
                offs0 = self._paa_z_prefilter(offs0, c, float(th), env=env_blk)
            cand_offs.append(offs0)
        counts = [o.size for o in cand_offs]
        total = int(sum(counts))
        if total == 0:
            return [(np.empty(0, np.int64), np.empty(0)) for _ in ctxs]
        offsets = np.concatenate(cand_offs)
        qids = np.repeat(np.arange(len(ctxs), dtype=np.int32), counts)
        zqs = np.stack([(c.query - c.params["_mu_q"]) / c.params["_sd_q"]
                        for c in ctxs])
        envs = [envelope(z, rho) for z in zqs]
        zq_m = jnp.asarray(zqs, jnp.float32)
        lo_m = jnp.asarray(np.stack([e[0] for e in envs]), jnp.float32)
        hi_m = jnp.asarray(np.stack([e[1] for e in envs]), jnp.float32)
        data_dev = self.data_dev
        threshs = np.array([c.eps2 + vf.guard_threshold(c.eps2, L, self.qcfg.verify_guard)
                            for c in ctxs])

        from ..ops.dtw import dtw_stage_znorm_multi, lb_stage_znorm_multi
        if total <= self.qcfg.dtw_skip_lb_max:
            # Tiny set: the z-DP on everything is cheaper than the LB launch
            # that would prune it (QueryConfig.dtw_skip_lb_max; the alpha/beta
            # constraints were already applied by _constraint_prefilter above).
            s_off, s_qid = offsets, qids
        else:
            cons = jnp.asarray(np.stack(
                [[c.params["alpha"], c.params["beta"], c.params["_mu_q"],
                  c.params["_sd_q"],
                  1e-3 * (1.0 + abs(c.params["_mu_q"]) + c.params["_sd_q"])]
                 for c in ctxs]), jnp.float32)
            env_lo, env_hi = self.data_envelope_dev(rho)
            lb = vf.run_bucketed(
                lambda o, q: lb_stage_znorm_multi(data_dev, env_lo, env_hi,
                                                  zq_m, lo_m, hi_m, cons, o,
                                                  q, L),
                total, offsets.astype(np.int32), qids,
                lo=self.qcfg.verify_batch, width=L)
            surv = lb <= threshs[qids]
            s_off, s_qid = offsets[surv], qids[surv]
        per_q = [(np.empty(0, np.int64), np.empty(0)) for _ in ctxs]
        for c, cnt in zip(ctxs, counts):
            c.stats.n_device_checked = cnt
        if s_off.size:
            d2 = vf.run_bucketed(
                lambda o, q: dtw_stage_znorm_multi(data_dev, zq_m, o, q, L, rho),
                s_off.size, s_off.astype(np.int32),
                s_qid, lo=min(self.qcfg.verify_batch, 1024), width=L)
            near_mask = d2 <= threshs[s_qid]
            n_off, n_qid = s_off[near_mask], s_qid[near_mask]
            # Double-single device confirm (see rsm_dtw._verify_multi): the
            # near-threshold set gets ONE batched near-exact device DP instead
            # of ~28 ms/candidate of host f64 DP — the round-2 cNSM-DTW wall.
            # Candidates must also clear the alpha/beta constraints by more
            # than the prefix-sum error margin to be accepted without the
            # exact host pass (_confirm_dtw recomputes stats per window).
            acc_m = bor_m = None
            d2ds = mu64 = sd64 = None
            if n_off.size:
                from ..ops.dtw import ds_value, dtw_stage_znorm_ds_multi
                c1, c2 = self._cumsums()
                s1 = c1[n_off + L] - c1[n_off]
                mu64 = s1 / L
                var64 = np.maximum((c2[n_off + L] - c2[n_off]) / L
                                   - mu64 * mu64, 0.0)
                sd64 = np.sqrt(var64)
                safe64 = np.where(sd64 > 0, sd64, 1.0)
                hi, lo_, amp = vf.run_bucketed(
                    lambda o, q, m, s: dtw_stage_znorm_ds_multi(
                        data_dev, zq_m, o, q, m, s, L, rho),
                    n_off.size, n_off.astype(np.int32), n_qid,
                    mu64.astype(np.float32), safe64.astype(np.float32),
                    lo=min(self.qcfg.verify_batch, 1024), width=2 * L)
                d2ds = ds_value(hi, lo_)
                zqmax = np.array([float(np.abs(z).max()) for z in zqs])
                g = vf.ds_guard(d2ds, L, amp.astype(np.float64)
                                + zqmax[n_qid] + 1.0)
                eps2s = np.array([c.eps2 for c in ctxs])[n_qid]
                # constraint clearance: margin covers prefix-sum rounding
                # (|err| <= ~4 eps64 |c1[o+L]| / L on the mean, analogous on
                # the variance) so a clear pass here implies the exact
                # window-recomputed stats pass too
                alphas = np.array([c.params["alpha"] for c in ctxs])[n_qid]
                betas = np.array([c.params["beta"] for c in ctxs])[n_qid]
                mu_qs = np.array([c.params["_mu_q"] for c in ctxs])[n_qid]
                sd_qs = np.array([c.params["_sd_q"] for c in ctxs])[n_qid]
                eps64 = np.finfo(np.float64).eps
                m_mu = 8.0 * eps64 * np.abs(c1[n_off + L]) / L + 1e-12
                m_sd = (8.0 * eps64 * np.abs(c2[n_off + L]) / L
                        / (2.0 * safe64) + 1e-12)
                cons_clear = ((np.abs(mu64 - mu_qs) <= betas - m_mu)
                              & (sd64 <= alphas * sd_qs - m_sd)
                              & (sd64 >= sd_qs / alphas + m_sd)
                              & (sd64 > 0))
                cons_border = (~cons_clear
                               & (np.abs(mu64 - mu_qs) <= betas + m_mu)
                               & (sd64 <= alphas * sd_qs + m_sd)
                               & (sd64 >= sd_qs / alphas - m_sd)
                               & (sd64 > 0))
                d_acc = d2ds <= eps2s - g
                d_bor = ~d_acc & (d2ds <= eps2s + g)
                acc_m = cons_clear & d_acc
                bor_m = (cons_border & (d_acc | d_bor)) | (cons_clear & d_bor)
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
                    parts.append(self._confirm_dtw(border, ctx))
                offs_q = np.concatenate([p[0] for p in parts])
                dist_q = np.concatenate([p[1] for p in parts])
                order = np.argsort(offs_q)
                per_q[qi] = (offs_q[order], dist_q[order])
        return per_q

    def _host_zdtw_prefilter_tier(self, cand_ivs, ctxs):
        """Host-only mid-size loads: run-local constraint prefilter (two
        prefix lookups/offset) + z-space PAA envelope bound prune the load
        to what the exact f64 pipeline can verify; None when the load is
        outside the tier or too many candidates survive."""
        from ..utils import intervals as iv
        L = ctxs[0].length
        pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=True)
        if pre is None:
            return None
        surv = []
        for (l, r), c in zip(cand_ivs, ctxs):
            offs = iv.expand_offsets({"left": l, "right": r})
            c.stats.n_host_checked = int(offs.size)
            offs = self._constraint_prefilter(offs, c, prefix=pre)
            blocks = 16
            cw = L // blocks
            if cw >= 4 and offs.size:
                nblk = L // cw
                zq = (c.query - c.params["_mu_q"]) / c.params["_sd_q"]
                e_lo, e_hi = envelope(zq, c.params["rho"])
                env_blk = (e_lo[: nblk * cw].reshape(nblk, cw).mean(axis=1),
                           e_hi[: nblk * cw].reshape(nblk, cw).mean(axis=1))
                offs = self._paa_z_prefilter(offs, c, c.eps2,
                                             env=env_blk, prefix=pre)
            surv.append(offs)
        if sum(o.size for o in surv) * L > self.qcfg.host_confirm_max_points:
            return None  # falls through to the streamed-path skip error
        out = []
        for offs, c in zip(surv, ctxs):
            o, d = self._confirm_dtw(offs, c)
            order = np.argsort(o)
            out.append((o[order], d[order]))
        return out

    def _confirm_dtw(self, near: np.ndarray, ctx: _Ctx):
        """Exact float64 confirmation: constraints + banded DTW on z-normed
        windows (chunked — see BaseEngine._chunked_confirm)."""
        rho = ctx.params["rho"]
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        L = ctx.length
        zq = (ctx.query - mu_q) / sd_q
        cols = np.arange(L)

        def piece(p):
            x = self.data[p[:, None] + cols[None, :]].astype(
                np.float64, copy=False)
            mu_h = x.mean(axis=1)
            var_h = np.maximum(np.mean(x * x, axis=1) - mu_h * mu_h, 0.0)
            sd_h = np.sqrt(var_h)
            ratio_h = sd_h / sd_q
            ok_h = (np.abs(mu_h - mu_q) <= beta) & (ratio_h <= alpha) & \
                   (ratio_h >= 1.0 / alpha) & (sd_h > 0)
            z = (x - mu_h[:, None]) / np.where(sd_h > 0, sd_h, 1.0)[:, None]
            d2h = dtw_banded_batch_f64(z, zq, rho, ub=ctx.eps2)
            keep = ok_h & (d2h <= ctx.eps2)
            return p[keep], np.sqrt(d2h[keep])

        return self._chunked_confirm(near, piece)

    def _verify(self, offsets: np.ndarray, ctx: _Ctx) -> Tuple[np.ndarray, np.ndarray]:
        """Single query = batch of one through the fused multi-query stages."""
        if offsets.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        runs = np.flatnonzero(np.diff(offsets) > 1)
        left = offsets[np.concatenate(([0], runs + 1))]
        right = offsets[np.concatenate((runs, [offsets.size - 1]))]
        return self._verify_multi([(left, right)], [ctx])[0]
