"""Index-free full-scan baselines — the UCR-suite executors, batched on the device.

Equivalents of the reference's baseline drivers (experiments/ucr/
UcrEdQueryExecutor.java:29-184, UcrDtwQueryExecutor.java:31-315,
PaaUcrEdQueryExecutor.java:29-257, PaaUcrDtwQueryExecutor.java:30-448): scan
EVERY window of the series with no index, used to measure what the KV-index
buys.  The reference streams windows through scalar early-abandon loops; here the
scan is the region machinery of ops/regions.py applied to one region covering the
whole series — sliding FFT correlation + sliding sums at HBM bandwidth, an exact
float64 confirmation of near-threshold offsets, and (for DTW) the LB_Kim/LB_Keogh
cascade as the window prefilter.

``paa_prefilter`` adds the PAA lower bound of the Paa* executors
(PaaUcrEdQueryExecutor.java:104-120): with PAA segment width c, per-window
lb = c * sum_k max(|paa_T[k] - paa_Q[k]| , 0)^2 <= ED^2 — computed from the same
sliding sums, it prunes windows before any correlation work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import QueryConfig
from . import verify as vf


@dataclasses.dataclass
class ScanStats:
    n_windows: int = 0
    n_after_paa: int = 0
    n_near: int = 0
    n_answers: int = 0


class UcrScanner:
    """Full-scan matcher over a series held on device (and float64 on host)."""

    REGION_M = 4096

    def __init__(self, data: np.ndarray, device_data=None,
                 qcfg: QueryConfig = QueryConfig()):
        import jax.numpy as jnp
        self.data = np.ascontiguousarray(np.asarray(data, np.float64))
        self.n = self.data.size
        self.qcfg = qcfg
        self.data_dev = device_data if device_data is not None \
            else jnp.asarray(self.data, jnp.float32)
        self._center = float(self.data.mean())

    # ------------------------------------------------------------------ ED
    def scan_ed(self, query: np.ndarray, epsilon: float,
                stats: Optional[ScanStats] = None) -> Tuple[np.ndarray, np.ndarray]:
        """RSM-ED over every window (UcrEdQueryExecutor equivalent)."""
        from .ops.regions import region_ed_distances
        import jax.numpy as jnp
        query = np.asarray(query, np.float64)
        L = query.size
        m = self.n - L + 1
        M = self.REGION_M
        starts = np.arange(0, m, M, dtype=np.int64)
        starts_c = np.minimum(starts, self.n - (M + L - 1))
        q32 = jnp.asarray(query - self._center, jnp.float32)
        c = np.float32(self._center)
        eps2 = float(epsilon) ** 2
        thresh = eps2 + vf.guard_threshold(eps2, L, self.qcfg.verify_guard)

        near_all = []
        d2, err = vf.run_bucketed(
            lambda s_: region_ed_distances(self.data_dev, q32, s_, L, M, c),
            starts_c.size, starts_c.astype(np.int32), lo=8, hi=512)
        for b, (s0, sc) in enumerate(zip(starts, starts_c)):
            a = s0 - sc
            e = min(s0 + M, m) - sc
            row = d2[b, a:e]
            near = np.flatnonzero(row <= thresh + err[b, a:e]) + sc + a
            near_all.append(near)
        near = np.concatenate(near_all) if near_all else np.empty(0, np.int64)
        if stats is not None:
            stats.n_windows = m
            stats.n_near = int(near.size)
        return self._confirm_ed(near, query, eps2, stats)

    def scan_nsm_ed(self, query: np.ndarray, epsilon: float,
                    alpha: Optional[float] = None, beta: Optional[float] = None,
                    stats: Optional[ScanStats] = None):
        """NSM/cNSM-ED over every window (UcrEdQueryExecutor with the constraint
        test, UcrEdQueryExecutor.java:161)."""
        from .ops.regions import region_znorm_distances
        import jax.numpy as jnp
        query = np.asarray(query, np.float64)
        L = query.size
        m = self.n - L + 1
        M = self.REGION_M
        mu_q = query.mean()
        sd_q = float(np.sqrt(max(np.mean(query * query) - mu_q * mu_q, 0.0)))
        qh = (query - mu_q) / sd_q
        starts = np.arange(0, m, M, dtype=np.int64)
        starts_c = np.minimum(starts, self.n - (M + L - 1))
        q32 = jnp.asarray(qh, jnp.float32)
        eps2 = float(epsilon) ** 2
        thresh = eps2 + vf.guard_threshold(eps2, L, self.qcfg.verify_guard)
        out = vf.run_bucketed(
            lambda s_: region_znorm_distances(self.data_dev, q32, s_, L, M),
            starts_c.size, starts_c.astype(np.int32), lo=8, hi=512)
        d2, mu, sd = out[0], out[1], out[2]
        cg = 1e-3 * (1.0 + abs(mu_q) + sd_q)
        near_all = []
        for b, (s0, sc) in enumerate(zip(starts, starts_c)):
            a = s0 - sc
            e = min(s0 + M, m) - sc
            ok = np.ones(e - a, bool)
            if alpha is not None:
                ratio = sd[b, a:e] / sd_q
                ok = (np.abs(mu[b, a:e] - mu_q) <= beta + cg) & \
                     (ratio <= alpha + cg) & (ratio >= 1.0 / alpha - cg)
            ok &= sd[b, a:e] > 0
            mass_err = 1e-3 * (1.0 + eps2)
            near = np.flatnonzero(ok & (d2[b, a:e] <= thresh + mass_err)) + sc + a
            near_all.append(near)
        near = np.concatenate(near_all) if near_all else np.empty(0, np.int64)
        if stats is not None:
            stats.n_windows = m
            stats.n_near = int(near.size)
        return self._confirm_znorm(near, query, qh, mu_q, sd_q, eps2,
                                   alpha, beta, stats)

    # ------------------------------------------------------------------ DTW
    def scan_dtw(self, query: np.ndarray, epsilon: float, rho: int,
                 paa_prefilter: bool = True,
                 stats: Optional[ScanStats] = None):
        """RSM-DTW over every window (UcrDtwQueryExecutor equivalent):
        PAA + LB_Keogh/LB_Kim prefilters, banded DP on survivors."""
        import jax.numpy as jnp
        from .ops.dtw import dtw_banded_batch_f64
        from .plan import envelope
        query = np.asarray(query, np.float64)
        L = query.size
        m = self.n - L + 1
        eps2 = float(epsilon) ** 2
        thresh = eps2 + vf.guard_threshold(eps2, L, self.qcfg.verify_guard)

        cand = np.arange(m, dtype=np.int64)
        if paa_prefilter:
            cand = cand[self._lb_paa_dtw(query, eps2, rho) <= thresh]
        if stats is not None:
            stats.n_windows = m
            stats.n_after_paa = int(cand.size)
        if cand.size == 0:
            return np.empty(0, np.int64), np.empty(0)

        from .ops.dtw import dtw_stage_multi, lb_stage_multi
        from .ops.sliding import sliding_min_max
        import jax
        env_lo, env_hi = envelope(query, rho)
        qm = jnp.asarray(query[None, :], jnp.float32)
        lo_m = jnp.asarray(env_lo[None, :], jnp.float32)
        hi_m = jnp.asarray(env_hi[None, :], jnp.float32)
        data_dev = self.data_dev
        d_lo, d_hi = jax.jit(sliding_min_max, static_argnums=1)(data_dev, rho)

        lb = vf.run_bucketed(
            lambda o: lb_stage_multi(data_dev, d_lo, d_hi, qm, lo_m, hi_m, o,
                                     jnp.zeros(o.shape, jnp.int32), L),
            cand.size, cand.astype(np.int32), lo=1024)
        surv = cand[lb <= thresh]
        if surv.size == 0:
            return np.empty(0, np.int64), np.empty(0)

        d2 = vf.run_bucketed(
            lambda o: dtw_stage_multi(data_dev, qm, o,
                                      jnp.zeros(o.shape, jnp.int32), L, rho),
            surv.size, surv.astype(np.int32), lo=1024)
        near = surv[d2 <= thresh]
        if stats is not None:
            stats.n_near = int(near.size)
        if near.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        idx = near[:, None] + np.arange(L)[None, :]
        d2h = dtw_banded_batch_f64(self.data[idx], query, rho)
        keep = d2h <= eps2
        if stats is not None:
            stats.n_answers = int(keep.sum())
        order = np.argsort(d2h[keep])
        return near[keep][order], np.sqrt(d2h[keep][order])

    # ------------------------------------------------------------------ PAA
    def _paa_sums(self, width: int) -> np.ndarray:
        """Sliding PAA block sums from host float64 cumsums."""
        if not hasattr(self, "_c1"):
            self._c1 = np.concatenate(([0.0], np.cumsum(self.data)))
        return self._c1

    def _lb_paa_dtw(self, query: np.ndarray, eps2: float, rho: int,
                    segments: int = 16) -> np.ndarray:
        """PAA-domain lower bound for banded DTW over every window
        (PaaUcrDtwQueryExecutor.lbPaaDTW idea, PaaUcrDtwQueryExecutor.java:413):
        per PAA block, distance from the window's block mean to the query's
        *enveloped* block mean range, times the block width."""
        from .plan import envelope
        L = query.size
        m = self.n - L + 1
        c = max(L // segments, 1)
        k = L // c  # whole blocks only
        c1 = self._paa_sums(c)
        env_lo, env_hi = envelope(query, rho)
        lb = np.zeros(m)
        for blk in range(k):
            s = blk * c
            q_lo = env_lo[s:s + c].mean()
            q_hi = env_hi[s:s + c].mean()
            t_mean = (c1[s + c:s + c + m] - c1[s:s + m]) / c
            delta = np.maximum(np.maximum(t_mean - q_hi, q_lo - t_mean), 0.0)
            lb += c * delta * delta
        return lb

    # ------------------------------------------------------------------ exact
    def _confirm_ed(self, near, query, eps2, stats):
        if near.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        L = query.size
        idx = near[:, None] + np.arange(L)[None, :]
        diff = self.data[idx] - query[None, :]
        d2h = np.einsum("ij,ij->i", diff, diff)
        keep = d2h <= eps2
        if stats is not None:
            stats.n_answers = int(keep.sum())
        order = np.argsort(d2h[keep])
        return near[keep][order], np.sqrt(d2h[keep][order])

    def _confirm_znorm(self, near, query, qh, mu_q, sd_q, eps2, alpha, beta, stats):
        if near.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        L = query.size
        idx = near[:, None] + np.arange(L)[None, :]
        x = self.data[idx]
        mu_h = x.mean(axis=1)
        var_h = np.maximum(np.mean(x * x, axis=1) - mu_h * mu_h, 0.0)
        sd_h = np.sqrt(var_h)
        ok = sd_h > 0
        if alpha is not None:
            ratio = sd_h / sd_q
            ok &= (np.abs(mu_h - mu_q) <= beta) & (ratio <= alpha) & \
                  (ratio >= 1.0 / alpha)
        z = (x - mu_h[:, None]) / np.where(sd_h > 0, sd_h, 1.0)[:, None]
        diff = z - qh[None, :]
        d2h = np.einsum("ij,ij->i", diff, diff)
        keep = ok & (d2h <= eps2)
        if stats is not None:
            stats.n_answers = int(keep.sum())
        order = np.argsort(d2h[keep])
        return near[keep][order], np.sqrt(d2h[keep][order])
