"""Observability: per-query stats export, cost-model fitting, device tracing.

Covers the reference's cross-cutting subsystems (SURVEY.md section 5):

* ``StatsWriter`` — CSV appender for QueryStats rows, the structured replacement
  for the static StatisticWriter (statistic/StatisticWriter.java:28-70).
* ``fit_cost_model`` — re-fits the phase-2 time model t2 = a*#windows +
  b*#offsets/1e5*L on THIS hardware.  The reference ships coefficients fitted on
  its lab machine (QueryEngine.java:55-57) and says to re-fit by hand; here it is
  one function over a sample workload, returning an updated QueryConfig.
* ``trace`` — context manager around jax.profiler for device-level traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np

from ..config import QueryConfig


class StatsWriter:
    """Append QueryStats rows to a CSV (one header, flushed per write)."""

    FIELDS = ("t_total_ms", "t_phase1_ms", "t_phase2_ms", "n_candidates", "n_disjoint",
              "n_answers", "n_scans", "n_segments_used", "n_device_checked",
              "n_host_rechecked", "early_terminated")

    def __init__(self, path):
        self.path = Path(path)
        if not self.path.exists():
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(",".join(("label",) + self.FIELDS) + "\n")

    def write(self, label: str, stats) -> None:
        row = [str(label)] + [str(getattr(stats, f)) for f in self.FIELDS]
        with open(self.path, "a") as f:
            f.write(",".join(row) + "\n")
            f.flush()


def fit_cost_model(engine, queries, epsilon, repeats: int = 1,
                   **params) -> QueryConfig:
    """Measure phase-2 time against (#disjoint windows, #offsets*L) on real
    hardware and return a QueryConfig with re-fitted coefficients.

    ``queries`` is one (Q, L) batch or a list of batches (one per query
    length).  Least squares on t2 ~= a * n_windows + b * n_offsets/1e5 * L + c,
    mirroring the reference's fitted model shape (QueryEngine.java:316-327)."""
    batches = queries if isinstance(queries, (list, tuple)) else [queries]
    rows = []
    t2s = []
    for _ in range(repeats):
        for batch in batches:
            for res in engine.query_batch(batch, epsilon, **params):
                s = res.stats
                rows.append([max(s.n_disjoint, 1),
                             s.n_candidates / 1e5 * batch.shape[1], 1.0])
                t2s.append(s.t_phase2_ms)
    A = np.asarray(rows)
    t = np.asarray(t2s)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    a, b = float(max(coef[0], 0.0)), float(max(coef[1], 0.0))
    c = float(max(coef[2], 0.0))
    # On the device the per-offset cost is tiny and a fixed launch cost
    # dominates — the intercept keeps the early-termination comparison honest
    # (QueryEngine.java:316-327 has no intercept because serial Java has no
    # launch cost).
    if getattr(engine, "use_dtw_cost_model", False):
        return dataclasses.replace(engine.qcfg, phase2_cost_a_dtw=a,
                                   phase2_cost_b_dtw=b, phase2_cost_intercept=c)
    return dataclasses.replace(engine.qcfg, phase2_cost_a=a, phase2_cost_b=b,
                               phase2_cost_intercept=c)


@contextlib.contextmanager
def trace(log_dir: str = "kvmatch-trace"):
    """Device-level profiling around a block: ``with trace(): engine.query(...)``.

    Produces a TensorBoard-loadable trace (jax.profiler.trace) — the deep
    replacement for the reference's wall-clock phase timers."""
    import jax
    with jax.profiler.trace(log_dir):
        yield
