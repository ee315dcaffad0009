"""Configuration for the KV-match engine.

Every tunable that the reference hard-codes as ``private static final`` becomes a real
config field here (reference: QueryEngine.java:51-59, NormQueryEngine.java:57-60,
IndexBuilder.java:52-53,136, MeanIntervalUtils.java:35-41, IndexNode.java:31,
TimeSeriesNode.java:30).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# The reference's window family: WuList with an enabled mask selecting
# Sigma = {25, 50, 100, 200, 400} (QueryEngine.java:51-52).
DEFAULT_WU_LIST: Tuple[int, ...] = (25, 50, 75, 100, 125, 150, 175, 200,
                                    225, 250, 275, 300, 325, 350, 375, 400)
DEFAULT_WU_ENABLED: Tuple[bool, ...] = (True, True, False, True, False, False, False, True,
                                        False, False, False, False, False, False, False, True)


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Index-construction configuration (reference IndexBuilder.java:52-53, 135-136).

    ``pos_of_d`` sets the mean-bucket grid width d = 0.5 * 10^(1 - pos_of_d)
    (MeanIntervalUtils.java:38-41; default pos_of_d=2 -> d=0.05).
    """

    wu_list: Tuple[int, ...] = DEFAULT_WU_LIST
    wu_enabled: Tuple[bool, ...] = DEFAULT_WU_ENABLED
    pos_of_d: int = 2
    # Maximum number of offsets covered by one stored position interval
    # (IndexNode.java:31 MAXIMUM_DIFF = 256).
    maximum_diff: int = 256
    # Row-merge policy: merge a row into its (descending-key) predecessor when its
    # interval count < merge_count_factor * average AND the merged interval list is
    # smaller than merge_shrink_factor * (sum of parts) (IndexBuilder.java:327-329).
    merge_count_factor: float = 1.2
    merge_shrink_factor: float = 0.8
    # Conservative widening of probe ranges to absorb float32 build-side rounding
    # (addition to the reference; sound — can only add candidate rows, never
    # drop answers).
    probe_guard: float = 1e-4
    # Chunk length for the streaming (out-of-core) build path.
    build_chunk: int = 2 ** 24

    def __post_init__(self) -> None:
        # The planner's DP maps list position k-1 -> segment width unit*k
        # (QueryEngine.java:464-474 iterates Wu multiples of WuList[0]), so
        # wu_list must be the dense unit*k ladder with an enabled mask — a
        # sparse list like (100, 400) silently yields empty query plans.
        if len(self.wu_list) != len(self.wu_enabled):
            raise ValueError("wu_list and wu_enabled lengths differ")
        unit = self.wu_list[0]
        if not self.wu_enabled[0]:
            raise ValueError("the unit scale wu_list[0] must be enabled")
        for i, w in enumerate(self.wu_list):
            if w != unit * (i + 1):
                raise ValueError(
                    f"wu_list must be consecutive multiples of the unit "
                    f"({unit}): position {i} holds {w}, expected {unit * (i + 1)}. "
                    f"Disable unused widths via wu_enabled instead of omitting them.")

    @property
    def d(self) -> float:
        return 0.5 * 10.0 ** (1 - self.pos_of_d)

    @property
    def scales(self) -> Tuple[int, ...]:
        """Enabled window widths (Sigma)."""
        return tuple(w for w, e in zip(self.wu_list, self.wu_enabled) if e)

    @property
    def unit(self) -> int:
        """The unit window width w_u (smallest scale; 25 in the reference)."""
        return self.wu_list[0]


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Query-time configuration (reference QueryEngine.java:54-59 etc.)."""

    # Phase-0 DP segmentation limits (QueryEngine.java:463, 480).
    max_segments: int = 30
    enable_query_reordering: bool = True
    # Early termination of phase 1 driven by the phase-2 cost model
    # (QueryEngine.java:54-57, 316-327).
    enable_early_termination: bool = True
    # Cost model t2 ~= a * #disjointWindows + b * #offsets/1e5 * L  (ms).  The reference
    # fitted (a, b) on its lab machine; QueryConfig.tuned() holds the values
    # refit for the device verify kernels (utils/profiling.fit_cost_model);
    # these are the reference's defaults (QueryEngine.java:55-57).
    phase2_cost_a: float = 4.0707589132278
    phase2_cost_b: float = 0.269833135638498
    phase2_cost_a_dtw: float = 9.72276547123376
    phase2_cost_b_dtw: float = 0.0106737255022236
    phase2_cost_intercept: float = 0.0
    min_segments_before_termination: int = 5
    # Marginal-scan termination: skip a probe segment (and everything after it)
    # when its PREDICTED scan volume — the plan's per-segment interval count —
    # costs more than the current candidate set's phase-2 estimate.  The
    # reference never needs this (its scans are small KV range reads; the
    # time-based rule above reacts only AFTER paying for a scan), but with the
    # whole index RAM-resident a dense segment can hold 1e8+ intervals and one
    # scan+intersect pass costs seconds at n=1e9.  Sound: skipping probes only
    # loosens the candidate set; phase 2 is exact.  The constant is host
    # C-kernel throughput (~40M intervals/s on one core).
    phase1_scan_cost_ms_per_interval: float = 2.5e-5
    # Dense-query routing: when even the most selective plan segment holds
    # more than this many index intervals, phase 1 runs as the DEVICE dense
    # probe — the accumulated bound evaluated elementwise over every position
    # (no host intermediates), with bucket ids recomputed on the fly from the
    # f32 series.  OPT-IN (None = host phase 1 always): the host path handles
    # selective plans in milliseconds; enable it for flood workloads (e.g.
    # tuned(dense_probe_min_count=0) routes every plan through the device).
    # query_batch_device always uses the probe.
    dense_probe_min_count: int | None = None
    # Device region-route phase-2 cost (ms per candidate OFFSET): when set,
    # the early-termination estimate is the MIN of the reference's gather
    # form (cost_a/cost_b, which scales with L) and this flat per-offset
    # rate — the region kernels verify clustered candidates at ~500M
    # offsets/s nearly independent of L, so the gather form overestimates
    # flood phase 2 ~10x and keeps phase 1 buying segments that cost more
    # than they save.  Only applies to ED engines with device-resident data.
    phase2_cost_region: float | None = None
    # Dense phase-1 emission: 'runs' = run-compressed interval buffers with
    # the gap-coalescing overflow ladder (exact edges), 'flags' = the
    # overflow-proof per-flag-block candidate bitmap (block over-coverage the
    # exact phase 2 rejects; one pass at any density).  'auto' resolves per
    # platform through engine/base.dense_emit_for.
    dense_probe_emit: str = "auto"
    # Normalized-engine extras (NormQueryEngine.java:57-60).
    enable_std_filter: bool = True
    enable_beta_partition: bool = True
    beta_partition_width: float = 10.0
    max_scan_data_length: int = 40000
    # Phase-2 device batching: candidate windows are verified in padded
    # batches of this many rows.
    verify_batch: int = 1024
    # Host fast path for TINY phase-2 loads (ED engines): when the whole
    # candidate set touches at most this many points (sum of candidates x L),
    # verification runs directly as the exact float64 host kernel — no device
    # launch at all.  Break-even basis: a device launch's fixed cost
    # (dispatch plus transfers, phase2_cost_intercept) vs the host's ~2 GB/s
    # f64 streaming scan — 2e6 points = 16 MB ~= 8 ms of host work.  The
    # reference demo query (147 candidates x L=8192 = 1.2M points,
    # README.md:72-77) routes host under the default.  Set to 0 to force
    # every verify onto the device.
    host_verify_max_points: int = 2_000_000
    # Host-only engines (device_data='host') additionally accept candidate
    # loads up to this many OFFSETS by running the run-local prefix-sum
    # prefilters (constraint + PAA envelope bound, utils/sparse_prefix.py)
    # before the exact kernel; the post-prefilter survivors must still fit
    # host_confirm_max_points.  ~20-130 float ops/offset, so 32M offsets is
    # seconds on one core — vs skipping the query outright at n=1e10 where
    # full-series cumsums (80 GB) are unaffordable.  0 disables the tier.
    host_prefilter_max_offsets: int = 33_554_432
    # Survivor budget for that tier, in POINTS (survivors x L).  Distinct
    # from host_verify_max_points, which is a host-vs-device ROUTING
    # break-even; this caps how much exact f64 work the host-only route will
    # accept before declaring the query out of reach.  The exact kernels are
    # chunked (memory-bounded), so this is a time budget: ~2 GB/s f64
    # streaming -> 2^28 points ~ 1 s/query worst case (DTW confirms run the
    # LB_Keogh prefilter + early-abandon DP behind the same budget).
    host_confirm_max_points: int = 1 << 28
    # Skip the LB-cascade launch (DTW engines) when the candidate set is at
    # most this many offsets: at ~76k DP-candidates/s a 2048-candidate banded
    # DP costs ~27 ms — less than the extra launch (fixed dispatch cost) plus
    # the cascade's 3x gather traffic it would take to prune them first.  The
    # cascade is purely a prefilter (DtwUtils.java:149-257), so skipping it
    # never changes the answer set.  Set to 0 to always run the cascade.
    dtw_skip_lb_max: int = 2048
    # Host-only engines (device_data='host') multiply the phase-2 cost
    # slope by this factor: the host verify route (sparse-prefix prefilter +
    # exact f64 kernels) costs ~25x the device kernels per offset, and
    # under-estimating it makes early termination quit while probing is
    # still the cheaper move (measured: a 1M-candidate leftover costs ~1.1 s
    # host vs the 41 ms the device slope predicts at n=1e7, L=8192).
    host_cost_scale: float = 25.0
    # Guard band for exact host re-verification of device f32 distances: offsets with
    # |d^2 - eps^2| <= guard * eps^2 (relative) are re-checked in float64 on host, which
    # makes the final answer set exact while keeping the heavy compute on the device.
    verify_guard: float = 1e-2

    # The incremental index-cache visiting of the reference (QueryEngine.java:204-252)
    # is intentionally subsumed: the whole index is device/RAM-resident here, so every
    # probe is a pure array lookup and caching ranges would only add overhead.

    @classmethod
    def tuned(cls, **overrides) -> "QueryConfig":
        """Cost-model constants refit for the device verify kernels:
        utils/profiling.fit_cost_model at n=1e6, L in {512, 2048, 8192}, on
        an NVIDIA H100 80GB HBM3 at a 700 W power limit
        (scripts/kernel_decisions.py; PERF.md).

        The ED fit: ~8e-6 ms per disjoint window, ~1.4e-5 ms per 1e5
        offset-points and a 0.4 ms intercept — the batched device verify
        makes the per-candidate terms ~1e4x smaller than the reference's
        serial-Java constants, so early termination fires much sooner.  The
        DTW fit found no measurable per-candidate slope (phase 2 there is a
        per-batch cost of 20-170 ms growing with L, which cancels in the
        termination comparison), so the DTW slopes reuse the ED ones and the
        estimate still grows with extreme candidate loads.
        """
        overrides.setdefault("phase2_cost_region", 2e-6)
        return cls(phase2_cost_a=8e-6, phase2_cost_b=1.4e-5,
                   phase2_cost_a_dtw=8e-6, phase2_cost_b_dtw=1.4e-5,
                   phase2_cost_intercept=0.4, **overrides)


DEFAULT_INDEX_CONFIG = IndexConfig()
DEFAULT_QUERY_CONFIG = QueryConfig()
