"""KV-index array layout: one ``IndexScale`` per window width in Sigma.

Array (CSR) re-design of the reference's row-oriented index
(entity/IndexNode.java:29-159, operator/file/IndexFileOperator.java:127-164):

  keys      f64[R]     sorted ascending; key = lower edge of the mean range a row
                       covers (after variable-width row merging the upper edge is
                       the next key, exactly as in MeanIntervalUtils.toUpper with
                       statisticInfo, MeanIntervalUtils.java:104-114)
  row_ptr   i64[R+1]   CSR offsets into the interval arrays
  left/right i64[P]    position intervals (0-based window starts, inclusive), sorted
                       by left within each row, each covering <= 256 offsets
                       (IndexNode.java:31)
  cum_intervals i64[R] cumulative #intervals per row (ascending key order) — the
  cum_offsets   i64[R] "meta table" prefix sums the planner's selectivity estimates
                       binary-search (ByteUtils.java:89-95, QueryEngine.java:382-402)

The whole structure is plain NumPy on host and can be pushed to device HBM as flat
arrays for the jit'd dense probe path (parallel/query.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class IndexScale:
    w: int
    n: int
    keys: np.ndarray          # f64[R]
    row_ptr: np.ndarray       # i64[R+1]
    left: np.ndarray          # i64[P] (may be lazily materialized; see below)
    right: np.ndarray         # i64[P]
    cum_intervals: np.ndarray  # i64[R]
    cum_offsets: np.ndarray   # i64[R]
    # Strict upper bound on every window mean in this scale (upper edge of the
    # highest occupied bucket) — closes the last row's mean range, which the
    # reference leaves open-ended (MeanIntervalUtils.java:109 returns +10000).
    mean_upper_bound: float = float("inf")

    # Device-resident position-sorted interval view from the device builder
    # (index/device_build.py): (p_left_dev, p_right_dev, p_row_dev, n_pieces),
    # position-ordered.  When set, ``left``/``right`` may be constructed as
    # None and are materialized on host lazily at first access — a device
    # build + fly-probe + device-verify query never pays the interval D2H.
    dev_pos_view: tuple = None

    # Serving-mode scale (index/device_build.build_index_device_stats):
    # planner statistics only, NO intervals anywhere.  Host interval access
    # raises; phase 1 must run as the device dense probe.
    stats_only: bool = False

    # Lazy position-sorted view: intervals ordered by left edge with their row id.
    # Lets a probe restrict itself to the running candidate span (engine/base.py
    # _gather_rows_span) — later phase-1 segments then cost O(span intervals)
    # instead of O(all intervals in the key range).
    _pos_sorted: tuple = None
    # Cumulative interval count served by per-row merges (engine-maintained);
    # once it exceeds ~2x the scale's interval count, building the global
    # position-sorted view amortizes (BaseEngine._use_pos_view).
    gather_work: int = 0

    def materialize_host(self) -> None:
        """Pull the device interval view to the host and build the row-CSR
        arrays (counting-sort by row id; stability preserves position order).
        Also seeds the position-sorted view for free (the device view IS it)."""
        if self._left is not None or self.dev_pos_view is None:
            return
        p_l_d, p_r_d, p_row_d, np_pieces = self.dev_pos_view
        # Slice on DEVICE before the pull: the padded arrays are M-sized
        # (400 MB each at n=1e8) while np_pieces is typically a fraction of
        # that.
        p_l = np.asarray(p_l_d[:np_pieces])
        p_r = np.asarray(p_r_d[:np_pieces])
        p_row = np.asarray(p_row_d[:np_pieces])
        self.set_pos_arrays(p_l, p_r, p_row)

    def set_pos_arrays(self, p_l, p_r, p_row) -> None:
        """Install host interval arrays from a position-sorted piece view
        (int32 or int64), building the row-CSR copies."""
        from .. import native
        p_l = np.asarray(p_l)
        p_r = np.asarray(p_r)
        p_row = np.asarray(p_row)
        if p_l.dtype == np.int32 and p_row.size and self.num_rows:
            # Device-built int32 pieces: one fused C pass (widen + counting
            # scatter) instead of 3 astype passes + group_rows + 2 copies.
            ip = native.install_pieces(p_l, p_r, p_row, self.num_rows)
            if ip is not None:
                l64, r64, row64, ol, orr = ip
                self._pos_sorted = (l64, r64, row64)
                self._left = ol
                self._right = orr
                return
        p_l = p_l.astype(np.int64)
        p_r = p_r.astype(np.int64)
        p_row = p_row.astype(np.int64)
        self._pos_sorted = (p_l, p_r, p_row)
        grp = native.group_rows(p_row.astype(np.int32), p_l, p_r) \
            if p_row.size else None
        if grp is not None:
            _, _, l_sorted, r_sorted = grp
            self._left = l_sorted.copy()
            self._right = r_sorted.copy()
        else:
            order = np.argsort(p_row, kind="stable")
            self._left = p_l[order]
            self._right = p_r[order]

    def pos_sorted(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Position-sorted view (left, right, row_of_interval) of ALL intervals.

        Costly to materialize (O(T log R) C k-way merge over the row lists —
        ~10 s for the 4.6e8 intervals of a w=25 scale at n=1e9, vs minutes for
        the argsort fallback) and 24 bytes/interval to hold, so callers must
        only reach for it when per-row access cannot serve the scan; see
        BaseEngine.POS_VIEW_MIN.  Free when the device builder's view is
        present (device intervals come out position-ordered)."""
        if self._pos_sorted is None:
            if self.dev_pos_view is not None:
                self.materialize_host()
                return self._pos_sorted
            from .. import native
            mr = native.merge_rows(self.row_ptr[:-1], self.row_ptr[1:],
                                   self.left, self.right)
            if mr is not None:
                row_of, p_l, p_r = mr
                # copies: merge_rows returns scratch views; this cache persists
                self._pos_sorted = (p_l.copy(), p_r.copy(), row_of.copy())
            else:
                order = np.argsort(self.left, kind="stable")
                row_of = np.repeat(np.arange(self.num_rows, dtype=np.int64),
                                   np.diff(self.row_ptr))
                self._pos_sorted = (self.left[order], self.right[order],
                                    row_of[order])
        return self._pos_sorted

    @property
    def has_pos_sorted(self) -> bool:
        return self._pos_sorted is not None or self.dev_pos_view is not None

    @property
    def num_rows(self) -> int:
        return int(self.keys.size)

    @property
    def num_intervals(self) -> int:
        return int(self.row_ptr[-1]) if self.row_ptr.size else 0

    def row_slice(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = int(self.row_ptr[r]), int(self.row_ptr[r + 1])
        return self.left[s:e], self.right[s:e]

    def memory_bytes(self) -> int:
        meta = sum(a.nbytes for a in (self.keys, self.row_ptr,
                                      self.cum_intervals, self.cum_offsets))
        if self.stats_only:
            return meta  # no intervals exist anywhere
        if self._left is not None:
            return meta + self._left.nbytes + self._right.nbytes
        # device-resident intervals: int32 left/right (+row) per piece
        return meta + 12 * self.num_intervals

    def counts_between(self, begin_round: float, end_round: float) -> Tuple[int, int]:
        """(#intervals, #offsets) the probe for range [begin_round, end_round]
        will actually touch (the reference estimates this from its cumulative
        meta table, getCountsFromStatisticInfo, QueryEngine.java:382-402).

        Rows are variable-width: row j covers keys [keys[j], keys[j+1]), so
        the probe snaps ``begin`` DOWN to the key of its containing row and
        scans rows j0..j1 inclusive.  The planner MUST count that containing
        row too — in sparse key-range tails it can hold thousands of
        intervals, and excluding it made the DP rank tail-landing segments as
        nearly free (the round-4 cNSM n=1e8 23.5M-candidate plan blowup)."""
        i, o = self.counts_between_batch(np.atleast_1d(begin_round),
                                         np.atleast_1d(end_round))
        return int(i[0]), int(o[0])

    def counts_between_batch(self, begin_round: np.ndarray, end_round: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized counts_between over arrays of probe bounds — feeds the
        planner's whole cost table in a few searchsorted calls.  Mirrors
        probe_rows(snap_down(begin), end): rows j0..j1 inclusive where j0 is
        the row containing begin (0 when begin precedes all keys) and j1 the
        last row with key <= end."""
        keys = self.keys
        if keys.size == 0:
            z = np.zeros(np.shape(begin_round), np.int64)
            return z, z
        j0 = np.maximum(np.searchsorted(keys, begin_round, side="right") - 1, 0)
        j1 = np.searchsorted(keys, end_round, side="right") - 1
        lo_i = np.where(j0 > 0, self.cum_intervals[np.maximum(j0 - 1, 0)], 0)
        lo_o = np.where(j0 > 0, self.cum_offsets[np.maximum(j0 - 1, 0)], 0)
        hi_i = np.where(j1 >= 0, self.cum_intervals[np.maximum(j1, 0)], 0)
        hi_o = np.where(j1 >= 0, self.cum_offsets[np.maximum(j1, 0)], 0)
        return np.maximum(hi_i - lo_i, 0), np.maximum(hi_o - lo_o, 0)

    def probe_rows(self, begin_key: float, end_key: float) -> np.ndarray:
        """Indices of rows whose key lies in [begin_key, end_key] (inclusive).

        Equivalent to IndexFileOperator.readIndexes' lowerBound/upperBound binary
        searches (IndexFileOperator.java:65-119) — but O(log R) on an in-RAM array
        instead of per-probe file reads.
        """
        i0 = int(np.searchsorted(self.keys, begin_key, side="left"))
        i1 = int(np.searchsorted(self.keys, end_key, side="right"))
        return np.arange(i0, i1)


def _lazy_interval_field(name: str):
    """left/right become lazy properties: a device-built scale stores them as
    None and materializes host copies on first access (interval D2H + row-CSR
    counting sort happen only if a host code path actually needs them)."""
    priv = "_" + name

    def get(self):
        v = getattr(self, priv)
        if v is None:
            if self.stats_only:
                raise RuntimeError(
                    "stats-only index scale (build_index_device_stats) holds "
                    "no intervals: serve phase 1 through the device dense "
                    "probe (QueryConfig.dense_probe_min_count) or rebuild "
                    "with build_index_device/build_index_tpu")
            if self.dev_pos_view is not None:
                self.materialize_host()
                v = getattr(self, priv)
        return v

    def set_(self, v):
        object.__setattr__(self, priv, v)

    return property(get, set_)


IndexScale.left = _lazy_interval_field("left")
IndexScale.right = _lazy_interval_field("right")


Index = Dict[int, IndexScale]


def total_memory_bytes(index: Index) -> int:
    return sum(s.memory_bytes() for s in index.values())
