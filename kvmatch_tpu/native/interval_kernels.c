/* Native phase-1 interval kernels.
 *
 * The reference's candidate-set intersection is a serial two-pointer merge in
 * Java (QueryEngine.java:279-305, NormQueryEngine.java:334-399).  Our NumPy
 * path vectorizes it, but for the cNSM engines the per-segment interval volume
 * makes the many small array passes the phase-1 bottleneck.  This C version
 * fuses the whole CS x CS_i step — overlap enumeration, epsilon-budget sum,
 * beta-bitmask AND, derived-sigma filter — into ONE linear two-pointer pass at
 * memory speed.  Both inputs must be sorted by left and disjoint (guaranteed by
 * BaseEngine._gather_rows / merge_intervals); the output is sorted.
 *
 * Built at import time with cc -O3 (kvmatch_tpu/native/__init__.py); the NumPy
 * path remains as a fallback and as the semantics reference in tests.
 */

#include <stdint.h>
#include <math.h>

/* RSM engines: payloads = accumulated epsilon lower bound.
 * Emits every overlap piece with eps_a + eps_b <= eps2, SHIFTED by `delta`
 * (the next segment's frame — folding the shift here removes a whole
 * array pass per phase-1 step).  Also accumulates the phase-1 bookkeeping
 * the engine would otherwise recompute in extra passes: *n_off_out = total
 * covered offsets, *min_eps_out = smallest kept bound (HUGE_VAL if none).
 * Returns the piece count; output capacity must be >= na + nb. */
long intersect_ed(
    long na, const int64_t *al, const int64_t *ar, const double *ae,
    long nb, const int64_t *bl, const int64_t *br, const double *be,
    double eps2, int64_t delta,
    int64_t *ol, int64_t *orr, double *oe,
    int64_t *n_off_out, double *min_eps_out)
{
    long i = 0, j = 0, k = 0;
    int64_t n_off = 0;
    double emin = HUGE_VAL;
    while (i < na && j < nb) {
        if (ar[i] < bl[j]) { i++; continue; }
        if (br[j] < al[i]) { j++; continue; }
        double es = ae[i] + be[j];
        if (es <= eps2) {
            int64_t l = al[i] > bl[j] ? al[i] : bl[j];
            int64_t r = ar[i] < br[j] ? ar[i] : br[j];
            ol[k] = l + delta;
            orr[k] = r + delta;
            oe[k] = es;
            n_off += r - l + 1;
            if (es < emin) emin = es;
            k++;
        }
        if (ar[i] < br[j]) i++; else j++;
    }
    *n_off_out = n_off;
    *min_eps_out = emin;
    return k;
}

/* cNSM engines: payloads = eps + Ex/Ex2 bound tracks + beta bitmask.
 * Filters: eps budget, beta-mask AND (when use_beta), derived-sigma lower bound
 * in both directions (when use_std; NormQueryEngine.java:354-382,
 * NormQueryEngineDtw.java:370-389 with our conservative bound tracks).
 * p_units = unit windows covered so far INCLUDING this segment. */
/* Shared std-filter for the norm combine steps (NormQueryEngine.java:354-382,
 * NormQueryEngineDtw.java:370-389 with our conservative bound tracks).
 * Returns 0 when the piece can be pruned. */
static int norm_std_keep(double exlo, double ex2lo, double exup,
                         double unit, double qlen, double p_units,
                         double rest, double limit, double mu_q, double beta)
{
    if (rest > 0) {
        double mean_lo = exlo / p_units;
        if (mean_lo > mu_q + beta) {
            double nv = mu_q + beta -
                (mean_lo - mu_q - beta) * p_units * unit / rest;
            double var2 = (ex2lo * unit + rest * nv * nv) / qlen -
                (mu_q + beta) * (mu_q + beta);
            if (var2 > limit) return 0;
        }
        double mean_up = exup / p_units;
        if (mean_up < mu_q - beta) {
            double nv = mu_q - beta +
                (mu_q - beta - mean_up) * p_units * unit / rest;
            double var2 = (ex2lo * unit + rest * nv * nv) / qlen -
                (mu_q - beta) * (mu_q - beta);
            if (var2 > limit) return 0;
        }
    } else {
        double mean_lo = exlo / p_units;
        double mean_up = exup / p_units;
        double var_lb = 0.0;
        if (mean_up < mu_q - beta) {
            double d = mu_q - beta - mean_up;
            var_lb = d * d;
        } else if (mean_lo > mu_q + beta) {
            double d = mean_lo - mu_q - beta;
            var_lb = d * d;
        }
        if (var_lb > limit) return 0;
    }
    return 1;
}

long intersect_norm(
    long na, const int64_t *al, const int64_t *ar, const double *ae,
    const double *a_exlo, const double *a_ex2lo,
    const double *a_exup, const double *a_ex2up, const uint64_t *a_beta,
    long nb, const int64_t *bl, const int64_t *br, const double *be,
    const double *b_exlo, const double *b_ex2lo,
    const double *b_exup, const double *b_ex2up, const uint64_t *b_beta,
    double eps2, int use_beta, int use_std,
    double unit, double qlen, double p_units,
    double alpha, double beta, double mu_q, double sd_q, int64_t delta,
    int64_t *ol, int64_t *orr, double *oe,
    double *o_exlo, double *o_ex2lo, double *o_exup, double *o_ex2up,
    uint64_t *o_beta, int64_t *n_off_out, double *min_eps_out)
{
    long i = 0, j = 0, k = 0;
    int64_t n_off = 0;
    double emin = HUGE_VAL;
    double limit = alpha * alpha * sd_q * sd_q + 1e-12;
    double rest = qlen - p_units * unit;
    while (i < na && j < nb) {
        if (ar[i] < bl[j]) { i++; continue; }
        if (br[j] < al[i]) { j++; continue; }

        double es = ae[i] + be[j];
        int keep = es <= eps2;
        uint64_t bits = a_beta[i] & b_beta[j];
        if (keep && use_beta && bits == 0) keep = 0;

        double exlo = a_exlo[i] + b_exlo[j];
        double ex2lo = a_ex2lo[i] + b_ex2lo[j];
        double exup = a_exup[i] + b_exup[j];
        double ex2up = a_ex2up[i] + b_ex2up[j];
        if (keep && use_std)
            keep = norm_std_keep(exlo, ex2lo, exup, unit, qlen, p_units,
                                 rest, limit, mu_q, beta);

        if (keep) {
            int64_t l = al[i] > bl[j] ? al[i] : bl[j];
            int64_t r = ar[i] < br[j] ? ar[i] : br[j];
            ol[k] = l + delta;
            orr[k] = r + delta;
            oe[k] = es;
            o_exlo[k] = exlo;
            o_ex2lo[k] = ex2lo;
            o_exup[k] = exup;
            o_ex2up[k] = ex2up;
            o_beta[k] = bits;
            n_off += r - l + 1;
            if (es < emin) emin = es;
            k++;
        }
        if (ar[i] < br[j]) i++; else j++;
    }
    *n_off_out = n_off;
    *min_eps_out = emin;
    return k;
}

/* Fused scan+intersect join for the cNSM engines (see join_ed): binary search
 * the position-sorted view per CS interval, combine per-row payloads with the
 * same eps/beta/std filters as intersect_norm.  Row payload arrays are
 * indexed by (row - i0). */
long join_norm(
    long ncs, const int64_t *cl, const int64_t *cr, const double *ce,
    const double *c_exlo, const double *c_ex2lo,
    const double *c_exup, const double *c_ex2up, const uint64_t *c_beta,
    long np_, const int64_t *pl, const int64_t *pr, const int64_t *prow,
    long i0, long i1,
    const double *row_eps, const double *row_exlo, const double *row_ex2lo,
    const double *row_exup, const double *row_ex2up, const uint64_t *row_beta,
    double eps2, int use_beta, int use_std,
    double unit, double qlen, double p_units,
    double alpha, double beta, double mu_q, double sd_q, long max_diff,
    int64_t *ol, int64_t *orr, double *oe,
    double *o_exlo, double *o_ex2lo, double *o_exup, double *o_ex2up,
    uint64_t *o_beta)
{
    long k = 0;
    long t0 = 0;
    double limit = alpha * alpha * sd_q * sd_q + 1e-12;
    double rest = qlen - p_units * unit;
    for (long i = 0; i < ncs; i++) {
        int64_t lo_key = cl[i] - max_diff;
        long a = t0, b = np_;
        while (a < b) {
            long mid = (a + b) >> 1;
            if (pl[mid] < lo_key) a = mid + 1; else b = mid;
        }
        for (long t = a; t < np_ && pl[t] <= cr[i]; t++) {
            long r = prow[t];
            if (r < i0 || r >= i1 || pr[t] < cl[i]) continue;
            long ri = r - i0;
            double es = ce[i] + row_eps[ri];
            if (es > eps2) continue;
            uint64_t bits = c_beta[i] & row_beta[ri];
            if (use_beta && bits == 0) continue;
            double exlo = c_exlo[i] + row_exlo[ri];
            double ex2lo = c_ex2lo[i] + row_ex2lo[ri];
            double exup = c_exup[i] + row_exup[ri];
            double ex2up = c_ex2up[i] + row_ex2up[ri];
            if (use_std && !norm_std_keep(exlo, ex2lo, exup, unit, qlen,
                                          p_units, rest, limit, mu_q, beta))
                continue;
            ol[k] = pl[t] > cl[i] ? pl[t] : cl[i];
            orr[k] = pr[t] < cr[i] ? pr[t] : cr[i];
            oe[k] = es;
            o_exlo[k] = exlo;
            o_ex2lo[k] = ex2lo;
            o_exup[k] = exup;
            o_ex2up[k] = ex2up;
            o_beta[k] = bits;
            k++;
        }
        t0 = a;
    }
    return k;
}

/* Coalesce a sorted interval list: merge overlapping/adjacent runs with min-eps
 * combine (sortAndMergeIntervals, QueryEngine.java:664-693). */
long merge_sorted_ed(
    long n, const int64_t *l, const int64_t *r, const double *e,
    int64_t *ol, int64_t *orr, double *oe)
{
    if (n == 0) return 0;
    long k = 0;
    int64_t cl = l[0], cr = r[0];
    double ce = e[0];
    for (long i = 1; i < n; i++) {
        if (l[i] - 1 <= cr) {
            if (r[i] > cr) cr = r[i];
            if (e[i] < ce) ce = e[i];
        } else {
            ol[k] = cl; orr[k] = cr; oe[k] = ce; k++;
            cl = l[i]; cr = r[i]; ce = e[i];
        }
    }
    ol[k] = cl; orr[k] = cr; oe[k] = ce; k++;
    return k;
}

/* Fused segment scan: walk a slice of the position-sorted interval view and
 * emit the intervals belonging to rows [i0, i1) together with their per-row
 * payload columns (scanIndex, QueryEngine.java:504-518 / NormQueryEngine.java:
 * 672-701, minus the KV-store round trip).  Output is sorted by left because
 * the input view is.  Row payload arrays are indexed by (row - i0).
 * ncols: 1 = eps only (RSM), 6 = eps + Ex/Ex2 tracks + beta (cNSM).
 * min_right: only emit intervals with right >= min_right (span filtering).
 * Returns the interval count; capacity np_. */
long scan_fill(
    long np_, const int64_t *pl, const int64_t *pr, const int64_t *prow,
    long i0, long i1, int64_t min_right,
    const double *row_eps, const double *row_exlo, const double *row_ex2lo,
    const double *row_exup, const double *row_ex2up, const uint64_t *row_beta,
    int ncols,
    int64_t *ol, int64_t *orr, double *oe,
    double *o_exlo, double *o_ex2lo, double *o_exup, double *o_ex2up,
    uint64_t *o_beta)
{
    long k = 0;
    for (long t = 0; t < np_; t++) {
        long r = prow[t];
        if (r < i0 || r >= i1 || pr[t] < min_right) continue;
        long ri = r - i0;
        ol[k] = pl[t];
        orr[k] = pr[t];
        oe[k] = row_eps[ri];
        if (ncols > 1) {
            o_exlo[k] = row_exlo[ri];
            o_ex2lo[k] = row_ex2lo[ri];
            o_exup[k] = row_exup[ri];
            o_ex2up[k] = row_ex2up[ri];
            o_beta[k] = row_beta[ri];
        }
        k++;
    }
    return k;
}

/* Fused scan+intersect JOIN for the ED engines: instead of walking a scale's
 * ENTIRE position-sorted view (O(P) — seconds per segment at n=1e9 when the
 * running candidate set is scattered and ctx.span covers the whole series),
 * binary-search the view once per CS interval and visit only locally
 * overlapping index intervals: O(|CS| * (log P + local density)).
 *
 * Index intervals are at most `max_diff` positions wide (the builder's RLE
 * cap, IndexNode.java:31), so lower_bound(pl, cl - max_diff) cannot skip an
 * overlapping interval.  CS is sorted disjoint and pl is ascending, so the
 * emitted pieces are sorted disjoint.  Emits eps-filtered pieces with
 * es = cs_eps + row_eps[row - i0] (rows outside [i0, i1) are skipped).
 * Output capacity: ncs + (# index intervals of rows [i0, i1)). */
long join_ed(
    long ncs, const int64_t *cl, const int64_t *cr, const double *ce,
    long np_, const int64_t *pl, const int64_t *pr, const int64_t *prow,
    long i0, long i1, const double *row_eps, double eps2, long max_diff,
    int64_t *ol, int64_t *orr, double *oe)
{
    long k = 0;
    long t0 = 0;  /* monotone: cs is sorted, so searches only move right */
    for (long i = 0; i < ncs; i++) {
        int64_t lo_key = cl[i] - max_diff;
        /* lower_bound over pl[t0..np_) for lo_key */
        long a = t0, b = np_;
        while (a < b) {
            long mid = (a + b) >> 1;
            if (pl[mid] < lo_key) a = mid + 1; else b = mid;
        }
        /* back off: pl entries in [lo_key - ?]; a is first pl >= lo_key.
         * intervals starting in [cl-max_diff, cl) may still overlap, so we
         * must start from first pl >= cl - max_diff — that is `a`. */
        for (long t = a; t < np_ && pl[t] <= cr[i]; t++) {
            long r = prow[t];
            if (r < i0 || r >= i1 || pr[t] < cl[i]) continue;
            double es = ce[i] + row_eps[r - i0];
            if (es > eps2) continue;
            ol[k] = pl[t] > cl[i] ? pl[t] : cl[i];
            orr[k] = pr[t] < cr[i] ? pr[t] : cr[i];
            oe[k] = es;
            k++;
        }
        t0 = a;
    }
    return k;
}

/* Exact float64 banded DTW (Sakoe-Chiba radius r) for a batch of candidate
 * windows — the host confirmation kernel (semantics of DtwUtils.dtw,
 * DtwUtils.java:269-337).  a: (nb, m) row-major windows, q: (m,) query,
 * out: (nb,) squared distances.  work: scratch of 2*(m+2).
 *
 * `ub`: early-abandon upper bound — when every cell of a DP row exceeds ub,
 * the true distance provably exceeds ub (DP values are non-decreasing along
 * paths), so the row's minimum is emitted and the window abandoned.  The
 * reference's cb[] cascade (DtwUtils.java:299-306) serves the same purpose;
 * at the cNSM-DTW north-star shape the ~85% of near-candidates that are
 * rejects abandon after a small fraction of the L x (2r+1) band.  Exact
 * answers (distance <= ub) are never abandoned.  Pass HUGE_VAL to disable. */
void dtw_band_f64(
    long nb, long m, long r, double ub,
    const double *a, const double *q, double *out, double *work)
{
    double *prev = work;
    double *cur = work + (m + 2);
    const double INF = 1e300;
    for (long b = 0; b < nb; b++) {
        const double *x = a + b * m;
        for (long j = 0; j <= m; j++) prev[j] = INF;
        double result = INF;
        for (long i = 0; i < m; i++) {
            long j_lo = i - r < 0 ? 0 : i - r;
            long j_hi = i + r >= m ? m - 1 : i + r;
            /* The next row reads this one only at slots j_lo .. j_hi + 2:
             * reset the two slots outside the band, the rest is written. */
            cur[j_lo] = INF;
            if (j_hi + 2 <= m) cur[j_hi + 2] = INF;
            double run = INF;
            double rowmin = INF;
            for (long j = j_lo; j <= j_hi; j++) {
                double d = x[i] - q[j];
                d *= d;
                double best;
                if (i == 0 && j == 0) {
                    best = 0.0;
                } else {
                    best = prev[j + 1];              /* vertical (i-1, j)   */
                    if (j > 0 && prev[j] < best) best = prev[j];  /* diag  */
                    if (run < best) best = run;      /* horizontal (i, j-1) */
                }
                run = best + d;
                cur[j + 1] = run;
                if (run < rowmin) rowmin = run;
            }
            if (rowmin > ub) { result = rowmin; break; }  /* early abandon */
            double *t = prev; prev = cur; cur = t;
            result = prev[m];
        }
        out[b] = result;
    }
}

/* Fused bucket pass for host-side index builds: window means from the f64
 * prefix-sum array straight to int32 bucket ids (2*floor(v*s) + half-step),
 * one read + one write per output element.  Mirrors the device kernel
 * (ops/sliding.py bucketize_means) and the reference's running-mean toRound
 * pipeline (IndexBuilder.java:239-259, MeanIntervalUtils.java:51-61); replaces
 * ~7 NumPy temporaries with a single stream at memory speed.  c1 has n+1
 * entries (c1[0] = 0), m = n - w + 1 outputs. */
void bucket_pass(const double *c1, long m, long w, double scale, int32_t *out)
{
    double inv = scale / (double)w;
    for (long i = 0; i < m; i++) {
        double v = (c1[i + w] - c1[i]) * inv;
        double iv = floor(v);
        out[i] = (int32_t)(2 * (long)iv + (v - iv >= 0.5 ? 1 : 0));
    }
}

/* Run-length encode equal-bucket runs with the MAXIMUM_DIFF cap split
 * (IndexBuilder.java:268 discipline; mirrors index/build.py _rle_cap).
 * Two-pass protocol: call with out buffers NULL to get the piece count, then
 * with buffers of that size to fill.  Positions are 0-based inclusive. */
long rle_cap(const int32_t *b, long m, long cap,
             int32_t *ob, int64_t *ol, int64_t *orr)
{
    long k = 0;
    long i = 0;
    while (i < m) {
        long j = i + 1;
        int32_t v = b[i];
        while (j < m && b[j] == v) j++;
        for (long s = i; s < j; s += cap) {
            long e = s + cap - 1 < j - 1 ? s + cap - 1 : j - 1;
            if (ob) { ob[k] = v; ol[k] = s; orr[k] = e; }
            k++;
        }
        i = j;
    }
    return k;
}

/* Sorted union of two disjoint interval lists, merging overlapping/adjacent
 * intervals and re-splitting pieces wider than cap
 * (IndexNodeUtils.mergeIndexNode semantics, IndexNodeUtils.java:30-90).
 * Returns the output count; out capacity must be >= na + nb. */
static long union_resplit(long na, const int64_t *al, const int64_t *ar,
                          long nb, const int64_t *bl, const int64_t *br,
                          long cap, int64_t *ol, int64_t *orr)
{
    long i = 0, j = 0, k = 0;
    int64_t gl = 0, gr = -2;     /* current merged group; gr < gl-1 = empty */
    int have = 0;
    while (i < na || j < nb) {
        int64_t l, r;
        if (j >= nb || (i < na && al[i] <= bl[j])) { l = al[i]; r = ar[i]; i++; }
        else { l = bl[j]; r = br[j]; j++; }
        if (have && l - 1 <= gr) {
            if (r > gr) gr = r;
            continue;
        }
        if (have) {
            for (int64_t s = gl; s <= gr; s += cap) {
                int64_t e = s + cap - 1 < gr ? s + cap - 1 : gr;
                ol[k] = s; orr[k] = e; k++;
            }
        }
        gl = l; gr = r; have = 1;
    }
    if (have) {
        for (int64_t s = gl; s <= gr; s += cap) {
            int64_t e = s + cap - 1 < gr ? s + cap - 1 : gr;
            ol[k] = s; orr[k] = e; k++;
        }
    }
    return k;
}

/* Variable-width descending-key row merge (IndexBuilder.java:308-346; mirrors
 * index/build.py _group_and_merge): scan unique buckets descending, merge a
 * row into the running group when its interval count < merge_thresh and the
 * union shrinks below shrink_factor * (sum of part counts); a merged row
 * keeps the group's smallest key.
 *
 * Inputs: R rows ascending by bucket; row i owns l/r[row_start[i]..row_end[i]).
 * Outputs in ASCENDING key order, written from the END of the buffers (the
 * scan emits rows highest-key-first): final rows occupy out_key/out_count
 * [R-nrows, R) and the flat interval stream occupies ol/orr [T-used, T) where
 * T = total input interval count and used = sum(out_count).  Work buffers
 * wl/wr/w2l/w2r must hold T entries each.  Returns the final row count. */
long group_merge(long R, const int64_t *row_start, const int64_t *row_end,
                 const int64_t *ubucket, const int64_t *l, const int64_t *r,
                 double merge_thresh, double shrink_factor, long cap,
                 int64_t *out_key, int64_t *out_count,
                 int64_t *ol, int64_t *orr,
                 int64_t *wl, int64_t *wr, int64_t *w2l, int64_t *w2r)
{
    long kpos = R;                       /* next key slot, moving down   */
    long outp = R > 0 ? row_end[R - 1] : 0;  /* next interval end, moving down */
    long cur_n = 0;
    int64_t cur_key = 0;
    for (long idx = R - 1; idx >= 0; idx--) {
        long n_i = row_end[idx] - row_start[idx];
        const int64_t *li = l + row_start[idx];
        const int64_t *ri = r + row_start[idx];
        if (cur_n == 0) {
            for (long t = 0; t < n_i; t++) { wl[t] = li[t]; wr[t] = ri[t]; }
            cur_n = n_i; cur_key = ubucket[idx];
            continue;
        }
        int merged = 0;
        if ((double)n_i < merge_thresh) {
            long mn = union_resplit(cur_n, wl, wr, n_i, li, ri, cap, w2l, w2r);
            if ((double)mn < shrink_factor * (double)(cur_n + n_i)) {
                int64_t *t;
                t = wl; wl = w2l; w2l = t;
                t = wr; wr = w2r; w2r = t;
                cur_n = mn; cur_key = ubucket[idx];
                merged = 1;
            }
        }
        if (!merged) {
            kpos--; out_key[kpos] = cur_key; out_count[kpos] = cur_n;
            outp -= cur_n;
            for (long t = 0; t < cur_n; t++) { ol[outp + t] = wl[t]; orr[outp + t] = wr[t]; }
            for (long t = 0; t < n_i; t++) { wl[t] = li[t]; wr[t] = ri[t]; }
            cur_n = n_i; cur_key = ubucket[idx];
        }
    }
    if (cur_n > 0) {
        kpos--; out_key[kpos] = cur_key; out_count[kpos] = cur_n;
        outp -= cur_n;
        for (long t = 0; t < cur_n; t++) { ol[outp + t] = wl[t]; orr[outp + t] = wr[t]; }
    }
    return R - kpos;
}

/* K-way merge of R position-sorted interval rows (CSR slices of l/r) into one
 * left-sorted stream, emitting each interval's source row (0-based relative to
 * the first row).  A scale's rows are internally sorted by position and
 * mutually disjoint, so a heap merge is O(T log R) — beating both the argsort
 * gather (O(T log T)) and the full position-sorted index walk (O(total
 * intervals of the scale)) for first-segment scans with no span bound.
 * Scratch: heap_val/heap_row/cursor each hold R entries. */
long merge_rows(long R, const int64_t *row_start, const int64_t *row_end,
                const int64_t *l, const int64_t *r,
                int64_t *ol, int64_t *orr, int64_t *orow,
                int64_t *heap_val, int64_t *heap_row, int64_t *cursor)
{
    long hn = 0;
    for (long i = 0; i < R; i++) {
        cursor[i] = row_start[i];
        if (row_start[i] < row_end[i]) {
            /* sift up */
            long c = hn++;
            heap_val[c] = l[row_start[i]];
            heap_row[c] = i;
            while (c > 0) {
                long p = (c - 1) >> 1;
                if (heap_val[p] <= heap_val[c]) break;
                int64_t tv = heap_val[p]; heap_val[p] = heap_val[c]; heap_val[c] = tv;
                int64_t tr = heap_row[p]; heap_row[p] = heap_row[c]; heap_row[c] = tr;
                c = p;
            }
        }
    }
    long k = 0;
    while (hn > 0) {
        long row = heap_row[0];
        long cur = cursor[row];
        ol[k] = l[cur]; orr[k] = r[cur]; orow[k] = row; k++;
        cursor[row] = ++cur;
        if (cur < row_end[row]) {
            heap_val[0] = l[cur];
            /* heap_row[0] stays */
        } else {
            hn--;
            heap_val[0] = heap_val[hn];
            heap_row[0] = heap_row[hn];
        }
        /* sift down */
        long p = 0;
        for (;;) {
            long a = 2 * p + 1, b = 2 * p + 2, m = p;
            if (a < hn && heap_val[a] < heap_val[m]) m = a;
            if (b < hn && heap_val[b] < heap_val[m]) m = b;
            if (m == p) break;
            int64_t tv = heap_val[p]; heap_val[p] = heap_val[m]; heap_val[m] = tv;
            int64_t tr = heap_row[p]; heap_row[p] = heap_row[m]; heap_row[m] = tr;
            p = m;
        }
    }
    return k;
}

/* Counting-sort grouping of RLE intervals by bucket id (replaces the host
 * argsort+unique+gather around group_merge — the build's serial hot spot on
 * this 1-core host).  Bucket ids span a tiny range (a few thousand distinct
 * mean grids), so a histogram scatter is O(n) with two streaming passes.
 *
 * b[i] in [bmin, bmin+range); cnt is a caller-zeroed scratch of `range`
 * entries (reused as write cursors).  Outputs: ubucket/row_start describe R
 * rows ascending by bucket (row j owns ol/orr[row_start[j], row_start[j+1])),
 * intervals stay position-ordered within a row (the scan is stable).
 * Returns R. */
long group_rows(long n, const int32_t *b, const int64_t *l, const int64_t *r,
                int64_t bmin, int64_t range, int64_t *cnt,
                int64_t *ubucket, int64_t *row_start,
                int64_t *ol, int64_t *orr)
{
    for (long i = 0; i < n; i++) cnt[b[i] - bmin]++;
    long R = 0, acc = 0;
    for (int64_t k = 0; k < range; k++) {
        if (cnt[k]) {
            ubucket[R] = bmin + k;
            row_start[R] = acc;
            long c = cnt[k];
            cnt[k] = acc;            /* becomes the write cursor */
            acc += c;
            R++;
        }
    }
    row_start[R] = acc;
    for (long i = 0; i < n; i++) {
        long p = cnt[b[i] - bmin]++;
        ol[p] = l[i]; orr[p] = r[i];
    }
    return R;
}

/* Fused install of a device-built (int32) position-sorted piece view: one
 * streaming pass widens to the int64 pos-sorted copies AND counting-scatters
 * the row-sorted CSR interval copies.  Replaces three numpy astype passes +
 * group_rows + two output copies — the spill-mode device build's host wall
 * at n=1e8 (~24 s/scale -> one ~4 s pass on this host).  row32 values must
 * lie in [0, range) (the device builder's ascending group ids); cnt is a
 * caller-zeroed scratch of `range` entries.  Returns R (#non-empty rows). */
long install_pieces(long n, const int32_t *l32, const int32_t *r32,
                    const int32_t *row32, int64_t range, int64_t *cnt,
                    int64_t *l64, int64_t *r64, int64_t *row64,
                    int64_t *ol, int64_t *orr)
{
    for (long i = 0; i < n; i++) cnt[row32[i]]++;
    long R = 0, acc = 0;
    for (int64_t k = 0; k < range; k++) {
        long c = cnt[k];
        if (c) R++;
        cnt[k] = acc;                /* becomes the write cursor */
        acc += c;
    }
    for (long i = 0; i < n; i++) {
        int64_t L = l32[i], Rr = r32[i], ro = row32[i];
        l64[i] = L; r64[i] = Rr; row64[i] = ro;
        long p = cnt[ro]++;
        ol[p] = L; orr[p] = Rr;
    }
    return R;
}
