/* Native fast paths for recsys-tpu host-side ingest.
 *
 * TPU-native counterpart of the reference's C ingest layer
 * (util.c:7-34 fscanf parser; mat2d.c:61-83 glibc-random fills).
 * The compute path is JAX/XLA/Pallas; everything here runs on host
 * before device upload, where the bottlenecks are text parsing of
 * multi-million-line .in files and the inherently sequential glibc
 * random() recurrence.  Exposed to Python via ctypes
 * (recsys_tpu/io/_native.py), no pybind11 required.
 *
 * This file is a copy of native/recsys_native.c.  The PyTorch port loads it
 * through recsys_tpu_torch/io/_native.py, which builds it with cc into
 * build/recsys_tpu_torch/.
 *
 * Build: cc -O3 -shared -fPIC -o librecsys_native.so recsys_native.c
 */

#include <math.h>
#include <stdio.h>
#include <stdint.h>
#include <stddef.h>

/* ------------------------------------------------------------------ */
/* .in entry-body parser                                              */
/* ------------------------------------------------------------------ */

/* Parse nnz lines of "row col value" (whitespace separated) from buf.
 * Values are non-negative decimals with optional fraction (the format
 * the reference writes with %lf and reads with fscanf, util.c:29-34);
 * a fallback flag is returned if anything fancier (exponents, signs)
 * appears so the caller can retry with the numpy path.
 *
 * Returns the number of entries parsed (== nnz on success).          */
long rs_parse_entries(const char *buf, long len, long nnz,
                      int32_t *rows, int32_t *cols, double *vals) {
    const char *p = buf, *end = buf + len;
    /* Exact powers of ten (and their rounded reciprocals) for the
     * correctly-rounded fraction reconstruction below. 10^n is exactly
     * representable in double up to 10^22; reciprocals are RN(1/d). */
    static const double pow10_d[16] = {
        1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
        1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};
    static const uint64_t pow10_u[16] = {
        1ULL, 10ULL, 100ULL, 1000ULL, 10000ULL, 100000ULL, 1000000ULL,
        10000000ULL, 100000000ULL, 1000000000ULL, 10000000000ULL,
        100000000000ULL, 1000000000000ULL, 10000000000000ULL,
        100000000000000ULL, 1000000000000000ULL};
    static const double recip10_d[16] = {
        1e0, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7,
        1e-8, 1e-9, 1e-10, 1e-11, 1e-12, 1e-13, 1e-14, 1e-15};
    for (long n = 0; n < nnz; ++n) {
        long r = 0, c = 0;
        /* skip whitespace */
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
            ++p;
        if (p >= end) return n;
        while (p < end && *p >= '0' && *p <= '9') r = r * 10 + (*p++ - '0');
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        while (p < end && *p >= '0' && *p <= '9') c = c * 10 + (*p++ - '0');
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        /* value: [-]int[.frac] ; exponents signal fallback */
        int neg = 0;
        if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
        uint64_t ip = 0;
        while (p < end && *p >= '0' && *p <= '9') ip = ip * 10 + (uint64_t)(*p++ - '0');
        double v = (double)ip;
        if (p < end && *p == '.') {
            ++p;
            uint64_t fp = 0;
            int nd = 0;
            while (p < end && *p >= '0' && *p <= '9' && nd < 15) {
                fp = fp * 10 + (uint64_t)(*p++ - '0');
                ++nd;
            }
            if (p < end && *p >= '0' && *p <= '9')
                return -(n + 1); /* >15 fraction digits: strtod fallback */
            /* Correctly-rounded value, matching strtod/%lf bit-for-bit:
             * build the exact integer ip*10^nd + fp (must fit 2^53 so
             * its double conversion is exact) and divide by the exact
             * power of ten.  The division itself uses the same
             * FMA-corrected Newton sequence as rs_glibc_rand01 (one
             * rounding, identical to the hardware divide), because FP
             * division is ~2000 cycles on the target VM. */
            if (ip > (9007199254740992ULL - fp) / pow10_u[nd])
                return -(n + 1); /* numerator would exceed 2^53 */
            {
                double num = (double)(ip * pow10_u[nd] + fp); /* exact */
                double d = pow10_d[nd], c = recip10_d[nd];  /* c == RN(1/d) */
                double y0 = num * c;
                double r = fma(-y0, d, num);
                v = fma(r, c, y0);
            }
        }
        if (p < end && (*p == 'e' || *p == 'E')) return -(n + 1); /* fallback */
        rows[n] = (int32_t)r;
        cols[n] = (int32_t)c;
        vals[n] = neg ? -v : v;
    }
    return nnz;
}

/* ------------------------------------------------------------------ */
/* glibc random() (TYPE_3 additive lagged-Fibonacci) recreation        */
/* ------------------------------------------------------------------ */

/* State: rolling window of the last 34 outputs of the recurrence
 * x[i] = (x[i-31] + x[i-3]) mod 2^32, output x[i] >> 1.
 * Seeding per glibc: seed 0 -> 1; LCG r[i] = 16807*r[i-1] mod 2^31-1
 * (verified against the reference's samples/inst0.mats, SURVEY.md S0). */

typedef struct {
    uint32_t w[34];
} rs_glibc_state;

void rs_glibc_seed(rs_glibc_state *st, int32_t seed) {
    uint32_t warm[34 + 310];
    int64_t s = (seed == 0) ? 1 : (int64_t)seed;
    warm[0] = (uint32_t)s;
    int64_t prev = s;
    for (int i = 1; i < 31; ++i) {
        prev = (16807 * prev) % 2147483647LL;
        warm[i] = (uint32_t)prev;
    }
    for (int i = 31; i < 34; ++i) warm[i] = warm[i - 31];
    for (int i = 34; i < 34 + 310; ++i) warm[i] = warm[i - 31] + warm[i - 3];
    for (int i = 0; i < 34; ++i) st->w[i] = warm[310 + i];
}

/* Draw n outputs scaled to [0,1]: random()/RAND_MAX.
 * Chunked linear buffer instead of a ring: the recurrence indexes
 * directly (no per-draw modulo), which is ~100x faster. */
void rs_glibc_rand01(rs_glibc_state *st, long n, double *out) {
    enum { CHUNK = 8192 };
    uint32_t buf[34 + CHUNK];
    for (int i = 0; i < 34; ++i) buf[i] = st->w[i];
    long done = 0;
    while (done < n) {
        long m = n - done;
        if (m > CHUNK) m = CHUNK;
        for (long i = 34; i < 34 + m; ++i) buf[i] = buf[i - 31] + buf[i - 3];
        /* RAND01 = random()/RAND_MAX (mat2d.h:4), bit-exact. A bare
         * reciprocal multiply differs in the last ulp, and hardware FP
         * division is pathologically slow on some virtualized hosts, so
         * divide via Markstein's multiply + FMA-corrected Newton step,
         * which is provably correctly rounded (identical to the divide
         * instruction for every input). Split loops vectorize cleanly. */
        {
            const double d = 2147483647.0, c = 1.0 / 2147483647.0;
            double *o = out + done;
            for (long i = 0; i < m; ++i) o[i] = (double)(buf[34 + i] >> 1);
            for (long i = 0; i < m; ++i) {
                double y0 = o[i] * c;
                double r = fma(-y0, d, o[i]);
                o[i] = fma(r, c, y0);
            }
        }
        for (int i = 0; i < 34; ++i) buf[i] = buf[m + i];
        done += m;
    }
    for (int i = 0; i < 34; ++i) st->w[i] = buf[i];
}

/* One-shot convenience: first n rand01 draws after srandom(seed). */
void rs_rand01_sequence(long n, int32_t seed, double *out) {
    rs_glibc_state st;
    rs_glibc_seed(&st, seed);
    rs_glibc_rand01(&st, n, out);
}

/* ------------------------------------------------------------------ */
/* Serial full-batch GD (the sub-dispatch-floor fallback engine)       */
/* ------------------------------------------------------------------ */

/* Problems too small to amortize even one device dispatch (toy
 * instances: thousands of iterations over a handful of entries) run
 * the sequential host trajectory — the regime the reference's serial
 * driver owns (matFact.c:29-59).  Semantics: per iteration, snapshot
 * both factors, then for every observed entry accumulate
 *     e = alpha*2*(a - <L_s[i,:], R_s[j,:]>)   (dot over f ascending)
 *     L[i,f] += e*R_s[j,f];  R[j,f] += e*L_s[i,f]
 * in entry order.  The build disables FP contraction (-ffp-contract=
 * off, io/_native.py), so with the identical operation order the f64
 * trajectory is bit-identical to the reference binary's (which is
 * built without optimization and never contracts).
 *
 * L: (users, k) row-major; R: (items, k) row-major — the transposed
 * storage the reference also updates (matFact.c:117-120).  Ls/Rs are
 * caller-provided snapshot scratch of the same shapes.               */
void rs_serial_gd(long iters, double alpha, long k, long users, long items,
                  long nnz, const int32_t *rows, const int32_t *cols,
                  const double *vals, double *L, double *R,
                  double *Ls, double *Rs) {
    const long lu_n = users * k, ru_n = items * k;
    for (long it = 0; it < iters; ++it) {
        for (long x = 0; x < lu_n; ++x) Ls[x] = L[x];
        for (long x = 0; x < ru_n; ++x) Rs[x] = R[x];
        for (long n = 0; n < nnz; ++n) {
            const double *lp = Ls + (long)rows[n] * k;
            const double *rp = Rs + (long)cols[n] * k;
            double dot = 0;
            for (long f = 0; f < k; ++f) dot += lp[f] * rp[f];
            double e = alpha * 2 * (vals[n] - dot);
            double *lu = L + (long)rows[n] * k;
            double *ru = R + (long)cols[n] * k;
            for (long f = 0; f < k; ++f) {
                lu[f] += e * rp[f];
                ru[f] += e * lp[f];
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* BELL side-table builder (host data-loader fast path)               */
/* ------------------------------------------------------------------ */

/* Fill one BELL side's flat tables in a single pass over the entries.
 *
 * The numpy builder (ops/bell.py::_side_tables) re-scans the full entry
 * array once PER BUCKET (sel = (own_s >= b0) & (own_s < b1)) after a
 * stable O(nnz log nnz) sort; this routine exploits the same invariant
 * it relies on — entries arrive in file order, i.e. row-major with
 * ascending columns within a row — to assign every entry its (bucket,
 * slot, column) in one O(nnz + slots + dim) pass, producing BIT-
 * IDENTICAL tables (same slot order per row: arrival order).
 *
 * Layout contract (must match _side_tables exactly): bucket b with
 * rows [b0, b1) and width w stores a row-major (w, n=b1-b0) table of
 * int32 opposite-side indices and one of values; the per-bucket tables
 * are concatenated flat in bucket order.  Padding slots carry index
 * ``other_dim`` (the appended zero factor row) and value 0.
 *
 * own/other: the entry coordinates (original id space); inv_own /
 * inv_other: permuted position per original id; b0/b1/w/base: bucket
 * bounds, widths and flat base offsets (base[b] = sum of earlier
 * buckets' w*n); slot_next: (dim,) zeroed scratch; bkt_of: (dim,)
 * scratch.  vals_flat is float32 or float64 per vals_f64 (the bf16
 * table path stays on numpy).  total = base[nb-1] + w*n of the last
 * bucket.  Returns 0, or -1 if an entry addresses a row outside every
 * bucket (impossible for valid input: every nonzero-degree row is
 * bucketed).                                                          */
long rs_bell_side(long nnz, const int32_t *own, const int32_t *other,
                  const double *vals,
                  const int32_t *inv_own, const int32_t *inv_other,
                  long dim, long other_dim, long total,
                  long nb, const int64_t *b0, const int64_t *b1,
                  const int64_t *base,
                  int32_t *cols_flat, void *vals_flat, int vals_f64,
                  int32_t *slot_next, int32_t *bkt_of) {
    for (long x = 0; x < total; ++x) cols_flat[x] = (int32_t)other_dim;
    if (vals_f64) {
        double *vf = (double *)vals_flat;
        for (long x = 0; x < total; ++x) vf[x] = 0.0;
    } else {
        float *vf = (float *)vals_flat;
        for (long x = 0; x < total; ++x) vf[x] = 0.0f;
    }
    for (long x = 0; x < dim; ++x) bkt_of[x] = -1;
    for (long b = 0; b < nb; ++b)
        for (int64_t p = b0[b]; p < b1[b]; ++p) bkt_of[p] = (int32_t)b;
    for (long e = 0; e < nnz; ++e) {
        long p = inv_own[own[e]];
        long b = bkt_of[p];
        if (b < 0) return -1;
        long n = (long)(b1[b] - b0[b]);
        long s = slot_next[p]++;
        long off = base[b] + s * n + (p - b0[b]);
        cols_flat[off] = inv_other[other[e]];
        if (vals_f64) ((double *)vals_flat)[off] = vals[e];
        else ((float *)vals_flat)[off] = (float)vals[e];
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* .in writer (fixture generation fast path)                          */
/* ------------------------------------------------------------------ */

/* Format nnz entries as "row col v.vvvvvv\n" lines into out (caller
 * allocates >= nnz * 32 bytes). Returns bytes written. %.6f semantics
 * with round-half-even matching printf for the 0..5 rating range.     */
long rs_format_entries(long nnz, const int32_t *rows, const int32_t *cols,
                       const double *vals, char *out) {
    char *q = out;
    for (long n = 0; n < nnz; ++n) {
        long r = rows[n], c = cols[n];
        char tmp[24];
        int t = 0;
        if (r == 0) *q++ = '0';
        else {
            while (r) { tmp[t++] = (char)('0' + r % 10); r /= 10; }
            while (t) *q++ = tmp[--t];
        }
        *q++ = ' ';
        if (c == 0) *q++ = '0';
        else {
            while (c) { tmp[t++] = (char)('0' + c % 10); c /= 10; }
            while (t) *q++ = tmp[--t];
        }
        *q++ = ' ';
        double v = vals[n];
        if (v < 0) { *q++ = '-'; v = -v; }
        /* Fast path only when v*1e6 is exactly an integer (true for
         * every rating this repo generates: {1..5} and half-stars):
         * the product is then exact and formatting is unambiguous.
         * Otherwise defer to printf's %.6f, which rounds the EXACT
         * binary value — computing round(v*1e6) double-rounds and can
         * differ from printf by 1e-6 at tie boundaries, breaking
         * byte-identity with the numpy fallback writer. */
        double scaled = v * 1e6;
        if (!(scaled < 9e15) || scaled != floor(scaled)) {
            q += sprintf(q, "%.6f", v);
            *q++ = '\n';
            continue;
        }
        uint64_t u = (uint64_t)scaled;
        uint64_t whole = u / 1000000, frac = u % 1000000;
        if (whole == 0) *q++ = '0';
        else {
            while (whole) { tmp[t++] = (char)('0' + whole % 10); whole /= 10; }
            while (t) *q++ = tmp[--t];
        }
        *q++ = '.';
        for (int d = 5; d >= 0; --d) tmp[d] = (char)('0' + frac % 10), frac /= 10;
        for (int d = 0; d < 6; ++d) *q++ = tmp[d];
        *q++ = '\n';
    }
    return (long)(q - out);
}
