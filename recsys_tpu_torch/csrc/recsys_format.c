/* The printed top-1 list in one native pass (the port's own source).
 *
 * The reference prints, for each user with an unrated item, the index of
 * its highest-predicted unrated item and a newline, and skips a user whose
 * every item is rated (matFact.c:10-27, the max == -1 skip at :24).
 * recsys_tpu_torch/io/writers.py::format_recommendations calls this entry
 * through ctypes (recsys_tpu_torch/io/_native.py, which builds this file
 * into the same library as recsys_native.c); its numpy twin in the same
 * module gives the same bytes where the library is missing.
 */

#include <stdint.h>
#include <string.h>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "rs_format_top1 stores each line as a little-endian word"
#endif

/* Write top1[u] in decimal and '\n' for every u < n with
 * rated_counts[u] < items, into out; returns the bytes written.  Both
 * arrays are int32, the engine's own dtype, so the caller hands them over
 * without a copy.  The caller sizes out: n times (the digits of the
 * largest |top1[u]|, plus a sign where one is negative, plus one), plus 8
 * bytes of slack for the last user's word store. */
long rs_format_top1(long n, const int32_t *top1, const int32_t *rated_counts,
                    long items, char *out) {
    char *q = out;
    for (long u = 0; u < n; ++u) {
        if (rated_counts[u] >= items) continue;
        int64_t v = top1[u];
        if (v < 0) {
            *q++ = '-';
            v = -v;
        }
        /* The line "digits\n" as the bytes of one little-endian word, the
         * most significant digit in its lowest byte: at most 10 digits and
         * the newline, so a word of 8 takes up to 7 digits. */
        uint64_t line = '\n';
        int len = 1;
        do {
            line = (line << 8) | (uint64_t)('0' + v % 10);
            v /= 10;
            ++len;
        } while (v && len < 8);
        if (v) { /* more than 7 digits: the rest, most significant first */
            char tmp[4];
            int t = 0;
            do {
                tmp[t++] = (char)('0' + v % 10);
                v /= 10;
            } while (v);
            while (t) *q++ = tmp[--t];
        }
        memcpy(q, &line, 8);
        q += len;
    }
    return (long)(q - out);
}
