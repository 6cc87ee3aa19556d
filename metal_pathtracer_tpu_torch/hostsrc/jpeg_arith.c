/* Arithmetic entropy decoding of JPEG scans into DCT coefficient blocks
 * (ITU T.81 Annex D, F.1.4, F.2.4 and G.1.3; libjpeg's jdarith.c), the
 * bit-serial part of utils/jpeg.py for SOF9 (sequential) and SOF10
 * (progressive: DC first and refine, AC first and refine) files,
 * interleaved or not, with restart intervals and the conditioning of DAC
 * segments. The coefficient layout is jpeg_entropy.c's: natural order,
 * int16, one 64-entry block after another, each component's blocks
 * row-major over its allocated grid.
 *
 * Statistics are zeroed at the start of every scan and at every restart
 * marker, for the tables the scan codes with (jdarith.c start_pass and
 * process_restart). A marker met inside the coded data feeds zero bytes
 * from there on, as T.81 D.2.6 allows.
 *
 * Build: cc -O2 -shared -fPIC (utils/nativebuild.build_host_library).
 */

#include <stdint.h>
#include <string.h>

#define MAX_SCAN_COMPS 4
#define DC_STAT_BINS 64
#define AC_STAT_BINS 256
#define NUM_ARITH_TBLS 16

static const int arith_natural_order[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* T.81 Table D.2: Qe << 16 | Switch_MPS << 7 | Next_Index_LPS, and
 * Next_Index_MPS << 8; entry 113 is the fixed probability 0.5 of T.851
 * that libjpeg codes the signs and the DC refinement bits with. */
#define V(qe, nlps, nmps, sw) \
    (((int64_t)(qe) << 16) | ((int64_t)(nmps) << 8) | ((sw) << 7) | (nlps))
static const int64_t aritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),   V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),   V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),   V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),  V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),  V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),  V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),  V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),  V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),  V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),  V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),  V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),  V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),  V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),  V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),  V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),  V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),  V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),  V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),  V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),  V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),  V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),  V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),  V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),  V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),  V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),  V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),  V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),  V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),  V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),  V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),  V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),  V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),  V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

typedef struct {
    const uint8_t *data;
    int64_t len, pos;
    int64_t c;      /* base of the interval and the bits not yet used */
    int64_t a;      /* the interval's size, normalised */
    int ct;         /* bits left in c's buffer part; -16 before the first */
    int at_marker;  /* pos is at a marker: feed zeros */
    uint8_t dc_stats[NUM_ARITH_TBLS][DC_STAT_BINS];
    uint8_t ac_stats[NUM_ARITH_TBLS][AC_STAT_BINS];
    uint8_t fixed_bin;
} arith_decoder;

static int arith_byte(arith_decoder *e) {
    if (e->at_marker) return 0;
    if (e->pos >= e->len) {
        e->at_marker = 1;
        return 0;
    }
    int data = e->data[e->pos++];
    if (data != 0xFF) return data;
    int64_t start = e->pos - 1;
    do {
        if (e->pos >= e->len) {
            e->at_marker = 1;
            return 0;
        }
        data = e->data[e->pos++];
    } while (data == 0xFF);
    if (data == 0) return 0xFF;   /* a stuffed zero */
    e->pos = start;               /* a marker: leave it for the caller */
    e->at_marker = 1;
    return 0;
}

/* One binary decision in the statistics bin *st (T.81 D.2.4-D.2.6). */
static int arith_decode(arith_decoder *e, uint8_t *st) {
    while (e->a < 0x8000) {
        if (--e->ct < 0) {
            e->c = (e->c << 8) | arith_byte(e);
            if ((e->ct += 8) < 0 && ++e->ct == 0)
                e->a = 0x8000;   /* two initial bytes: a becomes 0x10000 */
        }
        e->a <<= 1;
    }
    int sv = *st;
    int64_t qe = aritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {   /* conditional exchange: the MPS */
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

static void arith_reset(arith_decoder *e) {
    memset(e->dc_stats, 0, sizeof(e->dc_stats));
    memset(e->ac_stats, 0, sizeof(e->ac_stats));
    e->fixed_bin = 113;
    e->c = 0;
    e->a = 0;
    e->ct = -16;
}

/* Skip to the restart marker (RST0-7) and past it; returns 0, or -1 when
 * another marker comes first. */
static int arith_restart(arith_decoder *e) {
    int64_t p = e->pos;
    while (p + 1 < e->len) {
        if (e->data[p] == 0xFF && e->data[p + 1] >= 0xD0 &&
            e->data[p + 1] <= 0xD7) {
            e->pos = p + 2;
            e->at_marker = 0;
            arith_reset(e);
            return 0;
        }
        if (e->data[p] == 0xFF && e->data[p + 1] != 0x00 &&
            e->data[p + 1] != 0xFF)
            return -1;
        p++;
    }
    return -1;
}

static int64_t arith_next_marker(const arith_decoder *e) {
    int64_t p = e->pos;
    while (p + 1 < e->len) {
        int next = e->data[p + 1];
        if (e->data[p] == 0xFF && next != 0x00 && next != 0xFF &&
            !(next >= 0xD0 && next <= 0xD7))
            return p;
        p++;
    }
    return e->len;
}

typedef struct {
    int h, v, alloc_bw, dc_tbl, ac_tbl;
    int16_t *coef;
    int last_dc, dc_context;
} arith_comp;

/* A DC difference (F.1.4.4.1 and Figures F.19-F.24); updates the
 * component's conditioning. Returns 0, or -1 for a magnitude overflow. */
static int decode_dc_diff(arith_decoder *e, arith_comp *sc, int lo, int hi,
                          int *diff) {
    uint8_t *st = e->dc_stats[sc->dc_tbl] + sc->dc_context;
    if (arith_decode(e, st) == 0) {
        sc->dc_context = 0;
        *diff = 0;
        return 0;
    }
    int sign = arith_decode(e, st + 1);
    st += 2 + sign;
    int m = arith_decode(e, st);
    if (m) {
        st = e->dc_stats[sc->dc_tbl] + 20;   /* X1 */
        while (arith_decode(e, st)) {
            if ((m <<= 1) == 0x8000) return -1;
            st++;
        }
    }
    if (m < (int)((1L << lo) >> 1))
        sc->dc_context = 0;
    else if (m > (int)((1L << hi) >> 1))
        sc->dc_context = 12 + sign * 4;
    else
        sc->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(e, st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return 0;
}

/* A non-zero AC value at zigzag index k, its bins from ``st`` (S0 + 1). */
static int decode_ac_value(arith_decoder *e, uint8_t *stats, uint8_t *st,
                           int k, int kx, int *value) {
    int sign = arith_decode(e, &e->fixed_bin);
    int m = arith_decode(e, st);
    if (m && arith_decode(e, st)) {
        m <<= 1;
        st = stats + (k <= kx ? 189 : 217);
        while (arith_decode(e, st)) {
            if ((m <<= 1) == 0x8000) return -1;
            st++;
        }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(e, st)) v |= m;
    v += 1;
    *value = sign ? -v : v;
    return 0;
}

/*
 * Decode one arithmetic-coded scan. ``params`` as mpt_jpeg_decode_scan's
 * (jpeg_entropy.c): [0] components, [1] Ss, [2] Se, [3] Ah, [4] Al,
 * [5] progressive, [6] restart interval, [7], [8] MCUs per row and
 * column, then per component h, v, blocks per row, DC table, AC table.
 * ``cond``: the DAC conditioning of tables 0-15, L[16], U[16], K[16].
 * Returns the offset of the marker that ends the scan, or -2 for bad
 * data, -3 for a missing restart marker, -4 for bad parameters.
 */
int64_t mpt_jpeg_decode_scan_arith(const uint8_t *data, int64_t len,
                                   int64_t pos, const int32_t *params,
                                   const int32_t *cond, int16_t **coefs) {
    int ncomp = params[0], ss = params[1], se = params[2], ah = params[3],
        al = params[4], progressive = params[5], interval = params[6],
        mcus_x = params[7], mcus_y = params[8];
    if (ncomp < 1 || ncomp > MAX_SCAN_COMPS || ss < 0 || se > 63 ||
        ss > se || al < 0 || al > 13 || mcus_x < 0 || mcus_y < 0)
        return -4;
    arith_decoder dec;
    arith_decoder *e = &dec;
    memset(e, 0, sizeof(*e));
    e->data = data;
    e->len = len;
    e->pos = pos;
    arith_reset(e);
    arith_comp comp[MAX_SCAN_COMPS];
    for (int c = 0; c < ncomp; c++) {
        const int32_t *p = params + 9 + 5 * c;
        comp[c].h = ncomp == 1 ? 1 : p[0];
        comp[c].v = ncomp == 1 ? 1 : p[1];
        comp[c].alloc_bw = p[2];
        comp[c].dc_tbl = p[3] & 15;
        comp[c].ac_tbl = p[4] & 15;
        comp[c].coef = coefs[c];
        comp[c].last_dc = 0;
        comp[c].dc_context = 0;
    }
    const int p1 = 1 << al, m1 = -(1 << al);
    int64_t total = (int64_t)mcus_x * mcus_y, left = interval;
    for (int64_t m = 0; m < total; m++) {
        if (interval && left == 0) {
            if (arith_restart(e)) return -3;
            left = interval;
            for (int c = 0; c < ncomp; c++)
                comp[c].last_dc = comp[c].dc_context = 0;
        }
        int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
        for (int c = 0; c < ncomp; c++) {
            arith_comp *sc = &comp[c];
            int lo = cond[sc->dc_tbl], hi = cond[16 + sc->dc_tbl];
            int kx = cond[32 + sc->ac_tbl];
            uint8_t *acs = e->ac_stats[sc->ac_tbl];
            for (int by = 0; by < sc->v; by++) {
                for (int bx = 0; bx < sc->h; bx++) {
                    int64_t row = (int64_t)my * sc->v + by;
                    int64_t col = (int64_t)mx * sc->h + bx;
                    int16_t *blk = sc->coef + (row * sc->alloc_bw + col) * 64;
                    int diff, v;
                    if (!progressive) {
                        if (decode_dc_diff(e, sc, lo, hi, &diff)) return -2;
                        sc->last_dc = (sc->last_dc + diff) & 0xFFFF;
                        blk[0] = (int16_t)sc->last_dc;
                        for (int k = 0; k < se;) {   /* Figure F.20 */
                            uint8_t *st = acs + 3 * k;
                            if (arith_decode(e, st)) break;   /* EOB */
                            for (;;) {
                                k++;
                                if (arith_decode(e, st + 1)) break;
                                st += 3;
                                if (k >= se) return -2;
                            }
                            if (decode_ac_value(e, acs, st + 2, k, kx, &v))
                                return -2;
                            blk[arith_natural_order[k]] = (int16_t)v;
                        }
                    } else if (ss == 0 && ah == 0) {   /* DC first */
                        if (decode_dc_diff(e, sc, lo, hi, &diff)) return -2;
                        sc->last_dc = (sc->last_dc + diff) & 0xFFFF;
                        blk[0] = (int16_t)((uint32_t)sc->last_dc << al);
                    } else if (ss == 0) {              /* DC refine */
                        if (arith_decode(e, &e->fixed_bin))
                            blk[0] = (int16_t)(blk[0] | p1);
                    } else if (ah == 0) {              /* AC first */
                        for (int k = ss; k <= se; k++) {
                            uint8_t *st = acs + 3 * (k - 1);
                            if (arith_decode(e, st)) break;   /* EOB */
                            while (arith_decode(e, st + 1) == 0) {
                                st += 3;
                                if (++k > se) return -2;
                            }
                            if (decode_ac_value(e, acs, st + 2, k, kx, &v))
                                return -2;
                            blk[arith_natural_order[k]] =
                                (int16_t)((uint32_t)v << al);
                        }
                    } else {                           /* AC refine */
                        int kex = se;   /* the previous stage's EOB */
                        for (; kex > 0; kex--)
                            if (blk[arith_natural_order[kex]]) break;
                        for (int k = ss; k <= se; k++) {
                            uint8_t *st = acs + 3 * (k - 1);
                            if (k > kex && arith_decode(e, st)) break;
                            for (;;) {
                                int16_t *t = blk + arith_natural_order[k];
                                if (*t) {   /* previously non-zero */
                                    if (arith_decode(e, st + 2))
                                        *t = (int16_t)(*t < 0 ? *t + m1
                                                              : *t + p1);
                                    break;
                                }
                                if (arith_decode(e, st + 1)) {   /* new */
                                    *t = (int16_t)(arith_decode(
                                        e, &e->fixed_bin) ? m1 : p1);
                                    break;
                                }
                                st += 3;
                                if (++k > se) return -2;
                            }
                        }
                    }
                }
            }
        }
        if (interval) left--;
    }
    return arith_next_marker(e);
}
