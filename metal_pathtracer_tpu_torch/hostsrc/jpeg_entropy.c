/* Huffman entropy decoding of JPEG scans into DCT coefficient blocks
 * (ITU T.81 Annex F and G; libjpeg-turbo's jdhuff.c and jdphuff.c), the
 * bit-serial part of utils/jpeg.py. Baseline and extended sequential
 * scans (SOF0, SOF1) and progressive scans (SOF2: DC first and refine, AC
 * first and refine with end-of-band runs), interleaved or not, with
 * restart intervals; and lossless scans (SOF3, Annex H) into samples,
 * undifferenced here. Dequantisation, the IDCT, upsampling and colour
 * conversion stay in Python.
 *
 * Coefficients are stored in natural (row-major) order, int16, one
 * 64-entry block after another, each component's blocks row-major over
 * its allocated grid. A marker met inside the entropy-coded data feeds
 * zero bits from there on, as libjpeg does.
 *
 * Build: cc -O2 -shared -fPIC (utils/nativebuild.build_host_library).
 */

#include <stdint.h>
#include <string.h>

#define MAX_SCAN_COMPS 4

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* a corrupt run past the end lands here, harmlessly */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    const uint8_t *data;
    int64_t len, pos;
    uint64_t acc;   /* bits, most significant first */
    int bits;       /* valid bits in acc */
    int at_marker;  /* pos is at a marker: feed zeros */
} bitreader;

typedef struct {
    int32_t maxcode[18];  /* largest code of each length, -1 if none */
    int32_t valoffset[18];
    uint8_t lookup_len[512];  /* 9-bit lookahead: code length, 0 if longer */
    uint8_t lookup_val[512];
    uint8_t vals[256];
    int present;
} huffman;

static void fill(bitreader *b) {
    while (b->bits <= 56) {
        int byte = 0;
        if (!b->at_marker && b->pos < b->len) {
            byte = b->data[b->pos];
            if (byte == 0xFF) {
                int next = b->pos + 1 < b->len ? b->data[b->pos + 1] : -1;
                if (next == 0x00) {
                    b->pos += 2;
                } else {
                    b->at_marker = 1;
                    byte = 0;
                }
            } else {
                b->pos += 1;
            }
        }
        b->acc |= (uint64_t)byte << (56 - b->bits);
        b->bits += 8;
    }
}

static inline int get_bits(bitreader *b, int n) {
    if (n == 0) return 0;
    if (b->bits < n) fill(b);
    int v = (int)(b->acc >> (64 - n));
    b->acc <<= n;
    b->bits -= n;
    return v;
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* counts: 16 code-length counts; vals: the symbols. Returns 0, or -1 for
 * a table that does not form a prefix code. */
static int build_huffman(huffman *h, const int32_t *counts,
                         const int32_t *vals) {
    int code = 0, k = 0;
    memset(h, 0, sizeof(*h));
    for (int len = 1; len <= 16; len++) {
        int n = counts[len - 1];
        h->valoffset[len] = k - code;
        if (n) {
            for (int i = 0; i < n; i++, k++, code++) {
                if (k >= 256) return -1;
                h->vals[k] = (uint8_t)vals[k];
                if (len <= 9) {
                    int lo = code << (9 - len), hi = (code + 1) << (9 - len);
                    for (int p = lo; p < hi; p++) {
                        h->lookup_len[p] = (uint8_t)len;
                        h->lookup_val[p] = (uint8_t)vals[k];
                    }
                }
            }
            h->maxcode[len] = code - 1;
        } else {
            h->maxcode[len] = -1;
        }
        if (code > (1 << len)) return -1;
        code <<= 1;
    }
    h->maxcode[17] = 0x7FFFFFFF;
    h->present = 1;
    return 0;
}

/* Returns the symbol, or -1 for a code the table does not hold. */
static inline int decode_symbol(bitreader *b, const huffman *h) {
    if (b->bits < 16) fill(b);
    int peek = (int)(b->acc >> (64 - 9));
    int len = h->lookup_len[peek];
    if (len) {
        b->acc <<= len;
        b->bits -= len;
        return h->lookup_val[peek];
    }
    int code = (int)(b->acc >> (64 - 9));
    len = 9;
    while (1) {
        len++;
        if (len > 16) return -1;
        code = (int)(b->acc >> (64 - len));
        if (code <= h->maxcode[len]) break;
    }
    b->acc <<= len;
    b->bits -= len;
    return h->vals[code + h->valoffset[len]];
}

typedef struct {
    int h, v, alloc_bw;
    int16_t *coef;
    const huffman *dc, *ac;
    int pred;
} scan_comp;

/* Skip to the restart marker (RST0-7) and past it; returns 0, or -1 when
 * no restart marker follows. */
static int restart(bitreader *b) {
    int64_t p = b->pos;
    while (p + 1 < b->len) {
        if (b->data[p] == 0xFF && b->data[p + 1] >= 0xD0 &&
            b->data[p + 1] <= 0xD7) {
            b->pos = p + 2;
            b->acc = 0;
            b->bits = 0;
            b->at_marker = 0;
            return 0;
        }
        if (b->data[p] == 0xFF && b->data[p + 1] != 0x00 &&
            b->data[p + 1] != 0xFF)
            return -1;
        p++;
    }
    return -1;
}

/* The offset of the marker that ends the scan. */
static int64_t next_marker(const bitreader *b) {
    int64_t p = b->pos;
    while (p + 1 < b->len) {
        int next = b->data[p + 1];
        if (b->data[p] == 0xFF && next != 0x00 && next != 0xFF &&
            !(next >= 0xD0 && next <= 0xD7))
            return p;
        p++;
    }
    return b->len;
}

/*
 * Decode one scan. ``data``/``len``: the whole file; ``pos``: the first
 * byte after the SOS header. ``params`` (int32):
 *   [0] components in the scan (1-4), [1] Ss, [2] Se, [3] Ah, [4] Al,
 *   [5] progressive, [6] restart interval in MCUs (0: none),
 *   [7], [8] MCUs per row and per column (a one-component scan: the
 *   component's own block grid, one block an MCU),
 *   then per scan component (at 9 + 5 c): h, v, blocks per row of its
 *   array, DC table slot (0-3), AC table slot (0-3).
 * ``tables``: 8 slots (DC 0-3, AC 0-3) of 16 counts then 256 symbols
 * (int32), ``present``: a bit per slot. ``coefs``: each scan component's
 * block array. Returns the offset of the marker that ends the scan, or
 * -1 for a missing table, -2 for a bad code, -3 for a missing restart
 * marker, -4 for bad parameters.
 */
int64_t mpt_jpeg_decode_scan(const uint8_t *data, int64_t len, int64_t pos,
                             const int32_t *params, const int32_t *tables,
                             int32_t present, int16_t **coefs) {
    int ncomp = params[0], ss = params[1], se = params[2], ah = params[3],
        al = params[4], progressive = params[5], interval = params[6],
        mcus_x = params[7], mcus_y = params[8];
    if (ncomp < 1 || ncomp > MAX_SCAN_COMPS || ss < 0 || se > 63 ||
        ss > se || al < 0 || al > 13 || mcus_x < 0 || mcus_y < 0)
        return -4;
    huffman tab[8];
    for (int t = 0; t < 8; t++) {
        tab[t].present = 0;
        if (present & (1 << t)) {
            if (build_huffman(&tab[t], tables + t * 272, tables + t * 272 + 16))
                return -2;
        }
    }
    int dc_scan = ss == 0, need_dc = dc_scan && !(progressive && ah);
    int need_ac = se > 0;
    scan_comp comp[MAX_SCAN_COMPS];
    for (int c = 0; c < ncomp; c++) {
        const int32_t *p = params + 9 + 5 * c;
        comp[c].h = p[0];
        comp[c].v = p[1];
        comp[c].alloc_bw = p[2];
        comp[c].dc = &tab[p[3] & 3];
        comp[c].ac = &tab[4 + (p[4] & 3)];
        comp[c].coef = coefs[c];
        comp[c].pred = 0;
        if ((need_dc && (p[3] > 3 || !comp[c].dc->present)) ||
            (need_ac && (p[4] > 3 || !comp[c].ac->present)))
            return -1;
        if (ncomp == 1) comp[c].h = comp[c].v = 1;
    }
    bitreader b = {data, len, pos, 0, 0, 0};
    int eobrun = 0;
    const int p1 = 1 << al, m1 = -(1 << al);
    int64_t total = (int64_t)mcus_x * mcus_y, left = interval;
    for (int64_t m = 0; m < total; m++) {
        if (interval && left == 0) {
            if (restart(&b)) return -3;
            left = interval;
            eobrun = 0;
            for (int c = 0; c < ncomp; c++) comp[c].pred = 0;
        }
        int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
        for (int c = 0; c < ncomp; c++) {
            scan_comp *sc = &comp[c];
            for (int by = 0; by < sc->v; by++) {
                for (int bx = 0; bx < sc->h; bx++) {
                    int64_t row = (int64_t)my * sc->v + by;
                    int64_t col = (int64_t)mx * sc->h + bx;
                    int16_t *blk = sc->coef + (row * sc->alloc_bw + col) * 64;
                    if (!progressive) {
                        int s = decode_symbol(&b, sc->dc);
                        if (s < 0 || s > 15) return -2;
                        int diff = s ? extend(get_bits(&b, s), s) : 0;
                        sc->pred += diff;
                        blk[0] = (int16_t)sc->pred;
                        for (int k = 1; k <= 63; k++) {
                            int rs = decode_symbol(&b, sc->ac);
                            if (rs < 0) return -2;
                            int r = rs >> 4;
                            s = rs & 15;
                            if (s) {
                                k += r;
                                blk[natural_order[k]] =
                                    (int16_t)extend(get_bits(&b, s), s);
                            } else if (r == 15) {
                                k += 15;
                            } else {
                                break;
                            }
                        }
                    } else if (dc_scan) {
                        if (!ah) {
                            int s = decode_symbol(&b, sc->dc);
                            if (s < 0 || s > 15) return -2;
                            int diff = s ? extend(get_bits(&b, s), s) : 0;
                            sc->pred += diff;
                            blk[0] = (int16_t)(sc->pred * (1 << al));
                        } else if (get_bits(&b, 1)) {
                            blk[0] = (int16_t)(blk[0] | p1);
                        }
                    } else if (!ah) {   /* AC first */
                        if (eobrun > 0) {
                            eobrun--;
                            continue;
                        }
                        for (int k = ss; k <= se; k++) {
                            int rs = decode_symbol(&b, sc->ac);
                            if (rs < 0) return -2;
                            int r = rs >> 4, s = rs & 15;
                            if (s) {
                                k += r;
                                blk[natural_order[k]] = (int16_t)(
                                    extend(get_bits(&b, s), s) * (1 << al));
                            } else if (r == 15) {
                                k += 15;
                            } else {
                                eobrun = 1 << r;
                                if (r) eobrun += get_bits(&b, r);
                                eobrun--;
                                break;
                            }
                        }
                    } else {            /* AC refine (jdphuff.c) */
                        int k = ss;
                        if (eobrun == 0) {
                            for (; k <= se; k++) {
                                int rs = decode_symbol(&b, sc->ac);
                                if (rs < 0) return -2;
                                int r = rs >> 4, s = rs & 15;
                                if (s) {
                                    s = get_bits(&b, 1) ? p1 : m1;
                                } else if (r != 15) {
                                    eobrun = 1 << r;
                                    if (r) eobrun += get_bits(&b, r);
                                    break;
                                }
                                do {
                                    int16_t *t = blk + natural_order[k];
                                    if (*t != 0) {
                                        if (get_bits(&b, 1) &&
                                            (*t & p1) == 0)
                                            *t = (int16_t)(*t >= 0 ? *t + p1
                                                                   : *t + m1);
                                    } else if (--r < 0) {
                                        break;
                                    }
                                    k++;
                                } while (k <= se);
                                if (s && k <= 63) blk[natural_order[k]] =
                                    (int16_t)s;
                            }
                        }
                        if (eobrun > 0) {
                            for (; k <= se; k++) {
                                int16_t *t = blk + natural_order[k];
                                if (*t != 0 && get_bits(&b, 1) &&
                                    (*t & p1) == 0)
                                    *t = (int16_t)(*t >= 0 ? *t + p1
                                                           : *t + m1);
                            }
                            eobrun--;
                        }
                    }
                }
            }
        }
        if (interval) left--;
    }
    return next_marker(&b);
}

/*
 * Decode one lossless (SOF3) scan into sample planes (T.81 Annex H;
 * libjpeg-turbo's jdlhuff.c, jddiffct.c and jdlossls.c): the Huffman-coded
 * differences (category 16 is 32768 with no extra bits), then each
 * component row undifferenced with the scan's predictor, modulo 2^16.
 * The first row of the scan and the first row after each restart marker
 * predict from the left (the first sample from 2^(P - Pt - 1)); the
 * first column of any other row from above. ``params`` (int32):
 *   [0] components in the scan (1-4), [1] predictor (1-7), [2] point
 *   transform Pt, [3] restart interval in MCUs (0: none; a multiple of
 *   the MCUs in a row), [4], [5] MCUs per row and per column (a
 *   one-component scan: the component's own width and height, one sample
 *   an MCU), [6] sample precision,
 *   then per scan component (at 7 + 4 c): h, v, samples per row of its
 *   plane, DC table slot (0-3).
 * ``planes``: each scan component's int32 plane, rows of ``samples per
 * row``, at least MCUs per column x v rows; it receives the undifferenced
 * samples (before the point transform's shift). Returns the offset of the
 * marker that ends the scan, or jpeg_entropy's error codes.
 */
int64_t mpt_jpeg_decode_lossless(const uint8_t *data, int64_t len,
                                 int64_t pos, const int32_t *params,
                                 const int32_t *tables, int32_t present,
                                 int32_t **planes) {
    int ncomp = params[0], predictor = params[1], pt = params[2],
        interval = params[3], mcus_x = params[4], mcus_y = params[5],
        precision = params[6];
    if (ncomp < 1 || ncomp > MAX_SCAN_COMPS || predictor < 1 ||
        predictor > 7 || pt < 0 || pt >= precision || mcus_x <= 0 ||
        mcus_y <= 0 || (interval && interval % mcus_x))
        return -4;
    huffman tab[4];
    int h[MAX_SCAN_COMPS], v[MAX_SCAN_COMPS], bw[MAX_SCAN_COMPS];
    const huffman *dc[MAX_SCAN_COMPS];
    for (int t = 0; t < 4; t++) {
        tab[t].present = 0;
        if ((present & (1 << t)) &&
            build_huffman(&tab[t], tables + t * 272, tables + t * 272 + 16))
            return -2;
    }
    for (int c = 0; c < ncomp; c++) {
        const int32_t *p = params + 7 + 4 * c;
        h[c] = ncomp == 1 ? 1 : p[0];
        v[c] = ncomp == 1 ? 1 : p[1];
        bw[c] = p[2];
        if (p[3] > 3) return -1;
        dc[c] = &tab[p[3]];
        if (!dc[c]->present) return -1;
        if (mcus_x * h[c] > bw[c]) return -4;
    }
    bitreader b = {data, len, pos, 0, 0, 0};
    int rows_per_interval = interval ? interval / mcus_x : 0;
    const int initial = 1 << (precision - pt - 1);
    for (int my = 0; my < mcus_y; my++) {
        int first = my == 0;
        if (rows_per_interval && my && my % rows_per_interval == 0) {
            if (restart(&b)) return -3;
            first = 1;
        }
        /* the differences of one MCU row */
        for (int mx = 0; mx < mcus_x; mx++) {
            for (int c = 0; c < ncomp; c++) {
                for (int y = 0; y < v[c]; y++) {
                    int32_t *row = planes[c] +
                        ((int64_t)my * v[c] + y) * bw[c] + (int64_t)mx * h[c];
                    for (int x = 0; x < h[c]; x++) {
                        int s = decode_symbol(&b, dc[c]);
                        if (s < 0 || s > 16) return -2;
                        row[x] = s == 16 ? 32768
                                         : s ? extend(get_bits(&b, s), s) : 0;
                    }
                }
            }
        }
        /* undifference each component row of it, left to right */
        for (int c = 0; c < ncomp; c++) {
            int width = mcus_x * h[c];
            for (int y = 0; y < v[c]; y++) {
                int64_t r = (int64_t)my * v[c] + y;
                int32_t *row = planes[c] + r * bw[c];
                if (first && y == 0) {
                    int ra = (row[0] + initial) & 0xFFFF;
                    row[0] = ra;
                    for (int x = 1; x < width; x++)
                        row[x] = ra = (row[x] + ra) & 0xFFFF;
                    continue;
                }
                const int32_t *up = row - bw[c];
                int rb = up[0], ra = (row[0] + rb) & 0xFFFF, rc, px;
                row[0] = ra;
                for (int x = 1; x < width; x++) {
                    rc = rb;
                    rb = up[x];
                    switch (predictor) {
                    case 1: px = ra; break;
                    case 2: px = rb; break;
                    case 3: px = rc; break;
                    case 4: px = ra + rb - rc; break;
                    case 5: px = ra + ((rb - rc) >> 1); break;
                    case 6: px = rb + ((ra - rc) >> 1); break;
                    default: px = (ra + rb) >> 1; break;
                    }
                    row[x] = ra = (row[x] + px) & 0xFFFF;
                }
            }
        }
    }
    return next_marker(&b);
}
