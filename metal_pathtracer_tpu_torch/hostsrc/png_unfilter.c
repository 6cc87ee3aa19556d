/* The PNG scanline filters undone (ISO 15948, section 9: None, Sub, Up,
 * Average, Paeth), the byte-serial part of utils/image_io.decode_png.
 *
 * Build: with jpeg_entropy.c, cc -O2 -shared -fPIC
 * (utils/nativebuild.build_host_library).
 */

#include <stddef.h>
#include <stdint.h>

/* The filters undone into ``out`` (h rows of ``stride`` bytes), from
 * ``raw`` (h rows of a filter byte and ``stride`` bytes); ``bpp``:
 * bytes a pixel, at least 1. Returns 0, or the row + 1 of a filter type
 * outside 0-4, negated. */
int mpt_png_unfilter(const uint8_t *raw, uint8_t *out, int64_t h,
                     int64_t stride, int bpp) {
    const uint8_t *prior = NULL;
    for (int64_t y = 0; y < h; y++) {
        const uint8_t *src = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        int kind = raw[y * (stride + 1)];
        for (int64_t i = 0; i < stride; i++) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            int up = prior ? prior[i] : 0;
            int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
            int pred;
            switch (kind) {
            case 0: pred = 0; break;
            case 1: pred = a; break;
            case 2: pred = up; break;
            case 3: pred = (a + up) >> 1; break;
            case 4: {
                int p = a + up - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > up ? p - up : up - p;
                int pc = p > c ? p - c : c - p;
                pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? up : c);
                break;
            }
            default: return -(int)(y + 1);
            }
            cur[i] = (uint8_t)(src[i] + pred);
        }
        prior = cur;
    }
    return 0;
}
