/* Block smoothing of a progressive JPEG's coefficients (libjpeg-turbo's
 * jdcoefct.c decompress_smooth_data, ITU T.81 K.8 over a 5x5 window of DC
 * values), the step before the IDCT that utils/jpeg.py runs when a
 * progressive file leaves one of the first zigzag coefficients unrefined.
 *
 * Each block's AC coefficients of zigzag 1-5 are estimated from the DC
 * values of its 5x5 neighbourhood where the coefficient is still zero and
 * not known to full precision; when no AC coefficient of zigzag 1-9 was
 * coded at all, zigzag 6-9 are estimated too and the DC value becomes a
 * weighted average of the neighbourhood. The neighbours are the blocks
 * libjpeg-turbo reads: columns and rows clamped to the component's
 * blocks, but for two row rules of a component with v_samp > 1 (in
 * mpt_jpeg_smooth; the rule its output shows, bit for bit).
 *
 * Build: cc -O2 -shared -fPIC (utils/nativebuild.build_host_library).
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* the natural positions of zigzag coefficients 1-9 */
static const int smooth_pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

/* 5x5 weights (rows above to below, columns left to right) of each
 * estimate: [0] without DC interpolation (zigzag 1-5 only), [1] with. */
static const int smooth_w[2][10][25] = {
    {{0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0,
      0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
      0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0,
      1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0}, {0}, {0}, {0}},
    {{-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
      -6, 6, 42, 6, -6, -2, -6, -8, -6, -2},
     {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
      -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
     {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
      1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
     {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
      0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
     {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0,
      0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
     {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1,
      0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0,
      0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0,
      0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0,
      0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0,
      0, -1, -2, -1, 0, 0, 0, 0, 0, 0}}};

/* An estimate num / (256 q), rounded half away from zero and limited
 * below 2^al where the coefficient is known to bit al. */
static int smooth_estimate(int64_t num, int64_t q, int al) {
    int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return (int)(num >= 0 ? pred : -pred);
}

/*
 * Smooth one component. ``coef``: its blocks, rows of ``alloc_bw``
 * blocks of 64 int16 in natural order, at least ``height`` rows;
 * ``out`` (the same layout) receives the blocks to transform, the real
 * ``height`` x ``width`` of them. ``v_samp``: the component's vertical
 * sampling factor, ``imcu_rows``: the frame's iMCU rows. ``coef_bits``:
 * the successive-approximation state of zigzag 0-9 (-1: never coded);
 * ``quant``: the quantisation table in natural order.
 */
void mpt_jpeg_smooth(const int16_t *coef, int16_t *out, int alloc_bw,
                     int alloc_rows, int width, int height, int v_samp,
                     int imcu_rows, const int32_t *coef_bits,
                     const int32_t *quant) {
    int change_dc = 1;
    for (int k = 1; k <= 9; k++)
        if (coef_bits[k] != -1) change_dc = 0;
    const int last_imcu = imcu_rows - 1;
    const int64_t q00 = quant[0];
    for (int imcu = 0; imcu <= last_imcu; imcu++) {
        int block_rows = v_samp;
        if (imcu == last_imcu) {
            block_rows = height % v_samp;
            if (block_rows == 0) block_rows = v_samp;
        }
        for (int br = 0; br < block_rows; br++) {
            int r = imcu * v_samp + br;
            if (r >= height) break;
            /* the rows above and below, clamped to the real rows, but
             * where v_samp > 1 the row two below comes from the next iMCU
             * row even if it is a dummy row (zeros unless an interleaved
             * scan coded it), and an iMCU row 1 that is the last and
             * holds one block row takes the row above for the one two
             * above */
            int rows[5];
            rows[2] = r;
            rows[1] = r > 0 ? r - 1 : r;
            rows[0] = r > 1 ? r - 2 : rows[1];
            if (v_samp > 1 && imcu == 1 && last_imcu == 1 && block_rows == 1)
                rows[0] = rows[1];
            rows[3] = r + 1 < height ? r + 1 : r;
            rows[4] = r + 2 < height ? r + 2 : rows[3];
            if (v_samp > 1 && imcu < last_imcu) rows[4] = r + 2;
            const int16_t *line[5];   /* NULL: a dummy row not stored */
            for (int i = 0; i < 5; i++)
                line[i] = rows[i] < alloc_rows
                              ? coef + (int64_t)rows[i] * alloc_bw * 64
                              : NULL;
            const int last_col = width - 1;
            for (int b = 0; b < width; b++) {
                int dc[5][5];   /* [row][column]: columns b-2 .. b+2 */
                for (int j = 0; j < 5; j++) {
                    int col = b + j - 2;
                    col = col < 0 ? 0 : col > last_col ? last_col : col;
                    for (int i = 0; i < 5; i++)
                        dc[i][j] = line[i] ? line[i][(int64_t)col * 64] : 0;
                }
                int16_t ws[64];
                memcpy(ws, line[2] + (int64_t)b * 64, sizeof(ws));
                for (int k = 1; k <= (change_dc ? 9 : 5); k++) {
                    int al = coef_bits[k], pos = smooth_pos[k];
                    if (al == 0 || ws[pos] != 0) continue;
                    int64_t sum = 0;
                    for (int i = 0; i < 25; i++)
                        sum += smooth_w[change_dc][k][i] * dc[i / 5][i % 5];
                    ws[pos] = (int16_t)smooth_estimate(q00 * sum, quant[pos],
                                                       al);
                }
                if (change_dc) {
                    int64_t sum = 0;
                    for (int i = 0; i < 25; i++)
                        sum += smooth_w[1][0][i] * dc[i / 5][i % 5];
                    ws[0] = (int16_t)smooth_estimate(q00 * sum, q00, 0);
                }
                memcpy(out + ((int64_t)r * alloc_bw + b) * 64, ws,
                       sizeof(ws));
            }
        }
    }
}
