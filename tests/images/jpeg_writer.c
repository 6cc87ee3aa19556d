/* A JPEG writer over the system's libjpeg(-turbo), for the fixtures that
 * Pillow's encoder cannot write: YCCK and CMYK with or without an Adobe
 * marker, any sampling factors, arithmetic coding with its conditioning,
 * progressive scripts of any scans, restart intervals. Compiled and run by
 * tests/images/make_fixtures.py only (never by the tests or the package):
 *
 *     cc -O2 -o jpeg_writer jpeg_writer.c -ljpeg
 *     jpeg_writer IN.raw OUT.jpg WIDTH HEIGHT SPACE [options]
 *
 * IN.raw holds the samples interleaved, row-major, 8-bit: three a pixel
 * for SPACE rgb (written as YCbCr), four for cmyk and ycck (written as
 * CMYK or YCCK). Options:
 *   -q Q              quality (default 75)
 *   -s H,V/H,V/...    sampling factors of each component
 *   -a                arithmetic coding
 *   -c L,U,K          arithmetic conditioning of every table (DAC)
 *   -p SCRIPT         progressive scans, "C C..:Ss-Se:Ah:Al;..." (the
 *                     components by index), or "simple"
 *   -r N              restart interval in MCUs
 *   -n                no JFIF or Adobe marker
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static int parse_script(const char *text, jpeg_scan_info *scans, int max) {
    int n = 0;
    const char *p = text;
    while (*p && n < max) {
        jpeg_scan_info *s = &scans[n];
        memset(s, 0, sizeof(*s));
        while (*p && *p != ':') {
            if (*p >= '0' && *p <= '9')
                s->component_index[s->comps_in_scan++] = *p - '0';
            p++;
        }
        if (sscanf(p, ":%d-%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4)
            return -1;
        while (*p && *p != ';') p++;
        if (*p == ';') p++;
        n++;
    }
    return n;
}

int main(int argc, char **argv) {
    if (argc < 6) {
        fprintf(stderr, "usage: %s IN.raw OUT.jpg W H SPACE [options]\n",
                argv[0]);
        return 2;
    }
    int w = atoi(argv[3]), h = atoi(argv[4]);
    const char *space = argv[5];
    int quality = 75, arith = 0, restart = 0, markers = 1, nscans = 0;
    int cond[3] = {-1, -1, -1}, factors[4][2], nfactors = 0;
    static jpeg_scan_info scans[64];
    const char *script = NULL;
    for (int i = 6; i < argc; i++) {
        if (!strcmp(argv[i], "-q") && i + 1 < argc) {
            quality = atoi(argv[++i]);
        } else if (!strcmp(argv[i], "-a")) {
            arith = 1;
        } else if (!strcmp(argv[i], "-c") && i + 1 < argc) {
            sscanf(argv[++i], "%d,%d,%d", &cond[0], &cond[1], &cond[2]);
        } else if (!strcmp(argv[i], "-p") && i + 1 < argc) {
            script = argv[++i];
        } else if (!strcmp(argv[i], "-r") && i + 1 < argc) {
            restart = atoi(argv[++i]);
        } else if (!strcmp(argv[i], "-n")) {
            markers = 0;
        } else if (!strcmp(argv[i], "-s") && i + 1 < argc) {
            const char *p = argv[++i];
            while (*p && nfactors < 4) {
                if (sscanf(p, "%d,%d", &factors[nfactors][0],
                           &factors[nfactors][1]) != 2)
                    return 2;
                nfactors++;
                while (*p && *p != '/') p++;
                if (*p == '/') p++;
            }
        } else {
            fprintf(stderr, "unknown option %s\n", argv[i]);
            return 2;
        }
    }
    int ch;
    J_COLOR_SPACE in_space, jpeg_space;
    if (!strcmp(space, "rgb")) {
        ch = 3; in_space = JCS_RGB; jpeg_space = JCS_YCbCr;
    } else if (!strcmp(space, "cmyk")) {
        ch = 4; in_space = JCS_CMYK; jpeg_space = JCS_CMYK;
    } else if (!strcmp(space, "ycck")) {
        ch = 4; in_space = JCS_CMYK; jpeg_space = JCS_YCCK;
    } else {
        fprintf(stderr, "unknown colour space %s\n", space);
        return 2;
    }
    size_t size = (size_t)w * h * ch;
    unsigned char *px = malloc(size);
    FILE *in = fopen(argv[1], "rb");
    if (!px || !in || fread(px, 1, size, in) != size) {
        fprintf(stderr, "cannot read %zu bytes from %s\n", size, argv[1]);
        return 1;
    }
    fclose(in);

    struct jpeg_compress_struct cinfo;
    struct jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&cinfo);
    FILE *out = fopen(argv[2], "wb");
    if (!out) return 1;
    jpeg_stdio_dest(&cinfo, out);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = ch;
    cinfo.in_color_space = in_space;
    jpeg_set_defaults(&cinfo);
    jpeg_set_colorspace(&cinfo, jpeg_space);
    jpeg_set_quality(&cinfo, quality, TRUE);
    if (!markers) {
        cinfo.write_JFIF_header = FALSE;
        cinfo.write_Adobe_marker = FALSE;
    }
    for (int c = 0; c < nfactors && c < cinfo.num_components; c++) {
        cinfo.comp_info[c].h_samp_factor = factors[c][0];
        cinfo.comp_info[c].v_samp_factor = factors[c][1];
    }
    cinfo.arith_code = arith ? TRUE : FALSE;
    if (cond[0] >= 0) {
        for (int t = 0; t < NUM_ARITH_TBLS; t++) {
            cinfo.arith_dc_L[t] = (UINT8)cond[0];
            cinfo.arith_dc_U[t] = (UINT8)cond[1];
            cinfo.arith_ac_K[t] = (UINT8)cond[2];
        }
    }
    cinfo.restart_interval = restart;
    if (script && !strcmp(script, "simple")) {
        jpeg_simple_progression(&cinfo);
    } else if (script) {
        nscans = parse_script(script, scans, 64);
        if (nscans <= 0) {
            fprintf(stderr, "bad scan script %s\n", script);
            return 2;
        }
        cinfo.scan_info = scans;
        cinfo.num_scans = nscans;
    }
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = px + (size_t)cinfo.next_scanline * w * ch;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    fclose(out);
    free(px);
    return 0;
}
