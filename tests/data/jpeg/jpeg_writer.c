/* Test-fixture JPEG writer: raw pixels in, a JPEG of the chosen coding
 * out, through libjpeg's compression API. Built and linked against the
 * libjpeg-turbo 3 that Pillow bundles (make_fixtures.py does both), so
 * that arithmetic, progressive, lossless and 12-bit frames come from
 * the same library PIL decodes them with.
 *
 *   jpeg_writer OUT IN H W C [key=value ...]
 *     IN      H*W*C bytes (C = 1, 2, 3 or 4), or 2-byte samples if prec=12/16
 *     q=N     quality (default 90)
 *     prog=1  jpeg_simple_progression
 *     scans=S custom scan script: scans split by ';', each
 *             "c0.c1.../Ss/Se/Ah/Al"
 *     arith=1 arithmetic coding
 *     lossless=PSV,PT
 *     restart=N restart interval in MCUs
 *     space=grey|rgb|ycc|cmyk|ycck|unknown  (JPEG colour space)
 *     samp=HV,HV,...  sampling factors per component
 *     prec=N  data precision (12 or 16, or 2..7 with lossless)
 *     opt=1   optimized Huffman tables
 *     dac=L,U,K arithmetic conditioning of tables 0 and 1 (writes DAC)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int psv, int pt);
JDIMENSION jpeg12_write_scanlines(j_compress_ptr, short **, JDIMENSION);
JDIMENSION jpeg16_write_scanlines(j_compress_ptr, unsigned short **, JDIMENSION);

int main(int argc, char **argv) {
  if (argc < 6) return 2;
  int h = atoi(argv[3]), w = atoi(argv[4]), c = atoi(argv[5]);
  int q = 90, prog = 0, arith = 0, psv = 0, pt = 0, restart = 0, prec = 8;
  int opt = 0, dl = -1, du = -1, dk = -1;
  const char *space = NULL, *samp = NULL, *scans = NULL;
  for (int i = 6; i < argc; ++i) {
    char *a = argv[i];
    if (!strncmp(a, "q=", 2)) q = atoi(a + 2);
    else if (!strncmp(a, "prog=", 5)) prog = atoi(a + 5);
    else if (!strncmp(a, "scans=", 6)) scans = a + 6;
    else if (!strncmp(a, "arith=", 6)) arith = atoi(a + 6);
    else if (!strncmp(a, "lossless=", 9)) sscanf(a + 9, "%d,%d", &psv, &pt);
    else if (!strncmp(a, "restart=", 8)) restart = atoi(a + 8);
    else if (!strncmp(a, "space=", 6)) space = a + 6;
    else if (!strncmp(a, "samp=", 5)) samp = a + 5;
    else if (!strncmp(a, "prec=", 5)) prec = atoi(a + 5);
    else if (!strncmp(a, "opt=", 4)) opt = atoi(a + 4);
    else if (!strncmp(a, "dac=", 4)) sscanf(a + 4, "%d,%d,%d", &dl, &du, &dk);
    else return 3;
  }
  int es = prec > 8 ? 2 : 1;
  size_t n = (size_t)h * w * c * es;
  unsigned char *pix = malloc(n);
  FILE *f = fopen(argv[2], "rb");
  if (!f || fread(pix, 1, n, f) != n) return 4;
  fclose(f);
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr jerr;
  ci.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&ci);
  FILE *o = fopen(argv[1], "wb");
  jpeg_stdio_dest(&ci, o);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = c;
  ci.in_color_space = c == 1 ? JCS_GRAYSCALE : c == 3 ? JCS_RGB
                    : c == 4 ? JCS_CMYK : JCS_UNKNOWN;
  ci.data_precision = prec;
  jpeg_set_defaults(&ci);
  ci.data_precision = prec;
  /* before the colour space and sampling: it resets both to the input's */
  if (psv) jpeg_enable_lossless(&ci, psv, pt);
  if (space) {
    J_COLOR_SPACE s = !strcmp(space, "grey") ? JCS_GRAYSCALE
                    : !strcmp(space, "rgb") ? JCS_RGB
                    : !strcmp(space, "ycc") ? JCS_YCbCr
                    : !strcmp(space, "cmyk") ? JCS_CMYK
                    : !strcmp(space, "ycck") ? JCS_YCCK : JCS_UNKNOWN;
    jpeg_set_colorspace(&ci, s);
  }
  if (!psv) jpeg_set_quality(&ci, q, TRUE);
  if (samp) {
    const char *p = samp;
    for (int k = 0; k < ci.num_components && *p; ++k) {
      ci.comp_info[k].h_samp_factor = p[0] - '0';
      ci.comp_info[k].v_samp_factor = p[1] - '0';
      p += 2;
      if (*p == ',') ++p;
    }
  }
  ci.arith_code = arith;
  if (dl >= 0)
    for (int t = 0; t < 2; ++t) {
      ci.arith_dc_L[t] = dl;
      ci.arith_dc_U[t] = du;
      ci.arith_ac_K[t] = dk;
    }
  ci.optimize_coding = opt;
  ci.restart_interval = restart;
  if (prog) jpeg_simple_progression(&ci);
  if (scans) {
    static jpeg_scan_info info[64];
    int ns = 0;
    const char *p = scans;
    while (*p && ns < 64) {
      jpeg_scan_info *s = &info[ns++];
      s->comps_in_scan = 0;
      for (;;) {
        s->component_index[s->comps_in_scan++] = (int)strtol(p, (char **)&p, 10);
        if (*p == '.') { ++p; continue; }
        break;
      }
      s->Ss = (int)strtol(p + 1, (char **)&p, 10);
      s->Se = (int)strtol(p + 1, (char **)&p, 10);
      s->Ah = (int)strtol(p + 1, (char **)&p, 10);
      s->Al = (int)strtol(p + 1, (char **)&p, 10);
      if (*p == ';') ++p;
    }
    ci.scan_info = info;
    ci.num_scans = ns;
  }
  jpeg_start_compress(&ci, TRUE);
  size_t stride = (size_t)w * c;
  while (ci.next_scanline < ci.image_height) {
    unsigned char *row = pix + (size_t)ci.next_scanline * stride * es;
    if (prec > 12) {
      unsigned short *r16 = (unsigned short *)row;
      jpeg16_write_scanlines(&ci, &r16, 1);
    } else if (prec > 8) {
      short *r12 = (short *)row;
      jpeg12_write_scanlines(&ci, &r12, 1);
    } else {
      jpeg_write_scanlines(&ci, &row, 1);
    }
  }
  jpeg_finish_compress(&ci);
  jpeg_destroy_compress(&ci);
  fclose(o);
  free(pix);
  return 0;
}
