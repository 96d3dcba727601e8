/* Writes the JPEG variants that neither cv2 nor PIL writes, with libjpeg:
 * arithmetic coding (sequential and progressive, with DAC conditioning),
 * YCCK and CMYK with or without an Adobe marker, custom progressive scan
 * scripts, restart intervals and chroma subsampling.
 *
 *   gcc -O2 -o jpeg_writer jpeg_writer.c -ljpeg
 *   jpeg_writer IN.raw OUT.jpg WIDTH HEIGHT NCOMP [options]
 *
 * IN.raw holds HEIGHT x WIDTH x NCOMP interleaved bytes: gray, RGB or CMYK.
 * Options: -q QUALITY, -a (arithmetic), -p (jpeg_simple_progression),
 * -f H,V,H,V,... (sampling factors per component), -r N (restart interval
 * in MCUs), -c ycck|cmyk|rgb (JPEG colour space), -n (no JFIF or Adobe
 * marker), -d L,U,K (arithmetic conditioning of every table) and
 * -s "C.C.C:Ss:Se:Ah:Al;..." (a scan script, components by index). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static jpeg_scan_info scans[64];

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s IN.raw OUT.jpg WIDTH HEIGHT NCOMP [options]\n", argv[0]);
    return 2;
  }
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  size_t size = (size_t)w * h * nc;
  unsigned char *pix = malloc(size);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(pix, 1, size, in) != size) return 3;
  fclose(in);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return 3;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = nc;
  cinfo.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  int quality = 90, progressive = 0, no_markers = 0, nscans = 0;
  for (int i = 6; i < argc; ++i) {
    const char *opt = argv[i], *val = i + 1 < argc ? argv[i + 1] : "";
    if (!strcmp(opt, "-a")) {
      cinfo.arith_code = TRUE;
    } else if (!strcmp(opt, "-p")) {
      progressive = 1;
    } else if (!strcmp(opt, "-n")) {
      no_markers = 1;
    } else if (!strcmp(opt, "-q")) {
      quality = atoi(val), ++i;
    } else if (!strcmp(opt, "-r")) {
      cinfo.restart_interval = atoi(val), ++i;
    } else if (!strcmp(opt, "-c")) {
      jpeg_set_colorspace(&cinfo, !strcmp(val, "ycck") ? JCS_YCCK
                                  : !strcmp(val, "cmyk") ? JCS_CMYK : JCS_RGB);
      ++i;
    } else if (!strcmp(opt, "-f")) {
      const char *p = val;
      for (int c = 0; c < cinfo.num_components && *p; ++c) {
        cinfo.comp_info[c].h_samp_factor = (int)strtol(p, (char **)&p, 10);
        cinfo.comp_info[c].v_samp_factor = (int)strtol(p + 1, (char **)&p, 10);
        if (*p == ',') ++p;
      }
      ++i;
    } else if (!strcmp(opt, "-d")) {
      int l, u, k;
      if (sscanf(val, "%d,%d,%d", &l, &u, &k) != 3) return 2;
      for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
        cinfo.arith_dc_L[t] = (UINT8)l, cinfo.arith_dc_U[t] = (UINT8)u;
        cinfo.arith_ac_K[t] = (UINT8)k;
      }
      ++i;
    } else if (!strcmp(opt, "-s")) {
      for (const char *p = val; *p && nscans < 64; ++nscans) {
        jpeg_scan_info *s = &scans[nscans];
        s->comps_in_scan = 0;
        do {
          s->component_index[s->comps_in_scan++] = (int)strtol(p, (char **)&p, 10);
        } while (*p++ == '.');
        s->Ss = (int)strtol(p, (char **)&p, 10);
        s->Se = (int)strtol(p + 1, (char **)&p, 10);
        s->Ah = (int)strtol(p + 1, (char **)&p, 10);
        s->Al = (int)strtol(p + 1, (char **)&p, 10);
        if (*p == ';') ++p;
      }
      ++i;
    } else {
      fprintf(stderr, "unknown option %s\n", opt);
      return 2;
    }
  }
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (progressive) jpeg_simple_progression(&cinfo);
  if (nscans) {
    cinfo.scan_info = scans;
    cinfo.num_scans = nscans;
  }
  if (no_markers) cinfo.write_JFIF_header = cinfo.write_Adobe_marker = FALSE;
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pix + (size_t)cinfo.next_scanline * w * nc;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pix);
  return 0;
}
