/* Test encoder of the JPEG variants that PIL does not write: a thin layer
 * over the libjpeg API, built by scripts/format_variants.py against the
 * libjpeg-turbo that Pillow bundles and called through ctypes.
 *
 * tenc_encode writes 8-bit samples with the given colour spaces, sampling
 * factors, entropy coder (Huffman or arithmetic, with DAC conditioning
 * values), scan script, restart interval, APP markers or lossless
 * predictor; tenc_transcode re-codes the coefficients of a JPEG (lossless
 * in the DCT domain) with another entropy coder or progression; tenc_decode
 * decodes a whole file held in memory (PIL feeds libjpeg 64 KiB at a time,
 * which its arithmetic decoder cannot resume from). Errors come back as
 * libjpeg's message; output buffers are freed with tenc_free.
 */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

/* libjpeg-turbo 3 API, absent from older headers */
void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

struct err_mgr {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
  char *msg;
};

static void on_error(j_common_ptr c) {
  struct err_mgr *e = (struct err_mgr *)c->err;
  (*c->err->format_message)(c, e->msg);
  longjmp(e->jb, 1);
}

static void quiet(j_common_ptr c, int level) { (void)c; (void)level; }

/* scans: nscans x (comps_in_scan, component indices x 4, Ss, Se, Ah, Al);
 * samp: (h, v) per component or NULL; dac: dc_L[4], dc_U[4], ac_K[4]
 * (-1 leaves a value) or NULL; adobe / jfif: -1 leaves libjpeg's choice;
 * psv > 0: lossless with that predictor and point transform pt. */
int tenc_encode(const unsigned char *px, int w, int h, int nc, int in_cs,
                int jpeg_cs, const int *samp, int quality, int arith,
                int progressive, const int *scans, int nscans,
                int restart_interval, int restart_rows, int adobe, int jfif,
                const int *dac, int psv, int pt, int optimize,
                unsigned char **out, unsigned long *outsize, char *err) {
  struct jpeg_compress_struct c;
  struct err_mgr e;
  jpeg_scan_info script[64];
  c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.emit_message = quiet;
  e.msg = err;
  *out = NULL;
  *outsize = 0;
  if (setjmp(e.jb)) {
    jpeg_destroy_compress(&c);
    free(*out);
    *out = NULL;
    return 1;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, out, outsize);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = (J_COLOR_SPACE)in_cs;
  jpeg_set_defaults(&c);
  if (jpeg_cs >= 0) jpeg_set_colorspace(&c, (J_COLOR_SPACE)jpeg_cs);
  jpeg_set_quality(&c, quality, TRUE);
  if (samp)
    for (int i = 0; i < c.num_components; ++i) {
      c.comp_info[i].h_samp_factor = samp[2 * i];
      c.comp_info[i].v_samp_factor = samp[2 * i + 1];
    }
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = optimize ? TRUE : FALSE;
  if (dac)
    for (int t = 0; t < 4; ++t) {
      if (dac[t] >= 0) c.arith_dc_L[t] = (UINT8)dac[t];
      if (dac[4 + t] >= 0) c.arith_dc_U[t] = (UINT8)dac[4 + t];
      if (dac[8 + t] >= 0) c.arith_ac_K[t] = (UINT8)dac[8 + t];
    }
  if (progressive) jpeg_simple_progression(&c);
  if (nscans > 0) {
    for (int s = 0; s < nscans && s < 64; ++s) {
      const int *p = scans + 9 * s;
      script[s].comps_in_scan = p[0];
      for (int k = 0; k < 4; ++k) script[s].component_index[k] = p[1 + k];
      script[s].Ss = p[5];
      script[s].Se = p[6];
      script[s].Ah = p[7];
      script[s].Al = p[8];
    }
    c.scan_info = script;
    c.num_scans = nscans;
  }
  c.restart_interval = restart_interval;
  c.restart_in_rows = restart_rows;
  if (adobe >= 0) c.write_Adobe_marker = adobe ? TRUE : FALSE;
  if (jfif >= 0) c.write_JFIF_header = jfif ? TRUE : FALSE;
  if (psv > 0) jpeg_enable_lossless(&c, psv, pt);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(px + (size_t)c.next_scanline * w * nc);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return 0;
}

/* the coefficients of src, re-coded: arithmetic or Huffman, progressive
 * (libjpeg's simple progression) or sequential, with a restart interval */
int tenc_transcode(const unsigned char *src, unsigned long n, int arith,
                   int progressive, int restart_interval, unsigned char **out,
                   unsigned long *outsize, char *err) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct err_mgr e;
  d.err = c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.emit_message = quiet;
  e.msg = err;
  *out = NULL;
  *outsize = 0;
  volatile int made = 0;
  if (setjmp(e.jb)) {
    if (made) jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    free(*out);
    *out = NULL;
    return 1;
  }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, src, n);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&d);
  jpeg_create_compress(&c);
  made = 1;
  jpeg_mem_dest(&c, out, outsize);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = FALSE;
  if (progressive) jpeg_simple_progression(&c);
  c.restart_interval = restart_interval;
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  return 0;
}

/* the file decoded by libjpeg from memory in one piece, in libjpeg's
 * default output colour space (grey, RGB or CMYK as stored): dims gets
 * width, height and components; out is freed with tenc_free */
int tenc_decode(const unsigned char *src, unsigned long n, unsigned char **out,
                int *dims, char *err) {
  struct jpeg_decompress_struct d;
  struct err_mgr e;
  d.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.emit_message = quiet;
  e.msg = err;
  *out = NULL;
  if (setjmp(e.jb)) {
    jpeg_destroy_decompress(&d);
    free(*out);
    *out = NULL;
    return 1;
  }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, src, n);
  jpeg_read_header(&d, TRUE);
  jpeg_start_decompress(&d);
  size_t stride = (size_t)d.output_width * d.output_components;
  *out = (unsigned char *)malloc(stride * d.output_height);
  while (d.output_scanline < d.output_height) {
    JSAMPROW row = *out + stride * d.output_scanline;
    jpeg_read_scanlines(&d, &row, 1);
  }
  dims[0] = d.output_width;
  dims[1] = d.output_height;
  dims[2] = d.output_components;
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  return 0;
}

void tenc_free(void *p) { free(p); }
