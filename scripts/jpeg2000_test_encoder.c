/* Test encoder of the JPEG 2000 variants that PIL's save does not reach: a
 * thin layer over OpenJPEG's compressor, built by scripts/format_variants.py
 * against the libopenjp2 that Pillow bundles and called through ctypes.
 *
 * No OpenJPEG header is needed: the few types used are declared here. The
 * compression parameters (opj_cparameters_t, 18720 bytes in OpenJPEG 2.5)
 * are filled by opj_set_default_encoder_parameters and then patched at the
 * offsets the caller gives (format_variants.py's CPARAM_INTS / CPARAM_BYTES,
 * which it checks against the library's defaults first): the code-block
 * style bits, SOP / EPH, the ROI shift, precincts, progression order
 * changes, tile-parts and the rest that PIL's save hides. The image carries
 * each component's subsampling, precision and sign, and the image offset.
 *
 * jenc_encode writes one image; the bytes come back in a malloc'd buffer
 * freed with jenc_free. Errors: negative codes, with OpenJPEG's last error
 * message in jenc_error().
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef int OPJ_BOOL;
typedef int64_t OPJ_OFF_T;

typedef struct {
  uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd;
} opj_image_cmptparm_t;

typedef struct {
  uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
  int32_t *data;
  uint16_t alpha;
} opj_image_comp_t;

typedef struct {
  uint32_t x0, y0, x1, y1, numcomps;
  int color_space;
  opj_image_comp_t *comps;
  unsigned char *icc_profile_buf;
  uint32_t icc_profile_len;
} opj_image_t;

typedef void (*opj_msg_callback)(const char *msg, void *client_data);
typedef size_t (*opj_stream_write_fn)(void *buffer, size_t nb, void *user);
typedef OPJ_OFF_T (*opj_stream_skip_fn)(OPJ_OFF_T nb, void *user);
typedef OPJ_BOOL (*opj_stream_seek_fn)(OPJ_OFF_T nb, void *user);
typedef void (*opj_stream_free_user_data_fn)(void *user);

void *opj_create_compress(int format);
void opj_destroy_codec(void *codec);
void opj_set_default_encoder_parameters(void *parameters);
OPJ_BOOL opj_setup_encoder(void *codec, void *parameters, opj_image_t *image);
OPJ_BOOL opj_encoder_set_extra_options(void *codec, const char *const *options);
OPJ_BOOL opj_set_error_handler(void *codec, opj_msg_callback fn, void *data);
opj_image_t *opj_image_create(uint32_t numcmpts, opj_image_cmptparm_t *cmptparms, int clrspc);
void opj_image_destroy(opj_image_t *image);
void *opj_stream_create(size_t buffer_size, OPJ_BOOL is_input);
void opj_stream_destroy(void *stream);
void opj_stream_set_write_function(void *stream, opj_stream_write_fn fn);
void opj_stream_set_skip_function(void *stream, opj_stream_skip_fn fn);
void opj_stream_set_seek_function(void *stream, opj_stream_seek_fn fn);
void opj_stream_set_user_data(void *stream, void *data, opj_stream_free_user_data_fn fn);
OPJ_BOOL opj_start_compress(void *codec, opj_image_t *image, void *stream);
OPJ_BOOL opj_encode(void *codec, void *stream);
OPJ_BOOL opj_end_compress(void *codec, void *stream);

#define CPARAM_SIZE 18720

typedef struct {
  unsigned char *data;
  size_t size, cap, pos;
} membuf;

static char last_error[512];

static void on_error(const char *msg, void *data) {
  (void)data;
  snprintf(last_error, sizeof(last_error), "%s", msg);
}

static int reserve(membuf *m, size_t n) {
  if (n <= m->cap) return 1;
  size_t cap = m->cap ? m->cap : 65536;
  while (cap < n) cap *= 2;
  unsigned char *p = (unsigned char *)realloc(m->data, cap);
  if (!p) return 0;
  memset(p + m->cap, 0, cap - m->cap);
  m->data = p;
  m->cap = cap;
  return 1;
}

static size_t mem_write(void *buffer, size_t nb, void *user) {
  membuf *m = (membuf *)user;
  if (!reserve(m, m->pos + nb)) return (size_t)-1;
  memcpy(m->data + m->pos, buffer, nb);
  m->pos += nb;
  if (m->pos > m->size) m->size = m->pos;
  return nb;
}

static OPJ_OFF_T mem_skip(OPJ_OFF_T nb, void *user) {
  membuf *m = (membuf *)user;
  if (!reserve(m, m->pos + (size_t)nb)) return -1;
  m->pos += (size_t)nb;
  if (m->pos > m->size) m->size = m->pos;
  return nb;
}

static OPJ_BOOL mem_seek(OPJ_OFF_T pos, void *user) {
  membuf *m = (membuf *)user;
  if (!reserve(m, (size_t)pos)) return 0;
  m->pos = (size_t)pos;
  if (m->pos > m->size) m->size = m->pos;
  return 1;
}

const char *jenc_error(void) { return last_error; }

/* comps: per component dx, dy, prec, sgnd; samples: every component's
 * samples, int32, of its size (ceil(x1 / dx) - ceil(x0 / dx) wide), one
 * after the other. int_sets / byte_sets: (offset, value) pairs applied to
 * opj_cparameters_t as ints / bytes. extra: NULL-terminated options of
 * opj_encoder_set_extra_options, or NULL. */
int jenc_encode(const int32_t *samples, uint32_t x0, uint32_t y0, uint32_t x1, uint32_t y1,
                int nc, const int *comps, int color_space, int jp2, const int *int_sets,
                int n_int, const int *byte_sets, int n_byte, const char *const *extra,
                unsigned char **out, size_t *outsize) {
  unsigned char params[CPARAM_SIZE + 64];
  opj_image_cmptparm_t parms[16];
  void *codec = NULL, *stream = NULL;
  opj_image_t *image = NULL;
  membuf m = {NULL, 0, 0, 0};
  int i, rc = 0;
  size_t at = 0;
  *out = NULL;
  *outsize = 0;
  last_error[0] = 0;
  if (nc < 1 || nc > 16) return -1;
  memset(params, 0, sizeof(params));
  opj_set_default_encoder_parameters(params);
  for (i = 0; i < n_int; ++i) {
    if (int_sets[2 * i] < 0 || (size_t)int_sets[2 * i] * 4 + 4 > CPARAM_SIZE) return -2;
    memcpy(params + 4 * (size_t)int_sets[2 * i], &int_sets[2 * i + 1], 4);
  }
  for (i = 0; i < n_byte; ++i) {
    if (byte_sets[2 * i] < 0 || byte_sets[2 * i] >= CPARAM_SIZE) return -2;
    params[byte_sets[2 * i]] = (unsigned char)byte_sets[2 * i + 1];
  }
  memset(parms, 0, sizeof(parms));
  for (i = 0; i < nc; ++i) {
    uint32_t dx = (uint32_t)comps[4 * i], dy = (uint32_t)comps[4 * i + 1];
    parms[i].dx = dx;
    parms[i].dy = dy;
    parms[i].x0 = (x0 + dx - 1) / dx;
    parms[i].y0 = (y0 + dy - 1) / dy;
    parms[i].w = (x1 + dx - 1) / dx - parms[i].x0;
    parms[i].h = (y1 + dy - 1) / dy - parms[i].y0;
    parms[i].prec = (uint32_t)comps[4 * i + 2];
    parms[i].bpp = parms[i].prec;
    parms[i].sgnd = (uint32_t)comps[4 * i + 3];
  }
  image = opj_image_create((uint32_t)nc, parms, color_space);
  if (!image) return -3;
  image->x0 = x0;
  image->y0 = y0;
  image->x1 = x1;
  image->y1 = y1;
  for (i = 0; i < nc; ++i) {
    size_t n = (size_t)parms[i].w * parms[i].h;
    memcpy(image->comps[i].data, samples + at, n * sizeof(int32_t));
    at += n;
  }
  codec = opj_create_compress(jp2 ? 2 : 0);
  if (!codec) {
    rc = -4;
    goto done;
  }
  opj_set_error_handler(codec, on_error, NULL);
  if (!opj_setup_encoder(codec, params, image)) {
    rc = -5;
    goto done;
  }
  if (extra && extra[0] && !opj_encoder_set_extra_options(codec, extra)) {
    rc = -6;
    goto done;
  }
  stream = opj_stream_create(65536, 0);
  if (!stream) {
    rc = -7;
    goto done;
  }
  opj_stream_set_write_function(stream, mem_write);
  opj_stream_set_skip_function(stream, mem_skip);
  opj_stream_set_seek_function(stream, mem_seek);
  opj_stream_set_user_data(stream, &m, NULL);
  if (!opj_start_compress(codec, image, stream) || !opj_encode(codec, stream) ||
      !opj_end_compress(codec, stream)) {
    rc = -8;
    goto done;
  }
  *out = m.data;
  *outsize = m.size;
  m.data = NULL;
done:
  if (stream) opj_stream_destroy(stream);
  if (codec) opj_destroy_codec(codec);
  opj_image_destroy(image);
  free(m.data);
  return rc;
}

void jenc_free(unsigned char *p) { free(p); }
