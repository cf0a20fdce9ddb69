/* Test encoder of the WebP variants that PIL's save does not reach: a thin
 * layer over libwebp's WebPEncode, built by scripts/format_variants.py
 * against the libwebp that Pillow bundles and called through ctypes.
 *
 * wenc_encode writes one RGBA picture with the WebPConfig fields that PIL's
 * save hides: the loop filter's type, strength and sharpness, the token
 * partitions, segments, spatial noise shaping, the alpha plane's compression
 * and filtering, exact, near-lossless and the image hint. A picture whose
 * alpha is all 255 is written without alpha. The bytes come back in a
 * malloc'd buffer freed with wenc_free; errors as libwebp's error code.
 */
#include <stdlib.h>
#include <string.h>

#include <webp/encode.h>

/* opts: quality (x100), method, filter_type, filter_strength,
 * filter_sharpness, partitions, segments, sns_strength, alpha_compression,
 * alpha_filtering, alpha_quality, exact, near_lossless, image_hint;
 * a value of -1 keeps libwebp's default. */
int wenc_encode(const unsigned char *rgba, int w, int h, int lossless, const int *opts,
                unsigned char **out, size_t *outsize) {
  WebPConfig config;
  WebPPicture pic;
  WebPMemoryWriter writer;
  int ok, i, opaque = 1;
  *out = NULL;
  *outsize = 0;
  if (!WebPConfigInit(&config) || !WebPPictureInit(&pic)) return -1;
  config.lossless = lossless;
#define SET(field, k) if (opts[k] >= 0) config.field = opts[k]
  if (opts[0] >= 0) config.quality = opts[0] / 100.0f;
  SET(method, 1);
  SET(filter_type, 2);
  SET(filter_strength, 3);
  SET(filter_sharpness, 4);
  SET(partitions, 5);
  SET(segments, 6);
  SET(sns_strength, 7);
  SET(alpha_compression, 8);
  SET(alpha_filtering, 9);
  SET(alpha_quality, 10);
  SET(exact, 11);
  SET(near_lossless, 12);
  if (opts[13] >= 0) config.image_hint = (WebPImageHint)opts[13];
#undef SET
  if (!WebPValidateConfig(&config)) return -2;
  pic.use_argb = lossless;
  pic.width = w;
  pic.height = h;
  for (i = 0; i < w * h; ++i) opaque &= rgba[4 * i + 3] == 255;
  ok = opaque ? WebPPictureImportRGBX(&pic, rgba, 4 * w)
              : WebPPictureImportRGBA(&pic, rgba, 4 * w);
  if (!ok) {
    WebPPictureFree(&pic);
    return -3;
  }
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  ok = WebPEncode(&config, &pic);
  i = pic.error_code;
  WebPPictureFree(&pic);
  if (!ok) {
    WebPMemoryWriterClear(&writer);
    return 100 + i;
  }
  *out = (unsigned char *)malloc(writer.size);
  if (*out == NULL) {
    WebPMemoryWriterClear(&writer);
    return -4;
  }
  memcpy(*out, writer.mem, writer.size);
  *outsize = writer.size;
  WebPMemoryWriterClear(&writer);
  return 0;
}

void wenc_free(unsigned char *p) { free(p); }
