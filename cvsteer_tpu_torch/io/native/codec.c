/* PNG codec on zlib alone: 8-bit PNG to float32 gray, and 8-bit gray PNG out.
 *
 * The port's counterpart of cvsteer_tpu/io/native/codec.cpp, which decodes
 * JPEG and PNG through libjpeg and libpng. Only zlib's header is on every
 * machine the port runs on, so this codec parses the chunks, inflates the
 * IDAT stream with zlib and undoes the scanline filters itself; JPEG is not
 * supported (cvs_png_info returns CVS_UNSUPPORTED for it). Called through
 * ctypes (io/native_codec.py), which releases the GIL, so a thread pool
 * decodes in parallel.
 *
 * Decode: 8-bit depth, colour types gray (0), RGB (2), gray + alpha (4) and
 * RGBA (6), not interlaced, filters None, Sub, Up, Average and Paeth. Gray
 * is the first sample; colour goes to gray by ITU-R BT.601 luma in float32,
 * 0.299 R + 0.587 G + 0.114 B summed left to right and rounded half to even
 * (cv2.IMREAD_GRAYSCALE's rule), as the plain numpy decoder
 * (io/imageio.py::_decode_png) computes it; alpha is ignored. Build with
 * -ffp-contract=off so that no multiply and add fuse.
 *
 * Encode: 8-bit gray, filter None on every row, deflate level 1 (the plain
 * writer io/imageio.py::imwrite_u8 does the same).
 *
 * Return codes: 0 success, < 0 an error (the CVS_* values below).
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#define CVS_EXPORT __attribute__((visibility("default")))

enum {
    CVS_OK = 0,
    CVS_BAD_ARGS = -1,
    CVS_NOT_PNG = -2,
    CVS_UNSUPPORTED = -3, /* JPEG, 16-bit, palette, interlaced */
    CVS_CORRUPT = -4,
    CVS_NO_MEMORY = -5,
    CVS_IO = -6,
};

static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

static uint32_t be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

static void put_be32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

typedef struct {
    uint32_t w, h;
    int channels;
} Header;

/* The IHDR of a PNG in memory; CVS_OK when the codec can decode it. */
static int read_header(const uint8_t* data, size_t size, Header* hd) {
    if (data == NULL || size < 8) return CVS_BAD_ARGS;
    if (data[0] == 0xFF && data[1] == 0xD8) return CVS_UNSUPPORTED; /* JPEG */
    if (memcmp(data, kSig, 8) != 0) return CVS_NOT_PNG;
    if (size < 8 + 8 + 13 || be32(data + 8) != 13 || memcmp(data + 12, "IHDR", 4) != 0) {
        return CVS_CORRUPT;
    }
    const uint8_t* b = data + 16;
    hd->w = be32(b);
    hd->h = be32(b + 4);
    const int depth = b[8], ctype = b[9], interlace = b[12];
    switch (ctype) {
        case 0: hd->channels = 1; break;
        case 2: hd->channels = 3; break;
        case 4: hd->channels = 2; break;
        case 6: hd->channels = 4; break;
        default: return CVS_UNSUPPORTED;
    }
    if (depth != 8 || interlace != 0) return CVS_UNSUPPORTED;
    if (hd->w == 0 || hd->h == 0 || hd->w > (1u << 24) || hd->h > (1u << 24) ||
        (uint64_t)hd->w * hd->h > (1ull << 30)) {
        return CVS_CORRUPT;
    }
    return CVS_OK;
}

/* Inflate every IDAT chunk (in order) into raw[0, raw_len): exactly that many
 * bytes and the end of the zlib stream, or CVS_CORRUPT. */
static int inflate_idat(const uint8_t* data, size_t size, uint8_t* raw, size_t raw_len) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return CVS_NO_MEMORY;
    zs.next_out = raw;
    zs.avail_out = (uInt)raw_len;
    int rc = Z_OK;
    size_t pos = 8;
    while (pos + 12 <= size && rc != Z_STREAM_END) {
        const uint32_t len = be32(data + pos);
        const uint8_t* kind = data + pos + 4;
        if ((size_t)len > size - pos - 12) break; /* a chunk past the end */
        if (memcmp(kind, "IDAT", 4) == 0) {
            zs.next_in = (Bytef*)(data + pos + 8);
            zs.avail_in = len;
            while (zs.avail_in > 0) {
                rc = inflate(&zs, Z_NO_FLUSH);
                if (rc == Z_STREAM_END) break;
                if (rc != Z_OK) {
                    inflateEnd(&zs);
                    return CVS_CORRUPT;
                }
                if (zs.avail_out == 0 && zs.avail_in > 0) {
                    /* more pixels than the header holds */
                    rc = inflate(&zs, Z_NO_FLUSH);
                    if (rc != Z_STREAM_END) {
                        inflateEnd(&zs);
                        return CVS_CORRUPT;
                    }
                    break;
                }
            }
        } else if (memcmp(kind, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + (size_t)len;
    }
    const size_t got = raw_len - zs.avail_out;
    inflateEnd(&zs);
    return (rc == Z_STREAM_END && got == raw_len) ? CVS_OK : CVS_CORRUPT;
}

static int paeth(int a, int b, int c) {
    const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

/* Undo one scanline's filter in place: line[stride] over prev (zeros on the
 * first row), bpp bytes a pixel. */
static int unfilter(int type, uint8_t* line, const uint8_t* prev, size_t stride, int bpp) {
    size_t x;
    switch (type) {
        case 0:
            return CVS_OK;
        case 1:
            for (x = (size_t)bpp; x < stride; ++x) line[x] = (uint8_t)(line[x] + line[x - bpp]);
            return CVS_OK;
        case 2:
            for (x = 0; x < stride; ++x) line[x] = (uint8_t)(line[x] + prev[x]);
            return CVS_OK;
        case 3:
            for (x = 0; x < stride; ++x) {
                const int a = x >= (size_t)bpp ? line[x - bpp] : 0;
                line[x] = (uint8_t)(line[x] + ((a + prev[x]) >> 1));
            }
            return CVS_OK;
        case 4:
            for (x = 0; x < stride; ++x) {
                const int a = x >= (size_t)bpp ? line[x - bpp] : 0;
                const int c = x >= (size_t)bpp ? prev[x - bpp] : 0;
                line[x] = (uint8_t)(line[x] + paeth(a, prev[x], c));
            }
            return CVS_OK;
        default:
            return CVS_CORRUPT;
    }
}

/* (width, height) of a PNG the codec can decode; no pixel work. */
CVS_EXPORT int cvs_png_info(const uint8_t* data, size_t size, int* w, int* h) {
    Header hd;
    if (w == NULL || h == NULL) return CVS_BAD_ARGS;
    const int rc = read_header(data, size, &hd);
    if (rc != CVS_OK) return rc;
    *w = (int)hd.w;
    *h = (int)hd.h;
    return CVS_OK;
}

/* Decode a PNG in memory into out[h * w] float32 gray (w, h from
 * cvs_png_info). */
CVS_EXPORT int cvs_png_decode_gray(const uint8_t* data, size_t size, float* out, int w, int h) {
    Header hd;
    int rc = read_header(data, size, &hd);
    if (rc != CVS_OK) return rc;
    if (out == NULL || (int)hd.w != w || (int)hd.h != h) return CVS_BAD_ARGS;
    const int bpp = hd.channels;
    const size_t stride = (size_t)hd.w * bpp, row = stride + 1;
    uint8_t* raw = (uint8_t*)malloc(row * hd.h);
    uint8_t* zero = (uint8_t*)calloc(stride, 1);
    if (raw == NULL || zero == NULL) {
        free(raw);
        free(zero);
        return CVS_NO_MEMORY;
    }
    rc = inflate_idat(data, size, raw, row * hd.h);
    for (uint32_t y = 0; rc == CVS_OK && y < hd.h; ++y) {
        uint8_t* line = raw + y * row + 1;
        rc = unfilter(line[-1], line, y ? line - row : zero, stride, bpp);
        if (rc != CVS_OK) break;
        float* o = out + (size_t)y * hd.w;
        if (bpp >= 3) {
            for (uint32_t x = 0; x < hd.w; ++x) {
                const uint8_t* p = line + (size_t)x * bpp;
                float s = 0.299f * (float)p[0];
                s = s + 0.587f * (float)p[1];
                s = s + 0.114f * (float)p[2];
                o[x] = rintf(s); /* the default rounding mode: half to even */
            }
        } else {
            for (uint32_t x = 0; x < hd.w; ++x) o[x] = (float)line[(size_t)x * bpp];
        }
    }
    free(raw);
    free(zero);
    return rc;
}

/* Write img[h * w] (8-bit gray) to path as PNG. */
CVS_EXPORT int cvs_png_write_gray(const char* path, const uint8_t* img, int w, int h) {
    if (path == NULL || img == NULL || w <= 0 || h <= 0) return CVS_BAD_ARGS;
    const size_t row = (size_t)w + 1, raw_len = row * (size_t)h;
    uint8_t* raw = (uint8_t*)malloc(raw_len);
    uLongf zlen = compressBound((uLong)raw_len);
    /* signature, IHDR (25), IDAT header and CRC (12), IEND (12) */
    uint8_t* png = (uint8_t*)malloc(8 + 25 + 12 + zlen + 12);
    if (raw == NULL || png == NULL) {
        free(raw);
        free(png);
        return CVS_NO_MEMORY;
    }
    for (int y = 0; y < h; ++y) {
        raw[y * row] = 0;
        memcpy(raw + y * row + 1, img + (size_t)y * w, (size_t)w);
    }
    uint8_t* p = png;
    memcpy(p, kSig, 8);
    p += 8;
    put_be32(p, 13);
    memcpy(p + 4, "IHDR", 4);
    put_be32(p + 8, (uint32_t)w);
    put_be32(p + 12, (uint32_t)h);
    p[16] = 8; /* depth */
    p[17] = 0; /* gray */
    p[18] = p[19] = p[20] = 0;
    put_be32(p + 21, (uint32_t)crc32(0, p + 4, 17));
    p += 25;
    const int zrc = compress2(p + 8, &zlen, raw, (uLong)raw_len, 1);
    free(raw);
    if (zrc != Z_OK) {
        free(png);
        return CVS_NO_MEMORY;
    }
    put_be32(p, (uint32_t)zlen);
    memcpy(p + 4, "IDAT", 4);
    put_be32(p + 8 + zlen, (uint32_t)crc32(0, p + 4, (uInt)(zlen + 4)));
    p += 12 + zlen;
    put_be32(p, 0);
    memcpy(p + 4, "IEND", 4);
    put_be32(p + 8, (uint32_t)crc32(0, p + 4, 4));
    p += 12;
    FILE* f = fopen(path, "wb");
    int rc = CVS_IO;
    if (f != NULL) {
        const size_t n = (size_t)(p - png);
        rc = fwrite(png, 1, n, f) == n ? CVS_OK : CVS_IO;
        if (fclose(f) != 0) rc = CVS_IO;
    }
    free(png);
    return rc;
}
