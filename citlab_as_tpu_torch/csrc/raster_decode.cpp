// Host decoder loops of the port's lossless raster formats: the run-length
// and bit stream stages that PIL 12.1 runs in C (or in Python) for PCX,
// PSD, TGA, SGI, SUN, MSP, QOI and IM, each followed as PIL follows it so
// that the samples, and the files refused, are PIL's:
//
//   PcxDecode.c       PCX runs (a byte >= 0xC0 repeats the next one), lines
//                     of all planes at once, the plane move of padded lines
//   PackBitsDecode.c  PackBits of PSD channels (runs cut at a line's end)
//   TgaRleDecode.c    TGA packets: literals may cross lines, runs may not
//   SgiRleDecode.c    SGI offset and length tables, 8- and 16-bit runs
//   SunRleDecode.c    SUN runs behind the 0x80 escape, across lines
//   MspImagePlugin    MSP version 2 rows of its row map, one byte stream
//   QoiImagePlugin    the QOI op stream (INDEX, DIFF, LUMA, RUN, RGB, RGBA)
//   BitDecode.c       IM's "F;<bits>" samples, least significant bit first
//   FliDecode.c       the first frame of an FLI / FLC animation (BRUN, LC,
//                     SS2, BLACK, COPY, PSTAMP chunks), fed as ImageFile.load
//                     feeds it: the frame's size in bytes at a time
//
// Every read is bounds-checked. A stream that ends before the image is full
// returns kTruncated (PIL: "image file is truncated"), a run PIL rejects
// kOverrun; nothing is returned as a partial image. The code keeps no state
// between calls and writes only into the caller's buffers.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kTruncated = -1;
constexpr int64_t kOverrun = -2;
constexpr int64_t kCorrupt = -3;

}  // namespace

extern "C" {

// PCX: rows of line_bytes (planes x stride) bytes into out, each after
// PcxDecode.c's move of the planes of a padded line: for the 2- and 4-plane
// bit planes (bits 2 and 4) each plane's (xsize + 7) / 8 bytes, otherwise
// planes of xsize bytes (the image width in pixels, as PIL takes it).
int64_t citlab_pcx_decode(const uint8_t* data, int64_t n, int64_t pos, int32_t xsize,
                          int32_t ysize, int32_t line_bytes, int32_t bits, uint8_t* out) {
    if (xsize <= 0 || ysize <= 0 || line_bytes <= 0) return kCorrupt;
    std::vector<uint8_t> buf(line_bytes);
    int64_t x = 0, y = 0;
    bool overrun = false;
    while (true) {
        if (pos >= n) return kTruncated;
        if ((data[pos] & 0xC0) == 0xC0) {
            if (pos + 1 >= n) return kTruncated;
            int count = data[pos] & 0x3F;
            for (; count > 0; count--) {
                if (x >= line_bytes) {
                    overrun = true;
                    break;
                }
                buf[x++] = data[pos + 1];
            }
            pos += 2;
        } else {
            buf[x++] = data[pos++];
        }
        if (x >= line_bytes) {
            int bands = 0, plane = 0, stride = 0;
            if (bits == 2 || bits == 4) {
                bands = bits;
                plane = (xsize + 7) / 8;
                stride = line_bytes / bits;
            } else if (line_bytes / xsize) {
                bands = line_bytes / xsize;
                plane = xsize;
                stride = line_bytes / bands;
            }
            if (stride > plane)
                for (int i = 1; i < bands; i++)
                    std::memmove(&buf[(size_t)i * plane], &buf[(size_t)i * stride], plane);
            std::memcpy(out + y * line_bytes, buf.data(), line_bytes);
            x = 0;
            if (++y >= ysize) return overrun ? kOverrun : 0;
        }
    }
}

// PackBits (PSD): rows of line_bytes bytes from data[pos:]; a run or a
// literal that passes the end of a line is cut there. Returns the position
// after the last byte used.
int64_t citlab_packbits_decode(const uint8_t* data, int64_t n, int64_t pos, int32_t line_bytes,
                               int32_t ysize, uint8_t* out) {
    if (line_bytes <= 0 || ysize <= 0) return kCorrupt;
    int64_t x = 0, y = 0;
    uint8_t* row = out;
    while (true) {
        if (pos >= n) return kTruncated;
        const uint8_t c = data[pos];
        if (c & 0x80) {
            if (c == 0x80) {
                pos++;
                continue;
            }
            if (pos + 1 >= n) return kTruncated;
            for (int k = 257 - c; k > 0 && x < line_bytes; k--) row[x++] = data[pos + 1];
            pos += 2;
        } else {
            const int64_t len = (int64_t)c + 2;
            if (pos + len > n) return kTruncated;
            for (int64_t i = 1; i < len && x < line_bytes; i++) row[x++] = data[pos + i];
            pos += len;
        }
        if (x >= line_bytes) {
            x = 0;
            row += line_bytes;
            if (++y >= ysize) return pos;
        }
    }
}

// TGA RLE: rows (in the order decoded) of line_bytes bytes, pixels of depth
// bytes (0 for 1-bit samples, which never advance, as in PIL).
int64_t citlab_tga_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int32_t line_bytes,
                              int32_t ysize, int32_t depth, uint8_t* out) {
    if (line_bytes <= 0 || ysize <= 0) return kCorrupt;
    std::vector<uint8_t> buf(line_bytes);
    int64_t x = 0, y = 0;
    while (true) {
        if (pos >= n) return kTruncated;
        int64_t count = (int64_t)depth * ((data[pos] & 0x7F) + 1);
        const uint8_t* lit = nullptr;
        int64_t extra = 0;
        if (data[pos] & 0x80) {
            if (pos + 1 + depth > n) return kTruncated;
            if (x + count > line_bytes) return kOverrun;
            for (int64_t i = 0; i < count; i += depth)
                std::memcpy(&buf[x + i], data + pos + 1, depth);
            pos += 1 + depth;
        } else {
            if (pos + 1 + count > n) return kTruncated;
            lit = data + pos + 1;
            if (x + count > line_bytes) {
                extra = count - (line_bytes - x);
                count = line_bytes - x;
            }
            std::memcpy(&buf[x], lit, count);
            lit += count;
            pos += 1 + count + extra;
        }
        while (true) {
            x += count;
            if (x >= line_bytes) {
                std::memcpy(out + y * line_bytes, buf.data(), line_bytes);
                x = 0;
                if (++y >= ysize) return 0;
            }
            if (extra == 0) break;
            count = extra < line_bytes ? extra : line_bytes;
            std::memcpy(&buf[0], lit, count);
            lit += count;
            extra -= count;
        }
    }
}

// SUN RLE: rows of line_bytes bytes; 0x80 0 is a literal 0x80, 0x80 k v a
// run of k + 1 bytes v, which goes on into the next lines.
int64_t citlab_sun_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int32_t line_bytes,
                              int32_t ysize, uint8_t* out) {
    if (line_bytes <= 0 || ysize <= 0) return kCorrupt;
    std::vector<uint8_t> buf(line_bytes);
    int64_t x = 0, y = 0;
    while (true) {
        if (pos >= n) return kTruncated;
        int64_t count, extra = 0;
        uint8_t value = 0;
        if (data[pos] == 0x80) {
            if (pos + 1 >= n) return kTruncated;
            if (data[pos + 1] == 0) {
                count = 1;
                buf[x] = 0x80;
                pos += 2;
            } else {
                if (pos + 2 >= n) return kTruncated;
                count = (int64_t)data[pos + 1] + 1;
                value = data[pos + 2];
                if (x + count > line_bytes) {
                    extra = count - (line_bytes - x);
                    count = line_bytes - x;
                }
                std::memset(&buf[x], value, count);
                pos += 3;
            }
        } else {
            count = 1;
            buf[x] = data[pos++];
        }
        while (true) {
            x += count;
            if (x >= line_bytes) {
                std::memcpy(out + y * line_bytes, buf.data(), line_bytes);
                x = 0;
                if (++y >= ysize) return 0;
            }
            if (extra == 0) break;
            count = extra < line_bytes ? extra : line_bytes;
            std::memset(&buf[0], value, count);
            extra -= count;
        }
    }
}

// SGI RLE: buf is the file after its 512-byte header. Rows (in the order
// decoded) of xsize x bands samples of bpc bytes, interleaved. Returns 0,
// also where PIL stops early at a row whose last counted byte is not a
// terminator (the rows after it stay zero, as in PIL's image).
int64_t citlab_sgi_rle_decode(const uint8_t* buf, int64_t bufsize, int32_t xsize,
                              int32_t ysize, int32_t bands, int32_t bpc, uint8_t* out) {
    if (xsize <= 0 || ysize <= 0 || bands <= 0 || (bpc != 1 && bpc != 2)) return kCorrupt;
    const int64_t tablen = (int64_t)bands * ysize;
    if (bufsize < 8 * tablen) return kOverrun;
    const size_t line = (size_t)xsize * bands * bpc;
    std::vector<uint8_t> row(line, 0);
    auto be32 = [&](int64_t at) {
        return (uint32_t)buf[at] << 24 | (uint32_t)buf[at + 1] << 16 |
               (uint32_t)buf[at + 2] << 8 | (uint32_t)buf[at + 3];
    };
    const int64_t last = bufsize - 1;        // PIL's bound: the last byte
    for (int64_t r = 0; r < ysize; r++) {
        for (int32_t c = 0; c < bands; c++) {
            int64_t src = be32(4 * (r + (int64_t)c * ysize));
            // the lengths are C ints: one past 2^31 is negative, no atom is read
            const int32_t length = (int32_t)be32(4 * (tablen + r + (int64_t)c * ysize));
            if (src < 512) return kOverrun;
            src -= 512;
            uint8_t* dst = &row[(size_t)c * bpc];
            int64_t x = 0;
            int status = 0;
            for (int64_t k = length; k > 0; k--) {
                if (src + bpc - 1 > last) { status = -1; break; }
                const uint8_t pixel = buf[src + bpc - 1];
                src += bpc;
                if (k == 1 && pixel != 0) { status = 1; break; }
                int count = pixel & 0x7F;
                if (!count) break;
                if (x + count > xsize) { status = -1; break; }
                x += count;
                if (pixel & 0x80) {
                    if (src + (int64_t)bpc * count > last) { status = -1; break; }
                    while (count--) {
                        std::memcpy(dst, buf + src, bpc);
                        src += bpc;
                        dst += (size_t)bands * bpc;
                    }
                } else {
                    if (src + bpc > last) { status = -1; break; }
                    while (count--) {
                        std::memcpy(dst, buf + src, bpc);
                        dst += (size_t)bands * bpc;
                    }
                    src += bpc;
                }
            }
            if (status == -1) return kOverrun;
            if (status == 1) return 0;
        }
        std::memcpy(out + r * line, row.data(), line);
    }
    return 0;
}

// MSP version 2: the rows of the row map (after the 32-byte header), their
// runs and literals written one after another as PIL writes them into one
// stream (a row may give more or fewer bytes than a line); the first
// `capacity` bytes go to out. Returns the stream's length.
int64_t citlab_msp_decode(const uint8_t* data, int64_t n, int32_t xsize, int32_t ysize,
                          uint8_t* out, int64_t capacity) {
    if (xsize < 0 || ysize < 0) return kCorrupt;
    if (32 + 2 * (int64_t)ysize > n) return kTruncated;
    int64_t pos = 32 + 2 * (int64_t)ysize, len = 0;
    auto put = [&](uint8_t v) {
        if (len < capacity) out[len] = v;
        len++;
    };
    const int64_t blank = ((int64_t)xsize + 7) / 8;
    for (int32_t r = 0; r < ysize; r++) {
        const int64_t rowlen = data[32 + 2 * r] | (int64_t)data[33 + 2 * r] << 8;
        if (rowlen == 0) {
            for (int64_t i = 0; i < blank; i++) put(0xFF);
            continue;
        }
        if (pos + rowlen > n) return kTruncated;
        const uint8_t* row = data + pos;
        pos += rowlen;
        int64_t idx = 0;
        while (idx < rowlen) {
            const int runtype = row[idx++];
            if (runtype == 0) {
                if (idx + 2 > rowlen) return kCorrupt;
                const int count = row[idx];
                const uint8_t value = row[idx + 1];
                for (int i = 0; i < count; i++) put(value);
                idx += 2;
            } else {
                const int64_t stop = idx + runtype < rowlen ? idx + runtype : rowlen;
                for (int64_t i = idx; i < stop; i++) put(row[i]);
                idx += runtype;
            }
        }
    }
    return len;
}

// QOI: width x height pixels of channels (3 or 4) bytes from data[pos:].
int64_t citlab_qoi_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t pixels,
                          int32_t channels, uint8_t* out) {
    if (channels != 3 && channels != 4) return kCorrupt;
    uint8_t seen[64][4];
    std::memset(seen, 0, sizeof(seen));
    bool have[64] = {false};
    uint8_t prev[4] = {0, 0, 0, 255};
    const int64_t dest = pixels * channels;
    int64_t len = 0;
    auto emit = [&](const uint8_t* v) {
        for (int i = 0; i < channels && len < dest; i++) out[len++] = v[i];
    };
    while (len < dest) {
        if (pos >= n) return kTruncated;
        const uint8_t byte = data[pos++];
        uint8_t v[4];
        if (byte == 0xFE) {
            if (pos + 3 > n) return kTruncated;
            v[0] = data[pos];
            v[1] = data[pos + 1];
            v[2] = data[pos + 2];
            v[3] = prev[3];
            pos += 3;
        } else if (byte == 0xFF) {
            if (pos + 4 > n) return kTruncated;
            std::memcpy(v, data + pos, 4);
            pos += 4;
        } else {
            const int op = byte >> 6;
            if (op == 0) {
                const int index = byte & 0x3F;
                if (have[index]) std::memcpy(v, seen[index], 4);
                else std::memset(v, 0, 4);
            } else if (op == 1) {
                v[0] = (uint8_t)(prev[0] + ((byte >> 4) & 3) - 2);
                v[1] = (uint8_t)(prev[1] + ((byte >> 2) & 3) - 2);
                v[2] = (uint8_t)(prev[2] + (byte & 3) - 2);
                v[3] = prev[3];
            } else if (op == 2) {
                if (pos >= n) return kTruncated;
                const uint8_t second = data[pos++];
                const int dg = (byte & 0x3F) - 32;
                v[0] = (uint8_t)(prev[0] + dg + ((second >> 4) & 0x0F) - 8);
                v[1] = (uint8_t)(prev[1] + dg);
                v[2] = (uint8_t)(prev[2] + dg + (second & 0x0F) - 8);
                v[3] = prev[3];
            } else {
                // a run repeats the previous pixel and leaves the index as it is
                for (int run = (byte & 0x3F) + 1; run > 0 && len < dest; run--) emit(prev);
                continue;
            }
        }
        std::memcpy(prev, v, 4);
        const int hash = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        std::memcpy(seen[hash], v, 4);
        have[hash] = true;
        emit(v);
    }
    return pos;
}

// BitDecode.c with IM's arguments (pad 8, fill 3, unsigned): xsize x ysize
// float samples of `bits` bits, the bit buffer filled and emptied least
// significant bit first, its count reset at each line's end.
int64_t citlab_bit_decode(const uint8_t* data, int64_t n, int64_t pos, int32_t bits,
                          int32_t xsize, int32_t ysize, float* out) {
    if (bits < 1 || bits >= 32 || xsize <= 0 || ysize <= 0) return kCorrupt;
    const uint64_t mask = ((uint64_t)1 << bits) - 1;
    uint64_t bitbuffer = 0;
    int bitcount = 0;
    int64_t x = 0, y = 0;
    while (pos < n) {
        const uint8_t byte = data[pos++];
        bitbuffer |= (uint64_t)byte << bitcount;
        bitcount += 8;
        while (bitcount >= bits) {
            const uint64_t value = bitbuffer & mask;
            if (bitcount > 32) {
                bitbuffer = byte >> (8 - (bitcount - bits));
            } else {
                bitbuffer >>= bits;
            }
            bitcount -= bits;
            out[y * xsize + x] = (float)value;
            if (++x >= xsize) {
                if (++y >= ysize) return 0;
                x = 0;
                bitcount = 0;
            }
        }
    }
    return kTruncated;
}

// FliDecode.c on one buffer: the frame chunk at buf[0], `bytes` bytes of
// it in hand. Returns the bytes consumed (0: wait for more) or -1 with
// `err` (0: the frame is done; else the decoder's error).
static int64_t fli_frame(const uint8_t* buf, int64_t bytes, int32_t xsize, int32_t ysize,
                         uint8_t* im, int& err) {
    auto i16 = [](const uint8_t* p) { return (int)p[0] | (int)p[1] << 8; };
    auto i32 = [](const uint8_t* p) {
        return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                         (uint32_t)p[3] << 24);
    };
    err = 0;
    if (bytes < 4) return 0;
    const uint8_t* ptr = buf;
    // the frame's size as PIL's build compares it: unsigned
    const int64_t framesize = (uint32_t)i32(ptr);
    // a full frame in hand first (one pad byte may be missing)
    if (bytes + (bytes % 2) < framesize) return 0;
    if (bytes < 8) {
        err = kOverrun;
        return -1;
    }
    if (i16(ptr + 4) != 0xF1FA) {
        err = kCorrupt;
        return -1;
    }
    const int chunks = i16(ptr + 6);
    ptr += 16;
    bytes -= 16;
    for (int c = 0; c < chunks; ++c) {
        if (bytes < 10) {
            err = kOverrun;
            return -1;
        }
        const uint8_t* data = ptr + 6;
        // the chunk's data must lie in what is in hand
        auto oob = [&](int64_t k) { return data + k > ptr + bytes; };
        switch (i16(ptr + 4)) {
            case 4: case 11: case 18:   // palettes (read at open), postage stamp
                break;
            case 7: {                    // SS2: word delta
                const int lines = i16(data);
                data += 2;
                int l = 0, y = 0;
                for (; l < lines && y < ysize; ++l, ++y) {
                    uint8_t* row = im + (int64_t)y * xsize;
                    if (oob(2)) { err = kOverrun; return -1; }
                    int packets = i16(data);
                    data += 2;
                    while (packets & 0x8000) {
                        if (packets & 0x4000) {
                            y += 65536 - packets;       // skip lines
                            if (y >= ysize) { err = kOverrun; return -1; }
                            row = im + (int64_t)y * xsize;
                        } else {
                            row[xsize - 1] = (uint8_t)packets;   // the odd last byte
                        }
                        if (oob(2)) { err = kOverrun; return -1; }
                        packets = i16(data);
                        data += 2;
                    }
                    int p = 0, x = 0;
                    for (; p < packets; ++p) {
                        if (oob(2)) { err = kOverrun; return -1; }
                        x += data[0];
                        if (data[1] >= 128) {
                            if (oob(4)) { err = kOverrun; return -1; }
                            const int i = 256 - data[1];
                            if (x + i + i > xsize) break;
                            for (int j = 0; j < i; ++j) {
                                row[x++] = data[2];
                                row[x++] = data[3];
                            }
                            data += 4;
                        } else {
                            const int i = 2 * (int)data[1];
                            if (x + i > xsize) break;
                            if (oob(2 + i)) { err = kOverrun; return -1; }
                            std::memcpy(row + x, data + 2, i);
                            data += 2 + i;
                            x += i;
                        }
                    }
                    if (p < packets) break;
                }
                if (l < lines) { err = kOverrun; return -1; }
                break;
            }
            case 12: {                   // LC: byte delta
                int y = i16(data);
                const int ymax = y + i16(data + 2);
                data += 4;
                for (; y < ymax && y < ysize; ++y) {
                    uint8_t* row = im + (int64_t)y * xsize;
                    if (oob(1)) { err = kOverrun; return -1; }
                    const int packets = *data++;
                    int p = 0, x = 0, i = 0;
                    for (; p < packets; ++p, x += i) {
                        if (oob(2)) { err = kOverrun; return -1; }
                        x += data[0];
                        if (data[1] & 0x80) {
                            i = 256 - data[1];
                            if (x + i > xsize) break;
                            if (oob(3)) { err = kOverrun; return -1; }
                            std::memset(row + x, data[2], i);
                            data += 3;
                        } else {
                            i = data[1];
                            if (x + i > xsize) break;
                            if (oob(2 + i)) { err = kOverrun; return -1; }
                            std::memcpy(row + x, data + 2, i);
                            data += i + 2;
                        }
                    }
                    if (p < packets) break;
                }
                if (y < ymax) { err = kOverrun; return -1; }
                break;
            }
            case 13:                     // BLACK
                std::memset(im, 0, (size_t)xsize * ysize);
                break;
            case 15:                     // BRUN: byte run length, the whole frame
                for (int y = 0; y < ysize; ++y) {
                    uint8_t* row = im + (int64_t)y * xsize;
                    data += 1;           // the packet count is not used
                    int x = 0, i = 0;
                    for (; x < xsize; x += i) {
                        if (oob(2)) { err = kOverrun; return -1; }
                        if (data[0] & 0x80) {
                            i = 256 - data[0];
                            if (x + i > xsize) break;
                            if (oob(i + 1)) { err = kOverrun; return -1; }
                            std::memcpy(row + x, data + 1, i);
                            data += i + 1;
                        } else {
                            i = data[0];
                            if (x + i > xsize) break;
                            std::memset(row + x, data[1], i);
                            data += 2;
                        }
                    }
                    if (x != xsize) { err = kOverrun; return -1; }
                }
                break;
            case 16:                     // COPY: the frame's pixels as they are
                if (INT32_MAX / xsize < ysize) { err = kOverrun; return -1; }
                if (oob((int64_t)xsize * ysize)) return ptr - buf;
                std::memcpy(im, data, (size_t)xsize * ysize);
                break;
            default:
                err = kCorrupt;
                return -1;
        }
        const int32_t advance = i32(ptr);
        if (advance == 0 || advance < 0 || advance > bytes) {
            err = kOverrun;
            return -1;
        }
        ptr += advance;
        bytes -= advance;
    }
    return -1;
}

// The first frame of an FLI / FLC file into im (xsize x ysize palette
// indices, zero to start with), as ImageFile.load drives FliDecode.c: the
// frame at `offset`, read framesize bytes at a time (PIL's decodermaxblock
// for the frame) and handed over with what the decoder left. Returns 0, or
// kTruncated where the file ends first, kOverrun / kCorrupt where the
// decoder fails.
int64_t citlab_fli_decode(const uint8_t* data, int64_t n, int64_t offset, int64_t framesize,
                          int32_t xsize, int32_t ysize, uint8_t* im) {
    if (xsize <= 0 || ysize <= 0) return kCorrupt;
    std::vector<uint8_t> buf;
    int64_t pos = offset;
    while (true) {
        const int64_t take = pos < n ? std::min(framesize, n - pos) : 0;
        if (take <= 0) return kTruncated;
        buf.insert(buf.end(), data + pos, data + pos + take);
        pos += take;
        int err = 0;
        const int64_t used = fli_frame(buf.data(), (int64_t)buf.size(), xsize, ysize, im, err);
        if (used < 0) return err ? err : 0;
        buf.erase(buf.begin(), buf.begin() + used);
    }
}

}  // extern "C"
