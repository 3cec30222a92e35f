// The native batch decoder of dsgan_tpu_torch (port of
// dsgan_tpu/runtime/loader.cpp): decode, crop and horizontally flip a
// batch of images into one contiguous uint8 NHWC buffer on C++ threads.
// The [-1, 1] normalize runs on the device. Bound with ctypes by
// dsgan_tpu_torch/runtime.py; a ctypes call releases the interpreter
// lock, so the loader's decoding no longer competes with the thread that
// dispatches the train step.
//
// PNG is decoded here, with its own inflate, so the library needs no
// image or compression library: a machine with g++ alone builds it.
// JPEG goes through libjpeg where its header was found at build time
// (-DDSGAN_WITH_JPEG -ljpeg). dsgan_formats() says which formats this
// build reads; a file it cannot read counts as a failed decode.
//
// PNG coverage: every colour type at 8 bits, RGB and RGBA at 16 bits
// (the high byte, as PIL reads them), grey and palette at 1, 2 and 4 bits
// (scaled to 0..255 as PIL does). Interlaced files and 16-bit grey are
// refused. Alpha and tRNS are dropped, as PIL's convert("RGB") drops them.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 [-DDSGAN_WITH_JPEG] loader.cpp
//        -lpthread [-ljpeg]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#ifdef DSGAN_WITH_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

struct Image {
    int w = 0, h = 0;
    std::vector<uint8_t> rgb;  // HWC, 3 channels
};

// ---------------------------------------------------------------- inflate

// Bits of a deflate stream, least significant first. Past the end of the
// input the reader supplies zero bytes and counts them, so a truncated
// stream shows as padding consumed.
struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int n = 0;
    int pad = 0;

    BitReader(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

    void fill() {
        while (n <= 56) {
            uint64_t byte = 0;
            if (p < end) {
                byte = *p++;
            } else {
                pad++;
            }
            buf |= byte << n;
            n += 8;
        }
    }
    uint32_t get(int k) {
        if (k == 0) return 0;
        if (n < k) fill();
        uint32_t v = uint32_t(buf & ((uint64_t(1) << k) - 1));
        buf >>= k;
        n -= k;
        return v;
    }
    void align() { get(n % 8); }
    // No zero byte past the end was consumed.
    bool intact() const { return pad <= n / 8; }
};

constexpr int kMaxBits = 15;
constexpr int kFastBits = 9;

// A canonical Huffman code: a table of the codes of at most kFastBits
// bits, indexed by the next kFastBits bits of the stream, and the counts
// and sorted symbols that decode the longer ones bit by bit.
struct Huffman {
    uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0: longer
    uint16_t count[kMaxBits + 1];
    uint16_t symbol[320];

    // False for an over-subscribed code. An incomplete code is allowed;
    // a symbol outside it fails to decode.
    bool build(const uint8_t* lengths, int n) {
        memset(fast, 0, sizeof(fast));
        memset(count, 0, sizeof(count));
        for (int s = 0; s < n; s++) count[lengths[s]]++;
        count[0] = 0;
        int left = 1;
        for (int len = 1; len <= kMaxBits; len++) {
            left = (left << 1) - count[len];
            if (left < 0) return false;
        }
        uint16_t offs[kMaxBits + 2];
        offs[1] = 0;
        for (int len = 1; len <= kMaxBits; len++) offs[len + 1] = offs[len] + count[len];
        for (int s = 0; s < n; s++)
            if (lengths[s]) symbol[offs[lengths[s]]++] = uint16_t(s);
        // the codes of at most kFastBits bits (RFC 1951 3.2.2), bit-reversed
        // into stream order
        int code = 0;
        int next[kMaxBits + 1];
        for (int len = 1; len <= kMaxBits; len++) {
            code = (code + count[len - 1]) << 1;
            next[len] = code;
        }
        for (int s = 0; s < n; s++) {
            int len = lengths[s];
            if (len == 0 || len > kFastBits) continue;
            int c = next[len]++;
            int rev = 0;
            for (int i = 0; i < len; i++) rev |= ((c >> i) & 1) << (len - 1 - i);
            for (int j = rev; j < (1 << kFastBits); j += 1 << len)
                fast[j] = uint16_t((len << 9) | s);
        }
        return true;
    }

    // The next symbol, or -1 for a code outside the table.
    int decode(BitReader& in) const {
        if (in.n < kMaxBits) in.fill();
        uint16_t e = fast[in.buf & ((1u << kFastBits) - 1)];
        if (e) {
            in.get(e >> 9);
            return e & 511;
        }
        int code = 0, first = 0, index = 0;
        for (int len = 1; len <= kMaxBits; len++) {
            code |= int(in.get(1));
            int c = count[len];
            if (code - c < first) return symbol[index + (code - first)];
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        return -1;
    }
};

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385,
                                24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

bool inflate_codes(BitReader& in, const Huffman& lit, const Huffman& dist, uint8_t* out,
                   size_t out_len, size_t* pos) {
    for (;;) {
        int s = lit.decode(in);
        if (s < 0) return false;
        if (s < 256) {
            if (*pos >= out_len) return false;
            out[(*pos)++] = uint8_t(s);
        } else if (s == 256) {
            return true;
        } else {
            s -= 257;
            if (s >= 29) return false;
            size_t len = kLenBase[s] + in.get(kLenExtra[s]);
            int d = dist.decode(in);
            if (d < 0 || d >= 30) return false;
            size_t back = kDistBase[d] + in.get(kDistExtra[d]);
            if (back > *pos || *pos + len > out_len) return false;
            uint8_t* q = out + *pos;
            for (size_t i = 0; i < len; i++) q[i] = q[i - back];  // may overlap
            *pos += len;
        }
        if (!in.intact()) return false;
    }
}

uint32_t adler32(const uint8_t* data, size_t len) {
    uint32_t a = 1, b = 0;
    while (len > 0) {
        size_t chunk = len < 5552 ? len : 5552;
        len -= chunk;
        while (chunk--) {
            a += *data++;
            b += a;
        }
        a %= 65521;
        b %= 65521;
    }
    return (b << 16) | a;
}

// A zlib stream (RFC 1950 around RFC 1951 deflate) that must inflate to
// exactly out_len bytes, its Adler-32 checked.
bool inflate_zlib(const uint8_t* src, size_t len, uint8_t* out, size_t out_len) {
    if (len < 6) return false;
    int cmf = src[0], flg = src[1];
    if ((cmf & 15) != 8 || (cmf * 256 + flg) % 31 != 0 || (flg & 32)) return false;
    BitReader in(src + 2, src + len);
    size_t pos = 0;
    static const Huffman* fixed = [] {
        static Huffman tables[2];
        uint8_t l[288];
        for (int i = 0; i < 288; i++) l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        tables[0].build(l, 288);
        uint8_t d[30];
        for (int i = 0; i < 30; i++) d[i] = 5;
        tables[1].build(d, 30);
        return tables;
    }();
    int final_block;
    do {
        final_block = int(in.get(1));
        int type = int(in.get(2));
        if (type == 0) {
            in.align();
            uint32_t n = in.get(16), nn = in.get(16);
            if ((n ^ 0xFFFFu) != nn || pos + n > out_len) return false;
            while (n > 0 && in.n >= 8) {
                out[pos++] = uint8_t(in.get(8));
                n--;
            }
            if (n > size_t(in.end - in.p)) return false;
            memcpy(out + pos, in.p, n);
            in.p += n;
            pos += n;
        } else if (type == 1) {
            if (!inflate_codes(in, fixed[0], fixed[1], out, out_len, &pos)) return false;
        } else if (type == 2) {
            int nlit = int(in.get(5)) + 257, ndist = int(in.get(5)) + 1;
            int ncode = int(in.get(4)) + 4;
            if (nlit > 286 || ndist > 30) return false;
            static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                              11, 4,  12, 3, 13, 2, 14, 1, 15};
            uint8_t cl[19] = {0};
            for (int i = 0; i < ncode; i++) cl[order[i]] = uint8_t(in.get(3));
            Huffman lens;
            if (!lens.build(cl, 19)) return false;
            uint8_t l[320];
            int i = 0;
            while (i < nlit + ndist) {
                int s = lens.decode(in);
                if (s < 0) return false;
                if (s < 16) {
                    l[i++] = uint8_t(s);
                    continue;
                }
                int rep;
                uint8_t val = 0;
                if (s == 16) {
                    if (i == 0) return false;
                    val = l[i - 1];
                    rep = 3 + int(in.get(2));
                } else if (s == 17) {
                    rep = 3 + int(in.get(3));
                } else {
                    rep = 11 + int(in.get(7));
                }
                if (i + rep > nlit + ndist) return false;
                while (rep--) l[i++] = val;
            }
            if (l[256] == 0) return false;
            Huffman lit, dist;
            if (!lit.build(l, nlit) || !dist.build(l + nlit, ndist)) return false;
            if (!inflate_codes(in, lit, dist, out, out_len, &pos)) return false;
        } else {
            return false;
        }
        if (!in.intact()) return false;
    } while (!final_block);
    in.align();
    uint32_t check = 0;
    for (int i = 0; i < 4; i++) check = (check << 8) | in.get(8);
    return in.intact() && pos == out_len && check == adler32(out, out_len);
}

// -------------------------------------------------------------------- PNG

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

bool decode_png(const std::vector<uint8_t>& file, Image* out) {
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    if (file.size() < 8 || memcmp(file.data(), sig, 8) != 0) return false;
    uint32_t w = 0, h = 0;
    int depth = 0, ctype = -1;
    std::vector<uint8_t> idat, palette;
    size_t pos = 8;
    bool ended = false;
    while (pos + 12 <= file.size()) {
        uint32_t len = be32(&file[pos]);
        const uint8_t* type = &file[pos + 4];
        const uint8_t* data = &file[pos + 8];
        if (len > file.size() - pos - 12) return false;
        if (!memcmp(type, "IHDR", 4)) {
            if (len < 13) return false;
            w = be32(data);
            h = be32(data + 4);
            depth = data[8];
            ctype = data[9];
            if (data[10] != 0 || data[11] != 0 || data[12] != 0) return false;  // interlaced
        } else if (!memcmp(type, "PLTE", 4)) {
            palette.assign(data, data + len);
        } else if (!memcmp(type, "IDAT", 4)) {
            idat.insert(idat.end(), data, data + len);
        } else if (!memcmp(type, "IEND", 4)) {
            ended = true;
            break;
        }
        pos += 12 + size_t(len);
    }
    if (!ended || w == 0 || h == 0 || w > (1u << 15) || h > (1u << 15)) return false;
    int channels;
    switch (ctype) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 3: channels = 1; break;
        case 4: channels = 2; break;
        case 6: channels = 4; break;
        default: return false;
    }
    bool low = (ctype == 0 || ctype == 3) && (depth == 1 || depth == 2 || depth == 4);
    bool wide = (ctype == 2 || ctype == 6) && depth == 16;
    if (!(depth == 8 || low || wide)) return false;
    if (ctype == 3 && (palette.empty() || palette.size() % 3)) return false;
    size_t bits = size_t(channels) * depth;
    size_t stride = (size_t(w) * bits + 7) / 8;
    size_t bpp = bits >= 8 ? bits / 8 : 1;
    std::vector<uint8_t> raw(size_t(h) * (stride + 1));
    if (!inflate_zlib(idat.data(), idat.size(), raw.data(), raw.size())) return false;

    std::vector<uint8_t> prior(stride, 0);
    out->w = int(w);
    out->h = int(h);
    out->rgb.resize(size_t(w) * h * 3);
    const size_t ncolors = palette.size() / 3;
    for (uint32_t y = 0; y < h; y++) {
        uint8_t* row = &raw[size_t(y) * (stride + 1)];
        int filter = row[0];
        uint8_t* x = row + 1;
        for (size_t i = 0; i < stride; i++) {
            int a = i >= bpp ? x[i - bpp] : 0, b = prior[i], c = i >= bpp ? prior[i - bpp] : 0;
            switch (filter) {
                case 0: break;
                case 1: x[i] = uint8_t(x[i] + a); break;
                case 2: x[i] = uint8_t(x[i] + b); break;
                case 3: x[i] = uint8_t(x[i] + ((a + b) >> 1)); break;
                case 4: x[i] = uint8_t(x[i] + paeth(a, b, c)); break;
                default: return false;
            }
        }
        memcpy(prior.data(), x, stride);
        uint8_t* dst = out->rgb.data() + size_t(y) * w * 3;
        for (uint32_t i = 0; i < w; i++, dst += 3) {
            if (low) {
                size_t bit = size_t(i) * depth;
                int v = (x[bit / 8] >> (8 - depth - bit % 8)) & ((1 << depth) - 1);
                if (ctype == 3) {
                    if (size_t(v) >= ncolors) return false;
                    memcpy(dst, &palette[3 * size_t(v)], 3);
                } else {
                    dst[0] = dst[1] = dst[2] = uint8_t(v * (255 / ((1 << depth) - 1)));
                }
            } else if (ctype == 3) {
                if (x[i] >= ncolors) return false;
                memcpy(dst, &palette[3 * size_t(x[i])], 3);
            } else if (ctype == 0 || ctype == 4) {
                dst[0] = dst[1] = dst[2] = x[size_t(i) * channels];
            } else {
                size_t step = depth / 8;  // 16-bit samples: the high byte
                const uint8_t* px = x + size_t(i) * channels * step;
                dst[0] = px[0];
                dst[1] = px[step];
                dst[2] = px[2 * step];
            }
        }
    }
    return true;
}

// ------------------------------------------------------------------- JPEG

#ifdef DSGAN_WITH_JPEG
struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

bool decode_jpeg(const std::vector<uint8_t>& file, Image* out) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(file.data()), file.size());
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    out->w = cinfo.output_width;
    out->h = cinfo.output_height;
    out->rgb.resize(size_t(out->w) * out->h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}
#endif

bool decode_file(const char* path, Image* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    std::vector<uint8_t> file;
    uint8_t chunk[1 << 16];
    size_t got;
    while ((got = fread(chunk, 1, sizeof(chunk), f)) > 0) file.insert(file.end(), chunk, chunk + got);
    fclose(f);
    if (file.size() >= 8 && file[0] == 0x89 && file[1] == 'P') return decode_png(file, out);
#ifdef DSGAN_WITH_JPEG
    if (file.size() >= 2 && file[0] == 0xFF && file[1] == 0xD8) return decode_jpeg(file, out);
#endif
    return false;
}

// crop (oy, ox, ch, cw), then an optional horizontal flip, into dst
// (ch * cw * 3 bytes). Rows and columns past the image clamp to its edge.
void postprocess_u8(const Image& im, int oy, int ox, int ch, int cw, int flip, uint8_t* dst) {
    for (int y = 0; y < ch; y++) {
        int sy = oy + y;
        if (sy < 0) sy = 0;
        if (sy >= im.h) sy = im.h - 1;
        const uint8_t* srow = im.rgb.data() + size_t(sy) * im.w * 3;
        uint8_t* drow = dst + size_t(y) * cw * 3;
        for (int x = 0; x < cw; x++) {
            int sx = ox + (flip ? (cw - 1 - x) : x);
            if (sx < 0) sx = 0;
            if (sx >= im.w) sx = im.w - 1;
            memcpy(drow + size_t(x) * 3, srow + size_t(sx) * 3, 3);
        }
    }
}

}  // namespace

extern "C" {

// Decode + crop + flip a batch of n images into out (n, crop_h, crop_w, 3)
// uint8; offs_y / offs_x / flips per image. Returns the number decoded;
// a failed image leaves zeros in its slot.
int dsgan_load_batch_u8(const char** paths, int n, const int* offs_y, const int* offs_x,
                        const int* flips, int crop_h, int crop_w, int num_threads,
                        uint8_t* out) {
    if (num_threads < 1) num_threads = 1;
    std::vector<int> ok(n, 0);
    const size_t stride = size_t(crop_h) * crop_w * 3;

    auto work = [&](int t) {
        for (int i = t; i < n; i += num_threads) {
            Image im;
            uint8_t* dst = out + size_t(i) * stride;
            if (decode_file(paths[i], &im)) {
                postprocess_u8(im, offs_y[i], offs_x[i], crop_h, crop_w, flips[i], dst);
                ok[i] = 1;
            } else {
                memset(dst, 0, stride);
            }
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
    int total = 0;
    for (int v : ok) total += v;
    return total;
}

// Decode one image; 1 and its size on success.
int dsgan_probe(const char* path, int* w, int* h) {
    Image im;
    if (!decode_file(path, &im)) return 0;
    *w = im.w;
    *h = im.h;
    return 1;
}

// The formats this build reads: bit 0 PNG, bit 1 JPEG.
int dsgan_formats(void) {
#ifdef DSGAN_WITH_JPEG
    return 3;
#else
    return 1;
#endif
}

}  // extern "C"
