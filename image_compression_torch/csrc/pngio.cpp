// Native host runtime: PNG codec + segment slicer + metadata writer.
//
// The port's copy of the JAX package's native/pngio.cpp, unchanged but for
// this header: the port builds it itself (image_compression_torch/kernels.py,
// g++ at first use) and never loads the JAX package's library. Equivalent of
// the original system's host-side C++ layer: image_writer
// (cv::imwrite, image_writer.cpp:4-8), the slicer's per-label mask/bbox/crop
// work (image_slicer.cpp:15-130), and the metadata codec (metadata.cpp:4-34).
// No OpenCV: PNG encoding is implemented directly on zlib with adaptive
// per-row filtering (the same None/Sub/Up/Avg/Paeth minimum-|int8| heuristic
// libpng uses and the estimator models, png_size_estimator.cu:60-205), and
// slices are encoded in parallel with a std::thread pool (the reference uses
// one std::async task per label).
//
// Exposed via a C ABI for ctypes (see image_compression_torch/io/native.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

void put_u32_be(std::vector<uint8_t>& out, uint32_t v) {
    out.push_back((v >> 24) & 0xFF);
    out.push_back((v >> 16) & 0xFF);
    out.push_back((v >> 8) & 0xFF);
    out.push_back(v & 0xFF);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
    put_u32_be(out, (uint32_t)len);
    size_t start = out.size();
    out.insert(out.end(), type, type + 4);
    out.insert(out.end(), data, data + len);
    uint32_t crc = crc32(0, out.data() + start, (uInt)(len + 4));
    put_u32_be(out, crc);
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Filter one row with the given filter id into dst (without the filter byte).
void filter_row(uint8_t filter, const uint8_t* cur, const uint8_t* prev,
                int bpp, int stride, uint8_t* dst) {
    switch (filter) {
        case 0:
            std::memcpy(dst, cur, stride);
            break;
        case 1:
            for (int i = 0; i < stride; ++i) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                dst[i] = (uint8_t)(cur[i] - left);
            }
            break;
        case 2:
            for (int i = 0; i < stride; ++i) {
                int up = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(cur[i] - up);
            }
            break;
        case 3:
            for (int i = 0; i < stride; ++i) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                int up = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(cur[i] - ((left + up) >> 1));
            }
            break;
        default:
            for (int i = 0; i < stride; ++i) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                int up = prev ? prev[i] : 0;
                int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
                dst[i] = (uint8_t)(cur[i] - paeth(left, up, ul));
            }
    }
}

inline uint64_t abs_i8(uint8_t r) {
    int8_t v = (int8_t)r;
    return (uint64_t)std::abs((int)v);
}

// All 5 filter costs in ONE pass over the row (instead of five filter+cost
// passes plus up-to-five memcpys): per byte, compute left/up/ul once and
// accumulate each filter's |int8| residual cost.
void row_costs_all(const uint8_t* cur, const uint8_t* prev, int bpp,
                   int stride, uint64_t costs[5]) {
    uint64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0;
    for (int i = 0; i < stride; ++i) {
        const int x = cur[i];
        const int left = i >= bpp ? cur[i - bpp] : 0;
        const int up = prev ? prev[i] : 0;
        const int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
        c0 += abs_i8((uint8_t)x);
        c1 += abs_i8((uint8_t)(x - left));
        c2 += abs_i8((uint8_t)(x - up));
        c3 += abs_i8((uint8_t)(x - ((left + up) >> 1)));
        c4 += abs_i8((uint8_t)(x - paeth(left, up, ul)));
    }
    costs[0] = c0; costs[1] = c1; costs[2] = c2; costs[3] = c3; costs[4] = c4;
}

// Reusable per-thread encoder state: one deflate stream (deflateReset per
// image instead of a fresh deflateInit + ~256KB of window allocations per
// slice — the dominant cost for small slices) plus scratch buffers.
struct Encoder {
    z_stream strm{};
    bool init = false;
    std::vector<uint8_t> raw, comp;

    ~Encoder() {
        if (init) deflateEnd(&strm);
    }
    // init-or-reset the stream for one compression at `level`
    // (deflateParams must directly follow deflateReset, per zlib docs)
    int prepare(int level) {
        if (!init) {
            strm.zalloc = Z_NULL;
            strm.zfree = Z_NULL;
            strm.opaque = Z_NULL;
            if (deflateInit(&strm, level) != Z_OK) return 1;
            init = true;
            this->level = level;
            return 0;
        }
        if (deflateReset(&strm) != Z_OK) return 1;
        if (level != this->level) {
            if (deflateParams(&strm, level, Z_DEFAULT_STRATEGY) != Z_OK)
                return 1;
            this->level = level;
        }
        return 0;
    }
    int level = -1;
};

// Depth-generic PNG encode core: img_be points at rows already in PNG byte
// order (big-endian samples for depth 16); bpp/stride are in BYTES. PNG
// filters operate bytewise regardless of sample depth, so the adaptive
// min-|int8| filter selection is depth-agnostic.
int encode_core(const uint8_t* img_be, int height, int width, int channels,
                int depth, int level, uint8_t** out, size_t* out_len,
                Encoder* enc = nullptr) {
    if (!img_be || !out || !out_len || height <= 0 || width <= 0 ||
        channels < 1 || channels > 4 || (depth != 8 && depth != 16))
        return 1;
    static const uint8_t color_types[5] = {0, 0, 4, 2, 6};
    const int bpp = channels * (depth / 8);
    const int stride = width * bpp;

    Encoder local;
    if (!enc) enc = &local;
    std::vector<uint8_t>& raw = enc->raw;
    raw.resize((size_t)height * (stride + 1));

    // adaptive filtering: pick min-|int8| filter per row (single cost pass
    // over the row, then one filter application for the winner)
    for (int y = 0; y < height; ++y) {
        const uint8_t* cur = img_be + (size_t)y * stride;
        const uint8_t* prev =
            y > 0 ? img_be + (size_t)(y - 1) * stride : nullptr;
        uint64_t costs[5];
        row_costs_all(cur, prev, bpp, stride, costs);
        uint8_t best_f = 0;
        for (uint8_t f = 1; f < 5; ++f)
            if (costs[f] < costs[best_f]) best_f = f;
        uint8_t* dst = raw.data() + (size_t)y * (stride + 1);
        dst[0] = best_f;
        filter_row(best_f, cur, prev, bpp, stride, dst + 1);
    }

    if (enc->prepare(level)) return 2;
    uLong comp_bound = deflateBound(&enc->strm, (uLong)raw.size());
    std::vector<uint8_t>& comp = enc->comp;
    comp.resize(comp_bound);
    enc->strm.next_in = raw.data();
    enc->strm.avail_in = (uInt)raw.size();
    enc->strm.next_out = comp.data();
    enc->strm.avail_out = (uInt)comp_bound;
    if (deflate(&enc->strm, Z_FINISH) != Z_STREAM_END) return 2;
    comp_bound = enc->strm.total_out;

    std::vector<uint8_t> png;
    png.reserve(comp_bound + 128);
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    png.insert(png.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = (width >> 24) & 0xFF; ihdr[1] = (width >> 16) & 0xFF;
    ihdr[2] = (width >> 8) & 0xFF;  ihdr[3] = width & 0xFF;
    ihdr[4] = (height >> 24) & 0xFF; ihdr[5] = (height >> 16) & 0xFF;
    ihdr[6] = (height >> 8) & 0xFF;  ihdr[7] = height & 0xFF;
    ihdr[8] = (uint8_t)depth;         // bit depth
    ihdr[9] = color_types[channels];  // color type
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    put_chunk(png, "IHDR", ihdr, 13);
    put_chunk(png, "IDAT", comp.data(), comp_bound);
    put_chunk(png, "IEND", nullptr, 0);

    *out = (uint8_t*)std::malloc(png.size());
    if (!*out) return 3;
    std::memcpy(*out, png.data(), png.size());
    *out_len = png.size();
    return 0;
}

}  // namespace

extern "C" {

// Encode an 8-bit image to PNG. channels: 1=gray, 2=gray+alpha, 3=RGB,
// 4=RGBA. Returns a malloc'd buffer in *out (caller frees via
// pngio_free). Returns 0 on success.
int pngio_encode(const uint8_t* img, int height, int width, int channels,
                 int level, uint8_t** out, size_t* out_len) {
    return encode_core(img, height, width, channels, 8, level, out, out_len);
}

// Encode a 16-bit image (native-endian uint16 samples) to a 16-bit PNG.
int pngio_encode16(const uint16_t* img, int height, int width, int channels,
                   int level, uint8_t** out, size_t* out_len) {
    if (!img || height <= 0 || width <= 0 || channels < 1 || channels > 4)
        return 1;
    const size_t n = (size_t)height * width * channels;
    std::vector<uint8_t> be(n * 2);
    for (size_t i = 0; i < n; ++i) {
        be[2 * i] = (uint8_t)(img[i] >> 8);
        be[2 * i + 1] = (uint8_t)(img[i] & 0xFF);
    }
    return encode_core(be.data(), height, width, channels, 16, level, out,
                       out_len);
}

void pngio_free(uint8_t* p) { std::free(p); }

// Decode an 8- or 16-bit PNG (color types 0/2/4/6, no interlace). Caller
// provides the output query: first call with out=nullptr fills
// *height/*width/*channels/*bit_depth; second call with an adequately sized
// out buffer decodes (uint8 samples for depth 8, native-endian uint16 for
// depth 16).
int pngio_decode(const uint8_t* data, size_t len, uint8_t* out, int* height,
                 int* width, int* channels, int* bit_depth) {
    if (!data || len < 45 || !height || !width || !channels || !bit_depth)
        return 1;
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (std::memcmp(data, sig, 8) != 0) return 2;

    size_t pos = 8;
    int w = 0, h = 0, depth = 0, color = -1;
    std::vector<uint8_t> idat;
    while (pos + 8 <= len) {
        uint32_t clen = ((uint32_t)data[pos] << 24) | (data[pos + 1] << 16) |
                        (data[pos + 2] << 8) | data[pos + 3];
        const char* type = (const char*)data + pos + 4;
        const uint8_t* payload = data + pos + 8;
        if (pos + 12 + clen > len) return 3;
        if (!std::memcmp(type, "IHDR", 4)) {
            w = (payload[0] << 24) | (payload[1] << 16) | (payload[2] << 8) |
                payload[3];
            h = (payload[4] << 24) | (payload[5] << 16) | (payload[6] << 8) |
                payload[7];
            depth = payload[8];
            color = payload[9];
            if (payload[12] != 0) return 4;  // interlaced: unsupported
        } else if (!std::memcmp(type, "IDAT", 4)) {
            idat.insert(idat.end(), payload, payload + clen);
        } else if (!std::memcmp(type, "IEND", 4)) {
            break;
        }
        pos += 12 + clen;
    }
    if (depth != 8 && depth != 16) return 5;
    int ch;
    switch (color) {
        case 0: ch = 1; break;
        case 2: ch = 3; break;
        case 4: ch = 2; break;
        case 6: ch = 4; break;
        default: return 6;  // palette etc.: caller falls back to PIL
    }
    *height = h;
    *width = w;
    *channels = ch;
    *bit_depth = depth;
    if (!out) return 0;

    const int bpp = ch * (depth / 8);
    const int stride = w * bpp;
    std::vector<uint8_t> raw((size_t)h * (stride + 1));
    uLongf raw_len = (uLongf)raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size()) !=
            Z_OK || raw_len != raw.size())
        return 7;

    // unfilter in place in `raw` payload bytes (PNG byte order), then emit
    std::vector<uint8_t> decoded((size_t)h * stride);
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = raw.data() + (size_t)y * (stride + 1);
        uint8_t filter = src[0];
        ++src;
        uint8_t* dst = decoded.data() + (size_t)y * stride;
        const uint8_t* prev =
            y > 0 ? decoded.data() + (size_t)(y - 1) * stride : nullptr;
        for (int i = 0; i < stride; ++i) {
            int left = i >= bpp ? dst[i - bpp] : 0;
            int up = prev ? prev[i] : 0;
            int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
            int pred = 0;
            switch (filter) {
                case 0: pred = 0; break;
                case 1: pred = left; break;
                case 2: pred = up; break;
                case 3: pred = (left + up) >> 1; break;
                default: pred = paeth(left, up, ul);
            }
            dst[i] = (uint8_t)(src[i] + pred);
        }
    }
    if (depth == 8) {
        std::memcpy(out, decoded.data(), decoded.size());
    } else {
        uint16_t* out16 = (uint16_t*)out;
        const size_t n = (size_t)h * w * ch;
        for (size_t i = 0; i < n; ++i)
            out16[i] =
                (uint16_t)((decoded[2 * i] << 8) | decoded[2 * i + 1]);
    }
    return 0;
}

// Slice an RGBA image by a label map and write the slices in parallel.
// pack=0: slice_<label>.png files + metadata.bin into out_path (a
// directory) — mirrors write_slices (image_slicer.cpp:81-130) with one
// vectorized bbox pass instead of per-label O(K*H*W) scans. pack=1: ONE
// container file at out_path holding the identical bytes (the "SLPK"
// format of io/pack.py) — one file create instead of K+1, the host-side
// lever bench_host_scaling.py identified. Returns the number of slices
// written, or -1 on error.
static int write_slices_impl(const uint8_t* img_rgba, const int32_t* labels,
                             int height, int width, const char* out_path,
                             int level, int n_threads, int pack) {
    if (!img_rgba || !labels || !out_path) return -1;

    // one RUN-based pass: bbox + pixel count per label. Label maps are
    // piecewise constant along rows (connected multicut regions), so only
    // run endpoints touch the bbox arrays — ~runs/row updates instead of
    // width (VERDICT r3 next #5).
    int32_t max_label = 0;
    for (size_t i = 0; i < (size_t)height * width; ++i)
        max_label = std::max(max_label, labels[i]);
    const int k = max_label + 1;
    std::vector<int32_t> x0(k, width), y0(k, height), x1(k, -1), y1(k, -1);
    std::vector<uint32_t> cnt(k, 0);
    for (int y = 0; y < height; ++y) {
        const int32_t* row = labels + (size_t)y * width;
        int x = 0;
        while (x < width) {
            const int32_t lab = row[x];
            int x2 = x + 1;
            while (x2 < width && row[x2] == lab) ++x2;
            if (lab >= 0) {
                x0[lab] = std::min(x0[lab], x);
                x1[lab] = std::max(x1[lab], x2 - 1);
                y0[lab] = std::min(y0[lab], y);
                y1[lab] = std::max(y1[lab], y);
                cnt[lab] += (uint32_t)(x2 - x);
            }
            x = x2;
        }
    }

    // one whole-image opacity scan: compress inputs are opaque RGBA almost
    // always, and knowing it up front removes the per-pixel alpha checks
    // from every slice crop below
    bool all_opaque = true;
    for (size_t i = 0; i < (size_t)height * width && all_opaque; ++i)
        all_opaque = img_rgba[4 * i + 3] == 255;

    struct Meta {
        int32_t label, x, y, w, h;
        std::string filename;
    };
    std::vector<Meta> metas;
    std::vector<int> present;
    for (int lab = 0; lab < k; ++lab)
        if (x1[lab] >= 0) present.push_back(lab);

    metas.resize(present.size());
    std::vector<std::vector<uint8_t>> blobs;  // pack mode: PNGs in memory
    if (pack) blobs.resize(present.size());
    std::atomic<size_t> next{0};
    std::atomic<bool> ok{true};

    auto worker = [&]() {
        std::vector<uint8_t> crop;
        Encoder enc;  // per-thread: reused deflate stream + scratch buffers
        while (true) {
            size_t i = next.fetch_add(1);
            if (i >= present.size()) return;
            int lab = present[i];
            int bw = x1[lab] - x0[lab] + 1;
            int bh = y1[lab] - y0[lab] + 1;
            // A slice whose segment fills its whole bbox with opaque source
            // pixels carries no information in its alpha plane: write it as
            // RGB (color type 2) and save a quarter of the raw bytes.
            // Reassembly is unchanged (RGB decodes as fully opaque, and the
            // alpha>0 compositing mask was all-true for such slices anyway,
            // reassemble.cpp:94-98). The single-slice fallback's full-canvas
            // slice always hits this path.
            const bool full_bbox = cnt[lab] == (uint32_t)bw * (uint32_t)bh;
            int channels;
            if (full_bbox && all_opaque) {
                // fast path: no zero-fill, no mask checks, RGB written
                // directly from the source rows (no RGBA-then-squeeze)
                channels = 3;
                crop.resize((size_t)bw * bh * 3);
                for (int y = 0; y < bh; ++y) {
                    const uint8_t* irow =
                        img_rgba +
                        (((size_t)(y0[lab] + y)) * width + x0[lab]) * 4;
                    uint8_t* orow = crop.data() + (size_t)y * bw * 3;
                    for (int x = 0; x < bw; ++x) {
                        orow[3 * x] = irow[4 * x];
                        orow[3 * x + 1] = irow[4 * x + 1];
                        orow[3 * x + 2] = irow[4 * x + 2];
                    }
                }
            } else {
                crop.assign((size_t)bw * bh * 4, 0);
                size_t matched = 0;
                bool opaque = true;
                for (int y = 0; y < bh; ++y) {
                    const int gy = y0[lab] + y;
                    const int32_t* lrow =
                        labels + (size_t)gy * width + x0[lab];
                    const uint8_t* irow =
                        img_rgba + ((size_t)gy * width + x0[lab]) * 4;
                    uint8_t* orow = crop.data() + (size_t)y * bw * 4;
                    // span copies over the row's contiguous label runs
                    int x = 0;
                    while (x < bw) {
                        if (lrow[x] != lab) { ++x; continue; }
                        int x2 = x + 1;
                        while (x2 < bw && lrow[x2] == lab) ++x2;
                        std::memcpy(orow + (size_t)x * 4,
                                    irow + (size_t)x * 4,
                                    (size_t)(x2 - x) * 4);
                        matched += (size_t)(x2 - x);
                        if (!all_opaque)
                            for (int xx = x; xx < x2 && opaque; ++xx)
                                opaque = irow[(size_t)xx * 4 + 3] == 255;
                        x = x2;
                    }
                }
                channels = 4;
                if (opaque && matched == (size_t)bw * bh) {
                    channels = 3;
                    for (size_t p = 0; p < (size_t)bw * bh; ++p)
                        std::memmove(crop.data() + p * 3,
                                     crop.data() + p * 4, 3);
                }
            }
            uint8_t* png = nullptr;
            size_t png_len = 0;
            if (encode_core(crop.data(), bh, bw, channels, 8, level, &png,
                            &png_len, &enc)) {
                ok = false;
                return;
            }
            std::string fname =
                "slice_" + std::to_string(lab) + ".png";
            if (pack) {
                blobs[i].assign(png, png + png_len);
            } else {
                std::string path = std::string(out_path) + "/" + fname;
                FILE* f = std::fopen(path.c_str(), "wb");
                if (!f || std::fwrite(png, 1, png_len, f) != png_len)
                    ok = false;
                if (f) std::fclose(f);
            }
            pngio_free(png);
            metas[i] = Meta{lab, x0[lab], y0[lab], bw, bh, fname};
        }
    };

    int nt = n_threads > 0
                 ? n_threads
                 : (int)std::max(1u, std::thread::hardware_concurrency());
    nt = std::min<int>(nt, (int)present.size() + 1);
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    if (!ok) return -1;

    // metadata payload, byte-compatible with metadata.cpp:4-34
    std::vector<uint8_t> meta;
    uint32_t header[4] = {0x534C4943, (uint32_t)metas.size(), (uint32_t)width,
                          (uint32_t)height};
    meta.insert(meta.end(), (uint8_t*)header, (uint8_t*)(header + 4));
    for (const auto& m : metas) {
        int32_t fixed[5] = {m.label, m.x, m.y, m.w, m.h};
        uint16_t flen = (uint16_t)m.filename.size();
        meta.insert(meta.end(), (uint8_t*)fixed, (uint8_t*)(fixed + 5));
        meta.insert(meta.end(), (uint8_t*)&flen, (uint8_t*)(&flen + 1));
        meta.insert(meta.end(), m.filename.data(),
                    m.filename.data() + flen);
    }

    if (!pack) {
        std::string mpath = std::string(out_path) + "/metadata.bin";
        FILE* f = std::fopen(mpath.c_str(), "wb");
        if (!f) return -1;
        if (std::fwrite(meta.data(), 1, meta.size(), f) != meta.size()) {
            std::fclose(f);
            return -1;
        }
        std::fclose(f);
        return (int)metas.size();
    }

    // pack container: "SLPK" | u32 version | u64 meta_len | meta |
    // per record: u64 png_len | png  (io/pack.py wire format)
    FILE* f = std::fopen(out_path, "wb");
    if (!f) return -1;
    bool wok = std::fwrite("SLPK", 1, 4, f) == 4;
    uint32_t version = 1;
    wok = wok && std::fwrite(&version, 4, 1, f) == 1;
    uint64_t meta_len = meta.size();
    wok = wok && std::fwrite(&meta_len, 8, 1, f) == 1;
    wok = wok && std::fwrite(meta.data(), 1, meta.size(), f) == meta.size();
    for (const auto& blob : blobs) {
        uint64_t blen = blob.size();
        wok = wok && std::fwrite(&blen, 8, 1, f) == 1;
        wok = wok && std::fwrite(blob.data(), 1, blob.size(), f) ==
                         blob.size();
    }
    std::fclose(f);
    return wok ? (int)metas.size() : -1;
}

int pngio_write_slices(const uint8_t* img_rgba, const int32_t* labels,
                       int height, int width, const char* out_dir,
                       int level, int n_threads) {
    return write_slices_impl(img_rgba, labels, height, width, out_dir, level,
                             n_threads, 0);
}

// Reconstruct the pixel label map from bit-packed inter-pixel connectivity
// planes. hbits/vbits are row-major [height][ceil(width/8)] with bit x%8 of
// byte x/8 in row y set iff the edge (y,x)-(y,x+1) resp. (y,x)-(y+1,x)
// CONNECTS (the device packs them in ops/labels_wire.py; the v plane's last
// row is padding). Union-find with smaller-root-wins unions: the final root
// of every component is its smallest flat pixel index, i.e. exactly the
// device solver's minlabel contract (ops/multicut.py) — host labels match
// the device's bit-for-bit, only 2 bits/pixel ever cross the relay instead
// of 16 (the reference ships full label tensors, compress.cpp:141-142).
int pngio_labels_from_conn(const uint8_t* hbits, const uint8_t* vbits,
                           int height, int width, int32_t* labels_out) {
    if (!hbits || !vbits || !labels_out || height <= 0 || width <= 0)
        return -1;
    const int stride = (width + 7) / 8;
    const size_t n = (size_t)height * width;
    std::vector<int32_t> parent(n);
    for (size_t i = 0; i < n; ++i) parent[i] = (int32_t)i;
    auto find = [&](size_t i) {
        while (parent[i] != (int32_t)i) {
            parent[i] = parent[parent[i]];  // path halving
            i = (size_t)parent[i];
        }
        return i;
    };
    auto unite = [&](size_t a, size_t b) {
        size_t ra = find(a), rb = find(b);
        if (ra == rb) return;
        if (ra < rb)
            parent[rb] = (int32_t)ra;
        else
            parent[ra] = (int32_t)rb;
    };
    for (int y = 0; y < height; ++y) {
        const uint8_t* hrow = hbits + (size_t)y * stride;
        const uint8_t* vrow = vbits + (size_t)y * stride;
        const size_t base = (size_t)y * width;
        for (int xb = 0; xb < stride; ++xb) {
            uint8_t hb = hrow[xb];
            uint8_t vb = y + 1 < height ? vrow[xb] : 0;
            if (!hb && !vb) continue;
            const int x0b = xb * 8;
            for (int k = 0; k < 8 && x0b + k < width; ++k) {
                if ((hb >> k) & 1 && x0b + k + 1 < width)
                    unite(base + x0b + k, base + x0b + k + 1);
                if ((vb >> k) & 1) unite(base + x0b + k, base + x0b + k + width);
            }
        }
    }
    for (size_t i = 0; i < n; ++i) labels_out[i] = (int32_t)find(i);
    return 0;
}

// Slice directly from packed connectivity planes: label reconstruction +
// write_slices in one native call — the full host half of compress after a
// 2-bit/pixel fetch.
int pngio_write_slices_conn(const uint8_t* img_rgba, const uint8_t* hbits,
                            const uint8_t* vbits, int height, int width,
                            const char* out_path, int level, int n_threads,
                            int pack) {
    std::vector<int32_t> labels((size_t)height * width);
    if (pngio_labels_from_conn(hbits, vbits, height, width, labels.data()))
        return -1;
    return write_slices_impl(img_rgba, labels.data(), height, width, out_path,
                             level, n_threads, pack);
}

int pngio_write_slices_pack(const uint8_t* img_rgba, const int32_t* labels,
                            int height, int width, const char* pack_path,
                            int level, int n_threads) {
    return write_slices_impl(img_rgba, labels, height, width, pack_path,
                             level, n_threads, 1);
}

}  // extern "C"
