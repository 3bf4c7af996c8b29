// fastnifti: native decode engine for the port's NIfTI I/O hot path.
//
// Bound with ctypes by torchio_tpu_torch/native/__init__.py, which builds
// this file with g++ at first use (zlib is the only dependency):
//   - fn_gunzip:        zlib inflate of a gzip stream into a caller
//                       buffer (the expected size is known from the
//                       NIfTI header, so no realloc churn).
//   - fn_f2c_transpose: Fortran-order (I fastest) -> C-order (K fastest)
//                       layout transform with cache-blocked loops.
//   - fn_byteswap:      in-place endianness swap for 2/4/8-byte items.
//   - fn_jpegll_info/fn_jpegll_decode: JPEG Lossless (T.81 process 14),
//                       the DICOM syntaxes 1.2.840.10008.1.2.4.57/.70.
//   - fn_jls_info/fn_jls_decode: JPEG-LS (T.87), the DICOM syntaxes
//                       1.2.840.10008.1.2.4.80/.81.
//
// Each JPEG decoder returns 0, or a negative code for a stream it
// refuses: -10 marks restart intervals, declined by design; the caller
// hands every refused stream to the Python decoder of io/jpeg_lossless.py
// or io/jpeg_ls.py, which reads it or raises. Every marker segment is
// bounds-checked against the stream.
//
// ctypes releases the interpreter lock for the duration of each call, so
// the Queue's worker threads decode in parallel.

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

// Returns the number of bytes written, or a negative zlib error code.
// avail_in/avail_out are 32-bit in zlib, so streams and buffers larger
// than 4 GiB (common for 4D volumes) are fed through <4GiB windows.
long long fn_gunzip(const uint8_t* src, long long src_len,
                    uint8_t* dst, long long dst_cap) {
    z_stream strm;
    std::memset(&strm, 0, sizeof(strm));
    if (inflateInit2(&strm, 16 + MAX_WBITS) != Z_OK) return -100;
    constexpr long long WINDOW = 1LL << 30;  // 1 GiB refill granularity
    long long in_off = 0;
    long long out_off = 0;
    int ret = Z_OK;
    while (ret != Z_STREAM_END) {
        if (strm.avail_in == 0) {
            const long long chunk = src_len - in_off;
            if (chunk <= 0 && ret == Z_OK && out_off > 0) break;  // truncated/concat
            const long long take = chunk < WINDOW ? chunk : WINDOW;
            strm.next_in = const_cast<Bytef*>(src + in_off);
            strm.avail_in = static_cast<uInt>(take > 0 ? take : 0);
            in_off += take > 0 ? take : 0;
        }
        if (strm.avail_out == 0) {
            const long long room = dst_cap - out_off;
            if (room <= 0) { inflateEnd(&strm); return -101; }  // dst too small
            const long long give = room < WINDOW ? room : WINDOW;
            strm.next_out = dst + out_off;
            strm.avail_out = static_cast<uInt>(give);
            out_off += give;
        }
        const long long before = static_cast<long long>(strm.avail_out);
        ret = inflate(&strm, Z_NO_FLUSH);
        if (ret == Z_STREAM_END) break;
        if (ret == Z_BUF_ERROR && strm.avail_in == 0 && in_off >= src_len) {
            break;  // consumed all input without END marker (concat members)
        }
        // zlib's errors are negative already (Z_DATA_ERROR is -3); Z_NEED_DICT
        // (2) is not: every failure comes back negative
        if (ret != Z_OK) { inflateEnd(&strm); return ret < 0 ? ret : -ret; }
        (void)before;
    }
    const long long total = out_off - static_cast<long long>(strm.avail_out);
    inflateEnd(&strm);
    return total;
}

}  // extern "C" (reopened below; the template needs C++ linkage)

// F-order (i fastest) (I, J, K) volume -> C-order (k fastest).
// Cache-blocked over (i, k) planes; itemsize-templated dispatch.
template <typename T>
static void f2c_impl(const T* src, T* dst,
                     long long ni, long long nj, long long nk) {
    constexpr long long B = 64;
    for (long long j = 0; j < nj; ++j) {
        const T* splane = src + j * ni;       // stride between k slabs: ni*nj
        T* dplane = dst + j * nk;             // stride between i rows: nj*nk
        for (long long i0 = 0; i0 < ni; i0 += B) {
            const long long imax = i0 + B < ni ? i0 + B : ni;
            for (long long k0 = 0; k0 < nk; k0 += B) {
                const long long kmax = k0 + B < nk ? k0 + B : nk;
                for (long long i = i0; i < imax; ++i) {
                    const T* s = splane + i;
                    T* d = dplane + i * nj * nk;
                    for (long long k = k0; k < kmax; ++k) {
                        d[k] = s[k * ni * nj];
                    }
                }
            }
        }
    }
}

extern "C" int fn_f2c_transpose(const void* src, void* dst,
                     long long ni, long long nj, long long nk,
                     int itemsize) {
    switch (itemsize) {
        case 1: f2c_impl(static_cast<const uint8_t*>(src),
                         static_cast<uint8_t*>(dst), ni, nj, nk); return 0;
        case 2: f2c_impl(static_cast<const uint16_t*>(src),
                         static_cast<uint16_t*>(dst), ni, nj, nk); return 0;
        case 4: f2c_impl(static_cast<const uint32_t*>(src),
                         static_cast<uint32_t*>(dst), ni, nj, nk); return 0;
        case 8: f2c_impl(static_cast<const uint64_t*>(src),
                         static_cast<uint64_t*>(dst), ni, nj, nk); return 0;
        default: return -1;
    }
}

extern "C" int fn_byteswap(void* data, long long count, int itemsize) {
    if (itemsize == 2) {
        auto* p = static_cast<uint16_t*>(data);
        for (long long i = 0; i < count; ++i) p[i] = __builtin_bswap16(p[i]);
    } else if (itemsize == 4) {
        auto* p = static_cast<uint32_t*>(data);
        for (long long i = 0; i < count; ++i) p[i] = __builtin_bswap32(p[i]);
    } else if (itemsize == 8) {
        auto* p = static_cast<uint64_t*>(data);
        for (long long i = 0; i < count; ++i) p[i] = __builtin_bswap64(p[i]);
    } else {
        return -1;
    }
    return 0;
}



// ---------------------------------------------------------------------------
// JPEG Lossless (ITU T.81 process 14): single-component scans, predictors
// 1-7, point transform, byte stuffing. The Huffman table is the one the
// scan header names (DHT segments are kept per table id), turned into a
// lookup of every 16-bit window.
// ---------------------------------------------------------------------------

namespace jpegll {

struct BitReader {
    const unsigned char* data;
    long long n;
    long long pos = 0;
    unsigned long long buf = 0;
    int nbits = 0;

    void fill() {
        while (nbits <= 48) {
            unsigned byte = 0;
            if (pos < n) {
                byte = data[pos++];
                if (byte == 0xFF) {
                    unsigned nxt = pos < n ? data[pos] : 0;
                    if (nxt == 0x00) {
                        pos++;  // stuffed zero
                    } else {
                        pos--;  // marker: pad with zeros from here on
                        byte = 0;
                    }
                }
            }
            buf = (buf << 8) | byte;
            nbits += 8;
        }
    }
    unsigned read(int k) {
        if (k == 0) return 0;
        if (nbits < k) fill();
        nbits -= k;
        unsigned v = (unsigned)((buf >> nbits) & ((1ull << k) - 1));
        buf &= (1ull << nbits) - 1;
        return v;
    }
    unsigned peek16() {
        if (nbits < 16) fill();
        return (unsigned)((buf >> (nbits - 16)) & 0xFFFF);
    }
};

static int extend(int value, int ssss) {
    if (ssss == 0) return 0;
    if (ssss == 16) return 32768;
    if (value < (1 << (ssss - 1))) return value - (1 << ssss) + 1;
    return value;
}

// Canonical codes of one DHT table (its 16 counts, then its values) to
// the 16-bit window lookup: (length << 8) | value, 0 for no code.
static bool build_table(const unsigned char* table, long long avail,
                        unsigned short* fast) {
    if (avail < 17) return false;
    long long total = 0;
    for (int i = 1; i <= 16; ++i) total += table[i];
    if (17 + total > avail) return false;
    std::memset(fast, 0, sizeof(unsigned short) << 16);
    unsigned code = 0;
    long long k = 0;
    for (int len = 1; len <= 16; ++len) {
        for (int c = 0; c < table[len]; ++c) {
            const unsigned value = table[17 + k];
            const unsigned prefix = (code << (16 - len)) & 0xFFFF;
            const unsigned span = 1u << (16 - len);
            for (unsigned t = 0; t < span && (prefix | t) < 65536u; ++t)
                fast[prefix | t] = (unsigned short)((len << 8) | value);
            code++;
            k++;
        }
        code <<= 1;
    }
    return true;
}

}  // namespace jpegll

// Header info, so that the caller can size the buffer: 0 and
// height/width/precision from SOF3, or negative.
extern "C" int fn_jpegll_info(const unsigned char* s, long long n,
                              int* height, int* width, int* precision) {
    if (n < 4 || s[0] != 0xFF || s[1] != 0xD8) return -1;
    long long pos = 2;
    while (pos + 4 <= n) {
        if (s[pos] != 0xFF) return -2;
        unsigned marker = s[pos + 1];
        pos += 2;
        if (marker == 0xD9) break;
        long long length = (s[pos] << 8) | s[pos + 1];
        if (length < 2 || pos + length > n) return -2;
        if (marker == 0xC3) {
            if (length < 8) return -2;
            *precision = s[pos + 2];
            *height = (s[pos + 3] << 8) | s[pos + 4];
            *width = (s[pos + 5] << 8) | s[pos + 6];
            return 0;
        }
        pos += length;
    }
    return -3;
}

extern "C" int fn_jpegll_decode(const unsigned char* s, long long n,
                                unsigned short* out, long long capacity) {
    if (n < 4 || s[0] != 0xFF || s[1] != 0xD8) return -1;
    long long pos = 2;
    int precision = 0, height = 0, width = 0;
    int predictor = 1, point_transform = 0, table_id = 0;
    long long scan_start = -1;
    // where each table id's DHT entry starts, and the bytes after it
    long long table_at[16], table_avail[16];
    for (int i = 0; i < 16; ++i) table_at[i] = -1;

    while (pos + 4 <= n) {
        if (s[pos] != 0xFF) return -2;
        unsigned marker = s[pos + 1];
        pos += 2;
        if (marker == 0xD9) break;
        long long length = (s[pos] << 8) | s[pos + 1];
        if (length < 2 || pos + length > n) return -2;
        const unsigned char* seg = s + pos + 2;
        const long long seg_len = length - 2;
        if (marker == 0xC3) {
            if (seg_len < 6) return -2;
            precision = seg[0];
            height = (seg[1] << 8) | seg[2];
            width = (seg[3] << 8) | seg[4];
            if (seg[5] != 1) return -4;  // single component only
        } else if (marker == 0xC4) {
            long long off = 0;
            while (off < seg_len) {
                if (off + 17 > seg_len) return -2;
                long long total = 0;
                for (int i = 1; i <= 16; ++i) total += seg[off + i];
                table_at[seg[off] & 0x0F] = (seg - s) + off;
                table_avail[seg[off] & 0x0F] = seg_len - off;
                off += 17 + total;
            }
        } else if (marker == 0xDD) {
            if (seg_len < 2) return -2;
            // restart intervals: declined, the Python decoder reads them
            if ((seg[0] << 8) | seg[1]) return -10;
        } else if (marker == 0xDA) {
            if (seg_len < 1) return -2;
            const int ns = seg[0];
            if (ns != 1) return -5;
            if (seg_len < 6) return -2;
            table_id = seg[2] >> 4;
            predictor = seg[1 + 2 * ns];
            point_transform = seg[3 + 2 * ns] & 0x0F;
            scan_start = pos + length;
            break;
        }
        pos += length;
    }
    if (scan_start < 0 || precision == 0) return -6;
    if (precision > 16 || point_transform >= precision) return -6;
    if ((long long)height * width > capacity) return -7;
    if (predictor < 1 || predictor > 7) return -8;
    static thread_local unsigned short fast[1 << 16];
    if (table_at[table_id] < 0 ||
        !jpegll::build_table(s + table_at[table_id], table_avail[table_id], fast))
        return -6;

    jpegll::BitReader reader{s + scan_start, n - scan_start};
    const int default_pred = 1 << (precision - point_transform - 1);
    for (int r = 0; r < height; ++r) {
        for (int c = 0; c < width; ++c) {
            const unsigned entry = fast[reader.peek16()];
            const int len = entry >> 8;
            const int ssss = entry & 0xFF;
            if (len == 0) return -9;  // no such code
            if (ssss > 16) return -9;
            reader.read(len);
            const int diff = jpegll::extend(ssss < 16 ? (int)reader.read(ssss) : 0, ssss);
            int pred;
            if (r == 0 && c == 0) {
                pred = default_pred;
            } else if (r == 0) {
                pred = out[c - 1];
            } else if (c == 0) {
                pred = out[(long long)(r - 1) * width];
            } else {
                const int a = out[(long long)r * width + c - 1];
                const int b = out[(long long)(r - 1) * width + c];
                const int cc = out[(long long)(r - 1) * width + c - 1];
                switch (predictor) {
                    case 1: pred = a; break;
                    case 2: pred = b; break;
                    case 3: pred = cc; break;
                    case 4: pred = a + b - cc; break;
                    case 5: pred = a + ((b - cc) >> 1); break;
                    case 6: pred = b + ((a - cc) >> 1); break;
                    default: pred = (a + b) >> 1; break;
                }
            }
            out[(long long)r * width + c] = (unsigned short)(((unsigned)(pred + diff)) & 0xFFFFu);
        }
    }
    // mask to the precision, then the point transform
    const unsigned pmask = precision >= 16 ? 0xFFFFu : ((1u << precision) - 1);
    const long long total = (long long)height * width;
    for (long long i = 0; i < total; ++i)
        out[i] = (unsigned short)(((unsigned)out[i] & pmask) << point_transform);
    return 0;
}

// ---------------------------------------------------------------------------
// JPEG-LS (ITU T.87 / ISO 14495-1, LOCO-I): regular and run modes, LSE
// preset parameters, near-lossless, multi-component scans in interleave
// mode 0 (one component a scan).
// ---------------------------------------------------------------------------

namespace jls {

static const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,  2,  3,  3,  3,  3,
                          4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct BitReader {
    const unsigned char* data;
    long long n;
    long long pos = 0;
    unsigned long long buf = 0;
    int nbits = 0;
    bool prev_ff = false;
    bool corrupt = false;

    void fill() {
        while (nbits <= 32) {
            if (pos >= n) {
                buf <<= 8;
                nbits += 8;
                continue;
            }
            unsigned b = data[pos];
            if (prev_ff) {  // the byte after 0xFF carries 7 bits
                buf = (buf << 7) | (b & 0x7F);
                nbits += 7;
                prev_ff = false;
                pos++;
                continue;
            }
            if (b == 0xFF) {
                unsigned nxt = pos + 1 < n ? data[pos + 1] : 0xD9;
                if (nxt & 0x80) {  // marker: stop, zero-pad
                    pos = n;
                    continue;
                }
                buf = (buf << 8) | 0xFF;
                nbits += 8;
                prev_ff = true;
                pos++;
                continue;
            }
            buf = (buf << 8) | b;
            nbits += 8;
            pos++;
        }
    }
    unsigned read(int k) {
        if (k == 0) return 0;
        if (nbits < k) fill();
        nbits -= k;
        unsigned v = (unsigned)((buf >> nbits) & ((1ull << k) - 1));
        buf &= (1ull << nbits) - 1;
        return v;
    }
    int read_unary() {
        int count = 0;
        for (;;) {
            if (nbits < 16) fill();
            unsigned window = (unsigned)((buf >> (nbits - 16)) & 0xFFFF);
            if (window == 0) {
                nbits -= 16;
                buf &= (1ull << nbits) - 1;
                count += 16;
                if (count > 4096) { corrupt = true; return 0; }
                continue;
            }
            int lead = __builtin_clz(window) - 16;
            nbits -= lead + 1;
            buf &= (1ull << nbits) - 1;
            return count + lead;
        }
    }
};

struct Params {
    int maxval, near, t1, t2, t3, reset;
    int range, qbpp, bpp, limit;

    void derive() {
        range = (maxval + 2 * near) / (2 * near + 1) + 1;
        qbpp = 0;
        while ((1 << qbpp) < range) qbpp++;
        bpp = 2;
        while ((1 << bpp) <= maxval) bpp++;
        limit = 2 * (bpp + (bpp > 8 ? bpp : 8));
    }
    void default_thresholds() {
        auto clamp1 = [&](int x, int lo) { return (x > maxval || x < lo) ? lo : x; };
        if (maxval >= 128) {
            int f = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
            t1 = clamp1(f + 2 + 3 * near, near + 1);
            t2 = clamp1(4 * f + 3 + 5 * near, t1);
            t3 = clamp1(17 * f + 4 + 7 * near, t2);
        } else {
            int f = 256 / (maxval + 1);
            int v1 = 3 / f + 3 * near; if (v1 < 2) v1 = 2;
            int v2 = 7 / f + 5 * near; if (v2 < 3) v2 = 3;
            int v3 = 21 / f + 7 * near; if (v3 < 4) v3 = 4;
            t1 = clamp1(v1, near + 1);
            t2 = clamp1(v2, t1);
            t3 = clamp1(v3, t2);
        }
    }
};

struct State {
    Params p;
    int A[365], B[365], C[365], N[365];
    int A_run[2], N_run[2], Nn[2];
    int run_index;

    void init(const Params& params) {
        p = params;
        int a_init = (p.range + 32) >> 6;
        if (a_init < 2) a_init = 2;
        for (int i = 0; i < 365; ++i) {
            A[i] = a_init; B[i] = 0; C[i] = 0; N[i] = 1;
        }
        A_run[0] = A_run[1] = a_init;
        N_run[0] = N_run[1] = 1;
        Nn[0] = Nn[1] = 0;
        run_index = 0;
    }
    int quantize(int d) const {
        if (d <= -p.t3) return -4;
        if (d <= -p.t2) return -3;
        if (d <= -p.t1) return -2;
        if (d < -p.near) return -1;
        if (d <= p.near) return 0;
        if (d < p.t1) return 1;
        if (d < p.t2) return 2;
        if (d < p.t3) return 3;
        return 4;
    }
    void update_regular(int q, int errval) {
        B[q] += errval * (2 * p.near + 1);
        A[q] += errval < 0 ? -errval : errval;
        if (N[q] == p.reset) {
            A[q] >>= 1;
            B[q] = B[q] >= 0 ? (B[q] >> 1) : -((1 - B[q]) >> 1);
            N[q] >>= 1;
        }
        N[q] += 1;
        int nv = N[q];
        if (B[q] <= -nv) {
            B[q] += nv;
            if (C[q] > -128) C[q] -= 1;
            if (B[q] <= -nv) B[q] = -nv + 1;
        } else if (B[q] > 0) {
            B[q] -= nv;
            if (C[q] < 127) C[q] += 1;
            if (B[q] > 0) B[q] = 0;
        }
    }
};

static inline int med(int a, int b, int c) {
    int mx = a > b ? a : b, mn = a < b ? a : b;
    if (c >= mx) return mn;
    if (c <= mn) return mx;
    return a + b - c;
}

static inline int clampv(int x, int maxval) {
    return x < 0 ? 0 : (x > maxval ? maxval : x);
}

static inline int reconstruct(int px, int sign_err, const Params& p) {
    int rx = px + sign_err;
    int span = p.range * (2 * p.near + 1);
    if (rx < -p.near) rx += span;
    else if (rx > p.maxval + p.near) rx -= span;
    return clampv(rx, p.maxval);
}

static int decode_limited(BitReader& r, int k, int limit, int qbpp) {
    int u = r.read_unary();
    if (r.corrupt) return -1;
    if (u < limit - qbpp - 1) return (u << k) | (int)r.read(k);
    if (u == limit - qbpp - 1) return (int)r.read(qbpp) + 1;
    r.corrupt = true;
    return -1;
}

static int decode_run_interruption(BitReader& r, State& st,
                                   const int* cur, const int* prev, int col) {
    const Params& p = st.p;
    int a = cur[col];
    int b = prev[col + 1];
    int d = a - b;
    int ritype = (d < 0 ? -d : d) <= p.near ? 1 : 0;
    int px = ritype ? a : b;
    int n = st.N_run[ritype];
    int temp = st.A_run[ritype] + (ritype ? (n >> 1) : 0);
    int k = 0;
    while ((n << k) < temp) k++;
    int limit = p.limit - J[st.run_index] - 1;
    int emap = decode_limited(r, k, limit, p.qbpp);
    if (r.corrupt) return 0;
    int tmp2 = emap + ritype;
    int map_bit = tmp2 & 1;
    int eabs = (tmp2 + map_bit) >> 1;
    int errval;
    if (((k != 0 || 2 * st.Nn[ritype] >= n) ? 1 : 0) == map_bit)
        errval = -eabs;
    else
        errval = eabs;
    if (errval < 0) st.Nn[ritype] += 1;
    st.A_run[ritype] += (emap + 1 - ritype) >> 1;
    if (st.N_run[ritype] == p.reset) {
        st.A_run[ritype] >>= 1;
        st.N_run[ritype] >>= 1;
        st.Nn[ritype] >>= 1;
    }
    st.N_run[ritype] += 1;
    int sign = (ritype == 0 && a > b) ? -1 : 1;
    return reconstruct(px, sign * errval * (2 * p.near + 1), p);
}

// Decode one scan (one component) into out, `stride` samples apart.
// Returns 0 or negative.
static int decode_scan(BitReader& r, unsigned short* out, long long stride,
                       int width, int height, const Params& params) {
    static thread_local State st;
    st.init(params);
    const Params& p = st.p;
    const int near = p.near;
    std::vector<int> buf_a((size_t)width + 2, 0), buf_b((size_t)width + 2, 0);
    int* prev = buf_a.data();
    int* cur = buf_b.data();
    for (int row = 0; row < height; ++row) {
        int* t = prev; prev = cur; cur = t;
        cur[0] = prev[1];
        prev[width + 1] = prev[width];
        int col = 0;
        while (col < width) {
            int a = cur[col], c = prev[col], b = prev[col + 1], d = prev[col + 2];
            int d1 = d - b, d2 = b - c, d3 = c - a;
            int a1 = d1 < 0 ? -d1 : d1, a2 = d2 < 0 ? -d2 : d2,
                a3 = d3 < 0 ? -d3 : d3;
            if (a1 <= near && a2 <= near && a3 <= near) {
                // run mode
                int runval = cur[col];
                for (;;) {
                    if (r.read(1) == 1) {
                        int seg = 1 << J[st.run_index];
                        int fill = seg < width - col ? seg : width - col;
                        for (int i = col + 1; i <= col + fill; ++i) cur[i] = runval;
                        col += fill;
                        if (fill == seg && st.run_index < 31) st.run_index++;
                        if (col >= width) break;
                    } else {
                        int jbits = J[st.run_index];
                        int cnt = jbits ? (int)r.read(jbits) : 0;
                        if (cnt > width - col - 1) return -20;
                        for (int i = col + 1; i <= col + cnt; ++i) cur[i] = runval;
                        col += cnt;
                        cur[col + 1] = decode_run_interruption(r, st, cur, prev, col);
                        if (st.run_index > 0) st.run_index--;
                        col += 1;
                        break;
                    }
                }
                if (r.corrupt) return -21;
                continue;
            }
            int q1 = st.quantize(d1), q2 = st.quantize(d2), q3 = st.quantize(d3);
            int q = 81 * q1 + 9 * q2 + q3;
            int sign = 1;
            if (q < 0) { sign = -1; q = -q; }
            int px = clampv(med(a, b, c) + sign * st.C[q], p.maxval);
            int av = st.A[q], nv = st.N[q];
            int k = 0;
            while ((nv << k) < av) k++;
            int merr = decode_limited(r, k, p.limit, p.qbpp);
            if (r.corrupt) return -21;
            int errval = (merr & 1) ? -((merr + 1) >> 1) : (merr >> 1);
            if (k == 0 && near == 0 && 2 * st.B[q] <= -st.N[q])
                errval = -errval - 1;
            st.update_regular(q, errval);
            cur[col + 1] = reconstruct(px, sign * errval * (2 * near + 1), p);
            col += 1;
        }
        unsigned short* line = out + (long long)row * width * stride;
        for (int i = 0; i < width; ++i)
            line[(long long)i * stride] = (unsigned short)cur[i + 1];
    }
    return 0;
}

}  // namespace jls

// Header info, so that the caller can size the buffer: 0 and
// height/width/ncomp/precision from SOF55, or negative.
extern "C" int fn_jls_info(const unsigned char* s, long long n, int* height,
                           int* width, int* ncomp, int* precision) {
    if (n < 4 || s[0] != 0xFF || s[1] != 0xD8) return -1;
    long long pos = 2;
    while (pos + 4 <= n) {
        if (s[pos] != 0xFF) return -2;
        unsigned marker = s[pos + 1];
        pos += 2;
        if (marker == 0xD9) break;
        if (marker >= 0xD0 && marker <= 0xD7) continue;
        long long length = ((long long)s[pos] << 8) | s[pos + 1];
        if (length < 2 || pos + length > n) return -2;
        if (marker == 0xF7) {
            if (length < 8) return -2;
            *precision = s[pos + 2];
            *height = ((int)s[pos + 3] << 8) | s[pos + 4];
            *width = ((int)s[pos + 5] << 8) | s[pos + 6];
            *ncomp = s[pos + 7];
            return 0;
        }
        pos += length;
    }
    return -3;
}

extern "C" int fn_jls_decode(const unsigned char* s, long long n,
                             unsigned short* out, long long capacity) {
    if (n < 4 || s[0] != 0xFF || s[1] != 0xD8) return -1;
    long long pos = 2;
    int precision = 0, height = 0, width = 0, ncomp = 0;
    int maxval = 0, t1 = 0, t2 = 0, t3 = 0, reset = 64;
    bool have_lse = false;
    int decoded = 0;
    while (pos + 2 <= n) {
        if (s[pos] != 0xFF) return -2;
        unsigned marker = s[pos + 1];
        pos += 2;
        if (marker == 0xD9) break;
        if (marker >= 0xD0 && marker <= 0xD7) continue;
        if (pos + 2 > n) return -2;
        long long length = ((long long)s[pos] << 8) | s[pos + 1];
        if (length < 2 || pos + length > n) return -2;
        const unsigned char* seg = s + pos + 2;
        const long long seg_len = length - 2;
        if (marker == 0xF7) {
            if (seg_len < 6) return -2;
            precision = seg[0];
            height = ((int)seg[1] << 8) | seg[2];
            width = ((int)seg[3] << 8) | seg[4];
            ncomp = seg[5];
            if (precision < 2 || precision > 16 || ncomp < 1) return -6;
            maxval = (1 << precision) - 1;
        } else if (marker == 0xF8) {
            if (seg_len < 1) return -2;
            if (seg[0] != 1) return -11;  // mapping tables: declined
            if (seg_len < 11) return -2;
            int mv = ((int)seg[1] << 8) | seg[2];
            t1 = ((int)seg[3] << 8) | seg[4];
            t2 = ((int)seg[5] << 8) | seg[6];
            t3 = ((int)seg[7] << 8) | seg[8];
            int rs = ((int)seg[9] << 8) | seg[10];
            if (mv) maxval = mv;
            if (rs) reset = rs;
            have_lse = true;
        } else if (marker == 0xDD) {
            if (seg_len < 2) return -2;
            if (((int)seg[0] << 8) | seg[1]) return -10;  // restart intervals: declined
        } else if (marker == 0xDA) {
            if (precision == 0) return -6;
            if (seg_len < 1) return -2;
            int ns = seg[0];
            if (seg_len < 3 + 2 * ns) return -2;
            int near = seg[1 + 2 * ns];
            int ilv = seg[2 + 2 * ns];
            if (ns != 1 || (ilv != 0 && ncomp > 1)) return -5;
            if ((long long)height * width * ncomp > capacity) return -7;
            jls::Params p;
            p.maxval = maxval;
            p.near = near;
            p.reset = reset;
            if (maxval < 1 || maxval > 65535 || near < 0 || near >= maxval) return -12;
            p.default_thresholds();
            if (have_lse) {
                if (t1) p.t1 = t1;
                if (t2) p.t2 = t2;
                if (t3) p.t3 = t3;
            }
            p.derive();
            jls::BitReader reader{s + pos + length, n - pos - length};
            int rc = jls::decode_scan(reader, out + decoded, ncomp, width, height, p);
            if (rc != 0) return rc;
            decoded++;
            if (decoded == ncomp) return 0;
            // past the entropy-coded data, to the next marker
            long long i = pos + length;
            for (;;) {
                while (i + 1 < n && s[i] != 0xFF) i++;
                if (i + 1 >= n) return -13;
                unsigned nxt = s[i + 1];
                if ((nxt & 0x80) && !(nxt >= 0xD0 && nxt <= 0xD7)) break;
                i++;
            }
            pos = i;
            continue;
        }
        pos += length;
    }
    return decoded == ncomp && decoded > 0 ? 0 : -6;
}
