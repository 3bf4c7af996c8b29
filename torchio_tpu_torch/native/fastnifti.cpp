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
//
// ctypes releases the interpreter lock for the duration of each call, so
// the Queue's worker threads decode in parallel.

#include <cstdint>
#include <cstring>
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

