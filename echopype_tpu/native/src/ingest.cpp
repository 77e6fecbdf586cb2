// Native datagram-framing scanner for Simrad .raw files.
//
// The datagram stream is length-prefixed: int32 size | body | int32 size
// (behavioral contract: echopype/convert/utils/ek_raw_io.py:133-234).
// This C++ scanner walks the framing in one pass and writes a columnar index
// (body offsets, sizes, 4-char type codes, NT timestamps) into caller-provided
// arrays, with bad-byte resync equivalent to the reference's recovery
// (ek_raw_io.py:473-486).  Exposed with C linkage for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

const char* KNOWN_TYPES[] = {"RAW", "CON", "NME", "XML", "TAG",
                             "BOT", "DEP", "MRU", "FIL", "IDX"};
const int N_KNOWN = 10;

inline bool plausible_type(const uint8_t* p) {
    for (int i = 0; i < N_KNOWN; ++i) {
        if (std::memcmp(p, KNOWN_TYPES[i], 3) == 0) return true;
    }
    return false;
}

inline int32_t read_i32(const uint8_t* buf, int64_t pos) {
    int32_t v;
    std::memcpy(&v, buf + pos, 4);  // little-endian hosts only (x86/ARM)
    return v;
}

inline uint32_t read_u32(const uint8_t* buf, int64_t pos) {
    uint32_t v;
    std::memcpy(&v, buf + pos, 4);
    return v;
}

// find next plausible datagram start from `start`; -1 if none
int64_t find_next_datagram(const uint8_t* buf, int64_t n, int64_t start) {
    for (int64_t i = start; i + 8 <= n; ++i) {
        if (!plausible_type(buf + i)) continue;
        if (i < 4) continue;
        int32_t size = read_i32(buf, i - 4);
        int64_t end = i + size;
        if (size >= 12 && end + 4 <= n && read_i32(buf, end) == size) {
            return i - 4;
        }
    }
    return -1;
}

}  // namespace

extern "C" {

// Scan the framing.  Returns the number of datagrams found (<= capacity).
// offsets/sizes/type_codes/timestamps_ns must hold `capacity` elements.
// type_codes are the 4 type bytes packed little-endian into a uint32.
// timestamps_ns are nanoseconds since the unix epoch.
int64_t ep_scan_datagrams(const uint8_t* buf, int64_t n, int resync,
                          int64_t capacity, int64_t* offsets, int32_t* sizes,
                          uint32_t* type_codes, int64_t* timestamps_ns) {
    const int64_t NT_UNIX_DELTA_TICKS = 11644473600LL * 10000000LL;
    int64_t count = 0;
    int64_t pos = 0;
    while (pos + 4 <= n && count < capacity) {
        int32_t size = read_i32(buf, pos);
        int64_t body = pos + 4;
        int64_t end = body + size;
        bool ok = (size >= 12) && (end <= n);
        if (ok && end + 4 <= n) {
            ok = (read_i32(buf, end) == size);
        } else if (ok) {
            ok = (end == n);  // truncated final datagram without trailer
        }
        if (!ok) {
            if (!resync) return -(pos + 1);  // negative => error position+1
            int64_t nxt = find_next_datagram(buf, n, pos + 1);
            if (nxt < 0) break;
            pos = nxt;
            continue;
        }
        offsets[count] = body;
        sizes[count] = size;
        std::memcpy(&type_codes[count], buf + body, 4);
        uint32_t low = read_u32(buf, body + 4);
        uint32_t high = read_u32(buf, body + 8);
        int64_t ticks = ((int64_t)high << 32) | (int64_t)low;
        timestamps_ns[count] = (ticks - NT_UNIX_DELTA_TICKS) * 100;
        ++count;
        pos = end + 4;
    }
    return count;
}

// Count datagrams without writing (for exact allocation if desired).
int64_t ep_count_datagrams(const uint8_t* buf, int64_t n, int resync) {
    int64_t count = 0;
    int64_t pos = 0;
    while (pos + 4 <= n) {
        int32_t size = read_i32(buf, pos);
        int64_t body = pos + 4;
        int64_t end = body + size;
        bool ok = (size >= 12) && (end <= n);
        if (ok && end + 4 <= n) {
            ok = (read_i32(buf, end) == size);
        } else if (ok) {
            ok = (end == n);
        }
        if (!ok) {
            if (!resync) return -(pos + 1);
            int64_t nxt = find_next_datagram(buf, n, pos + 1);
            if (nxt < 0) break;
            pos = nxt;
            continue;
        }
        ++count;
        pos = end + 4;
    }
    return count;
}

}  // extern "C"

extern "C" {

// Gather little-endian int16 runs of varying length into a padded matrix.
// Drop-in for the numpy fancy-gather (convert/simrad/decode.py:_gather_i16):
// row i copies counts[i] int16s from buf+starts[i] into vals[i*max_count..],
// zero-pads the rest, and writes a 0/1 validity mask.  memcpy handles the
// (common) unaligned datagram offsets.
// Fused gather + scale: out[i,k] = int16(buf+starts[i])[k] * scale for
// k < counts[i], NaN beyond -- the power-decode scaling (INDEX2POWER) and
// ragged NaN-padding in one pass, with no int16/validity intermediates.
void ep_gather_i16_scale_f32(const uint8_t* buf, const int64_t* starts,
                             const int64_t* counts, int64_t n_rows,
                             int64_t max_count, float scale, float* out) {
    const float NAN_F = __builtin_nanf("");
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t c = counts[i];
        if (c < 0) c = 0;
        if (c > max_count) c = max_count;
        const uint8_t* src = buf + starts[i];
        float* row = out + i * max_count;
        for (int64_t k = 0; k < c; ++k) {
            int16_t v;
            std::memcpy(&v, src + 2 * k, 2);
            row[k] = (float)v * scale;
        }
        for (int64_t k = c; k < max_count; ++k) row[k] = NAN_F;
    }
}

// Fused angle gather: each 16-bit sample is an (athwartship low byte,
// alongship high byte) int8 pair -> f32 [n, max_count, 2], NaN-padded.
void ep_gather_angle_f32(const uint8_t* buf, const int64_t* starts,
                         const int64_t* counts, int64_t n_rows,
                         int64_t max_count, float* out) {
    const float NAN_F = __builtin_nanf("");
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t c = counts[i];
        if (c < 0) c = 0;
        if (c > max_count) c = max_count;
        const int8_t* src = (const int8_t*)(buf + starts[i]);
        float* row = out + i * max_count * 2;
        for (int64_t k = 0; k < 2 * c; ++k) row[k] = (float)src[k];
        for (int64_t k = 2 * c; k < 2 * max_count; ++k) row[k] = NAN_F;
    }
}

// Fused float32 gather: out[i,k] = f32(buf+starts[i])[k] for k < counts[i],
// NaN beyond — the complex-sample (RAW3/RAW4) payload decode in one pass.
void ep_gather_f32_nan(const uint8_t* buf, const int64_t* starts,
                       const int64_t* counts, int64_t n_rows,
                       int64_t max_count, float* out) {
    const float NAN_F = __builtin_nanf("");
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t c = counts[i];
        if (c < 0) c = 0;
        if (c > max_count) c = max_count;
        float* row = out + i * max_count;
        if (c > 0) std::memcpy(row, buf + starts[i], (size_t)(c * 4));
        for (int64_t k = c; k < max_count; ++k) row[k] = NAN_F;
    }
}

// One-pass f32 -> int16 index conversion for the survey streamer's H2D
// buffers: dst[r,k] = rint(src[r,k] * scale) (round-half-to-even, matching
// numpy rint), NaN -> 0, saturating.  Replaces a 4-pass numpy chain
// (multiply, rint, nan_to_num, cast-store) -- 4x less memory traffic on the
// single-core ingest host.  Strides are in ELEMENTS.
void ep_f32_to_i16_scale(const float* src, int64_t n_rows, int64_t n_cols,
                         int64_t src_stride, float scale, int16_t* dst,
                         int64_t dst_stride) {
    for (int64_t r = 0; r < n_rows; ++r) {
        const float* s = src + r * src_stride;
        int16_t* d = dst + r * dst_stride;
        for (int64_t k = 0; k < n_cols; ++k) {
            float v = s[k];
            if (v != v) { d[k] = 0; continue; }
            float x = nearbyintf(v * scale);
            if (x > 32767.0f) x = 32767.0f;
            if (x < -32768.0f) x = -32768.0f;
            d[k] = (int16_t)x;
        }
    }
}

void ep_gather_i16(const uint8_t* buf, const int64_t* starts,
                   const int64_t* counts, int64_t n_rows, int64_t max_count,
                   int16_t* vals, uint8_t* valid) {
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t c = counts[i];
        if (c < 0) c = 0;
        if (c > max_count) c = max_count;
        int16_t* row = vals + i * max_count;
        uint8_t* vrow = valid + i * max_count;
        if (c > 0) std::memcpy(row, buf + starts[i], (size_t)(c * 2));
        if (c < max_count) {
            std::memset(row + c, 0, (size_t)((max_count - c) * 2));
        }
        std::memset(vrow, 1, (size_t)c);
        if (c < max_count) std::memset(vrow + c, 0, (size_t)(max_count - c));
    }
}

}  // extern "C"
