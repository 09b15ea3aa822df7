// kafka_codec.cpp — RecordBatch v2 decode + CRC32C, in C++.
//
// A copy of heatmap_tpu/native/kafka_codec.cpp for heatmap_tpu_torch, built with
// g++ by heatmap_tpu_torch/_build.py into the port's own library.
//
// The Kafka ingest hot path: a Fetch response's records blob is decoded
// straight to a newline-joined VALUES buffer ready for the columnar JSON
// decoder (decoder.cpp), plus per-value kafka offsets so the consumer's
// partial-take/offset bookkeeping keeps working.  Replaces the pure-Python
// per-record zigzag-varint walk and (especially) the per-byte Python
// CRC32C loop in heatmap_tpu/kafka/records.py, whose throughput ceiling
// (~10 MB/s) is far below the BASELINE ingest target.
//
// Semantics mirror records._decode(tolerant=True) exactly: truncated tail
// batches stop the scan; batches with bad CRC / unsupported magic /
// compression are skipped whole with their offset range advanced via the
// header's lastOffsetDelta.  Values containing raw \n or \r (impossible
// in compact JSON, possible in arbitrary payloads) are not emitted —
// they're counted so the caller can fall back to the Python record path
// for that blob.
//
// CRC32C uses the SSE4.2 hardware instruction when compiled with
// -msse4.2 (the build wrapper adds it on x86-64), else a slice-by-8
// table.

#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// ---- CRC32C --------------------------------------------------------------

#if !defined(__SSE4_2__)
struct Crc32cTable {
    uint32_t t[8][256];
    Crc32cTable() {
        const uint32_t poly = 0x82F63B78u;
        for (uint32_t n = 0; n < 256; n++) {
            uint32_t c = n;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
            t[0][n] = c;
        }
        for (uint32_t n = 0; n < 256; n++)
            for (int k = 1; k < 8; k++)
                t[k][n] = (t[k - 1][n] >> 8) ^ t[0][t[k - 1][n] & 0xFF];
    }
};
const Crc32cTable kTbl;
#endif

uint32_t crc32c_impl(const uint8_t* p, int64_t n, uint32_t crc) {
    crc ^= 0xFFFFFFFFu;
#if defined(__SSE4_2__)
    while (n >= 8) {
        uint64_t v;
        std::memcpy(&v, p, 8);
        crc = (uint32_t)_mm_crc32_u64(crc, v);
        p += 8;
        n -= 8;
    }
    while (n-- > 0) crc = _mm_crc32_u8(crc, *p++);
#else
    while (n >= 8) {
        uint32_t lo, hi;
        std::memcpy(&lo, p, 4);
        std::memcpy(&hi, p + 4, 4);
        lo ^= crc;
        crc = kTbl.t[7][lo & 0xFF] ^ kTbl.t[6][(lo >> 8) & 0xFF] ^
              kTbl.t[5][(lo >> 16) & 0xFF] ^ kTbl.t[4][lo >> 24] ^
              kTbl.t[3][hi & 0xFF] ^ kTbl.t[2][(hi >> 8) & 0xFF] ^
              kTbl.t[1][(hi >> 16) & 0xFF] ^ kTbl.t[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n-- > 0)
        crc = kTbl.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
#endif
    return crc ^ 0xFFFFFFFFu;
}

// ---- big-endian / varint readers ----------------------------------------

inline int32_t be32(const uint8_t* p) {
    return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | p[3]);
}
inline int64_t be64(const uint8_t* p) {
    return ((int64_t)be32(p) << 32) | (uint32_t)be32(p + 4);
}
inline int16_t be16(const uint8_t* p) {
    return (int16_t)(((uint16_t)p[0] << 8) | p[1]);
}

// zigzag varint; returns false on truncation
inline bool zvarint(const uint8_t* buf, int64_t end, int64_t& i,
                    int64_t& out) {
    uint64_t acc = 0;
    int shift = 0;
    while (i < end && shift <= 63) {
        uint8_t b = buf[i++];
        acc |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            out = (int64_t)(acc >> 1) ^ -(int64_t)(acc & 1);
            return true;
        }
        shift += 7;
    }
    return false;
}

}  // namespace

extern "C" {

uint32_t kc_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
    return crc32c_impl(p, n, crc);
}

// Decode a Fetch records blob into a joined values buffer.
//
//   framing   : 0 = newline-joined (JSON values; records whose value
//               contains a raw \n/\r are counted as oddballs and the
//               caller falls back); 1 = u32-length-prefixed (arbitrary
//               bytes — the binary event format, stream/binfmt.py)
//   blob      : out, >= len + cap_vals * (framing ? 4 : 1) bytes
//   val_off   : out, kafka offset of emitted value v
//   val_pos   : out, start of value v's frame in blob
//   out_state : [blob_len, next_offset, n_skipped_batches, n_oddballs,
//               n_null]
//
// Emits only records with offset >= start_offset and non-null values.
// Returns the number of emitted values, or -1 when an output capacity is
// exceeded (caller sizes capacities so this cannot happen for well-formed
// input; -1 therefore means malformed varints, and the caller falls back
// to the Python path).
int64_t kc_decode_values(
    const uint8_t* buf, int64_t len,
    int64_t start_offset, int32_t verify_crc, int32_t framing,
    uint8_t* blob, int64_t blob_cap,
    int64_t* val_off, int64_t* val_pos, int64_t cap_vals,
    int64_t* out_state) {
    int64_t n_vals = 0, blob_len = 0, skipped = 0, n_odd = 0, n_null = 0;
    int64_t next_offset = start_offset;
    int64_t i = 0;
    while (i + 12 <= len) {
        int64_t base_offset = be64(buf + i);
        int32_t batch_len = be32(buf + i + 8);
        int64_t end = i + 12 + batch_len;
        if (batch_len <= 0 || end > len) break;  // truncated tail
        bool ok = end - i >= 61;
        int8_t magic = ok ? (int8_t)buf[i + 16] : -1;
        if (ok && magic != 2) ok = false;
        if (ok) {
            uint32_t crc = (uint32_t)be32(buf + i + 17);
            int16_t attributes = be16(buf + i + 21);
            if (attributes & 0x07) ok = false;  // compressed
            if (ok && verify_crc &&
                crc32c_impl(buf + i + 21, end - (i + 21), 0) != crc)
                ok = false;
        }
        if (!ok) {
            // skip whole batch; advance offsets via lastOffsetDelta when
            // readable (fixed position i+23, mirror records.py)
            if (i + 27 <= len) {
                int32_t last_delta = be32(buf + i + 23);
                int64_t cand = base_offset + last_delta + 1;
                if (cand > next_offset) next_offset = cand;
            } else if (base_offset + 1 > next_offset) {
                next_offset = base_offset + 1;
            }
            skipped++;
            i = end;
            continue;
        }
        int32_t n = be32(buf + i + 57);
        int64_t j = i + 61;
        for (int32_t r = 0; r < n; r++) {
            int64_t rec_len;
            if (!zvarint(buf, end, j, rec_len)) return -1;
            int64_t rec_end = j + rec_len;
            if (rec_end > end) return -1;
            int64_t k = j;
            k++;  // record attributes
            int64_t ts_delta, off_delta, kn, vn;
            if (!zvarint(buf, rec_end, k, ts_delta)) return -1;
            if (!zvarint(buf, rec_end, k, off_delta)) return -1;
            if (!zvarint(buf, rec_end, k, kn)) return -1;
            k += kn > 0 ? kn : 0;
            if (!zvarint(buf, rec_end, k, vn)) return -1;
            int64_t voff = base_offset + off_delta;
            if (voff + 1 > next_offset) next_offset = voff + 1;
            if (voff >= start_offset) {
                if (vn < 0) {
                    n_null++;
                } else {
                    if (k + vn > rec_end) return -1;
                    bool odd = false;
                    if (framing == 0) {
                        for (int64_t t = 0; t < vn; t++) {
                            uint8_t c = buf[k + t];
                            if (c == '\n' || c == '\r') { odd = true; break; }
                        }
                    }
                    if (odd) {
                        n_odd++;
                    } else {
                        int64_t frame = framing ? vn + 4 : vn + 1;
                        if (n_vals >= cap_vals ||
                            blob_len + frame > blob_cap)
                            return -1;
                        val_off[n_vals] = voff;
                        val_pos[n_vals] = blob_len;
                        if (framing) {
                            uint32_t vlen = (uint32_t)vn;
                            std::memcpy(blob + blob_len, &vlen, 4);
                            blob_len += 4;
                        }
                        std::memcpy(blob + blob_len, buf + k, vn);
                        blob_len += vn;
                        if (!framing) blob[blob_len++] = '\n';
                        n_vals++;
                    }
                }
            }
            j = rec_end;
        }
        i = end;
    }
    out_state[0] = blob_len;
    out_state[1] = next_offset;
    out_state[2] = skipped;
    out_state[3] = n_odd;
    out_state[4] = n_null;
    return n_vals;
}

}  // extern "C"
