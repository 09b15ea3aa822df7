// tile_ops.cpp — packed-emit rows -> BSON update-op documents, in C++.
//
// A copy of heatmap_tpu/native/tile_ops.cpp for heatmap_tpu_torch, built with
// g++ by heatmap_tpu_torch/_build.py into the port's own library.
//
// The sink hot path of the streaming runtime: each micro-batch's device
// emit arrives on the host as the packed (E+1, 13) uint32 matrix
// (heatmap_tpu/engine/step.py pack_emit).  The reference built one Python
// dict per tile row in its Spark job and let pymongo's C extension
// encode it (reference: heatmap_stream.py:163-196); here the whole
// row -> {q: {_id}, u: {$set: doc}, upsert: true} transformation runs in
// C++ straight from the columnar buffer to wire-ready BSON, so the Python
// layer never touches individual tile rows.
//
// The output is the concatenated op documents of the `update` command's
// "updates" document sequence (OP_MSG section kind 1); per-op end offsets
// let the caller chunk at the reference's 1000-op bulk size without
// re-parsing.  Field order and numeric semantics replicate
// sink/base.py::TileDoc + stream/runtime.py::_emit_docs exactly (the
// differential test decodes both and compares).
//
// Build: part of the port's native library (see native/__init__.py);
// no dependencies beyond the C++17 standard library.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>

namespace {

// ---- little-endian appenders into a caller-provided buffer ---------------

struct Buf {
    uint8_t* p;
    int64_t cap;
    int64_t len = 0;
    bool overflow = false;

    void need(int64_t n) {
        if (len + n > cap) overflow = true;
    }
    void raw(const void* src, int64_t n) {
        need(n);
        if (!overflow) std::memcpy(p + len, src, n);
        len += n;  // track virtual length even on overflow (for sizing)
    }
    void u8(uint8_t v) { raw(&v, 1); }
    void i32(int32_t v) { raw(&v, 4); }
    void i64(int64_t v) { raw(&v, 8); }
    void f64(double v) { raw(&v, 8); }
    void cstr(const char* s) { raw(s, (int64_t)std::strlen(s) + 1); }
    // reserve an int32 length slot; return its offset for backpatching
    int64_t mark() { int64_t at = len; i32(0); return at; }
    void patch(int64_t at) {
        if (overflow) return;
        int32_t total = (int32_t)(len - at);
        std::memcpy(p + at, &total, 4);
    }
};

// BSON element writers (type byte + name cstring + payload)
void el_str(Buf& b, const char* name, const char* s, int64_t n) {
    b.u8(0x02); b.cstr(name);
    b.i32((int32_t)(n + 1)); b.raw(s, n); b.u8(0);
}
void el_i32(Buf& b, const char* name, int32_t v) { b.u8(0x10); b.cstr(name); b.i32(v); }
void el_f64(Buf& b, const char* name, double v) { b.u8(0x01); b.cstr(name); b.f64(v); }
void el_dt(Buf& b, const char* name, int64_t ms) { b.u8(0x09); b.cstr(name); b.i64(ms); }
void el_bool(Buf& b, const char* name, bool v) { b.u8(0x08); b.cstr(name); b.u8(v ? 1 : 0); }
int64_t doc_open(Buf& b, const char* name) {  // subdocument element
    b.u8(0x03); b.cstr(name); return b.mark();
}
void doc_close(Buf& b, int64_t at) { b.u8(0); b.patch(at); }

// ---- civil-calendar conversion (Howard Hinnant's algorithm) --------------

void iso_z_from_epoch(int64_t sec, char out[24]) {
    int64_t days = sec / 86400;
    int64_t rem = sec % 86400;
    if (rem < 0) { rem += 86400; days -= 1; }
    int64_t z = days + 719468;
    int64_t era = (z >= 0 ? z : z - 146096) / 146097;
    int64_t doe = z - era * 146097;
    int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    int64_t y = yoe + era * 400;
    int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    int64_t mp = (5 * doy + 2) / 153;
    int64_t d = doy - (153 * mp + 2) / 5 + 1;
    int64_t m = mp < 10 ? mp + 3 : mp - 9;
    if (m <= 2) y += 1;
    std::snprintf(out, 24, "%04lld-%02lld-%02lldT%02lld:%02lld:%02lldZ",
                  (long long)y, (long long)m, (long long)d,
                  (long long)(rem / 3600), (long long)((rem / 60) % 60),
                  (long long)(rem % 60));
}

int hex_u64(uint64_t v, char out[17]) {  // lowercase, no leading zeros
    if (v == 0) { out[0] = '0'; out[1] = 0; return 1; }
    char tmp[16];
    int n = 0;
    while (v) { tmp[n++] = "0123456789abcdef"[v & 0xF]; v >>= 4; }
    for (int i = 0; i < n; i++) out[i] = tmp[n - 1 - i];
    out[n] = 0;
    return n;
}

inline float as_f32(uint32_t bits) {
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

}  // namespace

extern "C" {

// body: (n_rows, 13) uint32 row-major — the packed emit matrix WITHOUT its
// head row (lanes: key_hi, key_lo, ws, count, sum_speed, sum_speed2,
// sum_lat, sum_lon, valid, p95, anchor_speed, anchor_lat, anchor_lon;
// float lanes bitcast, see engine/step.py).  The sum lanes are residual
// sums about the anchor lanes; averages recombine anchor + resid/count
// here in double precision (the device has no f64 — engine/state.py).
// Writes concatenated BSON update-op docs into out (skipping rows with
// valid==0 or count<=0), records each op's END offset in offsets[i]
// (i = 0..n_docs-1), sets *bytes_out to the total length, and returns the
// doc count.  Returns -(needed_bytes) when cap is too small — call again
// with a buffer of at least that size.
int64_t enc_tile_ops(
    const uint32_t* body, int64_t n_rows,
    const char* city, const char* grid,
    int64_t window_ms, int64_t ttl_ms,
    int32_t window_minutes_tag, int32_t with_p95,
    uint8_t* out, int64_t cap,
    int64_t* offsets, int64_t* bytes_out) {
    Buf b{out, cap};
    int64_t n_docs = 0;
    char cell_hex[17];
    char iso[24];
    // _id = city|grid|cellhex|iso — sized from the actual inputs so no
    // row is ever skipped (the Python fallback drops none either)
    std::vector<char> idbuf(std::strlen(city) + std::strlen(grid)
                            + 16 + 23 + 3 + 1);

    for (int64_t r = 0; r < n_rows; r++) {
        const uint32_t* row = body + r * 13;
        if (row[8] == 0) continue;                 // valid lane
        int32_t count = (int32_t)row[3];
        if (count <= 0) continue;

        uint64_t cell = ((uint64_t)row[0] << 32) | row[1];
        int64_t ws = (int32_t)row[2];
        double sum_speed = as_f32(row[4]);
        double sum_speed2 = as_f32(row[5]);
        double sum_lat = as_f32(row[6]);
        double sum_lon = as_f32(row[7]);
        double p95 = as_f32(row[9]);
        double anchor_speed = as_f32(row[10]);
        double anchor_lat = as_f32(row[11]);
        double anchor_lon = as_f32(row[12]);

        hex_u64(cell, cell_hex);
        iso_z_from_epoch(ws, iso);
        int idn = std::snprintf(idbuf.data(), idbuf.size(), "%s|%s|%s|%s",
                                city, grid, cell_hex, iso);

        // residual moments: mean_r recombines with the anchor for the
        // average; variance is anchor-invariant (Var(v) = E[r^2]-E[r]^2)
        double mean_r = sum_speed / count;
        double avg_speed = anchor_speed + mean_r;
        double var = sum_speed2 / count - mean_r * mean_r;
        if (var < 0.0) var = 0.0;
        double stddev = std::sqrt(var);
        int64_t ws_ms = ws * 1000;
        int64_t we_ms = ws_ms + window_ms;

        int64_t op = b.mark();                     // op document
        {
            int64_t q = doc_open(b, "q");
            el_str(b, "_id", idbuf.data(), idn);
            doc_close(b, q);

            int64_t u = doc_open(b, "u");
            {
                int64_t set = doc_open(b, "$set");
                el_str(b, "_id", idbuf.data(), idn);
                el_str(b, "city", city, (int64_t)std::strlen(city));
                el_str(b, "grid", grid, (int64_t)std::strlen(grid));
                el_str(b, "cellId", cell_hex,
                       (int64_t)std::strlen(cell_hex));
                el_dt(b, "windowStart", ws_ms);
                el_dt(b, "windowEnd", we_ms);
                el_i32(b, "count", count);
                el_f64(b, "avgSpeedKmh", avg_speed);
                {
                    int64_t c = doc_open(b, "centroid");
                    el_str(b, "type", "Point", 5);
                    // BSON array = doc with "0","1" keys
                    b.u8(0x04); b.cstr("coordinates");
                    int64_t arr = b.mark();
                    el_f64(b, "0", anchor_lon + sum_lon / count);
                    el_f64(b, "1", anchor_lat + sum_lat / count);
                    b.u8(0); b.patch(arr);
                    doc_close(b, c);
                }
                el_dt(b, "staleAt", we_ms + ttl_ms);
                el_f64(b, "stddevSpeedKmh", stddev);
                if (with_p95) el_f64(b, "p95SpeedKmh", p95);
                if (window_minutes_tag)
                    el_i32(b, "windowMinutes", window_minutes_tag);
                doc_close(b, set);
            }
            doc_close(b, u);

            el_bool(b, "upsert", true);
        }
        b.u8(0);
        b.patch(op);
        if (offsets) offsets[n_docs] = b.len;
        n_docs++;
    }
    *bytes_out = b.len;
    if (b.overflow) return -b.len;
    return n_docs;
}

}  // extern "C"

// ---- binary wire-frame column writer (serve/wire.py fast path) ----------
//
// The serve tier's compact tile/delta frame: the header is assembled in
// Python (a few dozen bytes); this writes the column section — per-doc
// flag bytes, zigzag-varint cell-id deltas, varint counts, the three
// float columns (raw f64 bits or x100 fixed-point zigzag varints — the
// ENCODING DECISION is made in Python by the same helper the pure-Python
// writer uses, so both bodies are byte-identical by construction), varint
// windowMinutes, and raw i64 per-doc window overrides.  Float columns
// arrive as int64 arrays either way: f64 BITS for enc 0 (memcpy'd
// little-endian, exactly what struct.pack("<d") emits), scaled ints for
// enc 1.  Returns 0 and sets *bytes_out, or -needed_bytes on overflow
// (same resize convention as enc_tile_ops).

namespace {

inline void put_varint(Buf& b, uint64_t u) {
    while (true) {
        uint8_t x = (uint8_t)(u & 0x7F);
        u >>= 7;
        if (u) b.u8(x | 0x80);
        else { b.u8(x); return; }
    }
}

inline uint64_t zigzag64(int64_t v) {
    return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

inline void put_float_col(Buf& b, int32_t enc, const int64_t* vals,
                          int64_t n) {
    b.u8((uint8_t)enc);
    if (enc == 0) {
        b.raw(vals, 8 * n);  // little-endian f64 bits
    } else {
        for (int64_t i = 0; i < n; i++) put_varint(b, zigzag64(vals[i]));
    }
}

}  // namespace

extern "C" {

int64_t enc_wire_cols(
    const uint8_t* flags, int64_t n,
    const int64_t* deltas,
    const int64_t* counts,
    int32_t s_enc, const int64_t* speeds,
    int32_t p_enc, const int64_t* p95, int64_t n_p95,
    int32_t d_enc, const int64_t* stddev, int64_t n_std,
    const int64_t* wmin, int64_t n_wmin,
    const int64_t* overrides, int64_t n_ovr_vals,
    uint8_t* out, int64_t cap, int64_t* bytes_out) {
    Buf b{out, cap};
    b.raw(flags, n);
    for (int64_t i = 0; i < n; i++) put_varint(b, zigzag64(deltas[i]));
    for (int64_t i = 0; i < n; i++) put_varint(b, (uint64_t)counts[i]);
    put_float_col(b, s_enc, speeds, n);
    put_float_col(b, p_enc, p95, n_p95);
    put_float_col(b, d_enc, stddev, n_std);
    for (int64_t i = 0; i < n_wmin; i++)
        put_varint(b, (uint64_t)wmin[i]);
    b.raw(overrides, 8 * n_ovr_vals);
    *bytes_out = b.len;
    if (b.overflow) return -b.len;
    return 0;
}

}  // extern "C"
