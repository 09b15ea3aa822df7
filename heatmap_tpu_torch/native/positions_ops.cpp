// positions_ops.cpp — columnar positions -> BSON pipeline-update ops.
//
// A copy of heatmap_tpu/native/positions_ops.cpp for heatmap_tpu_torch, built with
// g++ by heatmap_tpu_torch/_build.py into the port's own library.
//
// The positions_latest sink writes one *aggregation-pipeline* update per
// vehicle (the race-free form of the reference's conditional upsert,
// heatmap_stream.py:198-237; see sink/mongo.py::_monotonic_update_pipeline):
//
//   { q: {_id: "prov|veh"},
//     u: [ {$replaceRoot: {newRoot:
//            {$cond: [ {$or: [ {$lte: [{$ifNull: ["$ts", null]}, null]},
//                              {$lt:  ["$ts", <ts>]} ]},
//                      {_id, provider, vehicleId, ts, loc{Point}},
//                      "$$ROOT" ]} }} ],
//     upsert: true }
//
// Each op is ~40 BSON elements; at fleet scale (one op per vehicle per
// batch) encoding them in Python dominates the sink thread.  This builds
// the ops straight from columnar arrays + joined string buffers; output
// framing matches tile_ops.cpp (concatenated op docs + per-op end offsets
// for 1000-op chunking, shipped as OP_MSG document sequences).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

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
        len += n;
    }
    void u8(uint8_t v) { raw(&v, 1); }
    void i32(int32_t v) { raw(&v, 4); }
    void i64(int64_t v) { raw(&v, 8); }
    void f64(double v) { raw(&v, 8); }
    void cstr(const char* s) { raw(s, (int64_t)std::strlen(s) + 1); }
    int64_t mark() { int64_t at = len; i32(0); return at; }
    void patch(int64_t at) {
        if (overflow) return;
        int32_t total = (int32_t)(len - at);
        std::memcpy(p + at, &total, 4);
    }
};

void el_str(Buf& b, const char* name, const char* s, int64_t n) {
    b.u8(0x02); b.cstr(name);
    b.i32((int32_t)(n + 1)); b.raw(s, n); b.u8(0);
}
void el_f64(Buf& b, const char* name, double v) { b.u8(0x01); b.cstr(name); b.f64(v); }
void el_dt(Buf& b, const char* name, int64_t ms) { b.u8(0x09); b.cstr(name); b.i64(ms); }
void el_null(Buf& b, const char* name) { b.u8(0x0a); b.cstr(name); }
void el_bool(Buf& b, const char* name, bool v) { b.u8(0x08); b.cstr(name); b.u8(v ? 1 : 0); }
int64_t doc_open(Buf& b, const char* name) { b.u8(0x03); b.cstr(name); return b.mark(); }
int64_t arr_open(Buf& b, const char* name) { b.u8(0x04); b.cstr(name); return b.mark(); }
void closing(Buf& b, int64_t at) { b.u8(0); b.patch(at); }

}  // namespace

extern "C" {

// Inputs are columnar over n changed vehicles: lat/lon degrees (f32),
// ts_ms epoch milliseconds (i64), and the provider / vehicle strings as
// joined UTF-8 buffers with (n+1) end-exclusive offsets.  Output/return
// contract matches enc_tile_ops: concatenated op docs, per-op END
// offsets, -needed on insufficient cap.
int64_t enc_position_ops(
    const float* lat, const float* lon, const int64_t* ts_ms, int64_t n,
    const uint8_t* prov_bytes, const int64_t* prov_off,
    const uint8_t* veh_bytes, const int64_t* veh_off,
    uint8_t* out, int64_t cap,
    int64_t* end_offsets, int64_t* bytes_out) {
    Buf b{out, cap};
    std::vector<char> idbuf;
    for (int64_t r = 0; r < n; r++) {
        const char* prov = (const char*)prov_bytes + prov_off[r];
        int64_t pn = prov_off[r + 1] - prov_off[r];
        const char* veh = (const char*)veh_bytes + veh_off[r];
        int64_t vn = veh_off[r + 1] - veh_off[r];
        idbuf.resize((size_t)(pn + vn + 2));
        std::memcpy(idbuf.data(), prov, pn);
        idbuf[pn] = '|';
        std::memcpy(idbuf.data() + pn + 1, veh, vn);
        int64_t idn = pn + 1 + vn;

        int64_t op = b.mark();
        {
            int64_t q = doc_open(b, "q");
            el_str(b, "_id", idbuf.data(), idn);
            closing(b, q);

            int64_t u = arr_open(b, "u");           // pipeline = array
            {
                int64_t st = doc_open(b, "0");      // one stage
                int64_t rr = doc_open(b, "$replaceRoot");
                int64_t nr = doc_open(b, "newRoot");
                int64_t cond = arr_open(b, "$cond");
                {
                    // [0] condition: {$or: [...]}
                    int64_t c0 = doc_open(b, "0");
                    int64_t orr = arr_open(b, "$or");
                    {
                        int64_t o0 = doc_open(b, "0");
                        int64_t lte = arr_open(b, "$lte");
                        {
                            int64_t ifn_doc = doc_open(b, "0");
                            int64_t ifn = arr_open(b, "$ifNull");
                            el_str(b, "0", "$ts", 3);
                            el_null(b, "1");
                            closing(b, ifn);
                            closing(b, ifn_doc);
                            el_null(b, "1");
                        }
                        closing(b, lte);
                        closing(b, o0);

                        int64_t o1 = doc_open(b, "1");
                        int64_t lt = arr_open(b, "$lt");
                        el_str(b, "0", "$ts", 3);
                        el_dt(b, "1", ts_ms[r]);
                        closing(b, lt);
                        closing(b, o1);
                    }
                    closing(b, orr);
                    closing(b, c0);

                    // [1] then-branch: the replacement document
                    int64_t d = doc_open(b, "1");
                    el_str(b, "_id", idbuf.data(), idn);
                    el_str(b, "provider", prov, pn);
                    el_str(b, "vehicleId", veh, vn);
                    el_dt(b, "ts", ts_ms[r]);
                    {
                        int64_t loc = doc_open(b, "loc");
                        el_str(b, "type", "Point", 5);
                        int64_t coords = arr_open(b, "coordinates");
                        el_f64(b, "0", (double)lon[r]);
                        el_f64(b, "1", (double)lat[r]);
                        closing(b, coords);
                        closing(b, loc);
                    }
                    closing(b, d);

                    // [2] else-branch: keep the stored document
                    el_str(b, "2", "$$ROOT", 6);
                }
                closing(b, cond);
                closing(b, nr);
                closing(b, rr);
                closing(b, st);
            }
            closing(b, u);

            el_bool(b, "upsert", true);
        }
        b.u8(0);
        b.patch(op);
        end_offsets[r] = b.len;
    }
    *bytes_out = b.len;
    if (b.overflow) return -b.len;
    return n;
}

}  // extern "C"
