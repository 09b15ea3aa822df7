// Fast JSON-lines GPS-event decoder: bytes in, columnar arrays out.
//
// A copy of heatmap_tpu/native/decoder.cpp for heatmap_tpu_torch, built with
// g++ by heatmap_tpu_torch/_build.py into the port's own library.
//
// The reference pays a per-row Python round trip for every event (JSON parse
// in Spark + Python UDF, SURVEY.md §3.3 bottleneck #1); sustaining millions
// of events/sec needs ingest decode at memory speed (SURVEY.md §7 hard part
// #3).  This is a schema-specialized scanner for the canonical 8-field event
// (reference: heatmap_stream.py:52-61) — not a general JSON parser: it walks
// top-level key/value pairs per line, extracts lat/lon/speedKmh/ts/provider/
// vehicleId, interns the two strings into stable int ids, validates with the
// same rules as the Python path (stream/events.py), and writes straight into
// caller-provided numpy buffers.
//
// C ABI (used via ctypes from native/__init__.py):
//   dec_new / dec_free                  — decoder with persistent interns
//   dec_decode(buf, len, cap, out...)   — returns events decoded; *dropped
//   dec_intern_count / dec_intern_get / dec_intern_len — read the string
//     tables (get+len: names may contain NUL bytes after unescaping)
//
// Build: g++ -O3 -shared -fPIC decoder.cpp -o _native.so   (no deps)

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <locale.h>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Intern {
    std::unordered_map<std::string, int32_t> map;
    std::vector<std::string> names;
    int32_t get(const char* s, size_t n) {
        std::string key(s, n);
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        int32_t id = (int32_t)names.size();
        names.push_back(key);
        map.emplace(std::move(key), id);
        return id;
    }
};

struct Decoder {
    Intern providers;
    Intern vehicles;
    std::string scratch;  // reused unescape buffer
};

// ---- scanning helpers -----------------------------------------------------

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

// Parse a JSON string starting at the opening quote; returns pointer past
// the closing quote, sets [s, n) to the raw contents (escapes left as-is;
// callers that need the decoded text run unescape() on the slice).
inline const char* parse_string(const char* p, const char* end,
                                const char** s, size_t* n) {
    ++p;  // opening quote
    *s = p;
    while (p < end && *p != '"') {
        if (*p == '\\' && p + 1 < end) ++p;
        ++p;
    }
    *n = (size_t)(p - *s);
    return p < end ? p + 1 : p;
}

inline void append_utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) out += (char)cp;
    else if (cp < 0x800) {
        out += (char)(0xC0 | (cp >> 6));
        out += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        out += (char)(0xE0 | (cp >> 12));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    } else {
        out += (char)(0xF0 | (cp >> 18));
        out += (char)(0x80 | ((cp >> 12) & 0x3F));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    }
}

inline int hex4(const char* s) {
    int v = 0;
    for (int i = 0; i < 4; ++i) {
        char c = s[i];
        int d = (c >= '0' && c <= '9')   ? c - '0'
                : (c >= 'a' && c <= 'f') ? c - 'a' + 10
                : (c >= 'A' && c <= 'F') ? c - 'A' + 10
                                         : -1;
        if (d < 0) return -1;
        v = (v << 4) | d;
    }
    return v;
}

// Decode JSON escapes in [s, s+n) into `out` (UTF-8, surrogate pairs merged)
// so interned names match what Python's json module produces.
void unescape(const char* s, size_t n, std::string& out) {
    out.clear();
    out.reserve(n);
    size_t i = 0;
    while (i < n) {
        char c = s[i];
        if (c != '\\') { out += c; ++i; continue; }
        if (i + 1 >= n) { out += c; break; }
        char e = s[i + 1];
        i += 2;
        switch (e) {
            case '"': out += '"'; break;
            case '\\': out += '\\'; break;
            case '/': out += '/'; break;
            case 'b': out += '\b'; break;
            case 'f': out += '\f'; break;
            case 'n': out += '\n'; break;
            case 'r': out += '\r'; break;
            case 't': out += '\t'; break;
            case 'u': {
                if (i + 4 > n) { out += "\\u"; break; }
                int hi = hex4(s + i);
                if (hi < 0) { out += "\\u"; break; }
                i += 4;
                uint32_t cp = (uint32_t)hi;
                if (hi >= 0xD800 && hi <= 0xDBFF && i + 6 <= n &&
                    s[i] == '\\' && s[i + 1] == 'u') {
                    int lo = hex4(s + i + 2);
                    if (lo >= 0xDC00 && lo <= 0xDFFF) {
                        cp = 0x10000 + (((uint32_t)hi - 0xD800) << 10) +
                             ((uint32_t)lo - 0xDC00);
                        i += 6;
                    }
                }
                append_utf8(out, cp);
                break;
            }
            default: out += '\\'; out += e; break;
        }
    }
}

// Skip any JSON value (object/array/string/number/bool/null).
const char* skip_value(const char* p, const char* end) {
    p = skip_ws(p, end);
    if (p >= end) return p;
    if (*p == '"') {
        const char* s; size_t n;
        return parse_string(p, end, &s, &n);
    }
    if (*p == '{' || *p == '[') {
        char open = *p, close = (*p == '{') ? '}' : ']';
        int depth = 0;
        while (p < end) {
            if (*p == '"') {
                const char* s; size_t n;
                p = parse_string(p, end, &s, &n);
                continue;
            }
            if (*p == open) ++depth;
            else if (*p == close && --depth == 0) return p + 1;
            ++p;
        }
        return p;
    }
    while (p < end && *p != ',' && *p != '}' && *p != ']' &&
           *p != '\n') ++p;
    return p;
}

// ISO-8601 "YYYY-MM-DD[T ]HH:MM:SS[.frac][Z|+hh:mm|-hh:mm]" -> epoch secs.
// Days-from-civil (Howard Hinnant's algorithm), no locale, no libc tz.
bool parse_iso8601(const char* s, size_t n, double* out) {
    if (n < 19) return false;
    auto digit = [&](size_t i) { return s[i] >= '0' && s[i] <= '9'; };
    for (size_t i : {0u, 1u, 2u, 3u, 5u, 6u, 8u, 9u, 11u, 12u, 14u, 15u, 17u, 18u})
        if (!digit(i)) return false;
    if (s[4] != '-' || s[7] != '-' || (s[10] != 'T' && s[10] != ' ') ||
        s[13] != ':' || s[16] != ':')
        return false;
    int y = (s[0]-'0')*1000 + (s[1]-'0')*100 + (s[2]-'0')*10 + (s[3]-'0');
    unsigned m = (s[5]-'0')*10 + (s[6]-'0');
    unsigned d = (s[8]-'0')*10 + (s[9]-'0');
    int hh = (s[11]-'0')*10 + (s[12]-'0');
    int mi = (s[14]-'0')*10 + (s[15]-'0');
    int ss = (s[17]-'0')*10 + (s[18]-'0');
    if (m < 1 || m > 12 || d < 1 || d > 31 || hh > 23 || mi > 59 || ss > 60)
        return false;
    size_t i = 19;
    double frac = 0.0;
    if (i < n && s[i] == '.') {
        ++i;
        double scale = 0.1;
        while (i < n && digit(i)) { frac += (s[i]-'0') * scale; scale *= 0.1; ++i; }
    }
    long off = 0;  // seconds east of UTC
    if (i < n) {
        if (s[i] == 'Z') { ++i; }
        else if (s[i] == '+' || s[i] == '-') {
            int sign = (s[i] == '+') ? 1 : -1;
            if (i + 5 < n + 1 && n - i >= 6 && digit(i+1) && digit(i+2) &&
                s[i+3] == ':' && digit(i+4) && digit(i+5)) {
                off = sign * (((s[i+1]-'0')*10 + (s[i+2]-'0')) * 3600 +
                              ((s[i+4]-'0')*10 + (s[i+5]-'0')) * 60);
                i += 6;
            } else return false;
        } else return false;
    }
    // days from civil
    int yy = y - (m <= 2);
    int era = (yy >= 0 ? yy : yy - 399) / 400;
    unsigned yoe = (unsigned)(yy - era * 400);
    unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    long days = (long)era * 146097 + (long)doe - 719468;
    *out = (double)days * 86400.0 + hh * 3600 + mi * 60 + ss + frac - off;
    return true;
}

// Full-string number parse with Python float() semantics: surrounding
// whitespace allowed, optional sign, decimal digits with '_' group
// separators (between digits only), optional fraction/exponent, and the
// inf/infinity/nan words.  The grammar is validated BEFORE strtod so C99
// extensions float() rejects (hex floats) never slip through, and the
// sanitized buffer is parsed under the C locale (strtod_l) so a host
// LC_NUMERIC cannot change which events are accepted.
bool parse_number_string(const char* s, size_t n, double* out) {
    static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    size_t i = 0, j = n;
    auto is_ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\r' || c == '\n' ||
               c == '\f' || c == '\v';
    };
    while (i < j && is_ws(s[i])) ++i;
    while (j > i && is_ws(s[j - 1])) --j;
    if (i >= j) return false;
    std::string buf;
    buf.reserve(j - i);
    size_t k = i;
    if (s[k] == '+' || s[k] == '-') buf += s[k++];
    // word forms float() accepts (any case): inf, infinity, nan
    {
        std::string w;
        for (size_t t = k; t < j; ++t)
            w += (char)tolower((unsigned char)s[t]);
        if (w == "inf" || w == "infinity") { buf += "inf"; }
        else if (w == "nan") { buf += "nan"; }
        else w.clear();
        if (!buf.empty() && (buf.back() == 'f' || buf.back() == 'n')) {
            char* end = nullptr;
            *out = strtod_l(buf.c_str(), &end, c_loc);
            return end && *end == '\0';
        }
    }
    // digits[_digits]* [. digits[_digits]*] [eE[+-]digits[_digits]*]
    auto copy_digits = [&](size_t& t) -> bool {
        bool any = false, prev_digit = false;
        while (t < j) {
            char c = s[t];
            if (c >= '0' && c <= '9') {
                buf += c; any = prev_digit = true; ++t;
            } else if (c == '_') {
                // Python: '_' only BETWEEN digits
                if (!prev_digit || t + 1 >= j || s[t + 1] < '0' ||
                    s[t + 1] > '9')
                    return false;
                prev_digit = false; ++t;
            } else break;
        }
        return any;
    };
    bool int_part = copy_digits(k);
    bool frac_part = false;
    if (k < j && s[k] == '.') {
        buf += '.'; ++k;
        frac_part = copy_digits(k);
    }
    if (!int_part && !frac_part) return false;
    if (k < j && (s[k] == 'e' || s[k] == 'E')) {
        buf += 'e'; ++k;
        if (k < j && (s[k] == '+' || s[k] == '-')) buf += s[k++];
        if (!copy_digits(k)) return false;
    }
    if (k != j) return false;
    char* end = nullptr;
    double v = strtod_l(buf.c_str(), &end, c_loc);
    if (!end || *end != '\0') return false;
    *out = v;
    return true;
}

struct Fields {
    double lat = NAN, lon = NAN, speed = NAN, ts = NAN;
    const char* provider = nullptr; size_t provider_n = 0;
    const char* vehicle = nullptr;  size_t vehicle_n = 0;
    bool provider_null = true, vehicle_null = true;
};

inline bool key_is(const char* k, size_t n, const char* lit) {
    return strlen(lit) == n && memcmp(k, lit, n) == 0;
}

}  // namespace

extern "C" {

void* dec_new() { return new Decoder(); }
void dec_free(void* d) { delete (Decoder*)d; }

int64_t dec_intern_count(void* dv, int which) {
    Decoder* d = (Decoder*)dv;
    return (int64_t)(which == 0 ? d->providers.names.size()
                                : d->vehicles.names.size());
}

const char* dec_intern_get(void* dv, int which, int64_t i) {
    Decoder* d = (Decoder*)dv;
    auto& v = which == 0 ? d->providers.names : d->vehicles.names;
    if (i < 0 || (size_t)i >= v.size()) return "";
    return v[(size_t)i].data();
}

// Byte length of intern i (names may contain NUL from \u0000 escapes, so
// readers must use this rather than strlen).
int64_t dec_intern_len(void* dv, int which, int64_t i) {
    Decoder* d = (Decoder*)dv;
    auto& v = which == 0 ? d->providers.names : d->vehicles.names;
    if (i < 0 || (size_t)i >= v.size()) return 0;
    return (int64_t)v[(size_t)i].size();
}

// Decode up to `cap` events from newline-separated JSON in [buf, buf+len).
// Writes columnar outputs; returns count decoded; *n_dropped counts invalid
// lines; *consumed is the byte offset of the first unprocessed line (always
// at a line boundary), so callers can stream arbitrarily chunked buffers.
int64_t dec_decode(void* dv, const char* buf, int64_t len, int64_t cap,
                   float* lat, float* lon, float* speed, int32_t* ts,
                   int32_t* provider_id, int32_t* vehicle_id,
                   int64_t* n_dropped, int64_t* consumed) {
    Decoder* d = (Decoder*)dv;
    const char* p = buf;
    const char* end = buf + len;
    int64_t out = 0, dropped = 0;
    *consumed = 0;

    while (p < end && out < cap) {
        const char* line = p;
        const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!nl) break;  // partial trailing line: leave unconsumed for streaming
        const char* lend = nl;
        p = nl + 1;

        const char* q = skip_ws(line, lend);
        if (q >= lend) { *consumed = (int64_t)(p - buf); continue; }
        if (*q != '{') { ++dropped; *consumed = (int64_t)(p - buf); continue; }
        ++q;

        Fields f;
        bool ok = true;
        while (ok && q < lend) {
            q = skip_ws(q, lend);
            if (q < lend && *q == '}') break;
            if (q >= lend || *q != '"') { ok = false; break; }
            const char* k; size_t kn;
            q = parse_string(q, lend, &k, &kn);
            q = skip_ws(q, lend);
            if (q >= lend || *q != ':') { ok = false; break; }
            q = skip_ws(q + 1, lend);
            if (q >= lend) { ok = false; break; }

            if (*q == '"') {
                const char* s; size_t sn;
                q = parse_string(q, lend, &s, &sn);
                if (key_is(k, kn, "provider")) {
                    f.provider = s; f.provider_n = sn; f.provider_null = false;
                } else if (key_is(k, kn, "vehicleId")) {
                    f.vehicle = s; f.vehicle_n = sn; f.vehicle_null = false;
                } else if (key_is(k, kn, "ts")) {
                    double t;
                    if (parse_iso8601(s, sn, &t)) f.ts = t;
                } else if (key_is(k, kn, "lat") || key_is(k, kn, "lon") ||
                           key_is(k, kn, "speedKmh")) {
                    // string-encoded numerics: the Python path coerces via
                    // float() (stream/events.py), so "42.36" must parse the
                    // same here or acceptance becomes toolchain-dependent
                    double v;
                    if (parse_number_string(s, sn, &v)) {
                        if (k[0] == 'l' && k[1] == 'a') f.lat = v;
                        else if (k[0] == 'l') f.lon = v;
                        else f.speed = v;
                    }
                }
            } else if ((*q >= '0' && *q <= '9') || *q == '-' || *q == '+') {
                char* numend = nullptr;
                double v = strtod(q, &numend);
                if (numend == q || numend > lend) { q = skip_value(q, lend); }
                else {
                    if (key_is(k, kn, "lat")) f.lat = v;
                    else if (key_is(k, kn, "lon")) f.lon = v;
                    else if (key_is(k, kn, "speedKmh")) f.speed = v;
                    else if (key_is(k, kn, "ts")) f.ts = v;
                    else if (key_is(k, kn, "vehicleId")) {
                        // numeric identity: the Python path str()-coerces
                        // (stream/events.py:106) and the reference's Spark
                        // StringType schema casts — capture the literal
                        // token so an unwrapped numeric MBTA label
                        // (producers/mbta.py, ref :68) is accepted here
                        // too, not dropped as null.  Identities are opaque
                        // keys: the token spelling ("17.50") is kept as-is
                        // rather than re-canonicalized like Python's
                        // str(17.5).
                        f.vehicle = q; f.vehicle_n = (size_t)(numend - q);
                        f.vehicle_null = false;
                    } else if (key_is(k, kn, "provider")) {
                        f.provider = q; f.provider_n = (size_t)(numend - q);
                        f.provider_null = false;
                    }
                    q = numend;
                }
            } else {
                q = skip_value(q, lend);  // null / bool / nested
            }
            q = skip_ws(q, lend);
            if (q < lend && *q == ',') ++q;
        }

        // validation — mirror stream/events.py (reference filters,
        // heatmap_stream.py:96-104)
        if (!ok || f.provider_null || f.vehicle_null ||
            !std::isfinite(f.lat) || !std::isfinite(f.lon) ||
            f.lat < -90.0 || f.lat > 90.0 ||
            f.lon < -180.0 || f.lon > 180.0 ||
            !std::isfinite(f.ts) || f.ts < 0.0 || f.ts >= 2147483648.0) {
            ++dropped;
            *consumed = (int64_t)(p - buf);
            continue;
        }
        double sp = f.speed;
        if (!std::isfinite(sp)) sp = 0.0;

        lat[out] = (float)f.lat;
        lon[out] = (float)f.lon;
        speed[out] = (float)sp;
        ts[out] = (int32_t)f.ts;
        // fast path: no escapes → intern the raw slice directly
        if (memchr(f.provider, '\\', f.provider_n)) {
            unescape(f.provider, f.provider_n, d->scratch);
            provider_id[out] = d->providers.get(d->scratch.data(), d->scratch.size());
        } else {
            provider_id[out] = d->providers.get(f.provider, f.provider_n);
        }
        if (memchr(f.vehicle, '\\', f.vehicle_n)) {
            unescape(f.vehicle, f.vehicle_n, d->scratch);
            vehicle_id[out] = d->vehicles.get(d->scratch.data(), d->scratch.size());
        } else {
            vehicle_id[out] = d->vehicles.get(f.vehicle, f.vehicle_n);
        }
        ++out;
        *consumed = (int64_t)(p - buf);
    }
    *n_dropped = dropped;
    return out;
}

}  // extern "C"

namespace {

// Strict UTF-8 validity (rejects overlongs, surrogates, >U+10FFFF) — the
// binary path must drop exactly what Python's bytes.decode("utf-8") rejects
// (stream/binfmt.py decode_event), so acceptance is toolchain-independent.
bool utf8_valid(const unsigned char* s, size_t n) {
    size_t i = 0;
    while (i < n) {
        unsigned char c = s[i];
        if (c < 0x80) { ++i; continue; }
        int extra;
        uint32_t cp;
        if ((c & 0xE0) == 0xC0) { extra = 1; cp = c & 0x1F; }
        else if ((c & 0xF0) == 0xE0) { extra = 2; cp = c & 0x0F; }
        else if ((c & 0xF8) == 0xF0) { extra = 3; cp = c & 0x07; }
        else return false;
        if (i + extra >= n) return false;
        for (int k = 1; k <= extra; ++k) {
            unsigned char cc = s[i + k];
            if ((cc & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (cc & 0x3F);
        }
        if (extra == 1 && cp < 0x80) return false;          // overlong
        if (extra == 2 && cp < 0x800) return false;
        if (extra == 3 && cp < 0x10000) return false;
        if (cp >= 0xD800 && cp <= 0xDFFF) return false;     // surrogate
        if (cp > 0x10FFFF) return false;
        i += 1 + extra;
    }
    return true;
}

}  // namespace

extern "C" {

// Decode up to `cap` events from a u32-length-prefixed stream of binary
// event records (layout: stream/binfmt.py — magic 0xB1, version 1).  Same
// output contract as dec_decode; a partial trailing record is left
// unconsumed for streaming.  Invalid envelopes/fields are dropped with
// the same rules as the JSON/Python paths.
int64_t dec_decode_binary(void* dv, const char* buf, int64_t len,
                          int64_t cap,
                          float* lat, float* lon, float* speed, int32_t* ts,
                          int32_t* provider_id, int32_t* vehicle_id,
                          int64_t* n_dropped, int64_t* consumed) {
    Decoder* d = (Decoder*)dv;
    int64_t out = 0, dropped = 0;
    int64_t i = 0;
    *consumed = 0;
    while (i + 4 <= len && out < cap) {
        uint32_t n;
        memcpy(&n, buf + i, 4);
        if (i + 4 + (int64_t)n > len) break;  // partial trailing record
        const unsigned char* r = (const unsigned char*)buf + i + 4;
        i += 4 + n;
        *consumed = i;
        if (n < 32 || r[0] != 0xB1 || r[1] != 1) { ++dropped; continue; }
        uint32_t pn = r[2], vn = r[3];
        if (32 + pn + vn != n) { ++dropped; continue; }
        float f[5];
        memcpy(f, r + 4, 20);
        int64_t tsv;
        memcpy(&tsv, r + 24, 8);
        double la = f[0], lo = f[1];
        if (!std::isfinite(la) || !std::isfinite(lo) ||
            la < -90.0 || la > 90.0 || lo < -180.0 || lo > 180.0 ||
            tsv < 0 || tsv >= 2147483648LL) {
            ++dropped;
            continue;
        }
        if (!utf8_valid(r + 32, pn) || !utf8_valid(r + 32 + pn, vn)) {
            ++dropped;
            continue;
        }
        float sp = f[2];
        if (!std::isfinite(sp)) sp = 0.0f;
        lat[out] = (float)la;
        lon[out] = (float)lo;
        speed[out] = sp;
        ts[out] = (int32_t)tsv;
        provider_id[out] = d->providers.get((const char*)r + 32, pn);
        vehicle_id[out] = d->vehicles.get((const char*)r + 32 + pn, vn);
        ++out;
    }
    *n_dropped = dropped;
    return out;
}

}  // extern "C"

// ---- columnar strtab offsets (stream/colfmt.py hot path) -------------
//
// Parses the [u16 len][bytes]*n string-table blob into per-entry
// (offset, length) arrays in one pass — the Python loop doing this
// (struct.unpack_from per entry) was the top term of an ingest
// profile.  Returns 0 on success, -1 when an entry runs past the blob.

extern "C" {

int cf_strtab_offsets(const uint8_t* blob, int64_t blob_len, int32_t n,
                      int32_t* offs, int32_t* lens) {
  int64_t off = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (off + 2 > blob_len) return -1;
    uint16_t ln = (uint16_t)(blob[off] | ((uint16_t)blob[off + 1] << 8));
    off += 2;
    if (off + ln > blob_len) return -1;
    offs[i] = (int32_t)off;
    lens[i] = (int32_t)ln;
    off += ln;
  }
  return 0;
}

}  // extern "C"
