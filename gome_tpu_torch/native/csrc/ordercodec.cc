// The port's copy of native/ordercodec.cc, unchanged; built by
// gome_tpu_torch/native/build.py and called from
// gome_tpu_torch/bus/ordercodec.py.
//
// Native batch parser for the doOrder wire format (bus/codec.py
// encode_order): one flat JSON object per message with a fixed key set —
//   {"Action":N,"Uuid":s,"Oid":s,"Symbol":s,"Transaction":N,
//    "Price":N,"Volume":N[,"Kind":N]}
// (key order not assumed). The consumer decodes every inbound message on
// its hot path; parsing a whole micro-batch in one native call replaces a
// per-message json.loads. String values are returned as (offset, length)
// views into the caller's buffer — zero copies here; Python slices and
// interns them.
//
// Scope: exactly the subset of JSON our own codec emits — no nested
// objects/arrays, no floats, no unicode escapes. A message that does not
// conform (e.g. a string containing a backslash escape) stops the scan and
// the Python side falls back to json.loads for the remainder, so this is a
// fast path, never a different-semantics path.

#include <cstdint>
#include <cstring>

namespace {

struct View {
  const char* p;
  const char* end;
};

inline void skip_ws(View& v) {
  while (v.p < v.end &&
         (*v.p == ' ' || *v.p == '\t' || *v.p == '\n' || *v.p == '\r'))
    ++v.p;
}

// Parses a JSON string WITHOUT escapes; returns false on any backslash or
// raw control character (both of which json.loads treats differently —
// never silently diverge from the fallback path).
inline bool parse_string(View& v, int64_t* off, int64_t* len,
                         const char* base) {
  if (v.p >= v.end || *v.p != '"') return false;
  ++v.p;
  const char* start = v.p;
  while (v.p < v.end && *v.p != '"') {
    unsigned char c = static_cast<unsigned char>(*v.p);
    if (c == '\\' || c < 0x20) return false;  // -> python fallback
    ++v.p;
  }
  if (v.p >= v.end) return false;
  *off = start - base;
  *len = v.p - start;
  ++v.p;  // closing quote
  return true;
}

inline bool parse_int(View& v, int64_t* out) {
  skip_ws(v);
  bool neg = false;
  if (v.p < v.end && *v.p == '-') {
    neg = true;
    ++v.p;
  }
  if (v.p >= v.end || *v.p < '0' || *v.p > '9') return false;
  // JSON forbids leading zeros ("007"); json.loads rejects them, so we
  // must decline rather than decode a different value.
  if (*v.p == '0' && v.p + 1 < v.end && v.p[1] >= '0' && v.p[1] <= '9')
    return false;
  constexpr int64_t kMax = INT64_MAX;
  int64_t x = 0;
  while (v.p < v.end && *v.p >= '0' && *v.p <= '9') {
    int d = *v.p - '0';
    if (x > (kMax - d) / 10) return false;  // would overflow -> fallback
    x = x * 10 + d;
    ++v.p;
  }
  *out = neg ? -x : x;
  return true;
}

}  // namespace

extern "C" {

// Returns the count of successfully parsed leading messages (== n on full
// success). Message i spans buf[offs[i], offs[i+1]). All output arrays have
// length n. kind defaults to 0 and action to 1 (ADD) when absent, matching
// decode_order's d.get defaults.
int64_t gome_parse_orders(const char* buf, const int64_t* offs, int64_t n,
                          int64_t* action, int64_t* transaction,
                          int64_t* price, int64_t* volume, int64_t* kind,
                          int64_t* u_off, int64_t* u_len, int64_t* o_off,
                          int64_t* o_len, int64_t* s_off, int64_t* s_len) {
  for (int64_t i = 0; i < n; ++i) {
    View v{buf + offs[i], buf + offs[i + 1]};
    skip_ws(v);
    if (v.p >= v.end || *v.p != '{') return i;
    ++v.p;
    action[i] = 1;  // Action.ADD default (codec.py decode_order)
    kind[i] = 0;    // OrderType.LIMIT default
    transaction[i] = price[i] = volume[i] = 0;
    u_off[i] = u_len[i] = o_off[i] = o_len[i] = s_off[i] = s_len[i] = -1;
    bool done = false;
    while (!done) {
      skip_ws(v);
      int64_t koff, klen;
      if (!parse_string(v, &koff, &klen, buf)) return i;
      skip_ws(v);
      if (v.p >= v.end || *v.p != ':') return i;
      ++v.p;
      skip_ws(v);
      const char* key = buf + koff;
      bool ok;
      if (klen == 4 && !memcmp(key, "Uuid", 4)) {
        ok = parse_string(v, &u_off[i], &u_len[i], buf);
      } else if (klen == 3 && !memcmp(key, "Oid", 3)) {
        ok = parse_string(v, &o_off[i], &o_len[i], buf);
      } else if (klen == 6 && !memcmp(key, "Symbol", 6)) {
        ok = parse_string(v, &s_off[i], &s_len[i], buf);
      } else if (klen == 6 && !memcmp(key, "Action", 6)) {
        ok = parse_int(v, &action[i]);
      } else if (klen == 11 && !memcmp(key, "Transaction", 11)) {
        ok = parse_int(v, &transaction[i]);
      } else if (klen == 5 && !memcmp(key, "Price", 5)) {
        ok = parse_int(v, &price[i]);
      } else if (klen == 6 && !memcmp(key, "Volume", 6)) {
        ok = parse_int(v, &volume[i]);
      } else if (klen == 4 && !memcmp(key, "Kind", 4)) {
        ok = parse_int(v, &kind[i]);
      } else {
        return i;  // unknown key -> python fallback
      }
      if (!ok) return i;
      skip_ws(v);
      if (v.p < v.end && *v.p == ',') {
        ++v.p;
      } else if (v.p < v.end && *v.p == '}') {
        ++v.p;
        done = true;
      } else {
        return i;
      }
    }
    if (u_off[i] < 0 || o_off[i] < 0 || s_off[i] < 0) return i;
    skip_ws(v);
    if (v.p != v.end) return i;  // trailing garbage
  }
  return n;
}

}  // extern "C"
