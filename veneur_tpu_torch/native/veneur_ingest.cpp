// Native ingest hot path: SO_REUSEPORT UDP reader pool + DogStatsD parser
// + framed-SSF scanner.
//
// The reference reaches native ingest performance with Go + raw syscalls
// (/root/reference/socket_linux.go:12-76 SO_REUSEPORT/SO_RCVBUF,
// server.go:795-825 read loop, samplers/parser.go:232-363 parser,
// samplers/split_bytes.go splitter). This file is the C++ equivalent for
// the TPU build: N reader threads each own a SO_REUSEPORT socket, drain
// it with recvmmsg, split datagrams on '\n', and parse each DogStatsD
// line into a packed struct-of-arrays batch that Python drains wholesale
// — one FFI call per batch instead of one parse per line.
//
// Parsed-record grammar and validation mirror parser.go:232-363 exactly:
//   name:value|type[|@rate][|#tag1,tag2]   (sections in any order, once)
// with byte-wise tag sorting (Go sort.Strings), first-match
// veneurlocalonly/veneurglobalonly scope-tag extraction
// (parser.go:326-342), the fnv1a-32 digest over name+type+joined-tags
// (parser.go:259-354), NaN/Inf rejection, and (0,1] sample rates.
// Events (_e{) and service checks (_sc) are surfaced as RAW records for
// the Python parser — they are rare control-plane packets.
//
// The framed-SSF scanner mirrors protocol/wire.go:42-108: frames are
// 1 version byte (0x00) + 4-byte big-endian length + protobuf, 16 MiB
// cap; a bad version/length is a poison framing error.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kFnvInit = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;

inline uint32_t fnv1a(const char* data, size_t len, uint32_t h) {
  for (size_t i = 0; i < len; i++) {
    h = (h ^ static_cast<unsigned char>(data[i])) * kFnvPrime;
  }
  return h;
}

// Record types (order matches veneur_tpu/native/__init__.py)
enum RecordType : uint8_t {
  kCounter = 0,
  kGauge = 1,
  kHistogram = 2,
  kTimer = 3,
  kSet = 4,
  kRaw = 5,  // _e{ / _sc lines, passed through for the Python parser
};

const char* kTypeNames[5] = {"counter", "gauge", "histogram", "timer", "set"};
const size_t kTypeNameLens[5] = {7, 5, 9, 5, 3};

// Scopes (parser.go:34-40); kTopK marks a set carrying the veneurtopk
// magic tag (heavy-hitter sampler, this framework's extension)
enum Scope : uint8_t { kMixed = 0, kLocalOnly = 1, kGlobalOnly = 2,
                       kTopK = 3 };

}  // namespace

// One batch of parsed records, struct-of-arrays. All offsets index into
// `arena`. Python mirrors this layout with ctypes.
extern "C" struct VtBatch {
  uint32_t capacity;     // max records
  uint32_t arena_cap;    // arena bytes
  uint32_t count;        // records filled
  uint32_t arena_len;    // arena bytes used
  uint64_t parse_errors; // lines rejected since batch reset
  uint8_t* type;
  uint8_t* scope;
  double* value;
  float* sample_rate;
  uint32_t* digest;
  uint32_t* name_off;
  uint32_t* name_len;
  uint32_t* tags_off;    // comma-joined sorted tags
  uint32_t* tags_len;
  uint32_t* aux_off;     // set member / raw line bytes
  uint32_t* aux_len;
  char* arena;
};

extern "C" VtBatch* vt_batch_new(uint32_t capacity, uint32_t arena_cap) {
  VtBatch* b = static_cast<VtBatch*>(calloc(1, sizeof(VtBatch)));
  b->capacity = capacity;
  b->arena_cap = arena_cap;
  b->type = static_cast<uint8_t*>(malloc(capacity));
  b->scope = static_cast<uint8_t*>(malloc(capacity));
  b->value = static_cast<double*>(malloc(capacity * sizeof(double)));
  b->sample_rate = static_cast<float*>(malloc(capacity * sizeof(float)));
  b->digest = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->name_off = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->name_len = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->tags_off = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->tags_len = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->aux_off = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->aux_len = static_cast<uint32_t*>(malloc(capacity * sizeof(uint32_t)));
  b->arena = static_cast<char*>(malloc(arena_cap));
  return b;
}

extern "C" void vt_batch_free(VtBatch* b) {
  if (!b) return;
  free(b->type); free(b->scope); free(b->value); free(b->sample_rate);
  free(b->digest); free(b->name_off); free(b->name_len);
  free(b->tags_off); free(b->tags_len); free(b->aux_off); free(b->aux_len);
  free(b->arena);
  free(b);
}

extern "C" void vt_batch_reset(VtBatch* b) {
  b->count = 0;
  b->arena_len = 0;
  b->parse_errors = 0;
}

namespace {

// Append bytes to the batch arena; returns offset or UINT32_MAX when full.
inline uint32_t arena_put(VtBatch* b, const char* data, size_t len) {
  if (b->arena_len + len > b->arena_cap) return UINT32_MAX;
  memcpy(b->arena + b->arena_len, data, len);
  uint32_t off = b->arena_len;
  b->arena_len += static_cast<uint32_t>(len);
  return off;
}

struct TagView {
  const char* p;
  size_t len;
  bool operator<(const TagView& o) const {
    int c = memcmp(p, o.p, std::min(len, o.len));
    if (c != 0) return c < 0;
    return len < o.len;
  }
};

inline bool has_prefix(const TagView& t, const char* pre, size_t n) {
  return t.len >= n && memcmp(t.p, pre, n) == 0;
}

// Parse one line into the batch. Returns false on a parse error (counted
// by the caller). Mirrors parse_metric (parser.go:232-363).
bool parse_line(const char* line, size_t len, VtBatch* b) {
  if (b->count >= b->capacity) return false;
  uint32_t idx = b->count;

  // events / service checks pass through as raw records
  if ((len >= 3 && memcmp(line, "_e{", 3) == 0) ||
      (len >= 3 && memcmp(line, "_sc", 3) == 0)) {
    uint32_t off = arena_put(b, line, len);
    if (off == UINT32_MAX) return false;
    b->type[idx] = kRaw;
    b->scope[idx] = kMixed;
    b->value[idx] = 0.0;
    b->sample_rate[idx] = 1.0f;
    b->digest[idx] = 0;
    b->name_off[idx] = b->name_len[idx] = 0;
    b->tags_off[idx] = b->tags_len[idx] = 0;
    b->aux_off[idx] = off;
    b->aux_len[idx] = static_cast<uint32_t>(len);
    b->count++;
    return true;
  }

  // a trailing pipe is an empty final section (parser.go rejects it)
  if (line[len - 1] == '|') return false;

  // head section: name:value
  const char* pipe = static_cast<const char*>(memchr(line, '|', len));
  if (!pipe) return false;
  size_t head_len = pipe - line;
  const char* colon =
      static_cast<const char*>(memchr(line, ':', head_len));
  if (!colon) return false;
  size_t name_len = colon - line;
  if (name_len == 0) return false;
  const char* value_p = colon + 1;
  size_t value_len = head_len - name_len - 1;

  // type section
  const char* rest = pipe + 1;
  size_t rest_len = len - head_len - 1;
  const char* type_end =
      static_cast<const char*>(memchr(rest, '|', rest_len));
  size_t type_len = type_end ? static_cast<size_t>(type_end - rest)
                             : rest_len;
  if (type_len == 0) return false;
  uint8_t rtype;
  switch (rest[0]) {  // only the first byte is inspected (parser.go:281)
    case 'c': rtype = kCounter; break;
    case 'g': rtype = kGauge; break;
    case 'h': rtype = kHistogram; break;
    case 'm': rtype = kTimer; break;
    case 's': rtype = kSet; break;
    default: return false;
  }

  double value = 0.0;
  if (rtype != kSet) {
    char tmp[64];
    if (value_len == 0 || value_len >= sizeof(tmp)) return false;
    memcpy(tmp, value_p, value_len);
    tmp[value_len] = 0;
    char* endp = nullptr;
    value = strtod(tmp, &endp);
    if (endp != tmp + value_len) return false;
    if (std::isnan(value) || std::isinf(value)) return false;
  }

  // optional sections: @rate and #tags, any order, at most once
  float sample_rate = 1.0f;
  bool found_rate = false;
  // tags grow without bound, matching the pure-Python parser (the Go
  // reference imposes no tag-count limit either)
  std::vector<TagView> tags;
  bool found_tags = false;
  uint8_t scope = kMixed;

  const char* p = type_end ? type_end + 1 : rest + rest_len;
  const char* end = line + len;
  while (p < end) {
    const char* next = static_cast<const char*>(memchr(p, '|', end - p));
    size_t sec_len = next ? static_cast<size_t>(next - p)
                          : static_cast<size_t>(end - p);
    if (sec_len == 0) return false;  // empty string between pipes
    if (p[0] == '@') {
      if (found_rate) return false;
      char tmp[32];
      if (sec_len - 1 == 0 || sec_len - 1 >= sizeof(tmp)) return false;
      memcpy(tmp, p + 1, sec_len - 1);
      tmp[sec_len - 1] = 0;
      char* endp = nullptr;
      double r = strtod(tmp, &endp);
      if (endp != tmp + sec_len - 1) return false;
      if (!(r > 0.0 && r <= 1.0)) return false;
      sample_rate = static_cast<float>(r);
      found_rate = true;
    } else if (p[0] == '#') {
      if (found_tags) return false;
      found_tags = true;
      const char* tp = p + 1;
      const char* tend = p + sec_len;
      while (tp <= tend) {
        const char* comma =
            static_cast<const char*>(memchr(tp, ',', tend - tp));
        size_t tlen = comma ? static_cast<size_t>(comma - tp)
                            : static_cast<size_t>(tend - tp);
        tags.push_back(TagView{tp, tlen});
        if (!comma) break;
        tp = comma + 1;
      }
      std::sort(tags.begin(), tags.end());
      // first-match scope-tag extraction (parser.go:326-342)
      for (size_t i = 0; i < tags.size(); i++) {
        bool local = has_prefix(tags[i], "veneurlocalonly", 15);
        bool global = has_prefix(tags[i], "veneurglobalonly", 16);
        if (local || global) {
          scope = local ? kLocalOnly : kGlobalOnly;
          tags.erase(tags.begin() + i);
          break;
        }
      }
      // heavy-hitter routing tag: stays in the tag list (and digest),
      // and only flips the scope byte for SETS — other types keep their
      // local/global scope even if the tag is present
      if (rtype == kSet) {
        for (size_t i = 0; i < tags.size(); i++) {
          if (tags[i].len == 10 &&
              memcmp(tags[i].p, "veneurtopk", 10) == 0) {
            scope = kTopK;
            break;
          }
        }
      }
    } else {
      return false;  // unknown section
    }
    p = next ? next + 1 : end;
    if (!next) break;
  }

  // write the record
  uint32_t noff = arena_put(b, line, name_len);
  if (noff == UINT32_MAX) return false;

  uint32_t h = fnv1a(line, name_len, kFnvInit);
  h = fnv1a(kTypeNames[rtype], kTypeNameLens[rtype], h);

  uint32_t toff = b->arena_len;
  uint32_t tlen = 0;
  if (found_tags) {
    for (size_t i = 0; i < tags.size(); i++) {
      if (i > 0) {
        if (arena_put(b, ",", 1) == UINT32_MAX) return false;
        tlen += 1;
      }
      if (arena_put(b, tags[i].p, tags[i].len) == UINT32_MAX) return false;
      tlen += static_cast<uint32_t>(tags[i].len);
    }
    h = fnv1a(b->arena + toff, tlen, h);
  }

  uint32_t aoff = 0, alen = 0;
  if (rtype == kSet) {
    aoff = arena_put(b, value_p, value_len);
    if (aoff == UINT32_MAX) return false;
    alen = static_cast<uint32_t>(value_len);
    // 64-bit member hash (FNV-1a core + murmur3 fmix64), bit-identical to
    // ops/hll.py hash_member; carried through the value slot's bit pattern
    uint64_t mh = 14695981039346656037ULL;
    for (size_t vi = 0; vi < value_len; vi++) {
      mh = (mh ^ static_cast<uint8_t>(value_p[vi])) * 1099511628211ULL;
    }
    mh ^= mh >> 33;
    mh *= 0xFF51AFD7ED558CCDULL;
    mh ^= mh >> 33;
    mh *= 0xC4CEB9FE1A85EC53ULL;
    mh ^= mh >> 33;
    memcpy(&value, &mh, sizeof(value));
  }

  b->type[idx] = rtype;
  b->scope[idx] = scope;
  b->value[idx] = value;
  b->sample_rate[idx] = sample_rate;
  b->digest[idx] = h;
  b->name_off[idx] = noff;
  b->name_len[idx] = static_cast<uint32_t>(name_len);
  b->tags_off[idx] = toff;
  b->tags_len[idx] = tlen;
  b->aux_off[idx] = aoff;
  b->aux_len[idx] = alen;
  b->count++;
  return true;
}

}  // namespace

// Split a buffer on '\n' and parse every non-empty line
// (split_bytes.go:17-56). Returns records appended.
extern "C" uint32_t vt_parse_lines(const char* buf, size_t len, VtBatch* b) {
  uint32_t before = b->count;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t line_len = nl ? static_cast<size_t>(nl - p)
                         : static_cast<size_t>(end - p);
    if (line_len > 0) {
      if (!parse_line(p, line_len, b)) b->parse_errors++;
    }
    p = nl ? nl + 1 : end;
  }
  return b->count - before;
}

// ---------------------------------------------------------------------------
// Framed-SSF scanner (protocol/wire.go:42-108)

// Scans `buf` for complete frames. Writes (offset,length) pairs of the
// protobuf payloads into out_off/out_len (up to out_cap). Returns the
// number of complete frames; *consumed is the byte count of whole frames
// scanned past; *poisoned is set on a framing error (bad version or
// oversized length) — the stream must be closed (wire.go:26-28).
extern "C" uint32_t vt_frame_scan(const char* buf, size_t len,
                                  uint32_t* out_off, uint32_t* out_len,
                                  uint32_t out_cap, size_t* consumed,
                                  int* poisoned) {
  constexpr size_t kMaxFrame = 16 * 1024 * 1024;
  uint32_t n = 0;
  size_t pos = 0;
  *poisoned = 0;
  while (n < out_cap && pos + 5 <= len) {
    if (buf[pos] != 0) {  // version byte (wire.go:31-40)
      *poisoned = 1;
      break;
    }
    uint32_t flen = (static_cast<uint32_t>(
                         static_cast<unsigned char>(buf[pos + 1])) << 24) |
                    (static_cast<uint32_t>(
                         static_cast<unsigned char>(buf[pos + 2])) << 16) |
                    (static_cast<uint32_t>(
                         static_cast<unsigned char>(buf[pos + 3])) << 8) |
                    static_cast<uint32_t>(
                        static_cast<unsigned char>(buf[pos + 4]));
    if (flen > kMaxFrame) {
      *poisoned = 1;
      break;
    }
    if (pos + 5 + flen > len) break;  // incomplete frame: wait for more
    out_off[n] = static_cast<uint32_t>(pos + 5);
    out_len[n] = flen;
    n++;
    pos += 5 + flen;
  }
  *consumed = pos;
  return n;
}

// ---------------------------------------------------------------------------
// Series interning table: (scope-class kind, name, tags) -> dense row id.
// The host-side hot hash path (string-keyed series -> row indices) that
// the reference pays inside map[MetricKey]*sampler lookups per sample
// (worker.go:96-157). The table only MEMOIZES rows assigned by the Python
// Interner: vt_intern_assign leaves unknown keys as misses (row =
// UINT32_MAX) for Python to resolve and teach back via vt_intern_put, so
// both sides always agree on row numbering.

namespace {

// scope-class kinds, mirroring veneur_tpu/core/store.py _K_* constants
inline uint8_t kind_of(uint8_t rtype, uint8_t scope) {
  switch (rtype) {
    case kCounter: return scope == kGlobalOnly ? 1 : 0;
    case kGauge: return scope == kGlobalOnly ? 3 : 2;
    case kHistogram: return scope == kLocalOnly ? 5 : 4;
    case kTimer: return scope == kLocalOnly ? 7 : 6;
    case kSet:
      if (scope == kTopK) return 10;  // heavy hitters
      return scope == kLocalOnly ? 9 : 8;
    default: return 255;  // raw
  }
}

struct InternEntry {
  uint64_t hash;
  uint32_t key_off;
  uint32_t key_len;
  uint32_t row;
  uint32_t used;
};

struct InternTable {
  InternEntry* slots;
  size_t cap;  // power of two
  size_t count;
  char* arena;
  size_t arena_len;
  size_t arena_cap;
};

inline uint64_t fnv1a64(const char* data, size_t len, uint64_t h) {
  for (size_t i = 0; i < len; i++) {
    h = (h ^ static_cast<unsigned char>(data[i])) * 1099511628211ULL;
  }
  return h;
}

inline uint64_t intern_hash(uint8_t kind, const char* name, size_t nlen,
                            const char* tags, size_t tlen) {
  uint64_t h = 14695981039346656037ULL;
  char k = static_cast<char>(kind);
  h = fnv1a64(&k, 1, h);
  h = fnv1a64(name, nlen, h);
  char sep = 0x1f;
  h = fnv1a64(&sep, 1, h);
  return fnv1a64(tags, tlen, h);
}

inline bool intern_key_eq(const InternTable* t, const InternEntry* e,
                          uint8_t kind, const char* name, size_t nlen,
                          const char* tags, size_t tlen) {
  if (e->key_len != 1 + nlen + 1 + tlen) return false;
  const char* k = t->arena + e->key_off;
  if (static_cast<uint8_t>(k[0]) != kind) return false;
  if (memcmp(k + 1, name, nlen) != 0) return false;
  if (k[1 + nlen] != 0x1f) return false;
  return memcmp(k + 2 + nlen, tags, tlen) == 0;
}

void intern_grow(InternTable* t) {
  size_t ncap = t->cap * 2;
  InternEntry* ns = static_cast<InternEntry*>(
      calloc(ncap, sizeof(InternEntry)));
  for (size_t i = 0; i < t->cap; i++) {
    InternEntry* e = &t->slots[i];
    if (!e->used) continue;
    size_t j = e->hash & (ncap - 1);
    while (ns[j].used) j = (j + 1) & (ncap - 1);
    ns[j] = *e;
  }
  free(t->slots);
  t->slots = ns;
  t->cap = ncap;
}

}  // namespace

extern "C" InternTable* vt_intern_new() {
  InternTable* t = new InternTable();
  t->cap = 1 << 12;
  t->slots = static_cast<InternEntry*>(calloc(t->cap, sizeof(InternEntry)));
  t->count = 0;
  t->arena_cap = 1 << 16;
  t->arena = static_cast<char*>(malloc(t->arena_cap));
  t->arena_len = 0;
  return t;
}

extern "C" void vt_intern_free(InternTable* t) {
  free(t->slots);
  free(t->arena);
  delete t;
}

// Flush-time reset: rows restart from zero (the Python interners were
// swapped out), allocations are kept.
extern "C" void vt_intern_reset(InternTable* t) {
  memset(t->slots, 0, t->cap * sizeof(InternEntry));
  t->count = 0;
  t->arena_len = 0;
}

extern "C" void vt_intern_put(InternTable* t, uint8_t kind,
                              const char* name, uint32_t nlen,
                              const char* tags, uint32_t tlen,
                              uint32_t row) {
  if (t->count * 10 >= t->cap * 7) intern_grow(t);
  uint64_t h = intern_hash(kind, name, nlen, tags, tlen);
  size_t j = h & (t->cap - 1);
  while (t->slots[j].used) {
    InternEntry* e = &t->slots[j];
    if (e->hash == h && intern_key_eq(t, e, kind, name, nlen, tags, tlen)) {
      e->row = row;  // overwrite (python is authoritative)
      return;
    }
    j = (j + 1) & (t->cap - 1);
  }
  size_t klen = 1 + nlen + 1 + tlen;
  if (t->arena_len + klen > t->arena_cap) {
    while (t->arena_len + klen > t->arena_cap) t->arena_cap *= 2;
    t->arena = static_cast<char*>(realloc(t->arena, t->arena_cap));
  }
  char* k = t->arena + t->arena_len;
  k[0] = static_cast<char>(kind);
  memcpy(k + 1, name, nlen);
  k[1 + nlen] = 0x1f;
  memcpy(k + 2 + nlen, tags, tlen);
  InternEntry* e = &t->slots[j];
  e->hash = h;
  e->key_off = static_cast<uint32_t>(t->arena_len);
  e->key_len = static_cast<uint32_t>(klen);
  e->row = row;
  e->used = 1;
  t->arena_len += klen;
  t->count++;
}

// For every record: out_kinds[i] = scope-class kind (255 for raw),
// out_rows[i] = memoized row or UINT32_MAX on miss. Miss record indices
// are appended to out_miss; returns the miss count.
extern "C" uint32_t vt_intern_assign(InternTable* t, const VtBatch* b,
                                     uint32_t* out_rows, uint8_t* out_kinds,
                                     uint32_t* out_miss) {
  uint32_t nmiss = 0;
  for (uint32_t i = 0; i < b->count; i++) {
    uint8_t kind = kind_of(b->type[i], b->scope[i]);
    out_kinds[i] = kind;
    if (kind == 255) {
      out_rows[i] = UINT32_MAX;
      continue;
    }
    const char* name = b->arena + b->name_off[i];
    size_t nlen = b->name_len[i];
    const char* tags = b->arena + b->tags_off[i];
    size_t tlen = b->tags_len[i];
    uint64_t h = intern_hash(kind, name, nlen, tags, tlen);
    size_t j = h & (t->cap - 1);
    uint32_t row = UINT32_MAX;
    while (t->slots[j].used) {
      InternEntry* e = &t->slots[j];
      if (e->hash == h &&
          intern_key_eq(t, e, kind, name, nlen, tags, tlen)) {
        row = e->row;
        break;
      }
      j = (j + 1) & (t->cap - 1);
    }
    out_rows[i] = row;
    if (row == UINT32_MAX) out_miss[nmiss++] = i;
  }
  return nmiss;
}

// ---------------------------------------------------------------------------
// SO_REUSEPORT UDP reader pool (networking.go:37-87, socket_linux.go:12-76)

namespace {

struct Reader {
  int fd = -1;
  std::thread thread;
  std::mutex mu;
  VtBatch* active;   // parser writes here under mu
  VtBatch* standby;  // handed to Python on swap
  std::atomic<uint64_t> packets{0};
  std::atomic<uint64_t> dropped_batches{0};
};

struct ReaderPool {
  std::vector<Reader*> readers;
  std::atomic<bool> stop{false};
  int port = 0;
};

int make_udp_socket(const char* ip, int port, int rcvbuf) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  // SO_REUSEPORT kernel load-balancing (socket_linux.go:25-31)
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  if (rcvbuf > 0) {
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  }
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = ip && *ip ? inet_addr(ip) : INADDR_ANY;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

constexpr int kVlen = 64;  // datagrams per recvmmsg

void reader_loop(ReaderPool* pool, Reader* r, int dgram_max) {
  std::vector<char> bufs(static_cast<size_t>(kVlen) * dgram_max);
  mmsghdr msgs[kVlen];
  iovec iovs[kVlen];
  for (int i = 0; i < kVlen; i++) {
    iovs[i].iov_base = bufs.data() + static_cast<size_t>(i) * dgram_max;
    iovs[i].iov_len = dgram_max;
    memset(&msgs[i], 0, sizeof(mmsghdr));
    msgs[i].msg_hdr.msg_iov = &iovs[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
  }
  pollfd pfd = {r->fd, POLLIN, 0};
  while (!pool->stop.load(std::memory_order_relaxed)) {
    int pr = poll(&pfd, 1, 100);
    if (pr <= 0) continue;
    int got = recvmmsg(r->fd, msgs, kVlen, MSG_DONTWAIT, nullptr);
    if (got <= 0) continue;
    std::lock_guard<std::mutex> lock(r->mu);
    for (int i = 0; i < got; i++) {
      const char* data = bufs.data() + static_cast<size_t>(i) * dgram_max;
      size_t dlen = msgs[i].msg_len;
      if (r->active->count >= r->active->capacity ||
          r->active->arena_len + dlen > r->active->arena_cap) {
        // batch full and Python hasn't swapped: drop the datagram
        // (the kernel socket buffer is the real backpressure here,
        // like the reference's packet drops under overload)
        r->dropped_batches.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      vt_parse_lines(data, dlen, r->active);
    }
    r->packets.fetch_add(got, std::memory_order_relaxed);
  }
}

}  // namespace

extern "C" void* vt_reader_start(const char* ip, int port, int nreaders,
                                 int rcvbuf, uint32_t batch_records,
                                 uint32_t batch_arena, int dgram_max) {
  if (dgram_max <= 0) dgram_max = 8192;
  ReaderPool* pool = new ReaderPool();
  for (int i = 0; i < nreaders; i++) {
    int fd = make_udp_socket(ip, port, rcvbuf);
    if (fd < 0) {
      // threads are not started yet: release every reader created so far
      for (Reader* r : pool->readers) {
        close(r->fd);
        vt_batch_free(r->active);
        vt_batch_free(r->standby);
        delete r;
      }
      delete pool;
      return nullptr;
    }
    if (pool->port == 0) {
      sockaddr_in bound;
      socklen_t blen = sizeof(bound);
      getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
      pool->port = ntohs(bound.sin_port);
      port = pool->port;  // later readers share the resolved port
    }
    Reader* r = new Reader();
    r->fd = fd;
    r->active = vt_batch_new(batch_records, batch_arena);
    r->standby = vt_batch_new(batch_records, batch_arena);
    pool->readers.push_back(r);
  }
  for (Reader* r : pool->readers) {
    r->thread = std::thread(reader_loop, pool, r, dgram_max);
  }
  return pool;
}

extern "C" int vt_reader_port(void* handle) {
  return static_cast<ReaderPool*>(handle)->port;
}

extern "C" int vt_reader_count(void* handle) {
  return static_cast<int>(static_cast<ReaderPool*>(handle)->readers.size());
}

// Swap a reader's active batch for its (reset) standby and return the
// filled batch. Python owns the returned pointer until the next swap of
// the same reader.
extern "C" VtBatch* vt_reader_swap(void* handle, int idx) {
  ReaderPool* pool = static_cast<ReaderPool*>(handle);
  Reader* r = pool->readers[idx];
  std::lock_guard<std::mutex> lock(r->mu);
  VtBatch* filled = r->active;
  vt_batch_reset(r->standby);
  r->active = r->standby;
  r->standby = filled;
  return filled;
}

extern "C" uint64_t vt_reader_packets(void* handle, int idx) {
  return static_cast<ReaderPool*>(handle)
      ->readers[idx]->packets.load(std::memory_order_relaxed);
}

extern "C" uint64_t vt_reader_drops(void* handle, int idx) {
  return static_cast<ReaderPool*>(handle)
      ->readers[idx]->dropped_batches.load(std::memory_order_relaxed);
}

extern "C" void vt_reader_stop(void* handle) {
  ReaderPool* pool = static_cast<ReaderPool*>(handle);
  pool->stop.store(true);
  for (Reader* r : pool->readers) {
    if (r->thread.joinable()) r->thread.join();
    close(r->fd);
    vt_batch_free(r->active);
    vt_batch_free(r->standby);
    delete r;
  }
  delete pool;
}

// ---------------------------------------------------------------------------
// SSF span batch lane (server.go:827-899, ssf/sample.proto)
//
// UDP SSF datagrams each carry one bare SSFSpan protobuf. The Python
// path decodes them one ParseFromString at a time on the reader thread
// — the round-4 verdict's last hot ingest lane without a batch twin.
// Here the reader pool decodes spans on its C++ threads (off the GIL)
// into a struct-of-arrays span batch whose EMBEDDED METRICS are
// appended directly as VtBatch records, bit-identical to the Python
// parse_metric_ssf conversion (parser.py:198-233 / parser.go:179-230):
// "k:v" tags sorted bytewise, exact-key veneurlocalonly/globalonly
// scope extraction, fnv1a(name+type+joined-tags) digest, set members
// hashed with the FNV+fmix64 member hash. Indicator spans synthesize
// the configured duration timer natively (parser.go:94-121). STATUS
// samples (rare control-plane) and undecodable samples are surfaced as
// raw byte ranges for the Python slow lane. The raw span bytes stay in
// the arena so Python can materialize the full protobuf lazily for
// span sinks that need it.

namespace {

// minimal proto3 walker (same shape as veneur_egress.cpp's Cursor —
// the two .so files are compiled standalone, so a local copy)
struct PbCursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }
  uint32_t fixed32() {
    if (end - p < 4) { ok = false; return 0; }
    uint32_t v;
    memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  float f32() {
    uint32_t v = fixed32();
    float f;
    memcpy(&f, &v, 4);
    return f;
  }
  uint32_t tag() {
    if (p >= end) return 0;
    uint64_t t = varint();
    return ok ? static_cast<uint32_t>(t) : 0;
  }
  PbCursor sub() {
    uint64_t n = varint();
    if (!ok || static_cast<uint64_t>(end - p) < n) {
      ok = false;
      return {p, p};
    }
    PbCursor c{p, p + n};
    p += n;
    return c;
  }
  void skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1: if (end - p >= 8) p += 8; else ok = false; break;
      case 2: {
        uint64_t n = varint();
        if (ok && static_cast<uint64_t>(end - p) >= n) p += n;
        else ok = false;
        break;
      }
      case 5: if (end - p >= 4) p += 4; else ok = false; break;
      default: ok = false;
    }
  }
};

}  // namespace

// Decoded span batch. Span string fields (service/name) are offsets into
// `arena`, pointing INSIDE the span's raw bytes (raw_off/raw_len), which
// hold the whole datagram for lazy full-protobuf materialization.
// Embedded metric samples land in `metrics` as ordinary parsed records.
extern "C" struct VsBatch {
  uint32_t capacity;
  uint32_t count;
  uint32_t arena_cap;
  uint32_t arena_len;
  uint64_t decode_errors;    // undecodable datagrams
  uint64_t invalid_samples;  // samples failing parse_metric_ssf validity
  int32_t* version;
  int64_t* trace_id;
  int64_t* span_id;
  int64_t* parent_id;
  int64_t* start_ns;
  int64_t* end_ns;
  uint8_t* error;
  uint8_t* indicator;
  uint32_t* service_off;
  uint32_t* service_len;
  uint32_t* name_off;
  uint32_t* name_len;
  uint32_t* raw_off;
  uint32_t* raw_len;
  char* arena;
  VtBatch* metrics;
  // slow lane: STATUS / otherwise Python-only samples, raw bytes
  uint32_t slow_cap;
  uint32_t slow_count;
  uint32_t* slow_off;
  uint32_t* slow_len;
};

extern "C" VsBatch* vs_batch_new(uint32_t spans_cap, uint32_t arena_cap,
                                 uint32_t metric_cap,
                                 uint32_t metric_arena_cap) {
  VsBatch* b = static_cast<VsBatch*>(calloc(1, sizeof(VsBatch)));
  b->capacity = spans_cap;
  b->arena_cap = arena_cap;
  b->version = static_cast<int32_t*>(malloc(spans_cap * 4));
  b->trace_id = static_cast<int64_t*>(malloc(spans_cap * 8));
  b->span_id = static_cast<int64_t*>(malloc(spans_cap * 8));
  b->parent_id = static_cast<int64_t*>(malloc(spans_cap * 8));
  b->start_ns = static_cast<int64_t*>(malloc(spans_cap * 8));
  b->end_ns = static_cast<int64_t*>(malloc(spans_cap * 8));
  b->error = static_cast<uint8_t*>(malloc(spans_cap));
  b->indicator = static_cast<uint8_t*>(malloc(spans_cap));
  b->service_off = static_cast<uint32_t*>(malloc(spans_cap * 4));
  b->service_len = static_cast<uint32_t*>(malloc(spans_cap * 4));
  b->name_off = static_cast<uint32_t*>(malloc(spans_cap * 4));
  b->name_len = static_cast<uint32_t*>(malloc(spans_cap * 4));
  b->raw_off = static_cast<uint32_t*>(malloc(spans_cap * 4));
  b->raw_len = static_cast<uint32_t*>(malloc(spans_cap * 4));
  b->arena = static_cast<char*>(malloc(arena_cap));
  b->metrics = vt_batch_new(metric_cap, metric_arena_cap);
  b->slow_cap = spans_cap;
  b->slow_off = static_cast<uint32_t*>(malloc(b->slow_cap * 4));
  b->slow_len = static_cast<uint32_t*>(malloc(b->slow_cap * 4));
  return b;
}

extern "C" void vs_batch_free(VsBatch* b) {
  if (!b) return;
  free(b->version); free(b->trace_id); free(b->span_id);
  free(b->parent_id); free(b->start_ns); free(b->end_ns);
  free(b->error); free(b->indicator);
  free(b->service_off); free(b->service_len);
  free(b->name_off); free(b->name_len);
  free(b->raw_off); free(b->raw_len);
  free(b->arena);
  vt_batch_free(b->metrics);
  free(b->slow_off); free(b->slow_len);
  free(b);
}

extern "C" void vs_batch_reset(VsBatch* b) {
  b->count = 0;
  b->arena_len = 0;
  b->decode_errors = 0;
  b->invalid_samples = 0;
  b->slow_count = 0;
  vt_batch_reset(b->metrics);
}

namespace {

inline uint32_t vs_arena_put(VsBatch* b, const char* data, size_t len) {
  if (b->arena_len + len > b->arena_cap) return UINT32_MAX;
  memcpy(b->arena + b->arena_len, data, len);
  uint32_t off = b->arena_len;
  b->arena_len += static_cast<uint32_t>(len);
  return off;
}

// Append one decoded SSFSample as a parsed metric record, mirroring
// parse_metric_ssf + valid_metric (parser.py:198-238). Returns false
// only when the metrics batch/arena is full (caller drops the batch
// accounting); invalid samples bump the counter and "succeed".
bool append_ssf_sample(VsBatch* vb, uint32_t sample_metric,
                       const char* name_p, size_t name_n,
                       float value, float sample_rate,
                       const char* member_p, size_t member_n,
                       const std::vector<std::string>& kv_tags) {
  VtBatch* mb = vb->metrics;
  uint8_t rtype;
  switch (sample_metric) {
    case 0: rtype = kCounter; break;
    case 1: rtype = kGauge; break;
    case 2: rtype = kHistogram; break;
    case 3: rtype = kSet; break;
    default:
      // unknown enum: parse error in the Python path too
      vb->invalid_samples++;
      return true;
  }
  if (name_n == 0 || (rtype == kSet && member_n == 0)) {
    vb->invalid_samples++;  // valid_metric: name and value required
    return true;
  }
  if (mb->count >= mb->capacity) return false;
  uint32_t idx = mb->count;

  // exact-key scope extraction; every matching key is removed and the
  // LAST one seen wins, matching the dict iteration in parser.py:215-222
  uint8_t scope = kMixed;
  std::vector<const std::string*> keep;
  keep.reserve(kv_tags.size());
  for (const std::string& kv : kv_tags) {
    size_t colon = kv.find(':');
    size_t klen = colon == std::string::npos ? kv.size() : colon;
    if (klen == 15 && memcmp(kv.data(), "veneurlocalonly", 15) == 0) {
      scope = kLocalOnly;
      continue;
    }
    if (klen == 16 && memcmp(kv.data(), "veneurglobalonly", 16) == 0) {
      scope = kGlobalOnly;
      continue;
    }
    keep.push_back(&kv);
  }
  std::sort(keep.begin(), keep.end(),
            [](const std::string* a, const std::string* b) {
              return *a < *b;
            });
  if (rtype == kSet) {
    for (const std::string* kv : keep) {
      // the SSF "k:v" encoding makes the tag "veneurtopk:<value>";
      // match the KEY (parser.py parse_metric_ssf does the same)
      if (kv->size() >= 10 && memcmp(kv->data(), "veneurtopk", 10) == 0 &&
          (kv->size() == 10 || (*kv)[10] == ':')) {
        scope = kTopK;
        break;
      }
    }
  }

  uint32_t noff = arena_put(mb, name_p, name_n);
  if (noff == UINT32_MAX) return false;
  uint32_t h = fnv1a(name_p, name_n, kFnvInit);
  h = fnv1a(kTypeNames[rtype], kTypeNameLens[rtype], h);

  uint32_t toff = mb->arena_len;
  uint32_t tlen = 0;
  for (size_t i = 0; i < keep.size(); i++) {
    if (i > 0) {
      if (arena_put(mb, ",", 1) == UINT32_MAX) return false;
      tlen += 1;
    }
    if (arena_put(mb, keep[i]->data(), keep[i]->size()) == UINT32_MAX)
      return false;
    tlen += static_cast<uint32_t>(keep[i]->size());
  }
  h = fnv1a(mb->arena + toff, tlen, h);

  double dvalue = static_cast<double>(value);
  uint32_t aoff = 0, alen = 0;
  if (rtype == kSet) {
    aoff = arena_put(mb, member_p, member_n);
    if (aoff == UINT32_MAX) return false;
    alen = static_cast<uint32_t>(member_n);
    uint64_t mh = 14695981039346656037ULL;
    for (size_t vi = 0; vi < member_n; vi++) {
      mh = (mh ^ static_cast<uint8_t>(member_p[vi])) * 1099511628211ULL;
    }
    mh ^= mh >> 33;
    mh *= 0xFF51AFD7ED558CCDULL;
    mh ^= mh >> 33;
    mh *= 0xC4CEB9FE1A85EC53ULL;
    mh ^= mh >> 33;
    memcpy(&dvalue, &mh, sizeof(dvalue));
  }

  mb->type[idx] = rtype;
  mb->scope[idx] = scope;
  mb->value[idx] = dvalue;
  mb->sample_rate[idx] = sample_rate;
  mb->digest[idx] = h;
  mb->name_off[idx] = noff;
  mb->name_len[idx] = static_cast<uint32_t>(name_n);
  mb->tags_off[idx] = toff;
  mb->tags_len[idx] = tlen;
  mb->aux_off[idx] = aoff;
  mb->aux_len[idx] = alen;
  mb->count++;
  return true;
}

}  // namespace

// Decode one SSFSpan datagram into the batch. Returns 1 on success,
// 0 when the batch is full or the bytes are not a decodable span (the
// caller distinguishes via decode_errors).
extern "C" int vs_decode_span(const char* data, size_t len, VsBatch* b,
                              const char* ind_name, uint32_t ind_len) {
  if (b->count >= b->capacity) return 0;
  uint32_t roff = vs_arena_put(b, data, len);
  if (roff == UINT32_MAX) return 0;

  uint32_t idx = b->count;
  int32_t version = 0;
  int64_t trace_id = 0, span_id = 0, parent_id = 0, start_ns = 0,
          end_ns = 0;
  uint8_t err = 0, indicator = 0;
  uint32_t svc_off = 0, svc_len = 0, nm_off = 0, nm_len = 0;

  const uint8_t* base = reinterpret_cast<const uint8_t*>(data);
  PbCursor c{base, base + len};
  // sample submessage ranges, decoded after the span header so the
  // indicator synthesis has service/error available
  std::vector<std::pair<uint32_t, uint32_t>> samples;
  while (c.ok) {
    uint32_t t = c.tag();
    if (t == 0) break;
    uint32_t field = t >> 3, wt = t & 7;
    switch (field) {
      case 1: if (wt == 0) version = static_cast<int32_t>(c.varint());
              else c.skip(wt); break;
      case 2: if (wt == 0) trace_id = static_cast<int64_t>(c.varint());
              else c.skip(wt); break;
      case 3: if (wt == 0) span_id = static_cast<int64_t>(c.varint());
              else c.skip(wt); break;
      case 4: if (wt == 0) parent_id = static_cast<int64_t>(c.varint());
              else c.skip(wt); break;
      case 5: if (wt == 0) start_ns = static_cast<int64_t>(c.varint());
              else c.skip(wt); break;
      case 6: if (wt == 0) end_ns = static_cast<int64_t>(c.varint());
              else c.skip(wt); break;
      case 7: if (wt == 0) err = c.varint() ? 1 : 0;
              else c.skip(wt); break;
      case 8: {
        if (wt != 2) { c.skip(wt); break; }
        PbCursor s = c.sub();
        svc_off = roff + static_cast<uint32_t>(s.p - base);
        svc_len = static_cast<uint32_t>(s.end - s.p);
        break;
      }
      case 10: {
        if (wt != 2) { c.skip(wt); break; }
        PbCursor s = c.sub();
        samples.emplace_back(static_cast<uint32_t>(s.p - base),
                             static_cast<uint32_t>(s.end - s.p));
        break;
      }
      case 12: if (wt == 0) indicator = c.varint() ? 1 : 0;
               else c.skip(wt); break;
      case 13: {
        if (wt != 2) { c.skip(wt); break; }
        PbCursor s = c.sub();
        nm_off = roff + static_cast<uint32_t>(s.p - base);
        nm_len = static_cast<uint32_t>(s.end - s.p);
        break;
      }
      default: c.skip(wt); break;
    }
  }
  if (!c.ok) {
    b->arena_len = roff;  // roll back the raw copy
    b->decode_errors++;
    return 0;
  }

  // embedded samples -> metric records (STATUS and broken samples go
  // to the Python slow lane as raw bytes)
  for (const auto& [soff, slen] : samples) {
    PbCursor s{base + soff, base + soff + slen};
    uint32_t metric = 0;
    const char* name_p = nullptr;
    size_t name_n = 0;
    // absent sample_rate (proto3 default 0) means unsampled: weight
    // 1.0, never 1/0 (matches parser.py parse_metric_ssf)
    float value = 0.0f, rate = 0.0f;
    const char* member_p = nullptr;
    size_t member_n = 0;
    std::vector<std::string> kv_tags;
    bool slow = false;
    while (s.ok) {
      uint32_t t = s.tag();
      if (t == 0) break;
      uint32_t field = t >> 3, wt = t & 7;
      switch (field) {
        case 1: if (wt == 0) metric = static_cast<uint32_t>(s.varint());
                else s.skip(wt); break;
        case 2: {
          if (wt != 2) { s.skip(wt); break; }
          PbCursor ss = s.sub();
          name_p = reinterpret_cast<const char*>(ss.p);
          name_n = ss.end - ss.p;
          break;
        }
        case 3: if (wt == 5) value = s.f32(); else s.skip(wt); break;
        case 5: {
          if (wt != 2) { s.skip(wt); break; }
          PbCursor ss = s.sub();
          member_p = reinterpret_cast<const char*>(ss.p);
          member_n = ss.end - ss.p;
          break;
        }
        case 7: if (wt == 5) rate = s.f32(); else s.skip(wt); break;
        case 8: {
          if (wt != 2) { s.skip(wt); break; }
          PbCursor entry = s.sub();
          const char* kp = nullptr; size_t kn = 0;
          const char* vp = nullptr; size_t vn = 0;
          while (entry.ok) {
            uint32_t et = entry.tag();
            if (et == 0) break;
            uint32_t ef = et >> 3, ew = et & 7;
            if (ef == 1 && ew == 2) {
              PbCursor ks = entry.sub();
              kp = reinterpret_cast<const char*>(ks.p);
              kn = ks.end - ks.p;
            } else if (ef == 2 && ew == 2) {
              PbCursor vs = entry.sub();
              vp = reinterpret_cast<const char*>(vs.p);
              vn = vs.end - vs.p;
            } else {
              entry.skip(ew);
            }
          }
          std::string kv;
          kv.reserve(kn + 1 + vn);
          kv.append(kp ? kp : "", kn);
          kv.push_back(':');
          kv.append(vp ? vp : "", vn);
          kv_tags.push_back(std::move(kv));
          break;
        }
        default: s.skip(wt); break;
      }
    }
    if (!s.ok || metric == 4 || metric > 4) {
      // STATUS (needs the status enum + message) or undecodable:
      // Python slow lane on the raw sample bytes
      slow = true;
    }
    if (slow) {
      if (b->slow_count < b->slow_cap) {
        b->slow_off[b->slow_count] = roff + soff;
        b->slow_len[b->slow_count] = slen;
        b->slow_count++;
      } else {
        b->invalid_samples++;
      }
      continue;
    }
    if (rate <= 0.0f) rate = 1.0f;
    if (!append_ssf_sample(b, metric, name_p, name_n, value, rate,
                           member_p, member_n, kv_tags)) {
      // metrics batch full: surface the sample on the slow lane rather
      // than dropping it silently
      if (b->slow_count < b->slow_cap) {
        b->slow_off[b->slow_count] = roff + soff;
        b->slow_len[b->slow_count] = slen;
        b->slow_count++;
      } else {
        b->invalid_samples++;
      }
    }
  }

  // indicator duration timer (parser.go:94-121): HISTOGRAM ns duration
  // tagged error:bool + service, unit ns, rate 1.0
  if (indicator && ind_len > 0) {
    std::vector<std::string> tags;
    std::string et("error:");
    et += err ? "true" : "false";
    tags.push_back(std::move(et));
    std::string st("service:");
    st.append(b->arena + svc_off, svc_len);
    tags.push_back(std::move(st));
    double dur = static_cast<double>(end_ns - start_ns);
    // append via the shared helper; value passes through float, which
    // would truncate long durations — write the record directly
    VtBatch* mb = b->metrics;
    if (mb->count < mb->capacity) {
      uint32_t mi = mb->count;
      uint32_t noff2 = arena_put(mb, ind_name, ind_len);
      uint32_t toff2 = mb->arena_len;
      uint32_t tlen2 = 0;
      bool okp = noff2 != UINT32_MAX;
      for (size_t i = 0; okp && i < tags.size(); i++) {
        if (i > 0) {
          okp = arena_put(mb, ",", 1) != UINT32_MAX;
          tlen2 += 1;
        }
        if (okp) {
          okp = arena_put(mb, tags[i].data(), tags[i].size())
                != UINT32_MAX;
          tlen2 += static_cast<uint32_t>(tags[i].size());
        }
      }
      if (okp) {
        uint32_t h = fnv1a(ind_name, ind_len, kFnvInit);
        h = fnv1a(kTypeNames[kHistogram], kTypeNameLens[kHistogram], h);
        h = fnv1a(mb->arena + toff2, tlen2, h);
        mb->type[mi] = kHistogram;
        mb->scope[mi] = kMixed;
        mb->value[mi] = dur;
        mb->sample_rate[mi] = 1.0f;
        mb->digest[mi] = h;
        mb->name_off[mi] = noff2;
        mb->name_len[mi] = ind_len;
        mb->tags_off[mi] = toff2;
        mb->tags_len[mi] = tlen2;
        mb->aux_off[mi] = 0;
        mb->aux_len[mi] = 0;
        mb->count++;
      }
    }
  }

  b->version[idx] = version;
  b->trace_id[idx] = trace_id;
  b->span_id[idx] = span_id;
  b->parent_id[idx] = parent_id;
  b->start_ns[idx] = start_ns;
  b->end_ns[idx] = end_ns;
  b->error[idx] = err;
  b->indicator[idx] = indicator;
  b->service_off[idx] = svc_off;
  b->service_len[idx] = svc_len;
  b->name_off[idx] = nm_off;
  b->name_len[idx] = nm_len;
  b->raw_off[idx] = roff;
  b->raw_len[idx] = static_cast<uint32_t>(len);
  b->count++;
  return 1;
}

// ---------------------------------------------------------------------------
// SSF reader pool: same recvmmsg/SO_REUSEPORT shape as the metric pool,
// but each datagram decodes as one SSFSpan on the reader thread.

namespace {

struct SsfReader {
  int fd = -1;
  std::thread thread;
  std::mutex mu;
  VsBatch* active;
  VsBatch* standby;
  std::atomic<uint64_t> packets{0};
  std::atomic<uint64_t> dropped_batches{0};
};

struct SsfReaderPool {
  std::vector<SsfReader*> readers;
  std::atomic<bool> stop{false};
  int port = 0;
  std::string indicator_name;
};

void ssf_reader_loop(SsfReaderPool* pool, SsfReader* r, int dgram_max) {
  std::vector<char> bufs(static_cast<size_t>(kVlen) * dgram_max);
  mmsghdr msgs[kVlen];
  iovec iovs[kVlen];
  for (int i = 0; i < kVlen; i++) {
    iovs[i].iov_base = bufs.data() + static_cast<size_t>(i) * dgram_max;
    iovs[i].iov_len = dgram_max;
    memset(&msgs[i], 0, sizeof(mmsghdr));
    msgs[i].msg_hdr.msg_iov = &iovs[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
  }
  const char* ind = pool->indicator_name.c_str();
  uint32_t ind_len = static_cast<uint32_t>(pool->indicator_name.size());
  pollfd pfd = {r->fd, POLLIN, 0};
  while (!pool->stop.load(std::memory_order_relaxed)) {
    int pr = poll(&pfd, 1, 100);
    if (pr <= 0) continue;
    int got = recvmmsg(r->fd, msgs, kVlen, MSG_DONTWAIT, nullptr);
    if (got <= 0) continue;
    std::lock_guard<std::mutex> lock(r->mu);
    for (int i = 0; i < got; i++) {
      const char* data = bufs.data() + static_cast<size_t>(i) * dgram_max;
      size_t dlen = msgs[i].msg_len;
      VsBatch* b = r->active;
      if (b->count >= b->capacity ||
          b->arena_len + dlen > b->arena_cap ||
          b->metrics->count + 8 > b->metrics->capacity) {
        // batch full and Python hasn't swapped: shed, like the metric
        // pool (the kernel socket buffer is the real backpressure)
        r->dropped_batches.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      vs_decode_span(data, dlen, b, ind, ind_len);
    }
    r->packets.fetch_add(got, std::memory_order_relaxed);
  }
}

}  // namespace

extern "C" void* vs_reader_start(const char* ip, int port, int nreaders,
                                 int rcvbuf, uint32_t span_cap,
                                 uint32_t arena_cap, uint32_t metric_cap,
                                 uint32_t metric_arena, int dgram_max,
                                 const char* ind_name) {
  if (dgram_max <= 0) dgram_max = 8192;
  SsfReaderPool* pool = new SsfReaderPool();
  pool->indicator_name = ind_name ? ind_name : "";
  for (int i = 0; i < nreaders; i++) {
    int fd = make_udp_socket(ip, port, rcvbuf);
    if (fd < 0) {
      for (SsfReader* r : pool->readers) {
        close(r->fd);
        vs_batch_free(r->active);
        vs_batch_free(r->standby);
        delete r;
      }
      delete pool;
      return nullptr;
    }
    if (pool->port == 0) {
      sockaddr_in bound;
      socklen_t blen = sizeof(bound);
      getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
      pool->port = ntohs(bound.sin_port);
      port = pool->port;
    }
    SsfReader* r = new SsfReader();
    r->fd = fd;
    r->active = vs_batch_new(span_cap, arena_cap, metric_cap,
                             metric_arena);
    r->standby = vs_batch_new(span_cap, arena_cap, metric_cap,
                              metric_arena);
    pool->readers.push_back(r);
  }
  for (SsfReader* r : pool->readers) {
    r->thread = std::thread(ssf_reader_loop, pool, r, dgram_max);
  }
  return pool;
}

extern "C" int vs_reader_port(void* handle) {
  return static_cast<SsfReaderPool*>(handle)->port;
}

extern "C" int vs_reader_count(void* handle) {
  return static_cast<int>(
      static_cast<SsfReaderPool*>(handle)->readers.size());
}

extern "C" VsBatch* vs_reader_swap(void* handle, int idx) {
  SsfReaderPool* pool = static_cast<SsfReaderPool*>(handle);
  SsfReader* r = pool->readers[idx];
  std::lock_guard<std::mutex> lock(r->mu);
  VsBatch* filled = r->active;
  vs_batch_reset(r->standby);
  r->active = r->standby;
  r->standby = filled;
  return filled;
}

extern "C" uint64_t vs_reader_packets(void* handle, int idx) {
  return static_cast<SsfReaderPool*>(handle)
      ->readers[idx]->packets.load(std::memory_order_relaxed);
}

extern "C" uint64_t vs_reader_drops(void* handle, int idx) {
  return static_cast<SsfReaderPool*>(handle)
      ->readers[idx]->dropped_batches.load(std::memory_order_relaxed);
}

extern "C" void vs_reader_stop(void* handle) {
  SsfReaderPool* pool = static_cast<SsfReaderPool*>(handle);
  pool->stop.store(true);
  for (SsfReader* r : pool->readers) {
    if (r->thread.joinable()) r->thread.join();
    close(r->fd);
    vs_batch_free(r->active);
    vs_batch_free(r->standby);
    delete r;
  }
  delete pool;
}

// ---------------------------------------------------------------------------
// Native TCP/TLS statsd listener (server.go:901-1001 + the TLS config of
// server.go:314-348, rebuilt native)
//
// The Python TLS accept path tops out well under the reference's
// published ~700 conn/s (ECDH prime256v1, localhost, one CPU): OpenSSL
// 3.0's per-connection setup plus the Python ssl-module wrapper and
// per-connection thread spawn eat the budget. This listener terminates
// TLS in C++ — accept, handshake, newline framing and DogStatsD parsing
// all happen off the GIL, feeding the same VtBatch swap protocol the
// UDP pool uses (one Python FFI drain per batch).
//
// libssl is loaded at runtime with dlopen/dlsym against the stable
// OpenSSL 3 C ABI (the image ships libssl.so.3 but no headers); when
// the library or a symbol is missing, vt_tls_available() reports 0 and
// Python keeps its own TLS path. Client-cert auth mirrors
// make_server_tls_context: a CA path turns on required verification.
// Session tickets are disabled: statsd TLS clients hold connections
// long-term, and full-handshake capacity (the number the reference
// publishes) beats resumption for reconnect storms.

#include <dlfcn.h>

namespace {

// --- minimal OpenSSL 3 ABI (stable exported C symbols) ---
struct OsslApi {
  void* ssl_handle = nullptr;
  void* crypto_handle = nullptr;
  const void* (*TLS_server_method)();
  void* (*SSL_CTX_new)(const void*);
  void (*SSL_CTX_free)(void*);
  int (*SSL_CTX_use_certificate_chain_file)(void*, const char*);
  int (*SSL_CTX_use_PrivateKey_file)(void*, const char*, int);
  int (*SSL_CTX_check_private_key)(const void*);
  void (*SSL_CTX_set_verify)(void*, int, void*);
  int (*SSL_CTX_load_verify_locations)(void*, const char*, const char*);
  int (*SSL_CTX_set_num_tickets)(void*, size_t);
  void* (*SSL_new)(void*);
  void (*SSL_free)(void*);
  int (*SSL_set_fd)(void*, int);
  int (*SSL_accept)(void*);
  int (*SSL_read)(void*, void*, int);
  int (*SSL_get_error)(const void*, int);
  int (*SSL_shutdown)(void*);
  unsigned long (*ERR_get_error)();
  bool ok = false;
};

OsslApi* ossl() {
  static OsslApi api;
  static std::once_flag once;
  std::call_once(once, [] {
    // RTLD_LOCAL: every symbol is fetched via dlsym, and a GLOBAL
    // promotion could interpose these OpenSSL 3 symbols onto a Python
    // _ssl built against a different OpenSSL in the same process
    void* h = dlopen("libssl.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libssl.so.1.1", RTLD_NOW | RTLD_LOCAL);
    if (!h) return;
    void* hc = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!hc) hc = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_LOCAL);
    api.ssl_handle = h;
    api.crypto_handle = hc;
    bool all = true;
    auto grab = [&](const char* name) -> void* {
      void* p = dlsym(h, name);
      if (!p && hc) p = dlsym(hc, name);
      if (!p) all = false;
      return p;
    };
    api.TLS_server_method = reinterpret_cast<const void* (*)()>(
        grab("TLS_server_method"));
    api.SSL_CTX_new = reinterpret_cast<void* (*)(const void*)>(
        grab("SSL_CTX_new"));
    api.SSL_CTX_free = reinterpret_cast<void (*)(void*)>(
        grab("SSL_CTX_free"));
    api.SSL_CTX_use_certificate_chain_file =
        reinterpret_cast<int (*)(void*, const char*)>(
            grab("SSL_CTX_use_certificate_chain_file"));
    api.SSL_CTX_use_PrivateKey_file =
        reinterpret_cast<int (*)(void*, const char*, int)>(
            grab("SSL_CTX_use_PrivateKey_file"));
    api.SSL_CTX_check_private_key = reinterpret_cast<int (*)(const void*)>(
        grab("SSL_CTX_check_private_key"));
    api.SSL_CTX_set_verify = reinterpret_cast<void (*)(void*, int, void*)>(
        grab("SSL_CTX_set_verify"));
    api.SSL_CTX_load_verify_locations =
        reinterpret_cast<int (*)(void*, const char*, const char*)>(
            grab("SSL_CTX_load_verify_locations"));
    api.SSL_CTX_set_num_tickets = reinterpret_cast<int (*)(void*, size_t)>(
        grab("SSL_CTX_set_num_tickets"));
    api.SSL_new = reinterpret_cast<void* (*)(void*)>(grab("SSL_new"));
    api.SSL_free = reinterpret_cast<void (*)(void*)>(grab("SSL_free"));
    api.SSL_set_fd = reinterpret_cast<int (*)(void*, int)>(
        grab("SSL_set_fd"));
    api.SSL_accept = reinterpret_cast<int (*)(void*)>(grab("SSL_accept"));
    api.SSL_read = reinterpret_cast<int (*)(void*, void*, int)>(
        grab("SSL_read"));
    api.SSL_get_error = reinterpret_cast<int (*)(const void*, int)>(
        grab("SSL_get_error"));
    api.SSL_shutdown = reinterpret_cast<int (*)(void*)>(
        grab("SSL_shutdown"));
    api.ERR_get_error = reinterpret_cast<unsigned long (*)()>(
        grab("ERR_get_error"));
    api.ok = all;
  });
  return &api;
}

constexpr int kSslFiletypePem = 1;       // SSL_FILETYPE_PEM
constexpr int kSslVerifyPeer = 0x01;     // SSL_VERIFY_PEER
constexpr int kSslVerifyFailNoPeer = 0x02;

struct TlsServer {
  int listen_fd = -1;
  void* ssl_ctx = nullptr;  // null = plain TCP
  std::thread acceptor;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> conns{0};
  std::atomic<uint64_t> handshake_failures{0};
  std::atomic<uint64_t> dropped{0};
  // load-bearing for shutdown: stop() waits for the detached
  // connection threads to drain before freeing this struct
  std::atomic<int> live_conns{0};
  std::mutex mu;  // guards active/standby
  VtBatch* active = nullptr;
  VtBatch* standby = nullptr;
  int port = 0;
  int max_line = 4096;
  int handshake_timeout_ms = 10000;
};

void tls_conn_loop(TlsServer* srv, int fd) {
  OsslApi* api = ossl();
  void* ssl = nullptr;
  if (srv->ssl_ctx) {
    // bound handshake + reads: a silent client wedges only itself
    // (the Python path's slowloris posture, networking.py)
    timeval tv{srv->handshake_timeout_ms / 1000,
               (srv->handshake_timeout_ms % 1000) * 1000};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    ssl = api->SSL_new(srv->ssl_ctx);
    if (!ssl || api->SSL_set_fd(ssl, fd) != 1 ||
        api->SSL_accept(ssl) != 1) {
      srv->handshake_failures.fetch_add(1, std::memory_order_relaxed);
      if (ssl) api->SSL_free(ssl);
      close(fd);
      srv->live_conns.fetch_add(-1, std::memory_order_relaxed);
      return;
    }
  }
  // post-handshake read timeout: 500ms poll-equivalent granularity
  timeval rv{0, 500000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &rv, sizeof(rv));
  std::vector<char> buf;
  buf.reserve(srv->max_line + 65536);
  char tmp[65536];
  while (!srv->stop.load(std::memory_order_relaxed)) {
    int n;
    if (ssl) {
      n = api->SSL_read(ssl, tmp, sizeof(tmp));
      if (n <= 0) {
        int err = api->SSL_get_error(ssl, n);
        // 2 = WANT_READ (timeout tick): keep waiting unless stopping
        if (err == 2) continue;
        break;  // clean close (ZERO_RETURN) or error: drop the conn
      }
    } else {
      n = static_cast<int>(recv(fd, tmp, sizeof(tmp), 0));
      if (n == 0) break;
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
          continue;
        break;
      }
    }
    buf.insert(buf.end(), tmp, tmp + n);
    // parse every complete line; keep the tail
    size_t last_nl = buf.size();
    while (last_nl > 0 && buf[last_nl - 1] != '\n') last_nl--;
    if (last_nl > 0) {
      std::lock_guard<std::mutex> lock(srv->mu);
      if (srv->active->count >= srv->active->capacity ||
          srv->active->arena_len + last_nl > srv->active->arena_cap) {
        srv->dropped.fetch_add(1, std::memory_order_relaxed);
      } else {
        // parse errors reach Python via the batch's own counter
        vt_parse_lines(buf.data(), last_nl, srv->active);
      }
      buf.erase(buf.begin(), buf.begin() + last_nl);
    }
    if (buf.size() > static_cast<size_t>(srv->max_line)) {
      // a single line beyond max_length poisons the connection
      // (server.go:920-983)
      break;
    }
  }
  if (ssl) {
    api->SSL_shutdown(ssl);
    api->SSL_free(ssl);
  }
  close(fd);
  srv->live_conns.fetch_add(-1, std::memory_order_relaxed);
}

void tls_accept_loop(TlsServer* srv) {
  pollfd pfd = {srv->listen_fd, POLLIN, 0};
  while (!srv->stop.load(std::memory_order_relaxed)) {
    int pr = poll(&pfd, 1, 100);
    if (pr <= 0) continue;
    int fd = accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) continue;
    srv->conns.fetch_add(1, std::memory_order_relaxed);
    srv->live_conns.fetch_add(1, std::memory_order_relaxed);
    // detached: statsd TLS connections are long-lived, so joining
    // live threads from the accept loop would wedge accepts; stop()
    // synchronizes on live_conns instead
    std::thread(tls_conn_loop, srv, fd).detach();
  }
}

}  // namespace

extern "C" int vt_tls_available() { return ossl()->ok ? 1 : 0; }

// Start a TCP (cert_path empty -> plaintext) or TLS statsd listener.
// Returns null on failure. ca_path non-empty turns on required
// client-cert verification, mirroring make_server_tls_context.
extern "C" void* vt_tls_server_start(const char* ip, int port,
                                     const char* cert_path,
                                     const char* key_path,
                                     const char* ca_path,
                                     uint32_t batch_records,
                                     uint32_t batch_arena,
                                     int max_line) {
  OsslApi* api = ossl();
  bool want_tls = cert_path && *cert_path;
  if (want_tls && !api->ok) return nullptr;

  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = ip && *ip ? inet_addr(ip) : INADDR_ANY;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 128) != 0) {
    close(fd);
    return nullptr;
  }

  void* ctx = nullptr;
  if (want_tls) {
    ctx = api->SSL_CTX_new(api->TLS_server_method());
    if (!ctx ||
        api->SSL_CTX_use_certificate_chain_file(ctx, cert_path) != 1 ||
        api->SSL_CTX_use_PrivateKey_file(ctx, key_path,
                                         kSslFiletypePem) != 1 ||
        api->SSL_CTX_check_private_key(ctx) != 1) {
      if (ctx) api->SSL_CTX_free(ctx);
      close(fd);
      return nullptr;
    }
    if (ca_path && *ca_path) {
      if (api->SSL_CTX_load_verify_locations(ctx, ca_path, nullptr) != 1) {
        api->SSL_CTX_free(ctx);
        close(fd);
        return nullptr;
      }
      api->SSL_CTX_set_verify(
          ctx, kSslVerifyPeer | kSslVerifyFailNoPeer, nullptr);
    }
    if (api->SSL_CTX_set_num_tickets) {
      api->SSL_CTX_set_num_tickets(ctx, 0);
    }
  }

  TlsServer* srv = new TlsServer();
  srv->listen_fd = fd;
  srv->ssl_ctx = ctx;
  srv->max_line = max_line > 0 ? max_line : 4096;
  srv->active = vt_batch_new(batch_records, batch_arena);
  srv->standby = vt_batch_new(batch_records, batch_arena);
  sockaddr_in bound;
  socklen_t blen = sizeof(bound);
  getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  srv->port = ntohs(bound.sin_port);
  srv->acceptor = std::thread(tls_accept_loop, srv);
  return srv;
}

extern "C" int vt_tls_server_port(void* handle) {
  return static_cast<TlsServer*>(handle)->port;
}

extern "C" VtBatch* vt_tls_server_swap(void* handle) {
  TlsServer* srv = static_cast<TlsServer*>(handle);
  std::lock_guard<std::mutex> lock(srv->mu);
  VtBatch* filled = srv->active;
  vt_batch_reset(srv->standby);
  srv->active = srv->standby;
  srv->standby = filled;
  return filled;
}

extern "C" uint64_t vt_tls_server_conns(void* handle) {
  return static_cast<TlsServer*>(handle)
      ->conns.load(std::memory_order_relaxed);
}

extern "C" uint64_t vt_tls_server_handshake_failures(void* handle) {
  return static_cast<TlsServer*>(handle)
      ->handshake_failures.load(std::memory_order_relaxed);
}

extern "C" uint64_t vt_tls_server_drops(void* handle) {
  return static_cast<TlsServer*>(handle)
      ->dropped.load(std::memory_order_relaxed);
}

extern "C" void vt_tls_server_stop(void* handle) {
  TlsServer* srv = static_cast<TlsServer*>(handle);
  srv->stop.store(true);
  if (srv->acceptor.joinable()) srv->acceptor.join();
  close(srv->listen_fd);
  // connection threads are detached; they observe `stop` within one
  // 500ms read tick (a mid-handshake thread within the handshake
  // timeout) and decrement live_conns on exit. Wait bounded; if a
  // thread is still alive after that, LEAK the server struct — a
  // bounded leak at shutdown beats a use-after-free from a thread
  // still touching the batches.
  for (int i = 0; i < 1200 && srv->live_conns.load() > 0; i++) {
    usleep(10 * 1000);
  }
  if (srv->live_conns.load() > 0) {
    fprintf(stderr,
            "veneur-native: leaking TLS listener (%d connections still "
            "draining at shutdown)\n", srv->live_conns.load());
    return;
  }
  if (srv->ssl_ctx) ossl()->SSL_CTX_free(srv->ssl_ctx);
  vt_batch_free(srv->active);
  vt_batch_free(srv->standby);
  delete srv;
}
