// flink_tpu_torch batch codec (C ABI, loaded via ctypes).
//
// The port's own copy of the codec routines of the JAX package's native
// layer (native/flink_native.cc): the delta + zigzag + varint codec of
// int64 columns, the FLZ1 block compressor (LZ77, byte-oriented) and the
// CRC-32 (IEEE) and CRC-32C (Castagnoli) checksums, every symbol with the
// ``ftt_`` prefix.  The algorithms, tables and formats are the original's,
// so the same input gives the same bytes in both packages: a column block,
// a spill file or a frame written by one reads in the other.
//
// Built with g++ by flink_tpu_torch/kernels/build.py (codec_lib()); used by
// flink_tpu_torch/native (lz_compress, delta_varint_encode, crc32, ...),
// the batch codec (native/codec.py) and the formats (formats/__init__.py).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#define API extern "C" __attribute__((visibility("default")))

typedef int64_t i64;
typedef uint64_t u64;
typedef int32_t i32;
typedef uint32_t u32;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// varint / zigzag (delta codec for sorted int64 columns: timestamps, keys)
// ---------------------------------------------------------------------------

static inline u64 zigzag_enc(i64 v) { return ((u64)v << 1) ^ (u64)(v >> 63); }
static inline i64 zigzag_dec(u64 v) { return (i64)(v >> 1) ^ -(i64)(v & 1); }

static inline size_t varint_put(u8* out, u64 v) {
  size_t i = 0;
  while (v >= 0x80) { out[i++] = (u8)(v | 0x80); v >>= 7; }
  out[i++] = (u8)v;
  return i;
}

static inline size_t varint_get(const u8* in, const u8* end, u64* v) {
  u64 r = 0; int shift = 0; size_t i = 0;
  while (in + i < end) {
    u8 b = in[i++];
    r |= (u64)(b & 0x7f) << shift;
    if (!(b & 0x80)) { *v = r; return i; }
    shift += 7;
    if (shift > 63) break;
  }
  return 0;  // malformed
}

// Delta + zigzag + varint encode. Returns bytes written, or -1 if cap too
// small. Worst case 10 bytes/value.
API i64 ftt_delta_varint_encode_i64(const i64* vals, i64 n, u8* out, i64 cap) {
  i64 w = 0, prev = 0;
  for (i64 i = 0; i < n; i++) {
    if (w + 10 > cap) return -1;
    w += (i64)varint_put(out + w, zigzag_enc(vals[i] - prev));
    prev = vals[i];
  }
  return w;
}

// Returns bytes consumed, or -1 on malformed input.
API i64 ftt_delta_varint_decode_i64(const u8* in, i64 nbytes, i64 n, i64* out) {
  const u8* end = in + nbytes;
  i64 r = 0, prev = 0;
  for (i64 i = 0; i < n; i++) {
    u64 v;
    size_t c = varint_get(in + r, end, &v);
    if (c == 0) return -1;
    r += (i64)c;
    prev += zigzag_dec(v);
    out[i] = prev;
  }
  return r;
}

// ---------------------------------------------------------------------------
// FLZ block compression (LZ77, byte-oriented, format "FLZ1")
//
// Sequence = token byte (hi nibble literal-run len, lo nibble match len - 4,
// 15 => varint extension follows), literals, u16le offset, [ext match len].
// Final sequence carries literals only (match nibble unused, no offset).
// ---------------------------------------------------------------------------

static const int FLZ_HASH_LOG = 15;
static const u32 FLZ_MIN_MATCH = 4;

static inline u32 flz_hash(u32 seq) {
  return (seq * 2654435761u) >> (32 - FLZ_HASH_LOG);
}

static inline u32 read32(const u8* p) { u32 v; memcpy(&v, p, 4); return v; }

API i64 ftt_lz_bound(i64 n) { return n + n / 255 + 80; }

// Compress src[0..n) into dst (cap >= ftt_lz_bound(n)). Returns compressed
// size, or -1 on cap overflow.
API i64 ftt_lz_compress(const u8* src, i64 n, u8* dst, i64 cap) {
  std::vector<i64> table((size_t)1 << FLZ_HASH_LOG, -1);
  i64 ip = 0, anchor = 0, op = 0;
  const i64 mflimit = n - (i64)FLZ_MIN_MATCH;

  auto emit = [&](i64 lit_len, i64 match_len, i64 offset, bool final_seq) -> bool {
    // worst-case bytes for this sequence (varint extensions are <= 10 bytes)
    i64 need = 1 + lit_len + (lit_len >= 15 ? 10 : 0) + 12;
    if (op + need > cap) return false;
    u8* token = dst + op++;
    i64 ml = final_seq ? 0 : match_len - FLZ_MIN_MATCH;
    *token = (u8)(((lit_len < 15 ? lit_len : 15) << 4) |
                  (ml < 15 ? ml : 15));
    if (lit_len >= 15) op += (i64)varint_put(dst + op, (u64)(lit_len - 15));
    memcpy(dst + op, src + anchor, (size_t)lit_len);
    op += lit_len;
    if (!final_seq) {
      dst[op++] = (u8)(offset & 0xff);
      dst[op++] = (u8)(offset >> 8);
      if (ml >= 15) op += (i64)varint_put(dst + op, (u64)(ml - 15));
    }
    return true;
  };

  while (ip <= mflimit) {
    u32 h = flz_hash(read32(src + ip));
    i64 cand = table[h];
    table[h] = ip;
    if (cand >= 0 && ip - cand <= 0xffff && read32(src + cand) == read32(src + ip)) {
      // extend match
      i64 ml = FLZ_MIN_MATCH;
      while (ip + ml < n && src[cand + ml] == src[ip + ml]) ml++;
      if (!emit(ip - anchor, ml, ip - cand, false)) return -1;
      // index interior positions sparsely for better ratio on long matches
      for (i64 p = ip + 1; p + 4 <= ip + ml && p <= mflimit; p += 3)
        table[flz_hash(read32(src + p))] = p;
      ip += ml;
      anchor = ip;
    } else {
      ip++;
    }
  }
  if (!emit(n - anchor, 0, 0, true)) return -1;
  return op;
}

// Decompress into dst of exactly orig_n bytes. Returns orig_n, or -1 on
// malformed input.
API i64 ftt_lz_decompress(const u8* src, i64 n, u8* dst, i64 orig_n) {
  const u8* end = src + n;
  i64 ip = 0, op = 0;
  while (ip < n) {
    u8 token = src[ip++];
    i64 lit = token >> 4;
    if (lit == 15) {
      u64 ext; size_t c = varint_get(src + ip, end, &ext);
      if (!c) return -1;
      ip += (i64)c; lit = 15 + (i64)ext;
    }
    if (ip + lit > n || op + lit > orig_n) return -1;
    memcpy(dst + op, src + ip, (size_t)lit);
    ip += lit; op += lit;
    if (ip >= n) break;  // final literals-only sequence
    if (ip + 2 > n) return -1;
    i64 offset = src[ip] | ((i64)src[ip + 1] << 8);
    ip += 2;
    i64 ml = (token & 0x0f);
    if (ml == 15) {
      u64 ext; size_t c = varint_get(src + ip, end, &ext);
      if (!c) return -1;
      ip += (i64)c; ml = 15 + (i64)ext;
    }
    ml += FLZ_MIN_MATCH;
    if (offset == 0 || offset > op || op + ml > orig_n) return -1;
    // byte-wise copy: overlapping matches are the RLE case and must copy fwd
    for (i64 k = 0; k < ml; k++) dst[op + k] = dst[op + k - offset];
    op += ml;
  }
  return op == orig_n ? orig_n : -1;
}

// ---------------------------------------------------------------------------
// CRC32 (IEEE, table-driven) — checkpoint/log record integrity
// ---------------------------------------------------------------------------

static u32 crc_table[256];
static std::once_flag crc_once;

static void crc_init() {
  for (u32 i = 0; i < 256; i++) {
    u32 c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
}

API u32 ftt_crc32(const u8* data, i64 n, u32 seed) {
  std::call_once(crc_once, crc_init);
  u32 c = seed ^ 0xffffffffu;
  for (i64 i = 0; i < n; i++) c = crc_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// CRC32C (Castagnoli, reflected poly 0x82F63B78) — the checksum of Kafka's
// v2 record batches; slice-by-4 tables.
static u32 crc32c_table[4][256];
static std::once_flag crc32c_once;

static void crc32c_init() {
  for (u32 i = 0; i < 256; i++) {
    u32 c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
    crc32c_table[0][i] = c;
  }
  for (u32 i = 0; i < 256; i++)
    for (int t = 1; t < 4; t++)
      crc32c_table[t][i] =
          crc32c_table[t - 1][i] >> 8 ^
          crc32c_table[0][crc32c_table[t - 1][i] & 0xff];
}

API u32 ftt_crc32c(const u8* data, i64 n, u32 seed) {
  std::call_once(crc32c_once, crc32c_init);
  u32 c = seed ^ 0xffffffffu;
  i64 i = 0;
  for (; i + 4 <= n; i += 4) {
    c ^= (u32)data[i] | ((u32)data[i + 1] << 8) | ((u32)data[i + 2] << 16) |
         ((u32)data[i + 3] << 24);
    c = crc32c_table[3][c & 0xff] ^ crc32c_table[2][(c >> 8) & 0xff] ^
        crc32c_table[1][(c >> 16) & 0xff] ^ crc32c_table[0][c >> 24];
  }
  for (; i < n; i++)
    c = crc32c_table[0][(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}
