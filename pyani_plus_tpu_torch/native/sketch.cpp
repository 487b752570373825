// Native host-side sketching kernels for pyani-plus-tpu.
//
// Replaces the hot host loops of FracMinHash sketching (canonical k-mer
// MurmurHash3 x64-128 + scaled filter) -- the ingestion-side analogue of
// the Rust core inside sourmash/branchwater that the reference shells out
// to (SURVEY.md section 2.2). Device-side scoring stays in JAX/Pallas.
//
// MurmurHash3 is public domain (Austin Appleby); implementation below
// follows the published algorithm.
//
// Layout strategy: the sequence is decoded ONCE into contiguous forward
// and reverse-complement byte arrays (overallocated by 16 so the tail
// loads below may read past the logical end), so each k-mer hash is a
// murmur over a contiguous slice -- no per-k-mer byte translation loop.
// The canonical-strand choice selects a pointer branchlessly. Long
// inputs split across a worker thread per core (outputs stitched back
// in position order).
//
// Build: g++ -O3 -march=native -shared -fPIC sketch.cpp -o libsketch.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static inline uint64_t load64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian host assumed
}

// MurmurHash3 x64-128, first 64 bits. Requires the buffer to be
// readable for ((len+15)/16)*16 bytes (callers overallocate).
static inline uint64_t murmur3_x64_128_low(const uint8_t *data, int len,
                                           uint32_t seed) {
  const int nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (int i = 0; i < nblocks; i++) {
    uint64_t k1 = load64(data + i * 16);
    uint64_t k2 = load64(data + i * 16 + 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t *tail = data + nblocks * 16;
  const int rem = len & 15;
  if (rem > 8) {
    const int r2 = rem - 8;
    uint64_t k2 = load64(tail + 8) & ((1ULL << (8 * r2)) - 1);
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    uint64_t k1 = load64(tail);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  } else if (rem == 8) {
    uint64_t k1 = load64(tail);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  } else if (rem > 0) {
    uint64_t k1 = load64(tail) & ((1ULL << (8 * rem)) - 1);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= (uint64_t)len;
  h2 ^= (uint64_t)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  return h1;
}

namespace {

// Hash every valid k-mer whose END index i lies in [i_begin, i_end);
// append retained hashes to out (position order).
void sketch_range(const uint8_t *codes, int64_t n, int k,
                  const uint8_t *fwd_bytes, const uint8_t *rc_bytes,
                  uint64_t max_hash, uint32_t seed, int64_t i_begin,
                  int64_t i_end, std::vector<uint64_t> &out) {
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  uint64_t fwd = 0, rc = 0;
  int valid_run = 0;
  // Size for the expected retention rate (plus slack); push_back still
  // grows correctly on unusually dense regions.
  const double keep = (double)max_hash / (double)UINT64_MAX;
  out.reserve((size_t)((i_end - i_begin) * std::min(1.0, keep * 1.5) + 1024));
  // Warm up the rolling state from k-1 positions before the range.
  int64_t warm = i_begin - (k - 1);
  if (warm < 0) warm = 0;
  for (int64_t i = warm; i < i_end; i++) {
    const uint8_t c = codes[i];
    if (c >= 4) {
      valid_run = 0;
      continue;
    }
    valid_run++;
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | (((uint64_t)(3 - c)) << (2 * (k - 1)));
    if (valid_run < k || i < i_begin) continue;
    const int64_t p = i - k + 1;
    const uint8_t *ptr =
        (fwd <= rc) ? fwd_bytes + p : rc_bytes + (n - p - k);
    const uint64_t h = murmur3_x64_128_low(ptr, k, seed);
    if (h <= max_hash) out.push_back(h);
  }
}

}  // namespace

extern "C" {

// Canonical-kmer FracMinHash over a code array (0..3 = ACGT, >=4 masked).
// Writes retained (<= max_hash) hashes of the lexicographically smaller of
// each valid k-mer and its reverse complement. Returns the number written
// (never more than out_cap; excess is silently dropped -- caller sizes
// out generously and checks).
int64_t sketch_codes(const uint8_t *codes, int64_t n, int k,
                     uint64_t max_hash, uint32_t seed, uint64_t *out,
                     int64_t out_cap) {
  if (n < k || k > 32) return 0;
  static const char BASE[4] = {'A', 'C', 'G', 'T'};
  static const char CBASE[4] = {'T', 'G', 'C', 'A'};

  // Decode once; +16 slack so masked 8-byte tail loads stay in bounds.
  std::vector<uint8_t> fwd_bytes(n + 16), rc_bytes(n + 16);
  for (int64_t i = 0; i < n; i++) {
    fwd_bytes[i] = (uint8_t)BASE[codes[i] & 3];
    rc_bytes[i] = (uint8_t)CBASE[codes[n - 1 - i] & 3];
  }

  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = (n >= (int64_t)1 << 21 && hw > 1) ? (int)hw : 1;
  if (n_threads > 8) n_threads = 8;

  std::vector<std::vector<uint64_t>> parts(n_threads);
  if (n_threads == 1) {
    sketch_range(codes, n, k, fwd_bytes.data(), rc_bytes.data(), max_hash,
                 seed, 0, n, parts[0]);
  } else {
    std::vector<std::thread> workers;
    const int64_t step = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      const int64_t b = t * step;
      const int64_t e = std::min<int64_t>(n, b + step);
      workers.emplace_back(sketch_range, codes, n, k, fwd_bytes.data(),
                           rc_bytes.data(), max_hash, seed, b, e,
                           std::ref(parts[t]));
    }
    for (auto &w : workers) w.join();
  }

  int64_t count = 0;
  for (auto &part : parts) {
    const int64_t take =
        std::min<int64_t>((int64_t)part.size(), out_cap - count);
    if (take > 0) {
      std::memcpy(out + count, part.data(), take * sizeof(uint64_t));
      count += take;
    }
  }
  return count;
}

// Plain canonical-kmer murmur64 of every valid window (no filter), for
// parity testing against the numpy/JAX paths.
int64_t hash_codes(const uint8_t *codes, int64_t n, int k, uint32_t seed,
                   uint64_t *out, int64_t out_cap) {
  return sketch_codes(codes, n, k, ~0ULL, seed, out, out_cap);
}

}  // extern "C"
