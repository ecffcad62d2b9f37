// Native runtime helpers for dtc_tpu.
//
// The reference delegates all native work to Qiskit Aer / PennyLane
// Lightning C++ (SURVEY.md §2d). Our device compute path is XLA; this library
// covers the HOST-side runtime hot spots around it:
//   - measurement decoding: raw per-shot bit arrays -> <Z_q> (the reference
//     re-parses python dicts of bitstrings, autocorr-iqm-data-fix.py:42-60;
//     shot studies go to 1e6 shots where python-loop decoding dominates)
//   - disorder-ensemble generation (xoshiro256**): batch hs/phis sampling
//     for the L=4..130 x inst grids (generate_disorder.py batch loop)
//   - crash-safe append-only result journal (CRC32-framed records) backing
//     sweep checkpoint/resume — the binary analogue of the reference's
//     append-per-timestep CSV checkpointing (autocorr-delta-a-single-ibm-
//     energy.py:239-255)
//
// Build: make -C dtc_tpu/native (g++ -O3 -shared); loaded via ctypes with a
// pure-python fallback when no toolchain is present.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32 (reflected, poly 0xEDB88320) — table generated on first use.

static uint32_t crc_table[256];
static int crc_ready = 0;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_ready = 1;
}

uint32_t dtc_crc32(const uint8_t* data, uint64_t len) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Measurement decoding: bits[shot * nq + q] in {0,1} -> out[q] = <Z_q>.

int dtc_z_expectations(const uint8_t* bits, int64_t shots, int32_t nq,
                       double* out) {
  if (shots <= 0 || nq <= 0) return -1;
  int64_t* ones = new int64_t[nq]();
  for (int64_t s = 0; s < shots; s++) {
    const uint8_t* row = bits + s * nq;
    for (int32_t q = 0; q < nq; q++) ones[q] += row[q];
  }
  for (int32_t q = 0; q < nq; q++)
    out[q] = 1.0 - 2.0 * (double)ones[q] / (double)shots;
  delete[] ones;
  return 0;
}

// Histogram of packed bitstring keys (nq <= 64): out_keys/out_counts sized
// by caller to max_entries; returns number of distinct keys or -1 if more.
int64_t dtc_bit_histogram(const uint8_t* bits, int64_t shots, int32_t nq,
                          uint64_t* out_keys, int64_t* out_counts,
                          int64_t max_entries) {
  if (nq > 64) return -1;
  int64_t n = 0;
  for (int64_t s = 0; s < shots; s++) {
    const uint8_t* row = bits + s * nq;
    uint64_t key = 0;
    for (int32_t q = 0; q < nq; q++) key |= ((uint64_t)(row[q] & 1)) << q;
    // linear probe over collected keys (counts are tiny for low-entropy
    // measurement records; callers with huge key spaces use python dicts)
    int64_t i = 0;
    for (; i < n; i++)
      if (out_keys[i] == key) { out_counts[i]++; break; }
    if (i == n) {
      if (n == max_entries) return -1;
      out_keys[n] = key;
      out_counts[n] = 1;
      n++;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// xoshiro256** disorder generation.

static inline uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }

struct Xo {
  uint64_t s[4];
};

static uint64_t splitmix(uint64_t* x) {
  uint64_t z = (*x += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

static void xo_seed(Xo* st, uint64_t seed) {
  for (int i = 0; i < 4; i++) st->s[i] = splitmix(&seed);
}

static uint64_t xo_next(Xo* st) {
  uint64_t* s = st->s;
  uint64_t result = rotl(s[1] * 5, 7) * 9;
  uint64_t t = s[1] << 17;
  s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
  s[3] = rotl(s[3], 45);
  return result;
}

static double xo_uniform(Xo* st) {  // [0, 1)
  return (double)(xo_next(st) >> 11) * (1.0 / 9007199254740992.0);
}

// hs ~ U[-pi, pi) (inst x L); phis ~ U[0, amplitude*pi) - 1.5pi + delta*pi
// (inst x (L-1)), or fixed -0.4 when randomphi == 0.
int dtc_generate_disorder(uint64_t seed, int32_t L, int32_t inst,
                          double amplitude, double delta, int32_t randomphi,
                          double* hs, double* phis) {
  const double PI = 3.14159265358979323846;
  Xo st;
  xo_seed(&st, seed);
  for (int64_t i = 0; i < (int64_t)inst * L; i++)
    hs[i] = xo_uniform(&st) * 2.0 * PI - PI;
  for (int64_t i = 0; i < (int64_t)inst * (L - 1); i++)
    phis[i] = randomphi
                  ? xo_uniform(&st) * amplitude * PI - 1.5 * PI + delta * PI
                  : -0.4;
  return 0;
}

// ---------------------------------------------------------------------------
// Append-only CRC-framed journal.
// Record layout: "DTCJ" | u32 keylen | u64 datalen | u32 crc32(data) |
//                key bytes | data bytes

int dtc_journal_append(const char* path, const char* key, const uint8_t* data,
                       uint64_t len, int32_t do_flush) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  uint32_t keylen = (uint32_t)strlen(key);
  uint32_t crc = dtc_crc32(data, len);
  int ok = 1;
  ok &= fwrite("DTCJ", 1, 4, f) == 4;
  ok &= fwrite(&keylen, 4, 1, f) == 1;
  ok &= fwrite(&len, 8, 1, f) == 1;
  ok &= fwrite(&crc, 4, 1, f) == 1;
  ok &= fwrite(key, 1, keylen, f) == keylen;
  ok &= fwrite(data, 1, len, f) == len;
  if (do_flush) fflush(f);
  fclose(f);
  return ok ? 0 : -2;
}

}  // extern "C"
