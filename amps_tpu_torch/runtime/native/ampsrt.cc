// ampsrt — native host runtime for amps_tpu_torch (a copy of
// amps_tpu/runtime/native/ampsrt.cc; nothing in it uses JAX or CUDA).
//
// The reference's L3 is the GNU Radio 3.7 scheduler: one thread per block
// with lock-free ring buffers between them (SURVEY.md §1 L3).  The device
// pipeline replaces the block graph, but the HOST side
// still needs native-speed plumbing around it:
//   * a lock-free SPSC ring buffer for IQ/symbol streaming between the
//     IO thread (SDR/file/socket) and the device-feeder thread;
//   * single-word BCH(63,51,t=2) encode/decode for the low-latency
//     control plane (no device dispatch on the host hot path);
//   * Manchester encode/decode and the exact memmem trigger scan
//     (lib/recc_impl.cc:118) as a bit-exact host fallback/validator.
//
// C ABI for ctypes.  Built at first use by amps_tpu_torch/runtime/native_rt.py
// (g++ -O3 -fPIC -shared -std=c++17) into amps_tpu_torch/build/.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// BCH(63,51,t=2), generator x^12+x^10+x^8+x^5+x^4+x^3+1 (TIA/EIA-553).
// Bit arrays are 1 byte/bit MSB-first, matching the reference in-memory
// format (lib/amps_packet.cc).
// ---------------------------------------------------------------------------

static const uint32_t kGenPoly = 0b1010100111001;  // degree 12, 13 bits
static const int kN = 63;
static const int kParity = 12;

// syndrome of a full 63-bit word given as bits[63]
static uint32_t syndrome63(const uint8_t* bits) {
  uint32_t rem = 0;
  for (int i = 0; i < kN; i++) {
    rem = (rem << 1) | (bits[i] & 1);
    if (rem & (1u << kParity)) rem ^= kGenPoly;
  }
  return rem & 0xFFFu;
}

// Decode tables: syndrome -> error positions (within the 63-bit word).
// Built lazily once; 4096 entries x 2 positions (-1 = none), valid flag.
static int16_t g_err_pos[4096][2];
static uint8_t g_err_valid[4096];
static std::atomic<int> g_tables_ready{0};

static void build_tables() {
  int expected = 0;
  if (!g_tables_ready.compare_exchange_strong(expected, 1)) {
    while (g_tables_ready.load() != 2) { /* spin */ }
    return;
  }
  memset(g_err_valid, 0, sizeof(g_err_valid));
  for (int i = 0; i < 4096; i++) { g_err_pos[i][0] = g_err_pos[i][1] = -1; }
  uint8_t bits[kN];
  memset(bits, 0, sizeof(bits));
  g_err_valid[0] = 1;  // zero syndrome
  for (int i = 0; i < kN; i++) {
    memset(bits, 0, sizeof(bits));
    bits[i] = 1;
    uint32_t s = syndrome63(bits);
    g_err_pos[s][0] = i;
    g_err_valid[s] = 1;
  }
  for (int i = 0; i < kN; i++) {
    for (int j = i + 1; j < kN; j++) {
      memset(bits, 0, sizeof(bits));
      bits[i] = 1;
      bits[j] = 1;
      uint32_t s = syndrome63(bits);
      if (!g_err_valid[s]) {
        g_err_pos[s][0] = i;
        g_err_pos[s][1] = j;
        g_err_valid[s] = 1;
      }
    }
  }
  g_tables_ready.store(2);
}

// Forward (40,28): 28 info bits -> 40 coded bits (23-zero-prefix
// shortening, lib/focc_impl.cc:157-176).
void amps_focc_bch_encode(const uint8_t* info28, uint8_t* out40) {
  uint8_t full[kN];
  memset(full, 0, sizeof(full));
  memcpy(full + 23, info28, 28);
  // parity = remainder of x^12 * m(x)
  uint32_t rem = 0;
  for (int i = 0; i < kN; i++) {
    int bit = (i < 51) ? full[i] : 0;
    rem = (rem << 1) | bit;
    if (rem & (1u << kParity)) rem ^= kGenPoly;
  }
  memcpy(out40, info28, 28);
  for (int i = 0; i < kParity; i++) {
    out40[28 + i] = (rem >> (kParity - 1 - i)) & 1;
  }
}

// Reverse (48,36) encode (mobile side; for simulators/tests).
void amps_recc_bch_encode(const uint8_t* info36, uint8_t* out48) {
  uint32_t rem = 0;
  for (int i = 0; i < kN; i++) {
    int bit = (i >= 15 && i < 51) ? info36[i - 15] : 0;
    rem = (rem << 1) | bit;
    if (rem & (1u << kParity)) rem ^= kGenPoly;
  }
  memcpy(out48, info36, 36);
  for (int i = 0; i < kParity; i++) {
    out48[36 + i] = (rem >> (kParity - 1 - i)) & 1;
  }
}

// Reverse (48,36) decode: returns 1 if correctable (<=2 errors over the
// full zero-padded 63-bit word — matching IT++/reference acceptance,
// lib/recc_decode_impl.cc:53-79), writes 36 corrected info bits.
int amps_recc_bch_decode(const uint8_t* rx48, uint8_t* out36) {
  build_tables();
  uint8_t full[kN];
  memset(full, 0, 15);
  memcpy(full + 15, rx48, 48);
  uint32_t s = syndrome63(full);
  if (!g_err_valid[s]) {
    memcpy(out36, rx48, 36);
    return 0;
  }
  for (int k = 0; k < 2; k++) {
    int pos = g_err_pos[s][k];
    if (pos >= 0) full[pos] ^= 1;
  }
  memcpy(out36, full + 15, 36);
  return 1;
}

// ---------------------------------------------------------------------------
// Manchester (conventions of lib/utils.cc:28 and lib/amps_packet.h:47)
// ---------------------------------------------------------------------------

// bits -> ±1 int8 symbols, sps repeats per half-symbol
void amps_manchester_encode(const uint8_t* bits, int nbits, int sps,
                            int8_t* out) {
  int o = 0;
  for (int i = 0; i < nbits; i++) {
    int8_t first = bits[i] ? -1 : 1;
    for (int j = 0; j < sps; j++) out[o++] = first;
    for (int j = 0; j < sps; j++) out[o++] = -first;
  }
}

// sliced 0/1 symbols -> bits; returns bad-pair count
int amps_manchester_decode(const uint8_t* syms, int nbits, uint8_t* out) {
  int bad = 0;
  for (int i = 0; i < nbits; i++) {
    uint8_t a = syms[2 * i] & 1, b = syms[2 * i + 1] & 1;
    out[i] = 1 - a;  // (1,0)->0 (0,1)->1 (1,1)->0+bad (0,0)->1+bad
    if (a == b) bad++;
  }
  return bad;
}

// Exact trigger scan (the reference's memmem, lib/recc_impl.cc:118):
// returns offset of first occurrence of needle in haystack or -1.
long amps_trigger_scan(const uint8_t* hay, long hay_len,
                       const uint8_t* needle, long needle_len) {
  if (needle_len <= 0 || hay_len < needle_len) return -1;
  const void* p = memmem(hay, (size_t)hay_len, needle, (size_t)needle_len);
  if (!p) return -1;
  return (long)((const uint8_t*)p - hay);
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer (the GR buffer replacement for host IO).
// ---------------------------------------------------------------------------

struct AmpsRing {
  uint8_t* data;
  size_t capacity;  // bytes, power of two
  std::atomic<size_t> head;  // write index (producer)
  std::atomic<size_t> tail;  // read index (consumer)
};

AmpsRing* amps_ring_create(size_t capacity_pow2) {
  if (capacity_pow2 == 0 || (capacity_pow2 & (capacity_pow2 - 1))) return nullptr;
  AmpsRing* r = new (std::nothrow) AmpsRing();
  if (!r) return nullptr;
  r->data = new (std::nothrow) uint8_t[capacity_pow2];
  if (!r->data) { delete r; return nullptr; }
  r->capacity = capacity_pow2;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void amps_ring_destroy(AmpsRing* r) {
  if (r) { delete[] r->data; delete r; }
}

size_t amps_ring_write_available(const AmpsRing* r) {
  return r->capacity - (r->head.load(std::memory_order_acquire)
                        - r->tail.load(std::memory_order_acquire));
}

size_t amps_ring_read_available(const AmpsRing* r) {
  return r->head.load(std::memory_order_acquire)
       - r->tail.load(std::memory_order_acquire);
}

// returns bytes written (may be < len if full)
size_t amps_ring_write(AmpsRing* r, const uint8_t* src, size_t len) {
  size_t head = r->head.load(std::memory_order_relaxed);
  size_t avail = r->capacity - (head - r->tail.load(std::memory_order_acquire));
  if (len > avail) len = avail;
  size_t mask = r->capacity - 1;
  size_t off = head & mask;
  size_t first = len < (r->capacity - off) ? len : (r->capacity - off);
  memcpy(r->data + off, src, first);
  memcpy(r->data, src + first, len - first);
  r->head.store(head + len, std::memory_order_release);
  return len;
}

// returns bytes read (may be < len if empty)
size_t amps_ring_read(AmpsRing* r, uint8_t* dst, size_t len) {
  size_t tail = r->tail.load(std::memory_order_relaxed);
  size_t avail = r->head.load(std::memory_order_acquire) - tail;
  if (len > avail) len = avail;
  size_t mask = r->capacity - 1;
  size_t off = tail & mask;
  size_t first = len < (r->capacity - off) ? len : (r->capacity - off);
  memcpy(dst, r->data + off, first);
  memcpy(dst + first, r->data, len - first);
  r->tail.store(tail + len, std::memory_order_release);
  return len;
}

}  // extern "C"
