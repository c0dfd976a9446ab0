// Native host-side runtime for deflate_rs_tpu.
//
// The device owns the compute path (LZ77/Huffman/bit packing as JAX);
// this library covers the host-side serial tail, the role the reference's
// Rust fills outside the compressor core:
//   * ordered assembly of per-chunk bitstreams into one output buffer
//   * bit-level splicing (for the packed, sync-marker-free concatenation)
//   * slice-by-8 CRC-32 and Adler-32 for host-side verification paths
//
// Exposed as a plain C ABI consumed via ctypes (runtime/native.py); every
// entry point has a pure-Python fallback, so the library is an accelerator,
// not a hard dependency.

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// Ordered chunk assembly: gather variable-length chunk payloads (each stored
// in a fixed-stride words buffer) into a contiguous stream.
// ---------------------------------------------------------------------------
// Returns 0 on success, -1 if any nbytes[i] is outside [0, stride] — in
// which case nothing is written (a clamped copy would silently desync the
// output offsets from the caller's cumulative-size bookkeeping).
int64_t assemble_chunks(uint8_t* dst,
                        const uint8_t* words,   // [n_chunks * stride] bytes
                        int64_t stride,         // bytes per chunk slot
                        const int64_t* nbytes,  // [n_chunks]
                        int64_t n_chunks) {
    for (int64_t i = 0; i < n_chunks; ++i)
        if (nbytes[i] < 0 || nbytes[i] > stride) return -1;
    int64_t off = 0;
    for (int64_t i = 0; i < n_chunks; ++i) {
        std::memcpy(dst + off, words + i * stride, (size_t)nbytes[i]);
        off += nbytes[i];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Bit-level append: copy src_bits bits from src onto dst starting at bit
// position dst_bits (LSB-first bit order, matching DEFLATE).  Returns the new
// total bit length.  dst must have room for the result; bits beyond the
// current end of dst must be zero (the encoder zero-pads).
// ---------------------------------------------------------------------------
int64_t bit_append(uint8_t* dst, int64_t dst_bits,
                   const uint8_t* src, int64_t src_bits) {
    int shift = (int)(dst_bits & 7);
    int64_t dst_byte = dst_bits >> 3;
    int64_t src_bytes = (src_bits + 7) >> 3;
    if (shift == 0) {
        std::memcpy(dst + dst_byte, src, (size_t)src_bytes);
        return dst_bits + src_bits;
    }
    uint8_t carry = dst[dst_byte] & (uint8_t)((1u << shift) - 1);
    for (int64_t i = 0; i < src_bytes; ++i) {
        uint16_t v = (uint16_t)(((uint16_t)src[i] << shift) | carry);
        dst[dst_byte + i] = (uint8_t)(v & 0xFF);
        carry = (uint8_t)(v >> 8);
    }
    dst[dst_byte + src_bytes] = carry;
    return dst_bits + src_bits;
}

// ---------------------------------------------------------------------------
// Slice-by-8 CRC-32 (reflected, poly 0xEDB88320), zlib-compatible register
// convention: pass crc = crc32_so_far (0 for a fresh stream); no final xor
// handling here (callers use the standard init/final xor).
// ---------------------------------------------------------------------------
static uint32_t crc_tab[8][256];

static void crc_init() {
    for (uint32_t b = 0; b < 256; ++b) {
        uint32_t c = b;
        for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0xEDB88320u : 0u);
        crc_tab[0][b] = c;
    }
    for (uint32_t b = 0; b < 256; ++b)
        for (int t = 1; t < 8; ++t)
            crc_tab[t][b] = (crc_tab[t - 1][b] >> 8) ^ crc_tab[0][crc_tab[t - 1][b] & 0xFF];
}

// Tables are built once by the dynamic loader (dlopen runs static
// constructors before returning, single-threaded) — no lazy-init flag, no
// data race when two threads make their first crc32_raw call concurrently.
static struct CrcTablesInit { CrcTablesInit() { crc_init(); } } crc_tables_init_;

uint32_t crc32_raw(const uint8_t* data, int64_t len, uint32_t crc) {
    const uint8_t* p = data;
    while (len >= 8) {
        crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
               ((uint32_t)p[3] << 24);
        uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) | ((uint32_t)p[6] << 16) |
                      ((uint32_t)p[7] << 24);
        crc = crc_tab[7][crc & 0xFF] ^ crc_tab[6][(crc >> 8) & 0xFF] ^
              crc_tab[5][(crc >> 16) & 0xFF] ^ crc_tab[4][crc >> 24] ^
              crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
              crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
        p += 8;
        len -= 8;
    }
    while (len--) crc = (crc >> 8) ^ crc_tab[0][(crc ^ *p++) & 0xFF];
    return crc;
}

// ---------------------------------------------------------------------------
// Adler-32 with deferred modulo (zlib-style NMAX batching).
// ---------------------------------------------------------------------------
uint32_t adler32(const uint8_t* data, int64_t len, uint32_t adler) {
    const uint32_t MOD = 65521;
    uint32_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
    while (len > 0) {
        int64_t n = len > 5552 ? 5552 : len;
        len -= n;
        while (n--) {
            a += *data++;
            b += a;
        }
        a %= MOD;
        b %= MOD;
    }
    return (b << 16) | a;
}

}  // extern "C"
