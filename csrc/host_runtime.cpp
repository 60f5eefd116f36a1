// arrow_tpu C++ host runtime.
//
// Native host-side tier mirroring the reference's Rust host code: the
// bit-packing loops of BooleanBufferBuilder
// (crates/array/src/array/null_bit_buffer.rs:10-62) and the
// from_optional_slice upload path (primitive_array_gpu.rs:22-55).  Exposed via
// a plain C ABI consumed through ctypes (arrow_tpu/runtime/native.py).
//
// Build: make -C csrc    (produces libarrowtpu_host.so)

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// bool bytes[n] -> LSB-first uint32 words (Arrow validity layout).
// `out` must hold at least ceil(n/32) words and be zero-initialized beyond n.
void atpu_pack_bits(const uint8_t* mask, size_t n, uint32_t* out) {
    size_t full = n / 8;
    const uint8_t* m = mask;
    uint8_t* ob = reinterpret_cast<uint8_t*>(out);
    for (size_t i = 0; i < full; ++i) {
        uint8_t b = 0;
        b |= (m[0] != 0) << 0;
        b |= (m[1] != 0) << 1;
        b |= (m[2] != 0) << 2;
        b |= (m[3] != 0) << 3;
        b |= (m[4] != 0) << 4;
        b |= (m[5] != 0) << 5;
        b |= (m[6] != 0) << 6;
        b |= (m[7] != 0) << 7;
        ob[i] = b;
        m += 8;
    }
    size_t rem = n % 8;
    if (rem) {
        uint8_t b = 0;
        for (size_t j = 0; j < rem; ++j) b |= (m[j] != 0) << j;
        ob[full] = b;
    }
}

// LSB-first uint32 words -> bool bytes[n].
void atpu_unpack_bits(const uint32_t* words, size_t n, uint8_t* out) {
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(words);
    size_t full = n / 8;
    for (size_t i = 0; i < full; ++i) {
        uint8_t b = wb[i];
        uint8_t* o = out + i * 8;
        o[0] = (b >> 0) & 1;
        o[1] = (b >> 1) & 1;
        o[2] = (b >> 2) & 1;
        o[3] = (b >> 3) & 1;
        o[4] = (b >> 4) & 1;
        o[5] = (b >> 5) & 1;
        o[6] = (b >> 6) & 1;
        o[7] = (b >> 7) & 1;
    }
    size_t rem = n % 8;
    if (rem) {
        uint8_t b = wb[full];
        uint8_t* o = out + full * 8;
        for (size_t j = 0; j < rem; ++j) o[j] = (b >> j) & 1;
    }
}

// popcount over a word buffer (validity null_count support).
uint64_t atpu_popcount(const uint32_t* words, size_t n_words) {
    uint64_t total = 0;
    for (size_t i = 0; i < n_words; ++i) total += __builtin_popcount(words[i]);
    return total;
}

// AND-merge two validity word buffers (null_bit_buffer.rs:168-204 host analog).
void atpu_and_words(const uint32_t* a, const uint32_t* b, size_t n_words,
                    uint32_t* out) {
    for (size_t i = 0; i < n_words; ++i) out[i] = a[i] & b[i];
}

}  // extern "C"
