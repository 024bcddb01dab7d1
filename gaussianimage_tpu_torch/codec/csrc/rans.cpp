// rANS (range asymmetric numeral system) stack coder: host-side entropy
// coding of int symbol streams with a categorical model; 32-bit state,
// 16-bit renormalisation words, 16-bit quantized frequencies (scale_bits =
// 16). The port's own copy of gaussianimage_tpu/csrc/rans.cpp, the native
// equivalent of the reference's constriction.stream.stack.AnsCoder
// (reference usage at quantize.py:152-180); its streams are bit-identical
// to the JAX package's.
//
// Stack (LIFO) semantics: symbols are encoded in reverse by the caller so the
// decoder emits them in forward order. The Python wrapper (codec/rans.py)
// holds the bit-identical NumPy version, which the tests decode against.

#include <cstdint>
#include <cstring>

extern "C" {

// freqs: [num_sym] quantized frequencies summing to exactly 1<<16, all >= 1
// for symbols that occur. symbols: indices into the freq table, encoded in
// the given order (caller reverses). Returns number of uint16 words written
// (including 2 final state words), or -1 if out_cap exceeded.
int rans_encode(const int32_t* symbols, int n,
                const uint32_t* freqs, const uint32_t* cumfreqs, int num_sym,
                uint16_t* out, int out_cap) {
    uint32_t x = 1u << 16;  // lower bound L
    int pos = 0;
    for (int i = 0; i < n; ++i) {
        int32_t s = symbols[i];
        if (s < 0 || s >= num_sym) return -2;
        uint32_t f = freqs[s];
        uint32_t c = cumfreqs[s];
        if (f == 0) return -3;
        // renormalize: keep x < f << 16 before encoding (64-bit compare:
        // f can be up to 1<<16, so f << 16 may not fit in uint32)
        while ((uint64_t)x >= ((uint64_t)f << 16)) {
            if (pos >= out_cap) return -1;
            out[pos++] = (uint16_t)(x & 0xffffu);
            x >>= 16;
        }
        x = ((x / f) << 16) + (x % f) + c;
    }
    // flush 32-bit final state (low word first)
    if (pos + 2 > out_cap) return -1;
    out[pos++] = (uint16_t)(x & 0xffffu);
    out[pos++] = (uint16_t)(x >> 16);
    return pos;
}

// words: output of rans_encode (length n_words). Decodes n symbols (in the
// reverse order of encoding). Returns 0 on success.
int rans_decode(const uint16_t* words, int n_words,
                const uint32_t* freqs, const uint32_t* cumfreqs, int num_sym,
                int32_t* out_symbols, int n) {
    if (n_words < 2) return -1;
    int pos = n_words;
    uint32_t x = ((uint32_t)words[--pos]) << 16;
    x |= words[--pos];
    for (int i = 0; i < n; ++i) {
        uint32_t slot = x & 0xffffu;
        // linear scan is fine: num_sym <= 64 in every reference config
        int s = num_sym - 1;
        for (int k = 1; k < num_sym; ++k) {
            if (cumfreqs[k] > slot) { s = k - 1; break; }
        }
        uint32_t f = freqs[s];
        uint32_t c = cumfreqs[s];
        out_symbols[i] = s;
        x = f * (x >> 16) + slot - c;
        while (x < (1u << 16)) {
            if (pos == 0) return -2;  // malformed stream
            x = (x << 16) | words[--pos];
        }
    }
    return 0;
}

}  // extern "C"
