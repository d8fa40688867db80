// GIF-flavored LZW decoder — the native fast path for the byte-serial
// inner loop that NumPy cannot vectorize (same split as pngfilter.cpp /
// jpegdec.cpp: Python parses the container, C++ runs the bit-serial
// decode).  Mirrors formats._lzw_decode exactly, including deferred
// clear codes, the KwKwK case, early-EOI, and truncation handling.
//
// Returns the number of pixels decoded (== npixels on success);
// negative on corrupt streams:
//   -1  first code after clear is not a literal
//   -2  code beyond next_code (corrupt dictionary reference)
// A short (truncated) stream simply returns n_out < npixels, which the
// Python caller converts to FormatError (same message as the pure path).

#include <cstdint>
#include <cstring>

extern "C" long gif_lzw_decode(const uint8_t *data, long nbytes,
                               int min_code_size, uint8_t *out,
                               long npixels) {
    if (min_code_size < 1 || min_code_size > 11) return -3;  // defense in depth
    const int clear = 1 << min_code_size;
    const int eoi = clear + 1;
    static thread_local int16_t prefix[4096];
    static thread_local uint8_t tail[4096];
    static thread_local uint8_t first[4096];
    static thread_local uint8_t stack[4097];
    for (int c = 0; c < clear; ++c) {
        prefix[c] = -1;
        tail[c] = first[c] = (uint8_t)c;
    }

    long bitpos = 0;
    const long total_bits = nbytes * 8;
    int code_size = min_code_size + 1;
    int next_code = eoi + 1;
    int prev = -1;
    long n_out = 0;

    while (n_out < npixels) {
        // read one code (synthetic EOI past the end, like the Python path)
        int code;
        if (bitpos + code_size > total_bits) {
            code = eoi;
        } else {
            long byte0 = bitpos >> 3;
            uint32_t v = data[byte0];
            if (byte0 + 1 < nbytes) v |= (uint32_t)data[byte0 + 1] << 8;
            if (byte0 + 2 < nbytes) v |= (uint32_t)data[byte0 + 2] << 16;
            code = (int)((v >> (bitpos & 7)) & ((1u << code_size) - 1));
            bitpos += code_size;
        }

        if (code == clear) {
            code_size = min_code_size + 1;
            next_code = eoi + 1;
            prev = -1;
            continue;
        }
        if (code == eoi) break;
        if (prev < 0) {
            if (code >= clear) return -1;
            out[n_out++] = first[code];
            prev = code;
            continue;
        }
        int sp = 0;
        uint8_t new_tail;
        if (code < next_code) {
            for (int c = code; c >= 0; c = prefix[c]) stack[sp++] = tail[c];
            new_tail = stack[sp - 1];
        } else if (code == next_code) {  // KwKwK
            stack[sp++] = first[prev];
            for (int c = prev; c >= 0; c = prefix[c]) stack[sp++] = tail[c];
            new_tail = stack[sp - 1];
        } else {
            return -2;
        }
        // stack holds the sequence reversed; emit up to npixels
        long n = sp;
        if (n > npixels - n_out) n = npixels - n_out;
        for (long i = 0; i < n; ++i) out[n_out + i] = stack[sp - 1 - i];
        n_out += n;
        if (next_code < 4096) {
            prefix[next_code] = (int16_t)prev;
            tail[next_code] = new_tail;
            first[next_code] = first[prev];
            ++next_code;
            if (next_code == (1 << code_size) && code_size < 12)
                ++code_size;
        }
        prev = code;
    }
    return n_out;
}

// GIF-flavored LZW encoder — the write-side twin (same split: Python owns
// the container, C++ the bit-serial loop).  Emits CLEAR up front, variable
// width codes bumped exactly where formats._lzw_decode/gif_lzw_decode bump
// theirs (after adding an entry, when next_code reaches 1<<code_size), and
// a CLEAR + dictionary reset when the table fills at 4096.  Returns bytes
// written, or -1 if out_cap is too small (caller sizes 3*n/2 + 256).
extern "C" long gif_lzw_encode(const uint8_t *idx, long npixels,
                               int min_code_size, uint8_t *out,
                               long out_cap) {
    if (min_code_size < 2 || min_code_size > 11) return -2;
    const int clear = 1 << min_code_size;
    const int eoi = clear + 1;
    // child[prev*256 + byte] = code+1 (0 = absent)
    static thread_local int16_t child[4096 * 256];
    memset(child, 0, sizeof(child));

    uint32_t acc = 0;
    int nbits = 0;
    long n_out = 0;
    int code_size = min_code_size + 1;
    int next_code = eoi + 1;

#define EMIT(c)                                            \
    do {                                                   \
        acc |= (uint32_t)(c) << nbits;                     \
        nbits += code_size;                                \
        while (nbits >= 8) {                               \
            if (n_out >= out_cap) return -1;               \
            out[n_out++] = (uint8_t)(acc & 0xff);          \
            acc >>= 8;                                     \
            nbits -= 8;                                    \
        }                                                  \
    } while (0)

    EMIT(clear);
    if (npixels > 0) {
        int prev = idx[0];
        for (long i = 1; i < npixels; ++i) {
            const int b = idx[i];
            const long key = (long)prev * 256 + b;
            if (child[key]) {
                prev = child[key] - 1;
                continue;
            }
            EMIT(prev);
            if (next_code < 4096) {
                child[key] = (int16_t)(next_code + 1);
                ++next_code;
                // DELAYED bump (encoder side): the decoder adds its k-th
                // entry one code read later than we do, so it widens one
                // code later — widen only once next_code EXCEEDS the
                // current width's range
                if (next_code == (1 << code_size) + 1 && code_size < 12)
                    ++code_size;
            } else {
                EMIT(clear);
                memset(child, 0, sizeof(child));
                next_code = eoi + 1;
                code_size = min_code_size + 1;
            }
            prev = b;
        }
        EMIT(prev);
    }
    EMIT(eoi);
#undef EMIT
    if (nbits > 0) {
        if (n_out >= out_cap) return -1;
        out[n_out++] = (uint8_t)(acc & 0xff);
    }
    return n_out;
}
