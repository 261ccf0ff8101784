// The range coder of FFmpeg's rangecoder.h as the FFV1 and Snow decoders
// read it, bit for bit: ff_init_range_decoder, get_rac with the state
// transition table ff_build_rac_states(c, 0.05 * 2^32, 256 - 8) makes (or
// FFV1's custom one), and get_symbol.  A symbol longer than 32 bits calls
// Overlong, which the including decoder makes throw its own error.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace rangecoder {

template <void (*Overlong)()>
struct Coder {
    const uint8_t* start = nullptr;
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    uint32_t low = 0, range = 0;
    int overread = 0;
    uint8_t zero[256], one[256];

    // ff_init_range_decoder + ff_build_rac_states(c, 0.05 * 2^32, 256 - 8)
    void init(const uint8_t* buf, size_t n) {
        start = p = buf;
        end = buf + n;
        range = 0xFF00;
        low = n >= 2 ? uint32_t(buf[0]) << 8 | buf[1] : 0;
        p += 2;
        overread = 0;
        if (low >= 0xFF00) {
            low = 0xFF00;
            end = p;
        }
        build_states();
    }

    void build_states() {
        const int64_t one64 = int64_t(1) << 32;
        const int64_t factor = int64_t(0.05 * (int64_t(1) << 32));
        const int max_p = 256 - 8;
        std::memset(zero, 0, sizeof zero);
        std::memset(one, 0, sizeof one);
        int last_p8 = 0;
        int64_t prob = one64 / 2;
        for (int i = 0; i < 128; i++) {
            int p8 = int((256 * prob + one64 / 2) >> 32);
            if (p8 <= last_p8) p8 = last_p8 + 1;
            if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = uint8_t(p8);
            prob += ((one64 - prob) * factor + one64 / 2) >> 32;
            last_p8 = p8;
        }
        for (int i = 256 - max_p; i <= max_p; i++) {
            if (one[i]) continue;
            prob = (i * one64 + 128) >> 8;
            prob += ((one64 - prob) * factor + one64 / 2) >> 32;
            int p8 = int((256 * prob + one64 / 2) >> 32);
            if (p8 <= i) p8 = i + 1;
            if (p8 > max_p) p8 = max_p;
            one[i] = uint8_t(p8);
        }
        for (int i = 1; i < 255; i++) zero[i] = uint8_t(256 - one[256 - i]);
    }

    // ff_ffv1_init_slice_state's custom table
    void use_transition(const uint8_t* transition) {
        for (int i = 1; i < 256; i++) {
            one[i] = transition[i];
            zero[256 - i] = uint8_t(256 - one[i]);
        }
    }

    void refill() {
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (p < end)
                low += *p++;
            else
                overread++;
        }
    }

    int bit(uint8_t* state) {
        const uint32_t range1 = (range * *state) >> 8;
        range -= range1;
        if (low < range) {
            *state = zero[*state];
            refill();
            return 0;
        }
        low -= range;
        *state = one[*state];
        range = range1;
        refill();
        return 1;
    }

    // get_symbol_inline
    int symbol(uint8_t* state, bool is_signed) {
        if (bit(state + 0)) return 0;
        int e = 0;
        while (bit(state + 1 + std::min(e, 9))) {
            if (++e > 31) Overlong();
        }
        uint32_t a = 1;
        for (int i = e - 1; i >= 0; i--) a += a + bit(state + 22 + std::min(i, 9));
        const int neg = is_signed && bit(state + 11 + std::min(e, 10));
        return neg ? -int(a) : int(a);
    }
};

}  // namespace rangecoder
