// pypio — native I/O hot paths for pyp_tpu, exposed via a C ABI (ctypes).
//
// The reference ships its host-side hot loops as external binaries; here the
// host-side costs that matter on a TPU VM are (a) TIFF LZW decode of
// counting-camera movies (GB/s of compressed frames per dataset) and
// (b) streaming MRC stack merges (the merge3d dump-file concatenation,
// pyp/inout/image/mrc.py:643 merge_fast). Python-level
// LZW is ~100x too slow; this library decodes at memory speed.
//
// Build: make -C native/pypio   ->  libpypio.so
// Python binding: pyp_tpu/io/native.py (ctypes, with pure-Python fallback).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// TIFF-variant LZW (MSB-first codes, EarlyChange). Returns bytes written,
// or -1 if the output buffer is too small / the stream is corrupt.
long lzw_decode(const uint8_t* src, long src_len, uint8_t* dst, long dst_cap) {
    constexpr int CLEAR = 256, EOI = 257;
    // table entries: (prev_code, byte); strings materialized by walking back
    std::vector<int32_t> prev(4096);
    std::vector<uint8_t> last(4096);
    std::vector<int16_t> length(4096);
    auto reset = [&]() {
        for (int i = 0; i < 256; i++) {
            prev[i] = -1;
            last[i] = static_cast<uint8_t>(i);
            length[i] = 1;
        }
    };
    reset();
    int next_code = 258;
    int code_size = 9;

    uint64_t bitbuf = 0;
    int bitcnt = 0;
    long pos = 0;
    long out = 0;
    int prev_code = -1;
    std::vector<uint8_t> scratch(4096);

    auto emit = [&](int code) -> int {
        int n = length[code];
        if (out + n > dst_cap) return -1;
        int c = code;
        for (int i = n - 1; i >= 0; i--) {
            scratch[i] = last[c];
            c = prev[c];
        }
        std::memcpy(dst + out, scratch.data(), n);
        out += n;
        return n;
    };

    while (true) {
        while (bitcnt < code_size && pos < src_len) {
            bitbuf = (bitbuf << 8) | src[pos++];
            bitcnt += 8;
        }
        if (bitcnt < code_size) break;
        int code = static_cast<int>((bitbuf >> (bitcnt - code_size)) &
                                    ((1u << code_size) - 1));
        bitcnt -= code_size;

        if (code == CLEAR) {
            reset();
            next_code = 258;
            code_size = 9;
            prev_code = -1;
            continue;
        }
        if (code == EOI) break;

        if (prev_code < 0) {
            if (code >= 256) return -1;
            if (emit(code) < 0) return -1;
            prev_code = code;
            continue;
        }
        if (code < next_code) {
            if (emit(code) < 0) return -1;
            if (next_code < 4096) {
                prev[next_code] = prev_code;
                // first byte of `code`'s string
                int c = code;
                while (prev[c] >= 0) c = prev[c];
                last[next_code] = last[c];
                length[next_code] = static_cast<int16_t>(length[prev_code] + 1);
                next_code++;
            }
        } else if (code == next_code && next_code < 4096) {
            int c = prev_code;
            while (prev[c] >= 0) c = prev[c];
            prev[next_code] = prev_code;
            last[next_code] = last[c];
            length[next_code] = static_cast<int16_t>(length[prev_code] + 1);
            next_code++;
            if (emit(code) < 0) return -1;
        } else {
            return -1;  // corrupt stream
        }
        prev_code = code;
        if (next_code + 1 >= (1 << code_size) && code_size < 12) code_size++;
    }
    return out;
}

// Horizontal-differencing predictor undo for 16-bit rows (TIFF predictor 2).
void undiff_rows_u16(uint16_t* data, long rows, long cols) {
    for (long r = 0; r < rows; r++) {
        uint16_t* row = data + r * cols;
        for (long c = 1; c < cols; c++) row[c] = static_cast<uint16_t>(row[c] + row[c - 1]);
    }
}
void undiff_rows_u8(uint8_t* data, long rows, long cols) {
    for (long r = 0; r < rows; r++) {
        uint8_t* row = data + r * cols;
        for (long c = 1; c < cols; c++) row[c] = static_cast<uint8_t>(row[c] + row[c - 1]);
    }
}

// Streaming concatenation of MRC data sections: copy `count` bytes from
// src (at offset) into dst (at offset). Plain but avoids Python loops.
long copy_section(const char* src_path, long src_off, const char* dst_path,
                  long dst_off, long count) {
    FILE* in = fopen(src_path, "rb");
    if (!in) return -1;
    FILE* out = fopen(dst_path, "r+b");
    if (!out) {
        out = fopen(dst_path, "wb");
        if (!out) { fclose(in); return -1; }
    }
    if (fseek(in, src_off, SEEK_SET) || fseek(out, dst_off, SEEK_SET)) {
        fclose(in); fclose(out); return -1;
    }
    std::vector<char> buf(1 << 22);
    long done = 0;
    while (done < count) {
        long chunk = std::min<long>(count - done, buf.size());
        size_t got = fread(buf.data(), 1, chunk, in);
        if (got == 0) break;
        if (fwrite(buf.data(), 1, got, out) != got) break;
        done += static_cast<long>(got);
    }
    fclose(in);
    fclose(out);
    return done;
}

}  // extern "C"
