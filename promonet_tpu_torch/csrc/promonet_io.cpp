// Native WAV chunk decoder of the PyTorch port's training loader.
//
// The port's copy of native/promonet_io.cpp: WAV chunk decoding and batch
// assembly run here, off the Python GIL, with an internal thread pool.
// Python binds via ctypes (promonet_tpu_torch/data/native.py), which
// builds this file with g++ into build/native/ at first use.
//
// Supported input: 16-bit PCM RIFF/WAVE (the cache format written by
// utils.audio.save). Reads seek directly to the sample range needed for a
// training chunk, so a 16 kB crop of a long file costs one small read
// instead of a full decode.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
    uint32_t data_offset = 0;
    uint32_t data_bytes = 0;
    uint16_t channels = 0;
    uint16_t bits = 0;
    uint32_t sample_rate = 0;
};

// Parse RIFF chunks to locate fmt/data. Returns false on malformed input.
bool parse_header(FILE* file, WavInfo* info) {
    uint8_t riff[12];
    if (fread(riff, 1, 12, file) != 12) return false;
    if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
        return false;

    uint32_t offset = 12;
    for (;;) {
        uint8_t header[8];
        if (fseek(file, offset, SEEK_SET) != 0) return false;
        if (fread(header, 1, 8, file) != 8) return false;
        uint32_t size;
        memcpy(&size, header + 4, 4);
        if (memcmp(header, "fmt ", 4) == 0) {
            uint8_t fmt[16];
            if (fread(fmt, 1, 16, file) != 16) return false;
            uint16_t format;
            memcpy(&format, fmt, 2);
            memcpy(&info->channels, fmt + 2, 2);
            memcpy(&info->sample_rate, fmt + 4, 4);
            memcpy(&info->bits, fmt + 14, 2);
            if (format != 1) return false;  // PCM only
        } else if (memcmp(header, "data", 4) == 0) {
            info->data_offset = offset + 8;
            info->data_bytes = size;
            return info->channels > 0 && info->bits == 16;
        }
        offset += 8 + size + (size & 1);
    }
}

// Decode [start, start + count) frames into out (mono float32).
// Frames outside the file are zero-filled. Returns decoded frame count.
int64_t read_chunk(
    const char* path, int64_t start, int64_t count, float* out) {
    FILE* file = fopen(path, "rb");
    if (!file) return -1;
    WavInfo info;
    if (!parse_header(file, &info)) {
        fclose(file);
        return -1;
    }
    const int64_t total_frames =
        info.data_bytes / (2 * info.channels);
    const int64_t first = std::max<int64_t>(start, 0);
    const int64_t last = std::min<int64_t>(start + count, total_frames);

    std::fill(out, out + count, 0.f);
    if (last > first) {
        std::vector<int16_t> pcm((last - first) * info.channels);
        fseek(
            file,
            info.data_offset + first * 2 * info.channels,
            SEEK_SET);
        size_t got = fread(
            pcm.data(), 2 * info.channels, last - first, file);
        // Downmix to mono mean, normalize int16 -> [-1, 1]
        const float scale = 1.f / (32768.f * info.channels);
        for (size_t i = 0; i < got; ++i) {
            float acc = 0.f;
            for (uint16_t c = 0; c < info.channels; ++c)
                acc += static_cast<float>(pcm[i * info.channels + c]);
            out[first - start + i] = acc * scale;
        }
    }
    fclose(file);
    return last - first;
}

}  // namespace

extern "C" {

// Number of audio frames in a wav file; -1 on failure.
int64_t promonet_wav_frames(const char* path) {
    FILE* file = fopen(path, "rb");
    if (!file) return -1;
    WavInfo info;
    bool ok = parse_header(file, &info);
    fclose(file);
    if (!ok) return -1;
    return info.data_bytes / (2 * info.channels);
}

// Decode one chunk: out must hold `count` floats. Returns frames read.
int64_t promonet_wav_chunk(
    const char* path, int64_t start, int64_t count, float* out) {
    return read_chunk(path, start, count, out);
}

// Assemble a training batch: for each of `batch` items, decode
// `chunk` frames of paths[i] starting at starts[i] into
// out[i * chunk ...]. Decodes run on `threads` native threads.
// Returns 0 on success, else the number of failed items.
int32_t promonet_wav_batch(
    const char** paths,
    const int64_t* starts,
    int32_t batch,
    int64_t chunk,
    float* out,
    int32_t threads) {
    if (threads < 1) threads = 1;
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> failures(0);

    auto worker = [&]() {
        for (;;) {
            const int32_t i = next.fetch_add(1);
            if (i >= batch) return;
            const int64_t got = read_chunk(
                paths[i], starts[i], chunk, out + int64_t(i) * chunk);
            if (got < 0) failures.fetch_add(1);
        }
    };

    std::vector<std::thread> pool;
    const int32_t n = std::min<int32_t>(threads, batch);
    pool.reserve(n);
    for (int32_t t = 0; t < n; ++t) pool.emplace_back(worker);
    for (auto& thread : pool) thread.join();
    return failures.load();
}

}  // extern "C"
