// libfq3t: host-side DSP and IO of the PyTorch port, a copy of the JAX
// package's native/fq3t.cpp with the same C ABI (version 1): sample-rate
// conversion, PCM framing, WAV container IO and a ring buffer for streaming
// playback, consumed through ctypes by
// faster_qwen3_tts_tpu_torch/utils/native.py.
//
// Built at first use by that module with g++ into build/fq3t_torch/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <algorithm>
#include <atomic>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Version / ABI
// ---------------------------------------------------------------------------

int fq3t_abi_version() { return 1; }

// ---------------------------------------------------------------------------
// PCM conversion
// ---------------------------------------------------------------------------

// float32 [-1,1] -> int16 PCM with clamping. Returns n.
int64_t fq3t_float_to_pcm16(const float* in, int64_t n, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
        out[i] = (int16_t)lrintf(v * 32767.f);
    }
    return n;
}

int64_t fq3t_pcm16_to_float(const int16_t* in, int64_t n, float* out) {
    const float k = 1.f / 32768.f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * k;
    return n;
}

// ---------------------------------------------------------------------------
// Resampling: windowed-sinc polyphase (kaiser-lite via hann window)
// ---------------------------------------------------------------------------

// Resample n_in samples from sr_in to sr_out. out must hold
// fq3t_resample_out_len(n_in, sr_in, sr_out) floats. Returns produced count.
int64_t fq3t_resample_out_len(int64_t n_in, int32_t sr_in, int32_t sr_out) {
    return (int64_t)((double)n_in * sr_out / sr_in);
}

int64_t fq3t_resample(const float* in, int64_t n_in, int32_t sr_in,
                      int32_t sr_out, float* out) {
    if (sr_in == sr_out) {
        memcpy(out, in, sizeof(float) * n_in);
        return n_in;
    }
    const int64_t n_out = fq3t_resample_out_len(n_in, sr_in, sr_out);
    const double ratio = (double)sr_in / sr_out;
    const double cutoff = std::min(1.0, (double)sr_out / sr_in);  // anti-alias
    const int half = 16;  // taps per side
    for (int64_t j = 0; j < n_out; ++j) {
        const double center = j * ratio;
        const int64_t i0 = (int64_t)floor(center);
        double acc = 0.0, wsum = 0.0;
        for (int64_t i = i0 - half + 1; i <= i0 + half; ++i) {
            const double x = (center - i) * cutoff;
            // sinc * hann window
            double s = (fabs(x) < 1e-9) ? 1.0 : sin(M_PI * x) / (M_PI * x);
            const double w = 0.5 + 0.5 * cos(M_PI * (center - i) / half);
            s *= w * cutoff;
            const float v = (i < 0 || i >= n_in) ? 0.f : in[i];
            acc += s * v;
            wsum += s;
        }
        out[j] = (float)acc;
        (void)wsum;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// WAV container IO (16-bit PCM mono)
// ---------------------------------------------------------------------------

static void put_u32(uint8_t* p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff; p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
static void put_u16(uint8_t* p, uint16_t v) { p[0] = v & 0xff; p[1] = (v >> 8) & 0xff; }

// Write a 44-byte WAV header into out (caller appends PCM16 data).
// data_len = payload bytes, or 0xFFFFFFFF-44 for unknown-length streaming
// (the reference's streaming trick, openai_server.py:96-113).
int32_t fq3t_wav_header(int32_t sample_rate, int32_t channels, uint32_t data_len,
                        uint8_t* out) {
    const uint16_t bits = 16;
    const uint32_t byte_rate = sample_rate * channels * bits / 8;
    memcpy(out, "RIFF", 4);
    put_u32(out + 4, data_len + 36);
    memcpy(out + 8, "WAVEfmt ", 8);
    put_u32(out + 16, 16);
    put_u16(out + 20, 1);
    put_u16(out + 22, (uint16_t)channels);
    put_u32(out + 24, (uint32_t)sample_rate);
    put_u32(out + 28, byte_rate);
    put_u16(out + 32, (uint16_t)(channels * bits / 8));
    put_u16(out + 34, bits);
    memcpy(out + 36, "data", 4);
    put_u32(out + 40, data_len);
    return 44;
}

int32_t fq3t_write_wav(const char* path, const float* audio, int64_t n,
                       int32_t sample_rate) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    uint8_t hdr[44];
    fq3t_wav_header(sample_rate, 1, (uint32_t)(n * 2), hdr);
    fwrite(hdr, 1, 44, f);
    std::vector<int16_t> pcm(n);
    fq3t_float_to_pcm16(audio, n, pcm.data());
    fwrite(pcm.data(), 2, n, f);
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// SPSC ring buffer for streaming playback / socket framing
// ---------------------------------------------------------------------------

struct Fq3tRing {
    std::vector<float> buf;
    std::atomic<int64_t> head{0};  // written
    std::atomic<int64_t> tail{0};  // read
};

void* fq3t_ring_new(int64_t capacity) {
    auto* r = new Fq3tRing();
    r->buf.resize(capacity);
    return r;
}

void fq3t_ring_free(void* h) { delete (Fq3tRing*)h; }

int64_t fq3t_ring_write(void* h, const float* data, int64_t n) {
    auto* r = (Fq3tRing*)h;
    const int64_t cap = (int64_t)r->buf.size();
    const int64_t head = r->head.load(std::memory_order_relaxed);
    const int64_t tail = r->tail.load(std::memory_order_acquire);
    const int64_t space = cap - (head - tail);
    const int64_t w = std::min(n, space);
    for (int64_t i = 0; i < w; ++i) r->buf[(head + i) % cap] = data[i];
    r->head.store(head + w, std::memory_order_release);
    return w;
}

int64_t fq3t_ring_read(void* h, float* out, int64_t n) {
    auto* r = (Fq3tRing*)h;
    const int64_t cap = (int64_t)r->buf.size();
    const int64_t tail = r->tail.load(std::memory_order_relaxed);
    const int64_t head = r->head.load(std::memory_order_acquire);
    const int64_t avail = head - tail;
    const int64_t rd = std::min(n, avail);
    for (int64_t i = 0; i < rd; ++i) out[i] = r->buf[(tail + i) % cap];
    r->tail.store(tail + rd, std::memory_order_release);
    return rd;
}

int64_t fq3t_ring_available(void* h) {
    auto* r = (Fq3tRing*)h;
    return r->head.load(std::memory_order_acquire) - r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
