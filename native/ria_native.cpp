// ria_native: C++ runtime components for the accelerator-native HF modem framework.
//
// The compute path is JAX/XLA; these are the host-runtime pieces that the
// reference implements natively (audio ring buffer handoff, per-sample
// resampling, channel simulation for golden cross-checks):
//
// - RingBuffer: single-producer/single-consumer float ring with overflow
//   accounting (the StreamingDecoder feedAudio contract,
//   reference streaming_decoder.{hpp,cpp}).
// - Resampler: rational polyphase per-sample resampler (zero-stuff ->
//   64-tap windowed-sinc lowpass -> decimate; reference src/dsp/resampler.cpp
//   semantics).
// - Watterson: per-sample ITU-R F.1487 channel with std::mt19937 noise,
//   matching the reference model (src/sim/hf_channel.hpp behavior) —
//   used to cross-validate the vectorized JAX channel statistically.
// - crc16_ccitt: wire CRC used by frame v2.
//
// Build: see native/build.sh (g++ -O2 -shared -fPIC).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ============================================================================
// Ring buffer (SPSC, float samples)
// ============================================================================

struct RingBuffer {
    std::vector<float> data;
    size_t capacity;
    std::atomic<size_t> head{0};  // write index (total samples written)
    std::atomic<size_t> tail{0};  // read index (total samples read)
    std::atomic<uint64_t> overflow_drops{0};
};

void* rb_create(size_t capacity) {
    auto* rb = new RingBuffer();
    rb->capacity = capacity;
    rb->data.resize(capacity);
    return rb;
}

void rb_destroy(void* h) { delete static_cast<RingBuffer*>(h); }

size_t rb_size(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    return rb->head.load() - rb->tail.load();
}

uint64_t rb_overflows(void* h) {
    return static_cast<RingBuffer*>(h)->overflow_drops.load();
}

size_t rb_write(void* h, const float* src, size_t n) {
    auto* rb = static_cast<RingBuffer*>(h);
    size_t head = rb->head.load(std::memory_order_relaxed);
    size_t tail = rb->tail.load(std::memory_order_acquire);
    size_t free_space = rb->capacity - (head - tail);
    size_t to_write = n < free_space ? n : free_space;
    if (to_write < n) rb->overflow_drops += (n - to_write);
    for (size_t i = 0; i < to_write; ++i) {
        rb->data[(head + i) % rb->capacity] = src[i];
    }
    rb->head.store(head + to_write, std::memory_order_release);
    return to_write;
}

size_t rb_read(void* h, float* dst, size_t n) {
    auto* rb = static_cast<RingBuffer*>(h);
    size_t head = rb->head.load(std::memory_order_acquire);
    size_t tail = rb->tail.load(std::memory_order_relaxed);
    size_t avail = head - tail;
    size_t to_read = n < avail ? n : avail;
    for (size_t i = 0; i < to_read; ++i) {
        dst[i] = rb->data[(tail + i) % rb->capacity];
    }
    rb->tail.store(tail + to_read, std::memory_order_release);
    return to_read;
}

size_t rb_peek(void* h, float* dst, size_t n) {
    auto* rb = static_cast<RingBuffer*>(h);
    size_t head = rb->head.load(std::memory_order_acquire);
    size_t tail = rb->tail.load(std::memory_order_relaxed);
    size_t avail = head - tail;
    size_t to_read = n < avail ? n : avail;
    for (size_t i = 0; i < to_read; ++i) {
        dst[i] = rb->data[(tail + i) % rb->capacity];
    }
    return to_read;
}

void rb_consume(void* h, size_t n) {
    auto* rb = static_cast<RingBuffer*>(h);
    size_t head = rb->head.load(std::memory_order_acquire);
    size_t tail = rb->tail.load(std::memory_order_relaxed);
    size_t avail = head - tail;
    rb->tail.store(tail + (n < avail ? n : avail), std::memory_order_release);
}

// ============================================================================
// Rational polyphase resampler
// ============================================================================

struct Resampler {
    unsigned up, down;
    std::vector<float> taps;     // windowed-sinc lowpass at the high rate
    std::vector<float> delay;    // FIR state
    size_t delay_idx = 0;
    size_t phase = 0;
};

static std::vector<float> design_lowpass_taps(size_t ntaps, double cutoff, double fs) {
    std::vector<float> h(ntaps);
    double fc = cutoff / fs;
    long M = (long)(ntaps - 1) / 2;
    double sum = 0.0;
    for (long n = 0; n < (long)ntaps; ++n) {
        double v;
        if (n == M) {
            v = 2.0 * fc;
        } else {
            double x = M_PI * (n - M);
            v = std::sin(2.0 * fc * x) / x;
        }
        v *= 0.54 - 0.46 * std::cos(2.0 * M_PI * n / (ntaps - 1));
        h[n] = (float)v;
        sum += v;
    }
    for (auto& v : h) v = (float)(v / sum);
    return h;
}

void* rs_create(unsigned in_rate, unsigned out_rate) {
    auto* rs = new Resampler();
    unsigned a = in_rate, b = out_rate;
    while (b) { unsigned t = b; b = a % b; a = t; }
    rs->up = out_rate / a;
    rs->down = in_rate / a;
    unsigned hi = in_rate > out_rate ? in_rate : out_rate;
    unsigned lo = in_rate < out_rate ? in_rate : out_rate;
    rs->taps = design_lowpass_taps(64, lo * 0.45, (double)hi);
    rs->delay.assign(rs->taps.size(), 0.0f);
    return rs;
}

void rs_destroy(void* h) { delete static_cast<Resampler*>(h); }

size_t rs_output_size(void* h, size_t n) {
    auto* rs = static_cast<Resampler*>(h);
    return (n * rs->up + rs->down - 1) / rs->down;
}

static inline float fir_step(Resampler* rs, float in) {
    rs->delay[rs->delay_idx] = in;
    float out = 0.0f;
    size_t j = rs->delay_idx;
    for (size_t i = 0; i < rs->taps.size(); ++i) {
        out += rs->taps[i] * rs->delay[j];
        j = (j == 0) ? rs->taps.size() - 1 : j - 1;
    }
    rs->delay_idx = (rs->delay_idx + 1) % rs->taps.size();
    return out;
}

size_t rs_process(void* h, const float* in, size_t n, float* out, size_t out_cap) {
    auto* rs = static_cast<Resampler*>(h);
    size_t written = 0;
    if (rs->up == rs->down) {
        size_t m = n < out_cap ? n : out_cap;
        std::memcpy(out, in, m * sizeof(float));
        return m;
    }
    for (size_t i = 0; i < n; ++i) {
        for (unsigned j = 0; j < rs->up; ++j) {
            float s = (j == 0) ? in[i] * (float)rs->up : 0.0f;
            s = fir_step(rs, s);
            if (rs->phase == 0 && written < out_cap) {
                out[written++] = s;
            }
            rs->phase = (rs->phase + 1) % rs->down;
        }
    }
    return written;
}

// ============================================================================
// Per-sample Watterson channel (reference-faithful, mt19937 noise)
// ============================================================================

struct Watterson {
    double snr_db;
    size_t delay_samples;
    double fading_alpha;
    double noise_scale;
    bool fading, multipath, noise, cfo;
    double path1_gain, path2_gain;
    double cfo_hz, cfo_phase, cfo_phase_inc;
    unsigned sample_rate;
    std::mt19937 rng;
    std::normal_distribution<float> gauss{0.0f, 1.0f};
    std::vector<float> delay_line;
    size_t delay_pos = 0;
    float f1r = 1.0f, f1i = 0.0f, f2r = 1.0f, f2i = 0.0f;
};

void* wc_create(double snr_db, double delay_ms, double doppler_hz, double cfo_hz,
                unsigned sample_rate, unsigned seed, int fading, int multipath,
                int noise) {
    auto* w = new Watterson();
    w->snr_db = snr_db;
    w->sample_rate = sample_rate;
    w->delay_samples = (size_t)(delay_ms * sample_rate / 1000.0);
    double nd = doppler_hz / sample_rate;
    w->fading_alpha = 1.0 - std::exp(-2.0 * M_PI * nd);
    w->noise_scale = (w->fading_alpha > 0) ? std::sqrt(1.0 / w->fading_alpha) : 0.0;
    w->fading = fading != 0;
    w->multipath = multipath != 0;
    w->noise = noise != 0;
    w->path1_gain = multipath ? 0.707 : 1.0;
    w->path2_gain = multipath ? 0.707 : 0.0;
    w->cfo_hz = cfo_hz;
    w->cfo = std::abs(cfo_hz) > 1e-3;
    w->cfo_phase = 0.0;
    w->cfo_phase_inc = 2.0 * M_PI * cfo_hz / sample_rate;
    w->rng.seed(seed);
    w->delay_line.assign(w->delay_samples + 1, 0.0f);
    return w;
}

void wc_destroy(void* h) { delete static_cast<Watterson*>(h); }

void wc_process(void* h, const float* in, float* out, size_t n) {
    auto* w = static_cast<Watterson*>(h);

    // SNR normalization against non-zero-sample RMS (reference behavior).
    double power = 0.0;
    size_t count = 0;
    for (size_t i = 0; i < n; ++i) {
        if (std::abs(in[i]) > 1e-6f) { power += (double)in[i] * in[i]; ++count; }
    }
    double rms = count ? std::sqrt(power / count) : 0.1;
    double noise_std = rms * std::pow(10.0, -w->snr_db / 20.0);

    for (size_t i = 0; i < n; ++i) {
        float s = in[i];
        if (w->fading) {
            float n1r = (float)(w->noise_scale * w->gauss(w->rng));
            float n1i = (float)(w->noise_scale * w->gauss(w->rng));
            float n2r = (float)(w->noise_scale * w->gauss(w->rng));
            float n2i = (float)(w->noise_scale * w->gauss(w->rng));
            float a = (float)w->fading_alpha;
            w->f1r = (1 - a) * w->f1r + a * n1r;
            w->f1i = (1 - a) * w->f1i + a * n1i;
            w->f2r = (1 - a) * w->f2r + a * n2r;
            w->f2i = (1 - a) * w->f2i + a * n2i;
        }
        float h1 = w->fading ? std::sqrt(w->f1r * w->f1r + w->f1i * w->f1i) : 1.0f;
        float h2 = w->fading ? std::sqrt(w->f2r * w->f2r + w->f2i * w->f2i) : 1.0f;

        float o;
        if (w->multipath && w->delay_samples > 0) {
            float delayed = w->delay_line[w->delay_pos];
            w->delay_line[w->delay_pos] = s;
            w->delay_pos = (w->delay_pos + 1) % w->delay_line.size();
            o = (float)(s * w->path1_gain * h1 + delayed * w->path2_gain * h2);
        } else {
            o = s * h1;
        }
        if (w->noise) {
            o += (float)(noise_std * w->gauss(w->rng));
        }
        out[i] = o;
    }
    // CFO applied in a second pass at baseband (reference applyCFO).
    if (w->cfo) {
        const double fc = 1500.0, fs = w->sample_rate;
        std::vector<double> If(n), Qf(n);
        const size_t win = 48;
        double isum = 0, qsum = 0;
        std::vector<double> ibb(n), qbb(n);
        for (size_t i = 0; i < n; ++i) {
            double t = (double)i / fs;
            double mp = 2.0 * M_PI * fc * t;
            ibb[i] = out[i] * std::cos(mp);
            qbb[i] = out[i] * std::sin(mp);
        }
        for (size_t i = 0; i < n; ++i) {
            isum += ibb[i]; qsum += qbb[i];
            if (i >= win) { isum -= ibb[i - win]; qsum -= qbb[i - win]; }
            size_t m = (i + 1 < win) ? i + 1 : win;
            If[i] = isum / m; Qf[i] = qsum / m;
        }
        double ph = w->cfo_phase;
        for (size_t i = 0; i < n; ++i) {
            double t = (double)i / fs;
            double mp = 2.0 * M_PI * fc * t;
            double c = std::cos(ph), sN = std::sin(ph);
            double ic = If[i] * c - Qf[i] * sN;
            double qc = If[i] * sN + Qf[i] * c;
            out[i] = (float)(2.0 * (ic * std::cos(mp) - qc * std::sin(mp)));
            ph += w->cfo_phase_inc;
            if (ph > 2.0 * M_PI) ph -= 2.0 * M_PI;
        }
        w->cfo_phase = ph;
    }
}

// ============================================================================
// CRC-16/CCITT (poly 0x1021, init 0xFFFF)
// ============================================================================

uint16_t crc16_ccitt(const uint8_t* data, size_t len) {
    uint16_t crc = 0xFFFF;
    for (size_t i = 0; i < len; ++i) {
        crc ^= (uint16_t)(data[i]) << 8;
        for (int j = 0; j < 8; ++j) {
            crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x1021) : (uint16_t)(crc << 1);
        }
    }
    return crc;
}

}  // extern "C"

// ============================================================================
// TcpServer: select()-based multi-client TCP server (reference
// src/interface/tcp_server.{hpp,cpp} — single-threaded, non-blocking accept/
// read, best-effort writes).  Drives the host-control interface's command/
// data/KISS ports (interface.hpp:13-16) natively; the Python layer only
// parses command lines.  Event model: poll() multiplexes accept + reads and
// queues (type, client, payload) events the host drains with next_event().
// ============================================================================

#include <deque>
#include <map>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/select.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct TcpEvent {
    int type;  // 1=connect 2=disconnect 3=data
    int client;
    std::vector<uint8_t> payload;
};

struct TcpServer {
    int listener = -1;
    int port = 0;
    int next_id = 1;
    std::map<int, int> clients;  // client id -> fd
    std::deque<TcpEvent> events;
};

void set_nonblocking(int fd) {
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

}  // namespace

extern "C" {

// Returns handle or nullptr.  port 0 = ephemeral (query with tcp_port).
void* tcp_create(const char* bind_addr, int port) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, bind_addr ? bind_addr : "127.0.0.1", &addr.sin_addr) != 1 ||
        bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 8) != 0) {
        ::close(fd);
        return nullptr;
    }
    set_nonblocking(fd);
    socklen_t len = sizeof(addr);
    getsockname(fd, (sockaddr*)&addr, &len);
    auto* s = new TcpServer();
    s->listener = fd;
    s->port = ntohs(addr.sin_port);
    return s;
}

int tcp_port(void* h) { return static_cast<TcpServer*>(h)->port; }

int tcp_client_count(void* h) {
    return (int)static_cast<TcpServer*>(h)->clients.size();
}

// Multiplex accept + reads for up to timeout_ms; queue events.
// Returns the number of queued events.
int tcp_poll(void* h, int timeout_ms) {
    auto* s = static_cast<TcpServer*>(h);
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(s->listener, &rfds);
    int maxfd = s->listener;
    for (auto& [id, fd] : s->clients) {
        FD_SET(fd, &rfds);
        if (fd > maxfd) maxfd = fd;
    }
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    int n = select(maxfd + 1, &rfds, nullptr, nullptr, &tv);
    if (n <= 0) return (int)s->events.size();

    if (FD_ISSET(s->listener, &rfds)) {
        int cfd;
        while ((cfd = accept(s->listener, nullptr, nullptr)) >= 0) {
            set_nonblocking(cfd);
            int id = s->next_id++;
            s->clients[id] = cfd;
            s->events.push_back({1, id, {}});
        }
    }
    std::vector<int> dead;
    for (auto& [id, fd] : s->clients) {
        if (!FD_ISSET(fd, &rfds)) continue;
        uint8_t buf[65536];
        ssize_t got = recv(fd, buf, sizeof(buf), 0);
        if (got <= 0) {
            dead.push_back(id);
        } else {
            s->events.push_back({3, id, std::vector<uint8_t>(buf, buf + got)});
        }
    }
    for (int id : dead) {
        ::close(s->clients[id]);
        s->clients.erase(id);
        s->events.push_back({2, id, {}});
    }
    return (int)s->events.size();
}

// Pop one event.  Returns payload length (>=0) and fills type/client, or -1
// when the queue is empty.  Payloads longer than buf_cap are truncated to
// buf_cap (callers size buf_cap at the recv chunk size, so this is lossless).
int tcp_next_event(void* h, int* type, int* client, uint8_t* buf, int buf_cap) {
    auto* s = static_cast<TcpServer*>(h);
    if (s->events.empty()) return -1;
    TcpEvent ev = std::move(s->events.front());
    s->events.pop_front();
    *type = ev.type;
    *client = ev.client;
    int n = (int)ev.payload.size();
    if (n > buf_cap) n = buf_cap;
    if (n > 0) memcpy(buf, ev.payload.data(), (size_t)n);
    return n;
}

int tcp_send(void* h, int client, const uint8_t* data, int n) {
    auto* s = static_cast<TcpServer*>(h);
    auto it = s->clients.find(client);
    if (it == s->clients.end()) return -1;
    // Best-effort like the reference TcpServer: a slow client drops bytes
    // rather than blocking the modem tick loop.
    int sent = 0;
    while (sent < n) {
        ssize_t w = send(it->second, data + sent, (size_t)(n - sent), MSG_NOSIGNAL);
        if (w <= 0) break;
        sent += (int)w;
    }
    return sent;
}

int tcp_broadcast(void* h, const uint8_t* data, int n) {
    auto* s = static_cast<TcpServer*>(h);
    int count = 0;
    for (auto& [id, fd] : s->clients) {
        (void)fd;
        if (tcp_send(h, id, data, n) == n) count++;
    }
    return count;
}

void tcp_close_client(void* h, int client) {
    auto* s = static_cast<TcpServer*>(h);
    auto it = s->clients.find(client);
    if (it == s->clients.end()) return;
    ::close(it->second);
    s->clients.erase(it);
}

void tcp_destroy(void* h) {
    auto* s = static_cast<TcpServer*>(h);
    for (auto& [id, fd] : s->clients) {
        (void)id;
        ::close(fd);
    }
    if (s->listener >= 0) ::close(s->listener);
    delete s;
}

}  // extern "C"
