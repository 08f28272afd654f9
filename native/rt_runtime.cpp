// Native real-time runtime: paced executor + lock-free trace ring buffer.
//
// Re-design of the reference's native runtime slice: the XCM RT
// executor that calls control_loop() every ~1 ms under Xenomai
// (/root/reference/cmake/FindXenomai.cmake:17-50,
//  /root/reference/src/QPPVMPlugin.cpp:308) and the preallocated RT-safe
// MatLogger (/root/reference/src/QPPVMPlugin.cpp:44,54). Here: POSIX
// clock_nanosleep absolute-deadline pacing with per-tick latency capture,
// and a single-producer/single-consumer ring buffer so the control thread
// never allocates or blocks on IO. Exposed as a C ABI for ctypes
// (no pybind11 in this image).
//
// Build: make -C native   ->  native/librt_runtime.so

#include <atomic>
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <ctime>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

static inline int64_t now_ns() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return int64_t(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

struct Executor {
    int64_t period_ns;
    std::vector<double> latencies_s;  // per-tick callback latency
    std::vector<double> jitter_s;     // wakeup jitter vs deadline
    int64_t deadline_misses = 0;
};

struct Ring {
    // SPSC byte ring. Records: [u32 channel, u32 n_floats, f32 data[n]].
    std::vector<uint8_t> buf;
    std::atomic<uint64_t> head{0};  // producer writes
    std::atomic<uint64_t> tail{0};  // consumer reads
    std::atomic<uint64_t> dropped{0};
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- executor
void* rt_executor_create(int64_t period_ns) {
    auto* e = new Executor();
    e->period_ns = period_ns;
    e->latencies_s.reserve(1 << 20);
    e->jitter_s.reserve(1 << 20);
    return e;
}

void rt_executor_destroy(void* h) { delete static_cast<Executor*>(h); }

typedef int (*tick_cb)(int64_t tick, double t_s, void* user);

// Paced loop with absolute deadlines; returns ticks completed (callback
// returning nonzero stops the loop early — the "close" path).
int64_t rt_executor_run(void* h, tick_cb cb, int64_t n_ticks, void* user) {
    auto* e = static_cast<Executor*>(h);
    struct timespec next;
    clock_gettime(CLOCK_MONOTONIC, &next);
    int64_t start = now_ns();
    int64_t done = 0;
    for (int64_t i = 0; i < n_ticks; ++i) {
        int64_t wake = now_ns();
        double t_s = double(wake - start) * 1e-9;
        int64_t t0 = wake;
        int rc = cb(i, t_s, user);
        int64_t t1 = now_ns();
        e->latencies_s.push_back(double(t1 - t0) * 1e-9);
        if (t1 - t0 > e->period_ns) e->deadline_misses++;
        ++done;
        if (rc != 0) break;
        // absolute next deadline
        next.tv_nsec += e->period_ns;
        while (next.tv_nsec >= 1000000000L) {
            next.tv_nsec -= 1000000000L;
            next.tv_sec += 1;
        }
        clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
        int64_t after = now_ns();
        int64_t dl = int64_t(next.tv_sec) * 1000000000LL + next.tv_nsec;
        e->jitter_s.push_back(double(after - dl) * 1e-9);
    }
    return done;
}

static double percentile(std::vector<double> v, double p) {
    if (v.empty()) return 0.0;
    size_t k = size_t(p * double(v.size() - 1));
    std::nth_element(v.begin(), v.begin() + k, v.end());
    return v[k];
}

void rt_executor_stats(void* h, double* p50, double* p99, double* mean,
                       int64_t* misses) {
    auto* e = static_cast<Executor*>(h);
    *p50 = percentile(e->latencies_s, 0.50);
    *p99 = percentile(e->latencies_s, 0.99);
    double s = 0;
    for (double x : e->latencies_s) s += x;
    *mean = e->latencies_s.empty() ? 0.0 : s / double(e->latencies_s.size());
    *misses = e->deadline_misses;
}

// ------------------------------------------------------------------- ring
void* ring_create(uint64_t capacity_bytes) {
    auto* r = new Ring();
    r->buf.resize(capacity_bytes);
    return r;
}

void ring_destroy(void* h) { delete static_cast<Ring*>(h); }

// Producer side (control thread): wait-free push; drops record when full.
int ring_push(void* h, uint32_t channel, const float* data, uint32_t n) {
    auto* r = static_cast<Ring*>(h);
    const uint64_t cap = r->buf.size();
    const uint64_t need = 8 + uint64_t(n) * 4;
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    if (cap - (head - tail) < need) {
        r->dropped.fetch_add(1, std::memory_order_relaxed);
        return -1;
    }
    auto put = [&](const void* src, uint64_t len) {
        uint64_t off = head % cap;
        uint64_t first = std::min(len, cap - off);
        std::memcpy(&r->buf[off], src, first);
        if (len > first) std::memcpy(&r->buf[0], (const uint8_t*)src + first,
                                     len - first);
        head += len;
    };
    put(&channel, 4);
    put(&n, 4);
    put(data, uint64_t(n) * 4);
    r->head.store(head, std::memory_order_release);
    return 0;
}

// Consumer side: pop one record into out (cap_floats capacity).
// Returns n floats, -1 if empty, -2 if out too small (record consumed).
int ring_pop(void* h, uint32_t* channel, float* out, uint32_t cap_floats) {
    auto* r = static_cast<Ring*>(h);
    const uint64_t cap = r->buf.size();
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (head == tail) return -1;
    auto get = [&](void* dst, uint64_t len) {
        uint64_t off = tail % cap;
        uint64_t first = std::min(len, cap - off);
        std::memcpy(dst, &r->buf[off], first);
        if (len > first) std::memcpy((uint8_t*)dst + first, &r->buf[0],
                                     len - first);
        tail += len;
    };
    uint32_t n;
    get(channel, 4);
    get(&n, 4);
    int rc = int(n);
    if (n <= cap_floats) {
        get(out, uint64_t(n) * 4);
    } else {
        tail += uint64_t(n) * 4;  // skip
        rc = -2;
    }
    r->tail.store(tail, std::memory_order_release);
    return rc;
}

uint64_t ring_dropped(void* h) {
    return static_cast<Ring*>(h)->dropped.load(std::memory_order_relaxed);
}

// ------------------------------------------------- shared-memory channel
// Cross-process typed float channel — the native analog of XBot's
// SharedObject/SharedMemory (/root/reference/src/ForceAcc.cpp:52-55:
// a Gazebo plugin publishes floating-base pos/vel into shared memory read
// by the RT plugin). POSIX shm_open + a seqlock: single writer, any number
// of readers, wait-free on both sides (readers retry on a torn read).
//
// Layout: [u64 seq][u32 n][u32 pad][f32 data[n]]. seq odd = write in
// progress.

struct ShmHeader {
    std::atomic<uint64_t> seq;
    uint32_t n;
    uint32_t pad;
};

struct ShmChannel {
    ShmHeader* hdr = nullptr;
    float* data = nullptr;
    size_t map_len = 0;
    int fd = -1;
    bool owner = false;
    std::string name;
};

void* shm_channel_create(const char* name, uint32_t n_floats) {
    size_t len = sizeof(ShmHeader) + size_t(n_floats) * 4;
    int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, off_t(len)) != 0) { close(fd); return nullptr; }
    void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (p == MAP_FAILED) { close(fd); return nullptr; }
    auto* ch = new ShmChannel;
    ch->hdr = static_cast<ShmHeader*>(p);
    ch->data = reinterpret_cast<float*>(ch->hdr + 1);
    ch->map_len = len;
    ch->fd = fd;
    ch->owner = true;
    ch->name = name;
    ch->hdr->seq.store(0, std::memory_order_relaxed);
    ch->hdr->n = n_floats;
    return ch;
}

void* shm_channel_open(const char* name) {
    int fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    ShmHeader tmp;
    if (read(fd, &tmp, sizeof(tmp)) != ssize_t(sizeof(tmp))) {
        close(fd);
        return nullptr;
    }
    size_t len = sizeof(ShmHeader) + size_t(tmp.n) * 4;
    void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (p == MAP_FAILED) { close(fd); return nullptr; }
    auto* ch = new ShmChannel;
    ch->hdr = static_cast<ShmHeader*>(p);
    ch->data = reinterpret_cast<float*>(ch->hdr + 1);
    ch->map_len = len;
    ch->fd = fd;
    ch->owner = false;
    ch->name = name;
    return ch;
}

uint32_t shm_channel_size(void* h) {
    return static_cast<ShmChannel*>(h)->hdr->n;
}

// Single writer: seqlock write (odd seq while writing).
void shm_channel_write(void* h, const float* data, uint32_t n) {
    auto* ch = static_cast<ShmChannel*>(h);
    uint32_t m = std::min(n, ch->hdr->n);
    uint64_t s = ch->hdr->seq.load(std::memory_order_relaxed);
    ch->hdr->seq.store(s + 1, std::memory_order_release);  // odd: writing
    std::atomic_thread_fence(std::memory_order_release);
    std::memcpy(ch->data, data, size_t(m) * 4);
    ch->hdr->seq.store(s + 2, std::memory_order_release);
}

// Reader: retry until a consistent (even, unchanged) snapshot; returns the
// sequence number (0 = never written), or -1 if torn after max retries.
int64_t shm_channel_read(void* h, float* out, uint32_t cap) {
    auto* ch = static_cast<ShmChannel*>(h);
    uint32_t m = std::min(cap, ch->hdr->n);
    for (int attempt = 0; attempt < 1000; ++attempt) {
        uint64_t s0 = ch->hdr->seq.load(std::memory_order_acquire);
        if (s0 & 1) continue;  // write in progress
        std::atomic_thread_fence(std::memory_order_acquire);
        std::memcpy(out, ch->data, size_t(m) * 4);
        std::atomic_thread_fence(std::memory_order_acquire);
        uint64_t s1 = ch->hdr->seq.load(std::memory_order_acquire);
        if (s0 == s1) return int64_t(s1);
    }
    return -1;
}

void shm_channel_close(void* h) {
    auto* ch = static_cast<ShmChannel*>(h);
    munmap(ch->hdr, ch->map_len);
    close(ch->fd);
    if (ch->owner) shm_unlink(ch->name.c_str());
    delete ch;
}

}  // extern "C"
