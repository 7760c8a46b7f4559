// iqnative: native host-runtime primitives for iq_tool_tpu.
//
// The reference implements its runtime (queues, rings, byte packing) in
// C99 on pthreads; this framework keeps the compute path in XLA but
// uses this library for the host-side hot paths, where Python-level
// byte handling would bottleneck multi-GB/s streams:
//
//   * SPSC byte ring buffer with the reference's real-time semantics
//     (lossy non-blocking writes, blocking reads, EOS/shutdown signaling
//     -- ring_buffer.c:24-177 contract);
//   * cs24 <-> int32 pack/unpack (sample_convert.c:156-166 bit layout);
//   * planar short -> interleaved conversion (input_sdrplay.c:433-437);
//   * a readahead file loader (pread into caller buffers).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ----------------------------- ring buffer ----------------------------------

struct IqRing {
    uint8_t* buf;
    size_t capacity;
    size_t head;   // write
    size_t tail;   // read
    size_t size;
    bool eos;
    bool shutdown;
    std::mutex m;
    std::condition_variable readable;
};

IqRing* iq_ring_create(size_t capacity) {
    IqRing* r = new (std::nothrow) IqRing();
    if (!r) return nullptr;
    r->buf = new (std::nothrow) uint8_t[capacity];
    if (!r->buf) { delete r; return nullptr; }
    r->capacity = capacity;
    r->head = r->tail = r->size = 0;
    r->eos = r->shutdown = false;
    return r;
}

void iq_ring_destroy(IqRing* r) {
    if (!r) return;
    {
        // wake any blocked reader and let it leave wait() before the
        // mutex/condvar are destroyed (destroying a condvar with an
        // active waiter is UB)
        std::unique_lock<std::mutex> lk(r->m);
        r->shutdown = true;
        r->readable.notify_all();
    }
    {
        std::lock_guard<std::mutex> lk(r->m);
    }
    delete[] r->buf;
    delete r;
}

// Non-blocking lossy write; returns bytes accepted.
size_t iq_ring_write(IqRing* r, const uint8_t* data, size_t n) {
    std::lock_guard<std::mutex> lk(r->m);
    if (r->shutdown || r->eos) return 0;
    size_t take = n < (r->capacity - r->size) ? n : (r->capacity - r->size);
    if (take == 0) return 0;
    size_t first = take < (r->capacity - r->head) ? take : (r->capacity - r->head);
    std::memcpy(r->buf + r->head, data, first);
    if (take > first) std::memcpy(r->buf, data + first, take - first);
    r->head = (r->head + take) % r->capacity;
    r->size += take;
    r->readable.notify_all();
    return take;
}

// Blocking read: up to n bytes; returns short on EOS or timeout, 0 on
// shutdown (matching the Python RingBuffer).  timeout_ms < 0 = forever.
size_t iq_ring_read_timed(IqRing* r, uint8_t* out, size_t n,
                          long timeout_ms) {
    size_t got = 0;
    std::unique_lock<std::mutex> lk(r->m);
    while (got < n) {
        if (r->size == 0) {
            if (r->shutdown) return 0;
            if (r->eos) break;
            if (timeout_ms < 0) {
                r->readable.wait(lk);
            } else {
                if (r->readable.wait_for(
                        lk, std::chrono::milliseconds(timeout_ms)) ==
                    std::cv_status::timeout)
                    break;
            }
            continue;
        }
        size_t take = (n - got) < r->size ? (n - got) : r->size;
        size_t first = take < (r->capacity - r->tail) ? take : (r->capacity - r->tail);
        std::memcpy(out + got, r->buf + r->tail, first);
        if (take > first) std::memcpy(out + got + first, r->buf, take - first);
        r->tail = (r->tail + take) % r->capacity;
        r->size -= take;
        got += take;
    }
    return got;
}

size_t iq_ring_read(IqRing* r, uint8_t* out, size_t n) {
    return iq_ring_read_timed(r, out, n, -1);
}

size_t iq_ring_size(IqRing* r) {
    std::lock_guard<std::mutex> lk(r->m);
    return r->size;
}

void iq_ring_signal_eos(IqRing* r) {
    std::lock_guard<std::mutex> lk(r->m);
    r->eos = true;
    r->readable.notify_all();
}

void iq_ring_signal_shutdown(IqRing* r) {
    std::lock_guard<std::mutex> lk(r->m);
    r->shutdown = true;
    r->readable.notify_all();
}

int iq_ring_eos(IqRing* r) {
    std::lock_guard<std::mutex> lk(r->m);
    return (r->eos && r->size == 0) ? 1 : 0;
}

// ----------------------------- byte packing ---------------------------------

// little-endian 3-byte signed -> int32 (sign-extended), n values
void iq_unpack_cs24(const uint8_t* in, int32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        const uint8_t* p = in + 3 * i;
        int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24);
        out[i] = v >> 8;
    }
}

void iq_pack_cs24(const int32_t* in, uint8_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        uint32_t v = (uint32_t)in[i];
        uint8_t* p = out + 3 * i;
        p[0] = (uint8_t)(v & 0xFF);
        p[1] = (uint8_t)((v >> 8) & 0xFF);
        p[2] = (uint8_t)((v >> 16) & 0xFF);
    }
}

// planar I[],Q[] shorts -> interleaved IQIQ...
void iq_interleave_shorts(const int16_t* xi, const int16_t* xq, int16_t* out,
                          size_t n) {
    for (size_t i = 0; i < n; ++i) {
        out[2 * i] = xi[i];
        out[2 * i + 1] = xq[i];
    }
}

// --------------------------- readahead loader --------------------------------

// Simple positional read: returns bytes read, -1 on error.
long iq_pread(int fd, uint8_t* out, size_t n, long offset) {
    size_t got = 0;
    while (got < n) {
        ssize_t r = pread(fd, out + got, n - got, offset + (long)got);
        if (r < 0) return -1;
        if (r == 0) break;
        got += (size_t)r;
    }
    return (long)got;
}

int iq_native_abi_version(void) { return 2; }

}  // extern "C"
