// One-sided communication between the ranks of a mesh: the entry barrier,
// arrival signals and block-shared copies of the port's communicating
// kernels (a2a.cu, mega_ep.cu).
//
// Replaces deepgemm_tpu/kernels/common.py:89 (ici_entry_barrier, the
// counterpart of the reference's nvlink_barrier in comm/barrier.cuh:46-89)
// and the semaphore protocol of the JAX package's remote copies.
//
// A rank's symmetric buffer (parallel/dist.py:symmetric) is a data region
// and a signal pad of u64 counters, kPadKinds kinds of kPadRanks slots; slot
// [kind][src] of rank r is written only by rank src. A kernel takes the
// table of every rank's data and pad addresses (one card: local addresses;
// several cards of one host: NVLink addresses), its rank and D.
//
// Protocol, per call with epoch n (the host's count of calls on the buffer,
// 1, 2, ...; it only grows, so no receiver ever resets a signal and no reset
// can race with the next call's sender):
//   * entry barrier: block 0 stores n into slot [kBarrier][my] of every
//     peer (st.release.sys); every block waits until its own slots
//     [kBarrier][src] hold at least n (ld.acquire.sys). A rank enters call n
//     only after its stream has finished call n-1, including whatever read
//     its buffer after call n-1's kernel, so no store of call n lands in a
//     buffer that its owner still reads.
//   * arrival: after its stores to every rank, each block fences
//     (__threadfence_system, the fence.sc/acq_rel at sys scope, by every
//     thread) and adds 1 to slot [kind][my] of every rank (red.release.sys).
//     Every rank's grid has the same number of blocks G, so rank src's
//     stores of call n have all landed once slot [kind][src] reaches n * G.
//     The reader acquires before it loads; data written during the kernel is
//     read through L2 (cp.async.cg, ld.global.cg), not the incoherent L1.
//   * every spin is bounded by %globaltimer: past timeout_ns it writes a
//     diagnostic (flag, rank, kind, src, value seen, target, block) to
//     pinned host memory that outlives the context, and traps (the
//     reference's 60 s watchdog). A deadlock is an error, never a hang.
// The same code is right across NVLink: every signal and fence is at sys
// scope.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dgt {
namespace comm {

constexpr int kPadRanks = 64;
enum Kind { kBarrier = 0, kArrive = 1, kCombine = 2 };

struct Peers {
    const int64_t* table;      // [2, size]: data addresses, then pad addresses
    int rank, size;
    unsigned long long epoch;  // this call's count on the buffer: 1, 2, ...
    long long timeout_ns;
    long long* diag;           // this rank's 8 diagnostic words (pinned host), or null

    __device__ __forceinline__ uint8_t* data(int r) const {
        return reinterpret_cast<uint8_t*>(table[r]);
    }
    __device__ __forceinline__ unsigned long long* slot(int r, int kind, int src) const {
        return reinterpret_cast<unsigned long long*>(table[size + r]) + kind * kPadRanks + src;
    }
};

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
    asm volatile("st.release.sys.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_release_add(unsigned long long* p, unsigned long long v) {
    asm volatile("red.release.sys.global.add.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// One thread: spin until this rank's slot [kind][src] holds at least target
// (inline, for a caller whose registers setmaxnreg has cut: the dispatch
// kernel's producer lane; others call wait_at_least).
__device__ __forceinline__ void spin_until(const Peers& c, int kind, int src,
                                           unsigned long long target) {
    const unsigned long long* p = c.slot(c.rank, kind, src);
    unsigned long long v = ld_acquire(p);
    if (v >= target) return;
    const unsigned long long t0 = globaltimer();
    while ((v = ld_acquire(p)) < target) {
        if (globaltimer() - t0 > static_cast<unsigned long long>(c.timeout_ns)) {
            if (c.diag != nullptr) {
                volatile long long* d = c.diag;
                d[1] = c.rank;
                d[2] = kind;
                d[3] = src;
                d[4] = static_cast<long long>(v);
                d[5] = static_cast<long long>(target);
                d[6] = blockIdx.x;
                __threadfence_system();
                d[0] = 1;
                __threadfence_system();
            }
            __trap();
        }
        __nanosleep(64);
    }
}

__device__ __noinline__ void wait_at_least(const Peers& c, int kind, int src,
                                           unsigned long long target) {
    spin_until(c, kind, src, target);
}

// Every block: no store of this call reaches a peer before that peer has
// entered the call.
__device__ __forceinline__ void entry_barrier(const Peers& c) {
    if (threadIdx.x == 0) {
        if (blockIdx.x == 0)
            for (int r = 0; r < c.size; ++r)
                if (r != c.rank) st_release(c.slot(r, kBarrier, c.rank), c.epoch);
        for (int r = 0; r < c.size; ++r)
            if (r != c.rank) wait_at_least(c, kBarrier, r, c.epoch);
    }
    __syncthreads();
}

// Every block, after its stores of this call to every rank: one arrival
// of ``kind`` at every rank (this one included).
__device__ __forceinline__ void signal_all(const Peers& c, int kind) {
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0)
        for (int r = 0; r < c.size; ++r) red_release_add(c.slot(r, kind, c.rank), 1ull);
}

// Every block: wait until all of rank src's blocks have arrived (``kind``).
__device__ __forceinline__ void wait_from(const Peers& c, int kind, int src) {
    if (threadIdx.x == 0) wait_at_least(c, kind, src, c.epoch * gridDim.x);
    __syncthreads();
}

// This block's share (part ``part`` of ``parts`` contiguous parts) of a copy
// of ``bytes`` bytes, in 16-byte words where both ends and the size allow,
// else 4-byte words, else bytes. ``cg``: read through L2 only (data that
// peers stored during this kernel).
template <bool kCg>
__device__ __forceinline__ void copy_part(uint8_t* dst, const uint8_t* src, int64_t bytes,
                                          int part, int parts) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)
                          | static_cast<uintptr_t>(bytes);
    auto run = [&](auto word) {
        using T = decltype(word);
        const int64_t n = bytes / static_cast<int64_t>(sizeof(T));
        const int64_t per = (n + parts - 1) / parts;
        const int64_t lo = per * part, hi = lo + per < n ? lo + per : n;
        const T* s = reinterpret_cast<const T*>(src);
        T* d = reinterpret_cast<T*>(dst);
        for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
            if constexpr (kCg) d[i] = __ldcg(s + i);
            else d[i] = s[i];
        }
    };
    if ((align & 15) == 0) run(uint4{});
    else if ((align & 3) == 0) run(0u);
    else run(static_cast<unsigned char>(0));
}

}  // namespace comm
}  // namespace dgt
