// One-sided all-to-all between the D ranks of a mesh:
//   out[s] = x_s[my]   for every rank s (x_s: rank s's input [D, chunk])
// the semantics of jax.lax.all_to_all(x, axis, 0, 0, tiled=False).
//
// Replaces deepgemm_tpu/parallel/collectives.py:_a2a_kernel (pl.pallas_call
// at collectives.py:75, _a2a_call), with its entry barrier
// (deepgemm_tpu/kernels/common.py:89, ici_entry_barrier).
//
// Design: one persistent launch a rank, G blocks (the card's SMs shared out
// between the ranks on it, so every rank's grid fits beside the others':
// a rank that spins on a peer never keeps that peer's blocks off the card).
// Each rank: the entry barrier (comm.cuh); then every block stores its
// 1/G share of chunk dst into slot [my] of rank dst's receive region, for
// every dst (its own slot first, then my+1, my+2, ...: on several cards
// every link is busy at once); fence and one arrival at every rank; then,
// slot by slot as each source's G arrivals are in, its 1/G share of the
// slot into ``out`` (read through L2). The receive region is the
// symmetric buffer's and outlives the call, so the result is copied out:
// the next call may overwrite the region as soon as this rank has entered
// it.
//
// What bounds it on the H100: bytes. The function reads x once and writes
// out once (2 x D x chunk bytes a rank) over 3.35 TB/s when the ranks share
// one card; this kernel moves twice that (the stores into the receive
// region and the copy-out). Across cards the off-rank bytes ride NVLink at
// 450 GB/s each way.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "comm.cuh"

namespace dgt {
namespace a2a {

__global__ void __launch_bounds__(512) a2a_kernel(const uint8_t* x, uint8_t* out, int64_t chunk,
                                                  comm::Peers c) {
    comm::entry_barrier(c);
    for (int p = 0; p < c.size; ++p) {
        const int dst = (c.rank + p) % c.size;
        comm::copy_part<false>(c.data(dst) + c.rank * chunk, x + dst * chunk, chunk, blockIdx.x,
                               gridDim.x);
    }
    comm::signal_all(c, comm::kArrive);
    for (int p = 0; p < c.size; ++p) {
        const int src = (c.rank - p + c.size) % c.size;
        comm::wait_from(c, comm::kArrive, src);
        comm::copy_part<true>(out + src * chunk, c.data(c.rank) + src * chunk, chunk, blockIdx.x,
                              gridDim.x);
    }
}

}  // namespace a2a
}  // namespace dgt

// x and out [size, chunk] bytes on this rank's device; table [2, size] int64
// (the symmetric buffer's data and pad addresses; its data region holds at
// least size * chunk bytes); epoch the call's count on the buffer; blocks
// the grid (the same on every rank); diag null or 8 pinned words. Returns
// the launch's cudaError_t.
extern "C" int dgt_a2a(const void* x, void* out, long long chunk, const void* table, int rank,
                       int size, unsigned long long epoch, int blocks, long long timeout_ns,
                       void* diag, void* stream) {
    dgt::comm::Peers c = {static_cast<const int64_t*>(table), rank, size, epoch, timeout_ns,
                          static_cast<long long*>(diag)};
    dgt::a2a::a2a_kernel<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), chunk, c);
    return static_cast<int>(cudaGetLastError());
}

// Mapped, zeroed pinned host memory for the kernels' diagnostic words:
// written by a spin that times out, readable by the host after the trap has
// ended the context. Returns a cudaError_t; *host and *dev the two views.
extern "C" int dgt_diag_alloc(long long bytes, void** host, void** dev) {
    cudaError_t err = cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return static_cast<int>(err);
    memset(*host, 0, bytes);
    return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

extern "C" int dgt_diag_free(void* host) { return static_cast<int>(cudaFreeHost(host)); }

// Enable dev's access to peer's memory (idempotent). Returns a cudaError_t.
extern "C" int dgt_enable_peer_access(int dev, int peer) {
    int before = 0;
    cudaError_t err = cudaGetDevice(&before);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaSetDevice(dev);
    if (err == cudaSuccess) {
        err = cudaDeviceEnablePeerAccess(peer, 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();
            err = cudaSuccess;
        }
    }
    cudaSetDevice(before);
    return static_cast<int>(err);
}

extern "C" const char* dgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
