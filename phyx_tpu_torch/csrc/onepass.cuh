// The single-pass scan of K4 and K6 (csrc/sweep_tiled.cu,
// csrc/sweep_emit.cu), and the bulk copy K6 stages its chunks with.
//
// Both kernels write pairs in a serial emission order cut at max_pairs.
// The order is cut into tiles; the blocks take them by an atomic ticket,
// so the tiles start in their order and a tile only ever waits on tiles
// that have already started: forward progress needs no co-residency.
// A tile counts its hits, publishes that count (its aggregate), then looks
// back over the earlier tiles' published aggregates and inclusive prefixes
// for its first slot (the decoupled look-back of Merrill and Garland's
// single-pass prefix scan), publishes its inclusive prefix and writes its
// pairs.  No torch operation runs between count and write.
//
// The grid is persistent (as many blocks as stay resident): a block takes
// tiles by ticket until they are all taken, then one ticket more, and
// exits.  The scratch (Scan) is kept by the wrapper per device, stream and
// shape and zeroed once.  It needs no memset per call and nothing of the
// call from the host: the ticket counter's high word counts the finished
// calls modulo 2^30 - 1 and its low word the call's tickets.  A call's
// number (its epoch) is the count it reads in its tickets, plus one: the
// epochs run 1 .. 2^30 - 1 and then again from 1, so an epoch comes back
// only after 2^30 - 1 calls.  The block that takes the call's last ticket
// (the kernel knows its number: every block takes one past the work)
// raises the count and clears the tickets for the next call, whose blocks
// start after this launch ends.  Every flag a call publishes carries its
// epoch, so a flag of another call reads as not yet published.  So a
// launch captured in a CUDA graph computes on every replay what it
// computes when run.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace phyx {
namespace onepass {

constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;  // a flag's state
// a wait that has not ended after this many tries is a fault of the
// schedule: the kernel traps (a launch error) instead of hanging the card
constexpr unsigned kMaxTries = 1u << 26;
// the epochs, taken in turn: a flag holds 30 bits of one, and 0 is none
constexpr unsigned kEpochs = (1u << 30) - 1u;

struct Scan {
  unsigned long long* ticket;  // (1) finished calls % kEpochs << 32 |
                               //     the call's tickets
  unsigned* flag;              // (ntiles) epoch << 2 | state
  long long* agg;              // (ntiles) a tile's count
  long long* incl;             // (ntiles) the counts of tiles [0, i]
  int ntiles;
};

struct Tile {
  int index;       // in the emission order (a ticket, before it is mapped)
  unsigned epoch;  // the call's
  unsigned calls;  // the calls finished before it, modulo kEpochs
};

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// a word another block wrote: read at the device's point of coherence
__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float load_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The block's next ticket of this call, 0, 1, 2, ... (the kernel maps it
// to a tile, or stops past the last), and the call's epoch.  Every thread
// of the block (barriers: the block's shared memory of the tile before is
// free after it).
__device__ __forceinline__ Tile take(const Scan& sc) {
  __shared__ unsigned long long s_ticket;
  __syncthreads();
  if (threadIdx.x == 0) s_ticket = atomicAdd(sc.ticket, 1ull);
  __syncthreads();
  const unsigned long long t = s_ticket;
  const unsigned calls = static_cast<unsigned>(t >> 32);
  const unsigned long long i = t & 0xffffffffull;
  return {i < 0x7fffffffull ? static_cast<int>(i) : 0x7fffffff, calls + 1u,
          calls};
}

// By the block holding the call's last ticket, when every ticket of the
// call has been taken: the call counts as finished and the next one's
// tickets start at 0; the count stays below kEpochs.  One thread.
__device__ __forceinline__ void finish_call(const Scan& sc, Tile t) {
  atomicExch(sc.ticket, static_cast<unsigned long long>(
                            (t.calls + 1u) % kEpochs) << 32);
}

// The persistent grid of `kernel`: as many blocks as the card keeps
// resident at once, at most ntiles.  Host side.
template <class Kernel>
inline int resident_grid(Kernel kernel, int threads, int ntiles) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  const int grid = sms * per_sm;
  return grid < ntiles ? grid : ntiles;
}

// Publishes the tile's aggregate, or its inclusive prefix: the value, then
// the flag with release order.  One thread.
__device__ __forceinline__ void publish(const Scan& sc, Tile t,
                                        long long value, bool inclusive) {
  (inclusive ? sc.incl : sc.agg)[t.index] = value;
  store_release(&sc.flag[t.index],
                t.epoch << 2 | (inclusive ? kInclusive : kAggregate));
}

// The counts of tiles [0, t.index): lane L reads tile top - L of a
// 32-tile window; the window is read again until every tile in it has
// published; the sum stops at the nearest inclusive prefix, else goes on
// to the next window.  One warp, every lane; the result on every lane.
__device__ __forceinline__ long long look_back(const Scan& sc, Tile t,
                                               int lane) {
  long long excl = 0;
  unsigned tries = 0;
  for (int top = t.index - 1; top >= 0;) {
    const int i = top - lane;
    unsigned state = kInclusive;  // before tile 0: an inclusive 0
    long long v = 0;
    if (i >= 0) {
      const unsigned f = load_acquire(&sc.flag[i]);
      state = (f >> 2) == t.epoch ? (f & 3u) : 0u;
      if (state == kInclusive)
        v = load_relaxed(&sc.incl[i]);
      else if (state == kAggregate)
        v = load_relaxed(&sc.agg[i]);
    }
    if (__any_sync(kAll, state == 0u)) {
      if (++tries == kMaxTries) __trap();
      __nanosleep(64);
      continue;
    }
    const unsigned inc = __ballot_sync(kAll, state == kInclusive);
    // lanes up to the nearest inclusive prefix (all 32 without one)
    if (inc && lane > __ffs(inc) - 1) v = 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    excl += v;
    if (inc) break;
    top -= 32;
  }
  return excl;
}

// ---- the bulk copy (TMA) and its mbarrier ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: a barrier for one arrival, visible to the async proxy.
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(b))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread, before bulk copies into shared memory that threads read
// (generic proxy) for the tile before: orders those reads first.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: the barrier's arrival, expecting `bytes` to land.
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory; the barrier counts them when they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// waits until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  for (unsigned tries = 0;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (++tries == kMaxTries) __trap();
  }
}

}  // namespace onepass
}  // namespace phyx
