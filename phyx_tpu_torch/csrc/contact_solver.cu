// K2, the fused sequential-impulse solve on Hopper (sm_90a): one block, the
// solve run level by level with every operand of a visit on chip.
//
// Replaces the TPU kernel phyx_tpu/kernels/contact_solver.py,
// _solver_kernel (line 50), called through solve_contacts_fused.  It
// computes what that kernel computes, and what the streamed kernel K1
// (contact_solver_streamed.cu) computes, to the bit: one warm-start pass,
// vel_iters velocity passes and pos_iters displacement passes, each
// visiting the contact rows [0, num) and then the joint rows [c_cap,
// c_cap + numj), with the runtime residual gates read from tols.
//
// What bounds it: latency.  The frames that take K2 (4 (8 N + 4 R) bytes
// within one block's shared memory, contact_solver.fits) move ~0.3 MB; the
// time is the chain of dependent visits, each ~40 dependent float
// operations at -fmad=false on two body rows the visit before may have
// written.  The serial walk this kernel had before (one thread, the body
// table in shared memory, the ids and rows read from L2 on the visit's
// dependent path) took ~300 ns a visit.
//
// The design, one launch of one block:
// - The pre-pass of levels.cuh over K1's RowsMap (the same schedule as K1,
//   so K1 == K2 by construction) runs first in the same block: every visit
//   gets its level in the dependency graph, the visits are bucketed by
//   level into 80-byte records in device memory (L2), the level offsets
//   and the accumulators in level order stay in shared memory, the
//   last-level array sits in shared memory while the pre-pass runs.
// - The three working columns of every body (0-2 in the warm and velocity
//   passes, 5-7 in the displacement passes) and the level offsets are in
//   shared memory; so are the accumulators of the live rows where they fit
//   beside the ring (fused_layout in kernels/contact_solver.py decides from
//   the capacities), else in device memory.
// - A producer warp (warp 0) streams the records of every pass, in level
//   order, into a ring of kStages stages of kStage records in shared
//   memory with cp.async.bulk (TMA), one bulk copy a stage; a full and an
//   empty mbarrier a stage pace it against the solving warps, and it
//   sleeps between its tries.  A solving thread waits on a stage's full
//   barrier once, at its first record there, and reads its record and
//   that record's accumulators from shared memory, so no visit waits on
//   L2.  The producer may run into the next pass's records before the
//   gate has decided whether that pass runs; the solving warps raise a
//   stop flag after their last pass and the producer drains what it
//   issued.
// - A level of at most kNarrow visits is solved by solver warp 0 (warp 1)
//   alone, lane L taking the level's record L, with __syncwarp() between
//   levels; the other solving warps skip the run of narrow levels.  A wider
//   level takes all kSolvers solving threads (kSolvers records a step),
//   with a named barrier over the solving warps (not the producer) before
//   it when a narrow run came before, and after each step.  Every solving
//   thread reads the same offsets, so every thread takes the same branch.
//   Record pos belongs to the same thread in every pass, so its
//   accumulators are read by the thread that wrote them in the previous
//   pass.
// - A narrow run is a single warp's dependent chain, where each
//   instruction of bookkeeping costs its latency: its loop is kept to the
//   visit, a warp sync and a few integer operations, and the next level's
//   bounds and record are loaded before the visit (unrolled twice, so the
//   two records swap roles without a copy).
// - The residual is a max_p over every visit, reduced across the solving
//   warps in one fixed order, so every thread takes the same gate.
// The ring: 16 stages of 32 records (40,960 bytes); a wide step (128
// records) spans at most 5 stages, a narrow level and the one loaded
// ahead of it (64 records) at most 3.
// Built with -fmad=false, as every solve kernel.

#include <cstdint>

#include <cuda_runtime.h>

#include "levels.cuh"

namespace {

using phyx::levels::Item;
using phyx::levels::kPos;
using phyx::levels::kVel;
using phyx::levels::kWarm;
using phyx::levels::RowsMap;

constexpr int kSolvers = 128;                 // the solving threads
constexpr int kSolverWarps = kSolvers / 32;
constexpr int kThreads = 32 + kSolvers;       // the producer warp first
constexpr int kNarrow = 32;                   // the widest level of one warp
constexpr int kStage = 32;                    // records a ring stage
constexpr int kStages = 16;                   // the ring's depth
constexpr int kRecFloats = 20;                // an 80-byte record
constexpr int kStageBytes = kStage * kRecFloats * 4;
// a wide step, or two narrow levels, span at most this many stages
static_assert(kSolvers / kStage + 1 <= kStages, "ring too shallow");
// one block's 227 KB of shared memory less 1 KB for the static part
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kSolverBar = 1;                 // named barrier of the solvers

// ---- the shared-memory layout (mirrored by fused_layout in Python) ----

struct Layout {
  int bars, ring, cols, acc, loff, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

// kStages full and empty barriers; the ring (the pre-pass's last-level
// array while it runs); the columns (12 N bytes); the accumulators in level
// order (16 R bytes, acc_smem); the level offsets (R + 1 ints)
__host__ __device__ inline Layout layout(int n, int r, bool acc_smem) {
  Layout L;
  L.bars = 0;
  L.ring = up16(16 * kStages);
  const int ring = kStages * kStageBytes;
  L.cols = L.ring + up16(ring > 4 * n ? ring : 4 * n);
  L.acc = L.cols + up16(12 * n);
  L.loff = L.acc + (acc_smem ? 16 * r : 0);
  L.total = L.loff + up16(4 * (r + 1));
  return L;
}

// ---- mbarriers, the bulk copy and the solvers' barrier ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* b, int parity) {
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
  return done != 0;
}

// a wait that has not ended after this many tries is a fault of the
// schedule: the kernel traps (a launch error) instead of hanging the card
constexpr unsigned kMaxTries = 1u << 28;

// waits until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  for (unsigned tries = 0; !mbar_try_wait(b, parity);)
    if (++tries == kMaxTries) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) from device memory into shared memory; the
// barrier completes its transaction count when they have landed
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

__device__ __forceinline__ void solvers_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kSolverBar), "n"(kSolvers)
               : "memory");
}

// ---- the producer ----

// Streams stage s of every pass (records [s kStage, (s + 1) kStage) of v)
// into ring slot g mod kStages, g the stage's index in the stream, once
// the stage before it in that slot is released; at most max_passes passes,
// until the solvers raise stop.  Then waits for the copies still in
// flight.  Run by one thread, which sleeps between its tries so that it
// takes no issue slots from the solving warps.
__device__ void produce(const float* rec, float* ring, uint64_t* full,
                        uint64_t* empty, int v, int max_passes,
                        const volatile int* stop) {
  const int nsp = (v + kStage - 1) / kStage;
  const int total = nsp * max_passes;
  int issued = 0;
  for (int g = 0; g < total; ++g) {
    const int slot = g % kStages;
    if (g >= kStages) {
      const int parity = (g / kStages - 1) & 1;
      bool free = false;
      for (unsigned tries = 0;
           !(free = mbar_try_wait(&empty[slot], parity)) && !*stop;) {
        if (++tries == kMaxTries) __trap();
        __nanosleep(100);
      }
      if (!free) break;
    }
    const int s = g % nsp;
    const int n = min(kStage, v - s * kStage);
    const int bytes = n * kRecFloats * 4;
    mbar_expect(&full[slot], bytes);
    bulk_load(ring + slot * kStage * kRecFloats,
              rec + static_cast<size_t>(s) * kStage * kRecFloats, bytes,
              &full[slot]);
    issued = g + 1;
  }
  for (int g = issued > kStages ? issued - kStages : 0; g < issued; ++g)
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
}

// ---- the solving warps ----

struct Ring {
  const float4* ring;
  uint64_t* full;
  uint64_t* empty;
  int nsp, v;
};

// Solver 0 releases the stream stages wholly below record b of the pass
// (all of the pass's at its end).
__device__ __forceinline__ void release(const Ring& rg, unsigned gbase,
                                        unsigned b, unsigned& released) {
  const unsigned upto =
      gbase + (b == static_cast<unsigned>(rg.v) ? rg.nsp : b / kStage);
  for (; released < upto; ++released)
    mbar_arrive(&rg.empty[released % kStages]);
}

__device__ __forceinline__ bool narrow(const int* loff, int l) {
  return loff[l + 1] - loff[l] <= kNarrow;
}

// Waits until the stages of records [ready, end) of the pass whose first
// stream stage is gbase have landed, and moves ready to the end of the
// last.  Every stage waited on must be unreleased (its slot's parity is
// then unambiguous): ready starts at a stage the caller still holds.
__device__ __forceinline__ void wait_landed(const Ring& rg, unsigned gbase,
                                            unsigned end, unsigned& ready) {
  for (; ready < end; ready += kStage) {
    const unsigned g = gbase + ready / kStage;
    mbar_wait(&rg.full[g % kStages], (g / kStages) & 1);
  }
}

// record pos of the pass (its stage has landed) into it
__device__ __forceinline__ void read_record(Item& it, const Ring& rg,
                                            unsigned gbase, unsigned pos) {
  const unsigned slot = (gbase + pos / kStage) % kStages;
  const float4* r = rg.ring + (slot * kStage + pos % kStage) * 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) it.r[k] = r[k];
}

// the record and its accumulators
__device__ __forceinline__ void read(Item& it, const Ring& rg,
                                     unsigned gbase, unsigned pos,
                                     const float4* acc4) {
  read_record(it, rg, gbase, pos);
  it.a = acc4[pos];
}

// Solver warp 0's run of narrow levels from level l: lane L visits record
// lo + L of each, a __syncwarp() between levels.  The next level's bounds
// are loaded before the visit and this lane's record in it after, without
// a branch (the loop is unrolled twice, so the two records swap roles
// without a copy; unconditional and after the visit, the read took ~5 %
// off a narrow level, k2_anatomy.py).  The
// waits for landed stages and the releases of consumed ones are taken by
// the whole warp at once, when a level crosses a stage's end, so a level
// costs one compare of each.  ready (the records known to have landed,
// in whole stages) starts at the run's first stage, the same in every
// lane.  Returns the first level after the run.
template <int kKind, bool kJoints>
__device__ __forceinline__ int narrow_run(int l, unsigned gbase,
                                          const int* loff, int n_levels,
                                          float* cols, float4* acc4,
                                          const Ring& rg, int lane,
                                          unsigned& ready,
                                          unsigned& released, float& r) {
  unsigned lo = loff[l], hi = loff[l + 1];
  unsigned hi2 = l + 1 < n_levels ? loff[l + 2] : hi;
  // the record count whose consumption releases the next stage (every
  // stage wholly below lo is released)
  unsigned next_release = (lo / kStage + 1) * kStage;
  ready = lo / kStage * kStage;
  Item a, b;
  bool has = lo + lane < hi;
  wait_landed(rg, gbase, hi, ready);
  if (has) read(a, rg, gbase, lo + lane, acc4);
  // one level with its record in cur, the next level's loaded into nxt;
  // false when the next level is no narrow one of this pass
  auto level = [&](Item& cur, Item& nxt) {
    const bool more = l + 1 < n_levels && hi2 - hi <= kNarrow;
    const unsigned hi3 = l + 2 < n_levels ? loff[l + 3] : hi2;
    const bool has_next = more && hi + lane < hi2;
    if (more && hi2 > ready) wait_landed(rg, gbase, hi2, ready);
    if (has)
      r = phyx::max_p(r, phyx::levels::visit<kKind, kJoints, true>(
                             cur, cols, nullptr, acc4, lo + lane));
    // where this lane has no record in the next level, this level's first
    // (resident, and read-only here) stands in, so the read needs no branch
    read_record(nxt, rg, gbase, has_next ? hi + lane : lo);
    if (has_next) nxt.a = acc4[hi + lane];
    __syncwarp();
    if (hi >= next_release || hi == static_cast<unsigned>(rg.v)) {
      if (lane == 0) release(rg, gbase, hi, released);
      next_release = (hi / kStage + 1) * kStage;
    }
    ++l;
    lo = hi;
    hi = hi2;
    hi2 = hi3;
    has = has_next;
    return more;
  };
  while (level(a, b) && level(b, a)) {
  }
  return l;
}

// One pass over every level; returns the thread's max_p of its visits'
// residual terms (0 in the warm pass).  t: the solver index; released:
// the stream stages released so far (kept by solver 0).  Runs of narrow
// levels are solver warp 0's while the other warps skip to the next wide
// level; a wide level takes every solver, kSolvers records a step, with
// the solvers' barrier before it (after a narrow run) and after each step.
template <int kKind, bool kJoints>
__device__ __forceinline__ float solve_pass(int pass, const int* loff,
                                            int n_levels, float* cols,
                                            float4* acc4, const Ring& rg,
                                            int t, unsigned& released) {
  float r = 0.0f;
  const unsigned gbase = static_cast<unsigned>(pass) * rg.nsp;
  unsigned ready = 0;
  bool after_narrow = true;
  int l = 0;
  while (l < n_levels) {
    if (narrow(loff, l)) {
      if (t < 32) {
        l = narrow_run<kKind, kJoints>(l, gbase, loff, n_levels, cols, acc4,
                                       rg, t, ready, released, r);
      } else {
        while (l < n_levels && narrow(loff, l)) ++l;
      }
      after_narrow = true;
      continue;
    }
    if (after_narrow) solvers_sync();
    after_narrow = false;
    const unsigned hi = loff[l + 1];
    for (unsigned a = loff[l]; a < hi; a += kSolvers) {
      const unsigned pos = a + t;
      if (pos < hi) {
        Item it;
        if (pos >= ready) {
          // its own stage only: the stages between may be recycled
          ready = pos / kStage * kStage;
          wait_landed(rg, gbase, pos + 1, ready);
        }
        read(it, rg, gbase, pos, acc4);
        r = phyx::max_p(r, phyx::levels::visit<kKind, kJoints, true>(
                               it, cols, nullptr, acc4, pos));
      }
      solvers_sync();
      if (t == 0) release(rg, gbase, min(a + kSolvers, hi), released);
    }
    ++l;
  }
  return r;
}

// max_p across the solving warps, the same value in every solving thread
__device__ __forceinline__ float solvers_max(float r, float* red, int t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = phyx::max_p(r, __shfl_xor_sync(phyx::levels::kFull, r, o));
  if ((t & 31) == 0) red[t >> 5] = r;
  solvers_sync();
  float m = 0.0f;
  for (int w = 0; w < kSolverWarps; ++w) m = phyx::max_p(m, red[w]);
  solvers_sync();
  return m;
}

// the working columns out to columns out..out+2 of the table and, with in,
// columns 5-7 in from it; by the solving threads
__device__ __forceinline__ void swap_cols(float* cols, float* body_out,
                                          const float* body_in, int n,
                                          int out, bool in, int t) {
  for (int b = t; b < n; b += kSolvers) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      body_out[8 * b + out + c] = cols[3 * b + c];
      if (in) cols[3 * b + c] = body_in[8 * b + 5 + c];
    }
  }
}

// The whole solve.  iscratch: lvl, cursor, slot_s (R ints each);
// fscratch: rec (20 R floats), then acc_s (4 R) when the accumulators are
// in device memory.  Warp 0 is the producer, the other kSolverWarps solve.
// solve = false runs the pre-pass alone.
template <bool kJoints, bool kAccSmem>
__global__ void __launch_bounds__(kThreads) contact_solve_fused(
    const float* __restrict__ body_in, float* __restrict__ body_out,
    RowsMap map, float* __restrict__ acc_out, float* __restrict__ res_out,
    const float* __restrict__ tols, int* __restrict__ iscratch,
    float* __restrict__ fscratch, int n_cap, int vel_iters, int pos_iters,
    bool solve) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kSolverWarps];
  __shared__ int s_nlev;
  __shared__ int s_stop;
  const int r = map.c_cap + map.j_cap;
  const Layout L = layout(n_cap, r, kAccSmem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* cols = reinterpret_cast<float*>(smem + L.cols);
  int* loff = reinterpret_cast<int*>(smem + L.loff);
  int* lvl = iscratch;
  int* cursor = iscratch + r;
  int* slot_s = iscratch + 2 * r;
  float* rec = fscratch;
  float* acc_s = kAccSmem ? reinterpret_cast<float*>(smem + L.acc)
                          : fscratch + kRecFloats * static_cast<size_t>(r);
  const int tid = threadIdx.x;

  if (solve) {
    for (int i = tid; i < 8 * n_cap; i += kThreads) body_out[i] = body_in[i];
    for (int i = tid; i < 4 * r; i += kThreads) acc_out[i] = 0.0f;
    for (int b = tid; b < n_cap; b += kThreads) {
#pragma unroll
      for (int c = 0; c < 3; ++c) cols[3 * b + c] = body_in[8 * b + c];
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    s_stop = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  phyx::levels::prepass<false>(map, body_in, n_cap, nullptr,
                               reinterpret_cast<int*>(ring), nullptr, lvl,
                               cursor, loff, &s_nlev, slot_s, rec, acc_s,
                               nullptr);
  // the records (and the last-level array in the ring's place) were
  // written by the generic proxy; the bulk copies read and write through
  // the async proxy
  asm volatile("fence.proxy.async;" ::: "memory");
  __syncthreads();
  if (!solve) return;
  const int n_levels = s_nlev;
  const int v = loff[n_levels];

  if (tid < 32) {
    if (tid == 0)
      produce(rec, ring, full, empty, v, 1 + vel_iters + pos_iters, &s_stop);
  } else {
    const int t = tid - 32;
    const Ring rg{reinterpret_cast<const float4*>(ring), full, empty,
                  (v + kStage - 1) / kStage, v};
    float4* acc4 = reinterpret_cast<float4*>(acc_s);
    unsigned released = 0;
    int pass = 0;
    solve_pass<kWarm, kJoints>(pass++, loff, n_levels, cols, acc4, rg, t,
                               released);
    float res = 0.0f;
    bool converged = false;
    for (int p = 0; p < vel_iters && !converged; ++p) {
      res = solvers_max(solve_pass<kVel, kJoints>(pass++, loff, n_levels,
                                                  cols, acc4, rg, t,
                                                  released),
                        red, t);
      converged = res < tols[0];
    }
    solvers_sync();
    swap_cols(cols, body_out, body_in, n_cap, 0, pos_iters > 0, t);
    solvers_sync();
    converged = false;
    for (int p = 0; p < pos_iters && !converged; ++p) {
      const float pres = solvers_max(
          solve_pass<kPos, kJoints>(pass++, loff, n_levels, cols, acc4, rg,
                                    t, released),
          red, t);
      converged = pres < tols[1];
    }
    solvers_sync();
    if (pos_iters > 0)
      swap_cols(cols, body_out, body_in, n_cap, 5, false, t);
    if (t == 0) {
      *reinterpret_cast<volatile int*>(&s_stop) = 1;
      *res_out = res;
    }
  }
  __syncthreads();
  for (int pos = tid; pos < v; pos += kThreads)
    reinterpret_cast<float4*>(acc_out)[slot_s[pos]] =
        reinterpret_cast<const float4*>(acc_s)[pos];
}

}  // namespace

// Plain C entry for ctypes: raises the kernel's dynamic shared memory limit
// to what this call needs, launches on `stream` and returns the first CUDA
// error (0 = launched; cudaErrorInvalidValue when the layout does not fit
// one block).  Pointers are device pointers; num_joints may be null (no
// joint rows).  iscratch holds 3 R ints, fscratch 20 R floats (24 R when
// acc_smem is 0).  acc_smem puts the accumulators in shared memory
// (fused_layout in kernels/contact_solver.py chooses from the capacities).
// solve = 0 runs the pre-pass alone (for timing it).
extern "C" int phyx_contact_solve_fused(
    const void* body_in, void* body_out, const void* b1, const void* b2,
    const void* con, const void* warm, void* acc, void* res, const void* num,
    const void* num_joints, const void* tols, int n_cap, int c_cap,
    int j_cap, int vel_iters, int pos_iters, void* iscratch, void* fscratch,
    int acc_smem, int solve, void* stream) {
  const Layout L = layout(n_cap, c_cap + j_cap, acc_smem != 0);
  if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const bool joints = num_joints != nullptr;
  const auto kernel =
      joints ? (acc_smem ? contact_solve_fused<true, true>
                         : contact_solve_fused<true, false>)
             : (acc_smem ? contact_solve_fused<false, true>
                         : contact_solve_fused<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RowsMap map{static_cast<const int*>(b1),
                    static_cast<const int*>(b2),
                    static_cast<const float*>(con),
                    static_cast<const float*>(warm),
                    static_cast<const int*>(num),
                    static_cast<const int*>(num_joints),
                    n_cap, c_cap, j_cap, 0};
  kernel<<<1, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(body_in), static_cast<float*>(body_out), map,
      static_cast<float*>(acc), static_cast<float*>(res),
      static_cast<const float*>(tols), static_cast<int*>(iscratch),
      static_cast<float*>(fscratch), n_cap, vel_iters, pos_iters,
      solve != 0);
  return static_cast<int>(cudaGetLastError());
}
