// K4, the slab-windowed sweep-and-prune on Hopper (sm_90a).
//
// Replaces the TPU kernel phyx_tpu/kernels/sweep.py, sweep_emit_tiled (line
// 114).  Rows are the bodies sorted by (banded) min x, padded to
// (n_slabs - 1) * stride + window rows (broadphase._sap_tiled_sort_stage).
// Slab s (base = s * stride) starts a sweep at each row k < min(stride,
// nact - base); the sweep walks the candidates j = k+1, k+2, ... of the
// slab's window while j < window, base + j < nact and xlo[j] <= xhi[k], and
// emits (order[k], order[j]) where the y-intervals overlap, one of the two
// is dynamic and, with exact_x, the true x-intervals overlap too
// (tlo[j] <= thi[k]).  Emissions are ordered (slab, k, j); the first
// max_pairs are kept and the rest counted (ovf_drop).  A walk that reached
// j = window with rows past the window left (base + window < nact) and the
// last window row still open counts into ovf_window.  nact is read on the
// device.
//
// What the TPU kernel does that is not carried over: it copies each slab's
// window into SMEM and flushes a 1024-pair SMEM stage by DMA at a running
// append counter.  Here the rows stay in device memory as columns (280,576
// rows, ~9 MB, at the 1024-env scene: they sit in the 50 MB L2) and each
// walk reads its window in place.
//
// What bounds it: the bytes.  Every row is read once as a starter and by
// the walks that reach it, a handful of compares each, and the pairs are
// written once; the least time is the rows read once and the pairs written
// once over HBM's rate (chip_smoke.py).
//
// The design: one launch that counts, scans and writes (csrc/onepass.cuh's
// single-pass scan).  A tile is 256 consecutive sweeps in (slab, row)
// order, a thread a sweep; a persistent grid of resident blocks takes the
// tiles by ticket.  Each sweep is walked once, the serial break kept at
// the first candidate with !(xlo <= hix), so a NaN closes the walk.  A
// thread walks its sweep's first 32 candidates, their columns loaded 4 at
// a time (all within the window and the nact clamp, as the TPU walked 4 at
// a time); a sweep still open past them (an env's ground walks its ~256
// boxes) goes on the tile's list of long sweeps, which the whole block then
// walks one after another, 256 candidates a round (a warp's 32 a batch,
// __ballot_sync masks; the hits before the round's first closed
// candidate), so no block waits for one thread's long walk.  A hit takes a
// place in the tile's shared-memory stage (2,048 pairs), by an atomic on a
// shared counter for a thread's hit and for a round all its hits or none,
// with its sweep and its index h in that
// sweep's walk; a sweep that once misses a place stages no more, so each
// sweep's staged hits are a prefix of its walk.  A block scan of the
// sweeps' counts gives each its offset in the tile, the look-back the
// tile's first slot; a staged hit's place is its sweep's offset plus h, so
// the stage is put in (k, j) order in shared memory and goes out as
// contiguous stores.  A sweep with hits past the stage walks again, in the
// same launch, and writes those at their slots.  Slots at or past
// max_pairs are not written; only slots [0, num) are.  The last tile
// writes num, ovf_drop and ovf_window (the sum of the tiles' counts of
// walks open at their window end, each written before its tile's flag).

#include <cuda_runtime.h>

#include "onepass.cuh"

namespace {

namespace op = phyx::onepass;

constexpr int kSweeps = 256;  // a tile: consecutive sweeps, a thread each
constexpr int kStage = 2048;  // pairs a tile stages in shared memory
constexpr int kAhead = 4;     // candidates a thread loads at once
constexpr int kThreadWalk = 32;  // candidates a thread walks; then a warp

struct Rows {
  const float* xlo;  // walked: banded where banded keys are on
  const float* ylo;
  const float* xhi;
  const float* yhi;
  const float* tlo;  // true x-interval, read with exact_x only
  const float* thi;
  const int* dyn;
  const int* order;
  const int* nact;   // () rows that start sweeps, on the device
  int stride, window, n_sweeps;
};

Rows columns(const void* rows, const void* truex, const void* dyn,
             const void* order, const void* nact, int npad, int stride,
             int window, int n_slabs) {
  const float* r = static_cast<const float*>(rows);
  const float* t = static_cast<const float*>(truex);
  return {r,
          r + npad,
          r + 2 * npad,
          r + 3 * npad,
          t,
          t ? t + npad : nullptr,
          static_cast<const int*>(dyn),
          static_cast<const int*>(order),
          static_cast<const int*>(nact),
          stride,
          window,
          n_slabs * stride};
}

// Sweep u's source row (slab u / stride, row k = u % stride): its walk
// tests the candidates j in [k + 1, lim) of its slab's window.
struct Source {
  float hix, loy, hiy, thx;
  int di, base, k, lim;
};

template <bool kExact>
__device__ __forceinline__ Source source(const Rows& w, int u, int nact) {
  Source a;
  a.k = u % w.stride;
  a.base = u - a.k;
  a.hix = w.xhi[u];
  a.loy = w.ylo[u];
  a.hiy = w.yhi[u];
  a.thx = kExact ? w.thi[u] : 0.0f;
  a.di = w.dyn[u];
  a.lim = min(w.window, nact - a.base);
  return a;
}

// Candidate row q's accept test past the x test: y overlap, one dynamic,
// and with exact_x the true x-intervals.
template <bool kExact>
__device__ __forceinline__ bool accept(const Source& a, float yl, float yh,
                                       int d, float tl) {
  bool ok = yl <= a.hiy && a.loy <= yh && a.di + d > 0;
  if (kExact) ok = ok && tl <= a.thx;
  return ok;
}

// Whether a walk that ended at candidate j (not at a closed one) counts
// into ovf_window: it reached the window's end with rows past it, and the
// window's last row is open for it.
__device__ __forceinline__ bool window_open(const Rows& w, const Source& a,
                                            int j, int nact) {
  return j >= w.window && a.base + w.window < nact &&
         w.xlo[a.base + w.window - 1] <= a.hix;
}

// Walks sweep u serially (the hits past the stage), calling hit(q) for
// each emitted candidate row q in walk order.
template <bool kExact, class Hit>
__device__ __forceinline__ void walk(const Rows& w, int u, int nact,
                                     Hit hit) {
  const Source a = source<kExact>(w, u, nact);
  for (int j = a.k + 1; j < a.lim; ++j) {
    const int q = a.base + j;
    if (!(w.xlo[q] <= a.hix)) break;
    if (accept<kExact>(a, w.ylo[q], w.yhi[q], w.dyn[q],
                       kExact ? w.tlo[q] : 0.0f))
      hit(q);
  }
}

// kStage places of the tile's stage; reserves n consecutive ones if they
// are all free (else none: -1), so a sweep's staged hits stay a prefix of
// its walk when its later hits are staged a batch at a time.
__device__ __forceinline__ int reserve(int* fill, int n) {
  int old = *static_cast<volatile int*>(fill);
  while (old + n <= kStage) {
    const int prev = atomicCAS(fill, old, old + n);
    if (prev == old) return old;
    old = prev;
  }
  return -1;
}

template <bool kExact>
__global__ void __launch_bounds__(kSweeps, 4)
    tiled_onepass(Rows w, op::Scan sc, int* __restrict__ ovfw,
                  int max_pairs, int* __restrict__ pi, int* __restrict__ pj,
                  int* __restrict__ counters) {
  __shared__ int s_id[kStage];        // a staged hit's candidate body id
  __shared__ unsigned s_key[kStage];  // its sweep (thread) << 24 | h
  __shared__ int s_pi[kStage];        // the stage in (k, j) order
  __shared__ int s_pj[kStage];
  __shared__ int s_order[kSweeps];    // each sweep's own body id
  __shared__ int s_count[kSweeps];    // its hits, then its first place
  __shared__ int s_staged[kSweeps];   // its hits staged (a prefix)
  __shared__ int s_next[kSweeps];     // a long sweep's next candidate
  __shared__ int s_long[kSweeps];     // the long sweeps, for the warps
  __shared__ int s_cnt[kSweeps / 32];
  __shared__ unsigned s_hmask[kSweeps / 32];  // a long walk's round
  __shared__ bool s_closed[kSweeps / 32];
  __shared__ int s_fill, s_nlong, s_place;
  __shared__ long long s_first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (;;) {
  __syncthreads();  // the tile before is done with the counters
  if (tid == 0) s_fill = s_nlong = 0;
  const op::Tile tile = op::take(sc);  // barriers: the counters are set
  if (tile.index >= sc.ntiles) {  // one ticket past the work a block
    if (tid == 0 && tile.index == sc.ntiles + static_cast<int>(gridDim.x) - 1)
      op::finish_call(sc, tile);
    return;
  }
  const int u = tile.index * kSweeps + tid;
  const int nact = *w.nact;

  // each thread its sweep's first kThreadWalk candidates, kAhead loaded at
  // once; a sweep open past them goes on the tile's list of long sweeps
  int count = 0, staged = 0;
  bool open = false, went_long = false;
  if (u < w.n_sweeps) s_order[tid] = w.order[u];
  if (u < w.n_sweeps && u % w.stride < nact - (u - u % w.stride)) {
    const Source a = source<kExact>(w, u, nact);
    const int end = min(a.lim, a.k + 1 + kThreadWalk);
    bool full = false, closed = false;
    int j = a.k + 1;
    while (j < end && !closed) {
      float x[kAhead], yl[kAhead], yh[kAhead], tl[kAhead];
      int d[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (j + i < end) {
          const int q = a.base + j + i;
          x[i] = w.xlo[q];
          yl[i] = w.ylo[q];
          yh[i] = w.yhi[q];
          d[i] = w.dyn[q];
          tl[i] = kExact ? w.tlo[q] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (j >= end) break;
        if (!(x[i] <= a.hix)) {  // false on NaN: the serial break
          closed = true;
          break;
        }
        if (accept<kExact>(a, yl[i], yh[i], d[i], tl[i])) {
          if (!full) {
            const int p = atomicAdd(&s_fill, 1);
            full = p >= kStage;
            if (!full) {
              s_id[p] = w.order[a.base + j];
              s_key[p] = static_cast<unsigned>(tid) << 24 | count;
              staged = count + 1;
            }
          }
          ++count;
        }
        ++j;
      }
    }
    went_long = !closed && j < a.lim;
    if (went_long) {
      s_long[atomicAdd(&s_nlong, 1)] = tid;
      s_next[tid] = full ? -j : j;  // negative: its stage is full
    } else {
      open = !closed && window_open(w, a, j, nact);
    }
  }
  s_count[tid] = count;
  s_staged[tid] = staged;
  __syncthreads();

  // the long sweeps, one after another, each walked by the whole block:
  // 256 candidates a round, warp w's 32 a batch; the hits before the
  // round's first closed candidate count, the round's hits are staged all
  // or none, and the walk ends at the round holding a closed candidate
  const unsigned below = (1u << lane) - 1u;
  for (int i = 0; i < s_nlong; ++i) {
    const int r = s_long[i];
    const Source a = source<kExact>(w, tile.index * kSweeps + r, nact);
    int j = s_next[r], c = s_count[r], st = s_staged[r];
    bool full = j < 0, closed = false;
    j = full ? -j : j;
    while (j < a.lim && !closed) {
      const int jj = j + tid, q = a.base + jj;
      const bool in = jj < a.lim;
      bool is_open = false, hit = false;
      if (in) {
        is_open = w.xlo[q] <= a.hix;
        hit = accept<kExact>(a, w.ylo[q], w.yhi[q], w.dyn[q],
                             kExact ? w.tlo[q] : 0.0f);
      }
      const unsigned cl = __ballot_sync(op::kAll, in && !is_open);
      const unsigned h = __ballot_sync(op::kAll, hit) &
                         (cl ? (1u << (__ffs(cl) - 1)) - 1u : op::kAll);
      if (lane == 0) {
        s_hmask[warp] = h;
        s_closed[warp] = cl != 0u;
      }
      __syncthreads();
      // the batches up to the first closed one, and the hits before mine
      int last = kSweeps / 32 - 1, before = 0, round = 0;
      for (int b = kSweeps / 32 - 1; b >= 0; --b)
        if (s_closed[b]) last = b;
      for (int b = 0; b <= last; ++b) {
        before += b < warp ? __popc(s_hmask[b]) : 0;
        round += __popc(s_hmask[b]);
      }
      if (round) {
        if (tid == 0) s_place = full ? -1 : reserve(&s_fill, round);
        __syncthreads();
        const int p = s_place;
        full = p < 0;
        if (!full && warp <= last && (h >> lane & 1u)) {
          const int rank = before + __popc(h & below);
          s_id[p + rank] = w.order[q];
          s_key[p + rank] = static_cast<unsigned>(r) << 24 | (c + rank);
        }
        c += round;
        if (!full) st = c;
      }
      closed = last < kSweeps / 32 - 1 || s_closed[last];
      j += kSweeps;
      __syncthreads();  // the round's masks are read
    }
    if (tid == 0) {
      s_count[r] = c;
      s_staged[r] = st;
      // its open flag (a walk that was not closed ended at lim)
      s_next[r] = !closed && window_open(w, a, a.lim, nact);
    }
  }
  __syncthreads();
  count = s_count[tid];
  staged = s_staged[tid];
  if (went_long) open = s_next[tid];
  const int n_open = __syncthreads_count(open);

  // each sweep's first place in the tile: an exclusive scan in sweep order
  int x = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(op::kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_cnt[warp] = x;
  __syncthreads();
  int off = x - count, agg = 0;
  for (int i = 0; i < kSweeps / 32; ++i) {
    off += i < warp ? s_cnt[i] : 0;
    agg += s_cnt[i];
  }
  s_count[tid] = off;

  if (tid == 0) {
    ovfw[tile.index] = n_open;
    op::publish(sc, tile, agg, tile.index == 0);
  }
  if (warp == 0) {
    const long long excl = tile.index ? op::look_back(sc, tile, lane) : 0;
    if (lane == 0) {
      if (tile.index) op::publish(sc, tile, excl + agg, true);
      s_first = excl;
    }
  }
  __syncthreads();
  const long long first = s_first;

  // the staged hits to their places: in the stage, or past it straight out
  const int n_staged = min(s_fill, kStage);
  for (int e = tid; e < n_staged; e += kSweeps) {
    const unsigned key = s_key[e];
    const int r = key >> 24;
    const int at = s_count[r] + static_cast<int>(key & 0xffffffu);
    if (at < kStage) {
      s_pi[at] = s_order[r];
      s_pj[at] = s_id[e];
    } else if (first + at < max_pairs) {
      pi[first + at] = s_order[r];
      pj[first + at] = s_id[e];
    }
  }
  __syncthreads();
  // the stage out as contiguous stores (the places of hits that were not
  // staged are written again below)
  for (int p = tid; p < min(agg, kStage); p += kSweeps) {
    if (first + p >= max_pairs) break;
    pi[first + p] = s_pi[p];
    pj[first + p] = s_pj[p];
  }
  // the hits past the stage: their sweeps walk again
  if (__syncthreads_or(staged < count) && staged < count &&
      first + off + staged < max_pairs) {
    int h = 0;
    const int oi = s_order[tid];
    walk<kExact>(w, u, nact, [&](int q) {
      const long long at = first + off + h;
      if (h >= staged && at < max_pairs) {
        pi[at] = oi;
        pj[at] = w.order[q];
      }
      ++h;
    });
  }

  if (tile.index == sc.ntiles - 1) {  // the total and the counters
    int opened = 0;
    for (int i = tid; i < sc.ntiles; i += kSweeps)
      opened += i == tile.index ? n_open : op::load_relaxed(&ovfw[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      opened += __shfl_xor_sync(op::kAll, opened, o);
    if (lane == 0) s_cnt[warp] = opened;
    __syncthreads();
    if (tid == 0) {
      int all = 0;
      for (int i = 0; i < kSweeps / 32; ++i) all += s_cnt[i];
      const long long total = first + agg;
      const int num = static_cast<int>(total < max_pairs ? total : max_pairs);
      counters[0] = num;
      counters[1] = static_cast<int>(total - num);
      counters[2] = all;
    }
  }
  }
}

}  // namespace

// Plain C entries for ctypes.  K4's tiles at n_sweeps = n_slabs * stride
// sweeps (the scratch's ntiles).
extern "C" int phyx_sweep_tiled_tiles(int n_sweeps) {
  return (n_sweeps + kSweeps - 1) / kSweeps;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers; rows is (4, npad) f32 [xlo, ylo, xhi, yhi],
// truex (2, npad) f32 [tlo, thi] or null (exact_x off), dyn and order
// (npad) int32, nact () int32.  Writes pi and pj (max_pairs) int32 at the
// slots [0, num) and counters (3) int32 [num, ovf_drop, ovf_window].  The
// scratch, zeroed once and kept for this stream and shape: ticket (1) u64,
// flag (ntiles) u32, agg and incl (ntiles) i64, ovfw (ntiles) i32; ntiles
// = phyx_sweep_tiled_tiles(n_slabs * stride).  The launch keeps the
// scratch's call count itself (csrc/onepass.cuh), so the scratch is never
// cleared and a captured launch replays.
extern "C" int phyx_sweep_tiled(const void* rows, const void* truex,
                                const void* dyn, const void* order,
                                const void* nact, void* ticket, void* flag,
                                void* agg, void* incl, void* ovfw, void* pi,
                                void* pj, void* counters, int npad,
                                int stride, int window, int n_slabs,
                                int max_pairs, void* stream) {
  const Rows w = columns(rows, truex, dyn, order, nact, npad, stride, window,
                         n_slabs);
  if (window >= 1 << 23)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = phyx_sweep_tiled_tiles(w.n_sweeps);
  const op::Scan sc{static_cast<unsigned long long*>(ticket),
                    static_cast<unsigned*>(flag),
                    static_cast<long long*>(agg),
                    static_cast<long long*>(incl), ntiles};
  auto s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(ovfw);
  int* a = static_cast<int*>(pi);
  int* b = static_cast<int*>(pj);
  int* c = static_cast<int*>(counters);
  const auto kernel = truex ? tiled_onepass<true> : tiled_onepass<false>;
  const int grid = op::resident_grid(kernel, kSweeps, ntiles);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, kSweeps, 0, s>>>(w, sc, o, max_pairs, a, b, c);
  return static_cast<int>(cudaGetLastError());
}
