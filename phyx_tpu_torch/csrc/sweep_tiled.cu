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
// window into SMEM, stages emitted pairs in a 1024-pair SMEM buffer flushed
// by DMA, and walks candidates 4 at a time.  Here the rows stay in device
// memory as columns (51,200 rows, ~1.6 MB, at the 128-env mega-scene: they
// sit in the 50 MB L2) and each walk reads its window in place.  The chunked
// walk gives the per-candidate walk's emissions wherever xlo does not reopen
// after a closed candidate.  Sorted rows never reopen; in a segmented
// layout they can only next to a body outside its home band or an active
// tail row, and broadphase counts each of those into ovf_band.
//
// The design: count, scan, emit.  The TPU walks the sweeps one after the
// other with a running append counter; on the card one thread walks each
// (slab, row) sweep, all at once.  Kernel 1 counts each sweep's emissions
// (and its window overflow); an exclusive prefix sum over the sweeps in
// (slab, row) order (torch.cumsum in the wrapper, on the device) gives each
// its first output slot; kernel 2 walks again and writes its emissions at
// those slots below max_pairs.  That is the serial order and the serial cut,
// with no host sync.  Only slots [0, num) are written.
//
// What bounds it: the bytes.  Every row is read once as a starter and by
// the walks that reach it, a handful of compares each, and the pairs are
// written once; the least time is the rows read once and the pairs written
// once over HBM's rate (chip_smoke.py).  Neighbouring threads walk
// neighbouring rows, so their candidate reads fall in the same lines.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// Walks sweep t (slab t / stride, row t % stride), calling hit(q) for each
// emitted candidate row q in walk order.  Returns whether the walk counts
// into ovf_window.
template <bool kExact, class Hit>
__device__ __forceinline__ bool walk(const Rows& w, int t, int nact,
                                     Hit hit) {
  const int k = t % w.stride;
  const int base = t - k;
  if (k >= nact - base) return false;  // not a starter
  const float hix = w.xhi[t], loy = w.ylo[t], hiy = w.yhi[t];
  const float thx = kExact ? w.thi[t] : 0.0f;
  const int di = w.dyn[t];
  int j = k + 1;
  for (; j < w.window && base + j < nact; ++j) {
    const int q = base + j;
    if (!(w.xlo[q] <= hix)) break;
    bool ok = w.ylo[q] <= hiy && loy <= w.yhi[q] && di + w.dyn[q] > 0;
    if (kExact) ok = ok && w.tlo[q] <= thx;
    if (ok) hit(q);
  }
  return j >= w.window && base + j < nact &&
         w.xlo[base + w.window - 1] <= hix;
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads)
    sweep_count(Rows w, int* __restrict__ counts,
                int* __restrict__ ovf_window) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  int open = 0;
  if (t < w.n_sweeps) {
    int c = 0;
    open = walk<kExact>(w, t, *w.nact, [&](int) { ++c; });
    counts[t] = c;
  }
  open = __syncthreads_count(open);
  if (threadIdx.x == 0 && open > 0) atomicAdd(ovf_window, open);
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads)
    sweep_emit(Rows w, const int* __restrict__ counts,
               const long long* __restrict__ ends, int max_pairs,
               int* __restrict__ pi, int* __restrict__ pj) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= w.n_sweeps || counts[t] == 0) return;
  // exclusive prefix: the emissions of the sweeps before t
  long long slot = ends[t] - counts[t];
  if (slot >= max_pairs) return;
  const int oi = w.order[t];
  walk<kExact>(w, t, *w.nact, [&](int q) {
    if (slot < max_pairs) {
      pi[slot] = oi;
      pj[slot] = w.order[q];
    }
    ++slot;
  });
}

int blocks(const Rows& w) { return (w.n_sweeps + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entries for ctypes: each launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; rows is
// (4, npad) f32 [xlo, ylo, xhi, yhi], truex (2, npad) f32 [tlo, thi] or
// null (exact_x off), dyn and order (npad) int32, nact () int32.

// counts (n_slabs * stride) int32: each sweep's emissions; ovf_window (1)
// int32, zeroed by the caller, gains the sweeps open at their window end.
extern "C" int phyx_sweep_tiled_count(const void* rows, const void* truex,
                                      const void* dyn, const void* order,
                                      const void* nact, void* counts,
                                      void* ovf_window, int npad, int stride,
                                      int window, int n_slabs, void* stream) {
  const Rows w = columns(rows, truex, dyn, order, nact, npad, stride, window,
                         n_slabs);
  auto s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(counts);
  int* o = static_cast<int*>(ovf_window);
  if (truex)
    sweep_count<true><<<blocks(w), kThreads, 0, s>>>(w, c, o);
  else
    sweep_count<false><<<blocks(w), kThreads, 0, s>>>(w, c, o);
  return static_cast<int>(cudaGetLastError());
}

// ends (n_slabs * stride) int64: the inclusive prefix sum of counts.  Writes
// pi and pj (max_pairs) int32 at the slots [0, min(total, max_pairs)).
extern "C" int phyx_sweep_tiled_emit(const void* rows, const void* truex,
                                     const void* dyn, const void* order,
                                     const void* nact, const void* counts,
                                     const void* ends, void* pi, void* pj,
                                     int npad, int stride, int window,
                                     int n_slabs, int max_pairs,
                                     void* stream) {
  const Rows w = columns(rows, truex, dyn, order, nact, npad, stride, window,
                         n_slabs);
  auto s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  const long long* e = static_cast<const long long*>(ends);
  int* a = static_cast<int*>(pi);
  int* b = static_cast<int*>(pj);
  if (truex)
    sweep_emit<true><<<blocks(w), kThreads, 0, s>>>(w, c, e, max_pairs, a, b);
  else
    sweep_emit<false><<<blocks(w), kThreads, 0, s>>>(w, c, e, max_pairs, a,
                                                     b);
  return static_cast<int>(cudaGetLastError());
}
