// Stage marks of a frame (``phyx_tpu_torch/tracing.py``).
//
// ``step`` marks its frame's start and the end of each stage.  On the card
// a mark is a launch of one thread on the current stream, so a frame
// captured into a CUDA graph carries its marks into every replay.  Each
// stage has a kernel of its own, named after it (``phyx_mark_<stage>``),
// so a profiler trace tells the stages apart on its own device clock; each
// writes the device's ``%globaltimer`` (ns) into its slot of a small table
// of the latest frame, which the frame mark clears.  The marks read
// nothing of the frame and write nothing else.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace

// the slots, in the order of tracing.MARKS
enum { FRAME, INTEGRATE, BROADPHASE, NARROWPHASE, CACHE_JOIN, PREPARE,
       JOINT_PREPARE, SOLVE, BUILD_CACHE, N_MARKS };

extern "C" __global__ void phyx_mark_frame(unsigned long long* table) {
  table[FRAME] = global_ns();
  for (int k = FRAME + 1; k < N_MARKS; ++k) table[k] = 0;
}

#define PHYX_STAGE_MARK(name, slot)                                      \
  extern "C" __global__ void phyx_mark_##name(unsigned long long* table) { \
    table[slot] = global_ns();                                           \
  }

PHYX_STAGE_MARK(integrate, INTEGRATE)
PHYX_STAGE_MARK(broadphase, BROADPHASE)
PHYX_STAGE_MARK(narrowphase, NARROWPHASE)
PHYX_STAGE_MARK(cache_join, CACHE_JOIN)
PHYX_STAGE_MARK(prepare, PREPARE)
PHYX_STAGE_MARK(joint_prepare, JOINT_PREPARE)
PHYX_STAGE_MARK(solve, SOLVE)
PHYX_STAGE_MARK(build_cache, BUILD_CACHE)

// Launches the mark of ``slot`` on ``stream``; returns the CUDA error (0:
// launched).
extern "C" int phyx_stage_mark(int slot, unsigned long long* table,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slot) {
    case FRAME: phyx_mark_frame<<<1, 1, 0, s>>>(table); break;
    case INTEGRATE: phyx_mark_integrate<<<1, 1, 0, s>>>(table); break;
    case BROADPHASE: phyx_mark_broadphase<<<1, 1, 0, s>>>(table); break;
    case NARROWPHASE: phyx_mark_narrowphase<<<1, 1, 0, s>>>(table); break;
    case CACHE_JOIN: phyx_mark_cache_join<<<1, 1, 0, s>>>(table); break;
    case PREPARE: phyx_mark_prepare<<<1, 1, 0, s>>>(table); break;
    case JOINT_PREPARE:
      phyx_mark_joint_prepare<<<1, 1, 0, s>>>(table);
      break;
    case SOLVE: phyx_mark_solve<<<1, 1, 0, s>>>(table); break;
    case BUILD_CACHE: phyx_mark_build_cache<<<1, 1, 0, s>>>(table); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
