"""Where K1's time goes, on the card: its full solve at the settled 10k pile
and 64-env frames, under variants of its source built beside it.

K1 (``phyx_tpu_torch/csrc/contact_solver_streamed.cu``, its level schedule
in ``csrc/levels.cuh``) is a pre-pass that levels the visits, then one
block that runs each pass level by level.
This script settles the two frames as ``chip_smoke.py`` does (the 10k pile,
200 frames; bench row E at 64 envs x 256 boxes, 240 frames), takes K1's
inputs there, and times on CUDA events, in turns within the run:

* the pre-pass alone (its last-level array as the wrapper places it, and
  in device memory), and the full solve as the wrapper runs it;
* the design steps of the level solve, each equal to the bit to the
  wrapper's result on all passes (the run raises otherwise):
  ``step2`` (records loaded at their visit, working columns in device
  memory), ``step3`` (+ columns in shared memory), ``step4`` (+ records
  loaded three levels ahead: the source as it is), ``step4`` with its
  columns in device memory (the placement above N = 19,285), and with its
  last-level array there too (above N = 51,200);
* block sizes 128 and 256 beside the source's 512, equal to the bit;
* the split of a level: ``no_visit`` (each record and its accumulators
  loaded, the visit's body reads, arithmetic and writes left out),
  ``no_barrier`` (no barrier after a level), and both.  These do not
  compute the solve and are not checked;
* the levels a pass with the table's free rows (the kernel's schedule:
  the pile's ground is one) and with every row a node, the visits with a
  free endpoint, and the kernel's counters.

The variants are the source with one stated text of ``levels.cuh``
replaced, each written with its headers and compiled under
``phyx_tpu_torch/_build/anatomy/<variant>/``.  Prints one JSON line per
frame (ms, and ns a level with the pre-pass taken off) and the card's
``nvidia-smi`` name and power limit.  Needs one card:

    python3 k1_anatomy.py
"""

from __future__ import annotations

import ctypes
import functools
import json
import shutil
import statistics
import sys

import chip_smoke

# the level solve's block
THREADS = "constexpr int kSolveThreads = 512;"
# the level pass's loads ahead (from START up to END): replaced by one load
# at each visit
AHEAD_START = "  Item ring[kDepth];\n"
AHEAD_END = "  return r;\n}\n\n// max_p across the block"
NO_AHEAD = '''  for (int l = 0; l < n_levels; ++l) {
    for (int p = loff[l] + t; p < loff[l + 1]; p += blockDim.x) {
      Item it;
      load_item(it, rec4, acc4, p);
      r = phyx::max_p(r, visit<kKind, kJoints, kSmem, true>(
                             it, cols, body, acc4, p, &bad));
    }
    __syncthreads();
  }
'''
# the start of a visit's body: the visit left out, its loads kept live
VISIT = '''                                       float* body, float4* acc4, int pos,
                                       unsigned* bad = nullptr) {
'''
NO_VISIT = VISIT + '''  if (pos >= 0) {
    float s = it.a.x + it.a.y + it.a.z + it.a.w;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      s += it.r[k].x + it.r[k].y + it.r[k].z + it.r[k].w;
    acc4[pos] = make_float4(s, 0.0f, 0.0f, 0.0f);
    return 0.0f;
  }
'''
# the barrier after each level of the level pass
BARRIER = '''          load_item(ring[d], rec4, acc4, loff[ln] + t);
        __syncthreads();'''
NO_BARRIER = '''          load_item(ring[d], rec4, acc4, loff[ln] + t);'''

VARIANTS = {
    "threads128": [(THREADS, THREADS.replace("512", "128"))],
    "threads256": [(THREADS, THREADS.replace("512", "256"))],
    "no_ahead": [(AHEAD_START, AHEAD_END, NO_AHEAD)],
    "no_visit": [(VISIT, NO_VISIT)],
    "no_barrier": [(BARRIER, NO_BARRIER)],
    "no_visit_no_barrier": [(VISIT, NO_VISIT), (BARRIER, NO_BARRIER)],
}


def build_variants() -> dict:
    """Each variant written as a copy of K1's source and its headers, with
    its edits made in ``levels.cuh`` (the level solve), in a directory of
    its own, and all compiled at once; returns {name: ctypes library}."""
    from phyx_tpu_torch.kernels import contact_solver_streamed as k1
    from phyx_tpu_torch.kernels import nvcc
    sources = {}
    for name, edits in VARIANTS.items():
        out_dir = nvcc.BUILD_DIR / "anatomy" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for path in nvcc.sources_of(k1.SOURCE):
            shutil.copy(path, out_dir / path.name)
        header = out_dir / "levels.cuh"
        src = header.read_text()
        for edit in edits:
            # (old, new), or (start, end, new): the text from start to end
            for anchor in edit[:-1]:
                if src.count(anchor) != 1:
                    raise RuntimeError(f"{name}: the text to replace is not "
                                       f"in levels.cuh once")
            if len(edit) == 2:
                src = src.replace(*edit)
            else:
                start, end = src.index(edit[0]), src.index(edit[1])
                src = src[:start] + edit[2] + src[end:]
        header.write_text(src)
        sources[name] = out_dir / k1.SOURCE.name
    nvcc.compile_all(list(sources.values()))
    libs = {}
    for name, path in sources.items():
        lib = ctypes.CDLL(str(nvcc.library_path(path)))
        fn = lib.phyx_contact_solve_streamed
        fn.argtypes = k1.build()[0].phyx_contact_solve_streamed.argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def solver(lib, smem_cols: bool):
    """K1's solve through ``lib`` with the columns placed as given and the
    last-level array as the wrapper places it."""
    import torch
    from phyx_tpu_torch.kernels import contact_solver_streamed as k1

    def run(body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints=None, c_cap=None, tols=None):
        args = (body_flat, b1, b2, con_flat, warm_flat, num_contacts,
                vel_iters, pos_iters, num_joints, c_cap)
        n, r, c_cap, tols = k1.check_inputs(*args, tols)
        device = body_flat.device
        body_out = body_flat.clone()
        acc = torch.zeros((r * 4,), dtype=torch.float32, device=device)
        res = torch.empty((1,), dtype=torch.float32, device=device)
        iscratch, fscratch, stats = k1._scratch(n, r, device)
        err = lib.phyx_contact_solve_streamed(
            body_out.data_ptr(), body_flat.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), con_flat.data_ptr(), warm_flat.data_ptr(),
            acc.data_ptr(), res.data_ptr(), num_contacts.data_ptr(),
            None if num_joints is None else num_joints.data_ptr(),
            tols.data_ptr(), stats.data_ptr(), n, c_cap, r - c_cap,
            int(vel_iters), int(pos_iters), iscratch.data_ptr(),
            fscratch.data_ptr(), int(k1.placement(n)["smem_last"]),
            int(smem_cols), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K1 variant launch failed: CUDA error {err}")
        return body_out, acc, res
    return run


def settled_frames() -> dict:
    """K1's inputs at the two frames, each settled without host waits."""
    from phyx_tpu_torch.demos.run_envs import build_envs
    from phyx_tpu_torch.step import rollout, solve_inputs
    cfg, st = chip_smoke._bench_row("pile", 10_000)
    st = rollout(st, cfg, 200)
    frames = {"pile10k": solve_inputs(st, cfg)}
    cfg, st = build_envs(64, 256)
    st = rollout(st, cfg, 240)
    frames["envs64"] = solve_inputs(st, cfg)
    chip_smoke._sync()
    return frames


def measure(args, libs) -> dict:
    from phyx_tpu_torch.kernels import contact_solver_streamed as k1
    from phyx_tpu_torch.kernels.contact_solver_streamed import (
        COUNTERS, free_rows, prepass, solve_contacts_streamed, visit_levels)
    n = args["body_flat"].numel() // 8
    fits = k1.placement(n)["smem_cols"]
    runs = {
        "prepass": prepass,
        "prepass_last_in_device_memory": functools.partial(
            prepass, smem_last=False),
        "step4": solve_contacts_streamed,
        "step4_cols_in_device_memory": solver(k1.build()[0], False),
        "step4_in_device_memory": k1.solve_in_device_memory,
        "step3": solver(libs["no_ahead"], fits),
        "step2": solver(libs["no_ahead"], False),
        "step4_threads128": solver(libs["threads128"], fits),
        "step4_threads256": solver(libs["threads256"], fits),
        "no_visit": solver(libs["no_visit"], fits),
        "no_barrier": solver(libs["no_barrier"], fits),
        "no_visit_no_barrier": solver(libs["no_visit_no_barrier"], fits),
    }
    ref = solve_contacts_streamed(**args)
    counters = dict(zip(COUNTERS, solve_contacts_streamed.stats.tolist()))
    checked = ("step4_cols_in_device_memory", "step4_in_device_memory",
               "step3", "step2", "step4_threads128", "step4_threads256")
    for name in checked:
        chip_smoke._equal(f"K1 {name} vs the wrapper", runs[name](**args),
                          ref)
    times = {name: [] for name in runs}
    for _ in range(3):
        for name, fn in runs.items():
            times[name].append(chip_smoke._kernel_ms(fn, args, reps=5))
    ms = {name: statistics.median(t) for name, t in times.items()}
    free = free_rows(args["body_flat"])
    lv, full = (visit_levels(args["b1"], args["b2"], args["num_contacts"],
                             args["num_joints"], args["c_cap"], n, f)
                for f in (free, None))
    level_visits = lv["n_levels"] * (1 + args["vel_iters"]
                                     + args["pos_iters"])
    return dict(
        bodies=n, visits=lv["slots"].numel(), levels=lv["n_levels"],
        levels_every_row_a_node=full["n_levels"], free_rows=int(free.sum()),
        freed_visits=int((free[lv["i"]] | free[lv["j"]]).sum()),
        counters=counters, passes=1 + args["vel_iters"] + args["pos_iters"],
        cols_in_shared_memory=fits, ms=ms,
        ns_per_level={name: (t - ms["prepass"]) * 1e6 / level_visits
                      for name, t in ms.items()
                      if not name.startswith("prepass")},
        checked_equal=list(checked))


def main() -> int:
    if sys.argv[1:]:
        raise SystemExit("usage: python3 k1_anatomy.py")
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    libs = build_variants()
    for name, args in settled_frames().items():
        print(json.dumps(dict(frame=name, card=card,
                              **measure(args, libs))), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
