"""Where the tiled solves' time goes, on the card: K3 at the settled 20k
pile, 128-env and 1024-env frames and at the 20k avalanche's frame 360, K5
at the 20k frame's routed rows, in every placement of their per-row arrays
and under a variant of the level solve's record loads.

K3 and K5 (``phyx_tpu_torch/csrc/contact_solver_tiled.cu``, their level
schedule in ``csrc/levels.cuh``) run a pre-pass that levels the slab
walk's visits, then the passes level by level.  This script settles the
frames as ``chip_smoke.py`` does (the 20k pile, bench.py's 300 frames;
bench row E at 128 and at 1024 envs x 256 boxes, 240 frames each; the 20k
avalanche's autotuned settle of 300 frames, then 60 more, a frame of the
benchmark's window), takes
the kernels' inputs there and times on CUDA events, in turns within the
run (median of three rounds):

* the pre-pass alone, its last-level array in shared memory (where the
  table's rows allow) and in device memory;
* the full solve in every placement ``tiled_placements`` lists: the
  working columns in device memory, or in one block's shared memory where
  they fit, the last-level array likewise;
* ``stream_records``: the source with the level solve's record loads made
  streaming loads (``__ldcs``, evicted from L2 first), in the wrapper's
  placement;
* the depth the free rows take off (all +0.0: the slabs' zero blocks,
  where statics at rest are remapped, the halo and padding): the levels a
  pass with them (the kernels' schedule) and with every row a node
  (torch's ``levels_of``), the visits with a free endpoint, and the
  kernel's counters (the fallback among them).

Every solve is held equal to the bit to the wrapper's result on all
passes (the run raises otherwise).  The variant is the source with one
stated text of ``levels.cuh`` replaced, written with its headers and
compiled under ``phyx_tpu_torch/_build/anatomy_tiled/<variant>/``.
Prints one JSON line per frame (ms, and ns a level with the pre-pass of
the same last-level placement taken off) and the card's ``nvidia-smi``
name and power limit.  Needs one card:

    python3 k3_anatomy.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import sys

import chip_smoke

# the level solve's record loads
RECORDS = "  for (int k = 0; k < 5; ++k) it.r[k] = rec4[5 * pos + k];\n"
VARIANTS = {
    "stream_records": [(RECORDS, RECORDS.replace(
        "rec4[5 * pos + k]", "__ldcs(rec4 + 5 * pos + k)"))],
}


def build_variants() -> dict:
    """Each variant written as a copy of the tiled source and its headers,
    with its edits made in ``levels.cuh``, in a directory of its own, and
    all compiled at once; returns {name: ctypes library}."""
    from phyx_tpu_torch.kernels import contact_solver_tiled as tiled
    from phyx_tpu_torch.kernels import nvcc
    sources = {}
    for name, edits in VARIANTS.items():
        out_dir = nvcc.BUILD_DIR / "anatomy_tiled" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for path in nvcc.sources_of(tiled.SOURCE):
            shutil.copy(path, out_dir / path.name)
        header = out_dir / "levels.cuh"
        src = header.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in "
                                   "levels.cuh once")
            src = src.replace(old, new)
        header.write_text(src)
        sources[name] = out_dir / tiled.SOURCE.name
    nvcc.compile_all(list(sources.values()))
    libs = {}
    for name, path in sources.items():
        lib = ctypes.CDLL(str(nvcc.library_path(path)))
        for entry in ("phyx_contact_solve_tiled2", "phyx_contact_solve_tiled"):
            fn = getattr(lib, entry)
            fn.argtypes = getattr(tiled.build()[0], entry).argtypes
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def settled_frames() -> dict:
    """{frame: (kernel, its inputs)}, each frame settled without host
    waits."""
    from phyx_tpu_torch.demos.run_envs import build_envs
    from phyx_tpu_torch.step import rollout, solve_inputs
    from phyx_tpu_torch.tune import rollout_autotuned
    cfg, st = chip_smoke._bench_row("pile", 20_000)
    st = rollout(st, cfg, 300)
    frames = {"pile20k": ("K3", solve_inputs(st, cfg)),
              "pile20k_routed": ("K5", solve_inputs(
                  st, cfg.replace(tiled_routing=False)))}
    cfg, st = chip_smoke._bench_row("avalanche", 20_000)
    st, cfg = rollout_autotuned(st, cfg, 300, chunk=10)
    frames["avalanche20k_frame360"] = ("K3", solve_inputs(
        rollout(st, cfg, 60), cfg))
    for envs in (128, 1024):
        cfg, st = build_envs(envs, 256)
        st = rollout(st, cfg, 240)
        frames[f"envs{envs}"] = ("K3", solve_inputs(st, cfg))
    chip_smoke._sync()
    return frames


def measure(name: str, args, libs: dict) -> dict:
    from phyx_tpu_torch.kernels.contact_solver_streamed import (COUNTERS,
                                                                free_rows)
    from phyx_tpu_torch.kernels.contact_solver_tiled import (
        _launch, slab_levels, tiled_placements, tiled_prepass)
    npad = args["body_flat"].numel() // 8
    places = tiled_placements(npad)

    key = chip_smoke._place_key

    def solver(place, lib=None):
        return lambda **a: _launch(a, lib=lib, **place)[:3]

    runs = {f"prepass_{'shared' if s else 'device'}_last":
            (lambda s: lambda **a: tiled_prepass(a, smem_last=s))(s)
            for s in {places[0]["smem_last"], False}}
    solves = {key(p): solver(p) for p in places}
    solves.update({f"{v}_{key(places[0])}": solver(places[0], lib)
                   for v, lib in libs.items()})
    wrapper = chip_smoke._wrappers()[name]
    ref = wrapper(**args)
    counters = dict(zip(COUNTERS, wrapper.stats.tolist()))
    for k, fn in solves.items():
        chip_smoke._equal(f"{name} {k} vs the wrapper", fn(**args), ref)
    runs.update(solves)
    times = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            times[k].append(chip_smoke._kernel_ms(fn, args, reps=3))
    ms = {k: statistics.median(t) for k, t in times.items()}
    free = free_rows(args["body_flat"])
    lv = slab_levels(args, free)
    passes = 1 + args["vel_iters"] + args["pos_iters"]
    level_visits = max(1, passes * lv["n_levels"])
    ns = {k: (ms[k] - ms["prepass_shared_last" if "shared_last" in k
                         else "prepass_device_last"]) * 1e6 / level_visits
          for k in solves}
    return dict(kernel=name, rows=npad, visits=lv["slots"].numel(),
                levels=lv["n_levels"],
                levels_every_row_a_node=slab_levels(args)["n_levels"],
                free_rows=int(free.sum()),
                freed_visits=int((free[lv["i"]] | free[lv["j"]]).sum()),
                counters=counters, passes=passes,
                wrapper_placement=places[0], ms=ms, ns_per_level=ns,
                checked_equal=list(solves))


def main() -> int:
    if sys.argv[1:]:
        raise SystemExit("usage: python3 k3_anatomy.py")
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    libs = build_variants()
    for frame, (name, args) in settled_frames().items():
        print(json.dumps(dict(frame=frame, card=card,
                              **measure(name, args, libs))), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
