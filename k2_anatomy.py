"""K2 and K7 at their settled main-path frames on one GPU, for comparing two
trees of the port in one call.

    python3 k2_anatomy.py [--tree DIR] [--label NAME]

``--tree`` puts DIR first on the import path, so that ``phyx_tpu_torch``
is that tree's package (a checkout of an earlier commit, say) while the
helpers come from this tree's ``chip_smoke.py``; without it, this tree's
own package.  The tree's package must hold ``bench.py``: the frames are
built by its ``bench.build_row``.  Settles the 1000-link chain (300
frames), the 1k pile (400) and the 500-box pile under
``broadphase="sap"`` (400) at bench.py's settings, then at each frame: K2's full solve (median of three rounds of
five launches on CUDA events) and its device time behind a sleep kernel,
K1 on the same input (equal to K2 on all passes), the levels a pass and
the share of narrow levels (at most 32 visits), and, where the tree has
them, K2's pre-pass alone and its place in shared memory; at the 500-box
frame, K7's wrapper: its device time behind a sleep kernel and the CUDA
kernels one call launches (torch.profiler).  Prints a JSON line per frame
and the card's ``nvidia-smi`` name and power limit.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys

# the visit of a narrow level's record: left out, its record kept live
VISIT = """    if (has)
      r = phyx::max_p(r, phyx::levels::visit<kKind, kJoints, true>(
                             cur, cols, nullptr, acc4, lo + lane));
"""
NO_VISIT = """    if (has) {
      float z = cur.a.x;
#pragma unroll
      for (int k = 0; k < 5; ++k)
        z += cur.r[k].x + cur.r[k].y + cur.r[k].z + cur.r[k].w;
      acc4[lo + lane] = make_float4(z, 0.0f, 0.0f, 0.0f);
    }
"""
# the warp sync after a narrow level
SYNC = "    __syncwarp();\n    if (hi >= next_release"
NO_SYNC = "    if (hi >= next_release"
SOLVERS = "constexpr int kSolvers = 128;"
# variant: (edits, whether it computes the solve, so is held to the wrapper)
VARIANTS = {
    "solvers32": ([(SOLVERS, SOLVERS.replace("128", "32"))], True),
    "solvers64": ([(SOLVERS, SOLVERS.replace("128", "64"))], True),
    "no_visit": ([(VISIT, NO_VISIT)], False),
    "no_sync": ([(SYNC, NO_SYNC)], False),
    "no_visit_no_sync": ([(VISIT, NO_VISIT), (SYNC, NO_SYNC)], False),
}


def build_variants() -> dict:
    """Each variant written as a copy of K2's source and its headers with
    its edits made in ``contact_solver.cu``, in a directory of its own
    under ``phyx_tpu_torch/_build/anatomy_k2/``, all compiled at once;
    returns {name: ctypes function}."""
    from phyx_tpu_torch.kernels import contact_solver as k2mod
    from phyx_tpu_torch.kernels import nvcc
    sources = {}
    for name, (edits, _) in VARIANTS.items():
        out_dir = nvcc.BUILD_DIR / "anatomy_k2" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for path in nvcc.sources_of(k2mod.SOURCE):
            shutil.copy(path, out_dir / path.name)
        src_path = out_dir / k2mod.SOURCE.name
        src = src_path.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in "
                                   "contact_solver.cu once")
            src = src.replace(old, new)
        src_path.write_text(src)
        sources[name] = src_path
    nvcc.compile_all(list(sources.values()))
    fns = {}
    for name, path in sources.items():
        fn = ctypes.CDLL(str(nvcc.library_path(path))).phyx_contact_solve_fused
        fn.argtypes = k2mod.build()[0].phyx_contact_solve_fused.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run_variant(fn, args):
    """The wrapper's launch (``contact_solver._launch``) through a
    variant's entry."""
    import torch
    from phyx_tpu_torch.kernels import contact_solver as k2mod
    from phyx_tpu_torch.kernels.contact_solver_streamed import check_inputs
    a = (args["body_flat"], args["b1"], args["b2"], args["con_flat"],
         args["warm_flat"], args["num_contacts"], args["vel_iters"],
         args["pos_iters"], args["num_joints"], args["c_cap"])
    n, r, c_cap, tols = check_inputs(*a, args["tols"])
    place = k2mod.fused_layout(n, r)
    dev = args["body_flat"].device
    body = torch.empty_like(args["body_flat"])
    acc = torch.empty((4 * r,), dtype=torch.float32, device=dev)
    res = torch.empty((1,), dtype=torch.float32, device=dev)
    isc = torch.empty((3 * r,), dtype=torch.int32, device=dev)
    fsc = torch.empty(((20 if place["acc_smem"] else 24) * r,),
                      dtype=torch.float32, device=dev)
    nj = args["num_joints"]
    err = fn(args["body_flat"].data_ptr(), body.data_ptr(),
             args["b1"].data_ptr(), args["b2"].data_ptr(),
             args["con_flat"].data_ptr(), args["warm_flat"].data_ptr(),
             acc.data_ptr(), res.data_ptr(), args["num_contacts"].data_ptr(),
             None if nj is None else nj.data_ptr(), tols.data_ptr(), n,
             c_cap, r - c_cap, args["vel_iters"], args["pos_iters"],
             isc.data_ptr(), fsc.data_ptr(), int(place["acc_smem"]), 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return body, acc, res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--variants", action="store_true",
                    help="also time the variants of this tree's K2")
    opt = ap.parse_args()
    # this tree's helpers; they import the package only when called
    import chip_smoke as cs
    if opt.tree:
        sys.path.insert(0, opt.tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_anatomy: no CUDA device")
    import phyx_tpu_torch
    from phyx_tpu_torch.broadphase import sap_kernel_inputs
    from phyx_tpu_torch.kernels import contact_solver as k2mod
    from phyx_tpu_torch.kernels.contact_solver_streamed import (
        solve_contacts_streamed, visit_levels)
    from phyx_tpu_torch.kernels.sweep import sweep_emit
    from phyx_tpu_torch.step import (integrate_velocities, rollout,
                                     solve_inputs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# {opt.label}: phyx_tpu_torch from {phyx_tpu_torch.__file__}; "
          f"{card}", flush=True)
    k2 = k2mod.solve_contacts_fused
    variants = build_variants() if opt.variants else {}
    frames = (("chain", 1000, 300, None), ("pile", 1000, 400, None),
              ("pile", 500, 400, "sap"))
    for scene, boxes, settle, bp in frames:
        cfg, st = cs._bench_row(scene, boxes,
                                *(("--broadphase", bp) if bp else ()))
        st = rollout(st, cfg, settle)
        args = solve_inputs(st, cfg)
        cs._equal("K1 vs K2", solve_contacts_streamed(**args), k2(**args))
        full = statistics.median(cs._kernel_ms(k2, args, reps=5)
                                 for _ in range(3))
        k1 = statistics.median(cs._kernel_ms(solve_contacts_streamed, args,
                                             reps=5) for _ in range(3))
        stages = ()
        if hasattr(k2mod, "fused_prepass"):
            stages = (("prepass", lambda: k2mod.fused_prepass(**args)),)
        dev = cs._split_device_ms(stages, k2, args, reps=5)
        n = args["body_flat"].numel() // 8
        lv = visit_levels(args["b1"], args["b2"], args["num_contacts"],
                          args["num_joints"], args["c_cap"], n)
        widths = lv["offsets"].diff()
        out = dict(label=opt.label, frame=f"{scene} {boxes}",
                   contacts=int(args["num_contacts"]),
                   joints=0 if args["num_joints"] is None
                   else int(args["num_joints"]),
                   k2_ms_full_solve=full,
                   k2_device_ms_full_solve=dev["wrapper_device_ms"],
                   k1_ms_full_solve=k1, k1_equals_k2=True,
                   levels=lv["n_levels"], visits=lv["slots"].numel(),
                   narrow_level_share=int((widths <= 32).sum())
                   / max(1, lv["n_levels"]), card=card)
        if stages:
            out.update(k2_prepass_ms=dev["prepass_ms"],
                       layout=k2mod.fused_layout(n, args["b1"].numel()))
        ref = k2(**args)
        for name, fn in variants.items():
            if VARIANTS[name][1]:
                cs._equal(f"K2 {name} vs K2", run_variant(fn, args), ref)
            ms = statistics.median(cs._kernel_ms(
                lambda **a: run_variant(fn, a), args, reps=5)
                for _ in range(3))
            out[f"variant_{name}_ms"] = ms
            out[f"variant_{name}_ns_per_level"] = (
                (ms - out.get("k2_prepass_ms", 0.0)) * 1e6
                / max(1, lv["n_levels"] * (1 + args["vel_iters"]
                                           + args["pos_iters"])))
        if bp:
            k7_args = sap_kernel_inputs(integrate_velocities(st.bodies, cfg),
                                        cfg.max_pairs, False)
            k7 = cs._split_device_ms((), sweep_emit, k7_args, reps=20)
            out.update(k7_device_ms=k7["wrapper_device_ms"],
                       k7_pace_ms=cs._kernel_ms(sweep_emit, k7_args,
                                                reps=20),
                       k7_pairs=int(sweep_emit(**k7_args)[2]))
            try:
                out["k7_kernels_a_call"] = cs._device_kernels(
                    lambda: sweep_emit(**k7_args))
            except Exception as e:          # the profiler is untried here
                out["k7_kernels_a_call"] = f"not measured: {e!r}"
        print(json.dumps(out), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
