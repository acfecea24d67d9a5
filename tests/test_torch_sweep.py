"""The port's tiled sweep (K4's plain version, the sort stage and
``broadphase_sap_tiled``) against the JAX package, whose
``sweep_emit_tiled`` runs in interpret mode here, and the ``"sap"``
dispatch against the reference's branches."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phyx_tpu.broadphase as jbp
from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.kernels.sweep import sweep_emit_tiled as jax_sweep
from phyx_tpu.parallel.envs import concat_envs as jax_concat_envs
import phyx_tpu_torch.broadphase as bp
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.kernels.sweep_tiled import (sweep_emit_tiled,
                                                sweep_emit_tiled_plain)

torch.set_num_threads(1)

COUNTS = ("num", "overflow", "ovf_window", "ovf_slots", "ovf_drop",
          "ovf_band", "ovf_slab")
# tests/test_banded_sweep.py's band grid: 4 y-bands 120 apart, cells 40
# wide; 16 cells span 640 units, so the keys are banded over 1024
BANDED = dict(sweep_band_h=120.0, sweep_band_y0=-60.0,
              sweep_band_span=1024.0)
SCENES = {
    # 16 envs x 64 boxes on an x-line, unbanded: 1040 bodies over two
    # sweep slabs (K = 1024), both with starters
    "flat": (dict(max_bodies=2048, max_pairs=4096, broadphase="sap_tiled",
                  solver_backend="pallas_tiled", tile_stride=1024,
                  tile_halo=1024), 16, 64, 1),
    # 64 envs x 24 boxes on the band grid, banded keys (exact-x accept)
    "banded": (dict(max_bodies=2048, max_pairs=8192, broadphase="sap_tiled",
                    solver_backend="pallas_tiled", tile_stride=1024,
                    tile_halo=1024, **BANDED), 64, 24, 4),
    # the same, sorted per band on the static layout
    "segmented": (dict(max_bodies=2048, max_pairs=8192,
                       broadphase="sap_tiled", solver_backend="pallas_tiled",
                       tile_stride=1024, tile_halo=1024, **BANDED,
                       sweep_band_rows=25, sweep_band_n=4,
                       sweep_band_cols=16), 64, 24, 4),
}


@functools.lru_cache(maxsize=None)
def env_scene(name):
    """A mega-scene of jittered piles (numpy-made rotations and position
    noise, so boxes overlap), as a numpy State tree both packages take."""
    kw, n_envs, boxes, y_bands = SCENES[name]
    jcfg = JaxConfig(**kw)
    builders = [jscenes.pile(jcfg, boxes, seed=s, ground_half=8.0)
                for s in range(n_envs)]
    mega, _, _ = jax_concat_envs(builders, jcfg, band_width=40.0,
                                 y_bands=y_bands, band_height=120.0)
    st = jax.tree_util.tree_map(np.asarray, mega.build())
    rng = np.random.default_rng(len(name))
    b = st.bodies
    box = (b.inv_mass > 0) & b.active
    pos = b.pos.copy()
    pos[box] += rng.normal(0.0, 0.06, (box.sum(), 2)).astype(np.float32)
    ang = np.where(box, rng.uniform(-0.5, 0.5, box.shape), 0.0)
    rot = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    rot[~box] = b.rot[~box]
    return kw, st.replace(bodies=b.replace(pos=pos, rot=rot))


def jax_bodies(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree.bodies)


def port_sweep_args(name):
    kw, tree = env_scene(name)
    bodies = state_from_numpy(tree, "cpu").bodies
    lo, hi = bp.compute_aabbs(bodies)
    return bp._sap_tiled_sort_stage(bodies, SimConfig(**kw), lo, hi)


def jax_sweep_emit(args):
    """The JAX kernel on the port's sweep arguments (rows interleaved)."""
    tx = args["truex"]
    out = jax_sweep(
        jnp.asarray(args["rows"].T.reshape(-1).numpy()),
        jnp.asarray(args["dyn"].numpy()), jnp.asarray(args["order"].numpy()),
        jnp.asarray(args["nact"].numpy()), args["max_pairs"],
        args["n_slabs"], args["slab_stride"], args["window_rows"],
        truex_sorted=None if tx is None else jnp.asarray(
            tx.T.reshape(-1).numpy()),
        exact_x=tx is not None)
    return [np.asarray(x) for x in out]


def assert_sweeps_equal(args):
    """Plain K4 == the JAX kernel: pairs on [0, num), num, ovf_drop,
    ovf_window.  Returns the counters."""
    ref = jax_sweep_emit(args)
    got = [x.numpy() for x in sweep_emit_tiled(**args)]
    num = int(ref[2])
    assert int(got[2]) == num
    for a, b in zip(ref[:2], got[:2]):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a[:num], b[:num])
    for name, a, b in zip(("num", "ovf_drop", "ovf_window"), ref[2:],
                          got[2:]):
        assert a == b, (name, a, b)
    return dict(num=num, ovf_drop=int(ref[3]), ovf_window=int(ref[4]))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sort_stage_matches_jax(name):
    """The sort stage's rows (banded keys, true y, true x), dyn, order,
    nact, slab geometry, budget and n_cross equal the reference's."""
    kw, tree = env_scene(name)
    (aabb, dyn, order, truex, nact, n_slabs, K, W, mp,
     n_cross) = jbp._sap_tiled_sort_stage(jax_bodies(tree),
                                          JaxConfig(**kw))[:10]
    args, got_cross, _ = port_sweep_args(name)
    np.testing.assert_array_equal(args["rows"].T.reshape(-1).numpy(),
                                  np.asarray(aabb))
    np.testing.assert_array_equal(args["dyn"].numpy(), np.asarray(dyn))
    np.testing.assert_array_equal(args["order"].numpy(), np.asarray(order))
    assert (truex is None) == (args["truex"] is None) == (name == "flat")
    if truex is not None:
        np.testing.assert_array_equal(args["truex"].T.reshape(-1).numpy(),
                                      np.asarray(truex))
    assert int(args["nact"]) == int(nact)
    assert (args["n_slabs"], args["slab_stride"], args["window_rows"],
            args["max_pairs"]) == (n_slabs, K, W, mp)
    assert int(got_cross) == int(n_cross) == 0
    assert n_slabs == 2


@pytest.mark.parametrize("name,exact_x", [
    ("flat", False), ("banded", True), ("banded", False),
    ("segmented", True), ("segmented", False)])
def test_plain_sweep_matches_jax_on_env_scenes(name, exact_x):
    """K4's plain version against the JAX interpret-mode kernel on the
    sort stage's rows: the flat two-slab scene, the banded scene and the
    segmented layout (whose keys are not monotone across band segments),
    with the true-x accept on (banded keys carry true-x columns) and
    off."""
    args, _, _ = port_sweep_args(name)
    assert (args["truex"] is not None) == (name != "flat")
    if not exact_x:
        args = dict(args, truex=None)
    counts = assert_sweeps_equal(args)
    assert counts["num"] > 300
    assert counts["ovf_drop"] == counts["ovf_window"] == 0
    if name == "flat":     # sweeps start in both slabs
        assert int(args["nact"]) > args["slab_stride"]


def numpy_rows(seed, max_pairs):
    """Sorted numpy rows over two slabs (K 1024, W 2048): narrow intervals,
    and a few wide ones near the first slab's end, whose walks reach the
    window end with rows left past it."""
    rng = np.random.default_rng(seed)
    K, W, n_slabs = 1024, 2048, 2
    npad, nact = (n_slabs - 1) * K + W, 2900
    xlo = np.sort(rng.uniform(0.0, 1000.0, nact))
    xhi = xlo + rng.uniform(0.0, 1.5, nact)
    wide = rng.choice(np.arange(990, 1024), 5, replace=False)
    xhi[wide] = 5000.0
    ylo = rng.uniform(0.0, 10.0, nact)
    yhi = ylo + rng.uniform(0.5, 3.0, nact)
    pad = np.full(npad - nact, np.inf)
    rows = np.stack([np.concatenate([c, pad]) for c in (xlo, ylo, xhi, yhi)])
    dyn = np.concatenate([(rng.random(nact) < 0.7), np.zeros(npad - nact)])
    order = np.concatenate([rng.permutation(nact),
                            np.full(npad - nact, np.iinfo(np.int32).max)])
    return dict(rows=torch.from_numpy(rows.astype(np.float32)),
                dyn=torch.from_numpy(dyn.astype(np.int32)),
                order=torch.from_numpy(order.astype(np.int32)),
                nact=torch.tensor(nact, dtype=torch.int32),
                max_pairs=max_pairs, n_slabs=n_slabs, slab_stride=K,
                window_rows=W, truex=None)


@pytest.mark.parametrize("max_pairs,counter", [(8192, "ovf_window"),
                                               (1024, "ovf_drop")])
def test_plain_sweep_matches_jax_on_overflow(max_pairs, counter):
    """Numpy-made rows: wide intervals near a slab's end force
    ``ovf_window``; the same rows with a small budget force ``ovf_drop``
    (the first emissions in sweep order kept)."""
    counts = assert_sweeps_equal(numpy_rows(7, max_pairs))
    assert counts[counter] > 0
    assert counts["ovf_window"] == 5


def test_sweep_input_checks():
    args = numpy_rows(1, 1024)
    with pytest.raises(TypeError):
        sweep_emit_tiled(**dict(args, dyn=args["dyn"].long()))
    with pytest.raises(ValueError):      # windows past the rows
        sweep_emit_tiled(**dict(args, window_rows=4096))
    with pytest.raises(ValueError):
        sweep_emit_tiled(**dict(args, truex=args["rows"][:1].clone()))
    got = sweep_emit_tiled_plain(**args)
    assert got[0].shape == (1024,) and int(got[2]) == 1024


@functools.lru_cache(maxsize=None)
def _jax_tiled(cfg, emit_routing):
    return jax.jit(functools.partial(jbp.broadphase_sap_tiled, cfg=cfg,
                                     emit_routing=emit_routing))


@pytest.mark.parametrize("emit_routing", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sap_tiled_matches_jax(name, emit_routing):
    """``broadphase_sap_tiled``: every Pairs field and counter exact, and
    with ``emit_routing`` the routing's order, lb1, lb2 (the reference's
    are x8), pair_cum and ranked columns."""
    kw, tree = env_scene(name)
    ref = _jax_tiled(JaxConfig(**kw), emit_routing)(jax_bodies(tree))
    got = bp.broadphase_sap_tiled(state_from_numpy(tree, "cpu").bodies,
                                  SimConfig(**kw), emit_routing=emit_routing)
    for field in ("pi", "pj", "valid") + COUNTS:
        a, b = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert int(got.num) > 300 and int(got.overflow) == 0
    assert (got.routing is None) == (ref.routing is None) == \
        (not emit_routing)
    if emit_routing:
        r, g = ref.routing, got.routing
        np.testing.assert_array_equal(np.asarray(r.order), g.order.numpy())
        np.testing.assert_array_equal(np.asarray(r.lb1) // 8, g.lb1.numpy())
        np.testing.assert_array_equal(np.asarray(r.lb2) // 8, g.lb2.numpy())
        np.testing.assert_array_equal(np.asarray(r.pair_cum),
                                      g.pair_cum.numpy())
        np.testing.assert_array_equal(np.asarray(r.ranked_cols),
                                      g.ranked_cols.numpy())


class _Capacity:
    """All the dispatch reads of the bodies."""

    def __init__(self, n):
        self.capacity = n


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_tiled"])
@pytest.mark.parametrize("name", ["sap", "sap_grid", "sap_tiled",
                                  "sap_window", "sap_kernel", "n2"])
@pytest.mark.parametrize("n,max_pairs", [
    (1024, 4096),       # 4 * (6144 + 8192 + 8) = 57 KB: within the budget
    (16384, 32256),     # 651 KB (the 10k pile's): within
    (33792, 104960),    # 1.65 MB (the 128-env mega-scene's): above
])
def test_dispatch_follows_reference(name, backend, n, max_pairs,
                                    monkeypatch):
    """``broadphase`` sends each config where the reference does: its
    branches are stubbed to report their name."""
    def stub(module, fn):
        monkeypatch.setattr(module, fn, lambda *a, **k: fn)

    for fn in ("broadphase_n2", "broadphase_sap_kernel",
               "broadphase_sap_grid", "broadphase_sap_tiled",
               "broadphase_sap"):
        stub(jbp, fn)
    for fn in ("broadphase_n2", "broadphase_sap_kernel",
               "broadphase_sap_grid", "broadphase_sap_tiled",
               "broadphase_sap"):
        stub(bp, fn)
    kw = dict(max_bodies=n, max_pairs=max_pairs, broadphase=name,
              solver_backend=backend)
    ref = jbp.broadphase(_Capacity(n), JaxConfig(**kw))
    assert bp.broadphase(_Capacity(n), SimConfig(**kw)) == ref
    above = bp.sweep_kernel_smem_bytes(n, max_pairs) > 900 * 1024
    if name == "sap" and backend == "pallas":
        assert ref == ("broadphase_sap_tiled" if above
                       else "broadphase_sap_kernel")
