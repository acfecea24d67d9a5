"""The port's spatial decomposition (``phyx_tpu_torch/parallel/spatial.py``)
against the JAX package's on the 8 virtual CPU devices of conftest.

The host parts (``suggest_halo``, ``shard_spatial``, ``unshard``,
``rebalance``) and one halo exchange must equal the reference's exactly,
floats included; one sharded frame re-synced from the JAX sharded state
must be within 1e-4 of the reference's frame (integers exact), as a step
is.  The port's own mirrors of tests/test_spatial.py are in
tests/test_torch_spatial_mirrors.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.parallel import spatial as jspatial
from phyx_tpu.world import SceneBuilder as JaxSceneBuilder
from phyx_tpu_torch import tiling
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.parallel import spatial
from phyx_tpu_torch.types import SolverStats
from phyx_tpu_torch.world import SceneBuilder
from test_torch_step import leaves

torch.set_num_threads(1)

# tests/test_spatial.py's base configuration
BASE = dict(max_bodies=256, max_pairs=2048, broadphase="sap", sap_window=64,
            solver_backend="xla")
JOINTED = dict(BASE, max_joints=32, solver_backend="pallas")
# tests/test_spatial.py:135's pallas scene, and :159's tiled forcing
SMALL_PALLAS = dict(BASE, solver_backend="pallas", max_bodies=128,
                    max_pairs=1024, sap_window=32)
SMALL_TILED = dict(SMALL_PALLAS, solver_backend="pallas_tiled",
                   tile_stride=256, tile_halo=256)


def stacks(sb, n_stacks=8, height=3, spacing=8.0):
    """tests/test_spatial.py:36: short stacks along x on one ground."""
    sb.add_box((0.0, -1.0), (n_stacks * spacing, 1.0), static=True)
    x0 = -(n_stacks - 1) * spacing / 2.0
    for s in range(n_stacks):
        for k in range(height):
            sb.add_box((x0 + s * spacing, 0.5 + 1.02 * k), (0.5, 0.5))
    return sb


def chains(sb, n_chains=4, links=3, spacing=12.0):
    """tests/test_spatial.py:222: pendulum chains from static anchors."""
    sb.add_box((0.0, -1.0), (n_chains * spacing, 1.0), static=True)
    x0 = -(n_chains - 1) * spacing / 2.0
    for c in range(n_chains):
        x = x0 + c * spacing
        prev = sb.add_box((x, 8.0), (0.4, 0.4), static=True)
        for k in range(1, links + 1):
            cur = sb.add_box((x + 0.9 * k, 8.0), (0.4, 0.4))
            sb.add_revolute_joint(prev, cur, (x + 0.9 * k - 0.45, 8.0))
            prev = cur
    return sb


def pile60(sb):
    """A 60-box pile on a ground: boxes in loose rows, numpy-jittered."""
    rng = np.random.default_rng(3)
    sb.add_box((0.0, -1.0), (20.0, 1.0), static=True)
    for k in range(60):
        x = -9.0 + 1.25 * (k % 15) + rng.uniform(-0.2, 0.2)
        sb.add_box((x, 0.6 + 1.1 * (k // 15)), (0.5, 0.5),
                   angle=float(rng.uniform(-0.2, 0.2)))
    return sb


def twin_stacks(sb, k=6):
    """tests/test_spatial.py:290: two stacks straddling x = 0, every box
    of one x-overlapping every box of the other."""
    sb.add_box((0.0, -1.0), (30.0, 1.0), static=True)
    for j in range(k):
        sb.add_box((-0.45, 0.5 + 1.02 * j), (0.5, 0.5))
    for j in range(k):
        sb.add_box((+0.45, 0.5 + 1.02 * j), (0.5, 0.5))
    return sb


def small_stacks(sb):
    """tests/test_spatial.py:135's 8 stacks of 2."""
    sb.add_box((0.0, -1.0), (40.0, 1.0), static=True)
    for s in range(8):
        for k in range(2):
            sb.add_box((-14.0 + s * 4.0, 0.5 + 1.02 * k), (0.5, 0.5))
    return sb


def both(scene, kw):
    """(JAX config, JAX state, port config, port state) of ``scene``,
    each built by its own package's SceneBuilder."""
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    return (jcfg, scene(JaxSceneBuilder(jcfg)).build(), cfg,
            scene(SceneBuilder(cfg)).build("cpu"))


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("x",))


def numpy_tree(jst):
    return jax.tree_util.tree_map(np.asarray, jst)


def to_port(jst):
    return state_from_numpy(numpy_tree(jst), "cpu")


def assert_exact(ref: dict, got: dict):
    assert list(ref) == list(got)
    for k, a in ref.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def assert_resynced(ref: dict, got: dict, what: str):
    for k, a in ref.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                       err_msg=f"{what} {k}")


def assert_meta_equal(ref, got):
    assert tuple(ref.dims) == tuple(got.dims)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "dims":
            continue
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        else:
            assert a == b, f.name


def assert_cfg_equal(jcfg, cfg):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def port_meta(jm):
    """The reference's ``SpatialMeta`` as the port's."""
    return spatial.SpatialMeta(**{
        f.name: (spatial.SpatialDims(*jm.dims) if f.name == "dims"
                 else getattr(jm, f.name)) for f in dataclasses.fields(jm)})


def to_jax(state, like):
    """A port state as a JAX State with ``like``'s structure."""
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jax.numpy.asarray(v) for v in leaves(state_to_numpy(state))
         .values()])


# --- the host parts, exactly -------------------------------------------------

@pytest.mark.parametrize("scene,kw,n", [
    (stacks, BASE, 4), (chains, JOINTED, 4), (pile60, BASE, 4),
    (pile60, BASE, 3)], ids=["stacks", "jointed_chains", "pile60",
                             "pile60_3_shards"])
def test_shard_spatial_equals_jax(scene, kw, n):
    """Every leaf, ``local_cfg`` and ``meta`` equal to the reference's."""
    jcfg, jst, cfg, st = both(scene, kw)
    halo = jspatial.suggest_halo(jst, n)
    assert spatial.suggest_halo(st, n) == halo
    jsst, jl, jm = jspatial.shard_spatial(jst, jcfg, n, halo)
    sst, lcfg, meta = spatial.shard_spatial(st, cfg, n, halo)
    assert_exact(leaves(numpy_tree(jsst)), leaves(state_to_numpy(sst)))
    assert_cfg_equal(jl, lcfg)
    assert_meta_equal(jm, meta)
    if scene is chains:
        assert lcfg.max_joints > 0 and meta.owned_joint_ids is not None


def test_component_above_fair_share_raises():
    """tests/test_spatial.py:280: a 39-body chain at 8 shards."""
    cfg = SimConfig(**dict(JOINTED, max_joints=64))
    sb = SceneBuilder(cfg)
    prev = sb.add_box((0.0, 20.0), (0.4, 0.4), static=True)
    for k in range(1, 40):
        cur = sb.add_box((0.9 * k, 20.0), (0.4, 0.4))
        sb.add_revolute_joint(prev, cur, (0.9 * k - 0.45, 20.0))
        prev = cur
    with pytest.raises(ValueError, match="component"):
        spatial.shard_spatial(sb.build("cpu"), cfg, n_shards=8, halo=8)


@pytest.mark.parametrize("max_pairs,shards", [(800_256, 4), (2048, 4),
                                              (8192, 8), (100, 1)])
def test_block_pair_budget_keeps_tiled_tier(max_pairs, shards):
    """``tiling.block_pair_budget``: the least pair budget at or above a
    shard's fair share whose contact slots come in whole 1024-slot blocks,
    at least two, so a ``"pallas"`` shard above the streamed budget runs
    the tiled solve; the reference's default share (row D's 100k
    avalanche: 800,256 pairs in 4) does not."""
    share = -(-max_pairs // shards)
    per = tiling.block_pair_budget(share)
    assert per >= share and per % 512 == 0 and per >= 1024
    assert per - share < 512 or per == 1024
    cfg = SimConfig(**dict(BASE, solver_backend="pallas"))
    assert tiling.resolve_tiled(cfg, 30_000, 2 * per)
    if max_pairs == 800_256:
        assert not tiling.resolve_tiled(cfg, 30_000,
                                        2 * max(256, share))


@pytest.mark.parametrize("scene", [stacks, pile60, twin_stacks])
def test_suggest_halo_equals_jax(scene):
    jcfg, jst, cfg, st = both(scene, BASE)
    for n in (1, 2, 4, 8):
        for margin in (2.0, 3.5):
            assert (spatial.suggest_halo(st, n, margin)
                    == jspatial.suggest_halo(jst, n, margin))
    assert spatial.suggest_halo(st, 4) % 8 == 0


def jax_exchange(jbodies, dims):
    """The reference's ``_exchange_halo`` under ``shard_map`` on D devices:
    (bodies, halo_overflow (D,))."""
    def local(b):
        out, ovf = jspatial._exchange_halo(
            jax.tree.map(lambda a: a[0], b), dims, "x")
        return jax.tree.map(lambda a: a[None], out), ovf[None]

    return jax.jit(jax.shard_map(
        local, mesh=mesh(dims.D), in_specs=P("x"),
        out_specs=(P("x"), P("x")), check_vma=False))(jbodies)


def bodies_leaves(b):
    return {f.name: np.asarray(getattr(b, f.name)) if not torch.is_tensor(
        getattr(b, f.name)) else getattr(b, f.name).numpy()
        for f in dataclasses.fields(b)}


@pytest.mark.parametrize("scene,n,halo", [
    (twin_stacks, 2, 2), (twin_stacks, 2, 6), (stacks, 4, 8)],
    ids=["twin_halo2", "twin_halo6", "stacks_4_shards"])
def test_exchange_halo_equals_jax(scene, n, halo):
    """One exchange on the reference's sharded state developed 3 frames
    (by the port, handed to both): bodies, floats included, and
    ``halo_overflow`` exactly equal; the undersized halo of
    tests/test_spatial.py:308 counts (> 0), the adequate one reads 0."""
    jcfg, jst, _, _ = both(scene, BASE)
    jsst, jl, jm = jspatial.shard_spatial(jst, jcfg, n, halo)
    sst = spatial.spatial_rollout(to_port(jsst), SimConfig(
        **dataclasses.asdict(jl)), port_meta(jm), 3)
    jb, jovf = jax_exchange(to_jax(sst, jsst).bodies, jm.dims)
    b, ovf = spatial._exchange_halo(sst.bodies,
                                    spatial.SpatialDims(*jm.dims))
    assert ovf.dtype == torch.int32
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    assert_exact(bodies_leaves(jb), bodies_leaves(b))
    if scene is twin_stacks:
        assert (int(ovf.sum()) > 0) == (halo == 2)


def test_stats_reduction_equals_jax():
    """Per-shard counters made by numpy, reduced by the reference (its
    ``psum``/``pmax`` after a scan of no frame) and by ``reduce_stats``."""
    jcfg, jst, _, _ = both(stacks, BASE)
    jsst, jl, jm = jspatial.shard_spatial(jst, jcfg, 4, 8)
    rng = np.random.default_rng(5)
    fields = {}
    for f in dataclasses.fields(jsst.stats):
        a = np.asarray(getattr(jsst.stats, f.name))
        fields[f.name] = (rng.integers(0, 1000, a.shape).astype(a.dtype)
                          if a.dtype.kind == "i"
                          else rng.normal(0.0, 1.0, a.shape).astype(a.dtype))
    jsst = jsst.replace(stats=jsst.stats.replace(**{
        k: jax.numpy.asarray(v) for k, v in fields.items()}))
    ref = jspatial.spatial_rollout(jsst, jl, mesh(4), jm, 0).stats
    got = spatial.reduce_stats(SolverStats(**{
        k: torch.from_numpy(v) for k, v in fields.items()}))
    for f in dataclasses.fields(got):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(got, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape == (4,), f.name
        assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("scene,kw", [(stacks, BASE), (chains, JOINTED)],
                         ids=["stacks", "jointed_chains"])
def test_unshard_and_rebalance_equal_jax(scene, kw):
    """On a sharded state developed 4 frames (by the port, handed to both):
    ``unshard`` (joint impulses included) and ``rebalance`` to a new halo
    equal to the reference's exactly."""
    jcfg, jst, cfg, _ = both(scene, kw)
    jsst, jl, jm = jspatial.shard_spatial(jst, jcfg, 4, 8)
    meta = port_meta(jm)
    sst = spatial.spatial_rollout(to_port(jsst), SimConfig(
        **dataclasses.asdict(jl)), meta, 4)
    jsst, template = to_jax(sst, jsst), to_port(jst)
    if scene is chains:
        assert float(sst.joints.accum.abs().sum()) > 0.0
    assert_exact(leaves(numpy_tree(jspatial.unshard(jsst, jm, jst))),
                 leaves(state_to_numpy(spatial.unshard(sst, meta,
                                                       template))))
    ref = jspatial.rebalance(jsst, jm, jst, jcfg, halo=16)
    got = spatial.rebalance(sst, meta, template, cfg, halo=16)
    assert_exact(leaves(numpy_tree(ref[0])), leaves(state_to_numpy(got[0])))
    assert_cfg_equal(ref[1], got[1])
    assert_meta_equal(ref[2], got[2])


@pytest.mark.parametrize("scene,kw,n,pairs", [
    (stacks, BASE, 4, None), (small_stacks, SMALL_PALLAS, 2, None),
    (small_stacks, SMALL_TILED, 2, 1024)],
    ids=["xla", "pallas", "pallas_tiled"])
def test_spatial_frame_resynced_to_jax(scene, kw, n, pairs):
    """One sharded frame from the reference's sharded state, developed 2
    frames under ``"xla"`` (halos and caches filled; by the port, handed
    to both): integers exact, floats within 1e-4, the stats reduced
    across shards included.  (The reference's interpret-mode kernels take
    ~10 and ~35 s to compile here, hence 2 shards for them.)"""
    jcfg, jst, cfg, _ = both(scene, kw)
    jsst, jl, jm = jspatial.shard_spatial(jst, jcfg, n, 8,
                                          max_pairs_per_shard=pairs)
    lcfg, meta = SimConfig(**dataclasses.asdict(jl)), port_meta(jm)
    sst = spatial.spatial_rollout(to_port(jsst), lcfg.replace(
        solver_backend="xla"), meta, 2)
    got = spatial.spatial_rollout(sst, lcfg, meta, 1)
    jsst = jspatial.spatial_rollout(to_jax(sst, jsst), jl, mesh(n), jm, 1)
    assert_resynced(leaves(numpy_tree(jsst)), leaves(state_to_numpy(got)),
                    kw["solver_backend"])
    assert int(np.asarray(jsst.stats.num_contacts)[0]) > 8
