"""The port's own mirrors of tests/test_spatial.py: spatial decomposition
(``phyx_tpu_torch/parallel/spatial.py``) against the port's unsharded run
on the CPU, under that file's bounds (additive-Schwarz cut coupling:
convergence-level parity)."""

import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.parallel import spatial
from phyx_tpu_torch.step import rollout
from phyx_tpu_torch.world import SceneBuilder
from test_torch_spatial import BASE, JOINTED, chains, stacks

torch.set_num_threads(1)


def solo_and_sharded(st, cfg, n, halo, frames, chunks=1, rebalance=False):
    """(unsharded rollout, sharded run unsharded, the sharded state)."""
    solo = rollout(st, cfg, frames)
    sst, lcfg, meta = spatial.shard_spatial(st, cfg, n, halo)
    for _ in range(chunks):
        sst = spatial.spatial_rollout(sst, lcfg, meta, frames // chunks)
        if rebalance:
            sst, lcfg, meta = spatial.rebalance(sst, meta, st, cfg)
    return solo, spatial.unshard(sst, meta, st), sst


def active_pos_err(st, solo, back):
    act = st.bodies.active
    assert torch.isfinite(back.bodies.pos).all()
    return float((back.bodies.pos[act] - solo.bodies.pos[act]).abs().max())


def test_shard_unshard_roundtrip():
    cfg = SimConfig(**BASE)
    st = stacks(SceneBuilder(cfg)).build("cpu")
    sst, lcfg, meta = spatial.shard_spatial(st, cfg, 4, 8)
    assert lcfg.max_bodies == meta.dims.S + 2 * meta.dims.H + meta.dims.M
    back = spatial.unshard(sst, meta, st)
    assert torch.equal(back.bodies.pos, st.bodies.pos)
    assert torch.equal(back.bodies.inv_mass, st.bodies.inv_mass)


def test_separated_stacks_match_single_device():
    """tests/test_spatial.py:62, 5e-2 against the unsharded run, on 20
    frames of the reference's 40 (for the tests' time)."""
    cfg = SimConfig(**BASE)
    st = stacks(SceneBuilder(cfg)).build("cpu")
    solo, back, sst = solo_and_sharded(st, cfg, 4, 8, 20)
    assert active_pos_err(st, solo, back) <= 5e-2
    assert int(sst.stats.pair_overflow[0]) == 0


def test_cut_spanning_impulse_chain():
    """tests/test_spatial.py:82: a row of touching boxes across every cut,
    hit from the left; 30 frames, halo 12, 5e-2."""
    cfg = SimConfig(**BASE)
    sb = SceneBuilder(cfg)
    sb.add_box((0.0, -1.0), (60.0, 1.0), static=True)
    n = 24
    for k in range(n):
        sb.add_box(((k - n / 2) * 1.01, 0.5), (0.5, 0.5), friction=0.05)
    sb.add_box((-n / 2 * 1.01 - 3.0, 0.5), (0.5, 0.5), friction=0.05,
               velocity=(8.0, 0.0))
    st = sb.build("cpu")
    solo, back, sst = solo_and_sharded(st, cfg, 4, 12, 30)
    assert active_pos_err(st, solo, back) <= 5e-2
    assert int(sst.stats.pair_overflow[0]) == 0


def test_migration_across_cut():
    """tests/test_spatial.py:108: a fast box from the leftmost band hits a
    resting box (at frame ~25) and both move on; 40 frames of the
    reference's 60 (for the tests' time), in 4 chunks with rebalances."""
    cfg = SimConfig(**BASE)
    sb = SceneBuilder(cfg)
    sb.add_box((0.0, -1.0), (60.0, 1.0), static=True)
    for x in (-20.0, -12.0, -4.0, 4.0):
        sb.add_box((x, 0.5), (0.5, 0.5), friction=0.0)
    sb.add_box((-26.0, 0.5), (0.5, 0.5), friction=0.0, velocity=(12.0, 0.0))
    st = sb.build("cpu")
    solo, back, _ = solo_and_sharded(st, cfg, 4, 8, 40, chunks=4,
                                     rebalance=True)
    assert active_pos_err(st, solo, back) <= 5e-2


def test_jointed_chains_match_single_device():
    """tests/test_spatial.py:262: 25 frames under "pallas", 5e-2; the
    joints' warm impulses survive the unshard."""
    cfg = SimConfig(**JOINTED)
    st = chains(SceneBuilder(cfg)).build("cpu")
    solo, back, _ = solo_and_sharded(st, cfg, 4, 8, 25)
    assert active_pos_err(st, solo, back) <= 5e-2
    live = st.joints.kind != 0
    assert float(back.joints.accum[live].abs().sum()) > 0.0


def test_midscale_cut_convergence_quantified():
    """tests/test_spatial.py:325: a 1,536-box grid compacted 10 frames,
    then 20 frames at 8 shards with ``suggest_halo`` against 20 unsharded:
    the halo counter 0, no pair overflow, max |dpos| below the
    reference's 0.12 envelope."""
    cols, rows = 48, 32
    cfg = SimConfig(**dict(BASE, max_bodies=2048, max_pairs=8192,
                           sap_window=96))
    sb = SceneBuilder(cfg)
    sb.add_box((0.0, -1.0), (0.55 * cols + 10.0, 1.0), static=True)
    x0 = -(cols - 1) * 0.55
    for r in range(rows):
        for c in range(cols):
            sb.add_box((x0 + 1.1 * c + 0.001 * r, 0.5 + 1.01 * r),
                       (0.5, 0.5))
    st = rollout(sb.build("cpu"), cfg, 10)
    solo, back, sst = solo_and_sharded(st, cfg, 8,
                                       spatial.suggest_halo(st, 8), 20)
    assert int(sst.stats.halo_overflow[0]) == 0
    assert int(sst.stats.pair_overflow[0]) == 0
    err = active_pos_err(st, solo, back)
    assert err < 0.12, f"cut error {err}"
