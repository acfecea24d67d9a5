"""The port's ``rollout_autotuned`` on the tiled tier against the JAX
package's (its tiled Pallas kernels in interpret mode): the reference's
tile_halo growth on ``ovf_slab`` (tests/test_overflow_causes.py).  The
avalanche's retunes are in tests/test_torch_tune_avalanche.py."""

import dataclasses

import jax
import numpy as np
import torch

from phyx_tpu import tune as jtune
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.world import SceneBuilder as JaxSceneBuilder
from phyx_tpu_torch import tune
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.step import rollout

torch.set_num_threads(1)


def both(jst, kw, frames, chunk):
    """``rollout_autotuned`` of the port (on a copy of the JAX state) and
    of the JAX package: [(state, final config, retunes)], retunes as
    (frame, old config, new config) dicts."""
    out = []
    for fn, state, cfg in (
            (tune.rollout_autotuned, state_from_numpy(
                jax.tree_util.tree_map(np.asarray, jst), "cpu"),
             SimConfig(**kw)),
            (jtune.rollout_autotuned, jst, JaxConfig(**kw))):
        retunes = []
        st, cfg2 = fn(state, cfg, frames, chunk=chunk,
                      on_retune=lambda a, b, done, r=retunes: r.append(
                          (done, dataclasses.asdict(a),
                           dataclasses.asdict(b))))
        out.append((st, cfg2, retunes))
    return out


def scrambled_stack(cfg, n=384, seed=0):
    """tests/test_overflow_causes.py's stack with jittered x: its x-rank
    order is a random permutation, so stacked contacts span far more
    ranks than a small tile_halo."""
    rng = np.random.default_rng(seed)
    sb = JaxSceneBuilder(cfg)
    sb.add_box((0.0, -1.0), (20.0, 1.0), static=True)
    for k in range(n):
        sb.add_box((float(rng.uniform(-0.1, 0.1)), 0.5 + 1.02 * k),
                   (0.5, 0.5), friction=0.5)
    return sb.build()


def test_autotune_grows_tile_halo_on_ovf_slab():
    """``ovf_slab`` doubles tile_halo, and only tile_halo, until the
    rollout runs clean: the same retunes as the JAX package's."""
    kw = dict(max_bodies=512, max_pairs=1024, broadphase="n2",
              solver_backend="pallas_tiled", tile_stride=256, tile_halo=128,
              velocity_iterations=4, position_iterations=2)
    (st, cfg2, retunes), (_, jcfg2, jretunes) = both(
        scrambled_stack(JaxConfig(**kw)), kw, 20, 5)
    assert retunes == jretunes
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
    assert cfg2.tile_halo > kw["tile_halo"], retunes
    for _, old, new in retunes:
        assert new["sap_window"] == old["sap_window"]
        assert new["sap_hits"] == old["sap_hits"]
        assert new["max_pairs"] == old["max_pairs"]
    st = rollout(st, cfg2, 5)
    assert int(st.stats.pair_overflow) == 0
