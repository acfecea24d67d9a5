"""The port's ``rollout_autotuned`` on a small avalanche, bench row D's
scene and tier, against the JAX package's (its tiled Pallas kernels in
interpret mode)."""

import dataclasses

import jax
import numpy as np
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu import tune as jtune
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu_torch import tiling, tune
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


def test_avalanche_starved_sweep_retunes_as_jax():
    """A 100-box avalanche on the tiled tier with the grid sweep's window
    and hit slots starved (16 and 2): the hit slots spill as the boxes
    land on the slope; the retune (frame and configuration) equals the JAX
    package's, the contact slots stay in whole 1024-slot blocks (the tier
    does not change), and the port's next chunk runs clean (the JAX run
    stops at the retune: each configuration it meets compiles anew, ~40 s
    in interpret mode)."""
    kw = dict(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
              sap_window=16, sap_hits=2, solver_backend="pallas_tiled",
              tile_stride=256, tile_halo=256, velocity_iterations=4,
              position_iterations=2)
    jst = jscenes.avalanche(JaxConfig(**kw), 100, seed=0).build()
    (st, cfg2, retunes), (_, jcfg2, jretunes) = both(jst, kw, 20, 10)
    assert retunes == jretunes
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
    assert [r[0] for r in retunes] == [20]
    assert cfg2.sap_hits > kw["sap_hits"]
    assert tiling.resolve_tiled(cfg2, cfg2.max_bodies, 2 * cfg2.max_pairs)
    st = rollout(st, cfg2, 10)
    assert int(st.stats.pair_overflow) == 0
    assert torch.isfinite(st.bodies.pos).all()
