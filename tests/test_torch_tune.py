"""The port's budget policies (``phyx_tpu_torch/tune.py``,
``broadphase.suggest_sap_window`` and ``suggest_sap_hits``) against the JAX
package's on the same states, and the reference's own tune tests
(tests/test_tune.py, tests/test_overflow_causes.py's band-aware window) on
the port."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from phyx_tpu import broadphase as jbp
from phyx_tpu import scenes as jscenes
from phyx_tpu import tune as jtune
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.parallel.envs import concat_envs as jax_concat_envs
from phyx_tpu.step import rollout as jax_rollout
from phyx_tpu_torch import broadphase as bp
from phyx_tpu_torch import scenes, tune
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.step import rollout, step
from phyx_tpu_torch.types import EMPTY

torch.set_num_threads(1)

# tests/test_tune.py's settled-pile configuration
PILE = dict(max_bodies=256, max_pairs=4096, broadphase="sap_grid",
            sap_window=192, sap_hits=8)


def ported(jst):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")


def same_config(ours: SimConfig, ref: JaxConfig):
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.fixture(scope="module")
def settled():
    """tests/test_tune.py's settled 200-box pile, 60 frames of the JAX
    package; (JAX state, the port's copy of it)."""
    jst = jax_rollout(jscenes.pile(JaxConfig(**PILE), 200, seed=0).build(),
                      JaxConfig(**PILE), 60)
    return jst, ported(jst)


def test_tune_config_measures_the_state(settled):
    jst, st = settled
    cfg = SimConfig(**PILE)
    cfg2 = tune.tune_config(st, cfg)
    same_config(cfg2, jtune.tune_config(jst, JaxConfig(**PILE)))
    assert 16 <= cfg2.sap_window < 192
    assert cfg2.sap_window % 8 == 0
    assert 8 <= cfg2.sap_hits <= 64
    assert cfg2.max_pairs % 512 == 0
    assert cfg2.max_pairs >= int(st.stats.num_pairs)
    assert cfg2.max_bodies == cfg.max_bodies
    assert cfg2.velocity_iterations == cfg.velocity_iterations


@pytest.mark.parametrize("margin", [1.0, 1.5, 2.25])
def test_policies_match_jax(settled, margin):
    """Each policy, as integers, at the tuner's escalated margins."""
    jst, st = settled
    assert (bp.suggest_sap_window(st.bodies, margin=margin)
            == jbp.suggest_sap_window(jst.bodies, margin=margin))
    assert (bp.suggest_sap_hits(st.bodies, margin=int(4 * margin))
            == jbp.suggest_sap_hits(jst.bodies, margin=int(4 * margin)))
    assert (tune.suggest_pair_budget(st, 1.6 * margin)
            == jtune.suggest_pair_budget(jst, 1.6 * margin))
    same_config(tune.tune_config(st, SimConfig(**PILE), margin=margin),
                jtune.tune_config(jst, JaxConfig(**PILE), margin=margin))


def test_tuned_config_steps_cleanly(settled):
    jst, st = settled
    cfg2 = tune.tune_config(st, SimConfig(**PILE))
    st2 = tune.resize(st, cfg2)
    assert st2.cache.pi.shape[0] == cfg2.max_pairs
    out = rollout(st2, cfg2, 10)
    assert int(out.stats.pair_overflow) == 0
    assert torch.isfinite(out.bodies.pos).all()
    # the warm-start impulses survived the resize
    one = step(st2, cfg2)
    assert float(one.stats.max_penetration) < 0.05


@pytest.mark.parametrize("max_pairs", [1024, 4096, 8192])
def test_resize_matches_jax(settled, max_pairs):
    """Shrinking (live entries kept), equal and growing budgets: every
    cache field equal to the JAX ``resize``'s."""
    jst, st = settled
    got = tune.resize(st, SimConfig(**dict(PILE, max_pairs=max_pairs)))
    ref = jtune.resize(jst, JaxConfig(**dict(PILE, max_pairs=max_pairs)))
    for f in dataclasses.fields(got.cache):
        a = getattr(got.cache, f.name).numpy()
        b = np.asarray(getattr(ref.cache, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, f.name)
    assert (got.bodies is st.bodies and got.stats is st.stats)


def test_resize_grow_roundtrip(settled):
    _, st = settled
    small = tune.resize(st, SimConfig(**dict(PILE, max_pairs=1024)))
    big = tune.resize(small, SimConfig(**dict(PILE, max_pairs=2048)))
    live = small.cache.pi != EMPTY
    assert torch.equal(big.cache.pi[:1024][live], small.cache.pi[live])
    assert (big.cache.pi[1024:] == EMPTY).all()


def test_suggest_pair_budget_floor():
    kw = dict(max_bodies=64, max_pairs=512, broadphase="n2")
    jst = jscenes.pile(JaxConfig(**kw), 20, seed=0).build()
    b = tune.suggest_pair_budget(ported(jst))
    assert b == jtune.suggest_pair_budget(jst)
    assert b >= 512 and b % 512 == 0


def test_rollout_autotuned_recovers_from_overflow():
    """tests/test_tune.py's starved 40-box pile: the retunes (frames and
    configurations) equal the JAX package's, and the reference's checks
    hold on the port."""
    kw = dict(max_bodies=64, max_pairs=32, broadphase="n2",
              solver_backend="xla")
    jst = jscenes.pile(JaxConfig(**kw), 40, seed=0).build()
    runs = []
    for fn, state, cfg in ((tune.rollout_autotuned, ported(jst),
                            SimConfig(**kw)),
                           (jtune.rollout_autotuned, jst, JaxConfig(**kw))):
        retunes = []
        out, cfg2 = fn(state, cfg, 60, chunk=10,
                       on_retune=lambda a, b, done, r=retunes: r.append(
                           (done, dataclasses.asdict(b))))
        runs.append((out, cfg2, retunes))
    (st, cfg2, retunes), (_, jcfg2, jretunes) = runs
    assert retunes == jretunes
    same_config(cfg2, jcfg2)
    assert retunes, "overflow never triggered a retune"
    assert cfg2.max_pairs > kw["max_pairs"]
    assert int(st.stats.pair_overflow) == 0
    assert torch.isfinite(st.bodies.pos).all()
    st = rollout(st, cfg2, 10)
    assert int(st.stats.pair_overflow) == 0


def test_suggest_sap_hits_covers_the_state(settled):
    _, st = settled
    cfg = SimConfig(**PILE)
    h = bp.suggest_sap_hits(st.bodies, cfg=cfg)
    assert h >= 8
    ok = bp.broadphase_sap_grid(st.bodies, cfg.replace(sap_hits=min(h, 192)))
    assert int(ok.ovf_slots) == 0
    starved = bp.broadphase_sap_grid(st.bodies, cfg.replace(sap_hits=2))
    assert int(starved.ovf_slots) > 0
    assert int(ok.num) > int(starved.num)


def test_band_aware_window_suggestion():
    """tests/test_overflow_causes.py's banded mega-scene (8 envs over 4
    y-bands): the window and the hits measured on raw and on banded keys
    equal the JAX package's, and the banded window is well below the
    raw one."""
    base = dict(max_bodies=1024, max_pairs=4096, broadphase="sap_tiled",
                sap_long_k=4, solver_backend="xla")
    band = dict(sweep_band_h=120.0, sweep_band_y0=-60.0,
                sweep_band_span=256.0)
    jcfg = JaxConfig(**base)
    mega, _, _ = jax_concat_envs(
        [jscenes.pile(jcfg, 24, seed=s, ground_half=8.0) for s in range(8)],
        jcfg, band_width=40.0, y_bands=4, band_height=120.0)
    jst = mega.build()
    st = ported(jst)
    banded, jbanded = SimConfig(**base, **band), JaxConfig(**base, **band)
    raw = bp.suggest_sap_window(st.bodies)
    aware = bp.suggest_sap_window(st.bodies, cfg=banded)
    assert raw == jbp.suggest_sap_window(jst.bodies)
    assert aware == jbp.suggest_sap_window(jst.bodies, cfg=jbanded)
    assert (bp.suggest_sap_hits(st.bodies, cfg=banded)
            == jbp.suggest_sap_hits(jst.bodies, cfg=jbanded))
    assert (bp.suggest_sap_hits(st.bodies)
            == jbp.suggest_sap_hits(jst.bodies))
    assert aware < raw, (aware, raw)
    assert aware <= raw / 2 + 8, (aware, raw)
