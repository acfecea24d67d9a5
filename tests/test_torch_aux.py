"""The port's auxiliaries against the JAX package's (CPU): checkpoint files
in both directions and exact resume, ``metrics.snapshot`` and the JSONL
logger, the debug guards, the stage profiler and the demos."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import checkpoint as jcheckpoint
from phyx_tpu import metrics as jmetrics
from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu_torch import checkpoint, scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.debug import (GuardError, checked_rollout,
                                  checked_step)
from phyx_tpu_torch.metrics import MetricsLogger, snapshot
from phyx_tpu_torch.profiling import (STAGES, STAGES_JOINTS, profile_step,
                                      stage_times)
from phyx_tpu_torch.step import rollout, step
from phyx_tpu_torch.types import State

torch.set_num_threads(1)

# tests/test_checkpoint.py's configuration
CKPT = dict(max_bodies=64, max_pairs=256, max_joints=8, broadphase="n2",
            solver_backend="pallas")
CFG = SimConfig(**CKPT)
# tests/test_property.py's
CFG_G = SimConfig(max_bodies=16, max_pairs=64, broadphase="n2",
                  solver_backend="pallas")
RECORDS = ("bodies", "joints", "cache", "stats")


def leaves(state):
    """{record/field: numpy array} of a State with tensor or array leaves."""
    out = {}
    for rec in RECORDS:
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            v = getattr(sub, f.name)
            out[f"{rec}/{f.name}"] = (v.numpy() if torch.is_tensor(v)
                                      else np.asarray(v))
    return out


def assert_bit_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert la[k].shape == lb[k].shape, k
        assert la[k].tobytes() == lb[k].tobytes(), k


def to_jax(state, like):
    """A port state as a JAX State with ``like``'s structure."""
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(v) for v in leaves(state_to_numpy(state))
                  .values()])


def developed(scene, frames, jcfg_kw=CKPT, **kw):
    """(JAX build of ``scene``, the port's state after ``frames`` frames
    from it)."""
    jst = getattr(jscenes, scene)(JaxConfig(**jcfg_kw), **kw).build()
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    return jst, rollout(st, SimConfig(**jcfg_kw), frames)


# --- checkpoint ------------------------------------------------------------

def test_checkpoint_keys_are_the_jax_packages(tmp_path):
    kw = dict(max_bodies=16, max_pairs=64, broadphase="n2",
              solver_backend="pallas")
    jst, st = developed("pile", 5, kw, num_boxes=8, seed=1)
    checkpoint.save(str(tmp_path / "ours.npz"), st)
    jcheckpoint.save(str(tmp_path / "ref.npz"), to_jax(st, jst))
    with np.load(tmp_path / "ours.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert list(a.keys()) == list(b.keys())
        assert len(a.keys()) == 35
        assert list(a.keys())[0] == "bodies/pos"
        assert list(a.keys())[-1] == "stats/ovf_slab"
        for k in a.keys():
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_jax_save_port_load_bit_equal(tmp_path):
    jst, st = developed("chain", 30, num_links=3)
    p = str(tmp_path / "ck.npz")
    jcheckpoint.save(p, to_jax(st, jst))
    like = scenes.chain(CFG, 3).build("cpu")
    loaded = checkpoint.load(p, like)
    assert_bit_equal(loaded, st)


def test_port_save_jax_load_bit_equal(tmp_path):
    jst, st = developed("chain", 30, num_links=3)
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, st)
    loaded = jcheckpoint.load(p, jst)
    assert_bit_equal(jax.tree_util.tree_map(np.asarray, loaded), st)


@pytest.mark.parametrize("scene", ["chain", "pile"])
def test_checkpoint_roundtrip_exact(tmp_path, scene):
    """Resume is exact (tests/test_checkpoint.py:18-36): save -> load ->
    step equals stepping straight through; the joint accumulators (the
    3-link chain, 30 + 20 frames) and the contact cache (a 12-box pile,
    15 + 10 frames) ride along."""
    sb = (scenes.chain(CFG, 3) if scene == "chain"
          else scenes.pile(CFG, 12, seed=4))
    frames = (30, 20) if scene == "chain" else (15, 10)
    st = rollout(sb.build("cpu"), CFG, frames[0])
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, st)
    st_resumed = checkpoint.load(p, sb.build("cpu"))
    assert_bit_equal(st_resumed, st)
    a = rollout(st, CFG, frames[1])
    b = rollout(st_resumed, CFG, frames[1])
    assert_bit_equal(a, b)
    warm = a.joints.accum if scene == "chain" else a.cache.normal_impulse
    assert torch.count_nonzero(warm) > 0


def test_checkpoint_capacity_mismatch_rejected(tmp_path):
    st = scenes.pile(CFG, 10).build("cpu")
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, st)
    other = SimConfig(max_bodies=128, max_pairs=256, broadphase="n2")
    with pytest.raises(ValueError, match="capacity mismatch"):
        checkpoint.load(p, State.zeros(other.max_bodies, other.max_pairs,
                                       device="cpu"))


def test_checkpoint_without_overflow_split_loads(tmp_path):
    """A file written before the per-cause overflow counters existed: the
    missing ``stats/ovf_*`` keys take ``like``'s values; a missing body
    field raises."""
    st = rollout(scenes.pile(CFG, 10).build("cpu"), CFG, 10)
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, st)
    with np.load(p) as data:
        kept = {k: data[k] for k in data.keys()
                if not k.startswith("stats/ovf_")}
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **kept)
    like = scenes.pile(CFG, 10).build("cpu")
    like.stats.ovf_slab.fill_(7)
    loaded = checkpoint.load(old, like)
    assert loaded.stats.ovf_slab.item() == 7
    assert loaded.stats.ovf_slab is not like.stats.ovf_slab
    want = leaves(st)
    for k, v in leaves(loaded).items():
        if not k.startswith("stats/ovf_"):
            assert v.tobytes() == want[k].tobytes(), k
    del kept["bodies/vel"]
    np.savez_compressed(old, **kept)
    with pytest.raises(KeyError, match="bodies/vel"):
        checkpoint.load(old, like)


def test_checkpoint_spatial_cycle(tmp_path):
    """tests/test_checkpoint.py:71 (its frame counts cut from 20 + 10 +
    10 to 10 + 3 + 3: the scalar plain solve on the CPU takes ~0.35 s a
    shard frame here): a sharded run
    unsharded, saved, loaded and re-sharded resumes equal to the bit to
    the run re-sharded from the state before the save (both restart their
    caches empty)."""
    from phyx_tpu_torch.parallel.spatial import (shard_spatial,
                                                 spatial_rollout, unshard)
    cfg = SimConfig(max_bodies=128, max_pairs=1024, broadphase="n2",
                    solver_backend="pallas")
    st = rollout(scenes.pile(cfg, 60, seed=3).build("cpu"), cfg, 10)
    sstate, lcfg, meta = shard_spatial(st, cfg, 4, halo=16)
    sstate = spatial_rollout(sstate, lcfg, meta, 3)
    glob = unshard(sstate, meta, st)
    p = str(tmp_path / "spatial.npz")
    checkpoint.save(p, glob)
    glob2 = checkpoint.load(p, scenes.pile(cfg, 60, seed=3).build("cpu"))
    assert_bit_equal(glob2, glob)
    sa, la, ma = shard_spatial(glob, cfg, 4, halo=16)
    sb, lb, mb = shard_spatial(glob2, cfg, 4, halo=16)
    assert int(glob.stats.num_contacts) > 0
    assert_bit_equal(spatial_rollout(sa, la, ma, 3),
                     spatial_rollout(sb, lb, mb, 3))


# --- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("scene,frames,kw", [
    ("pile", 15, dict(num_boxes=20, seed=0)),
    ("chain", 25, dict(num_links=3)),
])
def test_snapshot_matches_jax(scene, frames, kw):
    jst, st = developed(scene, frames, **kw)
    ours = snapshot(st)
    ref = jmetrics.snapshot(to_jax(st, jst))
    assert list(ours) == list(ref)
    for k, v in ref.items():
        if isinstance(v, int):
            assert type(ours[k]) is int and ours[k] == v, k
        else:
            assert type(ours[k]) is float, k
            np.testing.assert_allclose(ours[k], v, rtol=1e-5, err_msg=k)
    assert ours["kinetic_energy"] > 0
    if scene == "pile":
        assert ours["num_contacts"] > 0


def test_metrics_jsonl(tmp_path):
    """tests/test_checkpoint.py:108: a run_start record, then a step
    record with the counters, momentum and kinetic energy."""
    st = rollout(scenes.pile(CFG, 20).build("cpu"), CFG, 30)
    p = str(tmp_path / "m.jsonl")
    log = MetricsLogger(p, dict(scene="pile"))
    log.log(30, st, note="x")
    log.close()
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["event"] == "run_start" and lines[0]["scene"] == "pile"
    rec = lines[1]
    assert rec["event"] == "step" and rec["step"] == 30
    assert rec["note"] == "x" and "t_wall" in rec
    assert rec["num_contacts"] > 0
    assert rec["max_penetration"] < 0.1
    assert "kinetic_energy" in rec and "momentum_x" in rec


# --- debug guards ----------------------------------------------------------

def test_checked_step_passes_on_healthy_scene():
    st_ = scenes.stack(CFG_G, 3).build("cpu")
    st_ = checked_step(st_, CFG_G)
    st_ = checked_rollout(st_, CFG_G, 5)
    assert torch.isfinite(st_.bodies.pos).all()


def test_checked_step_catches_nan():
    st_ = scenes.stack(CFG_G, 3).build("cpu")
    bad = st_.replace(bodies=st_.bodies.replace(vel=st_.bodies.vel.clone()))
    bad.bodies.vel[1, 0] = float("nan")
    with pytest.raises(GuardError,
                       match="^non-finite body position after step"):
        checked_step(bad, CFG_G)


def test_checked_rollout_catches_midstream_overflow():
    """Overflowing the pair budget mid-rollout raises instead of silently
    dropping contacts, with the reference's message and the first failing
    frame's count."""
    cfg = SimConfig(max_bodies=32, max_pairs=4, broadphase="n2",
                    solver_backend="pallas")
    st_ = scenes.pile(cfg, 12, seed=0).build("cpu")
    with pytest.raises(GuardError, match="overflow") as info:
        checked_rollout(st_, cfg, 30)
    msg = str(info.value)
    assert msg.startswith("pair budget overflow: ")
    assert "candidate pairs dropped (raise max_pairs)" in msg
    # the first frame whose pairs overflow, and its count
    s, first = st_, None
    for frame in range(1, 31):
        s = step(s, cfg)
        if s.stats.pair_overflow.item() and first is None:
            first = (frame, s.stats.pair_overflow.item())
    assert msg == (f"pair budget overflow: {first[1]} candidate pairs "
                   "dropped (raise max_pairs)")
    assert info.value.frame == first[0]


def test_checked_rollout_catches_denormalized_rotation():
    st_ = scenes.stack(CFG_G, 3).build("cpu")
    bad = st_.replace(bodies=st_.bodies.replace(rot=st_.bodies.rot * 1.1))
    with pytest.raises(GuardError, match="rotation basis denormalized"):
        checked_rollout(bad, CFG_G, 3)


def test_checked_rollout_frames_equal_rollout():
    st_ = rollout(scenes.chain(CFG, 3).build("cpu"), CFG, 5)
    assert_bit_equal(checked_rollout(st_, CFG, 12), rollout(st_, CFG, 12))


# --- profiler --------------------------------------------------------------

@pytest.mark.parametrize("scene,stages", [
    ("pile", STAGES), ("chain", STAGES_JOINTS)])
def test_profile_step_structure(scene, stages):
    """tests/test_profiling.py:9-35: one row a stage in the reference's
    order (joint scenes: exclusion in broadphase, a joint_prepare stage,
    the solve contacts and joints together), then the full step."""
    cfg = SimConfig(max_bodies=32, max_pairs=128,
                    max_joints=8 if scene == "chain" else 0,
                    broadphase="n2", solver_backend="pallas")
    sb = (scenes.pile(cfg, 10, seed=0) if scene == "pile"
          else scenes.chain(cfg, 4))
    st_ = rollout(sb.build("cpu"), cfg, 5)
    rows = profile_step(st_, cfg, reps=3)
    assert [r["stage"] for r in rows] == stages + ["REAL full step"]
    assert all(isinstance(r["ms"], float) and r["ms"] > 0 for r in rows)
    cum = np.cumsum([r["ms"] for r in rows[:-1]])
    np.testing.assert_allclose([r["cum_ms"] for r in rows[:-1]], cum)


@pytest.mark.parametrize("scene", ["pile", "chain"])
def test_staged_step_equals_step(scene):
    """The profiler's stage marks leave ``step``'s frame equal to the bit
    and come in the stage order: a 20-box pile with no joint slots, a
    3-link chain with them."""
    kw = dict(CKPT, max_joints=0) if scene == "pile" else CKPT
    st_ = developed(scene, 10, kw, **(dict(num_boxes=20, seed=3)
                                      if scene == "pile"
                                      else dict(num_links=3)))[1]
    cfg = SimConfig(**kw)
    marks = []
    staged = step(st_, cfg, marks.append)
    assert marks == (STAGES_JOINTS if scene == "chain" else STAGES)
    assert_bit_equal(staged, step(st_, cfg))


@pytest.mark.parametrize("scene", ["pile", "chain"])
def test_stage_times_chains_frames(scene):
    """``stage_times`` runs ``reps`` chained frames of ``step`` (its state
    is ``rollout``'s to the bit) and reports each stage, the host's
    enqueue and, on the CPU, no sleep and device-only times."""
    kw = dict(CKPT, max_joints=0) if scene == "pile" else CKPT
    st_ = developed(scene, 5, kw, **(dict(num_boxes=20, seed=3)
                                     if scene == "pile"
                                     else dict(num_links=3)))[1]
    cfg = SimConfig(**kw)
    out, times = stage_times(st_, cfg, 3)
    assert_bit_equal(out, rollout(st_, cfg, 3))
    stages = STAGES_JOINTS if scene == "chain" else STAGES
    assert list(times) == stages + ["sleep", "host_enqueue", "device_only"]
    assert all(times[s] > 0 for s in stages)
    assert times["sleep"] == 0.0 and times["device_only"] is True
    assert times["host_enqueue"] >= sum(times[s] for s in stages)


# --- demos -----------------------------------------------------------------

@pytest.fixture
def bench_module():
    """bench.py, without the persistent compilation cache its import
    turns on for the rest of the process."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    import bench
    for k, v in before.items():
        jax.config.update(k, v)
    return bench


def test_build_envs_matches_bench(bench_module):
    from phyx_tpu_torch.demos.run_envs import build_envs
    jcfg, jst = bench_module.build_envs(16, 64, "pallas")
    cfg, st_ = build_envs(16, 64, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_bit_equal(st_, jax.tree_util.tree_map(np.asarray, jst))


def test_run_scene_demo_cpu(tmp_path, capsys):
    from phyx_tpu_torch.demos import run_scene
    m = tmp_path / "m.jsonl"
    ck = tmp_path / "ck.npz"
    base = ["pile", "--boxes", "12", "--chunk", "10", "--cpu"]
    assert run_scene.main(base + ["--steps", "20", "--metrics", str(m),
                                  "--checkpoint", str(ck)]) == 0
    recs = [json.loads(line) for line in open(m)]
    assert [r["event"] for r in recs] == ["run_start", "step", "step"]
    assert [r["step"] for r in recs[1:]] == [10, 20]
    assert recs[2]["pair_overflow"] == 0 and recs[2]["num_contacts"] > 0
    assert run_scene.main(base + ["--steps", "10", "--resume",
                                  str(ck)]) == 0
    out = capsys.readouterr().out
    assert f"checkpointed to {ck}" in out and f"resumed from {ck}" in out


def test_run_envs_demo_cpu(capsys):
    from phyx_tpu_torch.demos import run_envs
    assert run_envs.main(["--envs", "2", "--boxes", "8", "--steps", "10",
                          "--chunk", "5", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "frame 10: contacts" in out and "overflow 0" in out
    assert "per-env max height" in out
