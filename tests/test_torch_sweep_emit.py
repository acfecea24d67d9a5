"""The port's sweep emission (K6's and K7's plain versions and
``broadphase_sap_kernel``) against the JAX package, whose ``sweep_emit_v2``
and ``sweep_emit`` run in interpret mode here, and against brute force; the
steps that run them (K7 + K2 on a pile, K6 + K2 on an env mega-scene)
against the JAX ``step``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.broadphase import broadphase_sap_kernel as jax_sap_kernel
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.kernels.sweep import sweep_emit as jax_k7
from phyx_tpu.kernels.sweep import sweep_emit_v2 as jax_k6
from phyx_tpu.parallel.envs import concat_envs as jax_concat_envs
from phyx_tpu.step import step as jax_step
from phyx_tpu.types import Bodies as JaxBodies
import phyx_tpu_torch.kernels.sweep as sweep_mod
from phyx_tpu_torch.broadphase import (EMPTY, broadphase,
                                       broadphase_sap_kernel, compute_aabbs)
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.kernels.sweep import sweep_emit, sweep_emit_v2
from phyx_tpu_torch.step import step
from phyx_tpu_torch.types import Bodies

torch.set_num_threads(1)

COUNTS = ("num", "overflow", "ovf_window", "ovf_slots", "ovf_drop",
          "ovf_band", "ovf_slab")


def sweep_rows(n, na, seed, spread=60.0, ground=False):
    """Numpy-made AABB rows, ``na`` of ``n`` active, and their stable
    x-sort (inactive rows last with their real AABBs, as the broadphase
    sorts them).  ``ground``: row 0 a long static interval across every
    chunk.  Returns (aabb (n, 4) f32 by id, order, dyn by id, na)."""
    rng = np.random.default_rng(seed)
    lox = rng.uniform(0.0, spread, n)
    loy = rng.uniform(0.0, spread / 3.0, n)
    w = rng.uniform(0.2, 2.0, (n, 2))
    dyn = (rng.random(n) < 0.8).astype(np.int32)
    if ground:
        lox[0], loy[0], w[0] = -1.0, -0.5, (spread + 2.0, 1.5)
        dyn[0] = 0
    aabb = np.stack([lox, loy, lox + w[:, 0], loy + w[:, 1]],
                    1).astype(np.float32)
    keys = np.where(np.arange(n) < na, aabb[:, 0], np.inf)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    return aabb, order, dyn, na


def k6_args(aabb, order, dyn, na):
    """K6's arguments: the columns in sorted order."""
    return aabb[order].reshape(-1), order, dyn[order], na


def k7_args(aabb, order, dyn, na):
    return aabb.reshape(-1), order, dyn, na


def run_jax(kernel, args, max_pairs):
    aabb, order, dyn, na = args
    out = kernel(jnp.asarray(aabb), jnp.asarray(order), jnp.asarray(dyn),
                 jnp.int32(na), max_pairs)
    return [np.asarray(x) for x in out]


def run_port(wrapper, args, max_pairs):
    aabb, order, dyn, na = args
    out = wrapper(torch.from_numpy(np.ascontiguousarray(aabb)),
                  torch.from_numpy(np.ascontiguousarray(order)),
                  torch.from_numpy(np.ascontiguousarray(dyn)),
                  torch.tensor(na, dtype=torch.int32), max_pairs)
    return [x.numpy() for x in out]


KERNELS = {"K6": (jax_k6, sweep_emit_v2, k6_args),
           "K7": (jax_k7, sweep_emit, k7_args)}
# (kernel, n, na, seed, spread, ground, max_pairs, overflows)
CASES = {
    "k6_one_chunk_dense": ("K6", 1024, 400, 1, 12.0, False, 16384, False),
    "k6_multi_chunk_ground": ("K6", 3072, 2500, 2, 120.0, True, 16384,
                              False),
    "k6_multi_chunk_overflow": ("K6", 2048, 1300, 3, 60.0, True, 256, True),
    "k7_cap256": ("K7", 256, 200, 4, 20.0, True, 4096, False),
    "k7_cap256_overflow": ("K7", 256, 200, 4, 20.0, True, 64, True),
    "k7_cap300": ("K7", 300, 250, 5, 25.0, True, 4096, False),
    "k7_cap300_overflow": ("K7", 300, 250, 5, 25.0, True, 100, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel(case):
    """The plain version writes the reference's pre-sort buffer slot for
    slot (EMPTY from num on), with num and ovf exact."""
    name, n, na, seed, spread, ground, max_pairs, overflows = CASES[case]
    jax_kernel, wrapper, layout = KERNELS[name]
    args = layout(*sweep_rows(n, na, seed, spread, ground))
    ref = run_jax(jax_kernel, args, max_pairs)
    got = run_port(wrapper, args, max_pairs)
    for part, a, b in zip(("pi", "pj", "num", "ovf"), ref, got):
        assert b.dtype == np.int32, (part, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=part)
    num, ovf = int(ref[2]), int(ref[3])
    assert (ovf > 0) == overflows and num > 50
    assert (ref[0][num:] == EMPTY).all()


def kept(out):
    num = int(out[2])
    return set(zip(out[0][:num].tolist(), out[1][:num].tolist()))


def test_survivors_differ_under_overflow():
    """K6 and K7 find the same pairs, but emit them in different orders,
    so a full buffer keeps different ones: their survivors differ while
    their counts agree."""
    rows = sweep_rows(2048, 1300, 6, 60.0, True)
    full = {k: run_port(KERNELS[k][1], KERNELS[k][2](*rows), 20000)
            for k in KERNELS}
    assert kept(full["K6"]) == kept(full["K7"]) and full["K6"][3] == 0
    cut = {k: run_port(KERNELS[k][1], KERNELS[k][2](*rows), 256)
           for k in KERNELS}
    assert int(cut["K6"][3]) == int(cut["K7"][3]) > 0
    assert kept(cut["K6"]) != kept(cut["K7"])


def random_bodies(n_real, cap, seed, spread):
    """tests/test_broadphase.py's random bodies (JAX ``Bodies``), with a
    long static ground across them."""
    rng = np.random.default_rng(seed)
    b = JaxBodies.zeros(cap)
    pos = rng.uniform(-spread, spread, (n_real, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n_real).astype(np.float32)
    h = rng.uniform(0.3, 1.2, (n_real, 2)).astype(np.float32)
    inv_m = (rng.uniform(0, 1, n_real) > 0.2).astype(np.float32)
    pos[0], ang[0], h[0], inv_m[0] = (0.0, -spread), 0.0, (spread, 1.0), 0.0
    return b.replace(
        pos=b.pos.at[:n_real].set(pos),
        rot=b.rot.at[:n_real].set(np.stack([np.cos(ang), np.sin(ang)], -1)),
        half_extent=b.half_extent.at[:n_real].set(h),
        inv_mass=b.inv_mass.at[:n_real].set(inv_m),
        inv_inertia=b.inv_inertia.at[:n_real].set(inv_m),
        active=b.active.at[:n_real].set(True))


def port_bodies(jb):
    return Bodies(**{f.name: torch.from_numpy(np.array(getattr(jb, f.name)))
                     for f in dataclasses.fields(Bodies)})


@functools.lru_cache(maxsize=None)
def _jax_sap_kernel(cfg):
    return jax.jit(functools.partial(jax_sap_kernel, cfg=cfg))


# (bodies, capacity, spread, max_pairs): K7 below 1024 rows, K6 at 1024
# and 2048 (two chunks), each also with a budget that overflows
SAP_CASES = {
    "k7": (200, 256, 6.0, 8192), "k7_overflow": (200, 256, 6.0, 300),
    "k6": (700, 1024, 20.0, 8192), "k6_overflow": (700, 1024, 20.0, 500),
    "k6_two_chunks": (1500, 2048, 40.0, 8192),
}


@pytest.mark.parametrize("case", sorted(SAP_CASES))
def test_sap_kernel_matches_jax(case):
    """``broadphase_sap_kernel`` equals the reference's on the same bodies:
    the lex-sorted buffer and every counter."""
    n_real, cap, spread, max_pairs = SAP_CASES[case]
    jb = random_bodies(n_real, cap, 10 + cap, spread)
    kw = dict(max_bodies=cap, max_pairs=max_pairs, solver_backend="pallas",
              broadphase="sap_kernel")
    ref = _jax_sap_kernel(JaxConfig(**kw))(jb)
    got = broadphase(port_bodies(jb), SimConfig(**kw))
    assert got.routing is None
    for name in ("pi", "pj", "valid") + COUNTS:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (int(got.ovf_drop) > 0) == case.endswith("overflow")


def brute_pairs(lo, hi, inv_mass, n_real):
    out = set()
    for i in range(n_real):
        for j in range(i + 1, n_real):
            if (lo[i, 0] <= hi[j, 0] and lo[j, 0] <= hi[i, 0]
                    and lo[i, 1] <= hi[j, 1] and lo[j, 1] <= hi[i, 1]
                    and (inv_mass[i] > 0.0 or inv_mass[j] > 0.0)):
                out.add((i, j))
    return out


@pytest.mark.parametrize("cap", [256, 1024])
def test_sap_kernel_dense_matches_brute(cap):
    """tests/test_broadphase.py's dense cluster, which the reference runs
    at cap 256 (K7), and at cap 1024 (K6): every overlapping pair with a
    dynamic body, no overflow."""
    n_real = 200
    bodies = port_bodies(random_bodies(n_real, cap, 11, 6.0))
    pairs = broadphase_sap_kernel(bodies, SimConfig(
        max_bodies=cap, max_pairs=8192, solver_backend="pallas"))
    lo, hi = (x.numpy() for x in compute_aabbs(bodies))
    got = {(int(a), int(b)) for a, b in zip(pairs.pi, pairs.pj)
           if a != EMPTY}
    assert got == brute_pairs(lo, hi, bodies.inv_mass.numpy(), n_real)
    assert int(pairs.overflow) == 0


def leaves(state):
    out = {}
    for rec in ("bodies", "joints", "cache", "stats"):
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            out[f"{rec}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def pile_k7(cfg):
    return jscenes.pile(cfg, 200, seed=0).build()


def envs_k6(cfg):
    """8 envs x 24 boxes on 4 y-bands (tests/test_torch_envs.py's grid)."""
    mega, _, _ = jax_concat_envs(
        [jscenes.pile(cfg, 24, seed=s, ground_half=8.0) for s in range(8)],
        cfg, band_width=40.0, y_bands=4, band_height=120.0)
    return mega.build()


# 4 + 2 passes; the fused solve (K2) at both capacities
STEPS = {
    # cap 512, not whole chunks: K7
    "k7_k2_pile": (pile_k7, dict(max_bodies=512, max_pairs=1024,
                                 broadphase="sap_kernel"), "sweep_emit"),
    # "sap" under pallas within the reference's sweep budget, cap 1024: K6
    "k6_k2_envs": (envs_k6, dict(max_bodies=1024, max_pairs=1024,
                                 broadphase="sap", sweep_band_h=120.0,
                                 sweep_band_y0=-60.0,
                                 sweep_band_span=256.0), "sweep_emit_v2"),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_step_matches_jax_step(case, monkeypatch):
    """Ten frames after four JAX frames, the port's input re-synced from
    the JAX state every frame: integers (pairs, cache keys, feature ids,
    every counter) exact, floats within 1e-4; the step ran the emission
    kernel's plain version once a frame."""
    scene, kw, kernel = STEPS[case]
    kw = dict(kw, solver_backend="pallas", velocity_iterations=4,
              position_iterations=2)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    calls = []
    plain = getattr(sweep_mod, f"{kernel}_plain")
    monkeypatch.setattr(sweep_mod, f"{kernel}_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jst = scene(jcfg)
    for _ in range(4):
        jst = jax_step(jst, jcfg)
    contacts = []
    for frame in range(10):
        ours = step(state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jst), "cpu"), cfg)
        jst = jax_step(jst, jcfg)
        ref = leaves(jax.tree_util.tree_map(np.asarray, jst))
        got = leaves(state_to_numpy(ours))
        for k, a in ref.items():
            b = got[k]
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, f"frame {frame} {k}")
            else:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                           err_msg=f"frame {frame} {k}")
        contacts.append(int(ref["stats.num_contacts"]))
        assert int(ref["stats.pair_overflow"]) == 0
    assert len(calls) == 10
    assert max(contacts) >= 150
