"""The reference's tests that hold the colored solve against the oracle
and against the serial Pallas solve, on the port: tests/test_joints.py:105-
130 (jointed scenes), tests/test_pallas_solver.py:145 (a pile) and
tests/test_residual_gates.py:85 (gated against exact on both backends),
at their tolerances."""

import numpy as np
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import step

torch.set_num_threads(1)

JOINTS = dict(max_bodies=64, max_pairs=256, max_joints=32, broadphase="n2",
              solver_backend="xla")
PALLAS = SimConfig(max_bodies=32, max_pairs=128, broadphase="n2",
                   solver_backend="pallas")


def run(st, cfg, frames):
    for _ in range(frames):
        st = step(st, cfg)
    return st


def test_xla_joints_match_oracle():
    """Colored joint sweeps after the contact colors each pass: a 5-link
    chain tracks the oracle at convergence level for 60 frames."""
    cfg = SimConfig(**JOINTS)
    st = run(scenes.chain(cfg, 5).build("cpu"), cfg, 60)
    ow = jscenes.chain(JaxConfig(**JOINTS), 5).to_oracle()
    for _ in range(60):
        ow.step()
    np.testing.assert_allclose(st.bodies.pos[:7].numpy(),
                               np.asarray(ow.pos)[:7], atol=5e-3)
    assert float(st.bodies.vel[1:7].abs().max()) > 1e-3


def test_xla_joints_match_pallas():
    """Colored against the fused serial solve on a chain with boxes
    falling on it: the same algorithm in another order stays within
    convergence-level tolerance, and the joints carry load on both."""
    cfg_x = SimConfig(max_bodies=128, max_pairs=1024, max_joints=32,
                      broadphase="n2", solver_backend="xla")
    cfg_p = cfg_x.replace(solver_backend="pallas")

    def build(cfg):
        sb = scenes.chain(cfg, 8)
        for k in range(6):
            sb.add_box((1.0 + 0.9 * k, 2.0 + 0.2 * k), (0.3, 0.3),
                       friction=0.5)
        return sb.build("cpu")

    st_x = run(build(cfg_x), cfg_x, 40)
    st_p = run(build(cfg_p), cfg_p, 40)
    np.testing.assert_allclose(st_x.bodies.pos.numpy(),
                               st_p.bodies.pos.numpy(), atol=2e-2)
    kx = st_x.joints.kind.numpy() == 1
    assert np.abs(st_x.joints.accum.numpy()[kx]).max() > 1e-3


def test_pallas_vs_xla_backend_agree():
    """Serial and colored sweep orders converge to the same contact
    solution: settled states agree loosely."""
    cfg_x = PALLAS.replace(solver_backend="xla")
    sb = scenes.pile(PALLAS, 12, seed=4)
    st_p = run(sb.build("cpu"), PALLAS, 100)
    st_x = run(sb.build("cpu"), cfg_x, 100)
    np.testing.assert_allclose(st_p.bodies.pos.numpy(),
                               st_x.bodies.pos.numpy(), atol=3e-2)


def test_rel_gates_track_exact_all_backends():
    """Gated settles to the same configuration as exact fixed-count passes
    on both the serial solve and the colored one."""
    for backend in ("pallas", "xla"):
        cfg0 = PALLAS.replace(solver_backend=backend)
        cfg1 = cfg0.replace(velocity_rel_tol=1e-3, position_rel_tol=1e-3)
        sb = scenes.stack(PALLAS, 5)
        st0 = run(sb.build("cpu"), cfg0, 120)
        st1 = run(sb.build("cpu"), cfg1, 120)
        d = (st0.bodies.pos - st1.bodies.pos).abs().max().item()
        assert d < 1e-2, f"{backend}: gated diverged {d}"
        assert float(st1.stats.max_penetration) < 0.05
