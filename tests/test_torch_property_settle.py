"""The reference's settling property (tests/test_property.py:124-145) with
the port's ``step`` on the CPU, under ``"pallas"``, the reference's
strategy and ``SETTLE`` settings: 150 frames an example."""

import torch
from hypothesis import given, settings, strategies as st

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import step
from phyx_tpu_torch.world import SceneBuilder

torch.set_num_threads(1)

SETTLE = dict(deadline=None, max_examples=25, derandomize=True)

box = st.tuples(
    st.floats(-2.0, 2.0), st.floats(-2.0, 2.0),      # pos
    st.floats(-3.1, 3.1),                            # angle
    st.floats(0.3, 1.2), st.floats(0.3, 1.2),        # half extents
    st.floats(-2.0, 2.0), st.floats(-2.0, 2.0),      # velocity
    st.floats(-2.0, 2.0),                            # angvel
)


@settings(**SETTLE)
@given(st.lists(box, min_size=2, max_size=5))
def test_prop_penetration_resolved_after_settling(boxes):
    """Dropping boxes on a ground plane: after settling, max penetration is
    bounded by slop-scale (the displacement pass must not let bodies sink)."""
    cfg = SimConfig(max_bodies=16, max_pairs=64, broadphase="n2",
                    solver_backend="pallas")
    sb = SceneBuilder(cfg)
    sb.add_box((0.0, -10.0), (50.0, 10.0), static=True, friction=0.6)
    for k, (x, y, a, hx, hy, vx, vy, w) in enumerate(boxes):
        # spread boxes out so the initial state isn't deeply interpenetrating
        sb.add_box((x + 5.0 * k, 1.5 + abs(y)), (hx, hy), angle=a,
                   friction=0.6)
    st_ = sb.build("cpu")
    for _ in range(150):
        st_ = step(st_, cfg)
    assert float(st_.stats.max_penetration) < 0.08
    ys = st_.bodies.pos[1:len(boxes) + 1, 1].numpy()
    assert ys.min() > 0.0, "a box sank through the ground"
