"""The solve's bound against hand-worked counts, and the trace's
reduction on hand-made operations."""

import pytest

from benchmark import roofline, trace


def test_bound_by_hand():
    # 3 live bodies, 4 live points, 10 velocity and 6 displacement passes:
    # bytes 2 x 3 x 32 (rows in and out) + 4 x (48 + 8 + 8 in, 16 out) + 4
    b = roofline.solve_bound(3, 4, 10, 6)
    assert b["bytes"] == 192 + 320 + 4
    # operations 4 x (24 warm + 10 x 59 velocity + 6 x 40 displacement)
    assert b["ops"] == 4 * (24 + 590 + 240) == 3416
    assert b["bytes_s"] == pytest.approx(516 / 3.35e12)
    assert b["ops_s"] == pytest.approx(3416 / 67e12)
    assert b["bound_s"] == max(b["bytes_s"], b["ops_s"])
    assert b["bound_by"] == "bytes"


def test_bound_at_a_pile_frame():
    # 10,001 live bodies and 40,000 live points: bytes bound it
    b = roofline.solve_bound(10_001, 40_000, 10, 6)
    assert b["ops"] == 40_000 * 854
    assert b["bytes"] == 2 * 10_001 * 32 + 40_000 * 80 + 4
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(b["bytes"] / 3.35e12)


def test_visit_operations_counted_from_the_velocity_visit():
    # the velocity visit (reference/engine.py): relative velocity 2 x 5,
    # normal and tangent speeds 3 + 4, the normal impulse 2, its clamp 2
    # and change 1, the friction impulse 4 + 1, its bound 1, clamp 3 and
    # change 1, the impulse vector 3 + 3, both bodies' updates
    # 2 x (2 + 2 + 5), the residual 3
    assert (10 + 7 + 5 + 10 + 6 + 18 + 3) == roofline.OPS["velocity"]


def test_trace_summary():
    ops = [("void phyx::visit_levels<RowsMap, true>", 0.0, 10.0),
           ("void phyx::level_solve<false, true>", 10.0, 40.0),
           ("copy", 35.0, 45.0),
           ("void phyx::visit_levels<CumSlots, true>", 60.0, 65.0),
           ("void phyx::level_solve<false, true>", 65.0, 80.0),
           ("fill", 90.0, 100.0)]
    notes = [("rollout", 40.0, 70.0), ("readback", 79.0, 95.0),
             ("wait", 78.0, 96.0)]
    t = trace.summarize(ops, notes)
    assert t["busy_us"] == 45.0 + 20.0 + 10.0
    assert t["span_us"] == 100.0
    assert t["idle_gaps"] == [["rollout", 15e-6], ["readback", 10e-6]]
    assert trace.solve_kernel_us(ops, "K1") == 40.0
    assert trace.solve_kernel_us(ops, "K3") == 20.0
    assert t["device_ops"][0] == ["void phyx::level_solve<false, true>",
                                  45e-6]


def test_device_mirrors_of_host_annotations_are_no_operations():
    from types import SimpleNamespace

    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, device):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [ev("rollout", 0.0, 100.0, cpu),
              ev("rollout", 5.0, 95.0, cuda),
              ev("kernel_a", 5.0, 20.0, cuda),
              ev("kernel_b", 60.0, 95.0, cuda)]
    t = trace.reduce_events(events)
    assert [o[0] for o in t["ops"]] == ["kernel_a", "kernel_b"]
    assert t["busy_us"] == 50.0 and t["span_us"] == 90.0
    assert t["idle_gaps"] == [["rollout", 40e-6]]
