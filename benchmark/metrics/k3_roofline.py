"""k3_roofline: the least time the card could take for a frame's solve
(``benchmark/roofline.py``, from the frame's live bodies and contact
points) over K3's device time a frame in the traced replays
(``kernels/contact_solver_tiled.py``: its level pre-pass over the
slab-major slots and level solves, found by kernel name), in percent."""

from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "K3")
