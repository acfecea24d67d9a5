"""k1_roofline: the least time the card could take for a frame's solve
(``benchmark/roofline.py``, from the frame's live bodies and contact
points) over K1's device time a frame in the traced replays
(``kernels/contact_solver_streamed.py``: its level pre-pass and level
solves, found by kernel name), in percent."""

from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "K1")
