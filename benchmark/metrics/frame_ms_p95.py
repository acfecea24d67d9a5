"""frame_ms_p95: the 95th percentile over the window's frames of the host
time from a frame's call to its bodies' positions on the host (mixes that
read back, one frame a call)."""

import numpy as np


def read(run):
    times = [(c.t_done - c.t_call) / c.frames * 1e3
             for c in run.window.calls if c.t_done is not None]
    if not times:
        return None
    return float(np.percentile(times, 95))
