"""rollout_call_ms: the mean host time of one ``step.rollout`` call of the
window, from its entry to its return (copy of the state in, the replays'
launch, the copy out queued), in ms a call; the calls of the profiled
stretch, whose host work the profiler slows, are left out."""


def read(run):
    calls = [c for c in run.window.calls if not c.traced]
    if not calls:
        return None
    return sum(c.t_return - c.t_call for c in calls) / len(calls) * 1e3
