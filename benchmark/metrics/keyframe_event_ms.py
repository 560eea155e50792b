"""keyframe_event_ms (ms): the device time of a run of the chunk graph's
keyframe IF body (kf_start to kf_end: stereo, insert and cull, local
BA, snapshot), the mean over the window's runs (benchmark/spans.py).
Moves frames_per_s."""

from benchmark.spans import figure


def read(ctx):
    return figure(ctx, "keyframe_event_ms")
