"""track_pose_ms_per_frame (ms): a frame's device time from "extracted"
to "tracked" (projection matching's top-2, the pose LM, the keyframe
rule, carry writes and pack), the mean over the window's frames
(benchmark/spans.py). Moves frames_per_s."""

from benchmark.spans import figure


def read(ctx):
    return figure(ctx, "track_pose_ms_per_frame")
