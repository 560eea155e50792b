"""extract_ms_per_frame (ms): a frame's device time from its start stamp
to "extracted" (the fetch and build_frame: the extractor), the mean over
the window's frames (benchmark/spans.py). Moves frames_per_s."""

from benchmark.spans import figure


def read(ctx):
    return figure(ctx, "extract_ms_per_frame")
