"""device_gap_ms_per_chunk (ms): the device's time from one chunk
graph's end stamp to the next one's start within a drive (the host
between chunks: fold, rows, upload, launch), the mean over the window's
gaps (benchmark/spans.py). Moves frames_per_s."""

from benchmark.spans import figure


def read(ctx):
    return figure(ctx, "device_gap_ms_per_chunk")
