"""keyframe_event_runs_per_frame (runs/frame): the runs of the chunk
graph's keyframe IF body (its graph_stats()["if_runs"]["keyframe"])
inside the window, summed over the window's sessions, over the window's
frames. Moves frames_per_s."""


def read(ctx):
    runs = ctx.get("counted", {}).get("keyframe_if_runs")
    if runs is None or not ctx.get("frames"):
        return None
    return runs / ctx["frames"]
