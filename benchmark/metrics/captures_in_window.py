"""captures_in_window (captures): CUDA-graph captures made inside the
window, summed over the chunk's graphs, the keyframe and cull programs'
and the loop programs' of every session (a new drive's engine captures
its graphs at its first chunk). Moves frames_per_s."""


def read(ctx):
    return ctx.get("counted", {}).get("captures")
