"""device_idle_share (%): 100 minus the mean of NVML's utilization.gpu
(the share of each sample period in which a kernel ran) sampled through
the traced window, the profiler's sub-window left out. Moves
frames_per_s."""


def read(ctx):
    util = [u for _, u in ctx.get("nvml", [])]
    if not util:
        return None
    return 100.0 - sum(util) / len(util)
