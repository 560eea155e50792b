"""pose_lm_roofline_share (%): the least time one tracking pose-LM solve
(map.track_landmarks observations, tracker.num_iterations) could take
on the card, over the mean device time of a launch of csrc/pose_lm.cu's
kernel recorded in the profiler's sub-window. Moves frames_per_s."""

from benchmark.roofline import bound_s, pose_lm_work

KERNEL = "pose_lm_kernel"            # csrc/pose_lm.cu


def read(ctx):
    launches = [v for k, v in ctx.get("profile", {}).get("kernels",
                                                         {}).items()
                if KERNEL in k]
    n = sum(v[0] for v in launches)
    if not n:
        return None
    cfg = ctx["config"]
    work = pose_lm_work(cfg["map"]["track_landmarks"],
                        cfg["tracker"]["num_iterations"])
    return 100.0 * bound_s(*work, ctx["card"]) / (
        sum(v[1] for v in launches) / n)
