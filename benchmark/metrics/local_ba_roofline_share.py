"""local_ba_roofline_share (%): the least time one local-BA solve of the
configuration's shape (window_keyframes poses, max_points points,
num_iterations) could take on the card, over the mean device time of a
launch of csrc/local_ba.cu's kernel recorded in the profiler's
sub-window. Moves frames_per_s."""

from benchmark.roofline import bound_s, local_ba_work

KERNEL = "local_ba_kernel"           # csrc/local_ba.cu


def read(ctx):
    launches = [v for k, v in ctx.get("profile", {}).get("kernels",
                                                         {}).items()
                if KERNEL in k]
    n = sum(v[0] for v in launches)
    if not n:
        return None
    lb = ctx["config"]["local_ba"]
    work = local_ba_work(lb["window_keyframes"], lb["max_points"],
                         lb["num_iterations"])
    return 100.0 * bound_s(*work, ctx["card"]) / (
        sum(v[1] for v in launches) / n)
