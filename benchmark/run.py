"""Run one cell of BENCHMARK.json once and print its result line.

    python -m benchmark.run --workload vo_circuit --seed 7 --seconds 30 \
        --trace 0

Exits 3, printing no result, when the cell's CUDA cards are missing, and
4 when jax, jaxlib, flax or slam_toolkit_tpu is loaded once the window
has closed. The last line of standard output is the result's JSON
object; each number `correct` compares is printed beside its limit as
the last lines of standard error, and comes last in the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()       # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    harness.CACHE.mkdir(parents=True, exist_ok=True)
    # the kernel caches of the program and of torch, inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(harness.CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(harness.CACHE /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    parts = harness.resolve(harness.load_spec(), args.workload)
    import torch
    chips = int(parts["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    out = harness.run(parts, args.seed, args.seconds, bool(args.trace),
                      T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}")
        return 4
    for name, c in out["checks"].items():
        sys.stderr.write(f"check {name} = {c['value']} (limit {c['limit']})"
                         "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
