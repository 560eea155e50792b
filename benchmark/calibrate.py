"""The readings a cell's limits are set from, in one process.

    python -m benchmark.calibrate --workload vo_circuit --seeds 1,2,3 \
        --seconds 30 [--control 1] [--fault state_unchanged]

Sets the cell up once, then for each seed drives a fresh engine through
the cell's warm-up and window, exactly as a run does, and prints one
JSON line: the window's end-to-end readings, every number `correct`
compares (the lower readings), and with --control 1 the same tracking
numbers of the control, the reference computed with TF32 matrix
products put in the program's place (the upper readings). --fault
plants one of benchmark/faults.py's faults under the timed path. Needs a
CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def readings(setup, seed: int, seconds: float, control: bool,
             fault: str = "", min_chunks: int = 1) -> dict:
    import torch

    from benchmark import faults, harness
    from benchmark.check import judge, verdict
    d = harness.drive(setup, seed, seconds, False, time.perf_counter(),
                      faults.hook(fault) if fault else None, min_chunks)
    out = {"seed": seed, "fault": fault, **harness.end_to_end(d),
           "window_s": d.window_s, "frames": d.returned,
           "drives": len(d.sessions), "chunk_ms": d.ctx["chunk_ms"]}
    cuda = setup.device.type == "cuda"
    if cuda:
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    art = [harness.artifacts(s) for s in d.sessions]
    del d
    if cuda:
        torch.cuda.empty_cache()
    limits = setup.parts["limits"]
    out["numbers"] = judge(art, setup.circuit, setup.cfg_doc, setup.traffic,
                           seed, checks=setup.checks)
    out["correct"] = verdict(out["numbers"], limits)[0]
    if control:
        out["control"] = judge(art, setup.circuit, setup.cfg_doc,
                               setup.traffic, seed, control=True,
                               checks=setup.checks)
        out["control_correct"] = verdict(out["control"], limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default="",
                    help="plant a fault of benchmark/faults.py")
    args = ap.parse_args(argv)
    from benchmark import harness
    parts = harness.resolve(harness.load_spec(), args.workload)
    setup = harness.Setup(parts, "cuda")
    harness.log(f"set up in {time.perf_counter() - T_START:.1f} s")
    for s in args.seeds.split(","):
        r = readings(setup, int(s), args.seconds, bool(args.control),
                     args.fault)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
