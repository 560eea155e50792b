"""Phase 2 of chip_smoke.py against several checkouts of the port in one
call, in turns, so that two versions of a kernel are compared on one
card.

    python slam_toolkit_tpu_torch/tools/kernel_ab.py ROOT [ROOT ...]

This is the repository's one way to pair two versions of the kernels.
Each ROOT is a directory holding a `slam_toolkit_tpu_torch` package: this
checkout, or an older commit unpacked there with `git archive`. Given
several, each runs in a process of its own (this script with that one
ROOT), in the order given (parent, change, change, parent compares two
commits), and builds its own kernels. The checks and
timers are this checkout's chip_smoke.py (`phase2`): every kernel against
its plain version, its device time with the host out of the window, its
wrapper's host time, the gather at the main path's budgets, local BA
at 0, 1 and 10 iterations, and FAST+NMS on two frames and on their
level 0 alone. Prints one JSON line per root, then one line per kernel
with its device ms under each root. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
KEYS = ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
        "max_abs_err", "split_ms", "cases_ms")


def run_one(root: str) -> dict:
    """Phase 2 of this checkout's chip_smoke.py on the package in root."""
    sys.path.insert(0, str(Path(root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from slam_toolkit_tpu_torch.utils import cuda_lib
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    lib = cuda_lib.library()
    rows = smoke.phase2(torch.device("cuda"))
    return {"root": root, "card": smoke.card_line(), "library": str(lib.path),
            "rows": {r["name"]: {k: r[k] for k in KEYS if k in r}
                     for r in rows}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    if len(args.roots) == 1:
        print("KERNEL_AB " + json.dumps(run_one(args.roots[0])), flush=True)
        return 0
    results = []
    for root in args.roots:
        out = subprocess.run([sys.executable, __file__, root],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("KERNEL_AB ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
            raise SystemExit(f"kernel_ab: {root} failed "
                             f"(exit {out.returncode})")
        results.append(json.loads(lines[0][len("KERNEL_AB "):]))
        print(json.dumps(results[-1]), flush=True)
    print(f"[{results[0]['card']}] device ms (wrapper host ms) per kernel, "
          f"roots in order {[r['root'] for r in results]}")
    for name in results[0]["rows"]:
        print(f"  {name:14s} " + "  ".join(
            f"{r['rows'][name]['ms']:.4f} ({r['rows'][name]['host_ms']:.4f})"
            for r in results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
