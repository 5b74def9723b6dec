"""Time one distributed row of chip_smoke.py on several checkouts.

The row of ``chip_smoke.py``'s distributed phase runs at world 1 on one
CUDA card, one process a checkout, in a given order (for example
parent, change, change, parent).

Each run imports the checkout's own ``chip_smoke.py`` and
``repro_torch``, builds its kernels, and runs the row's ``steps`` steps
through ``chip_smoke.distributed`` (step 0 with its checks and under
deterministic algorithms, so it is left out of the times).  Prints one
line per run and, last, one JSON object with every run's step seconds,
their median and the peak memory a step.

    python3 tools/dist_row_ab.py --row lags_hier/kernel --steps 6 \\
        --tree parent=path/to/parent --tree change=. \\
        --order parent,change,change,parent
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def child(root: str, row: str, steps: int) -> None:
    """One run on the checkout at ``root``; prints its result as JSON."""
    root_path = Path(root).resolve()
    sys.path[:0] = [str(root_path), str(root_path / "src")]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import chip_smoke as S
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    dev = torch.device("cuda", 0)
    with S.process_group(dev):
        _, results, _ = S.distributed(
            dev, tinyllama_1_1b.CONFIG, 1024, steps, plans={},
            configs={row: S.DIST_CONFIGS[row]})
    rows = results[row]["steps"]
    print(json.dumps({"step_s": [r["step_s"] for r in rows],
                      "peak": max(r["max_memory_allocated"] for r in rows),
                      "loss": [r["loss"] for r in rows]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--row", default="lags_hier/kernel")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a checkout (repeatable)")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, in run order "
                         "(default: each tree once)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.row, args.steps)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    runs = []
    for name in order:
        out = subprocess.run(
            [sys.executable, __file__, "--child", trees[name],
             "--row", args.row, "--steps", str(args.steps)],
            capture_output=True, text=True, check=False)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            print(f"dist_row_ab: {name} exited {out.returncode}")
            return 1
        got = json.loads(out.stdout.strip().splitlines()[-1])
        timed = got["step_s"][1:]
        got.update(tree=name, median_s=statistics.median(timed))
        runs.append(got)
        print(f"dist_row_ab {args.row} {name}: step s "
              f"{got['step_s']}, median of steps 1.. {got['median_s']!r}, "
              f"peak {got['peak'] / 2**30:.3f} GiB, losses {got['loss']}",
              flush=True)
    print(json.dumps({"row": args.row, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
