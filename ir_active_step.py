"""Times the Flow IR's nonlinear steps (``xla`` and ``active``) of one or
more checkouts of this repository on one card, in turns, a process a turn.

Each turn runs ``chip_smoke.ir_profiles`` of that checkout: per nonlinear
library model at ``--side``² f32, 4 ``xla`` steps and 4 ``active`` steps,
their CUDA-event wall time (median of 3) and the profiler's device activity
(busy time, idle share, kernels). Give two checkouts in the order parent,
change, change, parent to compare them on the same card within one call:

    python3 ir_active_step.py --side 8192 _parent . . _parent

Prints the card's name and power limit, one line a turn, and the rows as
one JSON object; writes them to ``chiprun_out/ir_active_step.json``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+",
                    help="checkouts of the repository, one turn each")
    ap.add_argument("--side", type=int, default=8192)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    turns = []
    for root in args.roots:
        root = Path(root).resolve()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); import chip_smoke; "
             "chip_smoke.ir_profiles(sys.argv[2])", str(root),
             str(args.side)], cwd=root, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"root": str(root), "rows": rows})
        print(root.name or str(root), json.dumps(
            {k: {"wall_ms_4_steps": v.get("wall_ms"),
                 "device_busy_ms": v.get("device_busy_ms"),
                 "idle_share": v.get("idle_share"),
                 "by_kind": v.get("device_by_kind")}
             for k, v in rows.items()}),
            flush=True)
    out = {"card": card, "side": args.side, "turns": turns}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ir_active_step.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
