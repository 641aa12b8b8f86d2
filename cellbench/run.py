"""The benchmark's one command:

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's files by name, makes every input on the device from
the seed, warms up only the cell's own shapes, measures for ``--seconds``,
checks the answers against the plain reference, and prints one JSON line
as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error).

It exits with another code than 0, and prints no result, when there is no
card or fewer cards than the cell asks for, when the program cannot be
imported, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded
once the window has closed.

``--control program_bf16`` runs the program with its bfloat16 interior
knob and ``--control reference_bf16`` puts the reference computed in
bfloat16 in the program's place: the checks must come out false on both
(``PERF.md``). The driver never passes ``--control``.

Caches: the kernel build directory (``utils.compile_cache``), and any
Triton, torch-extension or CUDA cache, are fixed directories under
``cellbench/.cache/`` in the checkout, so only a cell's first run builds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

from cellbench import registry

#: top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_model_tpu")

CACHE = registry.ROOT / ".cache"


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: its start time in
    clock ticks since boot, against the boot clock); 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return max(0.0, boot - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


def set_caches() -> str:
    """Point every build and kernel cache into the checkout, before torch
    is imported; returns the kernel build directory."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    build = CACHE / "build"
    build.mkdir(parents=True, exist_ok=True)
    os.chmod(build, 0o700)
    return str(build)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def main(argv=None) -> int:
    age = process_age_s()
    t_entry = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m cellbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="none",
                    choices=("none", "program_bf16", "reference_bf16"))
    args = ap.parse_args(argv)

    bench = registry.benchmark()
    cell = registry.cell(args.workload)
    build = set_caches()
    import torch

    chips = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"cellbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    try:
        import mpi_model_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"cellbench: the program cannot be imported: {e}",
              file=sys.stderr)
        return 4
    from cellbench import harness
    from cellbench.work import peak

    kind = torch.cuda.get_device_name(0)
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"peaks ({kind}): {peak(kind)}", file=sys.stderr)

    ctx = harness.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda",
                          control=args.control, build_dir=build)
    setup_s = age + (ctx.window_t0 - t_entry)

    metrics = {}
    if not args.trace:
        for m in cell_metrics(bench, "end_to_end", args.workload):
            v = setup_s if m["name"] == "setup_s" else ctx.e2e.get(m["name"])
            if not finite(v):
                print(f"cellbench: no reading of {m['name']}: {v!r}",
                      file=sys.stderr)
                return 6
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, "per_layer", args.workload):
            v = registry.metric(m["name"]).read(ctx.record)
            if finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            else:
                print(f"cellbench: {m['name']} read nothing", file=sys.stderr)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": ctx.checks.ok, "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": metrics, "device": device}
    tl = ctx.timeline
    if args.trace and tl is not None:
        device["busy_s"] = tl.busy_s
        device["window_s"] = tl.window_s
        result["breakdown"] = {
            "device_ops": tl.top_ops(10),
            "idle_gaps": tl.top_gaps(ctx.record.get("timeline_spans", []),
                                     10)}
    result["checks"] = ctx.checks.table()
    # last before the result: the readers ran above, and what they loaded
    # counts too
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 5
    print(f"setup_s {setup_s!r}; notes {json.dumps(ctx.notes)}",
          file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    ctx.checks.print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
