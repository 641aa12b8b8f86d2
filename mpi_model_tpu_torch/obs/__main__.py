"""``python -m mpi_model_tpu_torch.obs``: the operator command line over the
telemetry plane (counterpart of ``mpi_model_tpu/obs/__main__.py``).

- ``validate <snapshot.json>``: the schema gate (exit 1 naming the field);
- ``prom <snapshot.json>``: the snapshot's stats as Prometheus text;
- ``timeline <ticket> --journal DIR [--vault DIR] [--trace FILE]``: one
  ticket's lifecycle from the journals and a span file (a Chrome trace or a
  JSONL stream); ``--json`` prints the timeline document, otherwise an
  ordered listing. Exit 1 when the timeline is incomplete (no submit, or no
  or a duplicate terminal);
- ``--serve PORT --snapshot FILE``: the live scrape endpoint over a
  snapshot file that a soak keeps rewriting (``run_soak(snapshot_path=)``),
  re-read per request; blocks until interrupted.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import Optional

from . import prometheus_text, serve_status, validate_snapshot
from .postmortem import reconstruct


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpi_model_tpu_torch.obs",
        description="Telemetry-plane CLI: snapshot validation, Prometheus "
                    "exposition, per-ticket timeline reconstruction, live "
                    "scrape serving.")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the live scrape endpoint on PORT (requires "
                        "--snapshot; no subcommand)")
    p.add_argument("--snapshot", default=None, metavar="FILE",
                   help="snapshot file to serve (re-read per request)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --serve (default loopback)")
    sub = p.add_subparsers(dest="cmd", required=False)
    v = sub.add_parser("validate", help="schema-gate a snapshot file")
    v.add_argument("snapshot")
    pr = sub.add_parser("prom", help="Prometheus text exposition of a "
                                     "snapshot's stats")
    pr.add_argument("snapshot")
    t = sub.add_parser("timeline", help="reconstruct one ticket's "
                                        "lifecycle")
    t.add_argument("ticket", type=int)
    t.add_argument("--journal", required=True,
                   help="fleet journal directory")
    t.add_argument("--vault", default=None,
                   help="tiering vault directory (hibernation journal)")
    t.add_argument("--trace", default=None,
                   help="exported span file: a Chrome trace "
                        "(export_chrome) or a streaming .jsonl sink "
                        "(export_stream)")
    t.add_argument("--json", action="store_true")

    args = p.parse_args(argv)
    if args.serve is not None:
        if args.cmd is not None:
            p.error("--serve takes no subcommand")
        if args.snapshot is None:
            p.error("--serve needs --snapshot FILE (the document a soak "
                    "keeps rewriting via run_soak snapshot_path=)")
        snap_path = args.snapshot

        def _read_snapshot() -> dict:
            with open(snap_path) as fh:
                return json.load(fh)

        server = serve_status(args.serve, _read_snapshot, host=args.host)
        host, port = server.server_address[:2]
        print(f"serving {snap_path} on http://{host}:{port} (/metrics for "
              "Prometheus, / for the snapshot JSON); Ctrl-C to stop",
              file=sys.stderr)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()
        return 0
    if args.cmd is None:
        p.error("a subcommand (validate/prom/timeline) or --serve is "
                "required")
    if args.cmd == "timeline":
        return _timeline(args)
    with open(args.snapshot) as fh:
        doc = json.load(fh)
    if args.cmd == "validate":
        try:
            validate_snapshot(doc)
        except ValueError as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        print(f"ok: {args.snapshot} validates against {doc['schema']}")
        return 0
    sys.stdout.write(prometheus_text(doc.get("stats", {})))
    return 0


def _timeline(args) -> int:
    tl = reconstruct(args.ticket, journal_dir=args.journal,
                     vault_dir=args.vault, spans=args.trace)
    if args.json:
        print(json.dumps(tl.to_dict(), sort_keys=True))
    else:
        for e in tl.events:
            ts = " " * 14 if e.t_wall is None else f"{e.t_wall:14.3f}"
            sid = "" if e.service_id is None else f" [{e.service_id}]"
            print(f"{ts} {e.source:<14} {e.kind:<18}{sid} {e.detail}")
        print(f"-- ticket {tl.ticket}: "
              + ("COMPLETE" if tl.complete else "INCOMPLETE")
              + (f", {len(tl.gaps)} explicit gap/uncertainty record(s)"
                 if tl.gaps else ", gap-free"))
    return 0 if tl.complete else 1


if __name__ == "__main__":
    raise SystemExit(main())
