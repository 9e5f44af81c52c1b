"""Trace exporters: Chrome trace-event JSON (Perfetto) and CSV.

Converts the native ``repro-trace-v1`` documents written by
:class:`repro_torch.obs.Recorder` (DESIGN.md §11) into

* **Chrome trace-event JSON** — load the file at https://ui.perfetto.dev
  (or chrome://tracing). Each distinct ``proc`` label becomes a Perfetto
  process (one per subsystem, or one per benchmark strategy leg), each
  ``track`` a thread inside it, and every metrics registry time series
  (per-level link utilisation, queue depth) becomes a counter track.
  Timestamps are simulation seconds scaled to microseconds.
* **CSV** — long-format ``namespace,series,time,index,value`` rows of
  the metrics time series (default: the ``util.`` series — per-level
  link utilisation over sim time).

Also the home of the structural trace validators the CI gate runs
(``benchmarks/check_regression.py --trace``): hand-rolled JSON-schema
checks (no jsonschema dependency) over both formats.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.export TRACE_sched.json \
        --format perfetto --out trace.perfetto.json
    PYTHONPATH=src python -m repro_torch.obs.export TRACE_sched.json \
        --format csv --series util.level
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from typing import Optional

from .recorder import COUNTER, FORMAT, INSTANT, SPAN

_S_TO_US = 1e6
_PHASES = (INSTANT, SPAN, COUNTER)


# ---------------------------------------------------------------------------
# Chrome trace-event JSON
# ---------------------------------------------------------------------------
def to_chrome(doc: dict, include_wall: bool = False) -> dict:
    """Native document -> Chrome trace-event JSON object (Perfetto).

    Deterministic: pids/tids are assigned in sorted label order and the
    native event order is preserved. With ``include_wall`` every event
    that recorded a wall duration gains ``args.wall_s``.
    """
    events = doc.get("events", [])
    procs = sorted({e.get("proc", "main") for e in events})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    tracks = sorted({(e.get("proc", "main"), e.get("track") or e["cat"])
                     for e in events})
    tid_of = {}
    for proc, track in tracks:
        tid_of[(proc, track)] = sum(1 for p, _ in tid_of if p == proc) + 1

    out: list[dict] = []
    for proc in procs:
        out.append({"name": "process_name", "ph": "M", "pid": pid_of[proc],
                    "tid": 0, "args": {"name": proc}})
    for proc, track in tracks:
        out.append({"name": "thread_name", "ph": "M", "pid": pid_of[proc],
                    "tid": tid_of[(proc, track)], "args": {"name": track}})

    for e in events:
        proc = e.get("proc", "main")
        track = e.get("track") or e["cat"]
        args = dict(e.get("args") or {})
        if include_wall and "wall" in e:
            args["wall_s"] = e["wall"]
        ce = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
              "ts": e["ts"] * _S_TO_US, "pid": pid_of[proc],
              "tid": tid_of[(proc, track)], "args": args}
        if e["ph"] == SPAN:
            ce["dur"] = e.get("dur", 0.0) * _S_TO_US
        elif e["ph"] == INSTANT:
            ce["s"] = "t"      # thread-scoped instant
        out.append(ce)

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"format": doc.get("format", FORMAT),
                      "clock": doc.get("clock", "sim-seconds")},
    }


# ---------------------------------------------------------------------------
# CSV export
# ---------------------------------------------------------------------------
def to_csv(doc: dict, series_prefix: str = "util.") -> str:
    """Long-format CSV of the counter events whose name matches
    ``series_prefix`` — by default the per-level utilisation tracks
    (``util.level.<name>``) the scheduler emits at every mutation."""
    buf = io.StringIO()
    buf.write("proc,series,time_s,key,value\n")
    for e in doc.get("events", []):
        if e["ph"] != COUNTER or not e["name"].startswith(series_prefix):
            continue
        proc = e.get("proc", "main")
        for key in sorted(e.get("args") or {}):
            buf.write(f"{proc},{e['name']},{e['ts']!r},{key},"
                      f"{(e['args'][key])!r}\n")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Validation (the CI trace-schema gate)
# ---------------------------------------------------------------------------
def validate_native(doc: dict) -> list[str]:
    """Structural schema check of a ``repro-trace-v1`` document.

    Returns a list of problems (empty == valid). Checks the envelope,
    every event's required keys/types/phase, and that timestamps and
    durations are finite and non-negative.
    """
    probs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("format") != FORMAT:
        probs.append(f"format is {doc.get('format')!r}, expected {FORMAT!r}")
    if doc.get("clock") != "sim-seconds":
        probs.append(f"clock is {doc.get('clock')!r}, expected 'sim-seconds'")
    events = doc.get("events")
    if not isinstance(events, list):
        return probs + ["events is not a list"]
    if not isinstance(doc.get("metrics"), dict):
        probs.append("metrics is not an object")
    for i, e in enumerate(events):
        where = f"events[{i}]"
        if not isinstance(e, dict):
            probs.append(f"{where}: not an object")
            continue
        for key, typ in (("name", str), ("cat", str), ("ph", str),
                         ("proc", str), ("track", str)):
            if not isinstance(e.get(key), typ):
                probs.append(f"{where}: missing/invalid {key!r}")
        if e.get("ph") not in _PHASES:
            probs.append(f"{where}: unknown phase {e.get('ph')!r}")
        for key in ("ts", "dur"):
            v = e.get(key)
            if not isinstance(v, (int, float)) or v != v or v < 0:
                probs.append(f"{where}: {key!r} not a finite number >= 0")
        if not isinstance(e.get("args", {}), dict):
            probs.append(f"{where}: args not an object")
        if len(probs) > 20:
            probs.append("... (truncated)")
            break
    return probs


def validate_chrome(doc: dict) -> list[str]:
    """Structural schema check of an exported Chrome trace JSON."""
    probs: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["missing traceEvents list"]
    for i, e in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            probs.append(f"{where}: not an object")
            continue
        if not isinstance(e.get("name"), str):
            probs.append(f"{where}: missing name")
        if e.get("ph") not in ("M", "i", "X", "C"):
            probs.append(f"{where}: unknown phase {e.get('ph')!r}")
        if e.get("ph") != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts != ts or ts < 0:
                probs.append(f"{where}: ts not a finite number >= 0")
        if e.get("ph") == "X" and not isinstance(
                e.get("dur"), (int, float)):
            probs.append(f"{where}: X event without dur")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                probs.append(f"{where}: {key} not an int")
        if len(probs) > 20:
            probs.append("... (truncated)")
            break
    return probs


def validate_file(path: str) -> list[str]:
    """Validate a trace file of either format (auto-detected)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"cannot load {path}: {e}"]
    if isinstance(doc, dict) and "traceEvents" in doc:
        return validate_chrome(doc)
    probs = validate_native(doc)
    if not probs:
        # a native doc must survive export + the exported-side schema
        probs = [f"export: {p}" for p in validate_chrome(to_chrome(doc))]
    return probs


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="native repro-trace-v1 JSON file")
    ap.add_argument("--format", choices=("perfetto", "csv", "validate"),
                    default="perfetto",
                    help="perfetto: Chrome trace-event JSON; csv: metrics "
                         "time series; validate: schema check only")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--series", default="util.",
                    help="csv: counter-name prefix to export")
    ap.add_argument("--wall", action="store_true",
                    help="include wall-clock fields in the export")
    args = ap.parse_args(argv)

    try:
        with open(args.input) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"INVALID: cannot load {args.input}: {e}", file=sys.stderr)
        raise SystemExit(2)
    probs = validate_native(doc)
    if probs:
        for p in probs:
            print(f"INVALID: {p}", file=sys.stderr)
        raise SystemExit(2)
    if args.format == "validate":
        print(f"{args.input}: valid {FORMAT} "
              f"({len(doc.get('events', []))} events)", file=sys.stderr)
        return
    if args.format == "perfetto":
        text = json.dumps(to_chrome(doc, include_wall=args.wall),
                          indent=1, sort_keys=True)
    else:
        text = to_csv(doc, series_prefix=args.series)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)


if __name__ == "__main__":
    main()
