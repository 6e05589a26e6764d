"""Chrome/Perfetto ``trace_event`` JSON export of the tracer's buffers.

The output is the JSON-array-of-events object format documented by the
Chrome tracing team and consumed verbatim by both ``chrome://tracing``
and https://ui.perfetto.dev — ``{"traceEvents": [...]}`` with one dict
per event.  Phases used: ``X`` (complete span), ``i`` (instant),
``s``/``t``/``f`` (flow start/step/end), ``M`` (thread/process names).
Timestamps are microseconds relative to the tracer's epoch.

``validate_chrome_trace`` is the schema check the tests (and the
``--trace-out`` benchmark writers) run against every emitted file, so a
malformed trace fails in CI rather than silently refusing to load in the
viewer.
"""
from __future__ import annotations

import json
import os

from repro_torch.obs import trace as _trace

_KNOWN_PHASES = {"X", "i", "s", "t", "f", "M"}


def export_chrome_trace(tracer: "_trace.Tracer | None" = None) -> dict:
    """Render every thread buffer into one Chrome trace dict."""
    tracer = tracer or _trace.TRACER
    epoch = tracer.epoch_ns
    pid = os.getpid()
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": "repro-serving"},
    }]
    for buf in tracer.buffers():
        tid = int(buf.tid or 0)
        meta_args = {"name": buf.thread_name}
        if buf.dropped:
            meta_args["dropped_events"] = buf.dropped
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": meta_args})
        for ph, name, cat, ts_ns, dur_ns, args, flow_id in list(buf.events):
            ev = {
                "ph": ph, "name": name, "cat": cat,
                "ts": (ts_ns - epoch) / 1000.0,
                "pid": pid, "tid": tid,
            }
            if ph == "X":
                ev["dur"] = dur_ns / 1000.0
            if flow_id is not None:
                ev["id"] = flow_id
                if ph == "f":
                    ev["bp"] = "e"      # bind to the enclosing slice
            if args:
                ev["args"] = args
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       tracer: "_trace.Tracer | None" = None) -> dict:
    """Export, schema-check, and write the trace JSON; returns the dict."""
    doc = export_chrome_trace(tracer)
    validate_chrome_trace(doc)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc) -> None:
    """Raise ``ValueError`` unless ``doc`` is loadable Chrome trace JSON.

    Accepts the object form (``{"traceEvents": [...]}``) this module
    writes; checks per-event invariants the viewers rely on.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be a dict with a 'traceEvents' key")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not a dict")
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            raise ValueError(f"event {i}: pid/tid must be ints")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event {i}: missing ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X event needs dur >= 0")
        if ph in ("s", "t", "f") and not isinstance(
                ev.get("id"), (int, str)):
            raise ValueError(f"event {i}: flow event needs an id")
        args = ev.get("args")
        if args is not None:
            if not isinstance(args, dict):
                raise ValueError(f"event {i}: args must be a dict")
            try:
                json.dumps(args)
            except TypeError as e:
                raise ValueError(
                    f"event {i}: args not JSON-serializable: {e}") from e
