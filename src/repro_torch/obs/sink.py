"""Structured JSONL run-log: one event per line, schema-versioned,
sim-clock-only timestamps.

Every line is ``{"schema": 1, "kind": ..., "t": <seconds>, ...}`` with
sorted keys.  The invariant that makes run-logs diffable across machines
and regression-testable in CI: ``t`` always comes from the *producing
clock* — the replay harness's accumulated wall, the serving simulator's
event-heap time, the trainer's injected (and in tests synthetic) clock —
never from ``time.time()``.  Identical runs write byte-identical logs.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, TextIO, Union

SINK_SCHEMA = 1


class RunLog:
    """Append-only JSONL writer (context manager).  Pass a path or an open
    text file object (the latter is not closed on exit)."""

    def __init__(self, target: Union[str, TextIO]):
        if isinstance(target, str):
            self._f: TextIO = open(target, "w")
            self._owned = True
        else:
            self._f = target
            self._owned = False
        self.n_events = 0

    def emit(self, kind: str, t: float, **fields: Any) -> Dict[str, Any]:
        ev = {"schema": SINK_SCHEMA, "kind": str(kind), "t": float(t)}
        ev.update(fields)
        self._f.write(json.dumps(ev, sort_keys=True) + "\n")
        self.n_events += 1
        return ev

    def close(self) -> None:
        if self._owned and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None


def read_runlog(path: str) -> List[Dict[str, Any]]:
    """Load a run-log back; raises ValueError on an event from an unknown
    (newer) schema."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if ev.get("schema", 0) > SINK_SCHEMA:
                raise ValueError(
                    f"run-log event schema {ev.get('schema')} is newer than "
                    f"supported {SINK_SCHEMA}")
            out.append(ev)
    return out


def iter_kind(events: List[Dict[str, Any]], kind: str
              ) -> Iterator[Dict[str, Any]]:
    return (e for e in events if e.get("kind") == kind)
