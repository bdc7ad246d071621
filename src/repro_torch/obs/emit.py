"""Structured event emitter — the training loop's logging plumbing (a copy
of ``repro.obs.emit``).

Deterministic ``[kind] key=value`` lines so step-time regressions are
greppable in training logs, with an injectable sink (tests pass
``sink=lambda s: None`` or a capture list), optionally mirrored to an
append-only JSONL file.
"""
from __future__ import annotations

import json

__all__ = ["Emitter"]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, (list, tuple)):
        return "/".join(_fmt(x) for x in v)
    return str(v)


class Emitter:
    """Emit structured events as human lines + optional JSONL records."""

    def __init__(self, sink=print, jsonl_path: str | None = None):
        self.sink = sink
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def emit(self, kind: str, **fields) -> str:
        """One event: ``[kind] k1=v1 k2=v2 ...`` (field order preserved)."""
        line = " ".join([f"[{kind}]"] + [f"{k}={_fmt(v)}" for k, v in fields.items()])
        if self.sink is not None:
            self.sink(line)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(dict(event=kind, **fields)) + "\n")
            self._jsonl.flush()
        return line

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
