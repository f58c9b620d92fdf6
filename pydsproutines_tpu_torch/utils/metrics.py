"""Structured metrics / progress sink for long-running pipelines.

The reference's observability is print()/tqdm/plots (SURVEY.md §5); a
multi-host elastic pipeline needs something queryable instead. This module is
the consuming surface the round-2 review found missing: per-block timings and
quality metrics go to an append-only JSONL sink (one file per process — no
cross-process locking), and supervisors read them back with ``read_metrics``
/ ``summarize`` or poll live cluster state with
``parallel.multihost.cluster_progress``.

Design notes
  * JSON-lines, append-only, flushed per record: a dying process loses at
    most one torn line (tolerated by the reader), and any host tool
    (jq/pandas) can consume the files directly.
  * Records are {"ts", "proc", "name", "value", "unit", ...tags}. Names are
    dotted paths ("xcorr.block_seconds"); tags are flat JSON scalars.
  * ``MetricsSink.timer`` wraps a block in a wall-clock measurement; callers
    with work on the card must wait for it inside the timed region (the
    pipeline runner does: it copies each block's results to numpy before
    the insert).

A copy of the JAX package's ``pydsproutines_tpu/utils/metrics.py``, which is
numpy only: the port keeps its own because importing any module of that
package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path


class MetricsSink:
    """Append-only JSONL metrics writer (one file per process)."""

    def __init__(self, path, process_id: int = 0):
        self.path = Path(path)
        self.process_id = int(process_id)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    def emit(self, name: str, value, unit: str | None = None, **tags):
        rec = {"ts": time.time(), "proc": self.process_id, "name": str(name),
               "value": value}
        if unit is not None:
            rec["unit"] = unit
        rec.update(tags)
        self._fh.write(json.dumps(rec) + "\n")

    class _Timer:
        def __init__(self, sink, name, tags):
            self.sink, self.name, self.tags = sink, name, tags

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, *exc):
            dt = time.perf_counter() - self.t0
            self.sink.emit(self.name, dt, unit="s",
                           ok=exc_type is None, **self.tags)
            return False

    def timer(self, name: str, **tags) -> "_Timer":
        """Context manager: emits the block's wall-clock seconds on exit
        (with ok=False if the block raised)."""
        return self._Timer(self, name, tags)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_metrics(path):
    """Read one JSONL file, or every ``*.jsonl`` under a directory, into a
    list of dicts (time-ordered). Torn trailing lines are skipped."""
    p = Path(path)
    files = sorted(p.glob("*.jsonl")) if p.is_dir() else [p]
    out = []
    for f in files:
        if not f.exists():
            continue
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn write from a dying process
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = q * (len(sorted_vals) - 1)
    lo = math.floor(idx)
    hi = math.ceil(idx)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def summarize(records):
    """Aggregate numeric records per name: count/total/mean/min/max/p50/p95
    and the latest value. Non-numeric values only track count + last."""
    by_name: dict[str, list] = {}
    last: dict[str, object] = {}
    counts: dict[str, int] = {}
    for r in records:
        name = r.get("name")
        if name is None:
            continue
        counts[name] = counts.get(name, 0) + 1
        last[name] = r.get("value")
        v = r.get("value")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            by_name.setdefault(name, []).append(float(v))
    out = {}
    for name, cnt in counts.items():
        entry = {"count": cnt, "last": last[name]}
        vals = sorted(by_name.get(name, []))
        if vals:
            entry.update(
                total=sum(vals), mean=sum(vals) / len(vals),
                min=vals[0], max=vals[-1],
                p50=_quantile(vals, 0.5), p95=_quantile(vals, 0.95))
        out[name] = entry
    return out


def tail_progress(path, name_prefix: str = ""):
    """Latest record per name (optionally filtered by prefix) — the cheap
    'where is the job now' query for a supervisor or the web viewer."""
    latest = {}
    for r in read_metrics(path):
        n = r.get("name", "")
        if n.startswith(name_prefix):
            latest[n] = r
    return latest
