"""Device profiling helpers (SURVEY.md section 5: the reference's tracing
channel is an atomic ray counter + window-title Mrays/s; ours is the ray
counters in render stats plus real device traces).

`trace()` wraps jax.profiler and `op_summary()` parses the captured trace
into per-op device times.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "mrt_trace")):
    """Capture a device trace around a block:

        with profiling.trace() as t:
            frame, _ = render_wavefront(...)
        print(profiling.format_summary(t.summary()))
    """
    import jax

    class Handle:
        def summary(self, top=25):
            return op_summary(log_dir, top=top)

    h = Handle()
    with jax.profiler.trace(log_dir):
        yield h


def _latest_trace_file(log_dir: str):
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins/profile/*/*.trace.json.gz")))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    return paths[-1]


def op_summary(log_dir: str, top: int = 25):
    """Aggregate device-op durations from the newest trace in log_dir.

    Returns a list of {name, total_ms, count, avg_us} sorted by total time.
    """
    with gzip.open(_latest_trace_file(log_dir)) as f:
        tr = json.load(f)
    # device pids are announced via process_name metadata
    dev_pids = {
        e["pid"]
        for e in tr["traceEvents"]
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and "device:" in str(e.get("args", {}).get("name", "")).lower()
    }
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in tr["traceEvents"]:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            dur[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
    out = []
    for name, d in dur.most_common(top):
        out.append({
            "name": name,
            "total_ms": round(d / 1e3, 3),
            "count": cnt[name],
            "avg_us": round(d / max(cnt[name], 1), 1),
        })
    return out


def format_summary(rows) -> str:
    lines = [f"{'total ms':>10}  {'n':>6}  {'avg us':>9}  op"]
    for r in rows:
        lines.append(
            f"{r['total_ms']:10.2f}  {r['count']:6d}  {r['avg_us']:9.1f}  {r['name'][:70]}"
        )
    return "\n".join(lines)
