"""Scan snapshot pinning: capture (path, mtime_ns, size) per data file
at scan BIND time and verify it at execute time, so an overwrite
mid-session can never serve stale bytes: the scan either refreshes (the
next action plans against the new files) or raises before mixing old
and new data. Delta scans additionally pin the table version. The
JAX package's `io/snapshot.py`, copied; the port plans every action
afresh, so between actions the refresh only updates the scans'
snapshots (the JAX result cache's invalidation waits for ROADMAP A.15).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

__all__ = ["scan_snapshot", "snapshot_current", "refresh_plan_snapshots",
           "verify_snapshot", "SnapshotMismatch"]

# one snapshot element per file; (path, None, None) marks a file that
# could not be statted (deleted mid-session) — never equal to a live stat
SnapshotT = Tuple[Tuple[str, Optional[int], Optional[int]], ...]


class SnapshotMismatch(RuntimeError):
    """A scan's pinned file set changed UNDER a running execution (the
    plan-time refresh in DataFrame.physical_plan handles changes between
    actions; this fires only when files mutate mid-query)."""


def scan_snapshot(paths: Sequence[str]) -> SnapshotT:
    """Stat every file once; deterministic order (the caller's)."""
    out = []
    for p in paths:
        try:
            st = os.stat(p)
            out.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            out.append((p, None, None))
    return tuple(out)


def refresh_plan_snapshots(plan) -> list:
    """Re-stat every file-pinning scan in a logical tree, updating the
    scans' snapshots in place. Returns the list of paths whose files
    changed (empty = everything current). Runs before every action
    (`DataFrame.physical_plan`), so the fresh physical plan pins the
    files as they are now."""
    changed = []
    stack = [plan]
    seen = set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        snap = getattr(n, "snapshot", None)
        if snap is not None and getattr(n, "paths", None) is not None:
            cur = scan_snapshot(n.paths)
            if cur != snap:
                n.snapshot = cur
                changed.extend(n.paths)
        stack.extend(getattr(n, "children", ()) or ())
    return changed


def verify_snapshot(scan, ctx, kind: str):
    """Raise SnapshotMismatch (and count `scanSnapshotViolations` on the
    scan) when a file that `scan` pinned changed since it was planned."""
    if scan.snapshot is None or snapshot_current(scan.snapshot):
        return
    ctx.add_metric(scan._op_id, "scanSnapshotViolations", 1)
    paths = scan.paths
    raise SnapshotMismatch(
        f"{kind} files changed under a running scan: {paths[:3]}"
        f"{'...' if len(paths) > 3 else ''} (bind-time snapshot no longer "
        f"matches; re-run the action to rebind)")


def snapshot_current(snapshot: SnapshotT) -> bool:
    """True when every pinned file still has its bind-time mtime+size."""
    for p, mtime_ns, size in snapshot:
        try:
            st = os.stat(p)
        except OSError:
            return False
        if st.st_mtime_ns != mtime_ns or st.st_size != size:
            return False
    return True
