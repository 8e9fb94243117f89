"""Local file cache for scan inputs (the reference's filecache:
spark.rapids.filecache.enabled, GpuFileCache — caching remote-store
reads on local disk so repeated scans skip the slow fetch).

Keyed by (absolute path, mtime, size): a changed source file misses and
re-caches. Copies are atomic (tmp + rename), eviction is LRU by access
time down to `filecache.maxBytes`. Off by default — on a single host
with local inputs the copy is pure overhead; enable it when inputs
live on network mounts."""
from __future__ import annotations

import hashlib
import os
import shutil
import threading

__all__ = ["FileCache", "file_cache", "cached_local_path"]


class FileCache:
    def __init__(self, cache_dir: str, max_bytes: int):
        self.dir = cache_dir
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self.metrics = {"hits": 0, "misses": 0, "evictions": 0}
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, path: str) -> str:
        st = os.stat(path)
        h = hashlib.sha1(
            f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}"
            .encode()).hexdigest()
        ext = os.path.splitext(path)[1]
        return f"{h}{ext}"

    def local_path(self, path: str) -> str:
        """Cached local copy of `path` (fetching on miss). The fetch
        runs OUTSIDE the lock (a multi-GB network copy must not stall
        hit-path threads); concurrent misses on one file each copy to a
        pid/thread-unique tmp and the atomic rename races benignly —
        same content, one inode wins."""
        dst = os.path.join(self.dir, self._key(path))
        with self._lock:
            if os.path.exists(dst):
                os.utime(dst)               # LRU touch
                self.metrics["hits"] += 1
                return dst
            self.metrics["misses"] += 1
        tmp = f"{dst}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            shutil.copyfile(path, tmp)
            os.replace(tmp, dst)            # atomic publish
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with self._lock:
            self._evict_locked()
        return dst

    def _evict_locked(self):
        entries = []
        total = 0
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                continue
            p = os.path.join(self.dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_atime, st.st_size, p))
            total += st.st_size
        entries.sort()                      # oldest access first
        for _, size, p in entries:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(p)
                total -= size
                self.metrics["evictions"] += 1
            except OSError:
                pass


_CACHE = None
_CACHE_LOCK = threading.Lock()


def file_cache(conf) -> FileCache:
    from ..config import FILECACHE_DIR, FILECACHE_MAX_BYTES
    global _CACHE
    with _CACHE_LOCK:
        d = conf.get(FILECACHE_DIR)
        if _CACHE is None or _CACHE.dir != d:
            _CACHE = FileCache(d, conf.get(FILECACHE_MAX_BYTES))
        return _CACHE


def cached_local_path(path: str, conf) -> str:
    """The scan-side hook: identity when the cache is off."""
    from ..config import FILECACHE_ENABLED
    if not conf.get(FILECACHE_ENABLED):
        return path
    try:
        return file_cache(conf).local_path(path)
    except OSError:
        return path                          # cache failure -> direct
