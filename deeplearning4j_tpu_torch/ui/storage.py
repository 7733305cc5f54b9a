"""StatsStorage — pluggable persistence for telemetry streams.

Mirrors the reference's api/storage/StatsStorage.java + StatsStorageRouter
(SURVEY.md §2.2/§2.10): reports are keyed (session_id, type_id, worker_id),
storages are queryable by the UI server and observable (listeners fire on
new sessions/updates). Implementations:

  InMemoryStatsStorage  — dict-backed (InMemoryStatsStorage.java)
  FileStatsStorage      — append-only JSONL file, reloadable across
                          processes (MapDBStatsStorage/J7FileStatsStorage's
                          role without the MapDB/SQLite dependency)
  RemoteUIStatsStorageRouter — HTTP POSTs reports to a remote UIServer's
                          /remote endpoint (RemoteUIStatsStorageRouter.java
                          → RemoteReceiverModule)
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

Key = Tuple[str, str, str]  # session, type, worker


class StatsStorageRouter:
    """Write side (StatsStorageRouter.java)."""

    def put_static_info(self, report: dict):
        raise NotImplementedError

    def put_update(self, report: dict):
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read side (StatsStorage.java)."""

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_type_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def list_worker_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def get_static_info(self, session_id: str) -> Optional[dict]:
        raise NotImplementedError

    def get_all_updates(self, session_id: str,
                        worker_id: Optional[str] = None) -> List[dict]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str) -> Optional[dict]:
        ups = self.get_all_updates(session_id)
        return ups[-1] if ups else None

    # observers (StatsStorageListener)
    def register_listener(self, fn: Callable[[str, dict], None]):
        self._listeners().append(fn)

    def _listeners(self) -> list:
        if not hasattr(self, "_ls"):
            self._ls = []
        return self._ls

    def _notify(self, event: str, report: dict):
        for fn in list(self._listeners()):
            fn(event, report)


class InMemoryStatsStorage(StatsStorage):
    def __init__(self):
        self._static: Dict[str, dict] = {}
        self._updates: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()

    def put_static_info(self, report: dict):
        sid = report["session_id"]
        with self._lock:
            new = sid not in self._static and sid not in self._updates
            self._static[sid] = report
        self._notify("new_session" if new else "static_info", report)

    def put_update(self, report: dict):
        sid = report["session_id"]
        with self._lock:
            new = sid not in self._static and sid not in self._updates
            self._updates.setdefault(sid, []).append(report)
        if new:
            self._notify("new_session", report)
        self._notify("update", report)

    def list_session_ids(self):
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def list_type_ids(self, session_id):
        with self._lock:
            return sorted({u.get("type_id", "?")
                           for u in self._updates.get(session_id, [])})

    def list_worker_ids(self, session_id):
        with self._lock:
            return sorted({u.get("worker_id", "0")
                           for u in self._updates.get(session_id, [])})

    def get_static_info(self, session_id):
        return self._static.get(session_id)

    def get_all_updates(self, session_id, worker_id=None):
        with self._lock:
            ups = list(self._updates.get(session_id, []))
        if worker_id is not None:
            ups = [u for u in ups if u.get("worker_id") == worker_id]
        return ups


class FileStatsStorage(InMemoryStatsStorage):
    """JSONL-backed storage: every report is one appended line; existing
    files are loaded on open, so dashboards survive process restarts."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._flock = threading.Lock()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        r = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write
                    if r.get("static"):
                        super().put_static_info(r)
                    else:
                        super().put_update(r)

    def _append(self, report: dict):
        with self._flock:
            with open(self.path, "a") as f:
                f.write(json.dumps(report) + "\n")

    def put_static_info(self, report: dict):
        self._append(report)
        super().put_static_info(report)

    def put_update(self, report: dict):
        self._append(report)
        super().put_update(report)


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """POSTs reports to a remote UIServer (api/storage/impl/
    RemoteUIStatsStorageRouter.java). Sending happens on a background
    daemon thread: puts enqueue and return immediately, so a slow or dead
    dashboard can never stall the training hot path. Reports the server
    rejects (4xx) are dropped; transport failures are retried with the
    queue bounded at max_buffer (oldest dropped first)."""

    def __init__(self, url: str, timeout: float = 2.0,
                 max_buffer: int = 1000, retry_interval: float = 5.0):
        import queue

        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout
        self.max_buffer = max_buffer
        self.retry_interval = retry_interval
        self._q: "queue.Queue[dict]" = queue.Queue()
        self._pending: List[dict] = []  # transport-failed, awaiting retry
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _post(self, report: dict) -> str:
        """-> 'sent' | 'rejected' (4xx: drop) | 'unreachable' (retry)."""
        import urllib.error
        import urllib.request

        data = json.dumps(report).encode()
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return "sent" if 200 <= resp.status < 300 else "rejected"
        except urllib.error.HTTPError as e:
            return "rejected" if 400 <= e.code < 500 else "unreachable"
        except Exception:
            return "unreachable"

    def _sender(self):
        while True:
            self._wake.wait(timeout=self.retry_interval)
            self._wake.clear()
            # drain new reports into the retry buffer (order-preserving)
            while True:
                try:
                    self._pending.append(self._q.get_nowait())
                except Exception:
                    break
            del self._pending[:-self.max_buffer]
            still: List[dict] = []
            for i, r in enumerate(self._pending):
                status = self._post(r)
                if status == "unreachable":
                    # server down: keep this and the rest for later
                    still.extend(self._pending[i:])
                    break
            self._pending = still

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._sender, daemon=True)
            self._thread.start()

    def _put(self, report: dict):
        self._ensure_thread()
        self._q.put(report)
        self._wake.set()

    def flush(self, timeout: float = 10.0):
        """Best-effort drain (tests / graceful shutdown)."""
        import time as _t

        deadline = _t.monotonic() + timeout
        self._wake.set()
        while _t.monotonic() < deadline:
            if self._q.empty() and not self._pending:
                return
            self._wake.set()
            _t.sleep(0.02)

    put_static_info = _put
    put_update = _put


class SqliteStatsStorage(StatsStorage):
    """SQLite-backed stats storage (the reference's J7FileStatsStorage /
    MapDBStatsStorage role — deeplearning4j-ui-model storage/sqlite):
    durable, queryable, safe for concurrent readers. Reports are stored as
    JSON rows keyed by (session, worker, timestamp, kind)."""

    def __init__(self, path: str):
        import sqlite3

        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS reports ("
                " session_id TEXT NOT NULL,"
                " worker_id TEXT,"
                " ts REAL,"
                " kind TEXT NOT NULL,"
                " payload TEXT NOT NULL)")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_reports"
                " ON reports(session_id, kind, ts)")
            self._conn.commit()

    def _insert(self, kind: str, report: dict):
        with self._lock:
            self._conn.execute(
                "INSERT INTO reports VALUES (?,?,?,?,?)",
                (str(report.get("session_id", "default")),
                 str(report.get("worker_id", "")),
                 float(report.get("timestamp", 0.0)),
                 kind, json.dumps(report)))
            self._conn.commit()

    def _seen(self, session_id: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM reports WHERE session_id=? LIMIT 1",
                (session_id,)).fetchone()
        return row is not None

    def put_static_info(self, report: dict):
        # same event vocabulary as the sibling backends: new_session on
        # first sight, then static_info / update
        new = not self._seen(str(report.get("session_id", "default")))
        self._insert("static", report)
        self._notify("new_session" if new else "static_info", report)

    def put_update(self, report: dict):
        new = not self._seen(str(report.get("session_id", "default")))
        self._insert("update", report)
        if new:
            self._notify("new_session", report)
        self._notify("update", report)

    def _rows(self, q, args=()):
        with self._lock:
            return [json.loads(r[0])
                    for r in self._conn.execute(q, args).fetchall()]

    def list_session_ids(self):
        with self._lock:
            return [r[0] for r in self._conn.execute(
                "SELECT DISTINCT session_id FROM reports")]

    def list_type_ids(self, session_id):
        return sorted({r.get("type_id", "") for r in self._rows(
            "SELECT payload FROM reports WHERE session_id=?",
            (session_id,))})

    def list_worker_ids(self, session_id):
        with self._lock:
            return [r[0] for r in self._conn.execute(
                "SELECT DISTINCT worker_id FROM reports WHERE session_id=?",
                (session_id,))]

    def get_static_info(self, session_id):
        rows = self._rows(
            "SELECT payload FROM reports WHERE session_id=? AND kind='static'"
            " ORDER BY ts DESC LIMIT 1", (session_id,))
        return rows[0] if rows else None

    def get_all_updates(self, session_id, worker_id=None):
        if worker_id is None:
            return self._rows(
                "SELECT payload FROM reports WHERE session_id=?"
                " AND kind='update' ORDER BY ts", (session_id,))
        return self._rows(
            "SELECT payload FROM reports WHERE session_id=? AND worker_id=?"
            " AND kind='update' ORDER BY ts", (session_id, str(worker_id)))

    def close(self):
        with self._lock:
            self._conn.close()
