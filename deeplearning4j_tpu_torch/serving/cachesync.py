"""Compile-cache distribution: serve and fetch `persist.py` entries.

The persistent program store (optimize/persist.py) already gives every
entry a self-validating container — magic, JSON header, sha256 of the
blob — so the export format doubles as a wire format: a cold host can
download a warm host's entry and trust the same checksum re-validation
it would apply to its own disk.  This module is the transport half of
that contract, model-free on purpose (like router.py and agent.py it
never imports jax):

  serving    `read_entry(directory, name)` returns one entry's raw bytes
             by filename (the filename IS the key hash, so no key
             parsing happens server-side), `list_entries` enumerates
             them, and `CacheServer` is a tiny standalone HTTP server
             exposing both under `GET /a/cache/...` — the same paths a
             `ReplicaAgent` serves for its own cache directory, so a
             fetcher cannot tell a dedicated cache server from an agent.
  fetching   `CacheFetcher` is the client the cold host's store calls on
             a local miss (see `PersistentProgramStore.set_remote`): it
             tries each configured source in order with an explicit
             per-request timeout, and every attempt past the first
             draws from a `RetryBudget` — a dead cache peer degrades
             cold starts to plain compiles instead of amplifying into a
             fetch storm.  VALIDATION DOES NOT HAPPEN HERE: the store
             re-validates magic/header/checksum on arrival, and a
             corrupt fetch is a counted miss, never a crash.

Fault-injection: every fetched payload traverses the
``agent.cache_fetch`` point (reliability/faults.py); an armed `corrupt`
plan flips bytes in flight, which is how the chaos tests prove the
checksum re-validation downgrades a bad fetch to a miss.

The port's own copy of `deeplearning4j_tpu/serving/cachesync.py`, over the
port's store entries (`.ptp` files): the int8 artifact, the prefix entries
and the tuned tables.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.error import HTTPError
from urllib.parse import urlparse
from urllib.request import urlopen

from deeplearning4j_tpu_torch.reliability import RetryBudget, faults

#: entry filenames are hex hashes + the persist suffix — anything else
#: (traversal attempts, tmpfiles mid-write) is refused server-side
ENTRY_NAME_RE = re.compile(r"^[0-9a-f]{8,64}\.ptp$")

#: URL prefix both the agent and the standalone server expose
CACHE_PATH_PREFIX = "/a/cache/"


def valid_entry_name(name: str) -> bool:
    return bool(ENTRY_NAME_RE.match(name))


def list_entries(directory: str) -> List[str]:
    """Entry filenames currently in `directory` (empty on any problem —
    an unreadable cache dir means nothing to distribute, not a crash)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(n for n in names if valid_entry_name(n))


def read_entry(directory: str, name: str) -> Optional[bytes]:
    """Raw container bytes for one entry, or None (bad name, vanished
    file — a sibling's eviction between listdir and open is routine)."""
    if not valid_entry_name(name):
        return None
    try:
        with open(os.path.join(directory, name), "rb") as f:
            return f.read()
    except OSError:
        return None


def handle_cache_get(directory: Optional[str], path: str):
    """Shared GET dispatch for `/a/cache/...` paths: returns
    (status, content_type, body) or None when `path` is not a cache
    path.  Used by both `CacheServer` and the `ReplicaAgent` handler."""
    if path == CACHE_PATH_PREFIX.rstrip("/"):
        names = list_entries(directory) if directory else []
        return 200, "application/json", json.dumps(
            {"entries": names}).encode()
    if not path.startswith(CACHE_PATH_PREFIX):
        return None
    name = path[len(CACHE_PATH_PREFIX):]
    data = read_entry(directory, name) if directory else None
    if data is None:
        return 404, "application/json", json.dumps(
            {"error": f"no cache entry {name!r}"}).encode()
    return 200, "application/octet-stream", data


class _CacheHandler(BaseHTTPRequestHandler):
    server_ref: "CacheServer" = None

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        out = handle_cache_get(self.server_ref.directory, path)
        if out is None:
            out = 404, "application/json", b'{"error": "not found"}'
        code, ctype, body = out
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


class CacheServer:
    """Standalone compile-cache distribution endpoint: serves one
    directory's entries under `GET /a/cache/{name}`.  The CLI runs one
    on the router host when `serve --agent` is used, so a respawned
    replica on a cold host warms from the control plane's warmed cache
    even when every peer agent is also cold (or dead)."""

    def __init__(self, directory: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        handler = type("Handler", (_CacheHandler,), {"server_ref": self})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.server.server_address[0]}:{self.port}"

    def start(self) -> "CacheServer":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True,
                                        name="dl4j-cachesync")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class CacheFetcher:
    """Remote-entry fetch callable for `PersistentProgramStore.set_remote`.

    sources:   base URLs (a `ReplicaAgent` or a `CacheServer` — both
               serve `/a/cache/{name}`), tried in order per entry.
    timeout_s: explicit per-request timeout (every network call in
               serving/ carries one; the repo linter enforces it).
    budget:    `RetryBudget` shared by attempts past the first source —
               with every peer down, fetches degrade to one attempt per
               entry instead of hammering the whole source list.
    """

    def __init__(self, sources: List[str], timeout_s: float = 5.0,
                 budget: Optional[RetryBudget] = None,
                 clock=time.monotonic):
        self.sources = [s.rstrip("/") for s in sources]
        self.timeout_s = float(timeout_s)
        self.budget = budget if budget is not None else RetryBudget(
            clock=clock)
        self._lock = threading.Lock()
        self._requests = 0
        self._fetched = 0
        self._errors = 0

    def __call__(self, name: str) -> Optional[bytes]:
        """Container bytes for `name` from the first source that has
        it, or None.  Never raises; never validates (the store does)."""
        if not valid_entry_name(name):
            return None
        self.budget.note_request()
        with self._lock:
            self._requests += 1
        for i, base in enumerate(self.sources):
            if i > 0 and not self.budget.try_spend():
                break  # budget-gated: no storm across a dead source list
            try:
                with urlopen(base + CACHE_PATH_PREFIX + name,
                             timeout=self.timeout_s) as r:
                    data = r.read()
                # armed 'corrupt' plans flip bytes here — the store's
                # checksum re-validation must turn that into a counted
                # miss, never a crash
                data = faults.fire("agent.cache_fetch", data=data,
                                   name=name, source=base)
            except HTTPError:
                continue  # 404: this peer doesn't have it; try the next
            except Exception:  # noqa: BLE001 — unreachable peer or an
                # armed raise: a miss on this source, never a crash
                with self._lock:
                    self._errors += 1
                continue
            with self._lock:
                self._fetched += 1
            return data
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"sources": list(self.sources),
                    "requests": self._requests,
                    "fetched": self._fetched,
                    "errors": self._errors}


__all__ = ["CacheFetcher", "CacheServer", "handle_cache_get",
           "list_entries", "read_entry", "valid_entry_name"]
