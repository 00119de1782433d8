"""The persistent store: byte artifacts that outlive the process.

Counterpart of `deeplearning4j_tpu/optimize/persist.py`, with its file
semantics:

  entry         one file: a magic, a JSON header (format, platform facts and
                their fingerprint, the key, the payload kind, the sha256 of
                the blob) and the blob.
  key           any tuple of str / int / None (`canonical_key` is its repr),
                hashed with the platform fingerprint into the file name; a
                header whose platform or key differs is a plain miss.
  atomicity     a write goes to a temporary file in the directory and
                `os.replace`s into place, so a reader never sees a torn
                entry and concurrent writers of one key converge.
  corruption    an entry that fails its magic, header or checksum is
                evicted and counts as a miss (`corrupt_evicted`).
  size cap      an LRU under `max_bytes` (`DL4J_COMPILE_CACHE_MAX_BYTES`,
                default 1 GiB): a load touches the entry's mtime, a write
                evicts the least recently used entries until the directory
                fits.
  siblings      processes sharing a directory evict under one another: an
                entry that vanishes between listing and reading or removing
                is a counted miss (`vanished`), never an exception.

What it holds: byte payloads only (`store_bytes` / `load_bytes`). The JAX
package also stores its compiled programs (serialized StableHLO); a CUDA
graph cannot be written to disk, so the port's program caches keep their
graphs in memory and their disk counters stay 0 (ROADMAP.md queue C). The
payloads are the int8 weight artifact (`optimize/quantize.py`), the
continuous batcher's prefix entries (`serving/batcher.py`) and the tuned
tables (`optimize/tunables.py`). `platform_info` names the port's facts: the format, the backend
("cuda" or "cpu"), the device's name and compute capability, the device
count, and the torch and CUDA versions.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import tempfile
import time
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.reliability import faults

log = logging.getLogger("deeplearning4j_tpu_torch")

#: bump to invalidate every stored entry on a format change
FORMAT_VERSION = 1

_MAGIC = b"DL4JPTP1"
_SUFFIX = ".ptp"

#: the default directory cap; override per store or by the environment
DEFAULT_MAX_BYTES = int(os.environ.get("DL4J_COMPILE_CACHE_MAX_BYTES",
                                       str(1 << 30)))


def platform_info(device=None) -> dict:
    """The facts an entry is valid for. `device` (a torch device; None: the
    card where there is one, else the CPU) names the backend and, on CUDA,
    the card's name and compute capability."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    cuda = dev.type == "cuda"
    return {
        "format": FORMAT_VERSION,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "capability": (list(torch.cuda.get_device_capability(dev)) if cuda
                       else None),
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def platform_fingerprint(info: Optional[dict] = None) -> str:
    """sha1 of the canonical JSON of `platform_info`, truncated."""
    info = platform_info() if info is None else info
    blob = json.dumps(info, sort_keys=True).encode("utf-8")
    return hashlib.sha1(blob).hexdigest()[:16]


def canonical_key(key: Tuple) -> str:
    """The deterministic string of a key (nested tuples of str, int and
    None: their repr)."""
    return repr(key)


class PersistentProgramStore:
    """A versioned on-disk store of byte payloads. Loads and stores never
    raise on a bad entry: it is evicted and counted, and the caller
    recomputes. An unwritable directory raises at construction."""

    def __init__(self, directory: str, max_bytes: int = DEFAULT_MAX_BYTES,
                 device=None):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_bytes = int(max_bytes)
        os.makedirs(self.directory, exist_ok=True)
        self._platform = platform_info(device)
        self._fingerprint = platform_fingerprint(self._platform)
        self.writes = 0
        self.hits = 0            # loads that returned a blob
        self.evictions = 0
        self.corrupt_evicted = 0
        self.io_errors = 0       # OSErrors read as misses
        self.vanished = 0        # entries a sibling process removed first
        self.fetch_hits = 0      # entries served by the remote fallback
        self.fetch_corrupt = 0   # fetched bytes that failed validation
        self.fetch_misses = 0    # remote lookups no peer could serve
        self._io_warned = False
        # optional remote fallback: entry file name -> container bytes
        self._remote_fetch = None

    def set_remote(self, fetch_fn) -> None:
        """Ask `fetch_fn(filename)` for the container bytes of an entry that
        is not on disk, before the caller recomputes. Fetched bytes pass
        the same validation as disk reads; a bad fetch is a counted miss
        (`fetch_corrupt`). Fetches are served from memory, not written."""
        self._remote_fetch = fetch_fn

    @property
    def platform(self) -> dict:
        """The platform facts this store's entries are valid for (a
        copy)."""
        return dict(self._platform)

    def _note_io_error(self, op: str, path: str, exc: BaseException) -> None:
        """Count a disk failure read as a miss; warn once a store."""
        self.io_errors += 1
        if not self._io_warned:
            self._io_warned = True
            log.warning("compile-cache: disk %s failed (%s: %r); treating "
                        "it as a miss, and counting further I/O errors in "
                        "io_errors without logging", op, path, exc)

    # -- paths ------------------------------------------------------------
    def path_for(self, key: Tuple) -> str:
        name = hashlib.sha256(
            (self._fingerprint + "|" + canonical_key(key))
            .encode("utf-8")).hexdigest()[:40]
        return os.path.join(self.directory, name + _SUFFIX)

    # -- load -------------------------------------------------------------
    def _evict_bad(self, path: str, reason) -> None:
        """Evict a bad entry, or count a sibling that removed it first."""
        if self._remove(path):
            self.corrupt_evicted += 1
            log.warning("compile-cache: evicting bad entry %s (%s)",
                        os.path.basename(path), reason)
        else:
            self.vanished += 1

    def _validate(self, raw: bytes, key: Tuple, payload_kind: str) -> bytes:
        """The blob of a container's bytes; raises on any defect (the one
        check of disk reads and remote fetches)."""
        if raw[:8] != _MAGIC:
            raise ValueError("bad magic")
        (hlen,) = struct.unpack(">I", raw[8:12])
        header = json.loads(raw[12:12 + hlen].decode("utf-8"))
        blob = raw[12 + hlen:]
        if header.get("platform_fingerprint") != self._fingerprint:
            raise ValueError("platform fingerprint mismatch")
        if header.get("key") != canonical_key(key):
            raise ValueError("key collision/mismatch")
        if header.get("payload") != payload_kind:
            raise ValueError("payload kind mismatch")
        if header.get("blob_sha256") != hashlib.sha256(blob).hexdigest():
            raise ValueError("blob checksum mismatch")
        return blob

    def _fetch_remote(self, key: Tuple, payload_kind: str):
        if self._remote_fetch is None:
            return None
        name = os.path.basename(self.path_for(key))
        try:
            raw = self._remote_fetch(name)
        except Exception as e:  # noqa: BLE001 — a broken peer is a miss
            log.warning("compile-cache: remote fetch of %s failed (%s)",
                        name, e)
            self.fetch_misses += 1
            return None
        if raw is None:
            self.fetch_misses += 1
            return None
        try:
            blob = self._validate(raw, key, payload_kind)
        except Exception as e:  # noqa: BLE001 — a corrupt fetch is a miss
            self.fetch_corrupt += 1
            log.warning("compile-cache: fetched entry %s failed validation "
                        "(%s); counted a miss", name, e)
            return None
        self.fetch_hits += 1
        return blob

    def _load_payload(self, key: Tuple, payload_kind: str):
        """The validated blob of `key`, or None: absent (and no remote
        copy), foreign, of another kind or corrupt; the last three are
        evicted. A hit refreshes the entry's recency."""
        path = self.path_for(key)
        try:
            faults.fire("persist.read", path=path)
            with open(path, "rb") as f:
                raw = f.read()
        except (FileNotFoundError, IsADirectoryError):
            return self._fetch_remote(key, payload_kind)
        except OSError as e:
            self._note_io_error("read", path, e)
            return None
        try:
            blob = self._validate(raw, key, payload_kind)
        except Exception as e:  # noqa: BLE001 — any bad entry: evict
            self._evict_bad(path, e)
            return None
        try:
            os.utime(path, None)
        except OSError:
            pass
        self.hits += 1
        return blob

    def load_bytes(self, key: Tuple) -> Optional[bytes]:
        """The byte artifact stored under `key` with `store_bytes`, or
        None."""
        return self._load_payload(key, "bytes")

    # -- store ------------------------------------------------------------
    def store_bytes(self, key: Tuple, blob: bytes) -> bool:
        """Write a byte artifact under `key` atomically; returns success."""
        return self._store_payload(key, bytes(blob), "bytes")

    def _store_payload(self, key: Tuple, blob: bytes,
                       payload_kind: str) -> bool:
        path = self.path_for(key)
        try:
            header = json.dumps({
                "format": FORMAT_VERSION,
                "platform_fingerprint": self._fingerprint,
                "platform": self._platform,
                "key": canonical_key(key),
                "payload": payload_kind,
                "created": time.time(),
                "blob_sha256": hashlib.sha256(blob).hexdigest(),
            }, sort_keys=True).encode("utf-8")
            payload = _MAGIC + struct.pack(">I", len(header)) + header + blob
            # an armed 'corrupt' plan flips bytes here, so that the
            # checksum, evict and recompute path is testable end to end
            payload = faults.fire("persist.write", data=payload, path=path)
            fd, tmp = tempfile.mkstemp(dir=self.directory,
                                       suffix=_SUFFIX + ".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                self._remove(tmp)
                raise
        except OSError as e:  # a full disk or a lost mount: a counted miss
            self._note_io_error("write", path, e)
            return False
        except Exception as e:  # noqa: BLE001 — persistence is best-effort
            log.warning("compile-cache: failed to persist %s (%s)", key, e)
            return False
        self.writes += 1
        self._enforce_cap(keep=path)
        return True

    def evict(self, key: Tuple) -> None:
        self._remove(self.path_for(key))

    # -- size cap ---------------------------------------------------------
    def _entries(self):
        """[(path, size, mtime)] of every entry on disk now."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            p = os.path.join(self.directory, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((p, st.st_size, st.st_mtime))
        return out

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def _enforce_cap(self, keep: Optional[str] = None) -> None:
        """Evict the least recently used entries until the directory fits
        `max_bytes`; the entry just written (`keep`) stays even when it
        alone exceeds the cap. Entries a sibling removed meanwhile free
        their bytes all the same and count as `vanished`, not as
        evictions."""
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return
        for p, size, _ in sorted(entries, key=lambda e: e[2]):
            if total <= self.max_bytes:
                break
            if p == keep:
                continue
            if self._remove(p):
                self.evictions += 1
                log.info("compile-cache: LRU-evicted %s (%d bytes)",
                         os.path.basename(p), size)
            else:
                self.vanished += 1
            total -= size

    @staticmethod
    def _remove(path: str) -> bool:
        """Unlink; True iff this process removed the file."""
        try:
            os.remove(path)
            return True
        except OSError:
            return False

    def stats(self) -> dict:
        """The store's counters and its directory's entries and bytes."""
        return {"dir": self.directory, "entries": len(self),
                "bytes": self.total_bytes(), "writes": self.writes,
                "hits": self.hits, "evictions": self.evictions,
                "corrupt_evicted": self.corrupt_evicted,
                "io_errors": self.io_errors, "vanished": self.vanished}

    def __len__(self):
        return len(self._entries())

    def __repr__(self):
        return (f"PersistentProgramStore({self.directory!r}, "
                f"entries={len(self)}, bytes={self.total_bytes()}, "
                f"platform={self._fingerprint})")
