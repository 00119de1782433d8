"""Rank 0's calls to the other ranks of a serving mesh.

The JAX package serves a mesh from one process: GSPMD runs each program
on every device. The port runs one process a rank, so rank 0 (the
leader, which holds the HTTP front and the batchers) sends each call of a
mesh program to the other ranks (the followers), and every rank runs the
same captured graph on its own rows and heads.

The messages go through the process group's key-value store (torchrun's
TCP store, a test's file store), not through a collective: an idle
follower waits on the store without a collective timing out, and a
follower that fails answers with its error instead of leaving rank 0 in a
collective. One call is four steps:

  header   rank 0 writes (entry, key, bucket, the wired inputs, and the
           kept-row prefixes it forgot since its last header) under the
           call's sequence number;
  vote     every follower reads it, prepares (its key must be rank 0's,
           its state and buckets found) and answers "ok" or its error;
  go       rank 0 answers "go" once every follower is ready, else "abort"
           and raises the first error; no rank enters the program's
           collectives unless all are ready, so a miss is captured on
           every rank in the same order;
  done     every follower answers once its program has run; rank 0 raises
           a follower's error there.

A fault inside a running program's collective (past the vote) is not
caught here: the group's own timeout ends it. `stop` ends the followers'
loop.
"""

from __future__ import annotations

import itertools
import pickle
import time
from datetime import timedelta
from typing import Optional

#: channel namespaces: every rank makes its channels in the same order
#: (`InferCache.set_mesh` on the same networks), so the n-th channel of
#: each process is the same channel
_NAMESPACES = itertools.count()

#: how long rank 0 waits for a follower's answer before it gives up
DEFAULT_TIMEOUT_S = 600.0

_OK = b"ok"
_GO = b"go"
_ABORT = b"abort"


class FollowerError(RuntimeError):
    """A follower rank could not run rank 0's call (or did not answer)."""


class Aborted(Exception):
    """Rank 0 called the call off (another rank was not ready)."""


def _store():
    """The default process group's store."""
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


class Channel:
    """One mesh's messages: `leader` is rank 0 of the mesh, `ranks` its
    size. Keys live under a namespace of their own and are deleted once
    read."""

    def __init__(self, rank: int, ranks: int,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        import torch.distributed as dist

        self.rank, self.ranks = int(rank), int(ranks)
        self.timeout_s = float(timeout_s)
        self.store = dist.PrefixStore(f"dl4j-serve/{next(_NAMESPACES)}/",
                                      _store())
        self.seq = 0

    @property
    def leader(self) -> bool:
        return self.rank == 0

    # -- waiting --------------------------------------------------------------
    def _get(self, key: str, timeout_s: Optional[float]) -> bytes:
        """The value of `key` once it is set; `timeout_s` None waits for
        ever (an idle follower), polling the store a second at a time."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            try:
                self.store.wait([key], timedelta(seconds=1))
                return self.store.get(key)
            except Exception:  # noqa: BLE001 — the store's wait timed out
                if deadline is not None and time.monotonic() > deadline:
                    raise FollowerError(
                        f"no answer under {key!r} in {timeout_s:.0f} s")

    def _answers(self, seq: int, phase: str) -> Optional[str]:
        """Every follower's answer of `phase` to call `seq` (the keys
        deleted): the first error, or None when all are "ok"."""
        err = None
        for r in range(1, self.ranks):
            key = f"{seq}.{phase}.{r}"
            try:
                v = self._get(key, self.timeout_s)
            except FollowerError as e:
                err = err or f"rank {r}: {e}"
                continue
            self.store.delete_key(key)
            if v != _OK and err is None:
                err = f"rank {r}: {v.decode(errors='replace')}"
        return err

    # -- rank 0 ---------------------------------------------------------------
    def send(self, message) -> int:
        """Write a header; returns its sequence number."""
        seq, self.seq = self.seq, self.seq + 1
        self.store.set(f"{seq}.h", pickle.dumps(message))
        return seq

    def vote(self, seq: int) -> None:
        """Wait for every follower's readiness, then answer go or abort;
        raises `FollowerError` with the first follower's error."""
        err = self._answers(seq, "p")
        self.store.delete_key(f"{seq}.h")
        if seq:
            # every follower has finished the call before (it answered
            # this one), so that call's go has been read
            self.store.delete_key(f"{seq - 1}.g")
        self.store.set(f"{seq}.g", _ABORT if err else _GO)
        if err:
            raise FollowerError(err)

    def done(self, seq: int) -> None:
        """Wait for every follower's end of call `seq`; raises
        `FollowerError` with the first follower's error."""
        err = self._answers(seq, "d")
        if err:
            raise FollowerError(err)

    # -- the followers --------------------------------------------------------
    def receive(self):
        """(seq, message) of the next header, waiting as long as it takes."""
        seq, self.seq = self.seq, self.seq + 1
        return seq, pickle.loads(self._get(f"{seq}.h", None))

    def answer(self, seq: int, phase: str,
               error: Optional[BaseException] = None) -> None:
        text = _OK if error is None else (
            f"{type(error).__name__}: {error}".encode())
        self.store.set(f"{seq}.{phase}.{self.rank}", text)

    def wait_go(self, seq: int) -> None:
        """Block until rank 0 answers the vote; raises `Aborted` on an
        abort."""
        if self._get(f"{seq}.g", None) != _GO:
            raise Aborted()
