"""Host-side coordinator — the control plane.

The port's copy of `deeplearning4j_tpu/parallel/coordinator.py`, which
imports no JAX.

Parity: the reference's StateTracker + actor runtime
(`api/statetracker/StateTracker.java:45` ~40-method contract;
`MasterActor.java:61` heartbeat/reaper; `WorkerActor.java:52` poll/perform;
`BatchActor.java:49` data dispersal; `StateTrackerDropWizardResource.java:47`
REST).  The data plane (parameters/updates) rides `torch.distributed`
collectives (`parallel/data_parallel.py`), so what remains host-side is
exactly this: membership, heartbeats, stale-worker reaping, job routing,
counters, and REST observability — plus checkpoint coordination.

The in-process form doubles as the distributed-test rig (the analog of
`BaseTestDistributed.java:34-98`): real coordinator + real workers in one
process, no cluster.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_STALE_AFTER_S = 120.0   # MasterActor reaper threshold (:141-171)


@dataclass
class Job:
    """Work + result + workerId (`scaleout/job/Job.java:26-90`)."""

    work: Any
    worker_id: Optional[str] = None
    result: Any = None
    pending: bool = True
    attempts: int = 0
    error: Optional[str] = None


MAX_JOB_ATTEMPTS = 3  # JobFailed requeue cap (poisoned jobs must not spin)


class LocalFileUpdateSaver:
    """Spill worker updates to disk between rounds so aggregation survives
    a master restart (`LocalFileUpdateSaver.java:38-143` parity).  One
    atomically-published pickle per update, FIFO-ordered via
    `utils/disk_queue.DiskBasedQueue`."""

    def __init__(self, directory: str):
        from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue

        self.directory = directory
        self._queue = DiskBasedQueue(directory)
        # a fresh master over an old spill dir inherits the banked updates
        import os

        existing = sorted(
            f for f in os.listdir(directory) if f.endswith(".pkl"))
        self._queue._order.extend(
            os.path.join(directory, f) for f in existing)
        if existing:
            self._queue._counter = (
                int(os.path.splitext(existing[-1])[0]) + 1)

    def save(self, worker_id: str, update: Any) -> None:
        self._queue.add((worker_id, update))

    def drain(self) -> List[Tuple[str, Any]]:
        """Remove and return every spilled (worker_id, update)."""
        out = []
        while True:
            item = self._queue.poll()
            if item is None:
                return out
            out.append(item)

    def __len__(self) -> int:
        return len(self._queue)


class StateTracker:
    """Cluster state: workers, heartbeats, job slots, updates, current
    model, named counters.  Thread-safe; distributed deployments wrap it in
    the REST server below (workers poll over HTTP the way WorkerActor
    polled Hazelcast job slots).

    `update_dir` enables intra-round durability: every `add_update` also
    spills to disk, and a tracker (re)created over the same directory
    recovers the banked updates — a master restart mid-round loses nothing
    (`LocalFileUpdateSaver.java` parity)."""

    def __init__(self, stale_after_s: float = DEFAULT_STALE_AFTER_S,
                 update_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self._workers: Dict[str, float] = {}        # id -> last heartbeat
        self._enabled: Dict[str, bool] = {}
        self._jobs: Dict[str, Job] = {}             # per-worker job slot
        self._unclaimed: "queue.Queue[Job]" = queue.Queue()  # requeued work
        self._updates: List[Tuple[str, Any]] = []   # (worker, result) log
        self._current = None                        # current model (atomic ref)
        self._counters: Dict[str, float] = {}
        self._batches_so_far = 0
        self._minibatch_size = 0
        self.stale_after_s = stale_after_s
        self._saver: Optional[LocalFileUpdateSaver] = None
        if update_dir is not None:
            import os

            os.makedirs(update_dir, exist_ok=True)
            self._saver = LocalFileUpdateSaver(update_dir)
            # recover updates a crashed master had already banked
            self._updates.extend(self._saver.drain())
            for worker_id, update in self._updates:
                self._saver.save(worker_id, update)

    # -- membership / heartbeats (StateTracker.java:326-332) ---------------
    def add_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers[worker_id] = time.monotonic()
            self._enabled.setdefault(worker_id, True)

    def heartbeat(self, worker_id: str) -> None:
        self.add_worker(worker_id)

    def workers(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)
            self._enabled.pop(worker_id, None)
            job = self._jobs.pop(worker_id, None)
        if job is not None and job.pending:
            # re-route the orphaned job (MasterActor stale-job requeue)
            self.route_unclaimed(job)

    def reap_stale(self) -> List[str]:
        """Remove workers silent >= stale_after_s; returns removed ids."""
        now = time.monotonic()
        with self._lock:
            stale = [w for w, t in self._workers.items()
                     if now - t >= self.stale_after_s]
        for w in stale:
            self.remove_worker(w)
        return stale

    # -- job routing (StateTracker.java:359, job slots :699) ---------------
    def route_job(self, worker_id: str, job: Job) -> bool:
        """Assign a job to a worker's slot; False if slot occupied
        (`AlreadyWorking` protocol parity)."""
        with self._lock:
            if worker_id in self._jobs:
                return False
            job.worker_id = worker_id
            self._jobs[worker_id] = job
            return True

    def route_unclaimed(self, job: Job) -> None:
        job.worker_id = None
        self._unclaimed.put(job)

    def take_unclaimed(self) -> Optional[Job]:
        try:
            return self._unclaimed.get_nowait()
        except queue.Empty:
            return None

    def job_for(self, worker_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(worker_id)

    def clear_job(self, worker_id: str) -> None:
        with self._lock:
            self._jobs.pop(worker_id, None)

    def pending_jobs(self) -> int:
        with self._lock:
            return sum(1 for j in self._jobs.values() if j.pending)

    # -- updates (StateTracker.java:225-231) -------------------------------
    def add_update(self, worker_id: str, result: Any) -> None:
        with self._lock:
            # an append log, not a worker-keyed map: one worker may finish
            # several jobs per wave and every result must survive
            self._updates.append((worker_id, result))
            if self._saver is not None:  # intra-round durability
                self._saver.save(worker_id, result)
            job = self._jobs.get(worker_id)
            if job is not None:
                job.pending = False
                job.result = result

    def updates(self) -> List[Any]:
        """All results since the last clear, in completion order."""
        with self._lock:
            return [r for _, r in self._updates]

    def clear_updates(self) -> None:
        with self._lock:
            self._updates.clear()
            if self._saver is not None:
                self._saver.drain()  # the round aggregated; drop the spill

    # -- current model (StateTracker.java:90-97) ---------------------------
    def set_current(self, model) -> None:
        with self._lock:
            self._current = model

    def get_current(self):
        with self._lock:
            return self._current

    # -- counters / batch bookkeeping (REST observability surface) ---------
    def increment(self, name: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + by

    def count(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def increment_batches(self) -> None:
        with self._lock:
            self._batches_so_far += 1

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "workers": list(self._workers),
                "enabled": dict(self._enabled),
                "pending_jobs": sum(1 for j in self._jobs.values()
                                    if j.pending),
                "updates": len(self._updates),
                "counters": dict(self._counters),
                "minibatch": self._minibatch_size,
                "numbatchessofar": self._batches_so_far,
                "has_current_model": self._current is not None,
            }


class _StatusHandler(BaseHTTPRequestHandler):
    tracker: StateTracker = None

    def do_GET(self):  # noqa: N802 (http.server API)
        st = self.tracker.status()
        path = self.path.rstrip("/")
        # per-field endpoints mirror StateTrackerDropWizardResource paths
        if path in ("/statetracker", ""):
            body = st
        else:
            key = path.rsplit("/", 1)[-1]
            body = {key: st.get(key)}
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass


def start_rest_api(tracker: StateTracker, port: int = 0):
    """Serve tracker status over HTTP (`stateTracker.startRestApi()`
    parity).  Returns (server, actual_port); daemon thread."""
    handler = type("Handler", (_StatusHandler,), {"tracker": tracker})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


class LocalRunner:
    """In-process master/worker runtime over a StateTracker — the
    `DeepLearning4jDistributed` role for host-level work that is NOT
    on-mesh (vocab building, co-occurrence counting, data prep), and the
    test rig for control-plane semantics.

    perform(work) -> result runs in worker threads; aggregate(results) ->
    merged runs in the master loop per round.  BSP gate parity: next wave
    dispatches only when all updates are in (IterativeReduceWorkRouter);
    hogwild=True dispatches eagerly (HogWildWorkRouter).
    """

    def __init__(self, perform: Callable[[Any], Any],
                 aggregate: Callable[[List[Any]], Any],
                 n_workers: int = 4, hogwild: bool = False,
                 tracker: Optional[StateTracker] = None):
        self.perform = perform
        self.aggregate = aggregate
        self.n_workers = n_workers
        self.hogwild = hogwild
        self.tracker = tracker or StateTracker()
        self._work_q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()

    def _worker_loop(self, wid: str):
        self.tracker.add_worker(wid)
        while not self._stop.is_set():
            try:
                job = self._work_q.get(timeout=0.05)
            except queue.Empty:
                self.tracker.heartbeat(wid)
                continue
            self.tracker.route_job(wid, job)
            t0 = time.monotonic()
            try:
                job.attempts += 1
                result = self.perform(job.work)
                # result lives on the JOB (reference parity: Job carries its
                # own result, Job.java:26-90); keying the tracker map by
                # worker id alone would drop results when one worker
                # finishes several jobs in a wave
                job.result = result
                job.pending = False
                self.tracker.add_update(wid, result)
                self.tracker.increment("jobs_done")
                self.tracker.increment("job_ms",
                                       (time.monotonic() - t0) * 1e3)
            except Exception as e:  # JobFailed protocol: bounded requeue
                self.tracker.increment("jobs_failed")
                job.error = repr(e)
                if job.attempts < MAX_JOB_ATTEMPTS:
                    self._work_q.put(job)
                else:
                    job.pending = False  # give up; result stays None
            finally:
                self.tracker.clear_job(wid)
                self._work_q.task_done()

    def run(self, work_items) -> Any:
        """Dispatch all work, BSP-gated into waves of n_workers (or eagerly
        under hogwild); returns aggregate of all successful results."""
        threads = [threading.Thread(target=self._worker_loop,
                                    args=(f"worker-{i}",), daemon=True)
                   for i in range(self.n_workers)]
        for t in threads:
            t.start()
        jobs = [Job(work=w) for w in work_items]
        try:
            if self.hogwild:
                for j in jobs:
                    self._work_q.put(j)
                self._work_q.join()
            else:
                # waves: all updates in before the next MoreWorkMessage
                for i in range(0, len(jobs), self.n_workers):
                    self.tracker.clear_updates()
                    for j in jobs[i:i + self.n_workers]:
                        self._work_q.put(j)
                    self._work_q.join()
                    self.tracker.increment_batches()
        finally:
            self._stop.set()
            for t in threads:
                t.join(timeout=2.0)
        results = [j.result for j in jobs if j.result is not None]
        merged = self.aggregate(results)
        self.tracker.set_current(merged)
        return merged
