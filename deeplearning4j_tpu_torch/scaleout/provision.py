"""Cluster provisioning + blob storage — the AWS-module analog.

Capability parity with reference `aws/` (SURVEY.md §2 row 29):
`Ec2BoxCreator` / `ClusterSetup` (`aws/ec2/provision/ClusterSetup.java:42-115`
— create boxes, provision each over SSH via jsch `HostProvisioner`),
`S3Downloader`/`S3Uploader`/`BaseS3`, `S3ModelSaver`, `BaseS3DataSetIterator`,
and `DistributedDeepLearningTrainer`.

The port of `deeplearning4j_tpu/scaleout/provision.py`. The fleet is a
set of GPU hosts reached over SSH; the parameter data plane is
`torch.distributed` collectives, so provisioning only has to (a) push the
framework + configs to every host, (b) start one process per host with the
env `torch.distributed` reads (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
`RANK`, where the JAX package exports `JAX_COORDINATOR_ADDRESS`,
`JAX_NUM_PROCESSES` and `JAX_PROCESS_ID`), and (c) move artifacts
(checkpoints, datasets) through a pluggable BlobStore. No cloud SDK is
needed: the EC2/S3 calls become SSH/rsync command generation (executable
or dry-run) and a `BlobStore` interface with a local-filesystem
implementation; a real S3/GCS store only needs the same five methods.
Checkpoints go through the port's `parallel/checkpoint.py`, whose
`arrays.npz` layout the JAX package reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np


# ------------------------------------------------------------ cluster spec

@dataclasses.dataclass
class HostSpec:
    """One machine of the fleet (Ec2BoxCreator row analog)."""

    address: str
    user: str = "root"
    ssh_port: int = 22
    accelerators: int = 8  # chips on this host

    def ssh_target(self) -> str:
        return f"{self.user}@{self.address}"


@dataclasses.dataclass
class ClusterSpec:
    """The fleet + coordinator layout (`ClusterSetup` analog).

    `coordinator` is host 0's address:port for
    `torch.distributed.init_process_group` (the control plane that replaces
    Hazelcast/Zookeeper membership).
    """

    hosts: List[HostSpec] = dataclasses.field(default_factory=list)
    coordinator_port: int = 8476
    workdir: str = "/srv/dl4j_torch"

    @property
    def num_processes(self) -> int:
        return len(self.hosts)

    @property
    def coordinator_address(self) -> str:
        if not self.hosts:
            raise ValueError("empty cluster")
        return f"{self.hosts[0].address}:{self.coordinator_port}"

    def distributed_env(self, process_id: int) -> Dict[str, str]:
        """The `torch.distributed` env (its `env://` init) on host
        `process_id`: host 0's address and port, the world size, the
        rank."""
        if not self.hosts:
            raise ValueError("empty cluster")
        return {
            "MASTER_ADDR": self.hosts[0].address,
            "MASTER_PORT": str(self.coordinator_port),
            "WORLD_SIZE": str(self.num_processes),
            "RANK": str(process_id),
        }

    # -- serde (the reference parks configs in Zookeeper; we use JSON)
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ClusterSpec":
        d = json.loads(s)
        d["hosts"] = [HostSpec(**h) for h in d.get("hosts", [])]
        return cls(**d)


# -------------------------------------------------------------- launchers

class Launcher:
    """Pluggable worker-launch transport (VERDICT r4 next-#8): the SAME
    `ClusterSpec` drives a real remote fleet (`SshLauncher`) or a local
    stand-in fleet of subprocesses (`LocalLauncher`) — the reference
    contrast is `ClusterSetup.java:42-115`/`HostProvisioner.java`, which
    only know jsch SSH against real EC2 boxes."""

    def push(self, host: HostSpec, local_path: str, remote_path: str) -> int:
        raise NotImplementedError

    def start(self, host: HostSpec, entry: str, env: Dict[str, str],
              workdir: str):
        """Start `entry` for `host`; returns a handle (int returncode for
        fire-and-forget transports, Popen for local)."""
        raise NotImplementedError


class SshLauncher(Launcher):
    """rsync + ssh command transport.  `dry_run=True` (default) only
    records the commands — the in-process testable path, like the
    reference's IRUnitDriver pattern; `dry_run=False` really executes
    them against the host."""

    def __init__(self, dry_run: bool = True):
        self.dry_run = dry_run
        self.executed: List[List[str]] = []

    def _run(self, cmd: List[str]) -> int:
        self.executed.append(cmd)
        if self.dry_run:
            return 0
        return subprocess.run(cmd, check=False).returncode

    def push(self, host: HostSpec, local_path: str, remote_path: str) -> int:
        return self._run([
            "rsync", "-az", "-e", f"ssh -p {host.ssh_port}", local_path,
            f"{host.ssh_target()}:{remote_path}"])

    def start(self, host: HostSpec, entry: str, env: Dict[str, str],
              workdir: str) -> int:
        prefix = " ".join(f"{k}={v}" for k, v in env.items())
        full = f"cd {workdir} && {prefix} {entry}".strip()
        return self._run(["ssh", "-p", str(host.ssh_port),
                          host.ssh_target(), full])


class LocalLauncher(Launcher):
    """Per-host sandbox directories + local subprocesses — the second
    host stood in by this machine, so the full provision->launch->wait
    path is exercised hermetically (BaseTestDistributed-style)."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.procs: List[subprocess.Popen] = []

    def host_dir(self, host: HostSpec) -> str:
        d = os.path.join(self.base_dir, f"{host.address}_{host.ssh_port}")
        os.makedirs(d, exist_ok=True)
        return d

    def push(self, host: HostSpec, local_path: str, remote_path: str) -> int:
        # rsync analog: copy into the host sandbox (remote_path maps to
        # a path inside it, so spec.workdir works unchanged)
        dst = os.path.join(self.host_dir(host),
                           remote_path.lstrip("/"))
        os.makedirs(os.path.dirname(dst) or dst, exist_ok=True)
        if os.path.isdir(local_path):
            name = os.path.basename(os.path.normpath(local_path))
            target = os.path.join(dst, name)
            if os.path.exists(target):
                shutil.rmtree(target)
            shutil.copytree(local_path, target)
        else:
            os.makedirs(dst, exist_ok=True)
            shutil.copy2(local_path, dst)
        return 0

    def start(self, host: HostSpec, entry: str, env: Dict[str, str],
              workdir: str) -> subprocess.Popen:
        cwd = os.path.join(self.host_dir(host), workdir.lstrip("/"))
        os.makedirs(cwd, exist_ok=True)
        proc = subprocess.Popen(
            ["/bin/sh", "-c", entry], cwd=cwd,
            env={**os.environ, **env})
        self.procs.append(proc)
        return proc

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        return [p.wait(timeout=timeout) for p in self.procs]


# ------------------------------------------------------------- provisioner

class HostProvisioner:
    """Pushes the framework to hosts and launches one worker per host
    with its `torch.distributed` env, through a pluggable `Launcher`.

    Analog of `aws/ec2/provision/HostProvisioner.java` (jsch upload + run)
    + the launch half of `ClusterSetup.java`.  Default transport is the
    dry-run `SshLauncher` (commands recorded, not run); pass
    `LocalLauncher(dir)` to stand the fleet up on this machine, or
    `SshLauncher(dry_run=False)` to drive real hosts.
    """

    def __init__(self, spec: ClusterSpec, dry_run: bool = True,
                 launcher: Optional[Launcher] = None):
        self.spec = spec
        self.launcher = launcher or SshLauncher(dry_run=dry_run)
        self.handles: List[object] = []

    @property
    def executed(self) -> List[List[str]]:
        """Recorded commands (ssh transport only) — kept for the
        dry-run inspection contract."""
        return getattr(self.launcher, "executed", [])

    def push(self, local_path: str, host: HostSpec,
             remote_path: Optional[str] = None) -> int:
        return self.launcher.push(host, local_path,
                                  remote_path or self.spec.workdir)

    def run_remote(self, host: HostSpec, command: str,
                   env: Optional[Dict[str, str]] = None):
        return self.launcher.start(host, command, env or {}, ".")

    def provision_all(self, local_path: str) -> None:
        for host in self.spec.hosts:
            self.push(local_path, host)

    def launch_workers(self, entry: str = "python -m deeplearning4j_tpu_torch.cli train") -> List[object]:
        """Start one process per host with its torch.distributed env."""
        self.handles = [
            self.launcher.start(host, entry, self.spec.distributed_env(pid),
                                self.spec.workdir)
            for pid, host in enumerate(self.spec.hosts)]
        return self.handles

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Block until launched workers exit (local transport)."""
        if hasattr(self.launcher, "wait"):
            return self.launcher.wait(timeout)
        return [h if isinstance(h, int) else 0 for h in self.handles]


def initialize_distributed(spec: Optional[ClusterSpec] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """`torch.distributed.init_process_group` from a ClusterSpec or the env
    vars the provisioner exports. The backend is NCCL for a CUDA `device`
    (the default) and gloo for the CPU. Returns False when running
    single-process (the common local case) instead of raising."""
    import torch.distributed as dist

    if spec is not None and process_id is not None:
        addr = spec.coordinator_address
        nproc = spec.num_processes
        pid = process_id
    else:
        host = os.environ.get("MASTER_ADDR")
        addr = (f"{host}:{os.environ.get('MASTER_PORT', '')}"
                if host else None)
        nproc = int(os.environ.get("WORLD_SIZE", "1"))
        pid = int(os.environ.get("RANK", "0"))
    if not addr or nproc <= 1:
        return False
    from deeplearning4j_tpu_torch.nd.platform import resolve_device

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=nproc, rank=pid)
    return True


# --------------------------------------------------------------- blob store

class BlobStore:
    """S3-shaped artifact interface (`BaseS3` analog): five methods."""

    def upload(self, key: str, local_path: str) -> None:
        raise NotImplementedError

    def download(self, key: str, local_path: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class LocalBlobStore(BlobStore):
    """Directory-backed store — the hermetic stand-in for S3/GCS."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        root = os.path.normpath(self.root)
        p = os.path.normpath(os.path.join(root, key))
        if p != root and not p.startswith(root + os.sep):
            raise ValueError(f"key escapes store root: {key}")
        return p

    def upload(self, key: str, local_path: str) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isdir(local_path):
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(local_path, dst)
        else:
            shutil.copy2(local_path, dst)

    def download(self, key: str, local_path: str) -> None:
        src = self._path(key)
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        if os.path.isdir(src):
            if os.path.exists(local_path):
                shutil.rmtree(local_path)
            shutil.copytree(src, local_path)
        else:
            shutil.copy2(src, local_path)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                key = os.path.relpath(os.path.join(dirpath, f), self.root)
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        p = self._path(key)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


class BlobModelSaver:
    """Persist model checkpoints through a BlobStore (`S3ModelSaver` /
    `HdfsModelSaver` analog); pairs with `parallel/checkpoint`."""

    def __init__(self, store: BlobStore, key: str = "model"):
        self.store = store
        self.key = key

    def save(self, params, updater=None, *, conf=None, step: int = 0,
             tmpdir: Optional[str] = None) -> None:
        import tempfile

        from deeplearning4j_tpu_torch.parallel import checkpoint

        with tempfile.TemporaryDirectory(dir=tmpdir) as td:
            ckpt = os.path.join(td, "ckpt")
            checkpoint.save(ckpt, params, updater, conf=conf, step=step)
            self.store.upload(self.key, ckpt)

    def load(self, like_params=None, like_updater=None,
             tmpdir: Optional[str] = None):
        import tempfile

        from deeplearning4j_tpu_torch.parallel import checkpoint

        with tempfile.TemporaryDirectory(dir=tmpdir) as td:
            ckpt = os.path.join(td, "ckpt")
            self.store.download(self.key, ckpt)
            return checkpoint.load(ckpt, like_params, like_updater)


class BlobDataSetIterator:
    """Iterate DataSets stored as .npz blobs (`BaseS3DataSetIterator`
    analog): each key holds arrays `features` and `labels`."""

    def __init__(self, store: BlobStore, prefix: str = "data/",
                 tmpdir: Optional[str] = None):
        self.store = store
        self.keys = [k for k in store.list(prefix) if k.endswith(".npz")]
        self.tmpdir = tmpdir
        self._i = 0

    def reset(self) -> None:
        self._i = 0

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        import tempfile

        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        if self._i >= len(self.keys):
            raise StopIteration
        key = self.keys[self._i]
        self._i += 1
        with tempfile.TemporaryDirectory(dir=self.tmpdir) as td:
            local = os.path.join(td, "part.npz")
            self.store.download(key, local)
            with np.load(local) as z:
                return DataSet(z["features"], z["labels"])
