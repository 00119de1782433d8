"""The port's parameter-server worker and provisioning
(`deeplearning4j_tpu_torch/scaleout/ps_worker.py`, `provision.py`) on the
CPU: `ps_worker.main` in threads against a live server (JAX's
multi-process cases, tests/test_multiprocess_distributed.py, without the
processes), the worker's wire vector in JAX's flat order, and the cases
of tests/test_provision.py with the `torch.distributed` env names; a
two-rank gloo fleet only where JAX's own test is marked slow, marked the
same.
"""

import json
import os
import socket
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.models.zoo import mlp as jax_mlp  # noqa: E402
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.scaleout import ps_worker  # noqa: E402
from deeplearning4j_tpu_torch.scaleout.param_server import ParameterServer  # noqa: E402,E501
from deeplearning4j_tpu_torch.scaleout.provision import (  # noqa: E402
    BlobDataSetIterator, BlobModelSaver, ClusterSpec, HostProvisioner,
    HostSpec, LocalBlobStore, LocalLauncher, SshLauncher,
    initialize_distributed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- ps_worker, threads

def _mlp_conf_json():
    """JAX's test MLP (tests/test_multiprocess_distributed.py:33-39)."""
    conf = jax_mlp(4, [8], 3, lr=0.5)
    confs = tuple(c.replace(num_iterations=20, use_adagrad=False,
                            momentum=0.0) for c in conf.confs)
    return conf.replace(confs=confs).to_json()


def _run_workers(tmp_path, mode, slow=()):
    conf_json = _mlp_conf_json()
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(conf_json)
    net0 = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                             device="cpu", seed=7).init()
    n_workers, rounds = 3, 4
    ps = ParameterServer(net0.params_flat().numpy(), n_workers,
                         iterations=rounds, mode=mode)
    port = ps.serve(0)
    rcs, order = {}, []

    def run(i):
        argv = ["--server", f"http://127.0.0.1:{port}", "--worker-id",
                f"w{i}", "--conf", str(conf_path), "--rounds", str(rounds),
                "--device", "cpu"]
        if i in slow:
            argv += ["--slow", "0.5"]
        rcs[i] = ps_worker.main(argv)
        order.append(f"w{i}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_workers)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        ps.shutdown()
    assert rcs == {i: 0 for i in range(n_workers)}
    data = IrisDataFetcher().fetch(150).normalize_zero_mean_unit_variance()
    s0 = net0.score(data.features, data.labels)
    net0.set_params_flat(ps.current)
    acc = (net0.predict(data.features) == data.labels.argmax(-1)).mean()
    return ps, s0, net0.score(data.features, data.labels), acc, order


def test_ps_workers_in_threads_train_bsp(tmp_path):
    """Three `ps_worker.main` threads, 4 BSP rounds against a live server
    (JAX's multi-process case without the processes): every round is
    published, every worker reported, the averaged model learns."""
    ps, s0, s1, acc, _ = _run_workers(tmp_path, "bsp")
    assert ps.round == 4
    assert ps.completed == {"w0", "w1", "w2"} and not ps.errors
    assert ps.metrics.get("rounds") == 12.0 and len(ps.progress) == 3
    assert s1 < s0
    assert acc > 0.85, acc


def test_ps_workers_in_threads_async_straggler(tmp_path):
    """Async: each delta is applied as it lands (12 rounds for 3 x 4
    updates), the slow worker (0.5 s a round) finishes last, and the merged
    model learns."""
    ps, s0, s1, acc, order = _run_workers(tmp_path, "async", slow=(2,))
    assert ps.round == 12
    assert order[-1] == "w2", order
    assert s1 < s0
    assert acc > 0.85, acc


def test_ps_worker_sends_jaxs_flat_order():
    """The vector on the wire is JAX's `params_flat` of the same params:
    a port net carried from JAX's init flattens to JAX's vector."""
    from deeplearning4j_tpu.nn.conf import (
        MultiLayerConfiguration as JaxConf)
    from deeplearning4j_tpu.nn.multilayer import (
        MultiLayerNetwork as JaxNet)

    conf_json = _mlp_conf_json()
    jnet = JaxNet(JaxConf.from_json(conf_json), seed=3).init()
    net = ps_worker._build_net(conf_json, seed=3, device="cpu")
    net.set_params_flat(np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(net.params_flat().numpy(),
                                  np.asarray(jnet.params_flat()))
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)


# ------------------------------------------------------------ provisioning

def _spec():
    return ClusterSpec(hosts=[HostSpec("10.0.0.1"), HostSpec("10.0.0.2")],
                       coordinator_port=9000)


def test_cluster_spec_roundtrip_and_env():
    spec2 = ClusterSpec.from_json(_spec().to_json())
    assert spec2.coordinator_address == "10.0.0.1:9000"
    assert spec2.distributed_env(1) == {
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "9000",
        "WORLD_SIZE": "2", "RANK": "1"}


def test_provisioner_dry_run_generates_commands():
    prov = HostProvisioner(_spec(), dry_run=True)
    prov.provision_all("/tmp/framework")
    prov.launch_workers("python worker.py")
    rsyncs = [c for c in prov.executed if c[0] == "rsync"]
    sshes = [c for c in prov.executed if c[0] == "ssh"]
    assert len(rsyncs) == 2 and len(sshes) == 2
    assert "RANK=0" in sshes[0][-1] and "RANK=1" in sshes[1][-1]
    assert "MASTER_ADDR=10.0.0.1 MASTER_PORT=9000" in sshes[1][-1]
    assert "WORLD_SIZE=2" in sshes[0][-1]


def test_ssh_launcher_commands_include_workdir_cd():
    prov = HostProvisioner(_spec(), launcher=SshLauncher(dry_run=True))
    prov.launch_workers()
    sshes = [c for c in prov.executed if c[0] == "ssh"]
    assert len(sshes) == 2
    assert sshes[0][-1].startswith(f"cd {_spec().workdir} && ")
    assert sshes[0][-1].endswith(
        "python -m deeplearning4j_tpu_torch.cli train")


def test_local_launcher_runs_real_fleet(tmp_path):
    """The same ClusterSpec drives a local stand-in fleet: each worker
    writes its torch.distributed env and cwd (per-host sandboxes)."""
    launcher = LocalLauncher(str(tmp_path / "fleet"))
    prov = HostProvisioner(_spec(), launcher=launcher)
    src = tmp_path / "pkg"
    src.mkdir()
    (src / "marker.txt").write_text("v1")
    prov.provision_all(str(src))
    out = tmp_path / "out.jsonl"
    entry = (f"{sys.executable} -c \"import os, json; "
             f"open({str(out)!r}, 'a').write(json.dumps("
             f"{{'rank': os.environ['RANK'], "
             f"'world': os.environ['WORLD_SIZE'], "
             f"'addr': os.environ['MASTER_ADDR'], "
             f"'port': os.environ['MASTER_PORT'], "
             f"'cwd': os.getcwd()}}) + chr(10))\"")
    prov.launch_workers(entry)
    assert prov.wait(timeout=60) == [0, 0]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert {r["rank"] for r in rows} == {"0", "1"}
    assert all(r["world"] == "2" and r["addr"] == "10.0.0.1"
               and r["port"] == "9000" for r in rows)
    cwds = {r["cwd"] for r in rows}
    assert len(cwds) == 2
    workdir = _spec().workdir.lstrip("/")
    assert all("fleet" in c and c.endswith(workdir) for c in cwds)
    for host in _spec().hosts:
        assert os.path.isfile(os.path.join(launcher.host_dir(host), workdir,
                                           "pkg", "marker.txt"))


def test_initialize_distributed_is_false_for_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed(device="cpu") is False


@pytest.mark.slow
def test_local_launcher_fleet_all_reduces_over_gloo(tmp_path):
    """Two ranks started by the LocalLauncher initialise torch.distributed
    (gloo) from the exported env alone and all-reduce one tensor (JAX's
    two-process case, marked slow as it is)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = ClusterSpec(hosts=[HostSpec("127.0.0.1", ssh_port=22),
                              HostSpec("127.0.0.1", ssh_port=23)],
                       coordinator_port=port)
    script = tmp_path / "rank.py"
    script.write_text(
        "import sys, torch, torch.distributed as dist\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from deeplearning4j_tpu_torch.scaleout.provision import "
        "initialize_distributed\n"
        "assert initialize_distributed(device='cpu') is True\n"
        "t = torch.tensor([dist.get_rank() + 1.0])\n"
        "dist.all_reduce(t)\n"
        "assert t.item() == 3.0, t\n"
        "dist.destroy_process_group()\n")
    prov = HostProvisioner(spec, launcher=LocalLauncher(str(tmp_path / "f")))
    prov.launch_workers(f"{sys.executable} {script}")
    assert prov.wait(timeout=120) == [0, 0]


def test_local_blob_store_roundtrip(tmp_path):
    store = LocalBlobStore(str(tmp_path / "store"))
    src = tmp_path / "a.txt"
    src.write_text("hello")
    store.upload("artifacts/a.txt", str(src))
    assert store.exists("artifacts/a.txt")
    assert store.list("artifacts/") == ["artifacts/a.txt"]
    dst = tmp_path / "b.txt"
    store.download("artifacts/a.txt", str(dst))
    assert dst.read_text() == "hello"
    store.delete("artifacts/a.txt")
    assert not store.exists("artifacts/a.txt")


@pytest.mark.parametrize("key", ["../evil", "../store-evil/f"])
def test_blob_store_rejects_escaping_keys(tmp_path, key):
    store = LocalBlobStore(str(tmp_path / "store"))
    with pytest.raises(ValueError, match="escapes"):
        store.upload(key, __file__)


def test_blob_model_saver_roundtrip_and_jax_reads_it(tmp_path):
    """Bitwise back through the port, and JAX's `checkpoint.load` reads
    the blob the port wrote."""
    store = LocalBlobStore(str(tmp_path / "store"))
    params = ({"W": torch.arange(6.0).reshape(2, 3),
               "b": torch.tensor([0.5, -1.25, 3.0])},)
    saver = BlobModelSaver(store, key="models/mlp")
    saver.save(params, step=7)
    restored, updater, meta = saver.load(like_params=params)
    assert torch.equal(restored[0]["W"], params[0]["W"])
    assert torch.equal(restored[0]["b"], params[0]["b"])
    assert updater is None and meta["step"] == 7
    local = tmp_path / "ckpt"
    store.download("models/mlp", str(local))
    like = ({"W": np.zeros((2, 3), np.float32),
             "b": np.zeros(3, np.float32)},)
    jparams, _, jmeta = jax_checkpoint.load(str(local), like_params=like)
    np.testing.assert_array_equal(np.asarray(jparams[0]["W"]),
                                  params[0]["W"].numpy())
    assert jmeta["step"] == 7


def test_blob_dataset_iterator(tmp_path):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    store = LocalBlobStore(str(tmp_path / "store"))
    for i in range(3):
        p = tmp_path / f"part{i}.npz"
        np.savez(p, features=np.full((4, 2), i, np.float32),
                 labels=np.eye(4, 3, dtype=np.float32))
        store.upload(f"data/part{i}.npz", str(p))
    parts = list(BlobDataSetIterator(store, prefix="data/"))
    assert len(parts) == 3 and all(isinstance(p, DataSet) for p in parts)
    assert parts[1].features.shape == (4, 2)
    np.testing.assert_allclose(parts[2].features, 2.0)
