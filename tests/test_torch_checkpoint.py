"""Crash-safe checkpointed `fit`, checkpoints across both packages, and the
port's fault points, after the JAX package's tests
(tests/test_reliability.py).

A SIGTERM (the handler `fit` installs, called in process) or
`request_stop_training` checkpoints and raises `TrainingInterrupted`; a
rerun on the same directory and stream resumes at the saved cursor and ends
bitwise equal to one uninterrupted run (on the CPU; the card's check is in
chip_smoke.py). Checkpoints carry params, the data cursor and metadata in
the JAX package's layout both ways. Inputs and weights come from numpy
seeds.
"""

import json
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: E402
    ListDataSetIterator, PrefetchIterator)
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import (  # noqa: E402
    TrainingInterrupted, faults)

VOCAB, SEQ, ROWS, BATCHES = 20, 6, 3, 5
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dogs"]


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def _conf():
    jconf = jax_zoo.char_lstm(VOCAB, hidden=8, n_layers=2, sparse_labels=True,
                              embed=6)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _stream(n=BATCHES, seed=3):
    ids = np.random.RandomState(seed).randint(0, VOCAB,
                                              (n * ROWS, SEQ + 1))
    data = DataSet(ids[:, :-1].astype(np.int32),
                   ids[:, 1:].reshape(-1).astype(np.int32))
    return ListDataSetIterator(data, ROWS)


def _net(seed=7, **kw):
    return ml.MultiLayerNetwork(_conf()[1], device="cpu", seed=seed,
                                **kw).init()


def _leaves(net):
    return [t.clone() for t in tree_leaves(net.params)]


class _SigtermAfter:
    """A listener that calls the installed SIGTERM handler after `after`
    batches, standing in for the signal's delivery."""

    def __init__(self, after):
        self.after, self.n = after, 0

    def iteration_done(self, model, iteration, score):
        self.n += 1
        if self.n == self.after:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), "fit did not install a SIGTERM handler"
            handler(signal.SIGTERM, None)


def test_sigterm_mid_stream_then_rerun_is_bitwise_one_run(tmp_path):
    ck = str(tmp_path / "ck")
    ref = _net()
    ref.fit(_stream())
    before = signal.getsignal(signal.SIGTERM)

    n1 = _net()
    n1.set_listeners([_SigtermAfter(2)])
    with pytest.raises(TrainingInterrupted):
        n1.fit(_stream(), checkpoint_dir=ck)
    assert signal.getsignal(signal.SIGTERM) is before
    _, _, meta = checkpoint.load(ck)
    assert meta["data_cursor"] == {"batches_done": 2} and meta["step"] == 2
    assert "torch_generator_state" in meta["metadata"]

    n2 = _net()  # a fresh process
    n2.fit(PrefetchIterator(_stream(), device="cpu"), checkpoint_dir=ck)
    assert n2.resumed_from_batch == 2
    assert n2.step_cache.stats.steps == BATCHES - 2
    for a, b in zip(tree_leaves(n2.params), tree_leaves(ref.params)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    _, _, meta = checkpoint.load(ck)
    assert meta["data_cursor"]["batches_done"] == BATCHES
    assert n2.checkpoints_written == 1 and n2.checkpoint_write_seconds > 0


def test_periodic_checkpoints_and_request_stop_training(tmp_path):
    ck = str(tmp_path / "ck")
    net = _net(seed=1)
    saved = []
    real_save = net._save_checkpoint
    net._save_checkpoint = lambda d, n: (saved.append(n), real_save(d, n))
    net.fit(_stream(), checkpoint_dir=ck, checkpoint_every_n_batches=2)
    assert saved == [2, 4, 5]
    assert os.path.isdir(ck) and not os.path.isdir(ck + ".bak")

    class _Stop:
        def iteration_done(self, model, iteration, score):
            model.request_stop_training()

    net2 = _net(seed=1)
    net2.set_listeners([_Stop()])
    with pytest.raises(TrainingInterrupted):
        net2.fit(_stream(), checkpoint_dir=str(tmp_path / "ck2"),
                 auto_resume=False)
    _, _, meta = checkpoint.load(str(tmp_path / "ck2"))
    assert meta["data_cursor"]["batches_done"] == 1
    # auto_resume=False starts over even where a checkpoint exists
    net3 = _net(seed=1)
    net3.fit(_stream(), checkpoint_dir=ck, auto_resume=False)
    assert net3.resumed_from_batch is None
    assert net3.step_cache.stats.steps == BATCHES


def test_port_checkpoint_loads_in_jax_and_jax_checkpoint_in_the_port(
        tmp_path):
    jconf, tconf = _conf()
    net = _net(seed=2)
    net.fit(_stream(n=2))
    port_dir = str(tmp_path / "port")
    checkpoint.save(port_dir, net.params, conf=tconf, step=4,
                    data_cursor={"batches_done": 4},
                    metadata={"note": "port"})
    like = jax_ml.init_params(jconf, jax.random.PRNGKey(0))
    jparams, _, meta = jax_checkpoint.load_resilient(port_dir,
                                                     like_params=like)
    assert meta["data_cursor"] == {"batches_done": 4}
    assert meta["step"] == 4 and meta["metadata"] == {"note": "port"}
    for a, b in zip(tree_leaves(net.params), jax.tree_util.tree_leaves(
            jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jax_dir = str(tmp_path / "jax")
    jax_checkpoint.save(jax_dir, jparams, conf=jconf, step=9,
                        data_cursor={"batches_done": 9},
                        metadata={"note": "jax"})
    params, _, meta = checkpoint.load_resilient(jax_dir,
                                                like_params=net.params)
    assert meta["data_cursor"] == {"batches_done": 9}
    assert meta["step"] == 9 and meta["metadata"] == {"note": "jax"}
    for a, b in zip(tree_leaves(params), tree_leaves(net.params)):
        assert torch.equal(a, b)
    # a JAX checkpoint resumes a port fit at its cursor
    resumed = _net(seed=2)
    resumed.fit(_stream(n=BATCHES), checkpoint_dir=jax_dir)
    assert resumed.resumed_from_batch == 9  # past the stream: nothing to do
    assert resumed.step_cache.stats.steps == 0


def test_load_refuses_another_model_and_falls_back_past_a_torn_one(tmp_path):
    d = str(tmp_path / "ck")
    net = _net(seed=4)
    checkpoint.save(d, net.params, step=7)
    other = ml.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jax_zoo.char_lstm(VOCAB, hidden=4, n_layers=2, sparse_labels=True,
                          embed=6).to_json()), device="cpu").init()
    with pytest.raises(checkpoint.CheckpointFormatError, match="shape"):
        checkpoint.load_resilient(d, like_params=other.params)
    shutil.copytree(d, d + ".bak")
    with open(os.path.join(d, "arrays.npz"), "wb") as f:
        f.write(b"torn")
    params, _, meta = checkpoint.load_resilient(d, like_params=net.params)
    assert meta["step"] == 7
    for a, b in zip(tree_leaves(params), tree_leaves(net.params)):
        assert torch.equal(a, b)
    assert checkpoint.load_resilient(str(tmp_path / "absent")) is None


def test_an_armed_save_fault_leaves_the_previous_checkpoint_readable(
        tmp_path):
    d = str(tmp_path / "ck")
    net = _net(seed=5)
    checkpoint.save(d, net.params, step=1, data_cursor={"batches_done": 1})
    first = _leaves(net)
    net.fit(_stream(n=1))
    faults.arm("checkpoint.save", "oserror")
    with pytest.raises(OSError):
        checkpoint.save(d, net.params, step=2,
                        data_cursor={"batches_done": 2})
    params, _, meta = checkpoint.load_resilient(d, like_params=net.params)
    assert meta["data_cursor"] == {"batches_done": 1}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), first))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    # an armed load fault stands for an unreadable directory: skipped
    faults.arm("checkpoint.load", nth=1)
    assert checkpoint.load_resilient(d, like_params=net.params) is None
    assert faults.stats()["armed"]["checkpoint.load"]["fired"] == 1


def test_a_prefetch_worker_fault_reaches_the_consumer_once():
    faults.arm("prefetch.worker", nth=3)
    got = []
    with pytest.raises(faults.FaultInjected):
        for b in PrefetchIterator(_stream(), device="cpu"):
            got.append(b)
    assert faults.hits("prefetch.worker") == 3
    assert len(got) == 0  # two staged, none handed over before the fault
    assert len(list(PrefetchIterator(_stream(), device="cpu"))) == BATCHES


def _corpus(tmp_path, chars=300):
    rng = np.random.RandomState(0)
    text = " ".join(rng.choice(WORDS) for _ in range(chars // 4))[:chars]
    path = tmp_path / "corpus.txt"
    path.write_text(text)
    return f"text:{path}:8"


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_cli_checkpoint_dir_resumes_and_keeps_the_jax_train_keys(
        tmp_path, capsys, monkeypatch):
    uri = _corpus(tmp_path)
    common = ["train", "--input", uri, "--zoo", "char_lstm:layers=2,hidden=8",
              "--properties", "epochs=2,batch=8,checkpoint_every=2"]
    assert main(common + ["--output", str(tmp_path / "one"), "--device",
                          "cpu", "--checkpoint-dir",
                          str(tmp_path / "ck1")]) == 0
    one = _last_json(capsys.readouterr().out)
    # the JAX package's train line has the same keys with or without a
    # checkpoint dir; its checkpointed stream selects label rows by example
    # index (ROADMAP.md queue C), which a text corpus's B*T rows defeat
    assert jax_main(["train", "--input", uri, "--zoo",
                     "char_lstm:layers=2,hidden=8", "--properties",
                     "epochs=1", "--output", str(tmp_path / "jax")]) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(one) == set(want)
    assert one["resumed_from_step"] is None and one["disk_cache"] is None
    assert one["cache_misses"] >= 1 and one["cache_hits"] >= 1
    assert one["checkpoint_write_seconds"] > 0

    # stopped after 3 batches (the run's SIGTERM path), then rerun
    real = ml.MultiLayerNetwork._fit_batch
    calls = []

    def stop_after_three(self, x, y):
        real(self, x, y)
        calls.append(1)
        if len(calls) == 3:
            self.request_stop_training()

    ck = str(tmp_path / "ck2")
    monkeypatch.setattr(ml.MultiLayerNetwork, "_fit_batch", stop_after_three)
    assert main(common + ["--output", str(tmp_path / "two"), "--device",
                          "cpu", "--checkpoint-dir", ck]) == 0
    stopped = _last_json(capsys.readouterr().out)
    assert stopped["interrupted"] is True and stopped["checkpoint"] == ck
    monkeypatch.setattr(ml.MultiLayerNetwork, "_fit_batch", real)
    assert main(common + ["--output", str(tmp_path / "two"), "--device",
                          "cpu", "--checkpoint-dir", ck]) == 0
    two = _last_json(capsys.readouterr().out)
    assert two["resumed_from_step"] == 3
    a = checkpoint.load_network(str(tmp_path / "one"), device="cpu")
    b = checkpoint.load_network(str(tmp_path / "two"), device="cpu")
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    assert two["score"] == one["score"]
