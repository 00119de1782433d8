"""The port's CLI (`train`, `test`, `predict`) vs the JAX package's.

Inputs are a small word corpus built from a numpy seed, as bench.py builds
its CLI corpus, and a CSV drawn from a seed. Checkpoints cross both ways:
the port's `train --device cpu` writes what JAX `checkpoint.load` reads, and
the port's `predict` and `test` read what JAX `cli train` wrote and answer
as JAX `cli predict` and `cli test` do (probabilities to the CSV's 6
decimals, accuracy and F1 exactly).
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.cli.schemes import load_input as jax_load_input  # noqa: E402,E501
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.cli.schemes import load_input  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    LayerType, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.parallel.checkpoint import load_network  # noqa: E402,E501

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dogs",
         "and", "cats", "read", "write", "code", "tpu"]


def _corpus(tmp_path, chars=400, seed=0):
    rng = np.random.RandomState(seed)
    text = " ".join(rng.choice(WORDS) for _ in range(chars // 5))[:chars]
    path = tmp_path / "corpus.txt"
    path.write_text(text)
    return f"text:{path}:8"


def _csv(tmp_path, rows=30, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((rows, 4))
    y = (x[:, 0] + x[:, 1] > 0).astype(int) + (x[:, 2] > 1).astype(int)
    path = tmp_path / "data.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for row, label in zip(x, y):
            w.writerow([f"{v:.5f}" for v in row] + [label])
    return str(path)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    header = rows[0]
    preds = np.asarray([int(r[0]) for r in rows[1:]])
    probs = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]])
    return header, preds, probs


def test_text_and_csv_inputs_equal_jax(tmp_path):
    for uri in (_corpus(tmp_path), "csv:" + _csv(tmp_path), _csv(tmp_path)):
        got, want = load_input(uri), jax_load_input(uri)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.labels, want.labels)
    got, want = load_input(_corpus(tmp_path)), jax_load_input(
        _corpus(tmp_path))
    assert got.vocab_size == want.vocab_size
    assert got.char_index == want.char_index
    short = load_input(_corpus(tmp_path), num_examples=3)
    assert short.features.shape[0] == 3 and short.labels.shape[0] == 24


def test_train_on_cpu_writes_a_checkpoint_jax_reads(tmp_path, capsys):
    uri = _corpus(tmp_path)
    out = str(tmp_path / "lstm")
    assert main(["train", "--input", uri, "--zoo",
                 "char_lstm:layers=2,hidden=16", "--properties", "epochs=2",
                 "--output", out, "--device", "cpu"]) == 0
    info = _last_json(capsys.readouterr().out)
    assert info["saved"] == out and np.isfinite(info["score"])
    assert info["train_seconds"] > 0 and info["examples_per_sec"] > 0
    jconf = jax_conf.MultiLayerConfiguration.from_json(
        open(f"{out}/conf.json").read())
    assert [str(c.layer_type) for c in jconf.confs] == \
        ["lstm", "lstm", "output"]
    jparams, _, meta = jax_checkpoint.load(
        out, like_params=jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    assert meta["metadata"]["score"] == info["score"]
    x = load_input(uri).features
    net = load_network(out, device="cpu")
    want = jax_ml.network_output(jconf, jparams, jnp.asarray(x))
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(net.score(x, load_input(uri).labels),
                               info["score"], rtol=1e-6)


def test_train_in_batches_and_embedding_nets_take_ids(tmp_path, capsys):
    uri = _corpus(tmp_path)
    out = str(tmp_path / "tf")
    # a char transformer starts with an embedding: one-hot windows become
    # ids; batch=5 goes through the prefetcher with the label rows of
    # each window
    assert main(["train", "--input", uri, "--zoo",
                 "char_transformer:d_model=16,blocks=1,heads=2,seq_len=8",
                 "--properties", "epochs=1,batch=5", "--output", out,
                 "--device", "cpu"]) == 0
    info = _last_json(capsys.readouterr().out)
    assert np.isfinite(info["score"])
    net = load_network(out, device="cpu")
    assert LayerType(str(net.conf.conf(0).layer_type)) == \
        LayerType.EMBEDDING


def _jax_trained(tmp_path, capsys, uri, argv_extra):
    out = str(tmp_path / "jax_ckpt")
    assert jax_main(["train", "--input", uri, "--output", out,
                     *argv_extra]) == 0
    capsys.readouterr()
    return out


def _run(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("kind", ["text", "csv"])
def test_predict_and_test_match_jax_cli(tmp_path, capsys, kind):
    if kind == "text":
        uri = _corpus(tmp_path)
        ckpt = _jax_trained(tmp_path, capsys, uri,
                            ["--zoo", "char_lstm:layers=2,hidden=16"])
    else:
        uri = "csv:" + _csv(tmp_path)
        conf = MultiLayerConfiguration(confs=(
            NeuralNetConfiguration(layer_type=LayerType.DENSE, n_in=4,
                                   n_out=8, activation="tanh", lr=0.1),
            NeuralNetConfiguration(layer_type=LayerType.OUTPUT, n_in=8,
                                   n_out=3, activation="softmax",
                                   loss_function="mcxent", lr=0.1)))
        conf_path = tmp_path / "conf.json"
        conf_path.write_text(conf.to_json())
        ckpt = _jax_trained(tmp_path, capsys, uri,
                            ["--model", str(conf_path), "--normalize"])
    norm = ["--normalize"] if kind == "csv" else []
    for batch in ("0", "5"):
        common = ["--input", uri, "--model", ckpt, "--batch", batch, *norm]
        _run(jax_main, ["predict", *common, "--output",
                        str(tmp_path / "jax.csv")], capsys)
        info = _last_json(_run(main, ["predict", *common, "--output",
                                      str(tmp_path / "port.csv"),
                                      "--device", "cpu"], capsys))
        jh, jpred, jprob = _read_csv(tmp_path / "jax.csv")
        th, tpred, tprob = _read_csv(tmp_path / "port.csv")
        assert th == jh and info["n"] == len(jpred)
        assert info["written"] == str(tmp_path / "port.csv")
        np.testing.assert_array_equal(tpred, jpred)
        np.testing.assert_allclose(tprob, jprob, atol=2e-6, rtol=0)
    plain = ["predict", "--input", uri, "--model", ckpt, *norm]
    assert _run(main, plain + ["--device", "cpu"], capsys).split() == \
        _run(jax_main, plain, capsys).split()
    # test: one batch (the JAX package's batching pairs text windows with
    # the wrong label rows, ROADMAP.md queue C)
    test = ["test", "--input", uri, "--model", ckpt, *norm]
    want = _last_json(_run(jax_main, test + ["--batch", "0"], capsys))
    got_out = _run(main, test + ["--batch", "0", "--device", "cpu"], capsys)
    got = _last_json(got_out)
    assert (got["accuracy"], got["f1"]) == (want["accuracy"], want["f1"])
    assert "Accuracy:" in got_out
    # and the port's batched evaluation counts the same
    batched = _last_json(_run(main, test + ["--batch", "3", "--device",
                                            "cpu"], capsys))
    assert batched == got


@pytest.mark.parametrize("extra,item", [
    (["--runtime", "mesh"], "item 10"), (["--mesh"], "item 10"),
    (["--mesh", "batch=2"], "item 10"), (["--zero1"], "item 10"),
    (["--mesh", "batch=2", "--checkpoint-dir", "ck"], "item 10"),
    (["--compile-cache", "cc"], "item 11")])
def test_unported_train_options_name_their_roadmap_item(tmp_path, capsys,
                                                        monkeypatch, extra,
                                                        item):
    """The item-10 cases are ported now (each exited naming item 10
    before): `--runtime mesh` and bare `--mesh` train the char-LSTM on
    text windows through the data-parallel trainer and write the conf.json
    of JAX's `train`; at world size 1
    `--mesh batch=2` (with or without `--checkpoint-dir`) exits as the JAX
    CLI's mesh does with too few devices ("needs 2 ..., have 1"), and
    `--zero1` without the mesh runtime exits with the JAX CLI's own
    message. The item-11 case is ported too (it exited naming item 11):
    `--compile-cache` attaches the persistent store, whose directory the
    train JSON's `disk_cache` names, as the JAX CLI's does."""
    uri = _corpus(tmp_path)
    argv = ["train", "--input", uri, "--zoo", "char_lstm:hidden=16",
            "--output", str(tmp_path / "o"), *extra]
    if item == "item 11":
        monkeypatch.chdir(tmp_path)  # the store's relative directory
        out = _last_json(_run(main, argv + ["--device", "cpu"], capsys))
        jax_out = _last_json(_run(jax_main, argv, capsys))
        assert out["disk_cache"]["dir"] == jax_out["disk_cache"]["dir"] \
            == os.path.abspath("cc")
        assert out["disk_cache"]["disk_hits"] == 0
        assert np.isfinite(out["score"])
    elif "batch=2" in extra:
        with pytest.raises(SystemExit, match="needs 2 ranks, have 1"):
            main(argv + ["--device", "cpu"])
    elif extra == ["--zero1"]:
        with pytest.raises(SystemExit) as want:
            jax_main(argv)
        with pytest.raises(SystemExit) as got:
            main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
    else:
        out = _last_json(_run(main, argv + ["--device", "cpu"], capsys))
        assert out["cache_misses"] >= 1 and np.isfinite(out["score"])
        # JAX's conf from its local runtime: its mesh runtime cannot take
        # text windows (DataSet.get, ROADMAP.md queue C reference faults)
        jax_out = tmp_path / "jax"
        _run(jax_main, ["train", "--input", uri, "--zoo",
                        "char_lstm:hidden=16", "--output", str(jax_out)],
             capsys)
        assert ((tmp_path / "o" / "conf.json").read_text()
                == (jax_out / "conf.json").read_text())


@pytest.mark.parametrize("command", ["train", "test", "predict", "generate",
                                     "serve", "warmup"])
def test_compile_cache_attaches_one_store(tmp_path, capsys, monkeypatch,
                                          command):
    """`--compile-cache DIR` on every command the JAX CLI takes it on
    attaches one persistent store at DIR to the network (and its two
    caches share it); the command runs to its end."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    uri = "csv:" + _csv(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    assert main(["train", "--input", uri, "--zoo", "mlp:hidden=8",
                 "--output", ckpt, "--device", "cpu"]) == 0
    if command in ("generate", "serve", "warmup"):
        lm = str(tmp_path / "lm")
        assert main(["train", "--input", _corpus(tmp_path), "--zoo",
                     "char_transformer:d_model=16,blocks=1,heads=2",
                     "--output", lm, "--device", "cpu"]) == 0
    capsys.readouterr()
    cache = str(tmp_path / "cache")
    attached = []
    real = MultiLayerNetwork.set_compile_cache

    def spy(self, directory, max_bytes=None):
        store = real(self, directory, max_bytes)
        attached.append((self, store))
        return store

    monkeypatch.setattr(MultiLayerNetwork, "set_compile_cache", spy)
    monkeypatch.setattr(ModelServer, "wait_for_stop", lambda self: None)
    argv = {"train": ["train", "--input", uri, "--zoo", "mlp:hidden=8",
                      "--output", str(tmp_path / "o")],
            "test": ["test", "--input", uri, "--model", ckpt],
            "predict": ["predict", "--input", uri, "--model", ckpt,
                        "--output", str(tmp_path / "p.csv")],
            "generate": ["generate", "--model", str(tmp_path / "lm"),
                         "--prompt", "1,2", "--max-new-tokens", "2",
                         "--max-seq", "8"],
            "serve": ["serve", "--model", str(tmp_path / "lm"), "--shapes",
                      "", "--port", "0"],
            "warmup": ["warmup", "--model", str(tmp_path / "lm"),
                       "--shapes", "1x8"]}[command]
    assert main(argv + ["--compile-cache", cache, "--device", "cpu"]) == 0
    assert len(attached) == 1
    net, store = attached[0]
    assert store.directory == os.path.abspath(cache)
    assert net.infer_cache.persist is net.step_cache.persist is store
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert any((line.get("disk_cache") or {}).get("dir") == store.directory
               for line in lines)


@pytest.mark.parametrize("flags", [["--runtime", "mesh"],
                                   ["--runtime", "mesh", "--zero1"],
                                   ["--mesh", "batch=1"]],
                         ids=["mesh", "zero1", "mesh_batch_1"])
def test_mesh_runtime_checkpoints_resumes_and_writes_jaxs_conf(
        tmp_path, capsys, monkeypatch, flags):
    """The JAX package's test_cli_mesh_checkpoint_resume_and_zero1 at world
    size 1: the data-parallel trainer checkpoints every 3 batches, a rerun
    resumes at the final cursor (9 batches of 16), a stop after 3 batches
    prints the `interrupted` line and the rerun ends bitwise where one run
    ends; the conf.json is the JAX CLI's under the same flags."""
    from deeplearning4j_tpu_torch.parallel import data_parallel

    argv = ["train", "--input", "iris:144", "--zoo", "mlp:hidden=8",
            "--normalize", "--properties",
            "epochs=1,batch=16,checkpoint_every=3", *flags]
    one, ck = str(tmp_path / "one"), str(tmp_path / "ck")
    port = argv + ["--device", "cpu", "--checkpoint-dir"]
    j = _last_json(_run(main, port + [ck, "--output", one], capsys))
    assert j["resumed_from_step"] is None
    assert j["checkpoint_write_seconds"] > 0
    assert j["cache_misses"] == 1 and j["cache_hits"] == 8
    j2 = _last_json(_run(main, port + [ck, "--output", one], capsys))
    assert j2["resumed_from_step"] == 9

    real = data_parallel.DataParallelTrainer.__init__

    class StopAfterThree:
        def iteration_done(self, model, iteration, score):
            if iteration == 3:
                model.request_stop_training()

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.listeners.append(StopAfterThree())

    ck2, two = str(tmp_path / "ck2"), str(tmp_path / "two")
    monkeypatch.setattr(data_parallel.DataParallelTrainer, "__init__", init)
    stopped = _last_json(_run(main, port + [ck2, "--output", two], capsys))
    assert stopped["interrupted"] is True and stopped["checkpoint"] == ck2
    monkeypatch.setattr(data_parallel.DataParallelTrainer, "__init__", real)
    j3 = _last_json(_run(main, port + [ck2, "--output", two], capsys))
    assert j3["resumed_from_step"] == 3 and j3["score"] == j["score"]
    a = load_network(one, device="cpu")
    b = load_network(two, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(
        jax.tree_util.tree_leaves(list(a.params)),
        jax.tree_util.tree_leaves(list(b.params))))

    jax_out = tmp_path / "jax"
    _run(jax_main, argv + ["--output", str(jax_out)], capsys)
    assert ((tmp_path / "one" / "conf.json").read_text()
            == (jax_out / "conf.json").read_text())


def test_mesh_runtime_refuses_pretraining_recipes_as_jax(tmp_path):
    argv = ["train", "--input", "iris:", "--zoo", "dbn:hidden=4",
            "--scale-01", "--output", str(tmp_path / "o"), "--runtime",
            "mesh"]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "--runtime local" in str(got.value)


def test_a_model_axis_exits_naming_item_10b(tmp_path, capsys):
    """A model axis trains now (it exited naming item 10b before): `--mesh
    batch=1,model=1` at one rank runs the tensor-parallel trainer and
    writes the conf.json of JAX's `train` under the same flag; a mesh
    whose sizes need more ranks than the group has exits as JAX's does
    with too few devices (tests/test_torch_tp_ranks.py trains at 4)."""
    argv = ["train", "--input", "iris:", "--zoo", "mlp:hidden=8",
            "--output", str(tmp_path / "o"), "--mesh", "batch=1,model=1"]
    out = _last_json(_run(main, argv + ["--device", "cpu"], capsys))
    assert np.isfinite(out["score"]) and out["cache_misses"] >= 1
    _run(jax_main, argv[:-4] + ["--output", str(tmp_path / "jax"),
                                "--mesh", "batch=1,model=1"], capsys)
    assert ((tmp_path / "o" / "conf.json").read_text()
            == (tmp_path / "jax" / "conf.json").read_text())
    with pytest.raises(SystemExit, match="needs 2 ranks"):
        main(argv[:-1] + ["batch=1,model=2", "--device", "cpu"])


def _two_ranks(argv):
    """The port's CLI on two gloo ranks (torchrun's environment: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=root)
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli"] + argv,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]


def _ended(procs, timeout=120):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except Exception:  # noqa: BLE001 — a hung rank: end them all
            for q in procs:
                q.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    assert all(rc == 0 for rc, _, _ in outs), outs
    return outs


@pytest.mark.parametrize("command", ["serve", "generate"])
def test_serve_and_generate_mesh_answer_as_one_rank(tmp_path, capsys,
                                                    monkeypatch, command):
    """`serve --mesh` and `generate --mesh` at batch=1,model=2 over two
    gloo ranks: the
    charTransformer's heads split over the ranks, rank 0 answers POST
    /v1/predict as the one-rank server does (rtol 1e-5, atol 1e-6: the
    split sums in another order) and generates the one-rank tokens, and
    rank 1 prints nothing and exits when rank 0 ends."""
    import signal

    from deeplearning4j_tpu_torch.serving.server import ModelServer

    jconf = jax_conf.MultiLayerConfiguration.from_json(_zoo_json(
        "char_transformer:d_model=16,blocks=1,heads=2,seq_len=16"))
    ckpt = str(tmp_path / "ckpt")
    jax_checkpoint.save(ckpt, jax_ml.init_params(jconf,
                                                 jax.random.PRNGKey(0)),
                        conf=jconf)
    mesh = ["--mesh", "batch=1,model=2", "--device", "cpu"]
    if command == "generate":
        argv = ["generate", "--model", ckpt, "--prompt", "1,2,3",
                "--max-new-tokens", "8", "--max-seq", "16"]
        assert main(argv + ["--device", "cpu"]) == 0
        want = _last_json(capsys.readouterr().out)["tokens"]
        outs = _ended(_two_ranks(argv + mesh))
        assert _last_json(outs[0][1])["tokens"] == want and len(want) == 8
        assert outs[1][1] == ""
        return
    x = np.random.RandomState(0).randint(0, 5, (3, 8))
    body = {"features": x.tolist(), "dtype": "int32"}
    argv = ["serve", "--model", ckpt, "--port", "0", "--shapes", "2x8"]
    seen = {}
    monkeypatch.setattr(ModelServer, "wait_for_stop", lambda self: seen.update(
        answer=_post_json(self.url + "/v1/predict", body)))
    assert main(argv + ["--device", "cpu"]) == 0
    procs = _two_ranks(argv + mesh)
    startup = json.loads(procs[0].stdout.readline())
    assert startup["plan"] == {"axes": ["batch", "model"],
                               "shape": {"batch": 1, "model": 2},
                               "policy": "f32"}
    got = _post_json(startup["url"] + "/v1/predict", body)
    procs[0].send_signal(signal.SIGTERM)
    outs = _ended(procs)
    assert json.loads(outs[0][1].splitlines()[-1])["drained"]
    assert outs[1][1] == ""
    np.testing.assert_allclose(np.asarray(got["output"]),
                               np.asarray(seen["answer"]["output"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("zoo_name", ["lenet5", "mlp", "vgg_cifar10", "dbn",
                                      "deep_autoencoder"])
def test_zoo_models_train_with_jaxs_conf(tmp_path, capsys, monkeypatch,
                                         zoo_name):
    """Every --zoo model is ported (each exited naming item 9 before): each
    builds JAX's conf and trains (the conv nets on the MNIST and CIFAR
    stand-ins, tests/test_torch_conv.py holding them to the JAX CLI; the
    pretraining recipes on Iris in [0, 1], tests/test_torch_pretrain.py
    holding them to JAX)."""
    from deeplearning4j_tpu.models import zoo as jax_zoo

    monkeypatch.setenv("HOME", str(tmp_path))
    for var in ("MNIST_DIR", "DL4J_MNIST_URL", "CIFAR10_DIR"):
        monkeypatch.delenv(var, raising=False)
    ported = {
        "mlp": ("csv:" + _csv(tmp_path), "mlp:hidden=8x4",
                lambda: jax_zoo.mlp(4, [8, 4], 3, lr=0.05)),
        "lenet5": ("mnist:16", "lenet5", lambda: jax_zoo.lenet5(lr=0.05)),
        "vgg_cifar10": ("cifar10:16", "vgg_cifar10:width=4",
                        lambda: jax_zoo.vgg_cifar10(lr=0.05, width=4)),
        "dbn": ("iris:", "dbn:hidden=8x4,iterations=3,finetune=5",
                lambda: jax_zoo.dbn(4, [8, 4], 3, lr=0.05, iterations=3,
                                    finetune_iterations=5)),
        "deep_autoencoder": (
            "iris:", "deep_autoencoder:hidden=3,iterations=3,finetune=5",
            lambda: jax_zoo.deep_autoencoder(4, hidden=[3], lr=0.05,
                                             iterations=3,
                                             finetune_iterations=5))}
    uri, spec, want_conf = ported[zoo_name]
    out = str(tmp_path / "o")
    assert main(["train", "--input", uri, "--zoo", spec, "--scale-01",
                 "--output", out, "--device", "cpu"]) == 0
    assert np.isfinite(_last_json(capsys.readouterr().out)["score"])
    want = jax_conf.MultiLayerConfiguration.from_json(
        open(f"{out}/conf.json").read())
    assert want.to_json() == want_conf().to_json()


def test_pretraining_conf_and_builtin_datasets_train_as_jax(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """A `pretrain` conf trains (it exited naming item 9 before): here one
    CG output layer, nothing to pretrain, to the score JAX's CLI reaches
    from the same initial params (rtol 1e-4). The builtin datasets are
    ported (they raised naming item 6 before): each loads the JAX
    package's arrays (tests/test_torch_datasets.py holds every scheme)."""
    conf = MultiLayerConfiguration(confs=(
        NeuralNetConfiguration(layer_type=LayerType.OUTPUT, n_in=4, n_out=3,
                               num_iterations=20),
    ), pretrain=True)
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(conf.to_json())
    _carry_jax_init(monkeypatch)
    argv = ["train", "--input", "csv:" + _csv(tmp_path), "--model",
            str(conf_path)]
    got = _last_json(_run(main, argv + ["--output", str(tmp_path / "o"),
                                        "--device", "cpu"], capsys))
    want = _last_json(_run(jax_main, argv + ["--output",
                                             str(tmp_path / "j")], capsys))
    assert np.isfinite(got["score"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4)
    for name in ("mnist:30", "iris:20", "cifar10:12"):
        got, want = load_input(name), jax_load_input(name)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(SystemExit, match="--model"):
        main(["train", "--input", _corpus(tmp_path), "--output",
              str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(ValueError, match="unrecognized"):
        load_input("parquet:x")


def _carry_jax_init(monkeypatch):
    """The port's `MultiLayerNetwork.init` draws the JAX package's initial
    params for the same conf and seed (the generators differ), so a CLI
    run starts where the JAX CLI's does."""
    from deeplearning4j_tpu_torch.nn import multilayer as port_ml
    from deeplearning4j_tpu_torch.parallel.checkpoint import params_from_numpy

    real_init = port_ml.MultiLayerNetwork.init

    def init(self):
        real_init(self)
        jconf = jax_conf.MultiLayerConfiguration.from_json(
            self.conf.to_json())
        jnet = jax_ml.MultiLayerNetwork(jconf, seed=self.seed).init()
        self.params = params_from_numpy(jax.device_get(jnet.params),
                                        self.device)
        return self

    monkeypatch.setattr(port_ml.MultiLayerNetwork, "init", init)


@pytest.mark.parametrize("props", ["epochs=1", "epochs=2,batch=40"])
def test_train_zoo_mlp_on_mnist_gives_jaxs_score(tmp_path, capsys,
                                                 monkeypatch, props):
    """`train --zoo mlp --input mnist:n`: the MNIST stand-in, the JAX
    package's conf and initial params; the score within rtol 1e-4 (the
    f32 score tolerance of tests/test_torch_training.py), and `test`
    reports JAX's accuracy on the same checkpoint."""
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.delenv("DL4J_MNIST_URL", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    _carry_jax_init(monkeypatch)
    common = ["train", "--input", "mnist:120", "--zoo", "mlp:hidden=32x16",
              "--properties", props]
    want = _last_json(_run(jax_main, common + ["--output",
                                               str(tmp_path / "j")], capsys))
    got = _last_json(_run(main, common + ["--output", str(tmp_path / "t"),
                                          "--device", "cpu"], capsys))
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4)
    conf = open(tmp_path / "t" / "conf.json").read()
    assert conf == open(tmp_path / "j" / "conf.json").read()
    test = ["test", "--input", "mnist:120", "--batch", "0"]
    jt = _last_json(_run(jax_main, test + ["--model", str(tmp_path / "j")],
                         capsys))
    tt = _last_json(_run(main, test + ["--model", str(tmp_path / "t"),
                                       "--device", "cpu"], capsys))
    assert tt["accuracy"] == jt["accuracy"]


def test_serve_shapes_warm_before_listening(tmp_path, capsys, monkeypatch):
    """`serve --shapes 2x8,4x8` captures its buckets before the socket
    opens (the JAX CLI's shapes); an embedding net is warmed with int32
    ids, so a request replays and captures nothing (the JAX CLI warms
    float32 there, which int32 requests miss: ROADMAP.md, reference
    faults). `--no-batching` and `--default-deadline-ms` reach the
    server."""
    from deeplearning4j_tpu.cli import driver as jax_driver
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    jconf = jax_conf.MultiLayerConfiguration.from_json(
        _zoo_json("char_transformer:d_model=16,blocks=1,heads=2,seq_len=8"))
    ckpt = str(tmp_path / "ckpt")
    jax_checkpoint.save(ckpt, jax_ml.init_params(jconf,
                                                 jax.random.PRNGKey(0)),
                        conf=jconf)
    argv = ["serve", "--model", ckpt, "--port", "0", "--shapes", "2x8,4x8"]
    seen = {}
    real_start = ModelServer.start

    def start(self):
        seen["misses_at_start"] = self.net.infer_cache.stats.misses
        seen["batching"] = self.batching
        seen["default_deadline_ms"] = self.default_deadline_ms
        return real_start(self)

    def traffic(self):
        x = np.random.RandomState(0).randint(0, 5, (3, 8))
        seen["answer"] = _post_json(self.url + "/v1/predict",
                                    {"features": x.tolist(),
                                     "dtype": "int32"})
        seen["stats"] = self.stats()

    monkeypatch.setattr(ModelServer, "start", start)
    monkeypatch.setattr(ModelServer, "wait_for_stop", traffic)
    assert main(argv + ["--device", "cpu", "--default-deadline-ms",
                        "5000"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    startup = lines[0]
    assert startup["warmed"] == [[2, 8], [4, 8]]
    assert startup["batching"] is True and lines[-1]["drained"]
    assert seen["misses_at_start"] == startup["fresh_compiles"] == 2
    assert seen["default_deadline_ms"] == 5000.0
    assert seen["stats"]["fresh_compiles"] == 2  # the request replayed
    assert len(seen["answer"]["output"]) == 3 * 8
    jargs = jax_driver.build_parser().parse_args(argv)
    _, jserver, summary = jax_driver._build_server(jargs)
    jserver.stop()
    assert [list(s) for s in summary["warmed"]] == startup["warmed"]
    assert main(argv + ["--device", "cpu", "--no-batching"]) == 0
    assert seen["batching"] is False
    assert seen["stats"]["requests"] == 0
    assert json.loads(capsys.readouterr().out.splitlines()[0])[
        "batching"] is False


def _zoo_json(spec):
    from deeplearning4j_tpu_torch.cli.driver import _zoo_conf

    class _Data:
        vocab_size = 5
        features = np.zeros((1, 8, 5), np.float32)

    return _zoo_conf(spec, _Data()).to_json()


def _post_json(url, body):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_jax_warmup_of_an_embedding_net_misses_its_int32_requests():
    """The reference fault the port's `warmup` avoids: the JAX package
    warms a tuple shape with float32 zeros, so an embedding net's int32 id
    requests miss the warmed program and compile under traffic; the port
    warms int32 ids and its requests hit."""
    from deeplearning4j_tpu.models import zoo as jax_zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jconf = jax_zoo.char_transformer(13, d_model=16, n_blocks=1, n_heads=2,
                                     max_seq_len=8)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", seed=0).init()
    ids = np.random.RandomState(0).randint(0, 13, (2, 8)).astype(np.int32)
    misses = []
    for net in (jnet, tnet):
        net.warmup([(2, 8)])
        before = net.infer_cache.stats.misses
        net.output(ids)
        misses.append(net.infer_cache.stats.misses - before)
    assert misses == [1, 0]
