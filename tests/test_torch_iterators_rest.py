"""The rest of the port's data path against the JAX package's.

`DataSet.copy`, `merge`, `binarize`, `split_test_and_train` and `sample`,
and the sampling, reconstruction, moving-window and test iterators of
`deeplearning4j_tpu_torch/datasets/` on numpy-seeded inputs, array for
array against `deeplearning4j_tpu/datasets/`. The port keeps each
example's label rows where labels hold several rows an example (the text:
scheme's windows, [B*T, V] labels for [B, T, V] features); there the
selected features equal JAX's and the labels are the selected examples'
row blocks (ROADMAP.md queue C). The CLI's reconstruction streams are held
to the JAX CLI's scores.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.datasets import dataset as jax_dataset  # noqa: E402
from deeplearning4j_tpu.datasets import iterator as jax_iterator  # noqa: E402,E501
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.cli.schemes import load_input  # noqa: E402
from deeplearning4j_tpu_torch.datasets import dataset, iterator  # noqa: E402
from deeplearning4j_tpu_torch.models import zoo  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    LayerType, LossFunction, MultiLayerConfiguration)


def _pair(n=12, d=16, classes=3, seed=0):
    """One seeded (features, one-hot labels) set in both packages."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32) - 0.3
    y = jax_dataset.labels_to_one_hot(rng.randint(0, classes, n), classes)
    return dataset.DataSet(x, y), jax_dataset.DataSet(x, y)


def _equal(got, want):
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)


def _windows(tmp_path, seq_len=6):
    """A text: window set: features [B, T, V], labels [B*T, V]."""
    rng = np.random.RandomState(3)
    words = ["tree", "leaf", "node", "root", "span"]
    path = tmp_path / "corpus.txt"
    path.write_text(" ".join(rng.choice(words) for _ in range(60)))
    data = load_input(f"text:{path}:{seq_len}")
    assert data.label_rows() == seq_len
    return data


def _blocks(data, idx):
    """The label rows of examples idx, in order."""
    k = data.label_rows()
    return np.concatenate([data.labels[i * k:(i + 1) * k] for i in idx])


def test_dataset_methods_equal_jax():
    ours, ref = _pair()
    _equal(ours.copy(), ref.copy())
    c = ours.copy()
    c.features[0, 0] = 99.0
    assert ours.features[0, 0] != 99.0  # a copy, not a view
    other, jother = _pair(n=5, seed=1)
    _equal(dataset.DataSet.merge([ours, other]),
           jax_dataset.DataSet.merge([ref, jother]))
    for threshold in (0.0, 0.25):
        _equal(ours.binarize(threshold), ref.binarize(threshold))
    for n_train, seed in ((8, 123), (3, 7), (12, 0)):
        for got, want in zip(ours.split_test_and_train(n_train, seed),
                             ref.split_test_and_train(n_train, seed)):
            _equal(got, want)
    for n, seed in ((5, 123), (30, 4)):  # 30 > 12: with replacement
        _equal(ours.sample(n, seed), ref.sample(n, seed))
    rows = list(ours)
    want_rows = list(ref)
    assert len(rows) == len(want_rows) == 12
    for got, want in zip(rows, want_rows):
        _equal(got, want)


def test_dataset_methods_keep_label_rows_of_windows(tmp_path):
    data = _windows(tmp_path)
    ref = jax_dataset.DataSet(data.features, data.labels)
    n = data.num_examples()
    k = data.label_rows()
    idx = np.random.RandomState(123).choice(n, size=4, replace=False)
    got = data.sample(4, seed=123)
    np.testing.assert_array_equal(got.features, ref.sample(4).features)
    np.testing.assert_array_equal(got.features, data.features[idx])
    np.testing.assert_array_equal(got.labels, _blocks(data, idx))
    perm = np.random.RandomState(5).permutation(n)
    train, test = data.split_test_and_train(3, seed=5)
    jtrain, jtest = ref.split_test_and_train(3, seed=5)
    np.testing.assert_array_equal(train.features, jtrain.features)
    np.testing.assert_array_equal(test.features, jtest.features)
    np.testing.assert_array_equal(train.labels, _blocks(data, perm[:3]))
    np.testing.assert_array_equal(test.labels, _blocks(data, perm[3:]))
    assert train.label_rows() == test.label_rows() == k
    merged = dataset.DataSet.merge([train, test])
    np.testing.assert_array_equal(merged.labels, _blocks(data, perm))
    assert merged.label_rows() == k
    first = next(iter(data))
    np.testing.assert_array_equal(first.labels, data.labels[:k])


def test_sampling_iterator_equals_jax():
    ours, ref = _pair(n=20)
    it = iterator.SamplingDataSetIterator(ours, 6, total_batches=4, seed=9)
    jit = jax_iterator.SamplingDataSetIterator(ref, 6, total_batches=4,
                                               seed=9)
    got, want = list(it), list(jit)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _equal(g, w)
    assert it.total_examples() == jit.total_examples() == 24
    assert it.input_columns() == 16 and it.total_outcomes() == 3
    # next(num) draws num rows from the same stream
    it2 = iterator.SamplingDataSetIterator(ours, 6, 4, seed=2)
    jit2 = jax_iterator.SamplingDataSetIterator(ref, 6, 4, seed=2)
    _equal(it2.next(3), jit2.next(3))
    _equal(it2.next(), jit2.next())
    assert it2.cursor == jit2.cursor == 9


def test_sampling_iterator_takes_window_label_rows(tmp_path):
    data = _windows(tmp_path)
    ref = jax_dataset.DataSet(data.features, data.labels)
    it = iterator.SamplingDataSetIterator(data, 3, 2, seed=11)
    jit = jax_iterator.SamplingDataSetIterator(ref, 3, 2, seed=11)
    rng = np.random.RandomState(11)
    for got, want in zip(it, jit):
        idx = rng.choice(data.num_examples(), size=3)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.labels, _blocks(data, idx))


def test_reconstruction_iterator_equals_jax():
    ours, ref = _pair(n=12)
    it = iterator.ReconstructionDataSetIterator(
        iterator.ListDataSetIterator(ours, 5))
    jit = jax_iterator.ReconstructionDataSetIterator(
        jax_iterator.ListDataSetIterator(ref, 5))
    got, want = list(it), list(jit)
    assert [b.num_examples() for b in got] == [5, 5, 2]
    for g, w in zip(got, want):
        _equal(g, w)
        np.testing.assert_array_equal(g.labels, g.features)
        assert g.labels is not g.features
    assert it.total_outcomes() == it.input_columns() == 16
    assert it.cursor == jit.cursor == 12
    it.reset()
    _equal(it.next(), want[0])


@pytest.mark.parametrize("rows, cols, rotate",
                         [(2, 2, True), (2, 2, False), (3, 3, True),
                          (2, 3, True), (6, 6, True)])
def test_moving_window_dataset_equals_jax(rows, cols, rotate):
    rng = np.random.RandomState(rows * 10 + cols)
    x = rng.rand(5, 36).astype(np.float32)
    y = jax_dataset.labels_to_one_hot(rng.randint(0, 4, 5), 4)
    got = iterator.moving_window_dataset(dataset.DataSet(x, y), rows, cols,
                                         rotate)
    want = jax_iterator.moving_window_dataset(jax_dataset.DataSet(x, y),
                                              rows, cols, rotate)
    _equal(got, want)
    assert got.features.dtype == np.float32


def test_moving_window_rejects_what_jax_rejects():
    ours, ref = _pair(n=2, d=16)
    for args in ((3, 3), (4, 3)):
        with pytest.raises(ValueError) as a:
            iterator.moving_window_dataset(ours, *args)
        with pytest.raises(ValueError) as b:
            jax_iterator.moving_window_dataset(ref, *args)
        assert str(a.value) == str(b.value)
    odd, jodd = _pair(n=2, d=15)
    with pytest.raises(ValueError, match="not square"):
        iterator.moving_window_dataset(odd, 3, 3)


def test_moving_window_iterator_equals_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(6, 36).astype(np.float32)
    y = jax_dataset.labels_to_one_hot(rng.randint(0, 2, 6), 2)
    it = iterator.MovingWindowBaseDataSetIterator(
        dataset.DataSet(x, y), 3, 3, batch_size=8)
    jit = jax_iterator.MovingWindowBaseDataSetIterator(
        jax_dataset.DataSet(x, y), 3, 3, batch_size=8)
    assert it.total_examples() == jit.total_examples() == 96
    assert it.input_columns() == 9
    got, want = list(it), list(jit)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _equal(g, w)


def test_test_iterator_records_what_it_served():
    ours, ref = _pair(n=11)
    it = iterator.TestDataSetIterator(iterator.ListDataSetIterator(ours, 4))
    jit = jax_iterator.TestDataSetIterator(
        jax_iterator.ListDataSetIterator(ref, 4))
    got, want = list(it), list(jit)
    assert len(it.served) == len(jit.served) == 3
    for g, w, s in zip(got, want, it.served):
        _equal(g, w)
        assert s is g
    assert it.cursor == jit.cursor == 11
    assert it.input_columns() == 16 and it.total_outcomes() == 3
    it.reset()
    assert it.cursor == 0 and it.has_next()


def test_iterators_are_exported_as_jax_exports_them():
    import deeplearning4j_tpu.datasets as jax_pkg
    import deeplearning4j_tpu_torch.datasets as pkg

    for name in ("DataSet", "DataSetIterator", "ListDataSetIterator",
                 "MultipleEpochsIterator", "SamplingDataSetIterator",
                 "TestDataSetIterator"):
        assert hasattr(jax_pkg, name) and hasattr(pkg, name), name
    assert pkg.ReconstructionDataSetIterator is \
        iterator.ReconstructionDataSetIterator


def _reconstruction_conf(tmp_path):
    """An MLP whose output reconstructs its 4 inputs (not a pretraining
    stack, so the CLI streams its batches)."""
    base = zoo.mlp(4, [3], 4, lr=0.1, iterations=2)
    out = base.confs[-1].replace(
        loss_function=LossFunction.RECONSTRUCTION_CROSSENTROPY)
    conf = MultiLayerConfiguration(confs=base.confs[:-1] + (out,),
                                   backprop=True)
    assert LayerType(str(conf.confs[-1].layer_type)) == LayerType.OUTPUT
    path = tmp_path / "rec.json"
    path.write_text(conf.to_json())
    return str(path)


def _csv01(tmp_path, rows=24, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(rows, 4)
    path = tmp_path / "rec.csv"
    with open(path, "w") as f:
        for row in x:
            f.write(",".join(f"{v:.5f}" for v in row) + ",0\n")
    return str(path)


@pytest.mark.parametrize("extra", [["--properties", "epochs=2,batch=10"],
                                   ["--properties", "epochs=2,batch=10",
                                    "--checkpoint-dir", "CKPT"]],
                         ids=["batched", "checkpointed"])
def test_cli_reconstruction_streams_score_as_jax(tmp_path, capsys, extra):
    """The CLI's reconstruction batches come through
    ReconstructionDataSetIterator, as the JAX CLI's do: the trained score
    equals the JAX CLI's on the same conf, data and batches."""
    conf, data = _reconstruction_conf(tmp_path), _csv01(tmp_path)
    scores = []
    for name, fn, dev in (("port", main, ["--device", "cpu"]),
                          ("jax", jax_main, [])):
        args = [a.replace("CKPT", str(tmp_path / f"ck_{name}"))
                for a in extra]
        assert fn(["train", "--input", data, "--model", conf, "--output",
                   str(tmp_path / name), *args, *dev]) == 0
        out = capsys.readouterr().out
        scores.append(json.loads(out.strip().splitlines()[-1])["score"])
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5)
