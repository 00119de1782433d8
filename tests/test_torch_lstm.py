"""The port's char-LSTM slice vs the JAX package.

The fused cell (its plain version, which CPU tensors take), its autograd
function, the LSTM and GravesLSTM layers, a small char-LSTM net (vocab 24,
embed 16, 2 layers of 24, seq 8, 4 rows) in f32 and under bf16 compute,
`fit`, `evaluate`, `CharLSTM` decoding, the data iterators and checkpoints
both ways. Inputs and weights come from numpy seeds and cross as numpy
arrays; the JAX package's Pallas cell runs in interpret mode. Tolerances:
the cell, the layers and the f32 net 1e-5; gradients rtol 1e-4 and atol
1e-5; bf16 compute 2e-2 (outputs) and 2e-2 * max|g| (gradients); `fit`
trajectories 1e-5 (bf16 compute 2e-2); decoding token-identical,
log-probabilities 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet  # noqa: E402,E501
from deeplearning4j_tpu.evaluation import Evaluation as JaxEvaluation  # noqa: E402,E501
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.models.char_lstm import CharLSTM as JaxCharLSTM  # noqa: E402,E501
from deeplearning4j_tpu.nd.pallas_kernels import \
    fused_lstm_step as jax_fused_lstm_step  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.nn.layers import get_layer as jax_get_layer  # noqa: E402,E501
from deeplearning4j_tpu.optimize import listeners as jax_listeners  # noqa: E402,E501
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.datasets import (  # noqa: E402
    DataSet, DeviceBatch, ListDataSetIterator, MultipleEpochsIterator,
    PrefetchIterator, labels_to_one_hot)
from deeplearning4j_tpu_torch.evaluation import Evaluation  # noqa: E402
from deeplearning4j_tpu_torch.models import zoo  # noqa: E402
from deeplearning4j_tpu_torch.models.char_lstm import CharLSTM  # noqa: E402
from deeplearning4j_tpu_torch.nd import kernels  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    LayerType, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers import get_layer  # noqa: E402
from deeplearning4j_tpu_torch.optimize import listeners, solver  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402

VOCAB, EMBED, HIDDEN, LAYERS, ROWS, SEQ = 24, 16, 24, 2, 4, 8
TOL = {"": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol, rtol=None):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol if rtol is None else rtol,
        atol=tol)


def _cell_inputs(seed, b, i, h):
    """x, h, c, wx, wh, b as numpy f32, the scales of the JAX test."""
    rng = np.random.RandomState(seed)
    f = (lambda *s: rng.standard_normal(s).astype(np.float32))
    return (f(b, i), f(b, h), f(b, h), 0.1 * f(i, 4 * h), 0.1 * f(h, 4 * h),
            0.1 * f(4 * h))


# -------------------------------------------------------------------- cell

# the last is the CLI north star's cell (2047 windows, 27 characters, 128
# hidden): B and K = I + H are multiples of no tile of the kernel
@pytest.mark.parametrize("shape", [(4, 8, 16), (3, 7, 20), (5, 27, 12),
                                   (2047, 27, 128)])
def test_fused_lstm_step_matches_jax(shape):
    arrs = _cell_inputs(0, *shape)
    want = jax_fused_lstm_step(*(jnp.asarray(a) for a in arrs),
                               interpret=True)
    got = kernels.fused_lstm_step(*(torch.from_numpy(a) for a in arrs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        _close(g, w, 1e-5)
    # the wrapper itself takes the plain version on CPU tensors
    again = kernels.lstm_cell(*(torch.from_numpy(a) for a in arrs))
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert kernels.LAUNCHES["lstm_cell"] == 0


# The bf16 kernel body's order of sums (csrc/lstm_cell.cu,
# lstm_cell_bf16_kernel): each of its K slices (4 or 8 warps) sums its
# 32-deep tiles of x.Wx or h.Wh in f32 apart, the first nx slices taking
# x.Wx and the others h.Wh (nx as the launch splits them), and the slices
# meet in a fixed order, z = ((x.Wx slices) + (h.Wh slices)) + b, before
# the cell in f32 and one rounding of h' and c' to bf16. Held to the JAX
# package's Pallas cell in bf16 (interpret mode) at 2e-2 * max, the
# tolerance the card's check uses for the bf16 cell.

def _split_slices(slices, tx, th):
    """The launch's split of `slices` between x.Wx (tx tiles) and h.Wh (th
    tiles): the x slices that leave the largest slice the fewest tiles."""
    best, nx = None, 1
    for cand in range(1, slices):
        most = max(-(-tx // cand), -(-th // (slices - cand)))
        if best is None or most < best:
            best, nx = most, cand
    return nx


def _bf16_cell_model(x, h, c, wx, wh, b, slices, tile=32):
    n_in, n_h = x.shape[1], h.shape[1]
    tx, th = -(-n_in // tile), -(-n_h // tile)
    nx = _split_slices(slices, tx, th)
    parts = []
    for src, w, k, tiles, n in ((x, wx, n_in, tx, nx),
                                (h, wh, n_h, th, slices - nx)):
        part = []
        for j in range(n):
            lo = j * tiles // n * tile
            hi = min((j + 1) * tiles // n * tile, k)
            part.append(src[:, lo:hi].float() @ w[lo:hi].float()
                        if hi > lo else
                        torch.zeros(x.shape[0], 4 * n_h))
        parts.append(part)
    zx, zh = parts[0][0], parts[1][0]
    for p in parts[0][1:]:
        zx = zx + p
    for p in parts[1][1:]:
        zh = zh + p
    z = (zx + zh) + b.float()
    i, f, o = (torch.sigmoid(z[:, g * n_h:(g + 1) * n_h]) for g in range(3))
    g = torch.tanh(z[:, 3 * n_h:])
    c_new = f * c.float() + i * g
    return (o * torch.tanh(c_new)).to(h.dtype), c_new.to(c.dtype)


@pytest.mark.parametrize("slices", [4, 8])
@pytest.mark.parametrize("shape", [(256, 256, 256), (2047, 27, 128),
                                   (3, 7, 20)])
def test_bf16_cell_slice_model_holds_the_jax_cell(shape, slices):
    arrs = [torch.from_numpy(a).to(torch.bfloat16)
            for a in _cell_inputs(25, *shape)]
    got = _bf16_cell_model(*arrs, slices)
    want = jax_fused_lstm_step(
        *(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in arrs),
        interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 2e-2 * float(np.abs(w).max())
    # and the plain version the card's check holds the kernel to
    for g, w in zip(got, kernels.lstm_cell_reference(*arrs)):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item()


@pytest.mark.parametrize("views", [False, True])
def test_lstm_cell_function_grads_match_jax(views):
    b, i, h = 3, 7, 20
    x, h0, c0, wx, wh, bias = _cell_inputs(1, b, i, h)
    rng = np.random.RandomState(2)
    gh = rng.standard_normal((b, h)).astype(np.float32)
    gc = rng.standard_normal((b, h)).astype(np.float32)
    w = np.concatenate([wx, wh])

    def jax_obj(x, h0, c0, w, bias):
        hn, cn = jax_fused_lstm_step(x, h0, c0, w[:i], w[i:], bias,
                                     interpret=True)
        return jnp.sum(hn * gh) + jnp.sum(cn * gc)

    want = jax.grad(jax_obj, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, h0, c0, w, bias)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, h0, c0, w, bias)]
    tx, th, tc, tw, tb = leaves
    if views:  # the layer's layout: row blocks of one fused W
        twx, twh = tw[:i], tw[i:]
    else:
        twx = tw[:i].detach().clone().requires_grad_()
        twh = tw[i:].detach().clone().requires_grad_()
    hn, cn = kernels.LSTMCellFunction.apply(tx, th, tc, twx, twh, tb)
    (hn * torch.from_numpy(gh)).sum().backward(inputs=[tx, th, tc, tb] + (
        [tw] if views else [twx, twh]), retain_graph=True)
    (cn * torch.from_numpy(gc)).sum().backward(inputs=[tx, th, tc, tb] + (
        [tw] if views else [twx, twh]))
    got_w = tw.grad if views else torch.cat([twx.grad, twh.grad])
    for g, wnt in zip((tx.grad, th.grad, tc.grad, got_w, tb.grad), want):
        _close(g, wnt, 1e-5, rtol=1e-4)


def test_lstm_cell_function_skips_gradients_nobody_asks_for():
    arrs = [torch.from_numpy(a) for a in _cell_inputs(3, 2, 5, 6)]
    w = arrs[3].requires_grad_()
    hn, cn = kernels.fused_lstm_step(*arrs)
    (g,) = torch.autograd.grad(hn.sum() + cn.sum(), [w])
    assert g.shape == w.shape and torch.isfinite(g).all()
    with torch.no_grad():  # no grad: the wrapper alone, no graph
        assert kernels.fused_lstm_step(*arrs)[0].grad_fn is None


def test_lstm_cell_plain_version_rounds_once_to_bf16():
    arrs = [torch.from_numpy(a) for a in _cell_inputs(4, 3, 8, 16)]
    bf = [a.to(torch.bfloat16) for a in arrs]
    hn, cn = kernels.lstm_cell_reference(*bf)
    assert hn.dtype == cn.dtype == torch.bfloat16
    want = kernels.lstm_cell_reference(*(a.float() for a in bf))
    assert torch.equal(hn, want[0].to(torch.bfloat16))
    assert torch.equal(cn, want[1].to(torch.bfloat16))


# ------------------------------------------------------------------ layers

def _layer_confs(layer_type, impl, n_in=8, n_out=12):
    jc = jax_conf.NeuralNetConfiguration(layer_type=layer_type, n_in=n_in,
                                         n_out=n_out, lstm_impl=impl)
    tc = MultiLayerConfiguration.from_json(
        jax_conf.MultiLayerConfiguration(confs=(jc,)).to_json()).conf(0)
    return jc, tc


def _layer_params(layer_type, n_in=8, n_out=12, seed=5):
    rng = np.random.RandomState(seed)
    p = {"W": 0.3 * rng.standard_normal((n_in + n_out, 4 * n_out)),
         "b": 0.1 * rng.standard_normal(4 * n_out)}
    if layer_type == "graves_lstm":  # non-zero peepholes
        for name in ("p_i", "p_f", "p_o"):
            p[name] = 0.5 * rng.standard_normal(n_out)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("rank", [3, 2])
@pytest.mark.parametrize("layer_type,impl", [("lstm", "scan"),
                                             ("lstm", "fused"),
                                             ("lstm", "auto"),
                                             ("graves_lstm", "auto")])
def test_lstm_layers_forward_matches_jax(layer_type, impl, rank):
    jc, tc = _layer_confs(layer_type, impl)
    p = _layer_params(layer_type)
    shape = (3, 5, 8) if rank == 3 else (5, 8)
    x = np.random.RandomState(6).standard_normal(shape).astype(np.float32)
    want = jax_get_layer(jc.layer_type).forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jc, jnp.asarray(x))
    got = get_layer(tc.layer_type).forward(
        {k: torch.from_numpy(v) for k, v in p.items()}, tc,
        torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("layer_type,impl", [("lstm", "fused"),
                                             ("lstm", "scan"),
                                             ("graves_lstm", "auto")])
def test_lstm_layer_grads_match_jax(layer_type, impl):
    jc, tc = _layer_confs(layer_type, impl)
    p = _layer_params(layer_type, seed=7)
    rng = np.random.RandomState(8)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    gy = rng.standard_normal((3, 5, 12)).astype(np.float32)
    names = sorted(p)

    def jax_obj(params, x):
        y = jax_get_layer(jc.layer_type).forward(params, jc, x)
        return jnp.sum(y * gy)

    want_p, want_x = jax.grad(jax_obj, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = get_layer(tc.layer_type).forward(tp, tc, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                [tp[k] for k in names] + [tx])
    for g, name in zip(grads, names):
        _close(g, want_p[name], 1e-5, rtol=1e-4)
    _close(grads[-1], want_x, 1e-5, rtol=1e-4)


def test_lstm_init_matches_jax_shapes_and_forget_bias():
    for lt in ("lstm", "graves_lstm"):
        jc, tc = _layer_confs(lt, "auto")
        jp = jax_get_layer(jc.layer_type).init(jax.random.PRNGKey(0), jc)
        tp = get_layer(tc.layer_type).init(nd_random.prng_key(0), tc)
        assert {k: v.shape for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
        for k in tp:
            if k != "W":
                _close(tp[k], jp[k], 0.0)


def test_lstm_prefill_names_its_roadmap_item():
    # LSTM prefill was refused naming ROADMAP.md queue A item 8 until that
    # item's default path was ported: now it is held to the JAX package's,
    # for both LSTM layers, on ragged lengths (carries freeze past them)
    rng = np.random.RandomState(7)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    length = np.asarray([1, 5, 3], np.int32)
    for lt in ("lstm", "graves_lstm"):
        jc, tc = _layer_confs(lt, "auto")
        p = _layer_params(lt)
        h0 = np.zeros((3, 12), np.float32)
        want = jax_get_layer(jc.layer_type).prefill(
            {k: jnp.asarray(v) for k, v in p.items()}, jc, jnp.asarray(x),
            jnp.asarray(h0), jnp.asarray(h0), jnp.asarray(length))
        got = get_layer(tc.layer_type).prefill(
            {k: torch.as_tensor(v) for k, v in p.items()}, tc,
            torch.as_tensor(x), torch.as_tensor(h0), torch.as_tensor(h0),
            torch.as_tensor(length))
        for g, w in zip(got, want):
            _close(g, np.asarray(w), 1e-5)


# --------------------------------------------------------------------- net

def _net_confs(compute_dtype="", impl="auto", iterations=1):
    """(JAX conf, port conf) of the small char-LSTM: embedding, 2 LSTMs,
    sparse labels, the bench's shape of conf."""
    jconf = jax_zoo.char_lstm(VOCAB, hidden=HIDDEN, n_layers=LAYERS,
                              sparse_labels=True, embed=EMBED,
                              iterations=iterations)
    jconf = jconf.replace(confs=tuple(c.replace(lstm_impl=impl)
                                      for c in jconf.confs))
    if compute_dtype:
        jconf = jconf.with_compute_dtype(compute_dtype)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _numpy_params(jconf, seed=0):
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)
    return tuple({name: ((0.3 if len(shape) == 2 else 0.1)
                         * rng.standard_normal(shape)).astype(np.float32)
                  for name, shape in layer.items()} for layer in shapes)


def _jax_params(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (ROWS, SEQ + 1))
    return (ids[:, :-1].astype(np.int32),
            ids[:, 1:].reshape(ROWS * SEQ).astype(np.int32))


def test_char_lstm_conf_json_equals_jax():
    for kw in ({}, dict(hidden=32, n_layers=4, sparse_labels=True,
                        embed=16, lr=0.2, iterations=3)):
        assert zoo.char_lstm(27, **kw).to_json() == \
            jax_zoo.char_lstm(27, **kw).to_json()


@pytest.mark.parametrize("compute_dtype,impl", [("", "auto"), ("", "fused"),
                                                ("bfloat16", "auto"),
                                                ("bfloat16", "fused")])
def test_char_lstm_output_matches_jax(compute_dtype, impl):
    jconf, tconf = _net_confs(compute_dtype, impl)
    np_params = _numpy_params(jconf, seed=1)
    x = _batch(2)[0]
    want = jax_ml.network_output(jconf, _jax_params(np_params),
                                 jnp.asarray(x))
    net = ml.MultiLayerNetwork(tconf, device="cpu")
    net.params = checkpoint.params_from_numpy(np_params, "cpu")
    got = net.output(x)
    assert tuple(got.shape) == (ROWS * SEQ, VOCAB)
    _close(got, want, TOL[compute_dtype])
    np.testing.assert_array_equal(net.predict(x), got.argmax(-1).numpy())
    # the LSTM stack's hidden states too, where the tolerance is not
    # swamped by 24-way softmax probabilities
    jacts = jax_ml.feed_forward(jconf, _jax_params(np_params),
                                jnp.asarray(x))
    tacts = ml.feed_forward(tconf, net.params, torch.from_numpy(x))
    _close(tacts[LAYERS], jacts[LAYERS], 1e-5)


@pytest.mark.parametrize("compute_dtype,impl", [("", "auto"), ("", "fused"),
                                                ("bfloat16", "fused")])
def test_char_lstm_loss_and_grads_match_jax(compute_dtype, impl):
    jconf, tconf = _net_confs(compute_dtype, impl)
    np_params = _numpy_params(jconf, seed=3)
    x, y = _batch(4)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jax_ml.network_loss(jconf, p, jnp.asarray(x),
                                      jnp.asarray(y)))(_jax_params(np_params))
    got_g, got_loss = solver.from_loss(
        lambda p: ml.network_loss(tconf, p, torch.from_numpy(x),
                                  torch.from_numpy(y))).grad_and_score(
        checkpoint.params_from_numpy(np_params, "cpu"))
    want_leaves = jax.tree_util.tree_leaves(want_g)
    got_leaves = tree_leaves(got_g)
    assert len(got_leaves) == len(want_leaves)
    if not compute_dtype:
        _close(got_loss, want_loss, 1e-5)
        for g, w in zip(got_leaves, want_leaves):
            _close(g, w, 1e-5, rtol=1e-4)
        return
    _close(got_loss, want_loss, 2e-2)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 2e-2 * np.abs(w).max()


def test_check_input_lets_one_hot_windows_through():
    # the CLI's text input: one-hot [B, T, V] floats into a char-LSTM with
    # no embedding; ids are checked only where an embedding comes first
    conf = zoo.char_lstm(VOCAB, hidden=8)
    net = ml.MultiLayerNetwork(conf, device="cpu", seed=0).init()
    x = np.eye(VOCAB, dtype=np.float32)[_batch(23)[0]]
    net.check_input(x)
    assert tuple(net.output(x).shape) == (ROWS * SEQ, VOCAB)
    _, tconf = _net_confs()
    ids = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    ids.check_input(_batch(23)[0])
    with pytest.raises(ValueError, match="token ids"):
        ids.check_input(np.full((1, SEQ), VOCAB))


def test_fused_and_scan_paths_agree_on_cpu():
    _, fused = _net_confs(impl="fused")
    _, scan = _net_confs(impl="scan")
    params = checkpoint.params_from_numpy(_numpy_params(fused, 5), "cpu")
    x = torch.from_numpy(_batch(6)[0])
    _close(ml.network_output(fused, params, x),
           ml.network_output(scan, params, x).numpy(), 1e-6)


class _JaxScores(jax_listeners.IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(score)


class _PortScores(listeners.IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(score)


@pytest.mark.parametrize("compute_dtype,impl", [("", "auto"), ("", "fused"),
                                                ("bfloat16", "fused")])
def test_char_lstm_fit_trajectory_matches_jax(compute_dtype, impl):
    # three batches, two SGD-with-momentum iterations each; the updater
    # restarts on every batch in both packages
    tol = TOL[compute_dtype]
    jconf, tconf = _net_confs(compute_dtype, impl=impl, iterations=2)
    np_params = _numpy_params(jconf, seed=7)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = _jax_params(np_params)
    jrec = _JaxScores()
    jnet.set_listeners([jrec])
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    tnet.params = checkpoint.params_from_numpy(np_params, "cpu")
    trec = _PortScores()
    tnet.set_listeners([trec])
    for step in range(3):
        x, y = _batch(8 + step)
        jnet.fit(x, y)
        tnet.fit(x, y)
        for tp, jp in zip(tnet.params, jnet.params):
            for name in tp:
                _close(tp[name], np.asarray(jp[name]), tol)
        _close(tnet.score(x, y), jnet.score(x, y), tol)
    assert len(trec.scores) == len(jrec.scores) == 6
    _close(np.asarray(trec.scores), np.asarray(jrec.scores), tol)


def test_bench_conf_trains_on_cpu_and_the_score_falls():
    # the chip smoke's configuration, at a small width: zoo lr 0.1, SGD
    # with momentum, bf16 compute on the output layer only
    conf = zoo.char_lstm(50, hidden=32, n_layers=2, sparse_labels=True,
                         embed=32).with_compute_dtype("bfloat16")
    net = ml.MultiLayerNetwork(conf, device="cpu", seed=0).init()
    ids = np.random.RandomState(0).randint(0, 27, (8, 17))
    x, y = ids[:, :-1], ids[:, 1:].reshape(-1)
    scores = [net.score(x, y)]
    for _ in range(4):
        net.fit(x, y)
        scores.append(net.score(x, y))
    assert all(np.isfinite(scores)) and scores[-1] < scores[0], scores


# -------------------------------------------------------------- evaluation

def test_evaluate_matches_jax_evaluation():
    jconf, tconf = _net_confs()
    np_params = _numpy_params(jconf, seed=11)
    x, y = _batch(12)
    net = ml.MultiLayerNetwork(tconf, device="cpu")
    net.params = checkpoint.params_from_numpy(np_params, "cpu")
    one_hot = labels_to_one_hot(y, VOCAB)
    want = JaxEvaluation()
    want.eval(one_hot, np.asarray(jax_ml.network_output(
        jconf, _jax_params(np_params), jnp.asarray(x))))
    for batch_size in (0, 1, 3):
        ev = net.evaluate(x, one_hot, batch_size=batch_size)
        assert ev.confusion.total() == ROWS * SEQ
        assert ev.stats() == want.stats()
        assert (ev.accuracy(), ev.f1()) == (want.accuracy(), want.f1())
    assert isinstance(net.evaluate(x, one_hot), Evaluation)


# -------------------------------------------------------------------- data

def test_dataset_selects_the_label_rows_of_each_example():
    x = np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2)
    y = np.arange(5 * 3)  # three label rows per example, window-major
    ds = DataSet(x, y)
    assert ds.label_rows() == 3
    parts = ds.batch_by(2)
    assert [p.num_examples() for p in parts] == [2, 2, 1]
    np.testing.assert_array_equal(np.concatenate([p.labels for p in parts]),
                                  y)
    np.testing.assert_array_equal(ds.get(np.array([4, 0])).labels,
                                  [12, 13, 14, 0, 1, 2])
    # one label row per example: the JAX package's selection
    flat = DataSet(x[:, 0], y[:5])
    jflat = JaxDataSet(x[:, 0], y[:5])
    assert flat.label_rows() == 1
    for a, b in zip(flat.batch_by(2), jflat.batch_by(2)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    for name in ("normalize_zero_mean_unit_variance", "scale_to_unit"):
        np.testing.assert_allclose(getattr(flat, name)().features,
                                   getattr(jflat, name)().features)


def test_iterators_and_cpu_prefetch_serve_every_batch_in_order():
    x = np.arange(7 * 2, dtype=np.float64).reshape(7, 2)
    y = np.arange(7)
    it = MultipleEpochsIterator(2, ListDataSetIterator(DataSet(x, y), 3))
    batches = list(PrefetchIterator(it, device="cpu"))
    assert [b.num_examples() for b in batches] == [3, 3, 1, 3, 3, 1]
    assert all(isinstance(b, DeviceBatch) for b in batches)
    assert batches[0].features.dtype == torch.float32  # f64 -> f32
    np.testing.assert_array_equal(
        torch.cat([b.labels for b in batches[:3]]).numpy(), y)
    # iterating again restarts from the base
    assert len(list(PrefetchIterator(it, device="cpu"))) == 6
    pairs = list(PrefetchIterator([(x[:2], y[:2])], device="cpu"))
    assert isinstance(pairs[0], tuple) and pairs[0][0].shape == (2, 2)


def test_prefetch_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchIterator([])


def test_fit_through_the_prefetcher_equals_fit_per_batch():
    _, tconf = _net_confs()
    np_params = _numpy_params(_net_confs()[0], seed=13)
    batches = [DataSet(*_batch(14)), DataSet(*_batch(15))]
    a = ml.MultiLayerNetwork(tconf, device="cpu")
    a.params = checkpoint.params_from_numpy(np_params, "cpu")
    a.fit(PrefetchIterator(batches, device="cpu"))
    b = ml.MultiLayerNetwork(tconf, device="cpu")
    b.params = checkpoint.params_from_numpy(np_params, "cpu")
    for d in batches:
        b.fit(d.features, d.labels)
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)


# ------------------------------------------------------------------ decode

TEXT = "the quick brown fox jumps over the lazy dog and cats read code " * 3


def _carried_char_lstm(n_layers):
    """A JAX CharLSTM fitted briefly, and the port's with its params."""
    jm = JaxCharLSTM(hidden=16, n_layers=n_layers, seq_len=8, lr=0.2,
                     iterations=5).fit(TEXT)
    tm = CharLSTM(hidden=16, n_layers=n_layers, seq_len=8, device="cpu")
    tm.chars, tm.char_index = list(jm.chars), dict(jm.char_index)
    tm.net = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jm.net.conf.to_json()),
        device="cpu")
    tm.net.params = checkpoint.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.net.params), "cpu")
    return jm, tm


@pytest.mark.parametrize("n_layers", [1, 2])
def test_greedy_sample_and_beam_search_match_jax(n_layers):
    jm, tm = _carried_char_lstm(n_layers)
    assert tm.sample("the ", n=30, temperature=0.0) == \
        jm.sample("the ", n=30, temperature=0.0)
    for width in (1, 3):
        got, got_lp = tm.beam_search("fox ", n=12, beam_width=width)
        want, want_lp = jm.beam_search("fox ", n=12, beam_width=width)
        assert got == want
        assert abs(got_lp - want_lp) <= 1e-5 * max(1.0, abs(want_lp))
    # the decode step's log-probabilities themselves
    step = tm._step_fn()
    hs, cs = tm._init_state(1)
    logp, _, _ = tm._feed(step, "quick", hs, cs)
    jstep = jm._step_fn()
    jhs, jcs = jm._init_state(1)
    jlogp, _, _ = jm._feed(jstep, "quick", jhs, jcs)
    _close(logp, np.asarray(jlogp), 1e-5)


def test_char_lstm_fit_trains_in_batches_on_cpu():
    m = CharLSTM(hidden=16, seq_len=8, lr=0.2, iterations=2, batch_size=3,
                 device="cpu").fit(TEXT)
    assert len(m.sample("the ", n=5, temperature=0)) == 5
    whole = CharLSTM(hidden=16, seq_len=8, lr=0.2, iterations=2,
                     device="cpu").fit(TEXT)
    assert whole.net.params[0]["W"].shape == m.net.params[0]["W"].shape


def test_unported_decoding_names_its_roadmap_item():
    # temperature sampling, `generate` and now speculative decoding (the
    # last of ROADMAP.md queue A item 8, which raised naming the item
    # before) are ported: the chars are the JAX package's, `spec_k` without
    # a draft is 0 as in the JAX package, and a draft cloned from the
    # model gives the one-step batcher's tokens in whole chunks
    from deeplearning4j_tpu_torch.serving import ContinuousBatcher

    jm, tm = _carried_char_lstm(1)
    assert tm.sample("the ", n=8, temperature=1.0, rng_seed=2) == \
        jm.sample("the ", n=8, temperature=1.0, rng_seed=2)
    assert tm.generate("the ", n=8) == jm.generate("the ", n=8)
    ids = [tm.char_index[c] for c in "the "]
    plain = ContinuousBatcher(tm.net, n_slots=1, max_seq=16, spec_k=2)
    clone = ml.MultiLayerNetwork(tm.net.conf, device="cpu")
    clone.params = tm.net.params
    spec = ContinuousBatcher(tm.net, n_slots=1, max_seq=16,
                             draft_net=clone, spec_k=3)
    try:
        assert plain.spec_k == 0
        assert spec.generate(ids, max_new_tokens=9) == plain.generate(
            ids, max_new_tokens=9)
        assert spec.stats()["speculative"]["accepted_per_step"] > 1.0
    finally:
        plain.stop()
        spec.stop()


# -------------------------------------------------------------- checkpoint

def test_lstm_params_round_trip_through_numpy():
    rng = np.random.RandomState(16)
    layer = {k: torch.from_numpy(v) for k, v in
             _layer_params("graves_lstm", seed=17).items()}
    plain = {"W": torch.from_numpy(rng.standard_normal((5, 8)).astype(
        np.float32)), "b": torch.zeros(8)}
    back = checkpoint.params_from_numpy(
        checkpoint.params_to_numpy((plain, layer)), "cpu")
    for got, want in zip(back, (plain, layer)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k])


def test_char_lstm_checkpoints_cross_both_ways(tmp_path):
    jconf, tconf = _net_confs()
    np_params = _numpy_params(jconf, seed=18)
    x = _batch(19)[0]
    jax_checkpoint.save(str(tmp_path / "jax"), _jax_params(np_params),
                        conf=jconf)
    net = checkpoint.load_network(str(tmp_path / "jax"), device="cpu")
    want = jax_ml.network_output(jconf, _jax_params(np_params),
                                 jnp.asarray(x))
    _close(net.output(x), want, 1e-5)
    net.fit(*_batch(20))
    checkpoint.save(str(tmp_path / "port"), net.params, conf=tconf,
                    metadata={"score": 1.5})
    jparams, _, meta = jax_checkpoint.load(
        str(tmp_path / "port"),
        like_params=jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    assert meta["metadata"] == {"score": 1.5}
    _close(net.output(x), jax_ml.network_output(jconf, jparams,
                                                jnp.asarray(x)), 1e-5)


# -------------------------------------------------------------------- card

@pytest.mark.cuda
def test_cuda_lstm_kernel_matches_plain_version_and_trains():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, None)):
        arrs = [torch.from_numpy(a).cuda().to(dt)
                for a in _cell_inputs(21, 37, 27, 40)]
        got = kernels.lstm_cell(*arrs)
        want = kernels.lstm_cell_reference(*arrs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if tol is not None:
                torch.testing.assert_close(g, w, atol=tol, rtol=tol)
            else:
                err = (g.float() - w.float()).abs().max().item()
                assert err <= 2e-2 * w.float().abs().max().item()
    _, tconf = _net_confs()
    net = ml.MultiLayerNetwork(tconf, device="cuda", seed=0).init()
    x, y = _batch(22)
    before = net.score(x, y)
    kernels.reset_launches()
    net.fit(x, y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm_cell"] == LAYERS * SEQ
    assert np.isfinite(net.score(x, y)) and np.isfinite(before)
    assert LayerType(str(tconf.conf(1).layer_type)) == LayerType.LSTM


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,h,views", [
    (37, 27, 40, False),    # K = 27 + 40: no multiple of the K tile
    (2047, 27, 128, False),  # B: no multiple of the block's 32 rows
    (3, 7, 20, False),      # every dimension under one tile
    (50, 36, 44, True),     # W as row blocks of one [I + H, 4H] tensor
    (64, 256, 256, True)])  # the bench widths, x a time step of [B, T, I]
def test_cuda_f32_lstm_kernel_edge_shapes(b, i, h, views):
    # the f32 body (cp.async ring, K slices) against its plain version at
    # 1e-5; shapes with 4-float aligned rows take 16-byte copies, the others
    # single-float copies
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, h0, c0, wx, wh, bias = (torch.from_numpy(a).cuda()
                               for a in _cell_inputs(23, b, i, h))
    if views:
        w = torch.cat([wx, wh])
        wx, wh = w[:i], w[i:]
        seq = torch.from_numpy(np.random.RandomState(24).standard_normal(
            (b, 3, i)).astype(np.float32)).cuda()
        x = seq[:, 1]
        assert x.stride(0) == 3 * i and wh.stride(0) == 4 * h
    before = kernels.LAUNCHES["lstm_cell"]
    got = kernels.lstm_cell(x, h0, c0, wx, wh, bias)
    want = kernels.lstm_cell_reference(x, h0, c0, wx, wh, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm_cell"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == (b, h) and g.is_contiguous()
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,h,views", [
    (256, 256, 256, False),   # the char-LSTM bench shape: 8 K slices
    (256, 256, 256, True),    # W as row blocks, x a time step of [B, T, I]
    (3, 7, 20, False),        # every dimension under one tile, no row
                              # 16-byte aligned: element-by-element copies
    (2047, 27, 128, False)])  # the CLI's cell: 4 K slices, x unaligned
def test_cuda_bf16_lstm_kernel_edge_shapes(b, i, h, views):
    # the bf16 body (K slices a warp, cp.async ring, ldmatrix) against its
    # plain version at 2e-2 * max
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, h0, c0, wx, wh, bias = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                               for a in _cell_inputs(26, b, i, h))
    if views:
        w = torch.cat([wx, wh])
        wx, wh = w[:i], w[i:]
        seq = torch.from_numpy(np.random.RandomState(27).standard_normal(
            (b, 3, i)).astype(np.float32)).cuda().to(torch.bfloat16)
        x = seq[:, 1]
    before = kernels.LAUNCHES["lstm_cell"]
    got = kernels.lstm_cell(x, h0, c0, wx, wh, bias)
    want = kernels.lstm_cell_reference(x, h0, c0, wx, wh, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm_cell"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == (b, h) and g.dtype == torch.bfloat16
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item()
