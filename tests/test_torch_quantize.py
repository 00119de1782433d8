"""The port's serve-precision policies (`optimize/quantize.py`, the infer
cache's policy keys, `MultiLayerNetwork.set_serve_precision`) vs the JAX
package.

Bitwise: `_quantize_leaf`'s q and scale (2-D and 4-D conv), the leaves
`quantize_params_int8` quantizes, `default_calibration`, `params_digest`
(f32 and bf16 trees) and the packed artifact both ways. The cache: the f32
key is the pre-policy tuple, a flip back is bitwise and all hits, mesh and
policy compose in the key, the report has JAX's fields, bf16 follows
training, int8 is a snapshot, and two gloo ranks at model axis 2 serve int8
as one rank does (`tests/torch_serve_worker.py`), the scales split with
their columns. Served outputs of the four small `precision_eval_confs`
under bf16 and int8 are within 2e-2 * max|o| of JAX's, and every entry
(output, feed_forward, loss, decode, prefill, verify, dense and paged)
keys its program with the policy. Greedy streams are
`tests/test_torch_precision.py`'s, the calibration and the error budgets
`tests/test_torch_budgets_*.py`'s.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.optimize import quantize as jq  # noqa: E402
from deeplearning4j_tpu.serving.batcher import \
    ContinuousBatcher as JaxBatcher  # noqa: E402
from deeplearning4j_tpu_torch.models import zoo  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import quantize  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher  # noqa: E402,E501

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_serve_worker.py")
#: a policy's output against JAX's: 2e-2 of the largest |output|
OUT_TOL = 2e-2
MODELS = ("lenet5", "char_lstm", "char_transformer", "deep_autoencoder")


def _jconfs():
    return jax_zoo.precision_eval_confs(small=True)


def _pair(jconf, seed=0):
    """JAX's network and the port's on the CPU, the port's params carried
    over from JAX's."""
    jnet = JaxNet(jconf, seed=seed).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", seed=seed)
    net.params = checkpoint.params_from_numpy(
        jax.device_get(jnet.params), "cpu")
    return jnet, net


def _mlp(seed=0):
    return _pair(jax_zoo.mlp(n_in=6, hidden=[8], n_out=3, lr=0.05),
                 seed=seed)


def _x(rows, seed=0, n_in=6):
    return np.random.RandomState(seed).randn(rows, n_in).astype(np.float32)


def _leaves_equal(port_tree, jax_tree):
    a = checkpoint.params_to_numpy(port_tree)
    b = jax.device_get(jax_tree)
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert sorted(la) == sorted(lb)
        for name in la:
            if isinstance(lb[name], dict):
                assert isinstance(la[name], dict) and sorted(la[name]) == \
                    sorted(lb[name])
                for k in lb[name]:
                    np.testing.assert_array_equal(la[name][k],
                                                  np.asarray(lb[name][k]))
                    assert la[name][k].dtype == np.asarray(lb[name][k]).dtype
            else:
                np.testing.assert_array_equal(la[name], np.asarray(lb[name]))


# -- quantization, bitwise -----------------------------------------------------

@pytest.mark.parametrize("shape,clip", [((5, 7), 1.0), ((64, 48), 0.995),
                                        ((4, 3, 2, 2), 1.0),
                                        ((20, 1, 5, 5), 0.98)])
def test_quantize_leaf_is_jaxs_bitwise(shape, clip):
    """q and scale of a 2-D weight (per output column) and a 4-D OIHW conv
    kernel (per output channel), a zero column included."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    if len(shape) == 2:
        w[:, 0] = 0.0   # a zero column takes scale 1
    else:
        w[0] = 0.0      # a zero output channel
    want = jq._quantize_leaf(w, clip)
    got = quantize._quantize_leaf(torch.from_numpy(w), clip)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


@pytest.mark.parametrize("model", MODELS)
def test_quantize_params_choose_jaxs_leaves_bitwise(model):
    """`quantize_params_int8` quantizes JAX's leaves (W* of >= 2 dims: the
    LSTM's W, not its b) with JAX's q and scale; the other leaves are
    copies of the params."""
    jnet, net = _pair(_jconfs()[model])
    got = quantize.quantize_params_int8(net.params, clip=0.999)
    _leaves_equal(got, jq.quantize_params_int8(jnet.params, clip=0.999))
    for layer, q in zip(net.params, got):
        for name, leaf in layer.items():
            if not isinstance(q[name], dict):
                assert q[name] is not leaf and torch.equal(q[name], leaf)


@pytest.mark.parametrize("model", MODELS)
def test_default_calibration_is_jaxs(model):
    jconf = _jconfs()[model]
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    for rows, seed in ((32, 0), (64, 1)):
        want = np.asarray(jq.default_calibration(jconf, rows=rows, seed=seed))
        got = quantize.default_calibration(conf, rows=rows, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_params_digest_is_jaxs_for_f32_and_bf16_trees():
    jnet, net = _pair(_jconfs()["char_transformer"])
    assert quantize.params_digest(net.params) == jq.params_digest(
        jnet.params)
    assert quantize.params_digest(quantize.cast_params_bf16(net.params)) \
        == jq.params_digest(jq.cast_params_bf16(jnet.params))
    q = quantize.quantize_params_int8(net.params)
    assert quantize.params_digest(q) == jq.params_digest(
        jq.quantize_params_int8(jnet.params))


def test_packed_artifact_crosses_both_ways():
    """JAX packs, the port unpacks and serves it as its own quantization;
    the port packs, JAX unpacks the same arrays and report; JAX's tree
    carried by `params_from_numpy` serves as the port's own."""
    jnet, net = _mlp()
    report = {"clip": 0.995, "mse": 1.5e-6, "calibration_rows": 32}
    jblob = jq.pack_quantized(jq.quantize_params_int8(jnet.params, 0.995),
                              report)
    q, r = quantize.unpack_quantized(jblob, "cpu")
    assert r == report
    mine = quantize.quantize_params_int8(net.params, 0.995)
    _leaves_equal(q, jq.quantize_params_int8(jnet.params, 0.995))
    x = torch.from_numpy(_x(4))
    np.testing.assert_array_equal(
        quantize.policy_output(net.conf, q, x, "int8").numpy(),
        quantize.policy_output(net.conf, mine, x, "int8").numpy())
    jq2, jr = jq.unpack_quantized(quantize.pack_quantized(mine, report))
    assert jr == report
    _leaves_equal(mine, jq2)
    # JAX's quantized tree carried across as params (int8 sub-dicts kept)
    carried = checkpoint.params_from_numpy(
        jax.device_get(jq.quantize_params_int8(jnet.params, 0.995)), "cpu")
    _leaves_equal(carried, jq.quantize_params_int8(jnet.params, 0.995))
    net.infer_cache.set_policy("int8", carried)
    np.testing.assert_array_equal(
        net.output(x).numpy(),
        quantize.policy_output(net.conf, mine, x, "int8").numpy())


def _set_policy(jnet, net, policy, clip=0.995):
    """Both networks under `policy`; int8 serves JAX's quantization at
    `clip` (packed by JAX, unpacked by the port: one artifact)."""
    if policy == "int8":
        jqp = jq.quantize_params_int8(jnet.params, clip)
        jnet.infer_cache.set_policy("int8", qparams=jqp)
        qparams, _ = quantize.unpack_quantized(jq.pack_quantized(jqp, {}),
                                               "cpu")
        net.infer_cache.set_policy("int8", qparams)
    else:
        jnet.set_serve_precision(policy, measure=False)
        net.set_serve_precision(policy, measure=False)


@pytest.mark.parametrize("policy", ["bf16", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_served_policy_outputs_are_jaxs(model, policy):
    """The policy set, then `output` (the cached entry) on the four small
    eval models: within 2e-2 * max|o| of JAX's served output; the int8
    weights both serve are JAX's (one artifact)."""
    jconf = jax_zoo.precision_eval_confs(small=True)[model]
    jnet, net = _pair(jconf)
    x = np.asarray(jq.default_calibration(jconf, rows=16, seed=5))
    _set_policy(jnet, net, policy)
    want = np.asarray(jnet.output(x))
    got = net.output(x).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OUT_TOL * float(np.abs(want).max()))
    assert net.infer_cache.programs_summary()[0]["policy"] == policy


# -- the cache keys -------------------------------------------------------------

def test_f32_key_is_the_pre_policy_tuple():
    """f32 adds nothing to a key: JAX's
    `test_f32_key_is_the_pre_policy_4_tuple`; a policy adds
    ("policy", name) as JAX's does."""
    jnet, net = _mlp()
    x = _x(4)
    for n in (jnet, net):
        n.output(x)
    assert sorted(net.infer_cache._programs) == sorted(
        jnet.infer_cache._programs)
    assert all(len(k) == 4 for k in net.infer_cache._programs)
    for n in (jnet, net):
        n.set_serve_precision("bf16", measure=False)
        n.output(x)
    assert sorted(net.infer_cache._programs) == sorted(
        jnet.infer_cache._programs)
    assert any(k[4:] == (("policy", "bf16"),)
               for k in net.infer_cache._programs)


def test_flip_back_is_bitwise_and_all_hits():
    _, net = _mlp()
    x = _x(4, seed=1)
    ref = net.output(x).clone()
    net.set_serve_precision("bf16", measure=False)
    net.output(x)
    net.set_serve_precision("int8", measure=False)
    net.output(x)
    assert {r["policy"] for r in net.infer_cache.programs_summary()} == {
        "f32", "bf16", "int8"}
    misses = net.infer_cache.stats.misses
    net.set_serve_precision("f32")
    assert torch.equal(net.output(x), ref)
    for policy in ("int8", "bf16"):
        net.infer_cache.set_policy(policy, net.infer_cache._qparams)
        net.output(x)
    assert net.infer_cache.stats.misses == misses


def test_mesh_and_policy_compose_in_the_key():
    jnet, net = _mlp()
    x = _x(4, seed=4)
    from deeplearning4j_tpu.parallel.plan import plan_mesh as jax_plan_mesh

    jnet.set_serve_mesh(mesh=jax_plan_mesh({}, devices=jax.devices()[:1]))
    net.set_serve_mesh()
    for n in (jnet, net):
        n.set_serve_precision("bf16", measure=False)
        n.output(x)
    keys = list(net.infer_cache._programs)
    assert keys == list(jnet.infer_cache._programs)
    assert any(k[3][0] == "mesh" and k[4] == ("policy", "bf16")
               for k in keys), keys
    assert any(r["sharding"].startswith("mesh:") and r["policy"] == "bf16"
               for r in net.infer_cache.programs_summary())
    assert net.infer_cache.plan.describe()["policy"] == "bf16"


def test_report_fields_are_jaxs():
    jnet, net = _mlp()
    want = jnet.set_serve_precision("int8")
    got = net.set_serve_precision("int8")
    assert set(got) == set(want) | {"artifact"}
    assert set(got["calibration"]) == set(want["calibration"])
    assert set(got["accuracy_delta"]) == set(want["accuracy_delta"])
    assert got["calibration"]["clip"] in quantize.CLIP_GRID
    assert got["artifact"]["source"] == "calibrated"
    assert net.serve_precision_report is got
    assert net.serve_precision == "int8"
    assert "accuracy_delta" not in net.set_serve_precision("bf16",
                                                           measure=False)
    with pytest.raises(ValueError, match="unknown precision policy"):
        net.set_serve_precision("fp8")


@pytest.mark.parametrize("policy", ["bf16", "int8"])
def test_every_entry_serves_under_its_policy_key(policy):
    """Under a policy every entry keys its program with ("policy", name):
    output, feed_forward, loss, decode (dense, paged, K-step blocks),
    prefill, prefill_logp, verify (dense, paged); the speculative streams
    (the verify under the policy) equal the K = 1 streams, and the feed
    forward's last activations the output."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    _, net = _pair(jax_zoo.char_transformer(24, d_model=16, n_blocks=1,
                                            n_heads=2, max_seq_len=32))
    draft = MultiLayerNetwork(char_lstm(24, hidden=8), device="cpu",
                              seed=3).init()
    net.set_serve_precision(policy, measure=False)
    x = np.random.RandomState(0).randint(0, 24, (3, 16)).astype(np.int32)
    y = np.eye(24, dtype=np.float32)[np.random.RandomState(1).randint(
        0, 24, 3 * 16)]
    out = net.output(x)
    assert torch.equal(net.feed_forward(x)[-1], out)
    assert np.isfinite(net.score(x, y))
    streams = {}
    for name, opts in (("k1", {}), ("spec", {"draft_net": draft,
                                             "spec_k": 3}),
                       ("paged_spec", {"draft_net": draft, "spec_k": 3,
                                       "page_size": 8}),
                       ("block", {"steps_per_dispatch": 2}),
                       ("prefix", {"prefix_cache": True})):
        net.warmup_generate(slots=2, max_seq=32, prompt_buckets=(8,), **opts)
        from deeplearning4j_tpu_torch.serving.batcher import \
            ContinuousBatcher

        cb = ContinuousBatcher(net, n_slots=2, max_seq=32,
                               prompt_buckets=(8,), **opts)
        try:
            ss = [cb.submit(p, max_new_tokens=6) for p in ([1, 7, 3],
                                                           [4, 4, 8, 2])]
            streams[name] = [list(t.tokens(timeout=60)) for t in ss]
        finally:
            cb.stop()
    assert all(v == streams["k1"] for v in streams.values()), streams
    entries = {k[0] for k in net.infer_cache._programs
               if k[-1] == ("policy", policy)}
    assert {"output", "feed_forward", "loss", "decode", "decode-paged",
            "decode-multi[2]", "prefill", "prefill-logp", "verify",
            "verify-paged"} <= entries, entries
    assert all(k[-1] == ("policy", policy) for k in net.infer_cache._programs)


# -- training and the int8 snapshot ------------------------------------------------

def _fit(net, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
    net.fit(x, y)


def test_bf16_follows_fit():
    """A train step writes the params in place; the next bf16 call casts
    them again (into the same tensors), equal to a fresh network holding
    the trained params under bf16."""
    _, net = _mlp()
    x = _x(6, seed=2)
    net.set_serve_precision("bf16", measure=False)
    before = net.output(x).clone()
    held = tree_leaves(net.infer_cache._serve_params(net.params))
    _fit(net)
    after = net.output(x)
    assert not torch.equal(after, before)
    assert all(a is b for a, b in zip(
        held, tree_leaves(net.infer_cache._serve_params(net.params))))
    fresh = MultiLayerNetwork(net.conf, device="cpu")
    fresh.params = tuple({k: v.clone() for k, v in layer.items()}
                         for layer in net.params)
    fresh.set_serve_precision("bf16", measure=False)
    assert torch.equal(fresh.output(x), after)


def test_int8_is_a_snapshot_requantized_in_place():
    """int8 serves the weights it quantized until set again; setting it
    again copies the new snapshot into the held tensors."""
    _, net = _mlp()
    x = _x(6, seed=2)
    net.set_serve_precision("int8", measure=False)
    before = net.output(x).clone()
    held = tree_leaves(net.infer_cache._qparams)
    _fit(net)
    assert torch.equal(net.output(x), before)
    net.set_serve_precision("int8", measure=False)
    assert all(a is b for a, b in zip(held,
                                      tree_leaves(net.infer_cache._qparams)))
    fresh = MultiLayerNetwork(net.conf, device="cpu")
    fresh.params = net.params
    fresh.set_serve_precision("int8", measure=False)
    assert torch.equal(net.output(x), fresh.output(x))
    assert not torch.equal(net.output(x), before)


# -- two ranks, model axis 2, int8 ---------------------------------------------------

@pytest.fixture(scope="module")
def int8_two_ranks(tmp_path_factory):
    """Two gloo ranks at batch=1, model=2 under int8 (`torch_serve_worker`'s
    "requantize" layout): rank 0 serves the rows on the seed-0 params, sets
    int8 again alone on the seed-1 params and calls, then every rank sets
    it and rank 0 serves again. Returns the worker's arrays and JSON and
    one rank's int8 outputs on each params."""
    tmp_path = tmp_path_factory.mktemp("int8_two_ranks")
    jconf = jax_zoo.char_transformer(32, d_model=16, n_blocks=2, n_heads=4,
                                     max_seq_len=32)
    trees = {name: jax.device_get(JaxNet(jconf, seed=seed).init().params)
             for name, seed in (("tf", 0), ("tf2", 1))}
    arrays = {f"params/{name}/{i}/{k}": np.asarray(a)
              for name, params in trees.items()
              for i, layer in enumerate(params) for k, a in layer.items()}
    arrays["output/x"] = np.random.RandomState(0).randint(
        1, 32, (3, 16)).astype(np.int32)
    np.savez(tmp_path / "inputs.npz", **arrays)
    with open(tmp_path / "scenarios.json", "w") as f:
        json.dump({"confs": {"tf": jconf.to_json()},
                   "generate": {"max_seq": 32, "bucket": 8},
                   "layouts": [{"layout": "1x2", "precision": "int8",
                                "output_only": True,
                                "requantize": "tf2"}]}, f)
    env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="1",
               HOME=str(tmp_path))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp_path)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(tmp_path))
             for r in range(2)]
    want = {}
    for name, params in trees.items():
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu")
        net.params = checkpoint.params_from_numpy(params, "cpu")
        net.set_serve_precision("int8", measure=False)
        want[name] = net.output(torch.from_numpy(arrays["output/x"])).numpy()
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    got = dict(np.load(tmp_path / "out" / "1x2.npz"))
    with open(tmp_path / "out" / "1x2.json") as f:
        info = json.load(f)
    return got, info, want


def test_int8_under_a_model_axis_serves_as_one_rank(int8_two_ranks):
    """Each rank holds its heads' q columns and the matching scale columns
    (the row splits' scales whole), and the served output equals one
    rank's int8 output within 2e-2 * max|o|."""
    got, info, want = int8_two_ranks
    assert info["policy"] == "int8"
    assert all("('policy', 'int8')" in k for k in info["keys"])
    np.testing.assert_allclose(got["y"], want["tf"], rtol=0,
                               atol=OUT_TOL * float(np.abs(want["tf"]).max()))


def test_int8_requantized_under_a_model_axis_serves_the_new_snapshot(
        int8_two_ranks):
    """A second `set_serve_precision("int8")` on other params of the same
    shapes: set on rank 0 alone, its next call is refused by the follower
    (its snapshot count is not rank 0's); set on every rank, the served
    output is one rank's int8 output of the new params, not the old
    snapshot's."""
    got, info, want = int8_two_ranks
    assert "int8 snapshot 1 is not rank 0's 2" in info["stale"]
    tol = OUT_TOL * float(np.abs(want["tf2"]).max())
    np.testing.assert_allclose(got["y2"], want["tf2"], rtol=0, atol=tol)
    assert float(np.abs(got["y2"] - got["y"]).max()) > tol


def test_sharded_scales_follow_their_columns():
    """`shard_params` of an int8 tree: a column split (Wqkv's thirds, W1)
    cuts `scale` with `q`'s columns; a row split (Wo, W2) keeps it
    whole."""
    from deeplearning4j_tpu_torch.parallel.tensor import (TensorParallel,
                                                          shard_params,
                                                          tp_layout)

    _, net = _pair(jax_zoo.char_transformer(32, d_model=16, n_blocks=1,
                                            n_heads=4, max_seq_len=32))
    q = quantize.quantize_params_int8(net.params)
    for rank in range(2):
        tp = TensorParallel(None, 2, rank, tp_layout(net.conf, 2))
        local = shard_params(q, tp)
        att, ffn = local[1], local[2]
        for name, cols in (("Wqkv", 3), ("W1", 1)):
            whole = q[1 if name == "Wqkv" else 2][name]
            n = whole["q"].shape[1]
            idx = np.concatenate([np.arange(p * n // cols + rank * n // cols
                                            // 2, p * n // cols
                                            + (rank + 1) * n // cols // 2)
                                  for p in range(cols)])
            part = att[name] if name == "Wqkv" else ffn[name]
            assert torch.equal(part["q"], whole["q"][:, idx])
            assert torch.equal(part["scale"], whole["scale"][:, idx])
        for name, lay in (("Wo", 1), ("W2", 2)):
            part, whole = local[lay][name], q[lay][name]
            assert part["q"].shape[0] == whole["q"].shape[0] // 2
            assert torch.equal(part["scale"], whole["scale"])
