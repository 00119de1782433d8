"""Serving under a mesh, and the initial params, in the port vs the JAX
package.

The initial params (`MultiLayerNetwork(conf, seed=s).init()`) are JAX's:
bitwise for the uniform schemes, within a few float32 ulps of XLA's erfinv
for the normal ones, for every layer type and for bfloat16 and float16
params.

The serving mesh: the cache's key tuples are JAX's for one rank, the 1-D
mesh and the (batch, model) plan, generation keeps "single" under a 1-D
mesh, and buckets round to the mesh's rows. One spawn of four gloo ranks
(`tests/torch_serve_worker.py`, which imports neither JAX nor
`deeplearning4j_tpu`) serves the charTransformer at 2 x 2, 1 x 4 and
4 x 1; its output is held to JAX's on a plan mesh of the same shape
(rtol 1e-5, atol 1e-6, `tests/test_tp_mesh.py`'s tolerance: JAX's own
bitwise mesh tests fail, ROADMAP.md queue C), its greedy dense and paged
tokens to JAX's trajectories on a 1 x 4 plan mesh, each rank's K/V columns
after a prefill to JAX's state's shard m (rtol 1e-5, atol 1e-6), its
speculative streams under a model axis to its K = 1 streams, and a
follower that raises must end rank 0's call with its error.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.optimize.step_cache import \
    arg_signature as jax_signature  # noqa: E402
from deeplearning4j_tpu.parallel.plan import plan_mesh as jax_plan_mesh  # noqa: E402,E501
from deeplearning4j_tpu.serving.batcher import \
    ContinuousBatcher as JaxBatcher  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.infer_cache import InferCache  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import serve_mesh  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_serve_worker.py")
VOCAB = 32
GEN = {"prompt": [1, 7, 3], "new": 8, "max_seq": 32, "bucket": 8,
       "page_size": 8, "n_pages": 8}
LAYOUTS = [{"layout": "2x2", "spec": True, "fault": True},
           {"layout": "1x4", "spec": True},
           {"layout": "4x1"}]
#: f32 erfinv: within 3 float32 ulps of XLA's (nd/random.erfinv), so a
#: normal draw of magnitude up to ~5 is within 5 * 3 * 2^-23 (+ the scale)
NORMAL_ATOL = 2e-6


def _tf():
    return jax_zoo.char_transformer(VOCAB, d_model=16, n_blocks=2,
                                    n_heads=4, max_seq_len=32)


def _port(jconf, seed=0):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", seed=seed)


# -- the initial params (ROADMAP.md queue C, C1) -----------------------------

def _dense(scheme, dist=None, dtype="float32"):
    base = jax_conf.NeuralNetConfiguration(weight_init=scheme, dist=dist,
                                           seed=1, dtype=dtype)
    return (jax_conf.list_builder(base, 2)
            .hidden_layer_sizes([7], n_in=5, n_out=3)
            .override(1, layer_type=jax_conf.LayerType.OUTPUT).build())


def _as_dtype(jconf, dtype):
    return jconf.replace(confs=tuple(c.replace(dtype=dtype)
                                     for c in jconf.confs))


#: the normal-drawn leaves: RELU/LECUN/normal-distribution weights and the
#: positional table
def _normal_leaf(conf_name, name):
    return name == "P" or conf_name in ("relu", "lecun", "dist-normal")


def _assert_jaxs(jconf, conf_name, seed=3):
    want = jax.device_get(JaxNet(jconf, seed=seed).init().params)
    got = _port(jconf, seed).init().params
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert sorted(a) == sorted(b), i
        for k in a:
            x = np.asarray(a[k])
            y = b[k]
            assert str(y.dtype).replace("torch.", "") == str(x.dtype), k
            x, y = x.astype(np.float32), y.float().numpy()
            if _normal_leaf(conf_name, k):
                ulp = float(np.finfo(np.float32).eps) if b[k].dtype == \
                    torch.float32 else 2.0 ** -7
                np.testing.assert_allclose(
                    y, x, rtol=4 * ulp, atol=NORMAL_ATOL,
                    err_msg=f"{conf_name} layer {i} {k}")
            else:
                np.testing.assert_array_equal(
                    y, x, err_msg=f"{conf_name} layer {i} {k}")


SCHEMES = ["vi", "normalized", "uniform", "xavier", "size", "zero", "relu",
           "lecun"]
DISTS = {"dist-normal": jax_conf.Distribution("normal", 0.1, 0.5),
         "dist-uniform": jax_conf.Distribution("uniform", lo=-0.2, hi=0.3),
         "dist-binomial": jax_conf.Distribution("binomial", p=0.3)}


@pytest.mark.parametrize("scheme", SCHEMES + sorted(DISTS))
def test_init_params_are_jaxs_for_every_scheme(scheme):
    if scheme in DISTS:
        _assert_jaxs(_dense("distribution", DISTS[scheme]), scheme)
    else:
        _assert_jaxs(_dense(scheme), scheme)


ZOO = {"transformer": lambda: _tf(),
       "lstm": lambda: jax_zoo.char_lstm(10, hidden=8, embed=8),
       "graves_lstm": lambda: jax_zoo.char_lstm(10, hidden=8).replace(
           confs=tuple(c.replace(layer_type=jax_conf.LayerType.GRAVES_LSTM)
                       if str(c.layer_type) == "lstm" else c
                       for c in jax_zoo.char_lstm(10, hidden=8).confs)),
       "conv_bn": lambda: jax_zoo.vgg_cifar10(width=4),
       "lenet5": lambda: jax_zoo.lenet5(),
       "rbm": lambda: jax_zoo.dbn(6, [5, 4], 3),
       "autoencoder": lambda: jax_zoo.deep_autoencoder(8, hidden=(5, 3))}


@pytest.mark.parametrize("model", sorted(ZOO))
def test_init_params_are_jaxs_for_every_layer_type(model):
    """Dense, output, embedding (with its positional table), attention,
    FFN, LSTM, Graves LSTM, convolution, subsampling, BatchNorm, RBM and
    autoencoder layers draw JAX's params from the network's key."""
    _assert_jaxs(ZOO[model](), model)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("conf_name", ["vi", "uniform", "xavier", "relu",
                                       "transformer"])
def test_init_params_in_16_bit_floats_are_jaxs(conf_name, dtype):
    """A 16-bit conf draws as JAX draws that dtype: UNIFORM and XAVIER in
    the dtype (8 random bits a bfloat16 draw), VI and RELU in float32
    then cast, the positional table's normal in the dtype."""
    jconf = _tf() if conf_name == "transformer" else _dense(conf_name)
    _assert_jaxs(_as_dtype(jconf, dtype), conf_name)


def test_checkpoint_keeps_the_key_and_no_generator_state(tmp_path):
    """`fit(checkpoint_dir=...)` saves the key stream under JAX's name and
    no generator; an older checkpoint's `torch_generator_state` is
    ignored on resume."""
    jconf = _dense("xavier")
    net = _port(jconf).init()
    x = np.random.RandomState(0).randn(8, 5).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, (8,)).astype(np.int32)
    net.fit([(x, y)] * 2, checkpoint_dir=str(tmp_path / "ck"))
    _, _, meta = checkpoint.load(str(tmp_path / "ck"))
    assert "torch_generator_state" not in meta["metadata"]
    assert meta["metadata"]["rng_key"] == [int(v) for v in net._key]
    meta["metadata"]["torch_generator_state"] = "00ff"
    checkpoint.save(str(tmp_path / "old"), net.params, conf=net.conf,
                    step=2, data_cursor={"batches_done": 2},
                    metadata=meta["metadata"])
    again = _port(jconf).init()
    again.fit([(x, y)] * 2, checkpoint_dir=str(tmp_path / "old"))
    assert again.resumed_from_batch == 2
    assert again._key == net._key


# -- keys and buckets at one rank ------------------------------------------

def _jax_keys(jnet, prog_entries=("output", "decode")):
    return sorted(k for k in jnet.infer_cache._programs
                  if k[0] in prog_entries)


def _port_keys(net, prog_entries=("output", "decode")):
    return sorted(k for k in net.infer_cache._programs
                  if k[0] in prog_entries)


@pytest.mark.parametrize("mesh", ["single", "1d"])
def test_serve_keys_are_jaxs_at_one_rank(mesh):
    """`output` and `decode` keys: "single" without a mesh; under the 1-D
    mesh the output key carries ("mesh", ("batch",), (1,)) and the decode
    key stays "single" (generation on rank 0 alone)."""
    jconf = _tf()
    jnet = JaxNet(jconf, seed=0).init()
    net = _port(jconf).init()
    if mesh == "1d":
        jnet.set_serve_mesh(mesh=jax_plan_mesh({}, devices=jax.devices()[:1]))
        net.set_serve_mesh()
    x = np.ones((4, 16), np.int32)
    for n in (jnet, net):
        n.infer_cache.output(n.conf, n.params, x if n is jnet
                             else torch.from_numpy(x), compile_only=True)
        n.warmup_generate(slots=2, max_seq=16, prompt_buckets=(4,))
    assert _port_keys(net) == _jax_keys(jnet)
    decode = [k for k in _port_keys(net) if k[0] == "decode"]
    assert decode and all(k[3] == "single" for k in decode)


def test_serve_bucket_rounds_to_the_mesh_rows(monkeypatch):
    """JAX's `tests/test_mesh_infer.py:119-137`: known divisible buckets
    are reused, otherwise the bucket grows to the next multiple."""
    c = InferCache()
    c.set_mesh(serve_mesh(device="cpu"))
    monkeypatch.setattr(c, "_mesh_rows", lambda: 4)
    assert c._serve_bucket(5) == 8
    assert 8 in c.buckets
    assert c._serve_bucket(3) == 8
    assert c._serve_bucket(8) == 8
    assert c._serve_bucket(9) == 12
    monkeypatch.setattr(c, "_mesh_rows", lambda: 1)
    assert c._serve_bucket(5) == 8
    c.set_mesh(None)
    assert c.sharding_tag() == InferCache.SINGLE


def test_set_serve_mesh_contract():
    """`mesh` and `spec` exclude each other; the spec's mesh is returned
    and a model axis of one rank serves bitwise the one-rank output."""
    net = _port(_tf()).init()
    x = torch.from_numpy(np.random.RandomState(0).randint(
        1, VOCAB, (3, 16)).astype(np.int32))
    ref = net.output(x)
    with pytest.raises(ValueError, match="not both"):
        net.set_serve_mesh(mesh=serve_mesh(device="cpu"), spec="all")
    mesh = net.set_serve_mesh(spec="batch=1,model=1")
    assert mesh.shape == {"batch": 1, "model": 1}
    assert net.infer_cache.plan.describe() == {
        "axes": ["batch", "model"], "shape": {"batch": 1, "model": 1},
        "policy": "f32"}
    assert torch.equal(net.output(x), ref)


# -- four ranks ----------------------------------------------------------------

def _jax_greedy(jnet, **options):
    jnet.warmup_generate(slots=2, max_seq=GEN["max_seq"],
                         prompt_buckets=(GEN["bucket"],), **options)
    cb = JaxBatcher(jnet, n_slots=2, max_seq=GEN["max_seq"],
                    prompt_buckets=(GEN["bucket"],),
                    **{k: v for k, v in options.items() if k != "n_pages"})
    try:
        return list(cb.submit(GEN["prompt"], max_new_tokens=GEN["new"])
                    .tokens(timeout=120.0))
    finally:
        cb.stop()


def _jax_net(jconf, params, shape=None):
    jnet = JaxNet(jconf, seed=0)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    if shape is not None:
        n = int(np.prod(list(shape.values())))
        jnet.set_serve_mesh(mesh=jax_plan_mesh(shape,
                                               devices=jax.devices()[:n]))
    return jnet


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, compute JAX's side while they work, collect
    both."""
    work = tmp_path_factory.mktemp("serve_ranks")
    confs = {"tf": _tf(), "draft": jax_zoo.char_lstm(VOCAB, hidden=8)}
    params = {k: jax.device_get(JaxNet(c, seed=0).init().params)
              for k, c in confs.items()}
    arrays = {f"params/{name}/{i}/{k}": np.asarray(a)
              for name, tree in params.items()
              for i, layer in enumerate(tree) for k, a in layer.items()}
    arrays["output/x"] = np.random.RandomState(0).randint(
        1, VOCAB, (5, 16)).astype(np.int32)
    np.savez(work / "inputs.npz", **arrays)
    with open(work / "scenarios.json", "w") as f:
        json.dump({"confs": {k: c.to_json() for k, c in confs.items()},
                   "generate": GEN, "layouts": LAYOUTS}, f)
    env = dict(os.environ, WORLD_SIZE="4", OMP_NUM_THREADS="1",
               HOME=str(work))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(work)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(work))
             for r in range(4)]

    tf = confs["tf"]
    want = {"output": {}, "state": None}
    for sc in LAYOUTS:
        b, m = (int(v) for v in sc["layout"].split("x"))
        jnet = _jax_net(tf, params["tf"], {"batch": b, "model": m})
        want["output"][sc["layout"]] = np.asarray(
            jnet.output(arrays["output/x"]))
        if sc["layout"] == "2x2":
            want["keys_2x2"] = _jax_keys_of_plan(jnet)
    plan14 = {"batch": 1, "model": 4}
    want["dense"] = _jax_greedy(_jax_net(tf, params["tf"], plan14))
    want["paged"] = _jax_greedy(_jax_net(tf, params["tf"], plan14),
                                page_size=GEN["page_size"],
                                n_pages=GEN["n_pages"])
    jnet = _jax_net(tf, params["tf"])
    state = jnet.infer_cache.init_decode_state(tf, 1, GEN["max_seq"])
    prompt = np.zeros((1, GEN["bucket"]), np.int32)
    prompt[0, :len(GEN["prompt"])] = GEN["prompt"]
    _, _, state = jnet.infer_cache.prefill(
        tf, jnet.params, state, prompt,
        np.asarray([len(GEN["prompt"])], np.int32),
        np.zeros((1, 2), np.uint32), np.zeros((1,), np.float32))
    want["state"] = jax.device_get(state)

    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    out_dir = work / "out"
    port = {}
    for sc in LAYOUTS:
        name = sc["layout"]
        with open(out_dir / f"{name}.json") as f:
            port[name] = json.load(f)
        port[name]["arrays"] = dict(np.load(out_dir / f"{name}.npz"))
        port[name]["ranks"] = {
            r: dict(np.load(out_dir / f"{name}_state_r{r}.npz"))
            for r in range(1, 4)}
        port[name]["kept"] = [json.load(open(out_dir / f"{name}_kept_r{r}"
                                             ".json")) for r in range(1, 4)]
    imports = [json.load(open(out_dir / f"imports_r{r}.json"))
               for r in range(4)]
    return {"port": port, "jax": want, "imports": imports}


def _jax_keys_of_plan(jnet):
    """The output and decode keys JAX's cache makes on a plan mesh,
    built from its own functions (`tests/test_serve_plan.py:113-160`
    builds them so), without compiling: the padded rows' signature and the
    whole decode state's leaves."""
    ic = jnet.infer_cache
    conf = jnet.conf
    xp = jnp.zeros((ic._serve_bucket(5), 16), jnp.int32)
    out_key = (("output", ic._fingerprint(conf), jax_signature(xp),
                ic.sharding_tag()) + ic._policy_suffix())
    state = _jax_state_shapes(conf)
    b = jnp.zeros((2,), jnp.int32)
    dec_key = (("decode", ic._fingerprint(conf),
                jax_signature(b, b, jnp.zeros((2, 2), jnp.uint32),
                              jnp.zeros((2,), jnp.float32),
                              *jax.tree_util.tree_leaves(state)),
                ic._decode_tag()) + ic._policy_suffix())
    return [out_key, dec_key]


def _jax_state_shapes(conf):
    from deeplearning4j_tpu.nn import decode as jax_decode

    return jax_decode.init_state(conf, 2, GEN["max_seq"])


@pytest.mark.parametrize("layout", [sc["layout"] for sc in LAYOUTS])
def test_output_under_a_mesh_is_jaxs(runs, layout):
    np.testing.assert_allclose(runs["port"][layout]["arrays"]["y"],
                               runs["jax"]["output"][layout], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("table", ["dense", "paged"])
@pytest.mark.parametrize("layout", [sc["layout"] for sc in LAYOUTS])
def test_greedy_tokens_under_a_mesh_are_jaxs(runs, layout, table):
    want = runs["jax"][table]
    assert want and runs["port"][layout][table] == want


@pytest.mark.parametrize("layout", [sc["layout"] for sc in LAYOUTS])
def test_each_ranks_kv_columns_are_jaxs_shard(runs, layout):
    """After one prefill, rank r's K/V leaves are the columns
    [m·n/M, (m+1)·n/M) of JAX's state (m = r mod M), with the whole width
    where M = 1; the per-rank state bytes fall as 1/M."""
    m_size = int(layout.split("x")[1])
    port = runs["port"][layout]
    jstate = runs["jax"]["state"]
    ranks = {0: {k[len("state/"):]: v for k, v in port["arrays"].items()
                 if k.startswith("state/")}, **port["ranks"]}
    checked = 0
    for r, leaves in ranks.items():
        m = r % m_size
        for key, got in leaves.items():
            i, name = key.split("/")
            whole = np.asarray(jstate[int(i)][name])
            w = whole.shape[-1] // m_size
            np.testing.assert_allclose(got, whole[..., m * w:(m + 1) * w],
                                       rtol=1e-5, atol=1e-6)
            checked += 1
    assert checked == 4 * 4  # 2 attention layers x (k, v) x 4 ranks
    whole_bytes = runs["port"]["4x1"]["bytes"]["state"]
    assert port["bytes"]["state"] * m_size == whole_bytes


@pytest.mark.parametrize("layout", [sc["layout"] for sc in LAYOUTS
                                    if sc.get("spec")])
def test_speculative_streams_under_a_model_axis_equal_k1(runs, layout):
    port = runs["port"][layout]
    assert port["spec"] == port["dense"]


@pytest.mark.parametrize("layout", [sc["layout"] for sc in LAYOUTS
                                    if sc.get("spec")])
def test_a_collected_batchers_prefix_rows_leave_every_rank(runs, layout):
    """A prefix-cache batcher's kept rows (each rank its own K/V columns
    under a model axis) leave rank 0's cache when the batcher is collected,
    and the other ranks' with rank 0's next call; its tokens are the
    table's."""
    port = runs["port"][layout]
    assert port["prefix"] == port["dense"]
    assert port["kept_held"] >= 1 and port["kept_left"] == 0
    assert port["kept"] == [0, 0, 0]


def test_a_follower_that_raises_ends_rank0s_call(runs):
    """Rank 1's armed `serve.follower` fault ends rank 0's `output` with
    its error at once (no hang), and the next call is served."""
    port = runs["port"]["2x2"]
    assert port["fault"] and "rank 1" in port["fault"]
    assert "FaultInjected" in port["fault"]
    assert port["fault_s"] < 30.0
    np.testing.assert_array_equal(port["arrays"]["y_after_fault"],
                                  port["arrays"]["y"])


def test_two_d_keys_are_jaxs(runs):
    """The output and decode keys at 2 x 2 are JAX's tuples: the plan's
    tag on both, the decode signature over the whole state's shapes."""
    got = {k for k in runs["port"]["2x2"]["keys"]}
    for key in runs["jax"]["keys_2x2"]:
        assert repr(key) in got


def test_per_rank_param_bytes_fall_with_the_model_axis(runs):
    whole = runs["port"]["4x1"]["bytes"]["params"]
    assert runs["port"]["2x2"]["bytes"]["params"] < whole
    assert (runs["port"]["1x4"]["bytes"]["params"]
            < runs["port"]["2x2"]["bytes"]["params"])


def test_the_ranks_import_no_jax(runs):
    assert runs["imports"] == [[], [], [], []]
