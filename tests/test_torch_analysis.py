"""The port's static-analysis layer on the CPU, held to the JAX package's.

The same seeded defect functions, audited by both packages (the JAX
package traces a jaxpr; the port runs the function once on clones under a
recording dispatch mode), give the same rule ids; the same synthetic
sources through both `lint_source`s give equal findings for every rule the
port keeps as JAX's; both reports render alike. The port's tree lints
clean, its attention audit on the CPU says that the plain version
materializes the scores (and the detector fires on it), its decode audit
is clean, speculative decoding emits JAX's plain greedy tokens, and
`python -m deeplearning4j_tpu_torch.cli analyze --device cpu` exits 0 with
JAX's report schema.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.analysis import program_audit as jax_pa  # noqa: E402
from deeplearning4j_tpu.analysis import repo_lint as jax_lint  # noqa: E402
from deeplearning4j_tpu.analysis import report as jax_report  # noqa: E402
from deeplearning4j_tpu_torch import analysis  # noqa: E402
from deeplearning4j_tpu_torch.analysis import program_audit as pa  # noqa: E402
from deeplearning4j_tpu_torch.analysis import repo_lint  # noqa: E402
from deeplearning4j_tpu_torch.analysis.report import (  # noqa: E402
    REPORT_VERSION, Finding, at_or_above, counts, render_text, to_report)
from deeplearning4j_tpu_torch.optimize.step_cache import (  # noqa: E402
    TensorSpec)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _rules(findings):
    return [f.rule for f in findings]


# -- report model --------------------------------------------------------------

def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError):
        Finding("r", "fatal", "x:1", "m")


def test_report_schema_rendering_and_all_equal_jax():
    rows = [("a", "info", "x:1", "m"), ("b", "error", "y:2", "m2"),
            ("c", "warn", "z:3", "m3"), ("b", "error", "a:1", "m4")]
    fs = [Finding(*r) for r in rows]
    jfs = [jax_report.Finding(*r) for r in rows]
    rep = to_report(fs, {"files": 3})
    assert rep == jax_report.to_report(jfs, {"files": 3})
    assert rep["version"] == REPORT_VERSION == jax_report.REPORT_VERSION
    assert [f["severity"] for f in rep["findings"]] == \
        ["error", "error", "warn", "info"]
    assert render_text(fs, {"files": 3}) == \
        jax_report.render_text(jfs, {"files": 3})
    assert _rules(at_or_above(fs, "warn")) == ["b", "c", "b"]
    assert counts([]) == {"info": 0, "warn": 0, "error": 0}
    from deeplearning4j_tpu import analysis as jax_analysis
    assert analysis.__all__ == jax_analysis.__all__


# -- the same seeded defects through both auditors -----------------------------

S, D = 600, 8


def _jax_cases():
    q = jax.ShapeDtypeStruct((S, D), jnp.float32)

    def full_attention(q, k, v):
        scores = jnp.einsum("sd,td->st", q, k) / np.sqrt(D).astype("f")
        return jax.nn.softmax(scores, axis=-1) @ v

    def cb(x):
        return jax.pure_callback(lambda a: np.asarray(a),
                                 jax.ShapeDtypeStruct(x.shape, x.dtype), x)

    big = np.zeros((600, 600), np.float32)
    coll = jax.vmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")
    with jax.enable_x64(True):
        f64 = jax.make_jaxpr(lambda x: x * 2.0)(jnp.zeros((3,), jnp.float64))
    return {
        "attention": jax_pa.audit_fn(full_attention, (q, q, q), where="a",
                                     seq_threshold=512),
        "f64": jax_pa.audit_jaxpr(f64, where="f64"),
        "promotion": jax_pa.audit_fn(lambda x: x.astype(jnp.float32) * 2,
                                     (jnp.zeros((2,), jnp.bfloat16),),
                                     where="p", policy="bf16"),
        "host": jax_pa.audit_fn(cb, (jnp.ones(3),), where="cb"),
        "collective": jax_pa.audit_fn(coll, (jnp.ones((2, 3)),), where="c",
                                      single_chip=True),
        "constant": jax_pa.audit_fn(lambda x: x + big,
                                    (jnp.zeros((600, 600)),), where="k"),
    }


@pytest.fixture(scope="module")
def gloo_group():
    """A one-rank gloo group for the collective defect (a test that finds
    one already running uses it)."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield dist
    if started:
        dist.destroy_process_group()


def _port_cases(dist):
    q = torch.zeros(S, D)

    def full_attention(q, k, v):
        scores = q @ k.T / float(np.sqrt(D))
        return torch.softmax(scores, dim=-1) @ v

    def collective(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    big = torch.zeros(600, 600)
    return {
        "attention": pa.audit_fn(full_attention, (q, q, q), where="a",
                                 seq_threshold=512),
        "f64": pa.audit_fn(lambda x: x * 2.0,
                           (torch.zeros(3, dtype=torch.float64),),
                           where="f64"),
        "promotion": pa.audit_fn(lambda x: x.float() * 2,
                                 (torch.zeros(2, dtype=torch.bfloat16),),
                                 where="p", policy="bf16"),
        "host": pa.audit_fn(lambda x: x * x.sum().item(), (torch.ones(3),),
                            where="cb"),
        "collective": pa.audit_fn(collective, (torch.ones(2, 3),),
                                  where="c", single_chip=True),
        "constant": pa.audit_fn(lambda x: x + big, (torch.zeros(600, 600),),
                                where="k"),
    }


def test_seeded_defects_give_jaxs_rule_ids(gloo_group):
    want = {k: sorted(_rules(v)) for k, v in _jax_cases().items()}
    got = {k: sorted(_rules(v)) for k, v in _port_cases(gloo_group).items()}
    assert got == want
    assert got == {"attention": ["materialized-scores"], "f64": ["f64-op"],
                   "promotion": ["dtype-promotion"],
                   "host": ["host-callback"],
                   "collective": ["collective-in-single-chip"],
                   "constant": ["folded-constant"]}
    # severities are JAX's too
    port = _port_cases(gloo_group)
    assert port["promotion"][0].severity == "warn"
    assert all(f.severity == "error" for k, fs in port.items()
               if k != "promotion" for f in fs)


def test_clean_twins_give_no_finding(gloo_group):
    def collective(x):
        y = x.clone()
        gloo_group.all_reduce(y)
        return y

    small = torch.zeros(8, 8)
    assert pa.audit_fn(lambda x: x * 2.0, (torch.zeros(3),), where="f") == []
    assert pa.audit_fn(lambda x: x.float() * 2,
                       (torch.zeros(2, dtype=torch.bfloat16),), where="p",
                       policy="f32") == []
    assert pa.audit_fn(collective, (torch.ones(2, 3),), where="c",
                       single_chip=False) == []
    assert pa.audit_fn(lambda x: x + small, (torch.zeros(8, 8),),
                       where="k") == []
    # a host read of a constant the program made itself reads no data
    assert pa.audit_fn(lambda x: x * float(torch.tensor(2.0)),
                       (torch.ones(3),), where="h") == []
    with pytest.raises(AssertionError):
        pa.assert_no_materialized_scores(
            lambda a: a @ a.T, (torch.zeros(600, 4),), 512, "naive")
    pa.assert_no_materialized_scores(lambda a: a.T @ a,
                                     (torch.zeros(600, 4),), 512, "gram")


def test_rectangular_scores_flagged_and_param_shapes_exempt():
    # a prefill of 600 queries attending over a 1024-long cache keeps a
    # rectangular [1,1,600,1024] score tensor: flagged, as JAX flags it
    def full_attention(q, k):
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        return torch.softmax(scores, dim=-1)

    def jax_full_attention(q, k):
        return jax.nn.softmax(jnp.einsum("bqhd,bkhd->bhqk", q, k), axis=-1)

    q, k = np.zeros((1, 600, 1, D), "f"), np.zeros((1, 1024, 1, D), "f")
    got = pa.audit_fn(full_attention, (torch.from_numpy(q),
                                       torch.from_numpy(k)),
                      where="rect", seq_threshold=512)
    want = jax_pa.audit_fn(jax_full_attention, (q, k), where="rect",
                           seq_threshold=512)
    assert _rules(got) == _rules(want) == ["materialized-scores"]
    assert "(1, 1, 600, 1024)" in got[0].message

    # a weight at the scale, its transpose and its gradient are no scores
    # once the weight is named a param; unnamed, the weight is flagged
    def dense_grad(w, x):
        with torch.enable_grad():
            return torch.autograd.grad((x @ w).sum(), w)[0]

    w = torch.zeros(800, 600, requires_grad=True)
    x = torch.zeros(4, 800)
    assert _rules(pa.audit_fn(dense_grad, (w, x), where="w",
                              seq_threshold=512)) == ["materialized-scores"]
    assert pa.audit_fn(dense_grad, (w, x), params=w, where="w",
                       seq_threshold=512) == []

    # so is a view of a weight (the recurrent block of a fused LSTM W) and
    # its gradient
    def block_grad(w, x):
        with torch.enable_grad():
            return torch.autograd.grad((x @ w[200:]).sum(), w)[0]

    assert pa.audit_fn(block_grad, (w, torch.zeros(4, 600)), params=w,
                       where="w", seq_threshold=512) == []


def test_recording_walks_ops_and_runs_on_clones():
    x = torch.ones(4, 4)

    def fn(a):
        a.add_(1.0)
        return (a @ a).relu()

    rec, out = pa.record_program(fn, (x,))
    assert [op.name for op in pa.iter_eqns(rec)] == \
        ["aten.add_.Tensor", "aten.mm.default", "aten.relu.default"]
    assert (4, 4) in pa.collect_shapes(rec)
    assert torch.equal(x, torch.ones(4, 4))  # the caller's tensor is intact
    assert torch.equal(out, torch.full((4, 4), 16.0))
    assert rec.launches == {}


# -- cache records ---------------------------------------------------------------

class FakeCache:
    def __init__(self, recs):
        self._recs = recs

    def audit_records(self):
        return list(self._recs)


def _spec(shape, device=CPU, dtype=torch.float32):
    return TensorSpec(tuple(shape), dtype, device)


def _rec(kind, key, build, write=None, in_place=None, plan=None,
         layout=None, abstract=None):
    return {"key": key, "kind": kind, "build": build, "write": write,
            "abstract": abstract or (_spec((2, 2)), _spec((2, 2))),
            "in_place": write is not None if in_place is None else in_place,
            "mesh": False, "plan": plan, "layout": layout}


@pytest.mark.parametrize("kind", ["step-cache", "dp-step-cache"])
def test_undonated_step_via_cache_records(kind):
    def write(p, out):
        p.copy_(out)
        return out

    rec = _rec(kind, ("step", (("policy", "f32"),)),
               lambda: (lambda p, x: p + x))
    assert _rules(pa.audit_cache(FakeCache([rec]),
                                 expect_donation=True)) == ["undonated-step"]
    # written in place, or not expected (the CPU, by default): clean
    assert pa.audit_cache(FakeCache([dict(rec, write=write,
                                          in_place=True)]),
                          expect_donation=True) == []
    assert pa.audit_cache(FakeCache([rec])) == []
    assert pa.audit_cache(FakeCache([rec]), expect_donation=False) == []


@pytest.mark.parametrize("entry,rule", [
    ("decode", "undonated-kv-cache"), ("prefill", "undonated-kv-cache"),
    ("verify", "undonated-kv-cache"), ("prefill-logp", "undonated-kv-cache"),
    ("decode-multi[4]", "undonated-kv-cache"),
    ("decode-paged", "undonated-kv-pages"),
    ("verify-paged", "undonated-kv-pages"),
    ("decode-multi-paged[4]", "undonated-kv-pages")])
def test_undonated_kv_state_via_cache_records(entry, rule):
    """A generation program whose new state neither aliases its state
    input nor is written back into it is flagged where in-place updates
    are expected; one that writes the state in place is clean."""
    state = (_spec((2, 3)),)
    abstract = ((_spec((2, 3)), state), _spec((2,), dtype=torch.int32))

    def fresh():
        return lambda ps, tok: (tok, (ps[1][0] + 1.0,))

    def in_place():
        return lambda ps, tok: (tok, (ps[1][0].add_(1.0),))

    rec = _rec("infer-cache", (entry, "fp", ((2,), "int32"), "single"),
               fresh, abstract=abstract)
    assert _rules(pa.audit_cache(FakeCache([rec]),
                                 expect_donation=True)) == [rule]
    assert pa.audit_cache(FakeCache([dict(rec, build=in_place)]),
                          expect_donation=True) == []
    assert pa.audit_cache(FakeCache([dict(rec, in_place=True)]),
                          expect_donation=True) == []
    assert pa.audit_cache(FakeCache([dict(
        rec, key=("output",) + rec["key"][1:])]),
        expect_donation=True) == []
    assert pa.audit_cache(FakeCache([rec]), expect_donation=False) == []


def test_replicated_large_leaf_rule():
    """On a plan with a model axis of M > 1, a param leaf >= the threshold
    that the model axis leaves whole is an error; a split leaf, a small
    leaf and a plan without a model axis are clean."""
    class Plan:
        def __init__(self, m):
            self.model_size = m

    params = ({"Wqkv": _spec((16, 48)), "b": _spec((4,))},)
    build = (lambda: (lambda p, x: x))

    def rec(plan, layout):
        return _rec("infer-cache", ("output", "fp", ((8, 4), "float32"),
                                    ("mesh", ("batch", "model"), (1, 2))),
                    build, plan=plan, layout=layout,
                    abstract=(params, _spec((8, 4))))

    fs = pa.audit_cache(FakeCache([rec(Plan(2), {})]),
                        replicated_leaf_threshold=256)
    assert _rules(fs) == ["replicated-large-leaf"]
    assert fs[0].severity == "error" and "(16, 48)" in fs[0].message
    assert pa.audit_cache(FakeCache([rec(Plan(2), {(0, "Wqkv"): "split"})]),
                          replicated_leaf_threshold=256) == []
    assert pa.audit_cache(FakeCache([rec(Plan(2), {})]),
                          replicated_leaf_threshold=1 << 20) == []
    assert pa.audit_cache(FakeCache([rec(Plan(1), {})]),
                          replicated_leaf_threshold=256) == []
    assert pa.audit_cache(FakeCache([rec(None, None)]),
                          replicated_leaf_threshold=256) == []


def test_real_caches_keep_audit_records_and_audit_clean():
    from deeplearning4j_tpu_torch.models.zoo import lenet5
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(lenet5(), device="cpu", seed=0).init()
    x = np.zeros((2, 1, 28, 28), np.float32)
    before = [t.clone() for t in torch.utils._pytree.tree_leaves(
        net.params)]
    net.output(x)
    net.finetune(x, np.full((2, 10), 0.1, np.float32))
    recs = net.infer_cache.audit_records() + net.step_cache.audit_records()
    assert {r["kind"] for r in recs} == {"infer-cache", "step-cache"}
    assert all(set(r) == {"key", "kind", "build", "write", "abstract",
                          "in_place", "mesh", "plan", "layout"}
               for r in recs)
    assert [r["in_place"] for r in net.step_cache.audit_records()] == [True]
    after = [t.clone() for t in torch.utils._pytree.tree_leaves(net.params)]
    assert pa.audit_cache(net.infer_cache) == []
    assert pa.audit_cache(net.step_cache) == []
    # the audit ran on fresh tensors: the network's params did not move
    for a, b in zip(after, torch.utils._pytree.tree_leaves(net.params)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


# -- the structure audits ------------------------------------------------------

def test_attention_audit_on_the_cpu_says_the_plain_version_materializes():
    fs = pa.audit_attention_structure(device="cpu")
    assert [(f.rule, f.severity) for f in fs] == \
        [("materialized-scores", "info")]
    assert "flash_attention_reference" in fs[0].message
    # the detector fires on the plain version called directly
    from deeplearning4j_tpu_torch.nd import kernels

    q = torch.randn(1, 1024, 1, 8)
    direct = pa.audit_fn(kernels.flash_attention_reference, (q, q, q, True),
                         where="plain", seq_threshold=1024)
    assert _rules(direct) == ["materialized-scores"]
    assert direct[0].severity == "error"


def test_decode_structure_audit_is_clean():
    assert pa.audit_decode_structure(device="cpu") == []


def test_spec_parity_tokens_are_jaxs_plain_greedy_tokens():
    """With JAX's params carried across, the port's plain and speculative
    (char-LSTM draft, spec_k=3) greedy tokens both equal the JAX batcher's
    plain greedy tokens, on both zoo targets; the audit itself is clean."""
    from deeplearning4j_tpu.nn.multilayer import \
        MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu.serving.batcher import \
        ContinuousBatcher as JaxBatcher
    from deeplearning4j_tpu_torch.models.zoo import char_lstm
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        params_from_numpy

    for name, conf in pa.spec_parity_confs().items():
        jnet = JaxNet(jax_pa_conf(name), seed=0).init()
        b = JaxBatcher(jnet, n_slots=2, max_seq=16, prompt_buckets=(8,))
        b.start()
        streams = [b.submit(list(p), max_new_tokens=8, temperature=0.0,
                            rng_seed=i)
                   for i, p in enumerate(pa.SPEC_PROMPTS)]
        want = [list(s.tokens(timeout=120)) for s in streams]
        b.stop()
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(conf.to_json()),
            device="cpu")
        net.params = params_from_numpy(jax.device_get(jnet.params), "cpu")
        draft = MultiLayerNetwork(char_lstm(pa.SPEC_VOCAB, hidden=8,
                                            n_layers=1),
                                  device="cpu", seed=1).init()
        assert pa.greedy_tokens(net) == want, name
        assert pa.greedy_tokens(net, draft_net=draft, spec_k=3) == want, name
    assert pa.audit_spec_decode_parity(device="cpu") == []


def jax_pa_conf(name):
    from deeplearning4j_tpu.models.zoo import char_lstm, char_transformer

    if name == "char_lstm":
        return char_lstm(pa.SPEC_VOCAB, hidden=16, n_layers=2)
    return char_transformer(pa.SPEC_VOCAB, d_model=16, n_blocks=2,
                            n_heads=2, max_seq_len=32)


# -- repo linter: the same synthetic sources through both ------------------------

def _metrics_src(body):
    return ('FAMILIES = {\n'
            '    "dl4j_x_total": ("counter", ("policy",)),\n'
            '    "dl4j_y": ("gauge", ()),\n'
            '}\n'
            'def emit(p, pol):\n' + textwrap.indent(body, "    "))


_LOCKS = textwrap.dedent("""
    class C:
        def one(self):
            with self._a_lock:
                with self._b_lock:
                    pass
        def two(self):
            with self._b_lock:
                with self._a_lock:
                    pass
""")

_UNGUARDED = textwrap.dedent("""
    import threading
    class D:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0
        def bump(self):
            self._n += 1
        def ok(self):
            with self._lock:
                self._n = 2
        def set_n_locked(self):
            self._n = 3
""")

#: (source, relpath, rules expected) for the rules kept as JAX's
KEPT_CASES = [
    ("DEFAULT_TARGET_ROWS = 256\n", "serving/x.py", ["hardcoded-tunable"]),
    ("_BLOCK_TABLE = {(256, 64): (128, 128, 128, 128)}\n", "nd/x.py",
     ["hardcoded-tunable"]),
    ("b = MicroBatcher(net, max_delay_ms=3.0)\n", "serving/x.py",
     ["hardcoded-tunable"]),
    ("def f(net, n_slots: int = 4):\n    pass\n", "serving/x.py",
     ["hardcoded-tunable"]),
    ("DEFAULT_TARGET_ROWS = 256\n", "optimize/tunables.py", []),
    ("def f(net, n_slots=None):\n"
     "    b = MicroBatcher(net, max_delay_ms=delay)\n", "serving/x.py", []),
    ("b = ContinuousBatcher(net, n_slots=1)"
     "  # lint: allow(hardcoded-tunable)\n", "cli/x.py", []),
    ("import time\nt = time.time()\n", "serving/x.py", ["wall-clock"]),
    ("import time\nt = time.time()\n", "reliability/x.py", ["wall-clock"]),
    ("import time\nt = time.time()\n", "clustering/x.py", []),
    ("import datetime\nn = datetime.datetime.now()\n", "serving/x.py",
     ["wall-clock"]),
    ("import time\nt = time.monotonic()\n", "serving/x.py", []),
    ("import urllib.request\nr = urllib.request.urlopen(url)\n",
     "serving/x.py", ["unbounded-network-call"]),
    ("import socket\ns = socket.create_connection((host, port))\n",
     "serving/x.py", ["unbounded-network-call"]),
    ("import urllib.request\nr = urllib.request.urlopen(url, timeout=2.0)\n",
     "serving/x.py", []),
    ("import socket\ns = socket.create_connection((host, port), 1.0)\n",
     "serving/x.py", []),
    ("import urllib.request\nr = urllib.request.urlopen(url)\n", "cli/x.py",
     []),
    ("import numpy as np\na = np.zeros((3,))\n", "optimize/x.py",
     ["np-default-dtype"]),
    ("import numpy as np\na = np.zeros((3,), dtype=np.float32)\n",
     "optimize/x.py", []),
    ('from x import faults\nfaults.fire("a.b")\n', "serving/x.py", []),
    ('from x import faults\nfaults.fire("zz.q")\n', "serving/x.py",
     ["fault-point"]),
    ("from x import faults\nfaults.fire(name)\n", "serving/x.py",
     ["fault-point"]),
    (_metrics_src('p.counter("dl4j_x_total", "h", 1, {"policy": pol})\n'
                  'p.gauge("dl4j_y", "h", 2)\n'), "serving/metrics.py", []),
    (_metrics_src('p.counter("dl4j_x_total", "h", 1, {"policy": pol})\n'
                  'p.gauge("dl4j_y", "h", 2)\n'
                  'p.gauge("dl4j_rogue", "h", 3)\n'), "serving/metrics.py",
     ["prom-family"]),
    (_metrics_src('p.counter("dl4j_x_total", "h", 1, {"policy": pol})\n'),
     "serving/metrics.py", ["prom-family"]),
    (_metrics_src('p.gauge("dl4j_x_total", "h", 1, {"policy": pol})\n'
                  'p.gauge("dl4j_y", "h", 2)\n'), "serving/metrics.py",
     ["prom-family"]),
    (_metrics_src('p.counter("dl4j_x_total", "h", 1, {"zone": pol})\n'
                  'p.gauge("dl4j_y", "h", 2)\n'), "serving/metrics.py",
     ["prom-family"]),
    (_LOCKS, "serving/x.py", ["lock-order-cycle"]),
    (_LOCKS.split("def two")[0], "serving/x.py", []),
    (_UNGUARDED, "serving/x.py", ["unguarded-shared-write"]),
]


@pytest.mark.parametrize("i", range(len(KEPT_CASES)))
def test_kept_rules_find_what_jax_finds(i):
    src, rel, want = KEPT_CASES[i]
    doc = {"a.b": "doc"}
    got = repo_lint.lint_source(src, rel, documented_points=doc)
    ref = jax_lint.lint_source(src, rel, documented_points=doc)
    assert [f.as_dict() for f in got] == [f.as_dict() for f in ref]
    assert sorted(_rules(got)) == sorted(want)


def test_platform_sniff_flags_the_torch_cuda_queries():
    for q in ("is_available()", "device_count()", "get_device_name(0)",
              "get_device_properties(0)", "get_device_capability(0)"):
        src = f"import torch\nd = torch.cuda.{q}\n"
        fs = repo_lint.lint_source(src, "parallel/x.py")
        assert _rules(fs) == ["platform-sniff"], q
        assert fs[0].severity == "error"
        assert repo_lint.lint_source(src, "nd/platform.py") == []
    ok = "import torch\ntorch.cuda.synchronize()\ns = torch.cuda.Stream()\n"
    assert repo_lint.lint_source(ok, "parallel/x.py") == []
    waived = ("import torch\n"
              "d = torch.cuda.is_available()  # lint: allow(platform-sniff)\n")
    assert repo_lint.lint_source(waived, "parallel/x.py") == []


def test_f64_literal_flags_numpy_and_torch_float64():
    for src in ("import numpy as np\na = np.zeros((3,), np.float64)\n",
                "import torch\na = torch.zeros(3, dtype=torch.float64)\n",
                "import torch\na = x.to(torch.double)\n",
                'import numpy as np\na = np.asarray(x, dtype="float64")\n'):
        fs = repo_lint.lint_source(src, "nn/x.py")
        assert _rules(fs) == ["f64-literal"], src
        assert repo_lint.lint_source(src, "clustering/x.py") == []
    fine = "import torch\na = torch.zeros(3, dtype=torch.float32)\n"
    assert repo_lint.lint_source(fine, "nn/x.py") == []


def test_fault_point_seeded_in_temp_module(tmp_path):
    mod = tmp_path / "chaos.py"
    mod.write_text(textwrap.dedent("""
        from deeplearning4j_tpu_torch.reliability import faults
        def hot_path():
            faults.fire("totally.undocumented")
    """))
    fs = repo_lint.lint_file(str(mod))
    assert _rules(fs) == ["fault-point"]
    assert "totally.undocumented" in fs[0].message


def test_fault_point_unfired_direction_on_package_walk(tmp_path):
    from deeplearning4j_tpu_torch.reliability.faults import DOCUMENTED_POINTS

    (tmp_path / "only.py").write_text(
        'from deeplearning4j_tpu_torch.reliability import faults\n'
        'faults.fire("compile")\n')
    fs, n = repo_lint.lint_package(root=str(tmp_path))
    unfired = {f.message.split("'")[1] for f in fs
               if f.rule == "fault-point"}
    assert n == 1
    assert unfired == set(DOCUMENTED_POINTS) - {"compile"}


def test_registry_matches_the_ports_fire_sites_both_ways():
    """The port's fire("...") sites and its DOCUMENTED_POINTS are the same
    set: JAX's registry plus the port's own `serve.follower`."""
    import ast

    from deeplearning4j_tpu.reliability.faults import \
        DOCUMENTED_POINTS as JAX_POINTS
    from deeplearning4j_tpu_torch.reliability.faults import DOCUMENTED_POINTS

    fired = set()
    root = repo_lint.package_root()
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py") or "faults.py" in fn:
                continue
            with open(os.path.join(dirpath, fn)) as fh:
                tree = ast.parse(fh.read())
            fired |= {p for p, _ in repo_lint._fire_sites(tree, fn)
                      if p is not None}
    assert fired == set(DOCUMENTED_POINTS)
    assert set(DOCUMENTED_POINTS) - set(JAX_POINTS) == {"serve.follower"}
    assert "serving/batcher.py" in DOCUMENTED_POINTS["dispatcher.execute"]
    assert "infer_cache.py" in DOCUMENTED_POINTS["serve.follower"]


def test_real_metrics_module_passes():
    path = os.path.join(REPO_ROOT, "deeplearning4j_tpu_torch", "serving",
                        "metrics.py")
    assert repo_lint.lint_file(path, repo_lint.package_root()) == []


def test_repo_is_lint_clean():
    findings, n_files = repo_lint.lint_package()
    assert repo_lint.package_root().endswith("deeplearning4j_tpu_torch")
    assert n_files > 100
    assert findings == []


# -- the CLI gate ----------------------------------------------------------------

def test_cli_analyze_gate_json_schema():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "analyze",
         "--fail-on", "error", "--format", "json", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO_ROOT, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert set(rep) == {"version", "counts", "checked", "findings"}
    assert rep["version"] == REPORT_VERSION
    assert set(rep["counts"]) == {"info", "warn", "error"}
    assert rep["counts"]["error"] == 0
    assert rep["checked"]["files"] > 100
    assert rep["checked"]["programs"] >= 10
    for f in rep["findings"]:
        assert set(f) == {"rule", "severity", "location", "message"}


def test_cli_analyze_fails_at_the_floor(monkeypatch, capsys):
    """`--fail-on warn` exits 1 once a warning is found; text renders the
    JAX package's summary line."""
    from deeplearning4j_tpu_torch.cli import driver

    monkeypatch.setattr(repo_lint, "lint_package", lambda: (
        [Finding("wall-clock", "warn", "serving/x.py:1", "m")], 120))
    monkeypatch.setattr(analysis, "lint_package", repo_lint.lint_package)
    rc = driver.main(["analyze", "--skip-programs", "--fail-on", "warn"])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.splitlines()[-1].startswith("analyze: 0 error(s), 1 warning")
    assert driver.main(["analyze", "--skip-programs"]) == 0
