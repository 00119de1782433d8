"""The port's autotuner (`optimize/tune.py`) and cost model
(`optimize/profiling.py`) held to the JAX package's.

Profiling: `transformer_step_costs` (every backward mode), the pruning
signal `attention_block_bytes` and `breakdown` equal JAX's exactly; the
counted total of one char-transformer step (`compiled_totals`:
`FlopCounterMode` plus the flash kernels by formula) meets the analytic
GEMM figure and the kernels' own products.

Tune: `_Search.pick` and `_prune` under a clock that is a function of the
candidate give JAX's winners, counters and group reports; `tune_model`
under an injected clock gives JAX's serve-group report and entries (the
`tune.measure` fault included); a failed capture leaves the cache usable;
`tune_and_store` persists a table that a second call (and a fresh CLI
process) inherits with fresh_tunes == 0, and the caches, the batcher and
`warmup_generate` then run at the table's values.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.optimize import profiling as jprof  # noqa: E402
from deeplearning4j_tpu.optimize import tunables as jt  # noqa: E402
from deeplearning4j_tpu.optimize import tune as jtune  # noqa: E402
from deeplearning4j_tpu_torch.models.zoo import (char_transformer,  # noqa: E402
                                                 mlp)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import profiling as pprof  # noqa: E402
from deeplearning4j_tpu_torch.optimize import tunables as pt  # noqa: E402
from deeplearning4j_tpu_torch.optimize import tune as ptune  # noqa: E402
from deeplearning4j_tpu_torch.optimize.persist import \
    PersistentProgramStore  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    from deeplearning4j_tpu.reliability import faults as jfaults

    for mod in (pt, jt):
        mod.clear()
    faults.reset()
    jfaults.reset()
    yield
    for mod in (pt, jt):
        mod.clear()
    faults.reset()
    jfaults.reset()


def _mlp_conf(pkg):
    return pkg.mlp(n_in=4, hidden=[6], n_out=3, lr=0.05)


def _nets(conf_fn):
    """The same conf in both packages (the port's on the CPU)."""
    from deeplearning4j_tpu.models import zoo as jzoo
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.models import zoo as pzoo

    jnet = JNet(conf_fn(jzoo), seed=0).init()
    pnet = MultiLayerNetwork(conf_fn(pzoo), device="cpu", seed=0).init()
    return jnet, pnet


def _step_clock():
    """A clock that moves 1.0 a call: every measurement takes one unit."""
    state = [0.0]

    def clock():
        state[0] += 1.0
        return state[0]
    return clock


# -- profiling --------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "fused", "recompute"])
@pytest.mark.parametrize("sparse", [False, True])
def test_transformer_step_costs_equal_jaxs(mode, sparse):
    kw = dict(batch=32, seq=512, d_model=2048, n_blocks=8, vocab=256,
              n_params=404_963_584, dtype_bytes=2, sparse_labels=sparse,
              attention_bwd_mode=mode)
    mine, ref = (pprof.transformer_step_costs(**kw),
                 jprof.transformer_step_costs(**kw))
    assert list(mine) == list(ref)
    assert {k: tuple(v) for k, v in mine.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    assert pprof.CATEGORIES == jprof.CATEGORIES
    assert pprof.ATTENTION_BWD_MODES == jprof.ATTENTION_BWD_MODES
    with pytest.raises(ValueError):
        pprof.transformer_step_costs(**dict(kw, attention_bwd_mode="x"))


def test_attention_block_bytes_equal_jaxs():
    for seq in (64, 200, 512, 1024, 4096):
        for hd in (32, 64, 128):
            for bq in (16, 64, 128, 256):
                for bk in (32, 64, 128, 512):
                    for size in (2, 4):
                        assert pprof.attention_block_bytes(
                            seq, hd, bq, bk, size) == \
                            jprof.attention_block_bytes(seq, hd, bq, bk,
                                                        size)


@pytest.mark.parametrize("totals,step_s", [
    (None, None), (None, 0.165), ({"flops": 3.0e14, "bytes": 0.0}, 0.165),
    ({"flops": 1.0e9, "bytes": 5.0e8}, None)])
def test_breakdown_equals_jaxs(totals, step_s):
    kw = dict(batch=4, seq=64, d_model=64, n_blocks=2, vocab=32,
              n_params=123_456)
    mine = pprof.breakdown(pprof.transformer_step_costs(**kw), totals,
                           step_s)
    ref = jprof.breakdown(jprof.transformer_step_costs(**kw), totals,
                          step_s)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)


def test_counted_totals_meet_the_analytic_gemms_and_the_kernels():
    """One train step of a small char-transformer (fused flash backward)
    under `compiled_totals`: the counted GEMM flops are the analytic
    6 * P_mm * tokens (qkv, proj, FFN and logits, forward and both
    gradients) within 1 %, and the attention part is the kernels' formula
    (forward 4u, dK/dV 8u, dQ 6u, delta 2 B S H D a block), with the CPU
    plain version's own products taken back."""
    from deeplearning4j_tpu_torch.nn.multilayer import network_loss
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    b, s, d, blocks, heads, vocab = 2, 16, 32, 2, 4, 24
    conf = char_transformer(vocab, d_model=d, n_blocks=blocks,
                            n_heads=heads, max_seq_len=s,
                            attention_fused_bwd=True)
    conf = conf.replace(confs=tuple(c.replace(attention_impl="flash")
                                    for c in conf.confs))
    net = MultiLayerNetwork(conf, device="cpu", seed=0).init()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, vocab, (b, s)).astype(np.int64))
    y = torch.zeros(b * s, vocab)
    y[torch.arange(b * s), torch.from_numpy(rng.randint(0, vocab, b * s))] \
        = 1.0
    leaves = [t.requires_grad_(True) for t in tree_leaves(net.params)]

    def step():
        loss = network_loss(conf, net.params, x, y)
        torch.autograd.grad(loss, leaves)

    totals = pprof.compiled_totals(step)
    tokens = b * s
    p_mm = 12 * blocks * d * d + d * vocab
    assert totals["bytes"] == 0.0
    assert totals["matmul_flops"] == pytest.approx(6.0 * p_mm * tokens,
                                                   rel=0.01)
    unit = float(blocks * tokens * s * d)
    assert totals["attention_flops"] == pytest.approx(
        (4.0 + 8.0 + 6.0) * unit + 2.0 * blocks * tokens * d)
    assert totals["flops"] == pytest.approx(totals["matmul_flops"]
                                            + totals["attention_flops"])
    # the analytic model's GEMM line is the same figure
    costs = pprof.transformer_step_costs(batch=b, seq=s, d_model=d,
                                         n_blocks=blocks, vocab=vocab,
                                         n_params=1,
                                         attention_bwd_mode="fused")
    assert costs["matmul"].flops == 6.0 * p_mm * tokens
    assert costs["attention_fwd"].flops == 4.0 * unit
    # a failing step gives no totals, never an exception
    assert pprof.compiled_totals(lambda: 1 / 0) is None
    # the wrappers are restored
    from deeplearning4j_tpu_torch.nd import kernels
    assert kernels.flash_attn_fwd.__name__ == "flash_attn_fwd"


def test_maybe_trace_is_a_no_op_on_the_cpu(tmp_path):
    with pprof.maybe_trace(str(tmp_path / "trace")):
        pass
    with pprof.maybe_trace(None):
        pass
    assert not os.path.exists(tmp_path / "trace")


# -- the search against JAX's ------------------------------------------------------

def _candidate_clock(times):
    """A clock whose elapsed time over run(c) is times[c]: run(c) moves it
    (the candidate is known where the clock is read)."""
    state = {"t": 0.0}

    def clock():
        return state["t"]

    def run(c):
        state["t"] += times[c]
    return clock, run


SCENARIOS = [
    # (candidates, default, times, throughput: None or "rows")
    ([64, 128, 256, 512, 1024], 256,
     {64: 1.0, 128: 1.5, 256: 2.0, 512: 3.0, 1024: 5.0}, "rows"),
    ([64, 128, 256, 512, 1024], 256,
     {64: 1.0, 128: 2.0, 256: 4.0, 512: 8.0, 1024: 16.0}, "rows"),
    ([1, 2, 4, 8, 16], 4, {1: 1.0, 2: 1.0, 4: 1.0, 8: 1.02, 16: 3.0},
     "rows"),
    ([(128, 128), (128, 64)], (128, 128),
     {(128, 128): 1.0, (128, 64): 0.99}, None),
    ([(64, 32), (64, 64)], (64, 32), {(64, 32): 1.0, (64, 64): 0.5}, None),
    ([(64, 128)], (64, 128), {(64, 128): 2.0}, None),
]


@pytest.mark.parametrize("cands,default,times,tp", SCENARIOS)
@pytest.mark.parametrize("rounds", [1, 3])
def test_search_pick_gives_jaxs_winner_counters_and_report(cands, default,
                                                           times, tp,
                                                           rounds):
    out = []
    for mod in (ptune, jtune):
        clock, run = _candidate_clock(times)
        search = mod._Search(rounds, clock)
        winner = search.pick("g", "k", list(cands), default, run,
                             throughput=(lambda c: float(c)) if tp
                             else None)
        out.append((winner, search.entries, search.groups,
                    search.candidates_measured, search.measure_failures))
    assert out[0] == out[1]
    assert ptune.MIN_GAIN == jtune.MIN_GAIN
    assert ptune.PRUNE_RATIO == jtune.PRUNE_RATIO


PRUNE_CASES = [
    ([1, 2, 3, 10], lambda v, **_: float(v), {}),
    ([(128, 128), (128, 64), (64, 32), (64, 64), (16, 64), (256, 512)],
     lambda v, seq=512, head_dim=128, **_:
     pprof.attention_block_bytes(seq, head_dim, *v),
     {"seq": 512, "head_dim": 128}),
]


@pytest.mark.parametrize("cands,hint,ctx", PRUNE_CASES)
def test_prune_gives_jaxs_survivors_and_counts(cands, hint, ctx):
    out = []
    for mod, tmod in ((ptune, pt), (jtune, jt)):
        search = mod._Search(1, lambda: 0.0)
        tun = tmod.Tunable("t", "s", cands[0], tuple(cands), hint, "")
        kept = mod._prune(search, tun, cands, cands[0], **ctx)
        out.append((kept, search.candidates_pruned))
    assert out[0] == out[1]
    search = ptune._Search(1, lambda: 0.0)
    tun = pt.Tunable("t2", "s", 1, (1, 2), None, "")
    assert ptune._prune(search, tun, [1, 2, 3], 1) == [1, 2, 3]


def _serve_report(rep):
    g = dict(rep["groups"]["serve"]["batcher.target_rows"])
    g.pop("pool_bytes", None)
    return g


def test_serve_group_under_an_injected_clock_is_jaxs():
    jnet, pnet = _nets(_mlp_conf)
    mine = ptune.tune_model(pnet, groups=("serve",), rounds=1, seed=7,
                            clock=_step_clock())
    ref = jtune.tune_model(jnet, groups=("serve",), rounds=1, seed=7,
                           clock=_step_clock())
    assert _serve_report(mine) == _serve_report(ref)
    assert mine["entries"] == ref["entries"]
    assert mine["entries"]["batcher.target_rows"] == 1024
    assert mine["entries"]["infer.bucket_ladder"] == (64, 128, 256, 512,
                                                      1024)
    for key in ("candidates_measured", "candidates_pruned",
                "measure_failures", "rounds", "seed", "tune_seconds",
                "fingerprint"):
        assert mine[key] == ref[key], key
    assert set(mine["groups"]["serve"]["batcher.target_rows"]["pool_bytes"]
               ) == set(mine["groups"]["serve"]["batcher.target_rows"]
                        ["candidates"])


def test_measure_fault_skips_the_candidate_as_in_jax():
    from deeplearning4j_tpu.reliability import faults as jfaults

    jnet, pnet = _nets(_mlp_conf)
    faults.arm("tune.measure", "raise", nth=2)
    mine = ptune.tune_model(pnet, groups=("serve",), rounds=1,
                            clock=_step_clock())
    jfaults.arm("tune.measure", "raise", nth=2)
    ref = jtune.tune_model(jnet, groups=("serve",), rounds=1,
                           clock=_step_clock())
    assert mine["measure_failures"] == ref["measure_failures"] == 1
    assert mine["candidates_measured"] == ref["candidates_measured"] == 4
    assert _serve_report(mine) == _serve_report(ref)


def test_a_failed_capture_is_skipped_and_the_cache_stays_usable():
    """A candidate whose program fails to be made (the `compile` point:
    on the card a capture, an out-of-memory one included) is a counted
    failure; the next candidates are measured and the network serves."""
    pnet = MultiLayerNetwork(_mlp_conf(__import__(
        "deeplearning4j_tpu_torch.models.zoo", fromlist=["mlp"])),
        device="cpu", seed=0).init()
    faults.arm("compile", "raise", nth=2)
    rep = ptune.tune_model(pnet, groups=("serve",), rounds=1,
                           clock=_step_clock())
    assert rep["measure_failures"] == 1 and rep["candidates_measured"] == 4
    measured = rep["groups"]["serve"]["batcher.target_rows"]["candidates"]
    assert "128" not in measured and len(measured) == 4
    out = pnet.output(np.zeros((128, 4), np.float32))
    assert tuple(out.shape) == (128, 3)


def test_decode_group_skips_non_generative_confs():
    pnet = MultiLayerNetwork(mlp(n_in=4, hidden=[6], n_out=3), device="cpu",
                             seed=0).init()
    rep = ptune.tune_model(pnet, groups=("decode",), rounds=1)
    assert rep["entries"] == {} and rep["candidates_measured"] == 0


# -- tune_and_store end to end -------------------------------------------------------

def _transformer(pkg=None, seq=16):
    from deeplearning4j_tpu_torch.models import zoo as pzoo
    return (pkg or pzoo).char_transformer(24, d_model=16, n_blocks=1,
                                          n_heads=2, max_seq_len=seq)


def test_tune_and_store_mlp_persists_and_is_inherited(tmp_path):
    pnet = MultiLayerNetwork(mlp(n_in=4, hidden=[6], n_out=3), device="cpu",
                             seed=0).init()
    store = PersistentProgramStore(str(tmp_path), device="cpu")
    rep = ptune.tune_and_store(pnet, store, groups=("serve",), rounds=1,
                               clock=_step_clock())
    assert rep["tuning"]["source"] == "fresh"
    assert rep["tuning"]["fresh_tunes"] == 1
    assert rep["device_kind"] == "cpu"
    assert pt.load_table(store, rep["fingerprint"], "cpu").entries == \
        rep["entries"]
    pt.clear()
    again = ptune.tune_and_store(pnet, store, groups=("serve",), rounds=1)
    assert again["candidates_measured"] == 0
    assert again["tuning"]["fresh_tunes"] == 0
    assert again["tuning"]["source"] == "disk"
    assert again["entries"] == rep["entries"]


def test_tune_and_store_transformer_all_groups_then_the_call_sites(tmp_path):
    """All three groups on a one-block char-transformer (f32: the f32
    body's tiles at 16x8), persisted and inherited; the serve group is
    JAX's on the same conf and clock. Then a fresh network on the store
    runs at the table's values: the infer cache's buckets, the batcher's
    target and decode table, `warmup_generate`'s programs."""
    from deeplearning4j_tpu.models import zoo as jzoo
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nd import kernels
    from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                          MicroBatcher)

    pnet = MultiLayerNetwork(_transformer(), device="cpu", seed=0).init()
    store = PersistentProgramStore(str(tmp_path), device="cpu")
    rep = ptune.tune_and_store(pnet, store, rounds=1, max_seq=16,
                               clock=_step_clock())
    assert set(rep["groups"]) == {"attention", "serve", "decode"}
    assert rep["measure_failures"] == 0 and rep["candidates_pruned"] == 0
    att = rep["groups"]["attention"]
    fwd = att["attention.block_fwd@16x8"]
    assert set(fwd["candidates"]) == {repr(t) for t in
                                      kernels.fwd_tiles(torch.float32, 8)}
    assert att["attention.block_bwd@16x8"]["winner"] == \
        kernels.bwd_tile(torch.float32, 8)
    # under one unit a measurement every tile ties: the defaults stand
    assert not any(k.startswith("attention.") for k in rep["entries"])
    ref = jtune.tune_model(JNet(_transformer(jzoo), seed=0).init(),
                           groups=("serve",), rounds=1, clock=_step_clock())
    assert _serve_report(rep) == _serve_report(ref)
    assert rep["entries"]["decode.slots"] == 16
    # every K decodes the same 16 tokens a slot in one unit: a tie, and
    # the default K stands
    assert "decode.steps_per_dispatch" not in rep["entries"]

    pt.clear()
    again = ptune.tune_and_store(pnet, store, rounds=1, max_seq=16)
    assert again["candidates_measured"] == 0
    assert again["tuning"] == {"tuned_tables": 1, "fresh_tunes": 0,
                               "entries": len(rep["entries"]),
                               "device_kind": "cpu", "source": "disk"}
    pt.clear()
    fresh = MultiLayerNetwork(_transformer(), device="cpu", seed=1).init()
    fresh.set_compile_cache(str(tmp_path))
    assert pt.status()["source"] == "disk"
    assert fresh.infer_cache.bucket_rows(3) == 64
    mb = MicroBatcher(fresh, auto_start=False)
    assert mb.target_rows == 1024
    summary = fresh.warmup_generate(max_seq=16, prompt_buckets=(4,))
    assert summary["slots"] == 16 and summary["steps_per_dispatch"] == 1
    cb = ContinuousBatcher(fresh, max_seq=16, prompt_buckets=(4,))
    try:
        assert cb.n_slots == 16 and cb.k_max == 1
    finally:
        cb.stop()


def test_cli_tune_then_a_fresh_warmup_inherits(tmp_path):
    """`tune` in one process persists the table; `warmup` in a fresh
    process on the store reports tuned_tables 1 and fresh_tunes 0; the
    tune JSON has the JAX CLI's keys."""
    from deeplearning4j_tpu.cli.driver import main as jmain
    from deeplearning4j_tpu.models import zoo as jzoo

    conf_path = tmp_path / "conf.json"
    conf_path.write_text(mlp(n_in=4, hidden=[6], n_out=3).to_json())
    cache = str(tmp_path / "cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    run = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli"]
    r1 = subprocess.run(run + ["tune", "--model", str(conf_path),
                               "--compile-cache", cache, "--groups", "serve",
                               "--rounds", "1", "--device", "cpu"],
                        env=env, cwd=ROOT, capture_output=True, text=True,
                        timeout=200)
    assert r1.returncode == 0, r1.stderr[-2000:]
    rep = json.loads(r1.stdout.strip().splitlines()[-1])
    assert rep["tuning"]["tuned_tables"] == 1
    assert rep["tuning"]["source"] == "fresh"
    assert rep["candidates_measured"] == 5
    r2 = subprocess.run(run + ["warmup", "--model", str(conf_path),
                               "--compile-cache", cache, "--shapes", "8",
                               "--device", "cpu"],
                        env=env, cwd=ROOT, capture_output=True, text=True,
                        timeout=200)
    assert r2.returncode == 0, r2.stderr[-2000:]
    summary = json.loads(r2.stdout.strip().splitlines()[-1])
    assert summary["tuning"] == dict(rep["tuning"], fresh_tunes=0,
                                     source="disk")

    jconf = tmp_path / "jconf.json"
    jconf.write_text(jzoo.mlp(n_in=4, hidden=[6], n_out=3).to_json())
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jmain(["tune", "--model", str(jconf), "--compile-cache",
                      str(tmp_path / "jcache"), "--groups", "serve",
                      "--rounds", "1"]) == 0
    jrep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(rep) == set(jrep)
    assert rep["entries"].keys() <= {"batcher.target_rows",
                                     "infer.bucket_ladder"}
