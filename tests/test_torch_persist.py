"""The port's persistent store (`optimize/persist.py`) and what goes
through it: the JAX package's `tests/test_persist.py` and
`tests/test_quantize.py` cases that concern byte payloads.

The store: the checksum and the payload-kind guard, corrupt and garbage
entries evicted, the LRU cap and a load's recency, concurrent and sibling
writers, a vanished entry, a foreign platform as a plain miss, and
`DL4J_COMPILE_CACHE`. Through it: the int8 weight artifact (a second
network loads it and calibrates nothing; a corrupt one is evicted and
calibrated again), the continuous batcher's prefix entries (a fresh
batcher serves a prompt from the disk entry with a cold prefill's tokens;
a corrupt entry is a counted miss), and the CLI: `warmup --precision int8`
then `serve` and `generate --compile-cache` in another network or process
calibrate nothing and capture nothing under traffic.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.models.zoo import (char_transformer,  # noqa: E402
                                                 mlp)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import persist as persist_mod  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import quantize  # noqa: E402
from deeplearning4j_tpu_torch.optimize.persist import (  # noqa: E402
    PersistentProgramStore, platform_fingerprint, platform_info)
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher  # noqa: E402,E501

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _store(tmp_path, **kw):
    return PersistentProgramStore(str(tmp_path), device="cpu", **kw)


def _mlp_net(seed=0):
    return MultiLayerNetwork(mlp(n_in=6, hidden=[8], n_out=3, lr=0.05),
                             device="cpu", seed=seed).init()


# -- the store -----------------------------------------------------------------

def test_store_bytes_checksum_and_kind_guard(tmp_path):
    store = _store(tmp_path)
    key = ("quantized-weights", "int8", "fp", "digest")
    assert store.store_bytes(key, b"artifact-bytes")
    assert store.load_bytes(key) == b"artifact-bytes"
    assert store.hits == 1 and store.writes == 1
    # another payload kind under the key is a mismatch: evicted, a miss
    assert store._load_payload(key, "program") is None
    assert store.corrupt_evicted == 1
    assert not os.path.exists(store.path_for(key))
    assert store.load_bytes(key) is None


def test_platform_mismatch_is_a_plain_miss(tmp_path):
    """A foreign platform's entry is not found (its file name differs),
    and moved into place it fails the header check and is evicted."""
    store = _store(tmp_path)
    key = ("k", "fp")
    assert store.store_bytes(key, b"x" * 10)
    foreign = _store(tmp_path)
    foreign._fingerprint = "0" * 16
    assert foreign.load_bytes(key) is None
    os.rename(store.path_for(key), foreign.path_for(key))
    assert foreign.load_bytes(key) is None
    assert foreign.corrupt_evicted == 1
    assert not os.path.exists(foreign.path_for(key))


def test_fingerprint_covers_platform_facts():
    info = platform_info("cpu")
    assert {"format", "backend", "device_kind", "capability", "n_devices",
            "torch", "cuda"} <= set(info)
    assert info["backend"] == "cpu"
    other = dict(info, device_kind="NVIDIA H100 80GB HBM3")
    assert platform_fingerprint(info) != platform_fingerprint(other)


@pytest.mark.parametrize("damage", ["flip", "truncate", "garbage"])
def test_corrupt_and_garbage_entries_are_evicted(tmp_path, damage):
    store = _store(tmp_path)
    key = ("k", damage)
    store.store_bytes(key, bytes(range(200)))
    path = store.path_for(key)
    raw = open(path, "rb").read()
    bad = {"flip": raw[:-5] + b"\xff\xff\xff\xff\xff",
           "truncate": raw[:40],
           "garbage": b"not a cache entry at all"}[damage]
    with open(path, "wb") as f:
        f.write(bad)
    assert store.load_bytes(key) is None
    assert store.corrupt_evicted == 1
    assert not os.path.exists(path)
    assert store.store_bytes(key, b"again") and store.load_bytes(key) == \
        b"again"


def test_lru_cap_evicts_least_recently_used(tmp_path):
    store = _store(tmp_path, max_bytes=1 << 30)
    keys = [("lru", i) for i in range(3)]
    for i, k in enumerate(keys):
        assert store.store_bytes(k, bytes(100 + i))
        os.utime(store.path_for(k), (1000.0 + i, 1000.0 + i))
    sizes = sum(os.path.getsize(store.path_for(k)) for k in keys)
    store.max_bytes = sizes - 1
    assert store.store_bytes(("lru", 3), bytes(50))
    assert not os.path.exists(store.path_for(keys[0]))
    assert store.evictions >= 1
    assert store.total_bytes() <= store.max_bytes
    assert store.load_bytes(("lru", 3)) == bytes(50)


def test_load_refreshes_recency(tmp_path):
    store = _store(tmp_path)
    a, b = ("a",), ("b",)
    store.store_bytes(a, b"1" * 64)
    store.store_bytes(b, b"2" * 64)
    os.utime(store.path_for(a), (1000.0, 1000.0))
    os.utime(store.path_for(b), (2000.0, 2000.0))
    assert store.load_bytes(a) is not None
    store.max_bytes = os.path.getsize(store.path_for(a))
    store._enforce_cap()
    assert os.path.exists(store.path_for(a))
    assert not os.path.exists(store.path_for(b))


def test_concurrent_writers_do_not_clobber(tmp_path):
    """Eight threads writing one key: the entry left is whole and no
    temporary file remains."""
    store = _store(tmp_path)
    key = ("race",)
    blob = os.urandom(4096)
    errs = []

    def write():
        try:
            assert store.store_bytes(key, blob)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=write) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert store.load_bytes(key) == blob
    assert len(store) == 1
    assert not [p for p in tmp_path.iterdir() if p.name.endswith(".tmp")]


def test_sibling_writers_same_key_converge(tmp_path):
    a, b = _store(tmp_path), _store(tmp_path)
    key = ("k", "shared")
    errors = []

    def worker(store):
        try:
            for _ in range(10):
                store.store_bytes(key, b"payload" * 100)
                store.load_bytes(key)
        except BaseException as e:  # noqa: BLE001 — the assertion
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,))
               for s in (a, b, a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert a.load_bytes(key) == b.load_bytes(key) == b"payload" * 100


def test_a_vanished_entry_is_a_plain_miss(tmp_path):
    """A sibling evicts an entry: the next load is a miss, not an error,
    and a rewrite works; a cap sweep over a stale listing counts the
    vanished file as `vanished`, not as an eviction."""
    a, b = _store(tmp_path), _store(tmp_path)
    key = ("infer-cache", "fp")
    assert a.store_bytes(key, b"x" * 32)
    assert b.load_bytes(key) is not None
    b.evict(key)
    assert a.load_bytes(key) is None
    assert a.io_errors == 0 and a.corrupt_evicted == 0
    assert a.store_bytes(key, b"x" * 32) and a.load_bytes(key) is not None
    store = _store(tmp_path / "cap", max_bytes=1)
    for i in range(3):
        store.store_bytes(("k", i), b"y" * 64)
    real = store._entries()
    ghost = os.path.join(store.directory, "0" * 40 + ".ptp")
    store.evictions = store.vanished = 0
    store._entries = lambda: [(ghost, 123, 0.0)] + real
    store._enforce_cap()
    assert store.vanished == 1 and store.evictions >= 1


def test_corrupt_entry_vanishing_under_eviction_counts_vanished(tmp_path,
                                                                monkeypatch):
    store = _store(tmp_path)
    key = ("k", "corrupt-race")
    store.store_bytes(key, b"z" * 64)
    path = store.path_for(key)
    with open(path, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff\xff")
    remove = os.remove

    def racing_remove(p):
        remove(p)  # the sibling wins the race just before our eviction
        raise FileNotFoundError(p)

    monkeypatch.setattr(persist_mod.os, "remove", racing_remove)
    assert store.load_bytes(key) is None
    assert store.vanished == 1 and store.corrupt_evicted == 0


def test_env_var_attaches_store(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_COMPILE_CACHE", str(tmp_path))
    net = MultiLayerNetwork(mlp(n_in=4, hidden=[6], n_out=3), device="cpu")
    assert net.step_cache.persist is not None
    assert net.step_cache.persist.directory == str(tmp_path)
    assert net.infer_cache.persist is net.step_cache.persist
    assert net.infer_cache.persist.platform["backend"] == "cpu"


# -- the int8 artifact -----------------------------------------------------------

def test_int8_artifact_round_trips_through_the_store(tmp_path):
    """A second network of the same conf and params loads the artifact:
    no calibration, no write, the same report and bitwise the same int8
    output."""
    net = _mlp_net()
    net.set_compile_cache(str(tmp_path))
    rep1 = net.set_serve_precision("int8", measure=False)
    assert rep1["artifact"]["source"] == "calibrated"
    assert net.infer_cache.persist.writes == 1
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    out1 = net.output(x)
    net2 = _mlp_net()
    store2 = net2.set_compile_cache(str(tmp_path))
    rep2 = net2.set_serve_precision("int8", measure=False)
    assert rep2["artifact"]["source"] == "disk"
    assert rep2["calibration"] == rep1["calibration"]
    assert store2.writes == 0 and store2.hits == 1
    assert torch.equal(net2.output(x), out1)
    # other params: another digest, so a calibration of its own
    net3 = _mlp_net(seed=5)
    net3.set_compile_cache(str(tmp_path))
    assert net3.set_serve_precision("int8", measure=False)["artifact"][
        "source"] == "calibrated"


def test_corrupt_artifact_is_evicted_and_recalibrated(tmp_path):
    net = _mlp_net()
    net.set_compile_cache(str(tmp_path))
    net.set_serve_precision("int8", measure=False)
    store = net.infer_cache.persist
    key = quantize.quantize_artifact_key(
        net.infer_cache._fingerprint(net.conf),
        quantize.params_digest(net.params))
    with open(store.path_for(key), "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    net2 = _mlp_net()
    store2 = net2.set_compile_cache(str(tmp_path))
    rep = net2.set_serve_precision("int8", measure=False)
    assert rep["artifact"]["source"] == "calibrated"
    assert rep["calibration"]["clip"] in quantize.CLIP_GRID
    assert store2.corrupt_evicted == 1 and store2.writes == 1


# -- the prefix disk store --------------------------------------------------------

def _gen_net(tmp_path, params=None):
    net = MultiLayerNetwork(char_transformer(16, d_model=16, n_blocks=1,
                                             n_heads=2, max_seq_len=32),
                            device="cpu", seed=0)
    if params is None:
        net.init()
    else:
        net.params = params
    net.set_compile_cache(str(tmp_path))
    return net


def _streams(net, prompts, policy="f32"):
    net.set_serve_precision(policy, measure=False)
    cb = ContinuousBatcher(net, n_slots=2, max_seq=32, prompt_buckets=(8,),
                           prefix_cache=True)
    try:
        ss = [cb.submit(p, max_new_tokens=8, temperature=t, rng_seed=3)
              for p, t in prompts]
        return [list(s.tokens(timeout=60)) for s in ss], \
            cb.stats()["prefix_cache"]
    finally:
        cb.stop()


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_prefix_entry_is_a_disk_hit_in_a_fresh_batcher(tmp_path, policy):
    """Batcher A prefills two prompts (one greedy, one sampled) and writes
    them through; a fresh network's batcher on the same directory serves
    both from disk with A's tokens (bf16 K/V rows bit for bit; under int8
    the snapshot is the stored artifact); a corrupt entry is a counted miss
    and a cold prefill with the same tokens."""
    prompts = [([1, 7, 3, 9, 2], 0.0), ([4, 4, 8], 0.8)]
    a = _gen_net(tmp_path)
    want, stats_a = _streams(a, prompts, policy)
    assert stats_a["misses"] == 2 and stats_a["disk_hits"] == 0
    params = tuple({k: v.clone() for k, v in lay.items()}
                   for lay in a.params)
    got, stats_b = _streams(_gen_net(tmp_path, params), prompts, policy)
    assert got == want
    assert stats_b["hits"] == 2 and stats_b["disk_hits"] == 2
    store = a.infer_cache.persist
    for name in os.listdir(store.directory):
        path = os.path.join(store.directory, name)
        with open(path, "r+b") as f:
            f.seek(-8, os.SEEK_END)
            f.write(b"\x00" * 8)
    c = _gen_net(tmp_path, params)
    got, stats_c = _streams(c, prompts, policy)
    assert got == want
    assert stats_c["misses"] == 2 and stats_c["disk_hits"] == 0
    # the prefix entries, and under int8 the weight artifact
    assert c.infer_cache.persist.corrupt_evicted == 2 + (policy == "int8")


@pytest.mark.parametrize("policy", ["f32", "int8"])
def test_prefix_entry_of_other_weights_is_a_miss(tmp_path, policy):
    """Another checkpoint of the same conf on the same store: the entries
    of the first are misses (the digest of the weights served keys them),
    and the second's tokens are its own cold stream's."""
    prompts = [([1, 7, 3, 9, 2], 0.0), ([4, 4, 8], 0.8)]
    a = _gen_net(tmp_path / "shared")
    _streams(a, prompts, policy)
    other = MultiLayerNetwork(a.conf, device="cpu", seed=1).init().params
    want, _ = _streams(_gen_net(tmp_path / "cold", other), prompts, policy)
    got, stats = _streams(_gen_net(tmp_path / "shared", other), prompts,
                          policy)
    assert got == want
    assert stats["misses"] == 2 and stats["disk_hits"] == 0


def test_prefix_disk_store_keeps_to_one_rank_under_a_model_axis(tmp_path):
    """Under a model axis each rank holds its own heads' K/V columns: the
    disk store is not used (entries stay in memory)."""
    net = _gen_net(tmp_path)
    net.set_serve_mesh(spec="batch=1,model=1")
    _, stats = _streams(net, [([1, 2, 3], 0.0)])
    assert stats["misses"] == 1
    assert len(net.infer_cache.persist) == 0


# -- the CLI ---------------------------------------------------------------------

def _checkpoint(tmp_path):
    net = MultiLayerNetwork(char_transformer(16, d_model=16, n_blocks=1,
                                             n_heads=2, max_seq_len=32),
                            device="cpu", seed=0).init()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, net.params, conf=net.conf)
    return ckpt


def _last(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_warmup_then_serve_and_generate_calibrate_and_capture_nothing(
        tmp_path, capsys, monkeypatch):
    """`warmup --precision int8 --generate` fills the store; `serve
    --precision int8` (a fresh network) loads the artifact, captures its
    buckets before listening and nothing under traffic; `generate
    --compile-cache` in another process captures nothing after its
    warm-up."""
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    ckpt, cache = _checkpoint(tmp_path), str(tmp_path / "cache")
    gen = ["--gen-slots", "2", "--gen-max-seq", "32",
           "--gen-prompt-buckets", "8"]
    assert main(["warmup", "--model", ckpt, "--compile-cache", cache,
                 "--shapes", "2x16", "--precision", "int8", "--generate",
                 *gen, "--device", "cpu"]) == 0
    warm = _last(capsys.readouterr().out)
    assert warm["precision"] == "int8"
    assert warm["precision_report"]["artifact"]["source"] == "calibrated"
    assert warm["disk_cache"]["entries"] == 1
    assert warm["infer_cache"]["misses"] >= 2

    seen = {}

    def traffic(self):
        from urllib.request import Request, urlopen

        x = np.random.RandomState(0).randint(0, 16, (2, 16))
        for _ in range(3):
            req = Request(self.url + "/v1/predict", method="POST",
                          data=json.dumps({"features": x.tolist(),
                                           "dtype": "int32"}).encode(),
                          headers={"Content-Type": "application/json"})
            with urlopen(req, timeout=60) as r:
                seen.setdefault("answers", []).append(json.loads(r.read()))
        seen["stats"] = self.stats()

    monkeypatch.setattr(ModelServer, "wait_for_stop", traffic)
    assert main(["serve", "--model", ckpt, "--compile-cache", cache,
                 "--precision", "int8", "--shapes", "2x16", "--port", "0",
                 "--generate", *gen, "--device", "cpu"]) == 0
    startup = json.loads(capsys.readouterr().out.splitlines()[0])
    assert startup["precision"] == "int8"
    assert startup["precision_report"]["artifact"]["source"] == "disk"
    assert startup["precision_report"]["calibration"] == \
        warm["precision_report"]["calibration"]
    assert startup["disk_cache"]["writes"] == 0
    stats = seen["stats"]
    assert stats["precision"]["policy"] == "int8"
    assert stats["precision"]["rows_by_policy"] == {"int8": 6}
    assert stats["fresh_compiles"] == startup["fresh_compiles"] > 0
    assert {r["policy"] for r in stats["programs"]} == {"int8"}

    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
                        "generate", "--model", ckpt, "--compile-cache",
                        cache, "--prompt", "1,2,3", "--max-new-tokens", "6",
                        "--max-seq", "32", "--device", "cpu"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = _last(r.stdout)
    assert out["n_tokens"] == 6 and out["fresh_compiles"] == 0
    assert out["disk_cache"]["dir"] == os.path.abspath(cache)
