"""The port's tunables registry and TunedTable override layer
(`deeplearning4j_tpu_torch/optimize/tunables.py`) held to the JAX
package's `optimize/tunables.py`: the registry's names, subsystems,
defaults, spaces and docs (the two attention tunables name the H100
kernels' tiles), the table's bytes (each package reads the other's),
`resolve` with qualified and bare entries, `decode_k_ladder`, the status
block, the store's device-kind isolation, a corrupt artifact evicted with
one warning, the `tune.load` fault point, and the call sites: with no table
every default is the registry's, and the flash forward's tile resolves
through `attention.block_fwd`.
"""

import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.optimize import tunables as jt  # noqa: E402
from deeplearning4j_tpu_torch.models.zoo import (char_transformer,  # noqa: E402
                                                 mlp)
from deeplearning4j_tpu_torch.nd import kernels  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import tunables as pt  # noqa: E402
from deeplearning4j_tpu_torch.optimize.persist import \
    PersistentProgramStore  # noqa: E402
from deeplearning4j_tpu_torch.optimize.step_cache import (  # noqa: E402
    CompiledProgramCache, conf_fingerprint)
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402

ATTENTION = ("attention.block_fwd", "attention.block_bwd")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_tunables():
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


def _store(path):
    return PersistentProgramStore(str(path), device="cpu")


def _mlp_net():
    return MultiLayerNetwork(mlp(n_in=4, hidden=[6], n_out=3, lr=0.05),
                             device="cpu", seed=0).init()


# -- the registry -------------------------------------------------------------

def test_registry_names_defaults_and_spaces_equal_jaxs():
    assert list(pt.REGISTRY) == list(jt.REGISTRY)
    for name, tun in pt.REGISTRY.items():
        ref = jt.REGISTRY[name]
        assert tun.name == ref.name and tun.default == ref.default
        assert (tun.cost_hint is None) == (ref.cost_hint is None)
        if name in ATTENTION:
            continue
        assert tun.subsystem == ref.subsystem
        assert tun.space == ref.space
        assert tun.doc == ref.doc
    assert pt.SCHEMA_VERSION == jt.SCHEMA_VERSION
    assert not hasattr(pt, "ATTENTION_BLOCK_TABLE")


def test_attention_spaces_are_the_compiled_tiles():
    fwd = {t for dt in (torch.bfloat16, torch.float32)
           for d in (32, 64, 128) for t in kernels.fwd_tiles(dt, d)}
    bwd = {kernels.bwd_tile(dt, d) for dt in (torch.bfloat16, torch.float32)
           for d in (32, 64, 128)}
    assert set(pt.REGISTRY["attention.block_fwd"].space) == fwd
    assert set(pt.REGISTRY["attention.block_bwd"].space) == bwd
    for name in ATTENTION:
        assert pt.default(name) is None
        assert pt.REGISTRY[name].subsystem == "nd/kernels"
    # the pruning hint is the profiling model's bytes, as in JAX
    from deeplearning4j_tpu_torch.optimize.profiling import \
        attention_block_bytes
    hint = pt.REGISTRY["attention.block_fwd"].cost_hint
    assert hint((128, 64), seq=512, head_dim=128) == \
        attention_block_bytes(512, 128, 128, 64)


def test_every_registry_entry_is_well_formed():
    for name, tun in pt.REGISTRY.items():
        assert tun.name == name and "." in name
        assert tun.subsystem and tun.doc
        assert isinstance(tun.space, tuple) and tun.space
        assert tun.default is None or tun.default in tun.space \
            or tun.default == () or name == "batcher.max_delay_ms"


# -- the table's bytes -----------------------------------------------------------

TABLES = [
    ({}, "", "", None),
    ({"batcher.target_rows": 512}, "cpu", "abcd", {"rounds": 3}),
    ({"attention.block_fwd@512x128": (128, 64),
      "infer.bucket_ladder": (8, 64, 256), "decode.slots": 8,
      "batcher.max_delay_ms": 1.0, "unknown.entry": [1, [2, 3]]},
     H100, "0123456789abcdef", {"rounds": 3, "seed": 0}),
]


@pytest.mark.parametrize("entries,kind,fp,meta", TABLES)
def test_table_bytes_are_jaxs_and_each_reads_the_other(entries, kind, fp,
                                                       meta):
    mine = pt.TunedTable(entries, device_kind=kind, fingerprint=fp,
                         meta=meta)
    ref = jt.TunedTable(entries, device_kind=kind, fingerprint=fp, meta=meta)
    assert mine.to_bytes() == ref.to_bytes()
    from_jax = pt.TunedTable.from_bytes(ref.to_bytes())
    from_port = jt.TunedTable.from_bytes(mine.to_bytes())
    assert from_jax.entries == from_port.entries
    assert from_jax.device_kind == kind == from_port.device_kind
    assert from_jax.meta == from_port.meta
    # JSON lists come back as tuples in both
    assert from_jax.to_bytes() == ref.to_bytes()


def test_schema_mismatch_rejected_as_in_jax():
    payload = json.loads(pt.TunedTable({}).to_bytes())
    payload["schema"] = pt.SCHEMA_VERSION + 1
    blob = json.dumps(payload).encode()
    for mod in (pt, jt):
        with pytest.raises(ValueError):
            mod.TunedTable.from_bytes(blob)


def test_table_key_is_jaxs():
    assert pt.table_key("fp", H100) == jt.table_key("fp", H100)


# -- resolve / status --------------------------------------------------------------

RESOLVE_TABLE = {"batcher.target_rows": 512,
                 "attention.block_fwd": (128, 128),
                 "attention.block_fwd@512x128": (128, 64),
                 "decode.slots@ignored": 16,
                 "infer.bucket_ladder": (8, 32)}
QUERIES = [(name, q) for name in pt.REGISTRY
           for q in (None, "512x128", "256x64", "ignored")]


@pytest.mark.parametrize("installed", [False, True])
def test_resolve_matches_jax(installed):
    if installed:
        for mod in (pt, jt):
            mod.install(mod.TunedTable(RESOLVE_TABLE, device_kind="cpu",
                                       fingerprint="f"))
    for name, q in QUERIES:
        assert pt.resolve(name, q) == jt.resolve(name, q), (name, q)


def test_status_and_fresh_counter_match_jax():
    assert pt.status() == jt.status()
    for mod in (pt, jt):
        mod.install(mod.TunedTable({"decode.slots": 8}, device_kind="cpu",
                                   fingerprint="f"), source="disk")
        mod.note_fresh(3)
    assert pt.status() == jt.status()
    assert pt.status()["fresh_tunes"] == 3
    assert pt.active().entries == {"decode.slots": 8}
    pt.clear()
    assert pt.active() is None and pt.status()["tuned_tables"] == 0


def test_decode_k_ladder_equals_jaxs():
    from deeplearning4j_tpu_torch.serving import batcher

    assert batcher.decode_k_ladder is pt.decode_k_ladder
    for k in range(1, 65):
        assert pt.decode_k_ladder(k) == jt.decode_k_ladder(k)
    assert pt.decode_k_ladder(0) == jt.decode_k_ladder(0) == (1,)


# -- persistence ---------------------------------------------------------------------

def test_save_load_and_another_device_kind_is_never_consulted(tmp_path):
    store = _store(tmp_path)
    kind = store.platform["device_kind"]
    assert kind == "cpu"
    fp = "feedc0de"
    pt.save_table(store, pt.TunedTable({"decode.slots": 8},
                                       device_kind=kind, fingerprint=fp))
    back = pt.load_table(store, fp, kind)
    assert back is not None and back.entries == {"decode.slots": 8}
    # a table tuned on the card, in the same directory: another key
    pt.save_table(store, pt.TunedTable({"decode.slots": 16},
                                       device_kind=H100, fingerprint=fp))
    assert pt.load_and_install(store, fp).entries == {"decode.slots": 8}
    pt.clear()
    # a forged payload of another kind under this kind's key: refused
    forged = pt.TunedTable({"decode.slots": 16}, device_kind=H100,
                           fingerprint=fp)
    store.store_bytes(pt.table_key(fp, kind), forged.to_bytes())
    assert pt.load_and_install(store, fp) is None
    assert pt.active() is None and pt.resolve("decode.slots") == 4
    # a table only the card has is not installed on the CPU
    store2 = _store(tmp_path / "only_card")
    pt.save_table(store2, pt.TunedTable({"decode.slots": 16},
                                        device_kind=H100, fingerprint=fp))
    assert pt.load_and_install(store2, fp) is None


def test_corrupt_artifact_evicted_degrades_with_one_warning(tmp_path,
                                                            caplog):
    store = _store(tmp_path)
    fp = "fp"
    pt.save_table(store, pt.TunedTable({"decode.slots": 8},
                                       device_kind="cpu", fingerprint=fp))
    path = store.path_for(pt.table_key(fp, "cpu"))
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        assert pt.load_and_install(store, fp) is None
    assert not os.path.exists(path)
    assert store.corrupt_evicted == 1
    assert pt.resolve("decode.slots") == 4
    # a second failure (the entry is gone: a plain miss) warns no more
    faults.arm("tune.load", "ioerror", times=2)
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        assert pt.load_and_install(store, fp) is None
        assert pt.load_and_install(store, fp) is None
    warnings = [r for r in caplog.records
                if "tuned-table load failed" in r.getMessage()]
    assert len(warnings) == 1


def test_load_fault_degrades_to_defaults_one_warning(tmp_path, caplog):
    store = _store(tmp_path)
    pt.save_table(store, pt.TunedTable({"decode.slots": 8},
                                       device_kind="cpu", fingerprint="fp"))
    faults.arm("tune.load", "ioerror", times=2)
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        assert pt.load_and_install(store, "fp") is None
        assert pt.load_and_install(store, "fp") is None
    warnings = [r for r in caplog.records
                if "tuned-table load failed" in r.getMessage()]
    assert len(warnings) == 1
    assert pt.active() is None and pt.resolve("decode.slots") == 4
    assert pt.load_and_install(store, "fp") is not None
    assert "tune.load" in faults.DOCUMENTED_POINTS
    assert "tune.measure" in faults.DOCUMENTED_POINTS


def test_set_compile_cache_installs_the_table_once(tmp_path):
    net = _mlp_net()
    fp = conf_fingerprint(net.conf)
    pt.save_table(_store(tmp_path), pt.TunedTable(
        {"batcher.target_rows": 512}, device_kind="cpu", fingerprint=fp))
    net.set_compile_cache(str(tmp_path))
    assert pt.status()["source"] == "disk"
    assert pt.resolve("batcher.target_rows") == 512
    # an active table is not replaced by a later attach
    pt.install(pt.TunedTable({"decode.slots": 2}, device_kind="cpu"),
               source="manual")
    _mlp_net().set_compile_cache(str(tmp_path))
    assert pt.status()["source"] == "manual"


# -- the call sites --------------------------------------------------------------------

def test_no_table_call_sites_keep_the_registry_defaults():
    from deeplearning4j_tpu_torch.datasets.iterator import PrefetchIterator
    from deeplearning4j_tpu_torch.serving.batcher import (MicroBatcher,
                                                          decode_geometry)

    net = _mlp_net()
    mb = MicroBatcher(net, auto_start=False)
    assert mb.max_delay_s == pytest.approx(3.0 / 1e3)
    assert mb.target_rows == 256
    geo = decode_geometry()
    assert (geo["slots"], geo["page_size"], geo["k_max"]) == (4, 0, 1)
    assert PrefetchIterator([], device="cpu").buffer_batches == 2
    c = CompiledProgramCache()
    assert c.bucket_rows(5) == 5 and c.buckets == (5,)
    assert kernels.resolve_fwd_tile(torch.bfloat16, 512, 128) == (128, 128)
    assert kernels.resolve_fwd_tile(torch.float32, 512, 128) == (64, 32)
    assert kernels.resolve_fwd_tile(torch.float32, 512, 64) == (64, 64)


def test_a_table_reaches_every_call_site():
    from deeplearning4j_tpu_torch.datasets.iterator import PrefetchIterator
    from deeplearning4j_tpu_torch.serving.batcher import (MicroBatcher,
                                                          decode_geometry)

    pt.install(pt.TunedTable({
        "batcher.target_rows": 512, "batcher.max_delay_ms": 1.0,
        "decode.slots": 2, "decode.page_size": 8,
        "decode.steps_per_dispatch": 4, "data.prefetch_depth": 3,
        "infer.bucket_ladder": (8, 32),
        "attention.block_fwd@512x128": (128, 64)}, device_kind="cpu"))
    net = _mlp_net()
    mb = MicroBatcher(net, auto_start=False)
    assert mb.max_delay_s == pytest.approx(1.0 / 1e3)
    assert mb.target_rows == 512
    # an explicit argument still beats the table
    assert MicroBatcher(net, max_delay_ms=5.0, max_batch_rows=16,
                        auto_start=False).target_rows == 16
    geo = decode_geometry(max_seq=32)
    assert (geo["slots"], geo["page_size"], geo["k_max"]) == (2, 8, 4)
    assert geo["pages_per_slot"] == 4
    assert PrefetchIterator([], device="cpu").buffer_batches == 3
    c = CompiledProgramCache()
    assert c.bucket_rows(5) == 8 and c.bucket_rows(20) == 32
    assert c.bucket_rows(40) == 40 and c.buckets == (8, 32, 40)
    assert kernels.resolve_fwd_tile(torch.bfloat16, 512, 128) == (128, 64)
    assert kernels.resolve_fwd_tile(torch.bfloat16, 256, 128) == (128, 128)
    # a tile the body is not built with raises, never falls back
    with pytest.raises(ValueError, match="built with"):
        kernels.resolve_fwd_tile(torch.float32, 512, 128)


def test_flash_forward_takes_its_tile_and_refuses_others():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float32))
               for _ in range(3))
    want = kernels.flash_attention_reference(q, k, v, True)
    for tile in kernels.fwd_tiles(torch.float32, 8):
        torch.testing.assert_close(kernels.flash_attn_fwd(q, k, v, True,
                                                          tile=tile),
                                   want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="built with"):
        kernels.flash_attn_fwd(q, k, v, True, tile=(64, 64))
    # on the CPU the plain version runs: nothing launches or counts
    assert sum(kernels.TILE_LAUNCHES.values()) == 0


def test_speculation_yields_a_tuned_k_but_not_an_explicit_one():
    from deeplearning4j_tpu_torch.models.zoo import char_lstm
    from deeplearning4j_tpu_torch.serving.batcher import decode_geometry

    draft = MultiLayerNetwork(char_lstm(12, hidden=8), device="cpu",
                              seed=0).init()
    pt.install(pt.TunedTable({"decode.steps_per_dispatch": 8},
                             device_kind="cpu"))
    assert decode_geometry(max_seq=16, draft_net=draft,
                           spec_k=3)["k_max"] == 1
    with pytest.raises(ValueError, match="pinned"):
        decode_geometry(max_seq=16, draft_net=draft, spec_k=3,
                        steps_per_dispatch=4)


def test_warmup_generate_captures_the_tuned_geometry():
    pt.install(pt.TunedTable({"decode.slots": 2,
                              "decode.steps_per_dispatch": 4},
                             device_kind="cpu"))
    net = MultiLayerNetwork(char_transformer(24, d_model=16, n_blocks=1,
                                             n_heads=2, max_seq_len=16),
                            device="cpu", seed=0).init()
    summary = net.warmup_generate(max_seq=16, prompt_buckets=(4,))
    assert summary["slots"] == 2 and summary["steps_per_dispatch"] == 4
    entries = {p["entry"] for p in net.infer_cache.programs_summary()}
    assert {"decode", "decode-multi[1]", "decode-multi[2]",
            "decode-multi[4]"} <= entries
