"""The port's copies of the host-side control plane: the coordinator
(`parallel/coordinator.py`) and the config registry
(`parallel/config_registry.py`), after the JAX package's tests
(tests/test_parallel.py:137-238,322-343 and tests/test_scaleout_nlp.py's
registry cases), with results averaged by the port's `average_pytrees`.
A registry written through one package's server reads back through the
other's client. Neither copy imports JAX; these tests import the JAX
package's registry only for that round trip.
"""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.parallel import config_registry as jax_registry  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel import average_pytrees  # noqa: E402
from deeplearning4j_tpu_torch.parallel.config_registry import (  # noqa: E402
    ConfigRegistry, ConfigRegistryServer, RemoteConfigRegistry)
from deeplearning4j_tpu_torch.parallel.coordinator import (  # noqa: E402
    Job, LocalRunner, StateTracker, start_rest_api)


def test_state_tracker_and_reaper():
    st = StateTracker(stale_after_s=0.0)
    st.add_worker("w0")
    st.add_worker("w1")
    assert set(st.workers()) == {"w0", "w1"}
    assert st.route_job("w0", Job(work=1))
    assert not st.route_job("w0", Job(work=2))  # already working
    assert set(st.reap_stale()) == {"w0", "w1"}
    # the reaped worker's pending job was queued again
    assert st.take_unclaimed() is not None
    st.increment("x", 2.0)
    assert st.count("x") == 2.0


def test_local_runner_bsp_and_rest():
    def perform(w):
        return {"v": torch.tensor(float(w))}

    def aggregate(results):
        return average_pytrees(results) if results else None

    runner = LocalRunner(perform, aggregate, n_workers=3)
    out = runner.run(range(9))
    assert out is not None and np.isfinite(float(out["v"]))
    assert runner.tracker.count("jobs_done") == 9

    server, port = start_rest_api(runner.tracker)
    try:
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/statetracker", timeout=5).read())
        assert body["counters"]["jobs_done"] == 9
        one = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/statetracker/numbatchessofar",
            timeout=5).read())
        assert "numbatchessofar" in one
    finally:
        server.shutdown()


def test_local_runner_hogwild():
    seen = []

    def perform(w):
        seen.append(w)
        return {"v": torch.tensor(1.0)}

    runner = LocalRunner(perform, lambda rs: len(rs), n_workers=2,
                         hogwild=True)
    runner.run(range(5))
    assert len(seen) == 5


def test_local_runner_retains_all_results_per_job():
    """Results are kept per job, not per worker: 9 jobs on 1 worker."""
    runner = LocalRunner(lambda w: w, lambda rs: rs, n_workers=1)
    assert sorted(runner.run(range(1, 10))) == list(range(1, 10))


def test_local_runner_poisoned_job_terminates():
    def perform(w):
        if w == 3:
            raise ValueError("poison")
        return w

    runner = LocalRunner(perform, lambda rs: rs, n_workers=2)
    out = runner.run(range(6))
    assert 3 not in out and len(out) == 5
    assert runner.tracker.count("jobs_failed") >= 1


def test_state_tracker_update_spill_survives_restart(tmp_path):
    spill = str(tmp_path / "updates")
    t1 = StateTracker(update_dir=spill)
    t1.add_worker("w0")
    t1.add_worker("w1")
    t1.add_update("w0", np.arange(4.0))
    t1.add_update("w1", np.arange(4.0) * 2)
    del t1  # the master dies mid-round, before aggregating

    t2 = StateTracker(update_dir=spill)  # restarted over the same spill
    ups = t2.updates()
    assert len(ups) == 2
    np.testing.assert_array_equal(ups[0], np.arange(4.0))
    np.testing.assert_array_equal(ups[1], np.arange(4.0) * 2)
    t2.clear_updates()
    assert t2.updates() == []
    assert StateTracker(update_dir=spill).updates() == []


def test_config_registry_file_backed_roundtrip(tmp_path):
    reg = ConfigRegistry(str(tmp_path))
    reg.register("host1/2510/conf", {"lr": 0.1, "layers": [4, 3]})
    assert reg.retrieve("host1/2510/conf") == {"lr": 0.1, "layers": [4, 3]}
    assert reg.list_keys() == ["host1/2510/conf"]
    reg.delete("host1/2510/conf")
    assert reg.retrieve("host1/2510/conf") is None


def test_config_registry_rest_round_trip_across_packages(tmp_path):
    """The port's server answers the JAX package's client and the other
    way round, and both read the same files."""
    srv = ConfigRegistryServer(str(tmp_path / "port")).start()
    jsrv = jax_registry.ConfigRegistryServer(str(tmp_path / "jax")).start()
    try:
        client = RemoteConfigRegistry(srv.url)
        client.register("job/42", {"batch": 128})
        assert client.retrieve("job/42") == {"batch": 128}
        assert "job/42" in client.list_keys()
        assert client.retrieve("missing") is None
        assert jax_registry.RemoteConfigRegistry(srv.url).retrieve(
            "job/42") == {"batch": 128}
        jax_registry.RemoteConfigRegistry(jsrv.url).register(
            "job/7", {"lr": 0.5})
        assert RemoteConfigRegistry(jsrv.url).retrieve("job/7") == {
            "lr": 0.5}
        assert ConfigRegistry(str(tmp_path / "jax")).retrieve("job/7") == {
            "lr": 0.5}
    finally:
        srv.stop()
        jsrv.stop()
