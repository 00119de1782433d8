"""The port's UI server and plotter on the CPU, held to the JAX package's.

The cases of tests/test_ui_plot.py run on the port's `UiServer(device=
"cpu")` and `plot/plotter.py`; every route's JSON answer must equal the JAX
package's `UiServer` for the same request bodies, key for key, and
`/api/tsne` must land within 1e-4 of JAX's KL, and of its coordinates
after 8 iterations (tests/test_torch_tsne.py's gate); at 20 iterations the
coordinates are held to JAX's own gap under a one-ulp change of its input,
since the iteration is chaotic under the route's exaggeration. The plot
cases need matplotlib and skip without it.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.plot import plotter as jax_plotter  # noqa: E402
from deeplearning4j_tpu.ui import UiServer as JaxUiServer  # noqa: E402
from deeplearning4j_tpu_torch.plot import plotter  # noqa: E402
from deeplearning4j_tpu_torch.ui import UiServer  # noqa: E402


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _status(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _plt():
    pytest.importorskip("matplotlib")


@pytest.fixture(scope="module")
def server():
    s = UiServer(device="cpu").start()
    yield s
    s.stop()


@pytest.fixture()
def pair(tmp_path):
    """A fresh port server and a fresh JAX server over one renders dir."""
    s = UiServer(renders_dir=str(tmp_path), device="cpu").start()
    j = JaxUiServer(renders_dir=str(tmp_path)).start()
    yield s, j
    s.stop()
    j.stop()


class TestUiServer:
    def test_coords_roundtrip(self, server):
        coords = [[0.0, 1.0], [2.0, 3.0]]
        out = _post(server.url + "/api/coords",
                    {"coords": coords, "labels": ["a", "b"]})
        assert out["n"] == 2
        back = _get(server.url + "/api/coords")
        assert back["coords"] == coords
        assert back["labels"] == ["a", "b"]

    def test_nearest_neighbors(self, server):
        rng = np.random.RandomState(0)
        vecs = rng.randn(20, 8)
        vecs[3] = vecs[7] + 0.001  # make w3 ~ w7
        labels = [f"w{i}" for i in range(20)]
        _post(server.url + "/api/vectors",
              {"vectors": vecs.tolist(), "labels": labels})
        out = _get(server.url + "/api/nearest?word=w3&k=3")
        assert out["nearest"][0] == "w7"

    def test_nearest_unknown_word_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url + "/api/nearest?word=zzz")
        assert e.value.code == 404

    def test_server_side_tsne(self, server):
        rng = np.random.RandomState(1)
        vecs = np.vstack([rng.randn(10, 5), rng.randn(10, 5) + 4])
        _post(server.url + "/api/vectors", {"vectors": vecs.tolist(),
                                            "labels": []})
        out = _post(server.url + "/api/tsne",
                    {"iters": 150, "perplexity": 5.0})
        assert out["n"] == 20
        coords = _get(server.url + "/api/coords")["coords"]
        assert len(coords) == 20

    def test_weights_endpoint(self, server):
        _post(server.url + "/api/weights",
              {"0/W": np.random.RandomState(2).randn(10, 4).tolist()})
        out = _get(server.url + "/api/weights")
        assert "0/W" in out
        assert len(out["0/W"]["hist"]) == 30

    def test_html_view(self, server):
        with urllib.request.urlopen(server.url + "/", timeout=10) as r:
            assert b"canvas" in r.read()

    def test_tsne_without_vectors_is_400(self, pair):
        s, j = pair
        req = urllib.request.Request(
            s.url + "/api/tsne", data=b"{}",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400

    def test_needs_a_card_unless_asked_for_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            UiServer()


class TestAgainstJax:
    def test_every_route_answers_as_jax(self, pair, tmp_path):
        """Each route's JSON (and status) for the same bodies, both
        servers fresh: uploads, fetches, nearest neighbors, weights,
        renders, the 404s."""
        s, j = pair
        rng = np.random.RandomState(5)
        vecs = rng.randn(12, 6)
        vecs[2] = vecs[9] * 1.5 + 0.01
        labels = [f"t{i}" for i in range(12)]
        weights = {"0/W": rng.randn(7, 3).tolist(),
                   "1/b": rng.randn(5).tolist()}
        posts = [("/api/coords", {"coords": rng.randn(4, 2).tolist(),
                                  "labels": ["a", "b", "c", "d"],
                                  "classes": [0, 1, 0, 1]}),
                 ("/api/vectors", {"vectors": vecs.tolist(),
                                   "labels": labels}),
                 ("/api/weights", weights),
                 ("/api/nope", {})]
        for path, body in posts:
            try:
                got = _post(s.url + path, body)
            except urllib.error.HTTPError as e:
                got = (e.code, json.loads(e.read()))
            try:
                want = _post(j.url + path, body)
            except urllib.error.HTTPError as e:
                want = (e.code, json.loads(e.read()))
            assert got == want, path
        for path in ("/api/coords", "/api/weights", "/api/renders",
                     "/api/nearest?word=t2&k=4", "/api/nearest?word=t9",
                     "/api/nearest?word=zz", "/api/renders/none.png",
                     "/nowhere"):
            assert _status(s.url + path) == _status(j.url + path), path

    @pytest.mark.parametrize("iters", [8, 20])
    def test_tsne_route_as_jax(self, pair, iters):
        """`/api/tsne` (learning rate 10, exaggeration 4 over the first 100
        iterations) on the same vectors: the KL within 1e-4 and the
        coordinates within 1e-4 of JAX's after 8 iterations. The iteration
        is chaotic under exaggeration: on these 20 points JAX's own run
        moves by 1.6e-3 at 20 iterations when its input moves by one
        float32 ulp (the port's gap to JAX there: 4.9e-4), so at 20 the
        coordinates are held to JAX's own gap from that perturbation."""
        s, j = pair
        rng = np.random.RandomState(1)
        vecs = np.vstack([rng.randn(10, 5), rng.randn(10, 5) + 4])
        body = {"iters": iters, "perplexity": 5.0}
        for srv in (s, j):
            _post(srv.url + "/api/vectors", {"vectors": vecs.tolist(),
                                             "labels": [f"p{i}" for i in
                                                        range(20)]})
        got, want = _post(s.url + "/api/tsne", body), \
            _post(j.url + "/api/tsne", body)
        assert set(got) == set(want) == {"n", "kl"}
        assert got["n"] == want["n"] == 20
        assert got["kl"] == pytest.approx(want["kl"], rel=1e-4, abs=1e-4)
        gc, wc = _get(s.url + "/api/coords"), _get(j.url + "/api/coords")
        assert set(gc) == set(wc)
        assert gc["labels"] == wc["labels"]
        gap = np.abs(np.asarray(gc["coords"]) - np.asarray(wc["coords"]))
        gate = 1e-4
        if iters > 8:
            from deeplearning4j_tpu.plot.tsne import Tsne as JaxTsne

            kw = dict(max_iter=iters, perplexity=5.0, learning_rate=10.0,
                      final_momentum=0.5, stop_lying_iter=100,
                      exaggeration=4.0)
            x = vecs.astype(np.float32)
            own = np.abs(
                np.asarray(JaxTsne(**kw).calculate(x)) - np.asarray(
                    JaxTsne(**kw).calculate(np.nextafter(
                        x, np.float32(np.inf), dtype=np.float32)))).max()
            gate = max(gate, float(own))
        assert gap.max() <= gate, (gap.max(), gate)


class TestRendersEndpoint:
    def test_renders_listing_and_fetch(self, tmp_path):
        _plt()
        p = plotter.NeuralNetPlotter(str(tmp_path))
        p.plot_weight_histograms(({"W": torch.randn(6, 4)},))
        plotter.FilterRenderer(str(tmp_path)).render_filters(
            np.random.randn(16, 6), name="filters")
        s = UiServer(renders_dir=str(tmp_path), device="cpu").start()
        j = JaxUiServer(renders_dir=str(tmp_path)).start()
        try:
            listing = _get(s.url + "/api/renders")["images"]
            assert listing == _get(j.url + "/api/renders")["images"]
            assert len(listing) >= 2
            assert any("filters" in n for n in listing)
            with urllib.request.urlopen(
                    s.url + "/api/renders/" + listing[0], timeout=10) as r:
                assert r.headers["Content-Type"].startswith("image/")
                assert len(r.read()) > 100
            with urllib.request.urlopen(s.url + "/render", timeout=10) as r:
                html = r.read().decode()
                assert listing[0] in html
        finally:
            s.stop()
            j.stop()

    def test_renders_404_and_traversal_safe(self, tmp_path):
        (tmp_path / "secret.txt").write_text("x")
        s = UiServer(renders_dir=str(tmp_path), device="cpu").start()
        try:
            assert _get(s.url + "/api/renders")["images"] == []
            for bad in ("/api/renders/nope.png",
                        "/api/renders/..%2Fsecret.txt"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(s.url + bad)
                assert e.value.code == 404
        finally:
            s.stop()

    def test_renders_empty_without_dir(self, server):
        assert _get(server.url + "/api/renders")["images"] == []


class TestPlotter:
    def test_to_host_reads_tensors_as_jax_reads_arrays(self):
        rng = np.random.RandomState(3)
        arrays = ({"W": rng.randn(4, 3).astype(np.float32),
                   "b": np.zeros(3, np.float32)},
                  {"W": rng.randn(3, 2).astype(np.float32)})
        tensors = tuple({k: torch.from_numpy(v) for k, v in layer.items()}
                        for layer in arrays)
        got, want = plotter._to_host(tensors), jax_plotter._to_host(arrays)
        assert sorted(got) == sorted(want) == ["0/W", "0/b", "1/W"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        flat = torch.arange(6, dtype=torch.bfloat16)
        host = plotter._to_host(flat)
        assert list(host) == [""] and host[""].dtype == np.float32

    def test_weight_histograms(self, tmp_path):
        _plt()
        p = plotter.NeuralNetPlotter(str(tmp_path))
        params = ({"W": torch.randn(10, 5), "b": torch.zeros(5)},
                  {"W": torch.randn(5, 2, dtype=torch.bfloat16)})
        path = p.plot_weight_histograms(params)
        assert os.path.isfile(path) and os.path.getsize(path) > 0
        with pytest.raises(ValueError, match="empty"):
            p.plot_weight_histograms(())

    def test_filter_renderer_dense_and_conv(self, tmp_path):
        _plt()
        f = plotter.FilterRenderer(str(tmp_path))
        path = f.render_filters(torch.randn(16, 6), name="dense")
        assert os.path.isfile(path)
        path = f.render_filters(np.random.randn(3, 3, 1, 8), name="conv")
        assert os.path.isfile(path)

    def test_filter_bad_shape_raises(self, tmp_path):
        _plt()
        with pytest.raises(ValueError):
            plotter.FilterRenderer(str(tmp_path)).render_filters(
                np.random.randn(7, 4))

    def test_plot_listener(self, tmp_path):
        _plt()

        class FakeModel:
            params = ({"W": torch.randn(4, 3)},)

        li = plotter.PlotIterationListener(str(tmp_path), every=2)
        for i in range(4):
            li.iteration_done(FakeModel(), i, 1.0 / (i + 1))
        assert any(n.startswith("weights-") for n in os.listdir(tmp_path))
        assert os.path.isfile(os.path.join(tmp_path, "score.png"))
        assert li.scores == [1.0, 0.5, 1 / 3, 0.25]

    def test_activations_from_a_tensor(self, tmp_path):
        _plt()
        path = plotter.NeuralNetPlotter(str(tmp_path)).plot_activations(
            torch.rand(8, 5))
        assert os.path.isfile(path)
