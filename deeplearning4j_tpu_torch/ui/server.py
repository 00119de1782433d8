"""REST/HTML UI server over stdlib http.server.

The port of `deeplearning4j_tpu/ui/server.py`: the same routes and the
same JSON answers, key for key. `/api/tsne` runs the port's exact t-SNE
(`plot/tsne.Tsne`) on the server's `device` (CUDA unless the caller passes
"cpu"), and `/api/nearest` the port's `clustering/vptree.VPTree` (cosine)
on the host.

Parity: reference `ui/UiServer.java` + resources:
  POST /api/coords            upload 2-d t-SNE coords [+labels]   (TsneResource)
  GET  /api/coords            fetch uploaded coords
  POST /api/vectors           upload high-d vectors [+labels]     (ApiResource upload)
  POST /api/tsne              run t-SNE server-side on the uploaded vectors
  GET  /api/nearest?word=W&k=K  nearest neighbors by label        (NearestNeighborsResource)
  POST /api/weights           upload a param pytree's histograms  (WeightResource)
  GET  /api/weights           fetch histogram summaries
  GET  /api/renders           list rendered images in renders_dir (RendersResource)
  GET  /api/renders/NAME      fetch one rendered image (png)
  GET  /render                HTML gallery of the rendered images (RenderView)
  GET  /                      scatter-plot HTML view              (FreeMarker tsne.ftl)

The renders endpoints expose what `plot/plotter.py` (`NeuralNetPlotter`,
`FilterRenderer`, `PlotIterationListener`) writes into its out_dir —
the reference serves the same artifacts through
`ui/renders/RendersResource.java` + `RenderView`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_VIEW = """<!doctype html>
<html><head><title>dl4j-tpu UI</title></head>
<body>
<h2>t-SNE embedding</h2>
<canvas id="c" width="800" height="600" style="border:1px solid #ccc"></canvas>
<script>
fetch('/api/coords').then(r => r.json()).then(d => {
  const ctx = document.getElementById('c').getContext('2d');
  const xs = d.coords.map(p => p[0]), ys = d.coords.map(p => p[1]);
  const minx = Math.min(...xs), maxx = Math.max(...xs);
  const miny = Math.min(...ys), maxy = Math.max(...ys);
  const sx = v => 20 + 760 * (v - minx) / (maxx - minx + 1e-9);
  const sy = v => 20 + 560 * (v - miny) / (maxy - miny + 1e-9);
  d.coords.forEach((p, i) => {
    ctx.fillStyle = 'hsl(' + (137 * (d.classes ? d.classes[i] : 0) % 360) + ',70%,50%)';
    ctx.beginPath(); ctx.arc(sx(p[0]), sy(p[1]), 3, 0, 6.28); ctx.fill();
    if (d.labels && d.labels[i]) ctx.fillText(d.labels[i], sx(p[0]) + 4, sy(p[1]));
  });
});
</script>
</body></html>"""


class _UiState:
    def __init__(self, device):
        self.device = device
        self.coords: Optional[np.ndarray] = None
        self.coord_labels: List[str] = []  # labels for coords only
        self.vectors: Optional[np.ndarray] = None
        self.labels: List[str] = []  # labels for vectors/vptree
        self.classes: List[int] = []
        self.weights: Dict[str, dict] = {}
        self.vptree = None
        self.renders_dir: Optional[str] = None
        self.lock = threading.Lock()

    def rebuild_tree(self):
        from deeplearning4j_tpu_torch.clustering.vptree import VPTree
        if self.vectors is not None and len(self.vectors):
            self.vptree = VPTree(self.vectors, distance="cosine")


class _Handler(BaseHTTPRequestHandler):
    state: _UiState = None

    def _send(self, body, code: int = 200,
              ctype: str = "application/json") -> None:
        data = (body if isinstance(body, bytes)
                else json.dumps(body).encode())
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def _render_names(self) -> List[str]:
        import os

        d = self.state.renders_dir
        if not d or not os.path.isdir(d):
            return []
        return sorted(f for f in os.listdir(d)
                      if f.rsplit(".", 1)[-1].lower()
                      in ("png", "jpg", "jpeg", "svg"))

    def do_GET(self):  # noqa: N802
        u = urlparse(self.path)
        st = self.state
        if u.path in ("/", "/tsne"):
            self._send(_VIEW.encode(), ctype="text/html")
        elif u.path == "/api/coords":
            with st.lock:
                if st.coords is None:
                    self._send({"coords": [], "labels": []})
                else:
                    self._send({"coords": st.coords.tolist(),
                                "labels": st.coord_labels,
                                "classes": st.classes})
        elif u.path == "/api/weights":
            with st.lock:
                self._send(st.weights)
        elif u.path == "/api/renders":
            self._send({"images": self._render_names()})
        elif u.path.startswith("/api/renders/"):
            import os

            name = os.path.basename(u.path[len("/api/renders/"):])
            if st.renders_dir is None or name not in self._render_names():
                self._send({"error": f"unknown render {name!r}"}, 404)
                return
            with open(os.path.join(st.renders_dir, name), "rb") as f:
                data = f.read()
            ext = name.rsplit(".", 1)[-1].lower()
            sub = {"jpg": "jpeg", "svg": "svg+xml"}.get(ext, ext)
            self._send(data, ctype=f"image/{sub}")
        elif u.path == "/render":
            imgs = "\n".join(
                f'<figure><img src="/api/renders/{n}" style="max-width:45%">'
                f"<figcaption>{n}</figcaption></figure>"
                for n in self._render_names())
            self._send((f"<!doctype html><html><head><title>renders</title>"
                        f"</head><body><h2>Renders</h2>{imgs}</body></html>")
                       .encode(), ctype="text/html")
        elif u.path == "/api/nearest":
            q = parse_qs(u.query)
            word = q.get("word", [""])[0]
            k = int(q.get("k", ["5"])[0])
            with st.lock:
                if st.vptree is None or word not in st.labels:
                    self._send({"error": f"unknown word {word!r}"}, 404)
                    return
                i = st.labels.index(word)
                idx = st.vptree.words_nearest(st.vectors[i], k + 1)
                names = [st.labels[j] for j in idx if j != i][:k]
            self._send({"word": word, "nearest": names})
        else:
            self._send({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        u = urlparse(self.path)
        st = self.state
        body = self._body()
        if u.path == "/api/coords":
            with st.lock:
                st.coords = np.asarray(body["coords"], np.float64)
                # coord labels are separate from the vector/vptree labels:
                # overwriting those would desync the nearest-neighbor index
                st.coord_labels = list(body.get("labels", []))
                st.classes = list(body.get("classes", []))
            self._send({"n": len(st.coords)})
        elif u.path == "/api/vectors":
            with st.lock:
                st.vectors = np.asarray(body["vectors"], np.float64)
                st.labels = list(body.get("labels", []))
                st.rebuild_tree()
            self._send({"n": len(st.vectors)})
        elif u.path == "/api/tsne":
            from deeplearning4j_tpu_torch.plot.tsne import Tsne
            with st.lock:
                if st.vectors is None:
                    self._send({"error": "no vectors uploaded"}, 400)
                    return
                vecs = st.vectors
            t = Tsne(max_iter=int(body.get("iters", 300)),
                     perplexity=float(body.get("perplexity", 30.0)),
                     learning_rate=float(body.get("learning_rate", 10.0)),
                     final_momentum=0.5, stop_lying_iter=100,
                     exaggeration=4.0, device=st.device)
            coords = t.calculate(vecs)
            with st.lock:
                st.coords = coords
                st.coord_labels = list(st.labels)  # coords of these vectors
            self._send({"n": len(coords), "kl": t.kl_history[-1]})
        elif u.path == "/api/weights":
            with st.lock:
                for key, arr in body.items():
                    a = np.asarray(arr, np.float64)
                    hist, edges = np.histogram(a.ravel(), bins=30)
                    st.weights[key] = {
                        "mean": float(a.mean()), "std": float(a.std()),
                        "min": float(a.min()), "max": float(a.max()),
                        "hist": hist.tolist(), "edges": edges.tolist()}
            self._send({"keys": sorted(st.weights)})
        else:
            self._send({"error": "not found"}, 404)

    def log_message(self, *args):  # quiet
        pass


class UiServer:
    """`UiServer.main()` parity: start/stop an embedded UI server. `device`
    is where `/api/tsne` runs (CUDA unless the caller passes "cpu")."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 renders_dir: Optional[str] = None, device=None):
        from deeplearning4j_tpu_torch.nd.platform import resolve_device

        self.state = _UiState(resolve_device(device))
        self.state.renders_dir = renders_dir
        handler = type("Handler", (_Handler,), {"state": self.state})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "UiServer":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.server.server_address[0]}:{self.port}"
