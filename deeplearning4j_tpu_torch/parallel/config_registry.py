"""Configuration registry — park configs for workers to retrieve.

The port's copy of `deeplearning4j_tpu/parallel/config_registry.py`,
which imports no JAX.

Parity: reference Zookeeper module (7 files / 725 LoC —
`ZooKeeperConfigurationRegister`/`Retriever` store a serialized
`Configuration` under `/{host}/{id}` paths; `ZooKeeperRunner` embeds a
server). The replacement: the control plane needs a tiny KV store,
not a consensus system — a file-backed registry (shared filesystem /
NFS / GCS-fuse in production) plus an embedded HTTP server mode for
hosts with no shared mount, mirroring the embedded-ZK-server capability.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import quote, unquote, urlparse
from urllib.request import Request, urlopen


class ConfigRegistry:
    """File-backed register/retrieve of JSON-serializable configs."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _file(self, key: str) -> str:
        # percent-encode (injective, unlike '/'->'__' style rewrites)
        return os.path.join(self.root, quote(key.strip("/"), safe="")
                            + ".json")

    def register(self, key: str, conf: Dict[str, Any]) -> None:
        """`ZooKeeperConfigurationRegister.register` parity."""
        with self._lock:
            tmp = self._file(key) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(conf, f)
            os.replace(tmp, self._file(key))

    def retrieve(self, key: str) -> Optional[Dict[str, Any]]:
        """`ZookeeperConfigurationRetriever.retrieve` parity."""
        try:
            with open(self._file(key)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._file(key))
        except FileNotFoundError:
            pass

    def list_keys(self) -> List[str]:
        return sorted(unquote(n[:-5]) for n in os.listdir(self.root)
                      if n.endswith(".json"))


class _RegistryHandler(BaseHTTPRequestHandler):
    registry: ConfigRegistry = None

    def _send(self, body: Any, code: int = 200) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        key = urlparse(self.path).path
        if key in ("/", ""):
            self._send({"keys": self.registry.list_keys()})
            return
        conf = self.registry.retrieve(key)
        if conf is None:
            self._send({"error": "not found"}, 404)
        else:
            self._send(conf)

    def do_PUT(self):  # noqa: N802
        key = urlparse(self.path).path
        n = int(self.headers.get("Content-Length", 0))
        conf = json.loads(self.rfile.read(n))
        self.registry.register(key, conf)
        self._send({"registered": key})

    def do_DELETE(self):  # noqa: N802
        self.registry.delete(urlparse(self.path).path)
        self._send({"deleted": True})

    def log_message(self, *args):  # quiet
        pass


class ConfigRegistryServer:
    """Embedded registry server (`ZooKeeperRunner` role)."""

    def __init__(self, root: str, port: int = 0, host: str = "127.0.0.1"):
        self.registry = ConfigRegistry(root)
        handler = type("Handler", (_RegistryHandler,),
                       {"registry": self.registry})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]

    def start(self) -> "ConfigRegistryServer":
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.server.server_address[0]}:{self.port}"


class RemoteConfigRegistry:
    """Client for a ConfigRegistryServer — same register/retrieve surface."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def register(self, key: str, conf: Dict[str, Any]) -> None:
        req = Request(f"{self.base_url}/{key.strip('/')}",
                      data=json.dumps(conf).encode(), method="PUT",
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=10):
            pass

    def retrieve(self, key: str) -> Optional[Dict[str, Any]]:
        try:
            with urlopen(f"{self.base_url}/{key.strip('/')}",
                         timeout=10) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def list_keys(self) -> List[str]:
        with urlopen(self.base_url + "/", timeout=10) as r:
            return json.loads(r.read())["keys"]
