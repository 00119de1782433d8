"""Checkpoints in the JAX package's gathered layout, and carrying weights
across.

Counterpart of `deeplearning4j_tpu/parallel/checkpoint.py` for the plain
gathered layout: `meta.json`, `conf.json` and `arrays.npz`, whose keys are
tree paths such as `params/3/W`. `save` writes that layout atomically (a
temporary directory swung into place, the previous one kept as
'<dir>.bak' until the swap is done), so the JAX package's `load` reads
what the port trained; `load` reads it back. `params_from_numpy` turns the
JAX package's params (a tuple of dicts of numpy arrays, as
`jax.device_get` gives them) into the port's tensors, and
`params_to_numpy` is its inverse.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

#: the checkpoint format `save` writes, and the newest `load` reads
FORMAT_VERSION = 1


class CheckpointFormatError(RuntimeError):
    """The checkpoint cannot be read into this process."""


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device) -> tuple:
    """A tuple of per-layer dicts of tensors on `device`, from the JAX
    package's params: a tuple (or list) of dicts of arrays, or the nested
    dict keyed "0", "1", ... that a checkpoint read gives."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree, key=int)]
    return tuple({name: _to_tensor(a, device) for name, a in layer.items()}
                 for layer in tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(params) -> tuple:
    """The inverse of `params_from_numpy`: the port's params as a tuple of
    dicts of numpy arrays, the layout the JAX package's params take. A
    bfloat16 tensor becomes an `ml_dtypes.bfloat16` array (the type JAX
    gives bf16 arrays, bit for bit) where `ml_dtypes` can be imported, and
    a float32 array (exact: widening loses nothing) where it cannot."""
    return tuple({name: _to_numpy(t) for name, t in layer.items()}
                 for layer in params)


def _atomic_swap(tmp: str, directory: str) -> None:
    """Swing a fully written temporary directory into place. The previous
    checkpoint moves to '<dir>.bak' (which `load` falls back to if a crash
    lands between the two renames) and is dropped after the swap."""
    if os.path.isdir(directory):
        bak = directory + ".bak"
        if os.path.isdir(bak):
            shutil.rmtree(bak)
        os.replace(directory, bak)
        os.replace(tmp, directory)
        shutil.rmtree(bak, ignore_errors=True)
    else:
        os.replace(tmp, directory)


def save(directory: str, params, *, conf: MultiLayerConfiguration = None,
         step: int = 0, metadata: Dict[str, Any] = None) -> str:
    """Write `params` (and `conf` as conf.json) as a gathered-layout
    checkpoint that the JAX package's `checkpoint.load` reads: arrays.npz
    keyed `params/{layer}/{name}`, meta.json with `format_version` 1 and
    `metadata` (a JSON-able dict). Returns the directory."""
    directory = os.fspath(directory)
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=parent)
    try:
        arrays = {f"params/{i}/{name}": a
                  for i, layer in enumerate(params_to_numpy(params))
                  for name, a in layer.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": int(step), "data_cursor": {},
                "metadata": dict(metadata or {}),
                "format_version": FORMAT_VERSION, "mesh": None}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if conf is not None:
            with open(os.path.join(tmp, "conf.json"), "w") as f:
                f.write(conf.to_json())
        _atomic_swap(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return directory


def load_conf(directory: str) -> MultiLayerConfiguration:
    with open(os.path.join(directory, "conf.json")) as f:
        return MultiLayerConfiguration.from_json(f.read())


def load(directory: str) -> Tuple[Dict[str, Any], Any, Dict[str, Any]]:
    """Read a gathered-layout checkpoint: (params, updater or None, meta),
    the trees as nested dicts of numpy arrays keyed by path component.
    Falls back to '<dir>.bak' when the directory is missing, as the JAX
    package does."""
    if not os.path.isdir(directory) and os.path.isdir(directory + ".bak"):
        directory = directory + ".bak"
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("layout") == "sharded":
        raise CheckpointFormatError(
            f"checkpoint {directory} has the sharded layout, which the port "
            f"does not read yet (ROADMAP.md queue A item 10)")
    version = int(meta.get("format_version", 0))
    if version > FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint {directory} has format_version={version} but this "
            f"build reads <= {FORMAT_VERSION}")
    nested: Dict[str, Any] = {}
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        for key in z.files:
            node = nested
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return nested.get("params", nested), nested.get("updater"), meta


def load_network(directory: str, device=None):
    """A `MultiLayerNetwork` on `device` with the checkpoint's conf and
    params. Raises `CheckpointFormatError` when they do not fit."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = load_conf(directory)
    net = MultiLayerNetwork(conf, device=device)
    params, _, _ = load(directory)
    extra = sorted(set(params) - {str(i) for i in range(conf.n_layers)})
    if extra:
        raise CheckpointFormatError(
            f"checkpoint {directory} holds params for layers {extra}, but "
            f"its conf.json has {conf.n_layers} layers")
    # a layer without params (none in this slice's layers) has no npz key
    net.params = params_from_numpy(
        [params.get(str(i), {}) for i in range(conf.n_layers)], net.device)
    return net
