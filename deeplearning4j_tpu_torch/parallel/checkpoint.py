"""Checkpoints in the JAX package's gathered layout, and carrying weights
across.

Counterpart of `deeplearning4j_tpu/parallel/checkpoint.py` for the plain
gathered layout: `meta.json` (step, data cursor, user metadata, format
version), `conf.json` and `arrays.npz`, whose keys are tree paths such as
`params/3/W`. `save` writes that layout atomically (a temporary directory
swung into place, the previous one kept as '<dir>.bak' until the swap is
done), so the JAX package's `load` reads what the port trained; `load`
reads it back, into a given params tree or as nested dicts, and
`load_resilient` falls back to '<dir>.bak' when the directory is missing
or unreadable. Saves and loads traverse the `checkpoint.save` and
`checkpoint.load` fault points where the JAX package's do.
`save_async` takes an owned host copy of the params on the calling thread
and writes it on a background thread; a failed background write is raised
again by the next `save_async` or by `join_async`, which waits for every
outstanding write, as in the JAX package.
`params_from_numpy` turns the JAX package's params (a tuple of dicts of
numpy arrays, as `jax.device_get` gives them) into the port's tensors, and
`params_to_numpy` is its inverse. The sharded layout is not ported
(ROADMAP.md queue A item 10).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.reliability import faults

log = logging.getLogger("deeplearning4j_tpu_torch")

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
         step: int = 0, data_cursor: Optional[Dict[str, Any]] = None,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write `params` (and `conf` as conf.json) as a gathered-layout
    checkpoint that the JAX package's `checkpoint.load` reads: arrays.npz
    keyed `params/{layer}/{name}`, meta.json with the JAX package's keys
    (`step`, `data_cursor` and `metadata`, JSON-able dicts, `format_version`
    1, `mesh` null). Returns the directory."""
    faults.fire("checkpoint.save", path=directory)
    directory = os.fspath(directory)
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=parent)
    try:
        arrays = {f"params/{i}/{name}": a
                  for i, layer in enumerate(params_to_numpy(params))
                  for name, a in layer.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": int(step), "data_cursor": dict(data_cursor or {}),
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


# a failed background write is raised at the next save_async or join_async
# call, never lost with its thread: a checkpoint the trainer believes exists
# but does not is silent data loss
_async_lock = threading.Lock()
_async_threads: List[threading.Thread] = []
_async_errors: List[BaseException] = []


def _raise_pending_async_error() -> None:
    with _async_lock:
        if not _async_errors:
            return
        err = _async_errors.pop(0)
    raise err


def _host_snapshot(params) -> tuple:
    """Owned host copies of every param, taken now. A CUDA tensor is copied
    by a synchronous device-to-host copy after the device has finished the
    work queued before it; the captured train step writes the same
    addresses in place, so a `non_blocking` copy into pinned memory could
    read a later step's values."""
    if any(t.device.type == "cuda" for layer in params
           for t in layer.values()):
        torch.cuda.synchronize()
    return tuple({name: t.detach().to("cpu", copy=True)
                  for name, t in layer.items()} for layer in params)


def save_async(directory: str, params, **kw) -> threading.Thread:
    """`save` on a background thread, from a host snapshot taken before the
    thread starts, so training may overwrite the params at once. Writes
    land in call order: each thread waits for the one started before it,
    so two saves into one directory never race on its '.bak' (the JAX
    package's threads write at once and can). Raises the error of an
    earlier `save_async` that failed; `join_async` waits for every
    outstanding write and raises the first failure."""
    _raise_pending_async_error()
    snapshot = _host_snapshot(params)
    with _async_lock:
        before = _async_threads[-1] if _async_threads else None

    def run():
        try:
            if before is not None:
                before.join()
            save(directory, snapshot, **kw)
        except BaseException as e:  # noqa: BLE001 — raised at the next call
            log.error("async checkpoint save to %s failed: %r", directory, e)
            with _async_lock:
                _async_errors.append(e)

    t = threading.Thread(target=run, daemon=True,
                         name="dl4j-torch-ckpt-save")
    with _async_lock:
        _async_threads[:] = [x for x in _async_threads if x.is_alive()]
        _async_threads.append(t)
    t.start()
    return t


def join_async(timeout: Optional[float] = None) -> None:
    """Wait for every outstanding `save_async`; raise the first failure."""
    with _async_lock:
        threads = list(_async_threads)
    for t in threads:
        t.join(timeout)
    with _async_lock:
        _async_threads[:] = [x for x in _async_threads if x.is_alive()]
    _raise_pending_async_error()


def load_conf(directory: str) -> MultiLayerConfiguration:
    with open(os.path.join(directory, "conf.json")) as f:
        return MultiLayerConfiguration.from_json(f.read())


def load(directory: str, like_params=None
         ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Read a gathered-layout checkpoint: (params, updater or None, meta).
    With `like_params` (a params tree of tensors) the params come back in
    that tree's structure, each leaf a tensor on its leaf's device; a
    missing leaf or another shape raises `CheckpointFormatError`. Without
    it the trees are nested dicts of numpy arrays keyed by path component.
    Falls back to '<dir>.bak' when the directory is missing, as the JAX
    package does."""
    if not os.path.isdir(directory) and os.path.isdir(directory + ".bak"):
        directory = directory + ".bak"
    faults.fire("checkpoint.load", path=directory)
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
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        flat = {key: z[key] for key in z.files}
    if like_params is not None:
        return _restore(directory, flat, like_params), None, meta
    nested: Dict[str, Any] = {}
    for key, a in flat.items():
        node = nested
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return nested.get("params", nested), nested.get("updater"), meta


def _restore(directory: str, flat: Dict[str, np.ndarray], like) -> tuple:
    """The `params/...` arrays of `flat` in the structure of `like`, on
    its leaves' devices, after the JAX package's checks."""
    out = []
    for i, layer in enumerate(like):
        restored = {}
        for name, leaf in layer.items():
            key = f"params/{i}/{name}"
            if key not in flat:
                raise CheckpointFormatError(
                    f"checkpoint {directory} is missing '{key}': it was "
                    f"written for a different model config")
            if tuple(flat[key].shape) != tuple(leaf.shape):
                raise CheckpointFormatError(
                    f"checkpoint {directory} leaf {key} has shape "
                    f"{tuple(flat[key].shape)}, model expects "
                    f"{tuple(leaf.shape)}: this checkpoint belongs to a "
                    f"different config")
            restored[name] = _to_tensor(flat[key], leaf.device)
        out.append(restored)
    return tuple(out)


def load_resilient(directory: str, like_params=None
                   ) -> Optional[Tuple[Any, Any, Dict[str, Any]]]:
    """The newest readable checkpoint among '<dir>' and '<dir>.bak', or
    None. A corrupt directory (torn npz, missing meta.json) falls back to
    the other; a `CheckpointFormatError` (newer format, another model) is
    not corruption and propagates, as in the JAX package."""
    for cand in (directory, directory + ".bak"):
        if not os.path.isdir(cand):
            continue
        try:
            return load(cand, like_params)
        except CheckpointFormatError:
            raise
        except Exception as e:  # noqa: BLE001 — corrupt entry, try fallback
            log.warning("checkpoint %s unreadable (%r); trying fallback",
                        cand, e)
    return None


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
