"""Checkpoints in the JAX package's layouts, and carrying weights across.

Counterpart of `deeplearning4j_tpu/parallel/checkpoint.py`. The gathered
layout: `meta.json` (step, data cursor, user metadata, format version, the
writing mesh), `conf.json` and `arrays.npz`, whose keys are tree paths such
as `params/3/W`, and for a trainer's updater `updater/.adagrad_hist/3/W`
and `updater/.velocity/3/W` (the JAX package's names for the fields of its
`UpdaterState`). `save` writes that layout atomically (a temporary
directory swung into place, the previous one kept as '<dir>.bak' until the
swap is done), on rank 0 only, so the JAX package's `load` reads what the
port trained; `load` reads it back, into given params and updater trees or
as nested dicts, and `load_resilient` falls back to '<dir>.bak' when the
directory is missing or unreadable. The sharded layout (`index.json` and
`shards.npz`, one piece a unique shard, each with its global bounds) is
what the JAX package's `save_sharded` writes for a tensor-parallel plan;
the port's `save_sharded` writes it too, from the ranks of a model axis
(rank 0 writes, the other model ranks send it their pieces one at a
time, and no rank holds a split leaf whole), and `load` reads either
layout whole or, with `tp=`, as this rank's shards of a model axis
(`parallel/tensor.py`'s pieces, assembled from the pieces that overlap
them). Saves and loads traverse the
`checkpoint.save` and `checkpoint.load` fault points where the JAX
package's do.
`save_async` takes an owned host copy of the params on the calling thread
and writes it on a background thread, and `save_sharded_async` does so for
this rank's pieces of the sharded layout; a failed background write is
raised again by the next `save_async` or `save_sharded_async` or by
`join_async`, which waits for every outstanding write, as in the JAX
package.
`params_from_numpy` turns the JAX package's params (a tuple of dicts of
numpy arrays, as `jax.device_get` gives them) into the port's tensors, and
`params_to_numpy` is its inverse.
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

from deeplearning4j_tpu_torch.nd import platform
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize.tree import tree_unflatten
from deeplearning4j_tpu_torch.reliability import faults

log = logging.getLogger("deeplearning4j_tpu_torch")

#: the checkpoint format `save` writes, and the newest `load` reads
FORMAT_VERSION = 1


class CheckpointFormatError(RuntimeError):
    """The checkpoint cannot be read into this process."""


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (an `ml_dtypes.bfloat16` one by its bits) as a tensor
    on `device`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_tensor(a, device):
    """A leaf, or an int8 leaf's {"q", "scale"} sub-dict, as tensors."""
    if isinstance(a, dict):
        return {k: to_tensor(v, device) for k, v in a.items()}
    return to_tensor(a, device)


def params_from_numpy(tree, device) -> tuple:
    """A tuple of per-layer dicts of tensors on `device`, from the JAX
    package's params: a tuple (or list) of dicts of arrays, or the nested
    dict keyed "0", "1", ... that a checkpoint read gives. The quantized
    trees of the int8 serve policy carry over too: a leaf that is a
    {"q": int8, "scale": float32} sub-dict stays one."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree, key=int)]
    return tuple({name: _leaf_to_tensor(a, device)
                  for name, a in layer.items()} for layer in tree)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (see `params_to_numpy` for
    bfloat16)."""
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
    return tuple({name: ({k: to_numpy(v) for k, v in t.items()}
                         if isinstance(t, dict) else to_numpy(t))
                  for name, t in layer.items()} for layer in params)


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


def _leaf_paths(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of every leaf in `tree_leaves` order, keyed as the JAX
    package keys its arrays: sequence indices, dict keys (sorted) and
    "." + the field name of a NamedTuple, joined by '/'."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaf_paths(v, prefix + ("." + name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def save(directory: str, params, updater=None, *,
         conf: MultiLayerConfiguration = None, step: int = 0,
         data_cursor: Optional[Dict[str, Any]] = None,
         metadata: Optional[Dict[str, Any]] = None,
         mesh: Optional[Dict[str, Any]] = None) -> str:
    """Write `params` (and a trainer's `updater`, and `conf` as conf.json)
    as a gathered-layout checkpoint that the JAX package's
    `checkpoint.load` reads: arrays.npz keyed `params/{layer}/{name}` and
    `updater/.{field}/{layer}/{name}`, meta.json with the JAX package's
    keys (`step`, `data_cursor` and `metadata`, JSON-able dicts,
    `format_version` 1, and `mesh`, the writing topology or null). Only
    rank 0 of a process group writes. Returns the directory."""
    if platform.rank() != 0:
        return directory
    faults.fire("checkpoint.save", path=directory)
    directory = os.fspath(directory)
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=parent)
    try:
        state = {"params": params}
        if updater is not None:
            state["updater"] = updater
        arrays = {key: to_numpy(a) for key, a in _leaf_paths(state)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": int(step), "data_cursor": dict(data_cursor or {}),
                "metadata": dict(metadata or {}),
                "format_version": FORMAT_VERSION, "mesh": mesh or None}
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


# a failed background write is raised at the next save_async,
# save_sharded_async or join_async call, never lost with its thread: a
# checkpoint the trainer believes exists but does not is silent data loss
_async_lock = threading.Lock()
_async_threads: List[threading.Thread] = []
_async_errors: List[BaseException] = []


def _raise_pending_async_error() -> None:
    with _async_lock:
        if not _async_errors:
            return
        err = _async_errors.pop(0)
    raise err


def _host_snapshot(tree):
    """Owned host copies of every leaf of `tree`, taken now. A CUDA tensor
    is copied by a synchronous device-to-host copy after the device has
    finished the work queued before it; the captured train steps write the
    same addresses in place, so a `non_blocking` copy into pinned memory
    could read a later step's values."""
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves, tree_map

    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in tree_leaves(tree)):
        torch.cuda.synchronize()
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def save_async(directory: str, params, updater=None,
               **kw) -> threading.Thread:
    """`save` on a background thread, from a host snapshot taken before the
    thread starts, so training may overwrite the params at once. Writes
    land in call order: each thread waits for the one started before it,
    so two saves into one directory never race on its '.bak' (the JAX
    package's threads write at once and can). Raises the error of an
    earlier `save_async` that failed; `join_async` waits for every
    outstanding write and raises the first failure."""
    _raise_pending_async_error()
    snapshot = _host_snapshot(params)
    upd_snapshot = None if updater is None else _host_snapshot(updater)
    return _start_async(
        lambda: save(directory, snapshot, upd_snapshot, **kw), directory)


def _start_async(write, directory: str) -> threading.Thread:
    """Run `write()` on a background thread after the async write started
    before it; its error is kept for the next call to raise."""
    with _async_lock:
        before = _async_threads[-1] if _async_threads else None

    def run():
        try:
            if before is not None:
                before.join()
            write()
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
    """Wait for every outstanding `save_async` and `save_sharded_async`;
    raise the first failure."""
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


def _check_version(directory: str, meta: Dict[str, Any]) -> None:
    version = int(meta.get("format_version", 0))
    if version > FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint {directory} has format_version={version} but this "
            f"build reads <= {FORMAT_VERSION}")


def load(directory: str, like_params=None, like_updater=None, tp=None
         ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Read a checkpoint of either layout: (params, updater or None, meta).
    With `like_params` (a params tree of tensors) the params come back in
    that tree's structure, each leaf a tensor on its leaf's device, and so
    does the updater with `like_updater` (an `UpdaterState` of such
    trees); a missing leaf or another shape raises
    `CheckpointFormatError`. Without them the trees are nested dicts of
    numpy arrays keyed by path component (the sharded layout needs
    `like_params`, as in the JAX package). Falls back to '<dir>.bak' when
    the directory is missing, as the JAX package does. With `tp` (a
    `parallel.tensor.TensorParallel` of more than one rank) the like trees
    are this rank's shards, and each split leaf is read as the pieces this
    rank holds, from either layout."""
    if not os.path.isdir(directory) and os.path.isdir(directory + ".bak"):
        directory = directory + ".bak"
    faults.fire("checkpoint.load", path=directory)
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if tp is not None and tp.size > 1:
        return _load_local(directory, meta, like_params, like_updater, tp)
    if meta.get("layout") == "sharded":
        return _load_sharded_impl(directory, like_params, like_updater, None)
    _check_version(directory, meta)
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        flat = {key: z[key] for key in z.files}
    if like_params is not None:
        params = _restore(directory, flat, "params", like_params)
        updater = (None if like_updater is None else
                   _restore(directory, flat, "updater", like_updater))
        return params, updater, meta
    nested: Dict[str, Any] = {}
    for key, a in flat.items():
        node = nested
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return nested.get("params", nested), nested.get("updater"), meta


def _restore(directory: str, flat: Dict[str, np.ndarray], prefix: str,
             like):
    """The `prefix/...` arrays of `flat` in the structure of `like`, on
    its leaves' devices, after the JAX package's checks."""
    leaves = []
    for path, leaf in _leaf_paths(like, (prefix,)):
        if path not in flat:
            raise CheckpointFormatError(
                f"checkpoint {directory} is missing '{path}': it was "
                f"written for a different model config")
        if tuple(flat[path].shape) != tuple(leaf.shape):
            raise CheckpointFormatError(
                f"checkpoint {directory} leaf {path} has shape "
                f"{tuple(flat[path].shape)}, model expects "
                f"{tuple(leaf.shape)}: this checkpoint belongs to a "
                f"different config")
        leaves.append(to_tensor(flat[path], leaf.device))
    return tree_unflatten(like, leaves)


# -- the sharded layout (read) ----------------------------------------------
#
# The JAX package's `save_sharded` writes one piece a unique shard of
# every leaf:
#
#   meta.json    as above, plus "layout": "sharded"
#   index.json   {"leaves": {path: {"shape", "dtype",
#                 "pieces": [{"key", "index": [[s, e], ...]}]}}}
#   shards.npz   pieces keyed "path::i"
#
# A region of a leaf assembles from the pieces that overlap it, so an N-way
# sharded checkpoint reads on any number of ranks.


def _read_sharded_index(directory: str) -> Tuple[Dict[str, Any],
                                                 Dict[str, Any]]:
    with open(os.path.join(directory, "index.json")) as f:
        index = json.load(f)
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    _check_version(directory, meta)
    return index["leaves"], meta


def _assemble_region(z, info: Dict[str, Any], region: Tuple[slice, ...],
                     stats: Optional[Dict[str, Any]]) -> np.ndarray:
    """One region of a leaf, assembled from the saved pieces overlapping
    it: the host holds the region, never the whole leaf."""
    shape = tuple(int(d) for d in info["shape"])
    dtype = _np_dtype(info["dtype"])
    bounds = tuple(sl.indices(d)[:2] for sl, d in zip(region, shape))
    out = np.zeros(tuple(e - s for s, e in bounds), dtype)
    for piece in info["pieces"]:
        pb = [tuple(b) for b in piece["index"]]
        lo = [max(s, ps) for (s, _), (ps, _) in zip(bounds, pb)]
        hi = [min(e, pe) for (_, e), (_, pe) in zip(bounds, pb)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        data = z[piece["key"]]
        src = tuple(slice(a - ps, b - ps)
                    for a, b, (ps, _) in zip(lo, hi, pb))
        dst = tuple(slice(a - s, b - s)
                    for a, b, (s, _) in zip(lo, hi, bounds))
        out[dst] = data[src]
        if stats is not None:
            stats["max_piece_bytes"] = max(
                stats.get("max_piece_bytes", 0), int(data.nbytes))
            stats["pieces_read"] = stats.get("pieces_read", 0) + 1
    if stats is not None:
        stats["max_region_bytes"] = max(
            stats.get("max_region_bytes", 0), int(out.nbytes))
    return out


def _np_dtype(name: str):
    """A numpy dtype by name; "bfloat16" through `ml_dtypes`, as JAX
    writes it."""
    if name == "bfloat16":
        import ml_dtypes

        return ml_dtypes.bfloat16
    return np.dtype(name)


def _load_sharded_impl(directory: str, like_params, like_updater,
                       stats) -> Tuple[Any, Any, Dict[str, Any]]:
    index, meta = _read_sharded_index(directory)
    if like_params is None:
        raise CheckpointFormatError(
            f"checkpoint {directory} has the sharded layout, which "
            f"restores into an example tree: pass like_params=")

    def restore(prefix, like):
        paths = list(_leaf_paths(like, (prefix,)))
        missing = [k for k, _ in paths if k not in index]
        if missing:
            raise CheckpointFormatError(
                f"checkpoint {directory} is missing {len(missing)} "
                f"'{prefix}' leaves (first: {missing[0]}): it was written "
                f"for a different model config")
        leaves = []
        with np.load(os.path.join(directory, "shards.npz")) as z:
            for k, leaf in paths:
                info = index[k]
                if tuple(info["shape"]) != tuple(leaf.shape):
                    raise CheckpointFormatError(
                        f"checkpoint {directory} leaf {k} has shape "
                        f"{tuple(info['shape'])}, model expects "
                        f"{tuple(leaf.shape)}: this checkpoint belongs to "
                        f"a different config")
                whole = (slice(None),) * len(info["shape"])
                leaves.append(to_tensor(
                    _assemble_region(z, info, whole, stats), leaf.device))
        return tree_unflatten(like, leaves)

    params = restore("params", like_params)
    updater = (None if like_updater is None
               else restore("updater", like_updater))
    return params, updater, meta


def _split_of(path: str, tp):
    """The Split of the leaf at a checkpoint path (".../{layer}/{name}")
    under `tp`'s layout, or None (a whole leaf)."""
    parts = path.split("/")
    try:
        return tp.layout.get((int(parts[-2]), parts[-1]))
    except (IndexError, ValueError):
        return None


def _write_sharded(directory: str, pieces: Dict[str, np.ndarray],
                   index: Dict[str, Any], conf, meta) -> str:
    """The sharded layout's files, swung into place atomically."""
    directory = os.fspath(directory)
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=parent)
    try:
        np.savez(os.path.join(tmp, "shards.npz"), **pieces)
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
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


def save_sharded(directory: str, params, updater=None, *,
                 conf: MultiLayerConfiguration = None, step: int = 0,
                 data_cursor: Optional[Dict[str, Any]] = None,
                 metadata: Optional[Dict[str, Any]] = None,
                 mesh: Optional[Dict[str, Any]] = None, tp=None) -> str:
    """Write the JAX package's sharded layout: meta.json (with "layout":
    "sharded"), index.json (per leaf its global shape, dtype and pieces,
    each with its [start, end] bounds a dim) and shards.npz (the pieces,
    keyed "path::i"); JAX's `load_sharded` and `load` read it.

    Without `tp` (or at one model rank) every leaf is one piece, written
    by rank 0. With `tp` (a `parallel.tensor.TensorParallel`; `params` and
    `updater` this rank's shards) it is a collective over the model group:
    a whole leaf is written once, from the group's rank 0, and each split
    leaf as every model rank's pieces (three a rank for the head-aligned
    `Wqkv`), which the other ranks send to rank 0 one piece at a time; no
    rank holds a split leaf whole. The group's rank 0 writes."""
    writer = _sharded_writer(tp)
    if writer:
        faults.fire("checkpoint.save", path=directory)
    pieces, index = _collect_sharded(params, updater, tp, writer)
    if not writer:
        return directory
    return _write_sharded(directory, pieces, index, conf,
                          _sharded_meta(step, data_cursor, metadata, mesh))


def save_sharded_async(directory: str, params, updater=None, *,
                       conf: MultiLayerConfiguration = None, step: int = 0,
                       data_cursor: Optional[Dict[str, Any]] = None,
                       metadata: Optional[Dict[str, Any]] = None,
                       mesh: Optional[Dict[str, Any]] = None,
                       tp=None) -> threading.Thread:
    """`save_sharded` with the writes on a background thread. The host
    copies of this rank's pieces are taken now, on the calling thread (with
    `tp`, the pieces' sends to the group's rank 0 too), so training may
    overwrite the params at once; the thread fires `checkpoint.save` and
    writes the files. Failures and ordering are `save_async`'s: the error
    of a failed write is raised at the next `save_async`,
    `save_sharded_async` or `join_async`, and writes land in call order. A
    rank that does not write returns a finished thread."""
    _raise_pending_async_error()
    writer = _sharded_writer(tp)
    pieces, index = _collect_sharded(params, updater, tp, writer)
    if not writer:
        t = threading.Thread(target=lambda: None)
        t.start()
        return t
    meta = _sharded_meta(step, data_cursor, metadata, mesh)

    def write():
        faults.fire("checkpoint.save", path=directory)
        _write_sharded(directory, pieces, index, conf, meta)

    return _start_async(write, directory)


def _sharded_writer(tp) -> bool:
    """Whether this rank writes a sharded checkpoint: the model group's
    rank 0 under a model axis of more than one rank, else global rank 0."""
    if tp is not None and tp.size > 1:
        return tp.rank == 0
    return platform.rank() == 0


def _sharded_meta(step, data_cursor, metadata, mesh) -> Dict[str, Any]:
    return {"step": int(step), "data_cursor": dict(data_cursor or {}),
            "metadata": dict(metadata or {}),
            "format_version": FORMAT_VERSION, "layout": "sharded",
            "mesh": mesh or None}


def _collect_sharded(params, updater, tp, writer: bool
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The sharded layout's pieces as host arrays and its index, on the
    writer (empty elsewhere); with `tp` over more than one model rank, the
    other ranks send their pieces of each split leaf to the writer."""
    import torch.distributed as dist

    state = {"params": params}
    if updater is not None:
        state["updater"] = updater
    multi = tp is not None and tp.size > 1
    if multi:
        from deeplearning4j_tpu_torch.parallel.tensor import pieces as bounds

        root = dist.get_global_rank(tp.group, 0)
    pieces: Dict[str, np.ndarray] = {}
    index: Dict[str, Any] = {}
    for path, leaf in _leaf_paths(state):
        split = _split_of(path, tp) if multi else None
        if split is None:
            if writer:
                arr = to_numpy(leaf)
                pieces[f"{path}::0"] = arr
                index[path] = {"shape": list(arr.shape),
                               "dtype": str(arr.dtype),
                               "pieces": [{"key": f"{path}::0", "index": [
                                   [0, int(d)] for d in arr.shape]}]}
            continue
        shape = list(leaf.shape)
        shape[split.dim] *= tp.size
        mine = leaf.detach().chunk(split.parts, dim=split.dim)
        entry = []
        for r in range(tp.size):
            for p, b in enumerate(bounds(shape, split, tp.size, r)):
                key = f"{path}::{r * split.parts + p}"
                if r == 0:
                    if writer:
                        pieces[key] = to_numpy(mine[p])
                elif tp.rank == r:
                    dist.send(mine[p].contiguous(), dst=root, group=tp.group)
                elif writer:
                    buf = torch.empty_like(mine[p], memory_format=torch.
                                           contiguous_format)
                    dist.recv(buf, src=dist.get_global_rank(tp.group, r),
                              group=tp.group)
                    pieces[key] = to_numpy(buf)
                entry.append({"key": key, "index": [list(x) for x in b]})
        if writer:
            index[path] = {"shape": shape,
                           "dtype": str(pieces[entry[0]["key"]].dtype),
                           "pieces": entry}
    return pieces, {"leaves": index}


def _load_local(directory: str, meta: Dict[str, Any], like_params,
                like_updater, tp) -> Tuple[Any, Any, Dict[str, Any]]:
    """`load` into this rank's shards of `tp`'s model axis: each split
    leaf as the concatenation of the pieces this rank holds, read from
    the sharded layout's overlapping pieces or cut from the gathered
    layout's whole array."""
    from deeplearning4j_tpu_torch.parallel.tensor import (local_shape,
                                                          pieces, shard_leaf)

    _check_version(directory, meta)
    sharded = meta.get("layout") == "sharded"
    if sharded:
        index, _ = _read_sharded_index(directory)
        store = np.load(os.path.join(directory, "shards.npz"))
    else:
        store = np.load(os.path.join(directory, "arrays.npz"))

    def read(path, like):
        split = _split_of(path, tp)
        if sharded:
            if path not in index:
                raise CheckpointFormatError(
                    f"checkpoint {directory} is missing '{path}': it was "
                    f"written for a different model config")
            info = index[path]
            shape = tuple(int(d) for d in info["shape"])
            regions = ([tuple((0, d) for d in shape)] if split is None
                       else pieces(shape, split, tp.size, tp.rank))
            parts = [_assemble_region(store, info, tuple(
                slice(lo, hi) for lo, hi in b), None) for b in regions]
            local = (parts[0] if split is None
                     else np.concatenate(parts, axis=split.dim))
        else:
            if path not in store.files:
                raise CheckpointFormatError(
                    f"checkpoint {directory} is missing '{path}': it was "
                    f"written for a different model config")
            whole = store[path]
            shape = tuple(whole.shape)
            local = shard_leaf(whole, split, tp.size, tp.rank)
        want = tuple(like.shape)
        got = shape if split is None else local_shape(shape, split, tp.size)
        if tuple(local.shape) != want or tuple(got) != want:
            raise CheckpointFormatError(
                f"checkpoint {directory} leaf {path} has shape {shape}, "
                f"which does not hold this rank's {want}: this checkpoint "
                f"belongs to a different config")
        return to_tensor(local, like.device)

    try:
        params = tree_unflatten(like_params, [
            read(path, like) for path, like in
            _leaf_paths(like_params, ("params",))])
        updater = (None if like_updater is None else tree_unflatten(
            like_updater, [read(path, like) for path, like in
                           _leaf_paths(like_updater, ("updater",))]))
    finally:
        store.close()
    return params, updater, meta


def load_sharded(directory: str, like_params=None, like_updater=None, *,
                 stats: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Read a checkpoint of the JAX package's sharded layout into
    `like_params` (and `like_updater`): each leaf assembled whole from its
    pieces, on its like leaf's device. `stats` (a dict) records
    "max_piece_bytes", "max_region_bytes" and "pieces_read"."""
    if not os.path.isdir(directory) and os.path.isdir(directory + ".bak"):
        directory = directory + ".bak"
    faults.fire("checkpoint.load", path=directory)
    return _load_sharded_impl(directory, like_params, like_updater, stats)


def load_resilient(directory: str, like_params=None, like_updater=None,
                   tp=None) -> Optional[Tuple[Any, Any, Dict[str, Any]]]:
    """The newest readable checkpoint among '<dir>' and '<dir>.bak', or
    None. A corrupt directory (torn npz, missing meta.json) falls back to
    the other; a `CheckpointFormatError` (newer format, another model) is
    not corruption and propagates, as in the JAX package."""
    for cand in (directory, directory + ".bak"):
        if not os.path.isdir(cand):
            continue
        try:
            return load(cand, like_params, like_updater, tp)
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
