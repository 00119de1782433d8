"""Captured inference: one CUDA graph per (entry point, conf, bucket).

Counterpart of `deeplearning4j_tpu/optimize/infer_cache.py` for its entry
points `output`, `feed_forward`, `loss`, `decode` and `prefill`, over the
`CompiledProgramCache` machinery of `optimize/step_cache.py`:

  key schema    (entry point, conf fingerprint, arg shapes/dtypes,
                "single"). `attention_fused_bwd` changes only the backward,
                so it is normalised out of the fingerprint, as in the JAX
                package: flipping it for training re-keys no serving
                program.
  bucketing     a ragged batch pads with zero rows up to the smallest known
                row bucket; `output` and `feed_forward` slice the pad rows
                back off (`truncate_rows`), and `loss` weighs them 0 in a
                weighted mean.
  outputs       a replay overwrites the graph's static outputs, so the
                entry points return copies, made under the pool's lock.
  params        read by address, as the train step writes them, so
                training between two calls is seen by the second.

Generation (the JAX package's `init_decode_state`, `decode`, `prefill`,
`init_paged_decode_state`, `decode_paged`, `decode_multi`,
`decode_multi_paged`, `prefill_logp`, `verify` and `verify_paged`):

  key schema    (entry point, conf fingerprint, arg signature with the
                state's leaves, "single"), the JAX package's.
  state         a graph reads and writes the decode state by address, as
                the train step does its params: the state is the graph's
                static buffers, and a call writes it in place (the new K/V
                rows at their positions, the new LSTM carries copied over
                the old). No step copies a KV cache in or out. A call with
                a state at other addresses captures anew, so the batcher
                and `warmup_generate` share the cache's own states
                (`decode_state`, one per role).
  sampling      inside the program (`nd/random.sample_tokens`): JAX's
                threefry keys bit for bit, one split a row a call.
  capture       the warm-up call before a capture writes the same K/V rows
                the replay writes and leaves the carries alone (the carries
                are written by the program's `write`, which only the
                capture records), so capturing mid-stream changes nothing.
  blocks        `decode_multi[k]` is K steps in one graph; its outputs are
                device copies made under the pool's lock, so a caller may
                feed one block's tokens and keys to the next dispatch
                without reading them back (the batcher's pipelined loop).
                Ids given as CUDA tensors are not checked on the host:
                they are a program's own samples, and a check would read
                them back.
  paged         the page pool is a state of its own role, keyed by its
                (n_pages, page_size); the page table is a static input.
  verify        speculative decoding's K-token step: one graph
                chain-samples K tokens with each row's key stream (the
                splits K one-step calls would make) and rolls the recurrent
                carries back to the accepted depth in the program
                (`_accepted_len`, `_rollback_carries`).

Meshes (`set_mesh`, `set_plan`; the JAX package's `:135-177`,
`:250-288`): a `ShardPlan` over a mesh of ranks keys every program, so
programs of different meshes coexist without eviction.

  1-D mesh      ("batch",) over every rank (`parallel/mesh.serve_mesh`):
                `output`, `feed_forward` and `loss` split a bucket's rows
                over the ranks in JAX's `P("batch")` order (buckets round
                up to a multiple of the ranks, `_serve_bucket`), each rank
                runs them with the whole params, and the rows are gathered
                back. Generation keeps the "single" tag and runs on rank 0
                alone, as the JAX package's does.
  model axis    ("batch", "model"): rows split over the batch axis; every
                rank holds its heads and FFN units (`parallel/tensor.
                shard_params` of the whole params, made once a params tree)
                and runs the programs with `ServeParallel`, whose
                all-reduces sit inside the captured graph. Generation is
                keyed by the plan's tag, and each rank's decode state holds
                its heads' n/M K/V columns (dense and paged; LSTM carries
                whole). The logits are whole on every rank and every rank
                samples with the same keys, so the tokens agree; rank 0
                reads them back.
  followers     one process a rank: rank 0 sends each mesh call to the
                other ranks (`parallel/followers.py`: a header with the
                entry, its key and bucket and the inputs, a vote, then the
                run), and they run it in `follow`, capturing a miss in the
                same order. A follower that fails ends rank 0's call with
                its error. `stop_followers` ends them. The batcher's state
                copies (`reset_state`, `scatter_row`, `keep_row`,
                `drop_row`) go the same way under a model axis, so each
                rank's prefix entries hold its own K/V columns; the rows of
                a collected batcher (`forget_rows`) leave the followers
                with the next header.

Precision policies (`set_policy`, the JAX package's `:180-230`): "f32",
"bf16" and "int8" (`optimize/quantize.py`) are a key element of every entry
(the plan's `policy_suffix`: nothing for f32, whose keys and outputs stay
the pre-policy ones), so the programs of each policy coexist and a flip
back is all hits. A policy's programs run its conf (compute dtype
bfloat16) on its params tree, and their outputs are float32:

  bf16          the params cast once (`_serve_params`) and held; the
                network reports in-place writes (a train step, `fit`,
                `set_params_flat`) through `params_written`, and the next
                call casts again into the same tensors, which the graphs
                read by address.
  int8          the quantized snapshot `set_policy` installs ({"q",
                "scale"} leaves), dequantized to bfloat16 inside the
                captured program; a new snapshot of the same shapes is
                copied into the held tensors, so the graphs stay valid.
  decode state  shaped for the policy's conf (bfloat16 K/V rows), one a
                policy and role.
  model axis    the policy's tree is sharded like the f32 one: an int8
                leaf's `q` as its float leaf, its per-column `scale` with
                the columns of a column split (`Wqkv`, `W1`) and whole for a
                row split (`Wo`, `W2`). A new bf16 cast or int8 snapshot
                is sharded again into the held shard. Every rank sets the
                policy: the header carries rank 0's count of int8
                snapshots, and a follower whose count differs refuses
                the call.

`set_persist` (the base class's) attaches the byte store
(`optimize/persist.py`) that the network's int8 artifact and the batcher's
prefix entries go through; a CUDA graph is not written to disk.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.optimize.step_cache import (CompiledProgramCache,
                                                          arg_signature,
                                                          check_input)
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
from deeplearning4j_tpu_torch.reliability import faults


def pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad `x` with rows up to `bucket` (feature rows = axis 0)."""
    pad = bucket - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def truncate_rows(arr: torch.Tensor, bucket: int, n: int) -> torch.Tensor:
    """A program output cut back to the `n` real input rows. Activations may
    carry `bucket` rows or a whole multiple of it (B*T rows where an
    `rnn_to_ff` preprocessor flattened time into the batch); pad rows take
    the trailing block either way. An output whose leading dim is not tied
    to the batch passes through."""
    if arr.dim() and arr.shape[0] and arr.shape[0] % bucket == 0:
        return arr[: n * (arr.shape[0] // bucket)]
    return arr


def _host_copy(t):
    """A host copy of a state tensor, pinned when it comes from the card
    (a prefix-cache hit copies it back without blocking)."""
    if not t.is_cuda:
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


class _Ref(NamedTuple):
    """A call argument that a follower rank resolves to its own object:
    "conf", "params" (its network's), "state" (its decode state of rank
    0's descriptor), "tensor" (a host array, on its device)."""

    kind: str
    value: object = None


class _Leaf(NamedTuple):
    """A leaf's shape and dtype only, for a key's signature."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _is_conf(obj) -> bool:
    return hasattr(obj, "confs") and hasattr(obj, "to_json")


def _mesh_entry(fn):
    """An entry that a mesh may run on every rank: on rank 0 of a mesh
    with followers, the call (name and arguments) is recorded for the
    header `_on_every_rank` sends."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        ch = self._channel
        if ch is None or not ch.leader:
            return fn(self, *args, **kwargs)
        prev = getattr(self._tls, "call", None)
        self._tls.call = (name, args, kwargs)
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._tls.call = prev

    return wrapper


class InferCache(CompiledProgramCache):
    """Keyed captured programs for the inference entry points."""

    kind = "infer-cache"

    #: key element of programs made without a mesh (the JAX package's tag)
    SINGLE = "single"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # (fingerprint, batch, max_seq, device, role, pages, decode tag) ->
        # the decode state the graphs of that role are captured on
        # (`decode_state`)
        self._decode_states: Dict[Tuple, tuple] = {}
        self._claimed: Set[int] = set()
        # the serving mesh (None: one rank), the channel to the other ranks
        # (None without followers), one ServeParallel and one sharded
        # params tree a conf under a model axis
        self._mesh = None
        self._channel = None
        self._tps: Dict[str, object] = {}
        self._sharded: Dict[str, tuple] = {}
        # rank 0: one mesh call at a time, header to done (the batchers'
        # threads and the server's share the cache)
        self._call_lock = threading.RLock()
        # per thread: rank 0's call in flight ("call"), or a follower's
        # (seq, (key, int8 snapshot count)) until it is ready ("follow")
        # and rank 0's bucket
        self._tls = threading.local()
        # decode states by id: their descriptors (serial, batch, max_seq,
        # pages), which a follower maps to states of its own
        self._descs: Dict[int, tuple] = {}
        self._serial = 0
        self._follower_states: Dict[tuple, tuple] = {}
        # prefix rows kept by handle (`keep_row`), and rank 0's handle
        # prefixes forgotten since its last header (`forget_rows`)
        self._kept: Dict[str, tuple] = {}
        self._forgotten: list = []
        # the precision policy, its params trees (the int8 snapshot and
        # the count of snapshots installed; the bf16 cast as (source leaf
        # ids, version, tree)), the version the network bumps when it
        # writes its params in place, and the digest of the weights served
        # (`weights_digest`) by (int8, stamp)
        self._policy = "f32"
        self._qparams = None
        self._qversion = 0
        self._cast = None
        self._version = 0
        self._digests: Dict[bool, tuple] = {}

    def _keyed_conf(self, conf):
        if any(c.attention_fused_bwd for c in conf.confs):
            return conf.replace(confs=tuple(
                c.replace(attention_fused_bwd=False) for c in conf.confs))
        return conf

    # -- mesh / plan ------------------------------------------------------
    def set_mesh(self, mesh) -> None:
        """Serve every later call over `mesh` (`parallel/mesh.Mesh`): the
        1-D ("batch",) mesh splits rows, a ("batch", "model") mesh also
        splits heads, FFN units and the decode state's K/V columns over
        the model axis; None goes back to one rank. Every rank of the mesh
        calls it, in the same order; ranks other than 0 then run `follow`
        while rank 0 serves. Programs of other meshes stay cached under
        their own tags."""
        from deeplearning4j_tpu_torch.parallel.followers import Channel

        with self._lock:
            self._mesh = mesh
            self._tps.clear()
            self._sharded.clear()
            n = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
            self._channel = None if n == 1 else Channel(mesh.rank, n)

    @property
    def mesh(self):
        return self._mesh

    @property
    def plan(self):
        """The cache's `ShardPlan` (its mesh and policy): every key element
        and placement comes from it."""
        from deeplearning4j_tpu_torch.parallel.plan import ShardPlan

        return ShardPlan(mesh=self._mesh, policy=self._policy)

    def set_plan(self, plan) -> None:
        """Install a `ShardPlan`: its policy and its mesh. An int8 plan needs
        the quantized tree installed first (`set_policy`; the plan carries
        the policy's name, not the snapshot)."""
        if plan.policy != self._policy:
            self.set_policy(plan.policy, qparams=self._qparams
                            if plan.policy == "int8" else None)
        self.set_mesh(plan.mesh)

    # -- precision policy -------------------------------------------------
    def set_policy(self, policy: str, qparams=None) -> None:
        """Serve every later call under `policy` ("f32", "bf16" or "int8").
        int8 takes the quantized tree (`MultiLayerNetwork.
        set_serve_precision` makes it); one of the same shapes as the held
        snapshot is copied into it, so that the captured int8 graphs stay
        valid, and another one replaces it (those graphs capture anew).
        Each new snapshot counts one, and under a mesh a rank whose count
        is not rank 0's refuses the call (every rank sets it). The
        programs of every policy stay cached under their own keys."""
        from deeplearning4j_tpu_torch.optimize.quantize import validate_policy

        validate_policy(policy)
        if policy == "int8":
            if qparams is None:
                raise ValueError("the int8 policy needs the quantized params "
                                 "tree (use MultiLayerNetwork."
                                 "set_serve_precision)")
            with self._lock:
                held = self._qparams
                if held is not None and held is not qparams and _same_leaves(
                        held, qparams):
                    with torch.no_grad():
                        for dst, src in zip(tree_leaves(held),
                                            tree_leaves(qparams)):
                            dst.copy_(src)
                    self._qversion += 1
                elif held is not qparams:
                    self._qparams = qparams
                    self._qversion += 1
        with self._lock:
            self._policy = policy

    @property
    def policy(self) -> str:
        return self._policy

    def params_written(self) -> None:
        """The network's params were written in place (a train step): the
        bf16 cast is made again at the next call."""
        with self._lock:
            self._version += 1

    def _serve_params(self, params):
        """The params tree the policy's programs read: f32 the network's
        own; bf16 the held cast of it, cast again (into the same tensors)
        after `params_written`, and made anew for another tree; int8 the
        snapshot `set_policy` installed."""
        policy = self._policy
        if policy == "f32":
            return params
        if policy == "int8":
            return self._qparams
        from deeplearning4j_tpu_torch.optimize.quantize import cast_params_bf16

        ids = tuple(id(t) for t in tree_leaves(params))
        with self._lock:
            held = self._cast
            if held is not None and held[:2] == (ids, self._version):
                return held[2]
            with torch.no_grad():
                if held is not None and held[0] == ids:
                    tree = held[2]
                    for dst, src in zip(tree_leaves(tree),
                                        tree_leaves(params)):
                        if dst is not src:
                            dst.copy_(src)
                else:
                    tree = cast_params_bf16(params)
            self._cast = (ids, self._version, tree)
            return tree

    def _stamp(self, params, int8: bool):
        """(leaf ids, version) of the weights a policy serves: the int8
        snapshot's and its count, else the network's and their version."""
        tree = self._qparams if int8 else params
        return (tuple(id(t) for t in tree_leaves(tree)),
                self._qversion if int8 else self._version)

    def weights_digest(self, params) -> str:
        """The digest (`quantize.params_digest`) of the weights the policy
        serves: the int8 snapshot's under int8, else the network's params
        (the bf16 cast is made of them). Made once a params version; it
        ties what a store keeps of a program's results to the weights that
        made them."""
        from deeplearning4j_tpu_torch.optimize.quantize import params_digest

        int8 = self._policy == "int8"
        with self._lock:
            stamp = self._stamp(params, int8)
            held = self._digests.get(int8)
            if held is not None and held[0] == stamp:
                return held[1]
            tree = self._qparams if int8 else params
        digest = params_digest(tree)
        with self._lock:
            self._digests[int8] = (stamp, digest)
        return digest

    def sharding_tag(self):
        """The sharding element of the row entries' keys (the plan's):
        "single" or ("mesh", axis names, sizes)."""
        return self.plan.sharding_tag()

    def _decode_tag(self):
        """The sharding element of the generation keys: "single" unless
        the plan has a model axis."""
        return self.plan.decode_tag()

    def _mesh_rows(self) -> int:
        """The row divisibility the plan asks of a bucket (1: no mesh)."""
        return self.plan.rows

    def _serve_bucket(self, n: int) -> int:
        """The bucket of `n` rows: under a mesh, the smallest known bucket
        >= n that the batch axis divides, else a new one at the next
        multiple, as the JAX package's."""
        m = self._mesh_rows()
        if m == 1:
            return self.bucket_rows(n)
        target = -(-n // m) * m
        with self._lock:
            for b in self._buckets:
                if b >= n and b % m == 0:
                    return b
            self._buckets.append(target)
            self._buckets.sort()
            return target

    def _bucket_of(self, n: int) -> int:
        """A row entry's bucket: rank 0's on a follower, else
        `_serve_bucket`."""
        b = getattr(self._tls, "bucket", None)
        return self._serve_bucket(n) if b is None else int(b)

    def _audit_scope(self, key):
        """A program's mesh, plan and model-axis layout for its audit
        record: the plan's mesh, the plan, and the split leaves of the
        key's conf (the fingerprint, key[1]) under a model axis."""
        with self._lock:
            tp = self._tps.get(key[1])
        return {"mesh": self.plan.mesh is not None, "plan": self.plan,
                "layout": None if tp is None else dict(tp.layout)}

    def _tp(self, conf):
        """The serving model axis for `conf` (None without one)."""
        if not self.plan.has_model_axis:
            return None
        from deeplearning4j_tpu_torch.parallel.tensor import serve_parallel

        fp = self._fingerprint(conf)
        with self._lock:
            tp = self._tps.get(fp)
            if tp is None:
                tp = self._tps[fp] = serve_parallel(self._mesh, conf)
            return tp

    def _local_params(self, conf, params):
        """The params a program of this rank reads: the policy's tree
        (`_serve_params`), whole, or under a model axis its shard
        (`shard_params`), made once a tree and kept, so that the graphs
        read it by address. A new version of a policy's tree (the bf16
        cast made again, a new int8 snapshot) is sharded again into the
        held shard. Training that writes the whole f32 params in place is
        not seen by their shard: `set_mesh` again (or assign the params)
        to shard them anew."""
        policy = self._policy
        params = self._serve_params(params)
        tp = self._tp(conf)
        if tp is None:
            return params
        from deeplearning4j_tpu_torch.parallel.tensor import shard_params

        fp = self._fingerprint(conf)
        ids = tuple(id(t) for t in tree_leaves(params))
        version = {"bf16": self._cast[1] if self._cast else None,
                   "int8": self._qversion}.get(policy)
        with self._lock:
            held = self._sharded.get((fp, policy))
            if held is None or held[0] != ids:
                with torch.no_grad():
                    held = self._sharded[(fp, policy)] = (
                        ids, version, shard_params(params, tp))
            elif held[1] != version:
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(held[2]), tree_leaves(
                            shard_params(params, tp))):
                        if dst is not src:
                            dst.copy_(src)
                held = self._sharded[(fp, policy)] = (ids, version, held[2])
            return held[2]

    def _batch_axis(self) -> Tuple[int, int]:
        """(this rank's coordinate, size) of the batch axis."""
        mesh = self._mesh
        if mesh is None or "batch" not in mesh.shape:
            return 0, 1
        return mesh.coord("batch"), int(mesh.shape["batch"])

    def _my_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a bucket, JAX's `P("batch")`
        order."""
        r, size = self._batch_axis()
        if size == 1:
            return t
        k = t.shape[0] // size
        return t[r * k:(r + 1) * k]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """The batch axis's rows of `t`, concatenated in rank order."""
        from deeplearning4j_tpu_torch.parallel.tensor import all_gather

        _, size = self._batch_axis()
        if size == 1:
            return t
        t = t.contiguous()
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        all_gather(out, t, self._mesh.axis_group("batch"))
        return out

    def _read_rows(self, out: torch.Tensor, bucket: int, n: int):
        """The `read` of a row entry's output: a copy of this rank's rows,
        cut back to the `n` real rows where no batch axis splits them."""
        if self._batch_axis()[1] == 1:
            out = truncate_rows(out, bucket, n)
        return out.clone()

    def _real_rows(self, out: torch.Tensor, bucket: int, n: int):
        """A row entry's result from its `_read_rows` copy: the batch
        axis's rows gathered and cut back to the `n` real rows."""
        if self._batch_axis()[1] == 1:
            return out
        return truncate_rows(self._gather(out), bucket, n)

    # -- rank 0 and its followers -----------------------------------------
    def _wire(self, obj):
        """A call argument as a header carries it: tensors as host arrays,
        decode states by descriptor."""
        if isinstance(obj, torch.Tensor):
            return _Ref("tensor", obj.detach().cpu().numpy())
        if isinstance(obj, tuple) and id(obj) in self._descs:
            return _Ref("state", self._descs[id(obj)][0])
        if isinstance(obj, (tuple, list)):
            return type(obj)(self._wire(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self._wire(v) for k, v in obj.items()}
        if isinstance(obj, np.ndarray):
            return obj.copy()
        return obj

    def _wire_call(self, args, kwargs):
        args = list(args)
        head = []
        if args and _is_conf(args[0]):
            head = [_Ref("conf"), _Ref("params")]
            args = args[2:]
        return (tuple(head) + tuple(self._wire(a) for a in args),
                {k: self._wire(v) for k, v in kwargs.items()})

    def _unwire(self, obj, net):
        if isinstance(obj, _Ref):
            if obj.kind == "conf":
                return net.conf
            if obj.kind == "params":
                return net.params
            if obj.kind == "tensor":
                return torch.from_numpy(obj.value).to(net.device)
            return self._follower_state(net.conf, obj.value, net.device)
        if isinstance(obj, (tuple, list)):
            return type(obj)(self._unwire(x, net) for x in obj)
        if isinstance(obj, dict):
            return {k: self._unwire(v, net) for k, v in obj.items()}
        return obj

    def _follower_state(self, conf, desc, device):
        """A follower's decode state for rank 0's descriptor: made fresh
        (zero, its own K/V columns) on first sight, the same ever after."""
        with self._lock:
            state = self._follower_states.get(desc)
            if state is None:
                _, batch, max_seq, pages = desc
                state = self._fresh_state(conf, batch, max_seq,
                                          resolve_device(device), pages)
                self._follower_states[desc] = state
            return state

    @contextlib.contextmanager
    def _on_every_rank(self, key, bucket=None):
        """Run the body on every rank of the mesh: on rank 0 the header
        goes out and the followers vote before the body, and their end is
        awaited after it; on a follower (inside `follow`), its key and its
        int8 snapshot count are checked against rank 0's and it answers
        ready and waits for go. Without followers, the body alone."""
        ch = self._channel
        follow = getattr(self._tls, "follow", None)
        snap = self._qversion if self._policy == "int8" else None
        if follow is not None:
            seq, (want, want_snap) = follow
            if key != want:
                raise RuntimeError(f"rank {ch.rank}: key {key!r} is not "
                                   f"rank 0's {want!r}")
            if snap != want_snap:
                raise RuntimeError(
                    f"rank {ch.rank}: int8 snapshot {snap} is not rank 0's "
                    f"{want_snap} (set_serve_precision on every rank)")
            self._tls.follow = None
            ch.answer(seq, "p")
            ch.wait_go(seq)
            yield
            return
        if ch is None or not ch.leader:
            yield
            return
        name, args, kwargs = self._tls.call
        args, kwargs = self._wire_call(args, kwargs)
        with self._call_lock:
            with self._lock:
                forgets, self._forgotten = self._forgotten, []
            seq = ch.send(("call", name, args, kwargs, (key, snap), bucket,
                           forgets))
            ch.vote(seq)
            try:
                yield
            except BaseException:
                try:
                    ch.done(seq)
                except Exception:  # noqa: BLE001 — rank 0's error first
                    pass
                raise
            ch.done(seq)

    def _model_axis(self, key):
        """`_on_every_rank` under a model axis (the generation entries and
        the state copies), else nothing: under a 1-D mesh generation runs
        on rank 0 alone."""
        if self.plan.has_model_axis:
            return self._on_every_rank(key)
        return contextlib.nullcontext()

    def follow(self, net) -> int:
        """The loop of a rank other than 0 of a serving mesh: run each call
        rank 0 sends on `net` (its conf, params and device) until rank 0
        stops it (`stop_followers`). Returns the calls run. An armed
        `serve.follower` fault fails the call it fires on, and rank 0's
        call raises with its error."""
        from deeplearning4j_tpu_torch.parallel.followers import Aborted

        ch = self._channel
        if ch is None or ch.leader:
            raise RuntimeError("follow runs on a rank other than 0 of a "
                               "serving mesh (set_mesh first)")
        served = 0
        while True:
            seq, msg = ch.receive()
            if msg[0] == "stop":
                ch.answer(seq, "p")
                return served
            _, name, args, kwargs, key, bucket, forgets = msg
            for prefix in forgets:
                self._drop_kept(prefix)
            self._tls.follow, self._tls.bucket = (seq, key), bucket
            try:
                faults.fire("serve.follower", entry=name, rank=ch.rank)
                getattr(self, name)(*self._unwire(args, net),
                                    **self._unwire(kwargs, net))
                if self._tls.follow is not None:
                    raise RuntimeError(f"{name} ran no mesh program here")
            except Aborted:
                continue
            except Exception as e:  # noqa: BLE001 — rank 0 raises it
                ch.answer(seq, "p" if self._tls.follow is not None else "d",
                          e)
                continue
            finally:
                self._tls.follow = self._tls.bucket = None
            ch.answer(seq, "d")
            served += 1

    def stop_followers(self) -> None:
        """Rank 0: end the followers' `follow` loops."""
        ch = self._channel
        if ch is None or not ch.leader:
            return
        with self._call_lock:
            ch.vote(ch.send(("stop",)))

    # -- row entries ------------------------------------------------------
    @_mesh_entry
    def output(self, conf, params, x, compile_only: bool = False):
        """`network_output` through the cache: the output activations of the
        `x.shape[0]` real rows (a copy). `compile_only` (warm-up) registers
        the bucket and captures the program without running it. Under a
        mesh, every rank runs its rows and the rows are gathered."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self._bucket_of(n)
        xp = pad_rows(x, bucket)
        key = (("output", self._fingerprint(conf), arg_signature(xp))
               + self.plan.key_suffix())
        tp, policy = self._tp(conf), self._policy
        with self._on_every_rank(key, bucket):
            out = self._run(key, lambda: _output_program(conf, tp, policy),
                            self._local_params(conf, params),
                            (self._my_rows(xp),),
                            read=lambda o: self._read_rows(o, bucket, n),
                            compile_only=compile_only)
            if compile_only:
                return None
            return self._real_rows(out, bucket, n)

    @_mesh_entry
    def feed_forward(self, conf, params, x, compile_only: bool = False):
        """`feed_forward` through the cache: the per-layer activations, each
        cut back to the real rows (copies)."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self._bucket_of(n)
        xp = pad_rows(x, bucket)
        key = (("feed_forward", self._fingerprint(conf), arg_signature(xp))
               + self.plan.key_suffix())
        tp, policy = self._tp(conf), self._policy
        with self._on_every_rank(key, bucket):
            acts = self._run(key,
                             lambda: _feed_forward_program(conf, tp, policy),
                             self._local_params(conf, params),
                             (self._my_rows(xp),),
                             read=lambda acts: [self._read_rows(a, bucket, n)
                                                for a in acts],
                             compile_only=compile_only)
            if compile_only:
                return None
            return [self._real_rows(a, bucket, n) for a in acts]

    def programs_summary(self):
        """Resident programs as (entry, bucket, sharding, policy) rows, the
        JAX package's `/v1/stats` `programs` block: bucket is the leading
        dim of the first argument (rows, or a decode table's slots), and a
        mesh's sharding reads "mesh:" and its sizes."""
        with self._lock:
            keys = list(self._programs)
        rows = []
        for k in keys:
            tag = k[3]
            rows.append({
                "entry": k[0],
                "bucket": int(k[2][0][0][0]) if k[2] and k[2][0] else 0,
                "sharding": (tag if isinstance(tag, str) else
                             "mesh:" + "x".join(str(d) for d in tag[2])),
                "policy": k[4][1] if len(k) > 4 else "f32"})
        return sorted(rows, key=lambda r: (r["entry"], r["bucket"],
                                           r["sharding"], r["policy"]))

    # -- generation -----------------------------------------------------------
    def init_decode_state(self, conf, batch: int, max_seq: int,
                          device=None):
        """A fresh zero decode state (`nn/decode.init_state`) on `device`
        (None: CUDA), shaped for the policy's conf; under a model axis,
        this rank's K/V columns."""
        from deeplearning4j_tpu_torch.nn import decode as decode_mod

        return decode_mod.init_state(_policy_conf(conf, self._policy),
                                     batch, max_seq,
                                     device=resolve_device(device),
                                     tp=self._tp(conf))

    def init_paged_decode_state(self, conf, batch: int, n_pages: int,
                                page_size: int, device=None):
        """A fresh zero paged decode state (`nn/decode.init_paged_state`):
        a pool of `n_pages` physical pages of `page_size` tokens (this
        rank's K/V columns under a model axis)."""
        from deeplearning4j_tpu_torch.nn import decode as decode_mod

        return decode_mod.init_paged_state(_policy_conf(conf, self._policy),
                                           batch, n_pages, page_size,
                                           device=resolve_device(device),
                                           tp=self._tp(conf))

    def decode_state(self, conf, batch: int, max_seq: int, device=None,
                     role: str = "table", pages=None):
        """The cache's own decode state for `role` (the batcher's "table",
        its paged "pool" and its B = 1 admission "row"; `warmup_generate`
        captures on the same ones), made on first use and kept: the graphs
        read it by address, so the programs warmed on it replay for its
        later users. `pages` = (n_pages, page_size) makes a paged state,
        and is part of the key, as are the decode tag (a model axis's state
        holds this rank's K/V columns) and the policy (its K/V dtype). Its
        content is what the last call left; `reset_state` zeroes it."""
        dev = resolve_device(device)
        key = (self._fingerprint(conf), int(batch), int(max_seq), str(dev),
               role, None if pages is None else tuple(int(p) for p in pages),
               self._decode_tag(), self._policy)
        with self._lock:
            state = self._decode_states.get(key)
            if state is None:
                state = self._fresh_state(conf, batch, max_seq, dev, pages)
                self._decode_states[key] = state
            return state

    def _fresh_state(self, conf, batch, max_seq, device, pages):
        """A fresh state, registered under a descriptor that a follower
        rank maps to a state of its own."""
        if pages is None:
            state = self.init_decode_state(conf, batch, max_seq, device)
        else:
            state = self.init_paged_decode_state(conf, batch, *pages, device)
        with self._lock:
            self._serial += 1
            self._descs[id(state)] = ((self._serial, int(batch),
                                       int(max_seq),
                                       None if pages is None
                                       else tuple(pages)), state)
        return state

    def claim_decode_state(self, conf, batch: int, max_seq: int,
                           device=None, role: str = "table", pages=None):
        """`decode_state` for a user that writes it for a while (a running
        batcher): while one holds it, another claimant gets a private fresh
        state, so that two batchers on one network never write each
        other's rows. Their calls share the key's one graph, which is
        captured anew whenever the state changes: right, but slow while
        both decode. `release_state` gives it back."""
        state = self.decode_state(conf, batch, max_seq, device, role, pages)
        with self._lock:
            if id(state) not in self._claimed:
                self._claimed.add(id(state))
                return state
        return self._fresh_state(conf, batch, max_seq, device, pages)

    def release_state(self, state) -> None:
        with self._lock:
            self._claimed.discard(id(state))

    @_mesh_entry
    def reset_state(self, state) -> None:
        """Zero every tensor of a decode state in place (on every rank
        under a model axis)."""
        with self._model_axis(("reset_state",)), torch.no_grad():
            for t in tree_leaves(state):
                t.zero_()

    @_mesh_entry
    def scatter_row(self, table, slot: int, row=None, pages=None,
                    kept: Optional[str] = None) -> None:
        """Copy a B = 1 row state (a decode state, or with `kept` the row
        `keep_row` kept under that handle) into the table's row `slot`,
        tensor by tensor; into a paged pool, the row's dense K/V go into
        `pages` (a list of page ids), a page at a time only where the last
        page runs past the row. On every rank under a model axis."""
        with self._model_axis(("scatter_row",)), torch.no_grad():
            if kept is not None:
                row = self._kept[kept]
            for lay, r in zip(table, row):
                for name, tbl in lay.items():
                    src = r[name][0]
                    if pages is None or name in ("h", "c"):
                        tbl[slot].copy_(src, non_blocking=True)
                        continue
                    ps = tbl.shape[1]
                    n_rows = min(len(pages) * ps, src.shape[0])
                    full = n_rows // ps
                    src = src.to(tbl.device, non_blocking=True)
                    if full:
                        idx = torch.as_tensor(list(pages[:full]),
                                              device=tbl.device)
                        tbl.index_copy_(0, idx, src[:full * ps].view(
                            full, ps, -1))
                    if n_rows > full * ps:
                        tbl[pages[full], :n_rows - full * ps].copy_(
                            src[full * ps:n_rows])

    @_mesh_entry
    def keep_row(self, handle: str, row) -> tuple:
        """Keep a host copy of a row state under `handle` (each rank its
        own under a model axis: its K/V columns); returns it. A copy: the
        admission row is the cache's shared state, which the next
        admission writes."""
        with self._model_axis(("keep_row",)):
            host = tuple({name: _host_copy(t) for name, t in lay.items()}
                         for lay in row)
            with self._lock:
                self._kept[handle] = host
            return host

    def forget_rows(self, prefix: str) -> None:
        """Forget the kept rows whose handles start with `prefix` (a
        batcher's, when it is collected). A follower forgets them when the
        next header arrives, which carries the prefix: the call runs from
        a finalizer, where no call to the other ranks may start."""
        with self._lock:
            self._drop_kept(prefix)
            ch = self._channel
            if ch is not None and ch.leader:
                self._forgotten.append(prefix)

    def _drop_kept(self, prefix: str) -> None:
        with self._lock:
            for h in [h for h in self._kept if h.startswith(prefix)]:
                del self._kept[h]

    @_mesh_entry
    def drop_row(self, handle: str) -> None:
        """Forget the row kept under `handle` (on every rank)."""
        with self._model_axis(("drop_row",)):
            with self._lock:
                self._kept.pop(handle, None)

    def _decode_inputs(self, conf, params, state, tok, *rest):
        """The call's tensors on the program's device: `tok` (or the prompt)
        as int32, then each of `rest`, an (array, dtype) pair; keys given as
        uint32 arrays become int64 holding uint32. Token ids of an embedding
        stack that come from the host are checked there first (a captured
        program cannot); ids in a CUDA tensor are a program's own samples,
        in range by construction, and checking them would read them back.
        Host arrays go to the card from pinned memory without blocking, so
        that a call does not wait for the previous replay to end before it
        is queued; `pin_memory` copies them first, so the caller may rewrite
        its arrays as soon as the call returns."""
        leaves = tree_leaves(state) or tree_leaves(params)
        dev = leaves[0].device
        if not (isinstance(tok, torch.Tensor) and tok.is_cuda):
            check_input(conf, tok if isinstance(tok, torch.Tensor)
                        else torch.as_tensor(np.asarray(tok)))

        def put(t):
            if dev.type == "cuda" and not t.is_cuda:
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)

        out = [put(torch.as_tensor(np.asarray(tok) if not isinstance(
            tok, torch.Tensor) else tok).to(torch.int32))]
        for a, dtype in rest:
            if isinstance(a, np.ndarray) and a.dtype == np.uint32:
                a = nd_random.key_array(a)
            out.append(put(torch.as_tensor(a)).to(dtype))
        return tuple(out)

    def _generation(self, entry, build, conf, params, state, read,
                    compile_only, tok, *rest):
        """One generation program's call: its inputs on the device
        (`_decode_inputs`), its key (entry, conf fingerprint, the signature
        of the inputs and the state's leaves at their whole shapes, the
        decode tag, the policy), and `_run` of `build(tp, policy)` with the new
        carries written
        into `state`, on every rank under a model axis. Returns `read` of
        the outputs, or None with `compile_only`."""
        args = self._decode_inputs(conf, params, state, tok, *rest)
        tp, policy = self._tp(conf), self._policy
        # the keys travel as int64 holding uint32 values (the only int64
        # input): the key names JAX's dtype
        sig = tuple((s[0], "uint32") if s is not None and s[1] == "int64"
                    else s for s in arg_signature(*args))
        key = ((entry, self._fingerprint(conf),
                sig + arg_signature(*_whole_leaves(state, tp)))
               + self.plan.decode_key_suffix())
        with self._model_axis(key):
            return self._run(key, lambda: build(tp, policy),
                             (self._local_params(conf, params), state),
                             args, read=read, write=_write_carries,
                             compile_only=compile_only)

    @_mesh_entry
    def decode(self, conf, params, state, tok, pos, keys, temps,
               compile_only: bool = False):
        """One KV-cache decode step over the whole slot table: tok, pos [B]
        int, keys [B, 2] (uint32 values), temps [B] float32 (rows at <= 0
        decode greedily). Returns (next_tok [B] int32, advanced keys [B, 2]
        int64, state), the state written in place. On CUDA the replay of one
        captured graph per key; on the CPU the program, eagerly."""
        out = self._generation(
            "decode", lambda tp, pol: _decode_program(conf, False, tp, pol),
            conf, params,
            state, _read_tokens, compile_only, tok, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def prefill(self, conf, params, state, prompt, length, keys, temps,
                compile_only: bool = False):
        """The prompt prefill: prompt [B, T_bucket] int (zero-padded),
        length [B] int. Fills the state in place and draws each row's first
        generated token. Returns (tok [B] int32, keys [B, 2], state). One
        program per (conf, rows, prompt bucket, max_seq): the state's leaves
        are in the key."""
        out = self._generation(
            "prefill", lambda tp, pol: _prefill_program(conf, tp, pol),
            conf, params,
            state, _read_tokens, compile_only, prompt, (length, torch.int32),
            (keys, torch.int64), (temps, torch.float32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def decode_paged(self, conf, params, state, tok, pos, keys, temps,
                     page_table, compile_only: bool = False):
        """`decode` over a paged state: page_table [B, pages_per_slot] int
        routes each row through the shared pool ("decode-paged")."""
        out = self._generation(
            "decode-paged",
            lambda tp, pol: _decode_program(conf, True, tp, pol), conf,
            params, state, _read_tokens, compile_only, tok,
            (pos, torch.int32), (keys, torch.int64), (temps, torch.float32),
            (page_table, torch.int32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def decode_multi(self, conf, params, state, tok, pos, keys, temps, rem,
                     k: int, compile_only: bool = False):
        """K decode steps in one program (`nn/decode.decode_block`), the
        tokens of K one-step calls: rem [B] int is each row's remaining
        budget; a row that spends it mid-block freezes and emits
        `BLOCK_SENTINEL`. Returns (toks [k, B] int32, the last token of each
        row [B], keys [B, 2], state), the three tensors device copies. K is
        in the entry name ("decode-multi[k]"), as in the JAX package."""
        out = self._generation(
            "decode-multi[%d]" % int(k),
            lambda tp, pol: _decode_block_program(conf, int(k), False, tp,
                                                  pol), conf,
            params,
            state, _read_block, compile_only, tok, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32), (rem, torch.int32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def decode_multi_paged(self, conf, params, state, tok, pos, keys, temps,
                           rem, page_table, k: int,
                           compile_only: bool = False):
        """`decode_multi` over a paged state ("decode-multi-paged[k]"): the
        page table rides the whole block, so the caller allocates the pages
        of all `k` positions first."""
        out = self._generation(
            "decode-multi-paged[%d]" % int(k),
            lambda tp, pol: _decode_block_program(conf, int(k), True, tp,
                                                  pol), conf,
            params,
            state, _read_block, compile_only, tok, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32), (rem, torch.int32),
            (page_table, torch.int32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def prefill_logp(self, conf, params, state, prompt, length,
                     compile_only: bool = False):
        """The prefill of the prefix cache: fills the state like `prefill`
        but returns (logp [B, vocab] float32, state) without sampling
        ("prefill-logp"); the batcher keeps the pair by prompt digest and
        samples each stream's first token on the host with its own key."""
        logp = self._generation(
            "prefill-logp",
            lambda tp, pol: _prefill_logp_program(conf, tp, pol), conf,
            params,
            state, lambda out: out[0].clone(), compile_only, prompt,
            (length, torch.int32))
        return None if compile_only else (logp, state)

    @_mesh_entry
    def verify(self, conf, params, state, toks, pos, keys, temps,
               compile_only: bool = False):
        """Speculative verification over the whole slot table: toks [B, K]
        int (column 0 each row's current token, columns 1..K-1 a draft's
        proposals), pos [B] int the position of column 0, keys [B, 2],
        temps [B]. One program advances every row K positions
        (`nn/decode.verify_chunk`), chain-samples K tokens with the row's
        key stream, the splits K one-step `decode` calls would make
        (`_sample_chain`), and rolls each recurrent layer's carries back to
        the row's accepted depth: 1 + the leading proposals equal to the
        samples before them (`_accepted_len`). Returns (sampled [B, K]
        int32, keys_after [B, K, 2]: the keys after accepting 1..K tokens,
        state), the state written in place; the first two are device
        copies, and a CUDA `toks` (a draft's own proposals) is not checked
        on the host."""
        out = self._generation(
            "verify", lambda tp, pol: _verify_program(conf, False, tp, pol),
            conf,
            params,
            state, _read_tokens, compile_only, toks, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def verify_paged(self, conf, params, state, toks, pos, keys, temps,
                     page_table, compile_only: bool = False):
        """`verify` over a paged state ("verify-paged"): the caller has
        allocated the pages of all K positions."""
        out = self._generation(
            "verify-paged",
            lambda tp, pol: _verify_program(conf, True, tp, pol), conf,
            params,
            state, _read_tokens, compile_only, toks, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32),
            (page_table, torch.int32))
        return None if compile_only else (*out, state)

    @_mesh_entry
    def loss(self, conf, params, x, y, compile_only: bool = False):
        """`network_loss(training=False)` through the cache: the row-weighted
        mean loss over the real rows plus regularization, a 0-d float32
        tensor. Pad rows carry weight 0."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self._bucket_of(n)
        xp, yp, w = self.pad_batch(x, y, bucket)
        key = (("loss", self._fingerprint(conf), arg_signature(xp, yp, w))
               + self.plan.key_suffix())
        # each rank's program gives its rows' losses; the weighted mean of
        # the gathered rows is taken outside it, on every mesh alike
        from deeplearning4j_tpu_torch.nn.multilayer import \
            network_regularization

        tp, policy = self._tp(conf), self._policy
        with self._on_every_rank(key, bucket):
            rows = self._run(key,
                             lambda: _rows_loss_program(conf, tp, policy),
                             self._local_params(conf, params),
                             (self._my_rows(xp), self._my_rows(yp)),
                             read=lambda r: r.clone(),
                             compile_only=compile_only)
            if compile_only:
                return None
            rows = self._gather(rows)
            with torch.inference_mode():
                return (torch.dot(rows, w) / torch.clamp(w.sum(), min=1.0)
                        + network_regularization(conf, params))


def _whole_leaves(state, tp):
    """The state's leaves at the shapes the JAX package's state has (a
    model axis's K/V leaves hold n/M of the n columns): the signature
    part of a generation key."""
    if tp is None:
        return tree_leaves(state)
    return [_Leaf(tuple(t.shape[:-1]) + (t.shape[-1] * tp.size,), t.dtype)
            if name in ("k", "v") else t
            for lay in state for name, t in lay.items()]


def _same_leaves(a, b) -> bool:
    """Whether two trees have leaves of equal shapes and dtypes in one
    order."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


def _policy_conf(conf, policy: str):
    """The conf a policy's programs run (f32: the conf itself)."""
    if policy == "f32":
        return conf
    from deeplearning4j_tpu_torch.optimize.quantize import serve_conf

    return serve_conf(conf, policy)


def _policy_args(params, policy: str):
    """The program's view of its params: int8 leaves dequantized to
    bfloat16 here, inside the captured program."""
    if policy == "f32":
        return params
    from deeplearning4j_tpu_torch.optimize.quantize import runtime_params

    return runtime_params(params, policy)


def _output_program(conf, tp=None, policy: str = "f32") -> Callable:
    # local import: nn.multilayer imports this module at top level
    from deeplearning4j_tpu_torch.nn.multilayer import network_output

    pconf = _policy_conf(conf, policy)

    def program(params, x):
        with torch.inference_mode():
            out = network_output(pconf, _policy_args(params, policy), x,
                                 tp=tp)
            return out if policy == "f32" else out.float()

    return program


def _feed_forward_program(conf, tp=None, policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn.multilayer import feed_forward

    pconf = _policy_conf(conf, policy)

    def program(params, x):
        with torch.inference_mode():
            acts = feed_forward(pconf, _policy_args(params, policy), x,
                                tp=tp)
            return acts if policy == "f32" else [a.float() for a in acts]

    return program


def _rows_loss_program(conf, tp=None, policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn.multilayer import network_rowwise_loss

    pconf = _policy_conf(conf, policy)

    def program(params, x, y):
        with torch.inference_mode():
            rows = network_rowwise_loss(pconf, _policy_args(params, policy),
                                        x, y, training=False, tp=tp)
            return rows if policy == "f32" else rows.float()

    return program


def _read_tokens(out):
    """Copies of a generation program's (tok, keys), made under the pool's
    lock: the next replay overwrites them."""
    return out[0].clone(), out[1].clone()


def _read_block(out):
    """Copies of a block program's (toks, tok, keys), made under the pool's
    lock."""
    return tuple(t.clone() for t in out)


def _write_carries(ps, out):
    """After a generation program: copy its new LSTM carries (its last
    output) into the state it was given (the attention caches were written
    in place), and hand on the other outputs."""
    state = ps[1]
    *rest, new = out
    with torch.no_grad():
        for layer, new_layer in zip(state, new):
            for name, t in new_layer.items():
                if t is not layer[name]:
                    layer[name].copy_(t)
    return tuple(rest)


def _decode_program(conf, paged: bool = False, tp=None,
                    policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    conf = _policy_conf(conf, policy)

    def program(ps, tok, pos, keys, temps, *page_table):
        params, state = ps
        params = _policy_args(params, policy)
        with torch.inference_mode():
            if paged:
                logp, new = decode_mod.decode_step_paged(
                    conf, params, state, tok, pos, *page_table, tp=tp)
            else:
                logp, new = decode_mod.decode_step(conf, params, state, tok,
                                                   pos, tp=tp)
            tok2, keys2 = nd_random.sample_tokens(logp.float(), keys, temps)
        return tok2, keys2, new

    return program


def _sample_f32(logp, keys, temps):
    return nd_random.sample_tokens(logp.float(), keys, temps)


def _decode_block_program(conf, k: int, paged: bool, tp=None,
                          policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    conf = _policy_conf(conf, policy)

    def program(ps, tok, pos, keys, temps, rem, *page_table):
        params, state = ps
        params = _policy_args(params, policy)
        with torch.inference_mode():
            return decode_mod.decode_block(
                conf, params, state, tok, pos, keys, temps, rem, k,
                _sample_f32, page_table=page_table[0] if paged else None,
                tp=tp)

    return program


def _sample_chain(logp, keys, temps):
    """One token a chunk position: position i draws from logp[:, i] with
    the keys position i - 1 left, the splits K one-step samplers make.
    Returns (toks [B, K] int32, keys_after [B, K, 2])."""
    toks, keys_after = [], []
    for i in range(logp.shape[1]):
        t, keys = nd_random.sample_tokens(logp[:, i], keys, temps)
        toks.append(t)
        keys_after.append(keys)
    return torch.stack(toks, dim=1), torch.stack(keys_after, dim=1)


def _accepted_len(toks, sampled):
    """Each row's accepted depth, in the program: e = 1 + the number of
    leading proposals toks[:, 1:] equal to the samples sampled[:, :-1]
    before them. Integer comparisons, so it equals the host's count on the
    read-back arrays."""
    b, kk = toks.shape
    if kk == 1:
        return torch.ones((b,), dtype=torch.int64, device=toks.device)
    agree = (toks[:, 1:].long() == sampled[:, :-1].long()).long()
    return 1 + torch.cumprod(agree, dim=1).sum(dim=1)


def _rollback_carries(state, carries, e):
    """`state` with each recurrent layer's (h, c) replaced by its carries
    after the e-th chunk token (index e - 1 of the [B, K, hidden] stacks):
    a carry advanced past the accepted tokens would condition every later
    token on rejected ones. Attention layers keep theirs."""
    rows = torch.arange(e.shape[0], device=e.device)
    return tuple({k: v[rows, e - 1] for k, v in car.items()} if car else lay
                 for lay, car in zip(state, carries))


def _verify_program(conf, paged: bool, tp=None,
                    policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    conf = _policy_conf(conf, policy)

    def program(ps, toks, pos, keys, temps, *page_table):
        params, state = ps
        params = _policy_args(params, policy)
        with torch.inference_mode():
            if paged:
                logp, new, carries = decode_mod.verify_chunk_paged(
                    conf, params, state, toks, pos, *page_table, tp=tp)
            else:
                logp, new, carries = decode_mod.verify_chunk(
                    conf, params, state, toks, pos, tp=tp)
            sampled, keys_after = _sample_chain(logp.float(), keys, temps)
            new = _rollback_carries(new, carries,
                                    _accepted_len(toks, sampled))
        return sampled, keys_after, new

    return program


def _prefill_logp_program(conf, tp=None, policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    conf = _policy_conf(conf, policy)

    def program(ps, prompt, length):
        params, state = ps
        params = _policy_args(params, policy)
        with torch.inference_mode():
            logp, new = decode_mod.prefill(conf, params, state, prompt,
                                           length, tp=tp)
        return logp.float(), new

    return program


def _prefill_program(conf, tp=None, policy: str = "f32") -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    conf = _policy_conf(conf, policy)

    def program(ps, prompt, length, keys, temps):
        params, state = ps
        params = _policy_args(params, policy)
        with torch.inference_mode():
            logp, new = decode_mod.prefill(conf, params, state, prompt,
                                           length, tp=tp)
            tok0, keys2 = nd_random.sample_tokens(logp.float(), keys, temps)
        return tok0, keys2, new

    return program
