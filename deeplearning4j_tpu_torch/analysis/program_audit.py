"""Program auditor: the JAX package's rules over recorded runs of the
port's programs.

The port of `deeplearning4j_tpu/analysis/program_audit.py`. The JAX
package traces a jaxpr and runs nothing. The port has no trace that
reaches its kernels: they are `ctypes` launches behind device checks
(`nd/kernels.py`), so a meta or fake-tensor trace stops at the wrappers.
So a program is audited by running it ONCE, eagerly, on clones of its
params and inputs (nothing the network holds changes, and no graph is
captured), under a `TorchDispatchMode` that records every aten op with the
shape, dtype, device and storage of its inputs and outputs
(`record_program`), beside the `kernels.launch_snapshot()` difference,
which names the hand-written kernels that launched and which the mode
cannot see. The rules then read that recording (`audit_recording`, the
JAX package's `audit_jaxpr`). Rule ids, severities and message shapes are
the JAX package's:

  f64-op                 a float64 or complex128 tensor among an op's
                         inputs or outputs (the stack computes in
                         float32 and below)
  dtype-promotion        a `.to(dtype)` (`aten._to_copy`, `aten.to`) to a
                         float of at least 16 and under 64 bits, wider
                         than the active precision policy's compute
                         ceiling (`POLICY_WIDTH`)
  materialized-scores    an op input or output with two dims at or above
                         the sequence scale: the [S,S] attention scores
                         the flash kernels exist to avoid. A tensor shaped
                         like one of the program's param leaves or a view
                         of one (or, for a matrix, its transpose) is
                         exempt: at the zoo's published widths the
                         weights, their views and their gradients reach
                         the scale (LeNet's [800, 500], the char-LSTM's
                         [320, 1024] and its recurrent block [256, 1024])
                         and are no scores. The JAX package exempts
                         nothing.
  undonated-step         a train-step program (step cache, data-parallel
                         step cache) on CUDA that does not write its result
                         into the params in place: the port's counterpart
                         of donating the params buffer
  undonated-kv-cache     a decode/prefill/verify/prefill-logp/
                         decode-multi[K] program on CUDA whose state
                         outputs neither alias its state inputs nor are
                         written back into them
  undonated-kv-pages     the same for the paged entries
                         (decode-paged/verify-paged/decode-multi-paged[K])
  spec-decode-parity     greedy speculative decoding emitted other tokens
                         than plain sequential decoding on a zoo model
  host-callback          a host read of the program's data
                         (`aten._local_scalar_dense`: `.item()`, `bool()`;
                         `equal`, `is_nonzero`, `allclose`) or a copy from a
                         CUDA tensor to the CPU, inside a program
  collective-in-single-chip
                         a `c10d` or `_c10d_functional` op in a program
                         keyed single-chip
  folded-constant        an op input of 1 MiB or more whose storage is none
                         of the program's params or inputs and was not
                         produced inside the run (data baked into the
                         program by a closure)
  replicated-large-leaf  on a plan with a model axis of M > 1, a param leaf
                         of 1 MiB or more that the model axis leaves whole
                         (its rank-local shape is its global shape)

Programs reach the auditor as in the JAX package: `audit_fn` runs any
callable, `audit_cache` runs the program of each audit record a
`CompiledProgramCache` keeps (`optimize/step_cache.py`: key, kind, build,
the inputs' specs, `in_place`, mesh and plan), and `audit_zoo_models` runs
the four zoo models' serve, train-step and generation programs through
fresh caches and audits the lot (`python -m deeplearning4j_tpu_torch.cli
analyze`). None of the three in-place rules fires on the CPU, where a
program runs eagerly and nothing is captured, as the JAX package expects
donation only off the CPU.

What a recording cannot see: ops that do not go through the dispatcher
(`Tensor.numpy()` of a CPU tensor, `torch.from_numpy`), and the work
inside a hand-written kernel (its launch is recorded by name).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from deeplearning4j_tpu_torch.analysis.report import Finding

#: ops that read a tensor's value back to the host (under
#: `inference_mode` the dispatch mode sees `aten.item` where autograd would
#: have decomposed it to `_local_scalar_dense`)
HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.equal",
    "aten.is_nonzero", "aten.allclose",
})

#: ops that convert a tensor's dtype or device (`.to()`, `.float()`,
#: `.cpu()`; `aten.to` itself under `inference_mode`)
CAST_OPS = frozenset({"aten._to_copy", "aten.to", "aten.type_as"})

#: op namespaces of the cross-rank collectives (meaningless on one card)
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional",
                                   "c10d_functional"})

#: the 64-bit float dtypes, by name (the auditor names no such dtype)
_WIDE_DTYPES = ("torch.float64", "torch.complex128")

#: compute-width ceiling (bits) each serve-precision policy allows
POLICY_WIDTH = {"f32": 32, "bf16": 16, "int8": 16}

#: default byte threshold above which a folded constant is flagged
CONST_BYTES_THRESHOLD = 1 << 20  # 1 MiB

#: default byte threshold above which a param leaf a model axis leaves
#: whole is flagged (replicated-large-leaf)
REPLICATED_LEAF_BYTES = 1 << 20  # 1 MiB

#: default sequence scale for the materialized-scores rule: only shapes
#: with two dims at or above this count as an [S,S] materialization
#: (tiny test models legitimately build [16,16] masks)
SEQ_THRESHOLD = 512

#: the infer cache's generation entries, by the state they write
_KV_ENTRIES = ("decode", "prefill", "verify", "prefill-logp")
_PAGED_ENTRIES = ("decode-paged", "verify-paged")


# -- recording a program -------------------------------------------------------

class TensorRecord(NamedTuple):
    """A tensor an op read or wrote: shape, dtype, device, the address of
    its storage (0 where it has none), its bytes, and whether it derives
    from the program's params or inputs."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    storage: int
    nbytes: int
    derived: bool


class OpRecord(NamedTuple):
    """One dispatched op: its name ("aten.mm.default"), namespace, and the
    tensors among its inputs and outputs."""

    name: str
    namespace: str
    inputs: Tuple[TensorRecord, ...]
    outputs: Tuple[TensorRecord, ...]

    @property
    def packet(self) -> str:
        """The name without its overload ("aten.mm")."""
        return self.name.rsplit(".", 1)[0] if self.name.count(".") > 1 \
            else self.name


class Recording(NamedTuple):
    """A program's recorded run: its ops in order, the hand-written kernels
    it launched (name -> launches), the storages of its params and inputs,
    and the shapes of its param leaves and their views (with each matrix's
    transpose). The port's counterpart of a ClosedJaxpr."""

    ops: Tuple[OpRecord, ...]
    launches: Dict[str, int]
    arg_storages: frozenset
    param_shapes: frozenset


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


class _Recorder(TorchDispatchMode):
    """Records every op dispatched while `active`. Whether a tensor derives
    from the program's data is kept by identity (a storage address can be
    reused by an unrelated tensor). The shapes of the param leaves `params`
    (tensors among `args`) and of every view of them are kept, each
    matrix's transpose too."""

    def __init__(self, args, params=()):
        super().__init__()
        self.param_shapes = set()
        self._param_storages = {_storage(t) for t in params} - {0}
        for t in params:
            self._param_shape(t)
        self.ops: List[OpRecord] = []
        self.active = True
        self._derived: Dict[int, weakref.ref] = {}
        self.arg_storages = set()
        for t in _tensors(args):
            self._mark(t)
            self.arg_storages.add(_storage(t))

    def _param_shape(self, t: torch.Tensor) -> None:
        shape = tuple(t.shape)
        self.param_shapes.add(shape)
        if len(shape) == 2:
            self.param_shapes.add(shape[::-1])

    def _mark(self, t: torch.Tensor) -> None:
        key = id(t)
        self._derived[key] = weakref.ref(
            t, lambda _r, k=key: self._derived.pop(k, None))

    def _is_derived(self, t: torch.Tensor) -> bool:
        ref = self._derived.get(id(t))
        return ref is not None and ref() is t

    def _rec(self, t: torch.Tensor, derived: bool) -> TensorRecord:
        return TensorRecord(tuple(t.shape), t.dtype, t.device, _storage(t),
                            t.numel() * t.element_size(), derived)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            if _storage(t) in self._param_storages:
                self._param_shape(t)
        derived = any(self._is_derived(t) for t in ins)
        if derived:
            for t in outs:
                self._mark(t)
        if self.active:
            self.ops.append(OpRecord(
                str(func), str(getattr(func, "namespace", "")),
                tuple(self._rec(t, self._is_derived(t)) for t in ins),
                tuple(self._rec(t, derived) for t in outs)))
        return out

    @contextlib.contextmanager
    def paused(self):
        """Ops run inside are not recorded (the host loop between the
        segments of a segmented program); what they produce still counts
        as produced inside the run."""
        self.active = False
        try:
            yield
        finally:
            self.active = True

    def recorded(self, segment: Callable):
        """`segment()`, recorded even inside `paused`."""
        was, self.active = self.active, True
        try:
            return segment()
        finally:
            self.active = was


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _clone(tree, memo: dict):
    """A copy of a (params, inputs) tree whose tensors are fresh clones
    (requires_grad kept), so that a run changes nothing the caller holds;
    `memo` maps each original's id to its clone."""
    from deeplearning4j_tpu_torch.optimize.tree import tree_map

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        with torch.inference_mode(False), torch.no_grad():
            c = t.detach().clone()
        memo[id(t)] = c
        return c.requires_grad_(t.requires_grad) if c.is_floating_point() \
            else c

    return tree_map(one, tree)


@contextlib.contextmanager
def _recording(args, params=()):
    """The recorder pushed around a body, as the caches run their programs
    (`ids_checked`: the entry points check token ids on the host before a
    program runs), with the kernel launches of the body in `launches`."""
    from deeplearning4j_tpu_torch.nd import kernels
    from deeplearning4j_tpu_torch.nn.layers.base import ids_checked

    rec = _Recorder(args, params)
    before = kernels.launch_snapshot()
    with ids_checked(), rec:
        yield rec
    after = kernels.launch_snapshot()
    rec.launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}


def _finish(rec: _Recorder) -> Recording:
    return Recording(tuple(rec.ops), dict(rec.launches),
                     frozenset(rec.arg_storages), frozenset(rec.param_shapes))


def record_program(fn: Callable, args: Sequence, params=None
                   ) -> Tuple[Recording, object]:
    """Run `fn(*args)` once on clones of `args` under the recorder; returns
    (the recording, fn's output). `params` is the tree of the program's
    param leaves among `args`: the materialized-scores rule exempts their
    shapes and their views'."""
    memo: dict = {}
    args = _clone(tuple(args), memo)
    params = [memo[id(t)] for t in _tensors(params) if id(t) in memo]
    with _recording(args, params) as rec:
        out = fn(*args)
    return _finish(rec), out


# -- walks (the JAX package's names) -------------------------------------------

def iter_eqns(recording: Recording) -> Iterator[OpRecord]:
    """Every recorded op, in order (the JAX package walks a jaxpr's eqns
    and sub-jaxprs; a recording is already flat: a loop's body appears once
    an iteration)."""
    yield from recording.ops


def collect_shapes(recording: Recording, out: Optional[list] = None
                   ) -> List[Tuple]:
    """Every input and output shape of every op."""
    if out is None:
        out = []
    for op in iter_eqns(recording):
        for t in op.inputs + op.outputs:
            out.append(t.shape)
    return out


def score_scale_shapes(recording: Recording, seq_threshold: int
                       ) -> List[Tuple]:
    """Shapes with >= 2 dims at sequence scale — the [S,S] offenders —
    other than the shapes of the program's param leaves."""
    return [s for s in collect_shapes(recording)
            if sum(1 for dim in s if dim >= seq_threshold) >= 2
            and s not in recording.param_shapes]


def assert_no_materialized_scores(fn, args, seq_threshold: int,
                                  where: str) -> None:
    """Run `fn(*args)` on clones and assert that no op produced an
    [S,S]-scale tensor."""
    recording, _ = record_program(fn, args)
    offenders = score_scale_shapes(recording, seq_threshold)
    assert not offenders, (f"[S,S]-scale intermediates in {where}: "
                           f"{sorted(set(offenders))}")


# -- recording-level rules -----------------------------------------------------

def _float_bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits if dtype.is_floating_point else 0


def audit_recording(recording: Recording, *, where: str,
                    policy: str = "f32",
                    seq_threshold: Optional[int] = None,
                    single_chip: bool = True,
                    const_bytes_threshold: int = CONST_BYTES_THRESHOLD
                    ) -> List[Finding]:
    """Run every recording-level rule over one recorded program.

    where:          location tag stamped on findings ("program:<where>").
    policy:         active precision policy for the promotion rule.
    seq_threshold:  enable the materialized-scores rule at this scale
                    (None skips it — the rule is only meaningful for
                    attention programs with a known sequence length).
    single_chip:    whether this program's cache key says it runs on one
                    card (enables the collective rule).
    """
    loc = f"program:{where}"
    findings: List[Finding] = []
    f64_ops: Dict[str, str] = {}
    promo: Dict[str, str] = {}
    host: Dict[str, bool] = {}
    coll: Dict[str, bool] = {}
    ceiling = POLICY_WIDTH.get(policy, 32)
    known = set(recording.arg_storages)
    consts: Dict[int, TensorRecord] = {}
    for op in iter_eqns(recording):
        for t in op.inputs + op.outputs:
            if str(t.dtype) in _WIDE_DTYPES:
                f64_ops.setdefault(op.packet, str(t.dtype)[6:])
        if op.packet in CAST_OPS and op.outputs and op.inputs:
            dt = op.outputs[0].dtype
            bits = _float_bits(dt)
            if (16 <= bits < 64 and bits > ceiling
                    and dt != op.inputs[0].dtype):
                promo.setdefault(str(dt)[6:], op.packet)
        if op.packet in HOST_READ_OPS and any(t.derived for t in op.inputs):
            host.setdefault(op.packet, True)
        if (op.packet in CAST_OPS or op.packet == "aten.copy_") and \
                op.outputs and op.inputs:
            src = op.inputs[-1] if op.packet == "aten.copy_" \
                else op.inputs[0]
            if src.device.type == "cuda" and \
                    op.outputs[0].device.type == "cpu":
                host.setdefault(f"{op.packet} (cuda -> cpu)", True)
        if single_chip and op.namespace in COLLECTIVE_NAMESPACES:
            coll.setdefault(op.packet, True)
        for t in op.inputs:
            if (t.storage and t.storage not in known
                    and t.nbytes >= const_bytes_threshold):
                consts.setdefault(t.storage, t)
        known.update(t.storage for t in op.outputs)

    if f64_ops:
        offenders = ", ".join(f"{p} ({d})"
                              for p, d in sorted(f64_ops.items()))
        findings.append(Finding(
            "f64-op", "error", loc,
            f"x64 leak: 64-bit float values flow through {offenders} — "
            f"the stack is bitwise-f32 by contract"))
    if promo:
        offenders = ", ".join(sorted(promo))
        findings.append(Finding(
            "dtype-promotion", "warn", loc,
            f"promotion to {offenders} exceeds the {policy} policy's "
            f"{ceiling}-bit compute ceiling"))
    if host:
        findings.append(Finding(
            "host-callback", "error", loc,
            f"host callback primitive(s) {sorted(host)} inside a "
            f"compiled hot path — a device->host round trip per call"))
    if coll:
        findings.append(Finding(
            "collective-in-single-chip", "error", loc,
            f"collective primitive(s) {sorted(coll)} in a program "
            f"keyed single-chip"))
    if seq_threshold:
        offenders = score_scale_shapes(recording, seq_threshold)
        if offenders:
            findings.append(Finding(
                "materialized-scores", "error", loc,
                f"[S,S]-scale intermediates at S>={seq_threshold}: "
                f"{sorted(set(offenders))[:4]} — full attention scores "
                f"are materialized"))
    for t in consts.values():
        findings.append(Finding(
            "folded-constant", "error", loc,
            f"constant of shape {t.shape} dtype {str(t.dtype)[6:]} "
            f"({t.nbytes} bytes) folded into the program — data "
            f"baked into the program by a closure is captured per value "
            f"and held by every graph"))
    return findings


#: the JAX package's name for the recording-level audit
audit_jaxpr = audit_recording


def audit_fn(fn, args, params=None, **kwargs) -> List[Finding]:
    """Run `fn(*args)` once on clones of `args` and audit the recording.
    `params` as in `record_program`. Accepts the same rule options as
    `audit_recording`; `where` defaults to the function's name."""
    kwargs.setdefault("where", getattr(fn, "__name__", repr(fn)))
    recording, _ = record_program(fn, args, params)
    return audit_recording(recording, **kwargs)


# -- cache-level audit ---------------------------------------------------------

def _specs(tree) -> list:
    from deeplearning4j_tpu_torch.optimize.step_cache import TensorSpec

    if isinstance(tree, TensorSpec):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [s for x in tree for s in _specs(x)]
    if isinstance(tree, dict):
        return [s for k in tree for s in _specs(tree[k])]
    return []


def _make(tree):
    """Fresh tensors for a record's specs (kept integer values, else
    zeros), in the record's tree."""
    from deeplearning4j_tpu_torch.optimize.step_cache import TensorSpec

    if isinstance(tree, TensorSpec):
        with torch.inference_mode(False):
            return tree.make()
    if isinstance(tree, (tuple, list)):
        made = [_make(x) for x in tree]
        return type(tree)(*made) if hasattr(tree, "_fields") \
            else type(tree)(made)
    if isinstance(tree, dict):
        return {k: _make(v) for k, v in tree.items()}
    return tree


def _donation_expected(expect_donation: Optional[bool], rec) -> bool:
    """Whether a program should update in place: as asked, else when it
    runs on CUDA (where it is a captured graph)."""
    if expect_donation is not None:
        return bool(expect_donation)
    return any(s.device.type == "cuda" for s in _specs(rec["abstract"]))


def _entry(rec) -> str:
    key = rec["key"]
    return key[0] if key and isinstance(key[0], str) else ""


def _is_kv(entry: str) -> bool:
    return entry in _KV_ENTRIES or entry.startswith("decode-multi[")


def _is_paged(entry: str) -> bool:
    return entry in _PAGED_ENTRIES or entry.startswith("decode-multi-paged[")


def _param_tree(rec, args=None):
    """The params of a record's first argument (of its specs, or of `args`
    made from them): a generation program takes (params, state)."""
    args = rec["abstract"] if args is None else args
    first = args[0] if args else ()
    entry = _entry(rec)
    if rec["kind"] == "infer-cache" and (_is_kv(entry) or _is_paged(entry)):
        return first[0]
    return first


def _replicated_large_leaves(rec, where: str, threshold: int
                             ) -> List[Finding]:
    """The replicated-large-leaf rule body: on a plan with a model axis of
    M > 1, every param leaf of `threshold` bytes or more must be one the
    model axis splits (a leaf of the record's `layout`)."""
    plan = rec.get("plan")
    if plan is None or getattr(plan, "model_size", 1) <= 1:
        return []
    layout = rec.get("layout") or {}
    findings: List[Finding] = []
    params = _param_tree(rec)
    for i, layer in enumerate(params if isinstance(params, (tuple, list))
                              else ()):
        if not isinstance(layer, dict):
            continue
        for name in sorted(layer):
            for spec in _specs(layer[name]):
                if spec.nbytes < threshold or (i, name) in layout:
                    continue
                findings.append(Finding(
                    "replicated-large-leaf", "error", f"program:{where}",
                    f"param leaf {spec.shape}/{str(spec.dtype)[6:]} "
                    f"({spec.nbytes} bytes) is fully replicated on a mesh "
                    f"with a 'model' axis — shard it (plan.param_pspecs) "
                    f"or it re-caps per-card memory at the single-card "
                    f"bound"))
    return findings


def _storages(tree) -> set:
    return {_storage(t) for t in _tensors(tree)}


def _run_record(rec):
    """Run a record's program once on fresh tensors of its specs, as the
    cache runs it (its `write` after it, a segmented program's segments in
    its host loop, unrecorded). Returns (recording, whether every state
    output of a generation program aliases its state input)."""
    from deeplearning4j_tpu_torch.optimize.step_cache import Segmented

    args = _make(tuple(rec["abstract"]))
    fn = rec["build"]()
    aliased = True
    with _recording(args, _tensors(_param_tree(rec, args))) as r:
        if isinstance(fn, Segmented):
            run = fn.make(args[0], args[1:])
            # the host loop between segments reads probes back by design:
            # only the segments (each one graph on CUDA) are the program
            with r.paused():
                run.drive(lambda name: r.recorded(run.segments[name]))
                r.recorded(run.segments["write"])
        else:
            out = fn(*args)
            entry = _entry(rec)
            if rec["kind"] == "infer-cache" and (_is_kv(entry)
                                                 or _is_paged(entry)):
                state_in = _storages(args[0][1])
                aliased = _storages(out[-1]) <= state_in
            if rec.get("write") is not None:
                rec["write"](args[0], out)
    return _finish(r), aliased


def audit_cache(cache, *, expect_donation: Optional[bool] = None,
                seq_threshold: Optional[int] = None,
                const_bytes_threshold: int = CONST_BYTES_THRESHOLD,
                replicated_leaf_threshold: int = REPLICATED_LEAF_BYTES
                ) -> List[Finding]:
    """Audit every program a `CompiledProgramCache` has made this process,
    through the audit records the cache keeps a key (builder, the inputs'
    specs, in-place decision): each builder's program runs once on fresh
    tensors of its specs (nothing the cache holds is touched).

    expect_donation: whether train-step programs should update their params
    in place (None = exactly when the program runs on CUDA, where it is a
    captured graph — the cache's own policy)."""
    findings: List[Finding] = []
    for rec in cache.audit_records():
        where = f"{rec['kind']}:{rec['key']}"
        policy = "f32"
        for part in rec["key"]:
            if (isinstance(part, tuple) and len(part) == 2
                    and part[0] == "policy"):
                policy = part[1]
        donation = _donation_expected(expect_donation, rec)
        recording, aliased = _run_record(rec)
        entry = _entry(rec)
        if (rec["kind"] in ("step-cache", "dp-step-cache")
                and not rec["in_place"] and donation):
            findings.append(Finding(
                "undonated-step", "error", f"program:{where}",
                "train-step program compiled without donating its params "
                "buffer — every parameter is double-buffered in HBM"))
        kv_in_place = rec["in_place"] or aliased
        if (rec["kind"] == "infer-cache" and _is_kv(entry)
                and not kv_in_place and donation):
            findings.append(Finding(
                "undonated-kv-cache", "error", f"program:{where}",
                f"{entry} program compiled without donating its "
                f"decode-state buffers — the KV cache is double-buffered "
                f"in HBM on every token"))
        if (rec["kind"] == "infer-cache" and _is_paged(entry)
                and not kv_in_place and donation):
            findings.append(Finding(
                "undonated-kv-pages", "error", f"program:{where}",
                f"{entry} program compiled without donating the "
                f"shared KV page pool — the pool is the server's entire "
                f"generation memory, double-buffered on every step"))
        findings.extend(_replicated_large_leaves(
            rec, where, replicated_leaf_threshold))
        findings.extend(audit_recording(
            recording, where=where, policy=policy,
            seq_threshold=seq_threshold,
            single_chip=not rec["mesh"],
            const_bytes_threshold=const_bytes_threshold))
    return findings


# -- the zoo sweep -------------------------------------------------------------

def _zoo_labels(out: torch.Tensor) -> torch.Tensor:
    """A valid labels batch shaped like a model's output activations:
    uniform rows are simultaneously a probability distribution (MCXENT
    softmax heads) and an in-(0,1) target (reconstruction heads)."""
    return torch.full(tuple(out.shape), 1.0 / out.shape[-1],
                      dtype=torch.float32, device=out.device)


def audit_zoo_programs(small: bool = True, rows: int = 4,
                       expect_donation: Optional[bool] = None,
                       seq_threshold: Optional[int] = None, device=None
                       ) -> Tuple[List[Finding], int]:
    """Build the four zoo models (LeNet, char-LSTM, charTransformer,
    deep-AE) on `device` (CUDA unless the caller passes "cpu"), run each
    one's serve `output` program and train step through fresh caches (the
    generative ones also their decode, paged, prefix, block and
    speculative programs), and audit every program the caches made.
    Returns (findings, programs audited)."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nd.platform import resolve_device
    from deeplearning4j_tpu_torch.nn.decode import check_generative
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.quantize import default_calibration

    dev = resolve_device(device)
    findings: List[Finding] = []
    n_programs = 0
    for name, conf in zoo.precision_eval_confs(small).items():
        net = MultiLayerNetwork(conf, device=dev, seed=0).init()
        x = default_calibration(conf, rows)
        out = net.output(x)                    # makes the serve program
        net.finetune(x, _zoo_labels(out))      # makes the train step
        try:
            check_generative(conf)
        except ValueError:
            pass
        else:
            # fixed audit geometry, NOT a serving default: the auditor pins
            # tiny shapes so every variant is made (the draft's own programs
            # live in the draft's cache; its verify step lives here)
            net.warmup_generate(slots=2, max_seq=8,  # lint: allow(hardcoded-tunable)
                                prompt_buckets=(4,),
                                steps_per_dispatch=4)  # lint: allow(hardcoded-tunable)
            net.warmup_generate(slots=2, max_seq=8,  # lint: allow(hardcoded-tunable)
                                prompt_buckets=(4,),
                                page_size=4, prefix_cache=True,  # lint: allow(hardcoded-tunable)
                                steps_per_dispatch=4)  # lint: allow(hardcoded-tunable)
            draft = MultiLayerNetwork(
                zoo.char_lstm(conf.conf(-1).n_out, hidden=8, n_layers=1),
                device=dev, seed=0).init()
            net.warmup_generate(slots=2, max_seq=8,  # lint: allow(hardcoded-tunable)
                                prompt_buckets=(4,),
                                draft_net=draft, spec_k=2)
        for cache in (net.step_cache, net.infer_cache):
            recs = cache.audit_records()
            n_programs += len(recs)
            for f in audit_cache(cache, expect_donation=expect_donation,
                                 seq_threshold=seq_threshold):
                findings.append(Finding(f.rule, f.severity,
                                        f"{name}/{f.location}", f.message))
    return findings, n_programs


def audit_zoo_models(small: bool = True, rows: int = 4,
                     expect_donation: Optional[bool] = None,
                     seq_threshold: Optional[int] = None, device=None
                     ) -> Tuple[List[Finding], int]:
    """`audit_zoo_programs`, then the attention, decode and
    speculative-parity audits (whose geometry is their own, whatever
    `small` is). Returns (findings, programs audited)."""
    from deeplearning4j_tpu_torch.nd.platform import resolve_device

    dev = resolve_device(device)
    findings, n_programs = audit_zoo_programs(small, rows, expect_donation,
                                              seq_threshold, dev)
    findings.extend(audit_attention_structure(device=dev))
    n_programs += 2
    findings.extend(audit_decode_structure(device=dev))
    n_programs += 4
    findings.extend(audit_spec_decode_parity(device=dev))
    n_programs += 2
    return findings, n_programs


def audit_attention_structure(S: int = 1024, D: int = 8, device=None
                              ) -> List[Finding]:
    """The flash-attention forward AND backward at a sequence length where
    an [S,S] materialization is unambiguous (the zoo's small
    transformer runs at S=16, far below `SEQ_THRESHOLD`). On CUDA the f32
    forward kernel and `FlashAttentionFunction`'s fused backward (delta,
    dK/dV, dQ) run: the result must be []. On the CPU the kernels' plain
    versions run, and the forward's (`flash_attention_reference`) takes the
    softmax over the whole [B,H,S,S] row by design: there its
    materialized-scores findings become one `info` finding that says so."""
    from deeplearning4j_tpu_torch.nd import kernels
    from deeplearning4j_tpu_torch.nd.platform import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, S, 1, D), generator=gen).to(dev)

    def fwd(q, k, v):
        with torch.no_grad():
            return kernels.flash_attention(q, k, v, True)

    def bwd(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = kernels.flash_attention(q, k, v, True, fused_bwd=True)
            return torch.autograd.grad(o.sum(), (q, k, v))

    findings = audit_fn(fwd, (q, q, q), where=f"flash-fwd:S={S}",
                        seq_threshold=S)
    findings += audit_fn(bwd, (q, q, q), where=f"flash-bwd:S={S}",
                         seq_threshold=S)
    if dev.type == "cuda":
        return findings
    plain = [f for f in findings if f.rule == "materialized-scores"]
    rest = [f for f in findings if f.rule != "materialized-scores"]
    if plain:
        rest.append(Finding(
            "materialized-scores", "info", f"program:flash:S={S}",
            f"on the CPU the kernels' plain versions run, and "
            f"flash_attention_reference takes the softmax over the whole "
            f"[B,H,S,S] row by design ({len(plain)} program(s)); the CUDA "
            f"kernels keep no [S,S] tensor"))
    return rest


def audit_decode_structure(S: int = 1024, device=None) -> List[Finding]:
    """The KV-cache decode step at a cache length where an [S,S]
    materialization is unambiguous: decode attends [B,1] queries against a
    [B,S] cache, so scores keep ONE sequence axis however long the cache
    grows. The dense and paged steps (`nn/decode.decode_step`,
    `decode_step_paged`) and the infer cache's `decode-multi[4]` and
    `decode-multi-paged[4]` programs. (Prefill legitimately materializes
    [T,T] causal scores at prompt-bucket scale and is not checked.)"""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer
    from deeplearning4j_tpu_torch.nd.platform import resolve_device
    from deeplearning4j_tpu_torch.nn import decode as decode_mod
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.infer_cache import (
        _decode_block_program)

    dev = resolve_device(device)
    conf = char_transformer(24, d_model=16, n_blocks=1, n_heads=2,
                            max_seq_len=S)
    net = MultiLayerNetwork(conf, device=dev, seed=0).init()
    state = decode_mod.init_state(conf, 1, S, device=dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)

    def step(params, state, tok, pos):
        with torch.inference_mode():
            return decode_mod.decode_step(conf, params, state, tok, pos)

    findings = audit_fn(step, (net.params, state, tok, pos), net.params,
                        where=f"decode-step:S={S}", seq_threshold=S)

    # the paged step gathers its context through the page table, which
    # must not change the score shape story: scores stay [B,H,1,ctx]
    page_size = 128
    n_pages = -(-S // page_size)
    pstate = decode_mod.init_paged_state(conf, 1, n_pages + 1, page_size,
                                         device=dev)
    page_table = torch.arange(n_pages, dtype=torch.int32,
                              device=dev).reshape(1, n_pages)

    def paged_step(params, state, tok, pos, page_table):
        with torch.inference_mode():
            return decode_mod.decode_step_paged(conf, params, state, tok,
                                                pos, page_table)

    findings += audit_fn(paged_step,
                         (net.params, pstate, tok, pos, page_table),
                         net.params, where=f"decode-step-paged:S={S}",
                         seq_threshold=S)

    # the K-step block must keep the same story at every step and keep
    # sampling in the program: the exact builders the infer cache runs
    keys = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    temps = torch.zeros((1,), dtype=torch.float32, device=dev)
    rem = torch.full((1,), 4, dtype=torch.int32, device=dev)
    findings += audit_fn(_decode_block_program(conf, 4, False),
                         ((net.params, state), tok, pos, keys, temps, rem),
                         net.params, where=f"decode-multi[4]:S={S}",
                         seq_threshold=S)
    findings += audit_fn(_decode_block_program(conf, 4, True),
                         ((net.params, pstate), tok, pos, keys, temps, rem,
                          page_table),
                         net.params, where=f"decode-multi-paged[4]:S={S}",
                         seq_threshold=S)
    return findings


#: the speculative-parity audit's models and prompts (the JAX package's)
SPEC_VOCAB = 13
SPEC_PROMPTS = ([1, 2, 3, 4], [5, 6, 7])


def spec_parity_confs() -> dict:
    """The two target models of the speculative-parity audit."""
    from deeplearning4j_tpu_torch.models.zoo import (char_lstm,
                                                     char_transformer)

    return {
        "char_lstm": char_lstm(SPEC_VOCAB, hidden=16, n_layers=2),
        "char_transformer": char_transformer(SPEC_VOCAB, d_model=16,
                                             n_blocks=2, n_heads=2,
                                             max_seq_len=32),
    }


def greedy_tokens(net, prompts=SPEC_PROMPTS, n_new: int = 8,
                  **batcher_kw) -> List[List[int]]:
    """Greedy tokens of each prompt from a 2-slot `ContinuousBatcher` on
    `net` (with `draft_net=` and `spec_k=`, speculatively)."""
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher

    b = ContinuousBatcher(net, n_slots=2, max_seq=16,  # lint: allow(hardcoded-tunable)
                          prompt_buckets=(8,), **batcher_kw)
    b.start()
    try:
        streams = [b.submit(list(p), max_new_tokens=n_new,
                            temperature=0.0, rng_seed=i)
                   for i, p in enumerate(prompts)]
        return [list(s.tokens(timeout=120)) for s in streams]
    finally:
        b.stop()


def audit_spec_decode_parity(n_new: int = 8, device=None) -> List[Finding]:
    """Executable parity gate for speculative decoding: greedy decode with
    a char-LSTM draft and `spec_k=3` must emit EXACTLY the tokens plain
    sequential decode emits, on both generative zoo models. Structural
    audits cannot see a wrong acceptance rule; only a divergent trajectory
    can."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm
    from deeplearning4j_tpu_torch.nd.platform import resolve_device
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    dev = resolve_device(device)
    findings: List[Finding] = []
    for name, conf in spec_parity_confs().items():
        net = MultiLayerNetwork(conf, device=dev, seed=0).init()
        plain = greedy_tokens(net, n_new=n_new)
        draft = MultiLayerNetwork(char_lstm(SPEC_VOCAB, hidden=8,
                                            n_layers=1),
                                  device=dev, seed=1).init()
        spec = greedy_tokens(net, n_new=n_new, draft_net=draft, spec_k=3)
        if spec != plain:
            findings.append(Finding(
                "spec-decode-parity", "error", f"program:spec:{name}",
                f"greedy speculative decode diverged from sequential "
                f"decode on {name}: {spec} != {plain} — speculation "
                f"changed the sampled trajectory"))
    return findings
