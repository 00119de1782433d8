"""The port's public surface against the JAX package's (on the CPU).

Every module of `deeplearning4j_tpu` is imported (`pkgutil.walk_packages`)
beside the port's module of the same name. For each one, every public name
the JAX module defines (an object whose `__module__` is that module, or a
constant assigned at its top level), or that a package's `__init__.py`
re-exports from the package, must exist in the port's module; every public
attribute of those classes (`dir`, so inherited ones too) must exist on
the port's class; and every parameter name of a function, method or
constructor present in both must be a parameter of the port's too.

A gap is allowed only where `DELIBERATE` names it, with the reason the
port differs there (and its counterpart). A gap is named as
"module.name", "module.Class.attribute" or "module.function(parameter)",
the module relative to the package, after the class or module that
defines the object in the JAX package; "{a,b}" in a key stands for each of
its alternatives. Modules and names imported from outside the package are
not surface. Each entry is mirrored in ROADMAP.md queue C.
"""

import ast
import importlib
import inspect
import pkgutil
import re
import types

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import deeplearning4j_tpu  # noqa: E402

JAX = "deeplearning4j_tpu"
PORT = "deeplearning4j_tpu_torch"

#: JAX modules with no port module of the same name
NOT_MODULES = {
    "nd.pallas_kernels": "ported as nd/kernels.py and the CUDA sources in "
                         "csrc/",
    "native.libdl4jtpu_io": "the C reader's shared library, loaded by "
                            "native/io.py through ctypes",
}

#: gap -> why the port differs there, and its counterpart
DELIBERATE = {
    "analysis.program_audit.{iter_eqns,collect_shapes,score_scale_shapes}"
    "(jaxpr)":
        "the audit walks a `recording` of the ops one run dispatched, not "
        "a jaxpr",
    "analysis.program_audit.audit_jaxpr(closed)":
        "an alias of `audit_recording`, which takes that `recording`",
    "analysis.program_audit.{HOST_CALLBACK,COLLECTIVE}_PRIMS":
        "jaxpr primitive names; the rules read dispatched op names and "
        "`COLLECTIVE_NAMESPACES`",
    "nd.platform.{is_tpu,default_platform,default_backend}":
        "no default backend: each entry point takes `device` "
        "(`resolve_device`: CUDA unless the CPU is asked), "
        "`device_kind` names it",
    "nd.random.uniform({key,lo,hi,shape,dtype})":
        "the port's `uniform` draws for each key of a batch of keys; "
        "`uniform_dtype(key, shape, dtype, minval, maxval)` is JAX's",
    "nn.multilayer.update_bn_ema{,_from_stats}(axis)":
        "a process `group` all-reduces the moments, where JAX names a "
        "pmean axis",
    "optimize.step_cache.CompiledProgramCache(donate)":
        "no buffer donation: a program writes its result into the params "
        "in place (`write`; `in_place` in its audit record)",
    "optimize.step_cache.CompiledProgramCache.track_jit":
        "no jitted program to wrap: `_run` captures a CUDA graph a key and "
        "keeps its books",
    "optimize.persist.PersistentProgramStore.{load,store}":
        "a CUDA graph cannot be serialized; `load_bytes`/`store_bytes` "
        "keep the byte artifacts",
    "optimize.profiling.compiled_totals(compiled)":
        "no AOT executable to ask: `compiled_totals(step, *args)` counts "
        "one uncaptured call's flops",
    "optimize.tunables.ATTENTION_BLOCK_TABLE":
        "TPU-measured Pallas blocks; the H100 tiles are the key-tile "
        "registry of `nd/kernels.py` and the tuned `attention.block_fwd`",
    "optimize.updater.FlatSpec{.treedef,(treedef)}":
        "`like`, the params tree with None leaves, in place of a pytree "
        "treedef",
    "parallel.{mesh.make_mesh,mesh.serve_mesh,plan.plan_mesh}(devices)":
        "one process a rank: a mesh spans the ranks of a process `group`, "
        "each on its own `device`",
    "parallel.checkpoint.load_sharded({params,updater}_shardings)":
        "no NamedSharding placement: `load(tp=)` reads this rank's pieces",
    "parallel.data_parallel.{make_sharded_train_step,param_pspecs,"
    "zero1_pspecs,shard_train_state}":
        "GSPMD specs: `DataParallelTrainer(plan=)` splits leaves by "
        "`parallel/tensor.py` SPLITS, ZeRO-1 chunks the flat buffer",
    "parallel.mesh.{infer_shardings,serve_placements}":
        "NamedSharding placements: `InferCache.set_mesh` splits the rows, "
        "`tensor.shard_params` the model axis's leaves",
    "parallel.plan.ShardPlan.{batch_sharding,param_shardings,"
    "state_shardings,replicated}":
        "NamedShardings: `tensor.tp_layout` and `pieces` give a rank's "
        "pieces of each leaf",
    "parallel.expert.init_moe_params(key)":
        "draws from a `torch.Generator` (`gen`) on the device it names",
}


def _expand(key):
    """The gaps a `DELIBERATE` key names: each "{a,b}" group expanded."""
    m = re.search(r"\{([^{}]*)\}", key)
    if m is None:
        return [key]
    return [g for alt in m.group(1).split(",")
            for g in _expand(key[:m.start()] + alt + key[m.end():])]


EXEMPT = {g: key for key in DELIBERATE for g in _expand(key)}


def _modules():
    found = [m.name for m in pkgutil.walk_packages(deeplearning4j_tpu.__path__,
                                                   JAX + ".")]
    rel = sorted(n[len(JAX) + 1:] for n in found)
    return [""] + [n for n in rel if n not in NOT_MODULES]


MODULES = _modules()


def _rel(module_name: str) -> str:
    return module_name[len(JAX) + 1:] if module_name != JAX else ""


def _dotted(*parts) -> str:
    return ".".join(p for p in parts if p)


def _assigned(module) -> set:
    """Names assigned at the top level of a module's source."""
    try:
        tree = ast.parse(inspect.getsource(module))
    except (OSError, TypeError):
        return set()
    names = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        for t in targets:
            names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
    return names


def _in_package(obj) -> bool:
    mod = getattr(obj, "__module__", None)
    return isinstance(mod, str) and (mod == JAX or mod.startswith(JAX + "."))


def _surface(module):
    """{name: object} of the JAX module's public surface."""
    package = hasattr(module, "__path__")
    assigned = _assigned(module)
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        mod = getattr(obj, "__module__", None)
        if isinstance(mod, str) and not isinstance(obj, type(None)):
            if mod == module.__name__ or (package and _in_package(obj)):
                out[name] = obj
        elif name in assigned:
            out[name] = obj
    return out


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _owner_id(cls, attr: str) -> str:
    """The gap name of `cls.attr`: after the class of the JAX package
    that defines it (the class itself when that is outside the package)."""
    for c in cls.__mro__:
        if attr in vars(c) and _in_package(c):
            return _dotted(_rel(c.__module__), c.__qualname__, attr)
    return _dotted(_rel(cls.__module__), cls.__qualname__, attr)


def _ctor_id(cls) -> str:
    for c in cls.__mro__:
        if ("__init__" in vars(c) or "__new__" in vars(c)) \
                and _in_package(c):
            return _dotted(_rel(c.__module__), c.__qualname__)
    return _dotted(_rel(cls.__module__), cls.__qualname__)


def _param_gaps(name_id: str, jax_fn, port_fn) -> list:
    jp, tp = _params(jax_fn), _params(port_fn)
    if jp is None or tp is None:
        return []
    return [f"{name_id}({p})" for p in jp if p not in tp]


def _gaps(rel: str) -> list:
    jm = importlib.import_module(_dotted(JAX, rel))
    tm = importlib.import_module(_dotted(PORT, rel))
    gaps = []
    for name, obj in _surface(jm).items():
        if not hasattr(tm, name):
            gaps.append(_dotted(rel, name))
            continue
        if getattr(obj, "__module__", None) != jm.__name__:
            continue  # a re-export: checked where it is defined
        port = getattr(tm, name)
        if inspect.isclass(obj):
            gaps += _param_gaps(_ctor_id(obj), obj, port)
            for attr in dir(obj):
                if attr.startswith("_"):
                    continue
                if not hasattr(port, attr):
                    gaps.append(_owner_id(obj, attr))
                    continue
                a, b = getattr(obj, attr), getattr(port, attr)
                if callable(a) and callable(b):
                    gaps += _param_gaps(_owner_id(obj, attr), a, b)
        elif callable(obj) and callable(port):
            gaps += _param_gaps(_dotted(rel, name), obj, port)
    return sorted(set(gaps))


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m or JAX)
def test_every_public_name_has_a_port_or_a_reason(module):
    missing = [g for g in _gaps(module) if g not in EXEMPT]
    assert not missing, (
        f"{_dotted(JAX, module)}: public names, attributes or parameters "
        f"with no counterpart in {_dotted(PORT, module)} and no entry in "
        f"DELIBERATE: {missing}")


def test_every_deliberate_difference_is_a_real_gap_with_a_reason():
    gaps = {g for m in MODULES for g in _gaps(m)}
    stale = sorted(g for g in EXEMPT if g not in gaps)
    assert not stale, f"DELIBERATE names gaps the port no longer has: {stale}"
    for key, reason in DELIBERATE.items():
        assert reason.strip() and "\n" not in reason, key
    assert len(DELIBERATE) <= 25


def test_the_walk_covers_every_module_of_the_package():
    # every .py file of the JAX package is one of MODULES or NOT_MODULES
    import os

    root = os.path.dirname(deeplearning4j_tpu.__file__)
    files = set()
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, n), root)[:-3]
                rel = rel.replace(os.sep, ".")
                files.add("" if rel == "__init__" else
                          rel[:-len(".__init__")] if rel.endswith(".__init__")
                          else rel)
    assert files <= set(MODULES) | set(NOT_MODULES)
    assert len(MODULES) > 100
