"""AST-based repo-convention linter, pointed at the port's own tree.

The port of `deeplearning4j_tpu/analysis/repo_lint.py`. `lint_package()`
walks `deeplearning4j_tpu_torch/`; the fault-point rule checks against the
port's `reliability.faults.DOCUMENTED_POINTS` and the prom-family rule the
port's `serving/metrics.py:FAMILIES`. Two rules speak torch where the JAX
package's speak jax: platform-sniff flags the `torch.cuda` queries of the
card outside nd/platform.py, and f64-literal flags `torch.float64` and
`torch.double` (and their complex kin) beside numpy's. Every other rule,
with its scope, severity and message, is the JAX package's.

The conventions this repo runs on — one platform-query choke point,
injectable clocks in everything the tests fake time for, no float64 on
the compiled path, a closed registry of fault points and Prometheus
families, lock discipline in the serving fabric — were previously
enforced by review memory.  This module turns each one into an
executable rule over the package's ASTs, reported through the same
`Finding` model as the program auditor (analysis/program_audit.py) and
wired into `python -m deeplearning4j_tpu_torch.cli analyze`.

Rules (rule id — severity — what it catches):

  hardcoded-tunable       warn   a numeric/dict literal at a known
                                 tunable call-site (attention blocks,
                                 flush deadlines, slot/page geometry,
                                 prefetch depth, batch targets) outside
                                 optimize/tunables.py — registry-owned
                                 values must resolve through the
                                 TunedTable layer so `cli tune` winners
                                 actually apply
  platform-sniff          error  `torch.cuda.is_available()` /
                                 `device_count()` / `get_device_name()` /
                                 `get_device_properties()` /
                                 `get_device_capability()` anywhere
                                 outside nd/platform.py, the one module
                                 allowed to ask about the card (so a
                                 test that stands in for the card
                                 patches one place)
  wall-clock              error  `time.time()` / `datetime.now()` /
                                 `utcnow()` in serving/ or reliability/
                                 — those modules take injectable clocks
                                 precisely so tests never sleep;
                                 `time.monotonic` & friends stay legal
  f64-literal             error  `np.float64` / `torch.float64` /
                                 `torch.double` / `dtype="float64"` in
                                 compiled-path packages (nd/ nn/
                                 optimize/ parallel/ serving/ analysis/
                                 models/zoo.py): the port computes in
                                 float32 and below, as the JAX package
                                 does with x64 disabled, so an f64
                                 literal is dead or a silent widening
  np-default-dtype        warn   `np.zeros/ones/empty/full/linspace`
                                 without an explicit dtype in the same
                                 compiled-path packages (NumPy defaults
                                 to float64 — the classic x64 leak seed)
  fault-point             error  a `faults.fire("name")` whose name is
                                 not in `reliability.faults.
                                 DOCUMENTED_POINTS`, or (package walks
                                 only) a documented point with no fire
                                 site; a non-literal point name is warn
  prom-family             error  in serving/metrics.py: an emitted
                                 family absent from `FAMILIES`, a
                                 declared family never emitted, a TYPE
                                 mismatch, or label keys straying from
                                 the declared set (`replica` and `le`
                                 are implicit everywhere)
  lock-order-cycle        error  a cycle in the static lock-order graph
                                 (edges: `with a: ... with b:` nesting)
  unguarded-shared-write  warn   `self._x = ...` to shared mutable
                                 state of a lock-owning class outside
                                 any `with <lock>:` block (methods whose
                                 name ends `_locked` are caller-holds-
                                 lock by repo convention and skipped)

Waivers: append `# lint: allow(rule-id)` to the offending line.  A
waiver is a reviewed, deliberate exception — the linter counts them but
never reports them.

Entry points: `lint_source(src, relpath)` for one module's text (what
the tests feed synthetic sources through), `lint_file(path, root)`, and
`lint_package(root)` which walks deeplearning4j_tpu_torch/ and additionally
runs the whole-package checks (unfired fault points, global lock-order
cycles).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.analysis.report import Finding

#: the one module allowed to ask torch about the card
PLATFORM_HOME = "nd/platform.py"

#: modules whose classes take injectable clocks — wall-clock reads here
#: break every test that fakes time
CLOCKED_SCOPES = ("serving/", "reliability/")

#: packages on the compiled path, where the x64 guard applies
DEVICE_PATH_SCOPES = ("nd/", "nn/", "optimize/", "parallel/", "serving/",
                      "analysis/", "models/zoo.py")

#: `torch.cuda` functions that ask about the card (nd/platform.py answers
#: them for everyone)
_SNIFF_ATTRS = {"is_available", "device_count", "get_device_name",
                "get_device_properties", "get_device_capability"}

#: 64-bit float dtypes by module: numpy's (and jnp's, which a synthetic
#: source may still name) and torch's aliases
_F64_ATTRS = {"np": ("float64", "complex128", "float128"),
              "numpy": ("float64", "complex128", "float128"),
              "jnp": ("float64", "complex128", "float128"),
              "torch": ("float64", "double", "complex128", "cdouble")}

#: numpy constructors whose missing dtype means float64, with the count
#: of required non-dtype positional args (extra positionals are dtypes)
_NP_F64_DEFAULTS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2,
                    "linspace": 2}

_WAIVER_RE = re.compile(r"#\s*lint:\s*allow\(([a-z0-9_,\s-]+)\)")

_LOCKY_RE = re.compile(r"(lock|cond|mutex)", re.IGNORECASE)


def _waivers(src: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(src.splitlines(), 1):
        m = _WAIVER_RE.search(line)
        if m:
            out[lineno] = {r.strip() for r in m.group(1).split(",")}
    return out


def _loc(relpath: str, node: ast.AST) -> str:
    return f"{relpath}:{getattr(node, 'lineno', 0)}"


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted source of a Name/Attribute chain ('self._lock'), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _in_scope(relpath: str, scopes: Sequence[str]) -> bool:
    return any(relpath == s or relpath.startswith(s) for s in scopes)


#: the one module allowed to define tunable constants (the registry's
#: defaults); numeric literals at tunable call-sites anywhere else
#: bypass `cli tune`'s TunedTable override layer
TUNABLE_HOME = "optimize/tunables.py"

#: constant names the registry now owns — re-declaring one with a
#: literal value resurrects a hand-tuned constant
_TUNABLE_CONST_NAMES = {"DEFAULT_TARGET_ROWS", "_BLOCK_TABLE",
                        "ATTENTION_BLOCK_TABLE"}

#: tunable-governed parameters: a numeric literal passed (or defaulted)
#: for one of these pins a value the tuned table can no longer move
_TUNABLE_KWARGS = {"max_delay_ms", "block_q", "block_k", "block_q_bwd",
                   "block_k_bwd", "buffer_batches", "n_slots", "slots",
                   "gen_slots", "page_size", "gen_page_size",
                   "target_rows", "prefetch_depth", "steps_per_dispatch",
                   "gen_steps_per_dispatch"}


def _rule_hardcoded_tunable(tree: ast.AST, relpath: str) -> List[Finding]:
    """warn: a numeric/dict literal at a known tunable call-site outside
    `optimize/tunables.py` (the registry defaults).  Deliberate pins are
    fine — waive them with `# lint: allow(hardcoded-tunable)` so the
    exception is reviewed."""
    if relpath == TUNABLE_HOME:
        return []

    def numeric(node) -> bool:
        return (isinstance(node, ast.Constant)
                and type(node.value) in (int, float))

    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and \
                        tgt.id in _TUNABLE_CONST_NAMES and \
                        (numeric(node.value) or
                         isinstance(node.value, (ast.Dict, ast.Tuple))):
                    out.append(Finding(
                        "hardcoded-tunable", "warn", _loc(relpath, node),
                        f"literal {tgt.id} outside {TUNABLE_HOME} — this "
                        f"constant is registry-owned; resolve it through "
                        f"optimize.tunables instead"))
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in _TUNABLE_KWARGS and numeric(kw.value):
                    out.append(Finding(
                        "hardcoded-tunable", "warn", _loc(relpath, node),
                        f"numeric literal for tunable-governed "
                        f"`{kw.arg}=` — pass None (tunable-resolved) or "
                        f"waive a deliberate pin"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            pairs = list(zip(a.args[len(a.args) - len(a.defaults):],
                             a.defaults))
            pairs += [(arg, d) for arg, d in
                      zip(a.kwonlyargs, a.kw_defaults) if d is not None]
            for arg, default in pairs:
                if arg.arg in _TUNABLE_KWARGS and numeric(default):
                    out.append(Finding(
                        "hardcoded-tunable", "warn",
                        f"{relpath}:{default.lineno}",
                        f"numeric default for tunable-governed parameter "
                        f"`{arg.arg}` — default to None and resolve via "
                        f"optimize.tunables"))
    return out


# -- per-node rules ----------------------------------------------------------

def _rule_platform_sniff(tree: ast.AST, relpath: str) -> List[Finding]:
    if relpath == PLATFORM_HOME:
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in _SNIFF_ATTRS:
            chain = _attr_chain(node)
            if chain and chain.split(".")[-2:-1] == ["cuda"]:
                out.append(Finding(
                    "platform-sniff", "error", _loc(relpath, node),
                    f"{chain} outside nd/platform.py — use the helpers "
                    f"in deeplearning4j_tpu_torch.nd.platform"))
    return out


def _rule_wall_clock(tree: ast.AST, relpath: str) -> List[Finding]:
    if not _in_scope(relpath, CLOCKED_SCOPES):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain == "time.time":
            out.append(Finding(
                "wall-clock", "error", _loc(relpath, node),
                "time.time() in a clocked module — take an injectable "
                "clock (default time.monotonic) like circuit.py does"))
        elif chain and chain.split(".")[-1] in ("now", "utcnow", "today") \
                and chain.split(".")[0] in ("datetime", "date"):
            out.append(Finding(
                "wall-clock", "error", _loc(relpath, node),
                f"{chain}() in a clocked module — wall-clock reads break "
                f"the fake-clock tests"))
    return out


def _rule_unbounded_network_call(tree: ast.AST,
                                 relpath: str) -> List[Finding]:
    """error: a network call in serving/ without an explicit
    `timeout=`.  The default urllib/socket timeout is 'forever'; one
    partitioned peer then wedges the calling thread — and the serving
    control plane (router polls, agent heartbeats, cache fetches) is
    built from exactly these calls.  Every one must bound its wait."""
    if not _in_scope(relpath, ("serving/",)):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain:
            continue
        tail = chain.split(".")[-1]
        has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
        if tail == "urlopen" and not has_timeout:
            out.append(Finding(
                "unbounded-network-call", "error", _loc(relpath, node),
                "urlopen without an explicit timeout= in serving/ — a "
                "partitioned peer wedges this thread forever; bound "
                "every network wait"))
        elif tail == "create_connection" and not has_timeout \
                and len(node.args) < 2:
            # socket.create_connection(addr[, timeout]): positional
            # timeout counts too
            out.append(Finding(
                "unbounded-network-call", "error", _loc(relpath, node),
                "socket connect without an explicit timeout in "
                "serving/ — bound every network wait"))
    return out


def _rule_f64(tree: ast.AST, relpath: str) -> List[Finding]:
    if not _in_scope(relpath, DEVICE_PATH_SCOPES):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                         ast.Name):
            if node.attr in _F64_ATTRS.get(node.value.id, ()):
                out.append(Finding(
                    "f64-literal", "error", _loc(relpath, node),
                    f"{node.value.id}.{node.attr} on the compiled path — "
                    f"the port computes in float32 and below; this is "
                    f"dead or a silent widening"))
        if isinstance(node, ast.keyword) and node.arg == "dtype" and \
                isinstance(node.value, ast.Constant) and \
                node.value.value in ("float64", "f8", "complex128"):
            out.append(Finding(
                "f64-literal", "error", _loc(relpath, node.value),
                f"dtype={node.value.value!r} on the compiled path"))
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            ctor = chain.split(".")[-1] if chain else ""
            if chain and chain.split(".")[0] in ("np", "numpy") and \
                    ctor in _NP_F64_DEFAULTS and \
                    not any(kw.arg == "dtype" for kw in node.keywords) and \
                    len(node.args) <= _NP_F64_DEFAULTS[ctor]:
                out.append(Finding(
                    "np-default-dtype", "warn", _loc(relpath, node),
                    f"{chain}(...) without dtype defaults to float64 — "
                    f"pass an explicit dtype on the compiled path"))
    return out


def _fire_sites(tree: ast.AST, relpath: str):
    """(point-or-None, lineno) for every faults.fire()/REGISTRY.fire()/
    fire() call in the module."""
    sites = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain is None or chain.split(".")[-1] != "fire":
            continue
        head = chain.split(".")[0]
        if head not in ("faults", "fire", "REGISTRY") and \
                "faults" not in chain:
            continue
        if node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            sites.append((node.args[0].value, node.lineno))
        else:
            sites.append((None, node.lineno))
    return sites


def _rule_fault_point(tree: ast.AST, relpath: str,
                      documented: Dict[str, str]) -> List[Finding]:
    if relpath == "reliability/faults.py":
        return []  # the registry itself (fire() definition + aliases)
    out = []
    for point, lineno in _fire_sites(tree, relpath):
        if point is None:
            out.append(Finding(
                "fault-point", "warn", f"{relpath}:{lineno}",
                "faults.fire() with a non-literal point name — the "
                "registry cannot vouch for it"))
        elif point not in documented:
            out.append(Finding(
                "fault-point", "error", f"{relpath}:{lineno}",
                f"undocumented fault point {point!r} — add it to "
                f"reliability.faults.DOCUMENTED_POINTS"))
    return out


# -- prom-family (serving/metrics.py only) -----------------------------------

#: label keys legal on every family: the router stamps `replica` when
#: re-exporting, the histogram renderer stamps `le`
_IMPLICIT_LABELS = {"replica", "le"}

#: positional index of the `labels` argument per emission method
_LABELS_ARG_INDEX = {"gauge": 3, "counter": 3, "histogram": 7}


def _literal_families(tree: ast.AST):
    """The `FAMILIES = {...}` literal from the module AST, or None."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "FAMILIES":
            try:
                return ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
    return None


def _label_keys(expr, env: Dict[str, Set[str]]) -> Optional[Set[str]]:
    """Statically resolve a labels argument to its set of keys.
    None = unresolvable; callers treat that as 'cannot check'."""
    if expr is None:
        return set()
    if isinstance(expr, ast.Constant) and expr.value is None:
        return set()
    if isinstance(expr, ast.Dict):
        keys = set()
        for k in expr.keys:
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None
            keys.add(k.value)
        return keys
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        # the lbl(**extra) helper pattern: keyword names ARE the own keys
        if any(kw.arg is None for kw in expr.keywords):
            return None
        return {kw.arg for kw in expr.keywords}
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    return None


def _rule_prom_family(tree: ast.AST, relpath: str) -> List[Finding]:
    if relpath != "serving/metrics.py":
        return []
    families = _literal_families(tree)
    if families is None:
        return [Finding(
            "prom-family", "error", f"{relpath}:1",
            "no literal FAMILIES registry found — every family this "
            "module emits must be declared in one dict")]
    out: List[Finding] = []
    emitted: Set[str] = set()
    # per-function env of `name = {literal dict}` assignments so that
    # e.g. `rl = {"replica": ...}; p.gauge(..., rl)` resolves
    env: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Dict):
            keys = _label_keys(node.value, {})
            if keys is not None:
                env[node.targets[0].id] = keys
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute) and
                node.func.attr in _LABELS_ARG_INDEX):
            continue
        if not (node.args and isinstance(node.args[0], ast.Constant) and
                isinstance(node.args[0].value, str) and
                node.args[0].value.startswith("dl4j")):
            continue
        name, mtype = node.args[0].value, node.func.attr
        emitted.add(name)
        decl = families.get(name)
        if decl is None:
            out.append(Finding(
                "prom-family", "error", _loc(relpath, node),
                f"family {name} emitted but not declared in FAMILIES"))
            continue
        decl_type, decl_labels = decl
        if decl_type != mtype:
            out.append(Finding(
                "prom-family", "error", _loc(relpath, node),
                f"family {name} emitted as {mtype} but declared "
                f"{decl_type}"))
        idx = _LABELS_ARG_INDEX[mtype]
        expr = node.args[idx] if len(node.args) > idx else next(
            (kw.value for kw in node.keywords if kw.arg == "labels"), None)
        keys = _label_keys(expr, env)
        if keys is None:
            out.append(Finding(
                "prom-family", "warn", _loc(relpath, node),
                f"family {name}: label keys not statically resolvable"))
            continue
        declared = set(decl_labels)
        # implicit keys are allowed as EXTRAS; a declared key is still
        # required even if it happens to be an implicit name (the
        # router's own per-replica families declare `replica` outright)
        own = keys - (_IMPLICIT_LABELS - declared)
        if own != declared:
            out.append(Finding(
                "prom-family", "error", _loc(relpath, node),
                f"family {name} emitted with labels {sorted(own)} but "
                f"declared {sorted(declared)}"))
    for name in sorted(set(families) - emitted):
        out.append(Finding(
            "prom-family", "error", f"{relpath}:1",
            f"family {name} declared in FAMILIES but never emitted"))
    return out


# -- lock rules --------------------------------------------------------------

def _lock_name(cls: Optional[str], chain: str) -> str:
    """Graph node for a lock expression: class-qualify self.X so two
    classes' `self._lock` stay distinct nodes."""
    if chain.startswith("self.") and cls:
        return f"{cls}.{chain[5:]}"
    return chain


def _collect_lock_edges(tree: ast.AST, relpath: str):
    """(held, acquired, location) for every syntactic `with a: with b:`
    nesting of lock-looking context managers."""
    edges = []

    def visit(node, cls, held):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name, held)
                continue
            acquired = []
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    chain = _attr_chain(item.context_expr)
                    if chain and _LOCKY_RE.search(chain.split(".")[-1]):
                        lock = _lock_name(cls, chain)
                        for h in held:
                            if h != lock:
                                edges.append(
                                    (h, lock, _loc(relpath, child)))
                        acquired.append(lock)
            visit(child, cls, held + acquired)

    visit(tree, None, [])
    return edges


def _find_lock_cycle(edges) -> Optional[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b, _ in edges:
        graph.setdefault(a, set()).add(b)
    state: Dict[str, int] = {}  # 1 = on stack, 2 = done
    path: List[str] = []

    def dfs(n) -> Optional[List[str]]:
        state[n] = 1
        path.append(n)
        for m in sorted(graph.get(n, ())):
            if state.get(m) == 1:
                return path[path.index(m):] + [m]
            if state.get(m, 0) == 0:
                cyc = dfs(m)
                if cyc:
                    return cyc
        path.pop()
        state[n] = 2
        return None

    for n in sorted(graph):
        if state.get(n, 0) == 0:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def _rule_lock_cycle(edges) -> List[Finding]:
    cyc = _find_lock_cycle(edges)
    if not cyc:
        return []
    loc = next((l for a, b, l in edges
                if a == cyc[0] and b == cyc[1]), "<package>")
    return [Finding(
        "lock-order-cycle", "error", loc,
        "lock acquisition order forms a cycle: " + " -> ".join(cyc))]


def _rule_unguarded_writes(tree: ast.AST, relpath: str) -> List[Finding]:
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        init = next((m for m in cls.body
                     if isinstance(m, ast.FunctionDef) and
                     m.name == "__init__"), None)
        if init is None:
            continue
        shared: Set[str] = set()
        has_lock = False
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self" and \
                            t.attr.startswith("_"):
                        if _LOCKY_RE.search(t.attr):
                            has_lock = True
                        else:
                            shared.add(t.attr)
        if not has_lock or not shared:
            continue
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef):
                continue
            if meth.name == "__init__" or meth.name.endswith("_locked") \
                    or meth.name.startswith("__"):
                continue
            out.extend(_unguarded_in(meth, shared, relpath))
    return out


def _unguarded_in(meth: ast.FunctionDef, shared: Set[str],
                  relpath: str) -> List[Finding]:
    out = []

    def visit(node, guarded):
        for child in ast.iter_child_nodes(node):
            g = guarded
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    chain = _attr_chain(item.context_expr)
                    if chain and _LOCKY_RE.search(chain.split(".")[-1]):
                        g = True
            if isinstance(child, (ast.Assign, ast.AugAssign)) and not g:
                targets = child.targets if isinstance(child, ast.Assign) \
                    else [child.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self" and t.attr in shared:
                        out.append(Finding(
                            "unguarded-shared-write", "warn",
                            _loc(relpath, child),
                            f"self.{t.attr} written in {meth.name}() "
                            f"outside the lock — guard it, rename the "
                            f"method *_locked, or waive with a comment"))
            # nested function defs get fresh threads; keep the flag
            visit(child, g)

    visit(meth, False)
    return out


# -- entry points ------------------------------------------------------------

def _documented_points() -> Dict[str, str]:
    from deeplearning4j_tpu_torch.reliability import faults
    return dict(faults.DOCUMENTED_POINTS)


def lint_source(src: str, relpath: str = "<memory>",
                documented_points: Optional[Dict[str, str]] = None,
                ) -> List[Finding]:
    """Run every per-module rule over one module's source text.
    `relpath` is the package-relative posix path — it selects which
    scoped rules apply (see the scope constants above)."""
    tree = ast.parse(src)
    documented = (_documented_points() if documented_points is None
                  else documented_points)
    findings: List[Finding] = []
    findings += _rule_platform_sniff(tree, relpath)
    findings += _rule_hardcoded_tunable(tree, relpath)
    findings += _rule_wall_clock(tree, relpath)
    findings += _rule_unbounded_network_call(tree, relpath)
    findings += _rule_f64(tree, relpath)
    findings += _rule_fault_point(tree, relpath, documented)
    findings += _rule_prom_family(tree, relpath)
    findings += _rule_lock_cycle(_collect_lock_edges(tree, relpath))
    findings += _rule_unguarded_writes(tree, relpath)
    waived = _waivers(src)
    return [f for f in findings
            if f.rule not in waived.get(_line_of(f), set())]


def _line_of(f: Finding) -> int:
    try:
        return int(f.location.rsplit(":", 1)[1])
    except (IndexError, ValueError):
        return 0


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    relpath = os.path.relpath(path, root).replace(os.sep, "/") \
        if root else os.path.basename(path)
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    return lint_source(src, relpath)


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_package(root: Optional[str] = None) -> Tuple[List[Finding], int]:
    """Lint every module under the package root; additionally run the
    whole-package checks (documented-but-unfired fault points, global
    lock-order cycles).  Returns (findings, files linted)."""
    root = root or package_root()
    documented = _documented_points()
    findings: List[Finding] = []
    all_edges = []
    fired: Set[str] = set()
    n_files = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            relpath = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
            try:
                tree = ast.parse(src)
            except SyntaxError as e:
                findings.append(Finding(
                    "parse-error", "error", f"{relpath}:{e.lineno or 0}",
                    f"module does not parse: {e.msg}"))
                continue
            n_files += 1
            findings += lint_source(src, relpath,
                                    documented_points=documented)
            all_edges += _collect_lock_edges(tree, relpath)
            if relpath != "reliability/faults.py":
                fired |= {p for p, _ in _fire_sites(tree, relpath)
                          if p is not None}
    for point in sorted(set(documented) - fired):
        findings.append(Finding(
            "fault-point", "error", "reliability/faults.py:1",
            f"fault point {point!r} documented in DOCUMENTED_POINTS but "
            f"no product code fires it"))
    findings += _rule_lock_cycle(all_edges)
    return findings, n_files
