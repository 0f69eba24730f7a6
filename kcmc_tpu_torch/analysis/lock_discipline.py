"""Pass 3 - lock/thread discipline (`lock-order`, `daemon-cuda`); the
port's copy of kcmc_tpu/analysis/lock_discipline.py.

The streaming pipeline, the writers, the serving scheduler, the fleet
and the plan runtime together hold dozens of `threading` sites whose
contracts live in comments. Two of them are machine-checkable here:

* **lock-order** - per class, build the lock-acquisition graph: an
  edge a->b when a `with self._b:` executes (directly, or via a
  `self.m()` call) inside a `with self._a:` body. A cycle is a
  deadlock waiting for the right interleaving. `threading.Condition(
  self._lock)` aliases to the underlying lock (waiting on `_wake`
  IS holding `_lock`), and self-edges are ignored (RLock reentrancy
  is this package's documented pattern).

* **daemon-cuda** - a daemon thread is killed where it stands at
  interpreter exit: in the middle of an nvcc build (a half-written
  kernel library in the build directory) or of a launch or copy on
  the card (CUDA teardown under a live stream aborts the process).
  So threads whose targets reach a kernel build or card work must be
  non-daemon (and joined on stop). The JAX package's rule of the same
  shape is `daemon-xla`, which names jax compile/dispatch.

The AST-local `shared-write` warning this pass used to carry in the
JAX package is superseded by the whole-program `race` pass
(`concurrency.py`), which does the same reasoning cross-module with
real lock sets and happens-before propagation; the per-class
acquisition machinery here (`_ClassModel`) stays because the
order/daemon rules and the runtime sanitizer's static-graph merge
build on it.
"""

from __future__ import annotations

import ast

from kcmc_tpu_torch.analysis.core import (
    Finding,
    FunctionTable,
    Module,
    ModuleIndex,
    attr_chain,
)

LOCK_CTORS = ("threading.Lock", "threading.RLock")
CONDITION_CTOR = "threading.Condition"
THREAD_CTOR = "threading.Thread"

# Call names (bare or trailing attribute) that indicate the callee
# builds a kernel library or does work on the card: the backend's entry
# points (backends/torch_backend.py), the corrector's warm-up, and the
# stream sync. Deliberately generous: reaching ANY of these from a
# daemon thread is worth a look.
CUDA_REACHING_NAMES = frozenset(
    {
        "TorchBackend",
        "process_batch",
        "process_batch_async",
        "stage_upload",
        "to_host",
        "prepare_reference",
        "update_reference",
        "apply_transforms",
        "warmup",
        "synchronize",
    }
)
# The kernel build (ops/cuda_build.py), by its module-qualified call:
# a bare `build`/`load` is far too common a name to mean nvcc.
CUDA_REACHING_CHAINS = ("cuda_build.build", "cuda_build.load")
CUDA_CHAIN_PREFIX = "torch.cuda."


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a `self._x` attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _ClassModel:
    """Locks, lock aliases, with-nesting, writes, and threads of one
    class."""

    def __init__(self, mod: Module, cls: ast.ClassDef, table: FunctionTable):
        self.mod = mod
        self.cls = cls
        self.methods = table.methods.get(cls.name, {})
        self.locks: dict[str, int] = {}  # attr -> def line
        self.alias: dict[str, str] = {}  # condition attr -> lock attr
        self._find_locks()
        # method -> ordered list of (lock attr, line, body node)
        self.acquires: dict[str, list[tuple[str, ast.With, str]]] = {
            m: self._withs(fn) for m, fn in self.methods.items()
        }
        self.lock_closure: dict[str, set[str]] = {}
        for m in self.methods:
            self.lock_closure[m] = self._closure(m, set())

    def _find_locks(self) -> None:
        for fn in self.methods.values():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                chain = (
                    attr_chain(node.value.func)
                    if isinstance(node.value, ast.Call)
                    else ""
                )
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if chain in LOCK_CTORS:
                        self.locks[attr] = node.lineno
                    elif chain == CONDITION_CTOR:
                        call = node.value
                        inner = (
                            _self_attr(call.args[0]) if call.args else None
                        )
                        if inner is not None:
                            self.alias[attr] = inner
                        else:
                            # Condition() owns a fresh lock — treat the
                            # condition attr itself as a lock.
                            self.locks[attr] = node.lineno

    def canon(self, attr: str) -> str:
        seen = set()
        while attr in self.alias and attr not in seen:
            seen.add(attr)
            attr = self.alias[attr]
        return attr

    def is_lock(self, attr: str | None) -> bool:
        if attr is None:
            return False
        c = self.canon(attr)
        return c in self.locks or attr in self.alias

    def _withs(self, fn: ast.FunctionDef) -> list:
        """All `with self._lock:` acquisitions in a method."""
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if self.is_lock(attr):
                    out.append((self.canon(attr), node, fn.name))
        return out

    def _closure(self, method: str, seen: set) -> set[str]:
        """Locks a call to `method` may acquire (transitively through
        self-calls)."""
        if method in seen:
            return set()
        seen.add(method)
        fn = self.methods.get(method)
        if fn is None:
            return set()
        locks = {a for a, _w, _m in self.acquires.get(method, [])}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee in self.methods:
                    locks |= self._closure(callee, seen)
        return locks

    # -- lock-order edges --------------------------------------------------

    def order_edges(self) -> dict[tuple[str, str], tuple[int, str]]:
        """{(outer, inner): (line, via)} across all methods."""
        edges: dict[tuple[str, str], tuple[int, str]] = {}
        for m, _fn in self.methods.items():
            for outer, with_node, _m in self.acquires.get(m, []):
                for node in ast.walk(with_node):
                    if node is with_node:
                        continue
                    if isinstance(node, ast.With):
                        for item in node.items:
                            attr = _self_attr(item.context_expr)
                            if self.is_lock(attr):
                                inner = self.canon(attr)
                                if inner != outer:
                                    edges.setdefault(
                                        (outer, inner),
                                        (node.lineno, m),
                                    )
                    elif isinstance(node, ast.Call):
                        callee = _self_attr(node.func)
                        if callee in self.methods:
                            for inner in self.lock_closure.get(
                                callee, set()
                            ):
                                if inner != outer:
                                    edges.setdefault(
                                        (outer, inner),
                                        (
                                            node.lineno,
                                            f"{m} -> self.{callee}()",
                                        ),
                                    )
        return edges

    # -- threads -----------------------------------------------------------

    def threads(self) -> list[dict]:
        """Every `threading.Thread(...)` constructed in this class."""
        out = []
        for m, fn in self.methods.items():
            for node in ast.walk(fn):
                if (
                    not isinstance(node, ast.Call)
                    or attr_chain(node.func) != THREAD_CTOR
                ):
                    continue
                info = {
                    "method": m,
                    "line": node.lineno,
                    "daemon": False,
                    "target": None,
                    "name": None,
                }
                for kw in node.keywords:
                    if kw.arg == "daemon" and isinstance(
                        kw.value, ast.Constant
                    ):
                        info["daemon"] = bool(kw.value.value)
                    elif kw.arg == "target":
                        t = _self_attr(kw.value)
                        if t is not None:
                            info["target"] = ("self", t)
                        elif isinstance(kw.value, ast.Name):
                            info["target"] = ("module", kw.value.id)
                    elif kw.arg == "name" and isinstance(
                        kw.value, ast.Constant
                    ):
                        info["name"] = kw.value.value
                out.append(info)
        return out


def _cycles(edges: dict[tuple[str, str], tuple[int, str]]) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles, done = [], set()

    def dfs(node, path, on_path):
        if node in on_path:
            cycles.append(path[path.index(node):] + [node])
            return
        if node in done:
            return
        on_path.add(node)
        for nxt in sorted(graph.get(node, ())):
            dfs(nxt, path + [node], on_path)
        on_path.discard(node)
        done.add(node)

    for start in sorted(graph):
        dfs(start, [], set())
    # de-dup rotations
    uniq, seen = [], set()
    for c in cycles:
        key = frozenset(c)
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    return uniq


def _reaches_cuda(
    table: FunctionTable,
    cls: str | None,
    fn: ast.FunctionDef,
    _seen: set | None = None,
) -> str | None:
    """First kernel-build or card-reaching call name found in `fn`'s
    local closure."""
    seen = _seen if _seen is not None else set()
    if id(fn) in seen:
        return None
    seen.add(id(fn))
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        last = chain.rsplit(".", 1)[-1]
        if (
            last in CUDA_REACHING_NAMES
            or chain.startswith(CUDA_CHAIN_PREFIX)
            or any(
                chain == c or chain.endswith("." + c)
                for c in CUDA_REACHING_CHAINS
            )
        ):
            return chain
        target = None
        if chain.startswith("self.") and cls is not None:
            target = table.methods.get(cls, {}).get(last)
        elif "." not in chain:
            cands = table.functions.get(chain)
            target = cands[0] if cands else None
        if target is not None:
            hit = _reaches_cuda(table, cls, target, seen)
            if hit is not None:
                return hit
    return None


def _daemon_finding(path: str, line: int, label: str, hit: str) -> Finding:
    return Finding(
        rule="daemon-cuda",
        path=path,
        line=line,
        severity="error",
        message=(
            f"daemon thread '{label}' reaches a kernel build or card "
            f"work via {hit}"
        ),
        detail=(
            "a daemon thread is killed at interpreter exit in the middle "
            "of an nvcc build or a launch; make it non-daemon and join "
            "it on stop"
        ),
    )


class LockDisciplinePass:
    name = "lock-discipline"
    # Per-class models over one module's AST: module-scoped for the
    # check cache (analysis/cache.py).
    cache_scope = "module"

    def run(self, index: ModuleIndex) -> list[Finding]:
        out: list[Finding] = []
        for mod in index:
            table = FunctionTable(mod.tree)
            class_nodes: set[int] = set()
            for cls in table.classes.values():
                class_nodes.update(id(n) for n in ast.walk(cls))
                model = _ClassModel(mod, cls, table)
                out.extend(self._check_order(mod, cls, model))
                out.extend(
                    self._check_threads(mod, cls, model, table)
                )
            out.extend(
                self._check_module_threads(mod, table, class_nodes)
            )
        return out

    def _check_module_threads(
        self, mod, table, class_nodes: set[int]
    ) -> list[Finding]:
        """daemon-cuda for threads constructed OUTSIDE any class (module
        functions, scripts): target resolves by bare name only."""
        out = []
        for node in ast.walk(mod.tree):
            if (
                id(node) in class_nodes
                or not isinstance(node, ast.Call)
                or attr_chain(node.func) != THREAD_CTOR
            ):
                continue
            daemon, target, label = False, None, None
            for kw in node.keywords:
                if kw.arg == "daemon" and isinstance(
                    kw.value, ast.Constant
                ):
                    daemon = bool(kw.value.value)
                elif kw.arg == "target" and isinstance(
                    kw.value, ast.Name
                ):
                    target = kw.value.id
                elif kw.arg == "name" and isinstance(
                    kw.value, ast.Constant
                ):
                    label = kw.value.value
            if not daemon or target is None:
                continue
            fn = (table.functions.get(target) or [None])[0]
            if fn is None:
                continue
            hit = _reaches_cuda(table, None, fn)
            if hit is not None:
                out.append(
                    _daemon_finding(
                        mod.path, node.lineno, label or target, hit
                    )
                )
        return out

    # -- lock-order --------------------------------------------------------

    def _check_order(self, mod, cls, model) -> list[Finding]:
        out = []
        edges = model.order_edges()
        for cycle in _cycles(edges):
            pretty = " -> ".join(cycle)
            first = min(
                (
                    edges[(a, b)]
                    for a, b in zip(cycle, cycle[1:])
                    if (a, b) in edges
                ),
                default=(cls.lineno, "?"),
            )
            out.append(
                Finding(
                    rule="lock-order",
                    path=mod.path,
                    line=first[0],
                    severity="error",
                    message=(
                        f"lock acquisition cycle in {cls.name}: "
                        f"{pretty}"
                    ),
                    detail=f"first edge via {first[1]}",
                )
            )
        return out

    # -- threads: daemon CUDA ----------------------------------------------

    def _check_threads(self, mod, cls, model, table) -> list[Finding]:
        out = []
        threads = model.threads()
        if not threads:
            return out

        # daemon-cuda rule
        for t in threads:
            if not t["daemon"] or t["target"] is None:
                continue
            kind, name = t["target"]
            fn = (
                model.methods.get(name)
                if kind == "self"
                else (table.functions.get(name) or [None])[0]
            )
            if fn is None:
                continue
            hit = _reaches_cuda(
                table, cls.name if kind == "self" else None, fn
            )
            if hit is not None:
                out.append(
                    _daemon_finding(
                        mod.path, t["line"], t["name"] or name, hit
                    )
                )

        return out
