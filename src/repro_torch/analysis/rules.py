"""Layer-1 AST rules (RL001–RL005) over the port's source tree — the
counterpart of ``repro/analysis/rules.py``.

Each rule is a class with a stable ``id``, a one-line ``title``, and a
``run(ctx)`` returning :class:`~repro_torch.analysis.findings.Finding`s.
The engine is the reference's: it parses every ``.py`` file once and hands
rules a shared :class:`RepoContext`; cross-file rules (metric families,
trace schema, launcher flags) locate their declaration sites *within the
scanned tree*, so the fixture tests can run the same rules over a
self-contained temporary mini-repo.

The reference's RL001/RL002 look at functions passed to ``jax.jit`` or
``shard_map``; the port has none.  Its counterpart of a jitted program is
a body captured as a CUDA graph (``serving/engine.capture_graph``), so
RL001 (capture purity) and RL002 (branches frozen at capture) look at every
function passed to ``capture_graph``, plus what is lexically nested in it,
plus the methods of the same class that it calls as ``self.<method>(...)``
(the Server's captured body is a method whose work is another method).  A
captured body replays only its device work: a host read, clock, print or
host copy in it runs once, at capture, and its value is frozen into the
graph.  Calls into other modules (``lm.decode_step``) are not chased, as
in the reference; Layer 2 (:mod:`repro_torch.analysis.audit`) covers them
on the captured graph itself.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.findings import Finding

# ---------------------------------------------------------------------------
# parsing infrastructure (the reference's)


@dataclass
class ParsedFile:
    path: str  # relative to the report root, posix
    source: str
    tree: ast.Module

    # local name -> imported module dotted path ("np" -> "numpy")
    module_aliases: dict = field(default_factory=dict)
    # local name -> (module, original attr) for from-imports
    from_aliases: dict = field(default_factory=dict)

    def resolve(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.module_aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.from_aliases[a.asname or a.name] = (node.module or "", a.name)


@dataclass
class RepoContext:
    root: Path
    files: list  # list[ParsedFile] under the scan root (findings scope)
    extra_sources: dict = field(default_factory=dict)  # name -> raw text (read-only aides)


def parse_tree(root: Path, extra_paths=(), rel_to: Path | None = None) -> RepoContext:
    """Parse every .py under ``root`` (recursively) into a RepoContext; a
    file's path is relative to ``rel_to`` (default ``root``)."""
    base = Path(rel_to) if rel_to is not None else root
    files = []
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        src = p.read_text()
        try:
            tree = ast.parse(src, filename=str(p))
        except SyntaxError:
            continue  # fixtures may hold intentionally-broken snippets
        pf = ParsedFile(path=p.relative_to(base).as_posix(), source=src, tree=tree)
        pf.resolve()
        files.append(pf)
    extras = {}
    for ep in extra_paths:
        ep = Path(ep)
        if ep.exists():
            extras[ep.name] = ep.read_text()
    return RepoContext(root=root, files=files, extra_sources=extras)


def dotted(node) -> str | None:
    """Render a Name/Attribute chain as 'a.b.c', else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _self_attr(node) -> str | None:
    """``name`` for a ``self.name`` expression, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


# ---------------------------------------------------------------------------
# capture-site discovery (shared by RL001 / RL002)

_CAPTURE_NAME = "capture_graph"
_PARTIAL_NAMES = {"partial", "functools.partial"}
_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class CaptureSite:
    fn: object  # ast.FunctionDef | ast.Lambda: the function passed to capture_graph
    name: str  # display/symbol name ("body", "Server._decode_body")
    # the methods of the same class reached by self.<method>(...) calls,
    # transitively: [(qualified name, ast.FunctionDef)]
    chased: list = field(default_factory=list)
    # names of self attributes the class binds to tensors
    tensor_attrs: set = field(default_factory=set)
    # local names bound to tensors in the body and the function around it
    tensor_names: set = field(default_factory=set)

    def scopes(self):
        """(symbol, function node) for the body and every chased method."""
        return [(self.name, self.fn)] + list(self.chased)


def _parents(tree) -> dict:
    out = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _enclosing(node, parents, kinds):
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, kinds):
        cur = parents.get(cur)
    return cur


def _outermost_def(node, parents):
    """The outermost function def around ``node`` inside its class or module
    (``node`` itself when it is one and nothing encloses it)."""
    best = node if isinstance(node, _FUNC_DEFS) else None
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, (ast.ClassDef, ast.Module)):
        if isinstance(cur, _FUNC_DEFS):
            best = cur
        cur = parents.get(cur)
    return best


def _methods(cls) -> dict:
    return {n.name: n for n in cls.body if isinstance(n, _FUNC_DEFS)} if cls else {}


def _defs_by_name(tree: ast.Module) -> dict:
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, _FUNC_DEFS):
            out.setdefault(node.name, []).append(node)
    return out


# torch calls whose result is no tensor (predicates, device and dtype objects)
_TORCH_NOT_TENSOR = ("torch.is_", "torch.cuda.", "torch.finfo", "torch.iinfo",
                     "torch.device", "torch.dtype", "torch.Size", "torch.Generator",
                     "torch.get_", "torch.backends.")
# attributes that are static under capture (a tensor's metadata)
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout", "size", "dim",
                 "numel", "stride", "element_size", "data_ptr", "is_contiguous"}


def _torch_call(pf: ParsedFile, call) -> str | None:
    """The call's callee as ``torch.<...>`` when it names a torch function
    (through the file's import aliases), else None."""
    name = dotted(call.func) if isinstance(call, ast.Call) else None
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in pf.from_aliases:
        mod, attr = pf.from_aliases[head]
        name = ".".join(p for p in (mod, attr, rest) if p)
    elif head in pf.module_aliases:
        name = ".".join(p for p in (pf.module_aliases[head], rest) if p)
    return name if name == "torch" or name.startswith("torch.") else None


def _tensorish(pf, node, names: set, attrs: set) -> bool:
    """Whether an expression evaluates to a tensor, as far as the source
    shows: a torch call, a tensor's method call, a known tensor name or
    ``self`` attribute, or arithmetic and indexing on one.  A tensor's
    metadata (shape, dtype, device, ...) is not a tensor: it is static
    under capture."""
    if isinstance(node, ast.Call):
        torch_name = _torch_call(pf, node)
        if torch_name is not None:
            return not torch_name.startswith(_TORCH_NOT_TENSOR)
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr not in _STATIC_ATTRS:
            return _tensorish(pf, fn.value, names, attrs)
        return False
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        attr = _self_attr(node)
        return attr is not None and attr in attrs
    if isinstance(node, ast.Subscript):
        return _tensorish(pf, node.value, names, attrs)
    if isinstance(node, ast.BinOp):
        return (_tensorish(pf, node.left, names, attrs)
                or _tensorish(pf, node.right, names, attrs))
    if isinstance(node, ast.UnaryOp):
        return _tensorish(pf, node.operand, names, attrs)
    return False


def _assigned(node):
    """(target, value) pairs of the assignments under ``node``; a tuple
    target takes a tuple value element-wise, or the whole value each."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign):
            pairs = [(t, sub.value) for t in sub.targets]
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)) and sub.value is not None:
            pairs = [(sub.target, sub.value)]
        else:
            continue
        for target, value in pairs:
            if isinstance(target, (ast.Tuple, ast.List)):
                if isinstance(value, (ast.Tuple, ast.List)) \
                        and len(value.elts) == len(target.elts):
                    yield from zip(target.elts, value.elts)
                # a call's tuple result: its elements are not known
            else:
                yield target, value


def _tensor_attrs(pf, cls) -> set:
    """``self`` attributes the class binds to tensors anywhere in its
    methods (``self.tok = torch.zeros(...)``)."""
    attrs: set = set()
    if cls is None:
        return attrs
    for _ in range(2):   # an attribute bound from another one
        for target, value in _assigned(cls):
            attr = _self_attr(target)
            if attr is not None and _tensorish(pf, value, set(), attrs):
                attrs.add(attr)
    return attrs


def _tensor_names(pf, scope, attrs) -> set:
    """Local names bound to tensors inside ``scope``."""
    names: set = set()
    if scope is None:
        return names
    for _ in range(2):
        for target, value in _assigned(scope):
            if isinstance(target, ast.Name) and _tensorish(pf, value, names, attrs):
                names.add(target.id)
    return names


def _chase(site_fn, methods: dict, cls_name: str) -> list:
    """The methods of the class reached from ``site_fn`` by
    ``self.<method>(...)`` calls, transitively."""
    seen, order, todo = set(), [], [site_fn]
    while todo:
        fn = todo.pop()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _self_attr(node.func)
            if name in methods and name not in seen and methods[name] is not site_fn:
                seen.add(name)
                order.append((f"{cls_name}.{name}", methods[name]))
                todo.append(methods[name])
    return order


def collect_capture_sites(pf: ParsedFile) -> list:
    """Every function object handed to ``capture_graph`` in a file: a name
    (a def of that name in the file), a lambda, ``self.<method>`` (the
    method of the class around the call) or ``functools.partial`` of one."""
    sites: list = []
    defs = _defs_by_name(pf.tree)
    parents = _parents(pf.tree)
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        callee = dotted(node.func)
        if callee is None or callee.split(".")[-1] != _CAPTURE_NAME:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Call) and dotted(arg.func) in _PARTIAL_NAMES and arg.args:
            arg = arg.args[0]
        cls = _enclosing(node, parents, ast.ClassDef)
        methods = _methods(cls)
        targets = []
        if isinstance(arg, ast.Lambda):
            targets.append(("<lambda>", arg))
        elif isinstance(arg, ast.Name):
            targets += [(fn.name, fn) for fn in defs.get(arg.id, [])]
        elif _self_attr(arg) in methods:
            targets.append((f"{cls.name}.{arg.attr}", methods[arg.attr]))
        for name, fn in targets:
            # a closure's self is the instance of the class around it
            owner = _enclosing(fn, parents, ast.ClassDef)
            owner_methods = _methods(owner)
            attrs = _tensor_attrs(pf, owner)
            site = CaptureSite(fn=fn, name=name, tensor_attrs=attrs,
                               chased=_chase(fn, owner_methods, owner.name) if owner else [])
            site.tensor_names = _tensor_names(pf, _outermost_def(fn, parents) or fn, attrs)
            for _, m in site.chased:
                site.tensor_names |= _tensor_names(pf, m, attrs)
            sites.append(site)
    # dedupe (a body may be captured at several calls)
    seen, uniq = set(), []
    for s in sites:
        if id(s.fn) not in seen:
            seen.add(id(s.fn))
            uniq.append(s)
    return uniq


def _via(site: CaptureSite, symbol: str) -> str:
    return (f"captured body '{site.name}'" if symbol == site.name
            else f"'{symbol}' (called from the captured body '{site.name}')")


# ---------------------------------------------------------------------------
# RL001 — capture purity


class CapturePurityRule:
    """No host-side work inside a body captured as a CUDA graph."""

    id = "RL001"
    title = "host-side call inside a body captured as a CUDA graph"

    _SYNC_CALLS = {"item", "cpu", "tolist", "numpy", "synchronize"}
    _TEL_METHODS = {"inc", "set_gauge", "observe", "span", "event"}
    _HOST_COPIES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
    _TIME_FNS = {"time", "perf_counter", "monotonic", "process_time", "time_ns",
                 "perf_counter_ns", "monotonic_ns"}

    def run(self, ctx: RepoContext):
        findings, seen = [], set()
        for pf in ctx.files:
            np_aliases = {n for n, mod in pf.module_aliases.items() if mod == "numpy"}
            time_aliases = {n for n, mod in pf.module_aliases.items() if mod == "time"}
            time_froms = {n for n, (mod, attr) in pf.from_aliases.items()
                          if mod == "time" and attr in self._TIME_FNS}
            for site in collect_capture_sites(pf):
                for symbol, fn in site.scopes():
                    for node in ast.walk(fn):
                        if not isinstance(node, ast.Call):
                            continue
                        msg = self._check_call(pf, node, np_aliases, time_aliases, time_froms)
                        key = (pf.path, node.lineno, symbol, msg)
                        if msg and key not in seen:
                            seen.add(key)
                            findings.append(Finding(
                                rule=self.id, path=pf.path, line=node.lineno, symbol=symbol,
                                message=f"{msg} inside the {_via(site, symbol)} — it runs "
                                        "once, at capture, and the graph replays its "
                                        "result (see docs/analysis_torch.md#rl001)"))
        return findings

    def _check_call(self, pf, node, np_aliases, time_aliases, time_froms):
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id == "print":
                return "print() call"
            if fn.id in time_froms:
                return f"wall-clock read '{fn.id}()'"
        torch_name = _torch_call(pf, node)
        if torch_name == "torch.cuda.synchronize":
            return "host sync 'torch.cuda.synchronize()'"
        if torch_name in self._HOST_COPIES:
            return f"host copy '{torch_name}(...)' (a value baked in at capture)"
        if isinstance(fn, ast.Attribute):
            root = fn.value
            if isinstance(root, ast.Name):
                if root.id in time_aliases and fn.attr in self._TIME_FNS:
                    return f"wall-clock read '{root.id}.{fn.attr}()'"
                if root.id in np_aliases:
                    return f"host numpy call '{root.id}.{fn.attr}()'"
            if fn.attr in self._SYNC_CALLS:
                return f"device sync '.{fn.attr}()'"
            if fn.attr == "to" and self._to_cpu(node):
                return "device sync '.to(\"cpu\")'"
            if fn.attr in self._TEL_METHODS:
                return f"telemetry record '.{fn.attr}(...)'"
        return None

    @staticmethod
    def _to_cpu(node) -> bool:
        vals = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
        for v in vals:
            if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                    and v.value.split(":")[0] == "cpu":
                return True
            if (isinstance(v, ast.Call) and dotted(v.func) in ("torch.device", "device")
                    and v.args and isinstance(v.args[0], ast.Constant)
                    and v.args[0].value == "cpu"):
                return True
        return False


# ---------------------------------------------------------------------------
# RL002 — branches frozen at capture


class CapturedBranchRule:
    """Python if/while on a tensor inside a captured body."""

    id = "RL002"
    title = "Python control flow on a tensor inside a captured body"

    # tensor methods whose result a branch would read on the host
    _VALUE_METHODS = {"any", "all", "item", "sum", "max", "min", "mean", "equal", "allclose",
                      "isnan", "isinf", "isfinite", "nonzero", "count_nonzero", "tolist",
                      "eq", "ne", "gt", "lt", "ge", "le", "argmax", "argmin", "is_nonzero"}
    _CASTS = {"bool", "int", "float"}

    def run(self, ctx: RepoContext):
        findings = []
        for pf in ctx.files:
            for site in collect_capture_sites(pf):
                for symbol, fn in site.scopes():
                    for node in ast.walk(fn):
                        if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                            continue
                        why = self._reads_tensor(pf, node.test, site)
                        if why:
                            kw = "while" if isinstance(node, ast.While) else "if"
                            findings.append(Finding(
                                rule=self.id, path=pf.path, line=node.lineno, symbol=symbol,
                                message=f"Python '{kw}' on {why} inside the "
                                        f"{_via(site, symbol)} — decided once, at capture; "
                                        "use torch.where or a masked write"))
        return findings

    def _reads_tensor(self, pf, test, site) -> str | None:
        """What in a branch test reads a tensor, None-checks, isinstance and
        closure constants exempt."""
        if self._is_none_check(test) or self._is_isinstance(test):
            return None
        names, attrs = site.tensor_names, site.tensor_attrs
        exempt = set()
        for node in ast.walk(test):
            # a None-check, isinstance, or a tensor's metadata (static under
            # capture: x.shape[0], x.size(1), x.dtype)
            if self._is_isinstance(node) or self._is_none_check(node) or (
                    isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS):
                exempt.update(id(n) for n in ast.walk(node))
        for node in ast.walk(test):
            if id(node) in exempt:
                continue
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr in self._VALUE_METHODS:
                    return f"a tensor's value '.{fn.attr}()'"
                if isinstance(fn, ast.Name) and fn.id in self._CASTS and node.args \
                        and _tensorish(pf, node.args[0], names, attrs):
                    return f"'{fn.id}()' of a tensor"
                if _tensorish(pf, node, names, attrs):
                    return f"the tensor '{dotted(fn) or 'call'}(...)'"
            elif isinstance(node, (ast.Name, ast.Attribute)) \
                    and _tensorish(pf, node, names, attrs):
                return f"the tensor '{dotted(node)}'"
        return None

    @staticmethod
    def _is_none_check(test) -> bool:
        if isinstance(test, ast.BoolOp):
            return all(CapturedBranchRule._is_none_check(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return CapturedBranchRule._is_none_check(test.operand)
        return (isinstance(test, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
                and any(isinstance(c, ast.Constant) and c.value is None
                        for c in [test.left, *test.comparators]))

    @staticmethod
    def _is_isinstance(node) -> bool:
        return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance")


# ---------------------------------------------------------------------------
# RL003 — metric-family consistency (the reference's rule)


# Receivers that look like metric emits but are profiler-session wall-time
# observations (serving/profiler.py), not registry families.
_PROFILER_RECEIVERS = {"_prof", "prof", "session", "_session"}


class MetricFamilyRule:
    """Every emit names a declared family; every family has an emit site."""

    id = "RL003"
    title = "metric family not declared / declared but never emitted"

    _EMIT_METHODS = {"inc", "set_gauge", "observe", "counter", "gauge", "histogram"}

    def run(self, ctx: RepoContext):
        declared, decl_pf, decl_line = self._declared(ctx)
        if decl_pf is None:
            return []  # no METRIC_FAMILIES in tree — rule not applicable
        findings, emitted = [], {}
        for pf in ctx.files:
            for node in ast.walk(pf.tree):
                name = self._emit_name(node)
                if name is None:
                    continue
                emitted.setdefault(name, []).append((pf, node.lineno))
        for name, sites in sorted(emitted.items()):
            if name not in declared:
                pf, line = sites[0]
                findings.append(Finding(
                    rule=self.id, path=pf.path, line=line, symbol=name,
                    message=f"metric family '{name}' emitted but not declared "
                            "in METRIC_FAMILIES — declare it (single source "
                            "of truth) or rename the emit"))
        for name in sorted(declared - set(emitted)):
            findings.append(Finding(
                rule=self.id, path=decl_pf.path, line=decl_line.get(name, 1),
                symbol=name,
                message=f"metric family '{name}' declared in METRIC_FAMILIES "
                        "but never emitted anywhere in the scanned tree — dead "
                        "families are errors; delete it or wire the emit"))
        return findings

    def _declared(self, ctx):
        for pf in ctx.files:
            for node in ast.walk(pf.tree):
                if (isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == "METRIC_FAMILIES"
                                for t in node.targets)
                        and isinstance(node.value, ast.Dict)):
                    names, lines = set(), {}
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            names.add(k.value)
                            lines[k.value] = k.lineno
                    return names, pf, lines
        return set(), None, {}

    def _emit_name(self, node):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            return None
        if node.func.attr not in self._EMIT_METHODS:
            return None
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return None
        # profiler-session observe("decode_step", dt) is a wall-time probe
        # keyed by program name, not a registry family
        recv = node.func.value
        tail = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else None)
        if tail in _PROFILER_RECEIVERS:
            return None
        return node.args[0].value


# ---------------------------------------------------------------------------
# RL004 — trace-span/event schema consistency (the reference's rule)


class TraceSchemaRule:
    """Span/event names must match the v2 validator schema in trace.py."""

    id = "RL004"
    title = "trace span/event name outside the v2 schema"

    def run(self, ctx: RepoContext):
        spans, events, decl_pf, decl_lines = self._schema(ctx)
        if decl_pf is None:
            return []
        findings = []
        span_sites, event_sites = {}, {}
        for pf in ctx.files:
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                    if (node.args and isinstance(node.args[0], ast.Constant)
                            and isinstance(node.args[0].value, str)):
                        if node.func.attr == "span":
                            span_sites.setdefault(node.args[0].value, []).append(
                                (pf, node.lineno))
                        elif node.func.attr == "event":
                            event_sites.setdefault(node.args[0].value, []).append(
                                (pf, node.lineno))
                # literal record construction ({"name": "truncated", ...}) in
                # the schema-owning module counts as an emit site
                if pf is decl_pf and isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if (isinstance(k, ast.Constant) and k.value == "name"
                                and isinstance(v, ast.Constant)
                                and isinstance(v.value, str)):
                            event_sites.setdefault(v.value, []).append((pf, v.lineno))
                            span_sites.setdefault(v.value, []).append((pf, v.lineno))
        for name, sites in sorted(span_sites.items()):
            if name not in spans and sites[0][0] is not decl_pf:
                pf, line = sites[0]
                findings.append(Finding(
                    rule=self.id, path=pf.path, line=line, symbol=name,
                    message=f"span '{name}' emitted but absent from SPAN_NAMES "
                            "— the v2 trace validator will reject it"))
        for name, sites in sorted(event_sites.items()):
            if name not in events and sites[0][0] is not decl_pf:
                pf, line = sites[0]
                findings.append(Finding(
                    rule=self.id, path=pf.path, line=line, symbol=name,
                    message=f"event '{name}' emitted but absent from "
                            "EVENT_NAMES — the v2 trace validator will "
                            "reject it"))
        for name in sorted(spans - set(span_sites)):
            findings.append(Finding(
                rule=self.id, path=decl_pf.path, line=decl_lines.get(name, 1),
                symbol=name,
                message=f"SPAN_NAMES declares '{name}' but no .span() site "
                        "emits it — dead schema entries are errors"))
        for name in sorted(events - set(event_sites)):
            findings.append(Finding(
                rule=self.id, path=decl_pf.path, line=decl_lines.get(name, 1),
                symbol=name,
                message=f"EVENT_NAMES declares '{name}' but no .event() site "
                        "emits it — dead schema entries are errors"))
        return findings

    def _schema(self, ctx):
        spans, events, decl_pf, lines = set(), set(), None, {}
        for pf in ctx.files:
            found = False
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if t.id in ("SPAN_NAMES", "EVENT_NAMES"):
                        vals = self._set_values(node.value)
                        if vals is None:
                            continue
                        found = True
                        for name, line in vals:
                            lines[name] = line
                            (spans if t.id == "SPAN_NAMES" else events).add(name)
            if found:
                decl_pf = pf
                break
        return spans, events, decl_pf, lines

    @staticmethod
    def _set_values(node):
        if isinstance(node, ast.Set):
            elts = node.elts
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id in ("set", "frozenset") and node.args
              and isinstance(node.args[0], (ast.Set, ast.List, ast.Tuple))):
            elts = node.args[0].elts
        else:
            return None
        return [(e.value, e.lineno) for e in elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]


# ---------------------------------------------------------------------------
# RL005 — launcher-flag coverage (the reference's rule)

#: the launcher tests RL005 reads: the port's tests/test_torch_launch_serve.py
LAUNCH_TEST_PREFIX = "test_torch_launch"


class LauncherFlagRule:
    """Every argparse flag is exercised by validate_flags or the launch tests."""

    id = "RL005"
    title = "launcher flag covered by neither validate_flags nor tests"

    def run(self, ctx: RepoContext):
        findings = []
        for pf in ctx.files:
            flags = self._flags(pf)
            validate = self._find_def(pf, "validate_flags")
            if not flags or validate is None:
                continue
            covered = self._coverage(pf, validate)
            test_src = "\n".join(
                src for name, src in ctx.extra_sources.items()
                if name.startswith(LAUNCH_TEST_PREFIX))
            for dest, (flag, line) in sorted(flags.items()):
                if dest in covered or flag in covered:
                    continue
                if test_src and (flag in test_src or f'"{dest}"' in test_src):
                    continue
                findings.append(Finding(
                    rule=self.id, path=pf.path, line=line, symbol=dest,
                    message=f"flag '{flag}' is referenced by neither "
                            "validate_flags nor the test_torch_launch_serve "
                            "matrix — add a validation rule or a test row"))
        return findings

    def _flags(self, pf):
        out = {}
        for node in ast.walk(pf.tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith("--")):
                flag = node.args[0].value
                dest = flag.lstrip("-").replace("-", "_")
                for kw in node.keywords:
                    if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                        dest = kw.value.value
                out[dest] = (flag, node.lineno)
        return out

    @staticmethod
    def _find_def(pf, name):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return node
        return None

    def _coverage(self, pf, validate):
        covered, referenced_globals = set(), set()
        for node in ast.walk(validate):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                if node.value.id in ("args", "ns", "flags"):
                    covered.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                covered.add(node.value)
                covered.add(node.value.lstrip("-").replace("-", "_"))
            elif isinstance(node, ast.Name):
                referenced_globals.add(node.id)
        # module-level string collections read by validate_flags (e.g. the
        # _STATIC_ONLY / _CONTINUOUS_ONLY mode tables)
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id in referenced_globals
                        and isinstance(node.value, (ast.Tuple, ast.List, ast.Set))):
                    for e in node.value.elts:
                        if isinstance(e, ast.Constant) and isinstance(e.value, str):
                            covered.add(e.value)
                            covered.add(e.value.lstrip("-").replace("-", "_"))
        return covered


ALL_RULES = (CapturePurityRule(), CapturedBranchRule(), MetricFamilyRule(),
             TraceSchemaRule(), LauncherFlagRule())


def run_rules(scan_root: Path, extra_paths=(), rules=ALL_RULES, rel_to: Path | None = None):
    """Run rules over a tree; returns (findings, {path: source}).  Paths are
    relative to ``rel_to`` (default ``scan_root``)."""
    ctx = parse_tree(Path(scan_root), extra_paths=extra_paths, rel_to=rel_to)
    findings = []
    for rule in rules:
        findings.extend(rule.run(ctx))
    sources = {pf.path: pf.source for pf in ctx.files}
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, sources
