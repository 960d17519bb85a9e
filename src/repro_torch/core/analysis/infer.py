"""ProfileInfer: static recovery of a handler's storage-call sequence.

Walks the AST of a ``handler(event, ctx)`` function and abstractly
interprets it just enough to recover the *ordered* sequence of storage
calls (``get_object`` / ``get_object_streaming`` / ``put_object``)
issued through any local alias of ``ctx.storage`` — including calls in
loops whose trip count is statically known (``event["inputs"]``,
``event["outputs"]``, literal tuples, ``range(k)``, and ``enumerate`` /
``zip`` / ``reversed`` / ``sorted`` wrappers of those). The inferred
sequence is then checked against the workload's declared `IOProfile`.

The walker also diagnoses the patterns that break transparent
offloading (`PAPER.md` §Design: the backend prefetches, early-releases,
and write-backs *on the assumption that the declared profile is the
program*):

* conditional GET/PUT (`PC-COND-GET` / `PC-COND-PUT`) — the plan would
  speculate I/O the handler may never issue;
* I/O inside ``except``/recovery blocks (`PC-EXCEPT-IO`) and, as a
  warning, inside ``try`` bodies (`PC-TRY-IO`);
* loops of statically-unknown trip count around I/O (`PC-LOOP`);
* two PUTs whose (bucket, key) resolve to the same symbolic value
  (`PC-DUP-KEY`) — the runtime rejects duplicate durable writes;
* ``ctx``/storage references escaping into calls, containers, returns,
  or closures (`PC-ESCAPE`) — interception can no longer see the calls;
* unknown methods on the storage surface (`PC-METHOD`);
* declared GETs after the final compute segment (`PC-TRAILING-GET`,
  warning) — they drag the release barrier past the last compute.

Handlers whose source is unavailable (built in ``exec``/REPL) degrade
to a `PC-NO-SOURCE` warning rather than a failure.

A copy of ``repro.core.analysis.infer``, whole: `runtime.WorkerNode.deploy`
runs `check_workload` on every handler by default.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass, field

from repro_torch.core.frontend import S3_METHODS
from repro_torch.core.workloads import ComputeSegment, Get, IOProfile, Workload

from .diag import (
    PC_COND_GET,
    PC_COND_PUT,
    PC_DUP_KEY,
    PC_ESCAPE,
    PC_EXCEPT_IO,
    PC_LOOP,
    PC_METHOD,
    PC_NO_SOURCE,
    PC_SHAPE,
    PC_TRAILING_GET,
    PC_TRY_IO,
    Diagnostic,
    PlanCheckError,
)

# Abstract values are tagged tuples:
#   ("storage",)                 an alias of ctx.storage
#   ("ctx",)                     an alias of ctx
#   ("event",)                   an alias of event
#   ("method", name)             a bound storage method (s.get_object)
#   ("seq", count|None, base)    a sequence; count statically known or None
#   ("tuple", (v0, v1, ...))     a literal tuple/list of abstract values
#   ("sym", text)                anything else; text "?" means opaque
_STORAGE = ("storage",)
_CTX = ("ctx",)
_EVENT = ("event",)
_OPAQUE = ("sym", "?")

_GETS = ("get_object", "get_object_streaming")


def _is_carrier(val) -> bool:
    """Values that must not escape the handler's direct control."""
    return val[0] in ("storage", "ctx", "method")


@dataclass(frozen=True)
class InferredOp:
    """One statically-recovered storage call."""

    kind: str                   # 'get' | 'put'
    method: str                 # the surface method actually named
    line: int                   # 1-based line in the real source file
    bucket: str                 # symbolic bucket text ('?' if opaque)
    key: str                    # symbolic key text ('?' if opaque)
    in_try: bool = False


@dataclass
class InferenceResult:
    """Outcome of analyzing one handler."""

    handler_name: str
    source_file: str
    ops: list[InferredOp] = field(default_factory=list)
    diagnostics: list[Diagnostic] = field(default_factory=list)

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(op.kind for op in self.ops)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]


class _HandlerWalker:
    """One pass over a handler body, in program order."""

    def __init__(self, event_name: str, ctx_name: str,
                 n_inputs: int, n_outputs: int, line_base: int):
        self.env: dict[str, tuple] = {
            event_name: _EVENT,
            ctx_name: _CTX,
        }
        self.n_inputs = n_inputs
        self.n_outputs = n_outputs
        self.line_base = line_base   # real file line of parsed line 1
        self.ops: list[InferredOp] = []
        self.diags: list[Diagnostic] = []
        self.done = False            # unconditional return/raise seen

    # ------------------------------------------------------------ util

    def _line(self, node: ast.AST) -> int:
        return self.line_base + getattr(node, "lineno", 1) - 1

    def _error(self, code: str, msg: str, node: ast.AST) -> None:
        self.diags.append(Diagnostic(code, "error", msg, self._line(node),
                                     op_index=len(self.ops)))

    def _warn(self, code: str, msg: str, node: ast.AST) -> None:
        self.diags.append(Diagnostic(code, "warn", msg, self._line(node),
                                     op_index=len(self.ops)))

    def _text(self, val) -> str:
        """Render an abstract value as a symbolic comparison key."""
        if val[0] == "sym":
            return val[1]
        if val[0] == "seq":
            return val[2]
        if val[0] == "tuple":
            return "(" + ",".join(self._text(v) for v in val[1]) + ")"
        return val[0]

    # ----------------------------------------------------- expressions

    def visit_expr(self, node: ast.expr, *, conditional: bool = False,
                   in_try: bool = False) -> tuple:
        """Evaluate ``node``, emitting ops for storage calls met along
        the way, in left-to-right evaluation order."""
        v = self.visit_expr
        kw = {"conditional": conditional, "in_try": in_try}

        if isinstance(node, ast.Name):
            return self.env.get(node.id, _OPAQUE)
        if isinstance(node, ast.Constant):
            return ("sym", repr(node.value))
        if isinstance(node, ast.Attribute):
            base = v(node.value, **kw)
            if base == _CTX and node.attr == "storage":
                return _STORAGE
            if base == _STORAGE:
                if node.attr in S3_METHODS:
                    return ("method", node.attr)
                self._error(PC_METHOD,
                            f"unknown method {node.attr!r} on the storage "
                            f"surface (known: {sorted(S3_METHODS)})", node)
                return _OPAQUE
            return _OPAQUE
        if isinstance(node, ast.Subscript):
            return self._subscript(node, **kw)
        if isinstance(node, ast.Call):
            return self._call(node, **kw)
        if isinstance(node, (ast.Tuple, ast.List)):
            if any(isinstance(e, ast.Starred) for e in node.elts):
                for e in node.elts:
                    v(e.value if isinstance(e, ast.Starred) else e, **kw)
                return _OPAQUE
            return ("tuple", tuple(v(e, **kw) for e in node.elts))
        if isinstance(node, ast.JoinedStr):
            parts = []
            for piece in node.values:
                if isinstance(piece, ast.Constant):
                    parts.append(str(piece.value))
                elif isinstance(piece, ast.FormattedValue):
                    parts.append("{%s}" % self._text(v(piece.value, **kw)))
                else:
                    parts.append("?")
            text = "".join(parts)
            return ("sym", "?" if "?" in text else text)
        if isinstance(node, ast.BinOp):
            left, right = v(node.left, **kw), v(node.right, **kw)
            lt, rt = self._text(left), self._text(right)
            if "?" in (lt, rt):
                return _OPAQUE
            return ("sym", f"({lt}{type(node.op).__name__}{rt})")
        if isinstance(node, ast.BoolOp):
            for val in node.values:
                v(val, **kw)
            return _OPAQUE
        if isinstance(node, ast.UnaryOp):
            v(node.operand, **kw)
            return _OPAQUE
        if isinstance(node, ast.Compare):
            v(node.left, **kw)
            for c in node.comparators:
                v(c, **kw)
            return _OPAQUE
        if isinstance(node, ast.IfExp):
            v(node.test, **kw)
            v(node.body, conditional=True, in_try=in_try)
            v(node.orelse, conditional=True, in_try=in_try)
            return _OPAQUE
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    v(k, **kw)
            for val_node in node.values:
                val = v(val_node, **kw)
                if _is_carrier(val):
                    self._error(PC_ESCAPE,
                                "ctx/storage reference stored into a dict "
                                "— interception cannot track it", val_node)
            return _OPAQUE
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._comprehension(node, [node.elt], **kw)
        if isinstance(node, ast.DictComp):
            return self._comprehension(node, [node.key, node.value], **kw)
        if isinstance(node, ast.Lambda):
            if self._closes_over_carrier(node):
                self._error(PC_ESCAPE,
                            "lambda closes over ctx/storage — calls made "
                            "through it are invisible to the profile", node)
            return _OPAQUE
        if isinstance(node, ast.Starred):
            return v(node.value, **kw)
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return v(node.value, **kw)
        if isinstance(node, ast.Yield):
            if node.value is not None:
                v(node.value, **kw)
            return _OPAQUE
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    v(part, **kw)
            return _OPAQUE
        if isinstance(node, ast.NamedExpr):
            val = v(node.value, **kw)
            self._bind(node.target, val, node)
            return val
        # FormattedValue outside JoinedStr, Set, etc.
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                v(child, **kw)
        return _OPAQUE

    def _subscript(self, node: ast.Subscript, **kw) -> tuple:
        base = self.visit_expr(node.value, **kw)
        idx = node.slice
        if base == _EVENT and isinstance(idx, ast.Constant):
            if idx.value == "inputs":
                return ("seq", self.n_inputs, "event.inputs")
            if idx.value == "outputs":
                return ("seq", self.n_outputs, "event.outputs")
            return ("sym", f"event[{idx.value!r}]")
        if base[0] == "seq" and isinstance(idx, ast.Constant) \
                and isinstance(idx.value, int):
            count, root = base[1], base[2]
            i = idx.value
            if count is not None and i < 0:
                i += count
            return ("sym", f"{root}[{i}]")
        if base[0] == "seq" and isinstance(idx, ast.Slice):
            count, root = base[1], base[2]
            bounds = []
            for part in (idx.lower, idx.upper, idx.step):
                if part is None:
                    bounds.append(None)
                elif isinstance(part, ast.Constant) \
                        and isinstance(part.value, int):
                    bounds.append(part.value)
                else:
                    self.visit_expr(part, **kw)
                    return _OPAQUE
            if count is None:
                return ("seq", None, f"{root}[:]")
            lo, hi, st = slice(*bounds).indices(count)
            return ("seq", len(range(lo, hi, st)),
                    f"{root}[{bounds[0]}:{bounds[1]}]")
        if base[0] == "tuple" and isinstance(idx, ast.Constant) \
                and isinstance(idx.value, int):
            try:
                return base[1][idx.value]
            except IndexError:
                return _OPAQUE
        if base[0] == "sym" and base[1] != "?" \
                and isinstance(idx, ast.Constant):
            return ("sym", f"{base[1]}.{idx.value}")
        if isinstance(idx, ast.expr):
            self.visit_expr(idx, **kw)
        return _OPAQUE

    def _call(self, node: ast.Call, *, conditional: bool,
              in_try: bool) -> tuple:
        kw = {"conditional": conditional, "in_try": in_try}
        # Recognize storage calls first: either obj.method(...) where
        # obj resolves to storage, or name(...) where name is a bound
        # storage method.
        method = None
        if isinstance(node.func, ast.Attribute):
            recv = self.visit_expr(node.func.value, **kw)
            if recv == _STORAGE:
                if node.func.attr in S3_METHODS:
                    method = node.func.attr
                else:
                    self._error(PC_METHOD,
                                f"unknown method {node.func.attr!r} on the "
                                "storage surface "
                                f"(known: {sorted(S3_METHODS)})", node)
                    return _OPAQUE
        else:
            fval = self.visit_expr(node.func, **kw)
            if fval[0] == "method":
                method = fval[1]

        if method is not None:
            return self._storage_call(node, method,
                                      conditional=conditional,
                                      in_try=in_try)

        # Plain call: evaluate arguments, flag escaping carriers, and
        # pass sequences through the transparent builtins.
        argvals = [self.visit_expr(a, **kw) for a in node.args]
        for a, val in zip(node.args, argvals):
            if _is_carrier(val):
                self._error(PC_ESCAPE,
                            "ctx/storage passed to a call — storage calls "
                            "made inside it are invisible to the profile",
                            a)
        for kwarg in node.keywords:
            val = self.visit_expr(kwarg.value, **kw)
            if _is_carrier(val):
                self._error(PC_ESCAPE,
                            "ctx/storage passed to a call — storage calls "
                            "made inside it are invisible to the profile",
                            kwarg.value)
        fname = node.func.id if isinstance(node.func, ast.Name) else None
        if fname in ("list", "tuple", "sorted") and len(argvals) == 1 \
                and argvals[0][0] in ("seq", "tuple"):
            return argvals[0]
        if fname == "reversed" and len(argvals) == 1:
            val = argvals[0]
            if val[0] == "seq":
                return ("seq", val[1], f"rev({val[2]})")
            if val[0] == "tuple":
                return ("tuple", tuple(reversed(val[1])))
        if fname == "len" and len(argvals) == 1 \
                and argvals[0][0] == "seq" and argvals[0][1] is not None:
            return ("sym", repr(argvals[0][1]))
        return _OPAQUE

    def _storage_call(self, node: ast.Call, method: str, *,
                      conditional: bool, in_try: bool) -> tuple:
        kw = {"conditional": conditional, "in_try": in_try}
        named = {k.arg: self.visit_expr(k.value, **kw)
                 for k in node.keywords if k.arg is not None}
        pos = [self.visit_expr(a, **kw) for a in node.args]
        bucket = named.get("Bucket", pos[0] if len(pos) > 0 else _OPAQUE)
        key = named.get("Key", pos[1] if len(pos) > 1 else _OPAQUE)
        kind = "get" if method in _GETS else "put"
        if conditional:
            code = PC_COND_GET if kind == "get" else PC_COND_PUT
            self._error(code,
                        f"{method} under a conditional branch — the plan "
                        "would speculate I/O the handler may never issue",
                        node)
            return _OPAQUE
        if in_try:
            self._warn(PC_TRY_IO,
                       f"{method} inside a try body — a swallowed failure "
                       "desynchronizes the runtime profile cursor", node)
        self.ops.append(InferredOp(kind, method, self._line(node),
                                   self._text(bucket), self._text(key),
                                   in_try=in_try))
        return _OPAQUE

    def _comprehension(self, node, result_exprs: list, *,
                       conditional: bool, in_try: bool) -> tuple:
        """Unroll a comprehension with a statically-known iteration
        space; fall back to diagnostics when it is opaque."""
        kw = {"conditional": conditional, "in_try": in_try}
        if len(node.generators) != 1:
            if self._contains_storage_call(node):
                self._error(PC_LOOP,
                            "storage call in a multi-generator "
                            "comprehension — trip count is not static",
                            node)
            return _OPAQUE
        gen = node.generators[0]
        items = self._iter_items(gen.iter, **kw)
        if gen.ifs:
            if self._contains_storage_call(node):
                self._error(PC_COND_GET if self._contains_storage_call(
                    node, puts=False) else PC_COND_PUT,
                    "storage call under a comprehension filter — "
                    "conditional I/O", node)
            return _OPAQUE
        if items is None:
            if self._contains_storage_call(node):
                self._error(PC_LOOP,
                            "storage call in a comprehension over an "
                            "iterable of unknown length", node)
            return _OPAQUE
        out = []
        for item in items:
            self._bind(gen.target, item, node)
            for expr in result_exprs:
                out.append(self.visit_expr(expr, **kw))
        self._clear_target(gen.target)
        return ("seq", len(items), "?")

    # ------------------------------------------------------ statements

    def walk(self, stmts: list[ast.stmt], *, in_try: bool = False) -> None:
        for stmt in stmts:
            if self.done:
                return
            self.visit_stmt(stmt, in_try=in_try)

    def visit_stmt(self, node: ast.stmt, *, in_try: bool) -> None:
        kw = {"in_try": in_try}
        if isinstance(node, ast.Expr):
            self.visit_expr(node.value, **kw)
        elif isinstance(node, ast.Assign):
            val = self.visit_expr(node.value, **kw)
            for target in node.targets:
                self._bind(target, val, node)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._bind(node.target,
                           self.visit_expr(node.value, **kw), node)
        elif isinstance(node, ast.AugAssign):
            self.visit_expr(node.value, **kw)
            if isinstance(node.target, ast.Name):
                self.env[node.target.id] = _OPAQUE
        elif isinstance(node, ast.For):
            self._for(node, in_try=in_try)
        elif isinstance(node, (ast.While, ast.AsyncFor)):
            if self._contains_storage_call(node):
                self._error(PC_LOOP,
                            "storage call in a loop whose trip count is "
                            "not statically known", node)
            self._invalidate_assigned(node.body + node.orelse)
        elif isinstance(node, ast.If):
            self._if(node, in_try=in_try)
        elif isinstance(node, ast.Try):
            self._try(node)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                val = self.visit_expr(item.context_expr, **kw)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, val, node)
            self.walk(node.body, in_try=in_try)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                val = self.visit_expr(node.value, **kw)
                if _is_carrier(val):
                    self._error(PC_ESCAPE,
                                "ctx/storage returned from the handler",
                                node)
            self.done = True
        elif isinstance(node, ast.Raise):
            if node.exc is not None:
                self.visit_expr(node.exc, **kw)
            self.done = True
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            if self._closes_over_carrier(node):
                self._error(PC_ESCAPE,
                            f"nested {type(node).__name__} closes over "
                            "ctx/storage — calls made inside it are "
                            "invisible to the profile", node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.env[node.name] = _OPAQUE
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        elif isinstance(node, ast.Assert):
            self.visit_expr(node.test, **kw)
        elif isinstance(node, (ast.Import, ast.ImportFrom, ast.Pass,
                               ast.Global, ast.Nonlocal, ast.Break,
                               ast.Continue)):
            pass
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.visit_expr(child, **kw)

    def _for(self, node: ast.For, *, in_try: bool) -> None:
        items = self._iter_items(node.iter, in_try=in_try)
        has_io = self._contains_storage_call(node, body_only=True)
        if has_io and self._has_loop_exit(node.body):
            self._error(PC_LOOP,
                        "break/continue in a loop with storage calls — "
                        "the trip count is no longer static", node)
            self._invalidate_assigned(node.body + node.orelse)
            return
        if items is None:
            if has_io:
                self._error(PC_LOOP,
                            "storage call in a loop over an iterable of "
                            "statically-unknown length", node)
            self._invalidate_assigned(node.body + node.orelse)
            return
        for item in items:
            self._bind(node.target, item, node)
            self.walk(node.body, in_try=in_try)
            if self.done:
                return
        self._clear_target(node.target)
        self.walk(node.orelse, in_try=in_try)

    def _if(self, node: ast.If, *, in_try: bool) -> None:
        self.visit_expr(node.test, in_try=in_try)
        # A pure guard (no storage I/O, branch ends the invocation) is
        # an assertion-style early exit, not conditional I/O.
        branches = [b for b in (node.body, node.orelse) if b]
        for branch in branches:
            for call, kind in self._storage_calls_in(branch):
                code = PC_COND_GET if kind == "get" else PC_COND_PUT
                self._error(code,
                            "storage call under a conditional branch — "
                            "the declared profile is unconditional "
                            "but this I/O is not", call)
        self._invalidate_assigned(node.body + node.orelse)

    def _try(self, node: ast.Try) -> None:
        self.walk(node.body, in_try=True)
        for handler in node.handlers:
            for call, _kind in self._storage_calls_in(handler.body):
                self._error(PC_EXCEPT_IO,
                            "storage call inside an except block — "
                            "recovery I/O is invisible to the declared "
                            "profile", call)
            self._invalidate_assigned(handler.body)
        self.walk(node.orelse, in_try=False)
        self.walk(node.finalbody, in_try=False)

    # ------------------------------------------------- loop unrolling

    def _iter_items(self, expr: ast.expr, **kw) -> list | None:
        """Return the per-iteration abstract values of ``expr``, or
        None when the iteration space is not statically known."""
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            fname = expr.func.id
            if fname == "range" and expr.args and not expr.keywords:
                consts = []
                for a in expr.args:
                    if isinstance(a, ast.Constant) \
                            and isinstance(a.value, int):
                        consts.append(a.value)
                    else:
                        self.visit_expr(a, **kw)
                        return None
                return [("sym", repr(i)) for i in range(*consts)]
            if fname == "enumerate" and len(expr.args) >= 1:
                inner = self._iter_items(expr.args[0], **kw)
                if inner is None:
                    return None
                start = 0
                if len(expr.args) == 2 and isinstance(
                        expr.args[1], ast.Constant):
                    start = expr.args[1].value
                return [("tuple", (("sym", repr(start + i)), item))
                        for i, item in enumerate(inner)]
            if fname == "zip" and expr.args and not expr.keywords:
                cols = [self._iter_items(a, **kw) for a in expr.args]
                if any(c is None for c in cols):
                    return None
                n = min(len(c) for c in cols)
                return [("tuple", tuple(col[i] for col in cols))
                        for i in range(n)]
            if fname in ("reversed", "sorted", "list", "tuple") \
                    and len(expr.args) == 1:
                inner = self._iter_items(expr.args[0], **kw)
                if inner is None:
                    return None
                return list(reversed(inner)) if fname == "reversed" \
                    else inner

        val = self.visit_expr(expr, **kw)
        if val[0] == "seq" and val[1] is not None:
            root = val[2]
            return [("sym", f"{root}[{i}]") for i in range(val[1])]
        if val[0] == "tuple":
            return list(val[1])
        return None

    # ------------------------------------------------------- binding

    def _bind(self, target: ast.expr, val: tuple, node: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if any(isinstance(e, ast.Starred) for e in elts):
                for e in elts:
                    self._bind(e.value if isinstance(e, ast.Starred)
                               else e, _OPAQUE, node)
                return
            if val[0] == "tuple" and len(val[1]) == len(elts):
                for e, v in zip(elts, val[1]):
                    self._bind(e, v, node)
                return
            if val[0] == "seq" and val[1] == len(elts):
                for i, e in enumerate(elts):
                    self._bind(e, ("sym", f"{val[2]}[{i}]"), node)
                return
            for e in elts:
                self._bind(e, _OPAQUE, node)
            return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            if _is_carrier(val):
                self._error(PC_ESCAPE,
                            "ctx/storage stored into a container — "
                            "interception cannot track it", node)
            self.visit_expr(target.value)

    def _clear_target(self, target: ast.expr) -> None:
        """Loop variables are dead after the loop for our purposes."""
        if isinstance(target, ast.Name):
            self.env[target.id] = _OPAQUE
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._clear_target(e.value if isinstance(e, ast.Starred)
                                   else e)

    def _invalidate_assigned(self, stmts: list[ast.stmt]) -> None:
        """Names assigned in a skipped/merged region become opaque."""
        for stmt in stmts:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Store):
                    self.env[sub.id] = _OPAQUE

    # -------------------------------------------------------- scanning

    def _looks_like_storage_recv(self, func: ast.expr) -> bool:
        """Conservative receiver test for pre-scans: resolvable
        receivers that are definitely not storage don't count."""
        if isinstance(func, ast.Attribute) and func.attr in S3_METHODS:
            recv = func.value
            if isinstance(recv, ast.Name):
                known = self.env.get(recv.id)
                return known is None or _is_carrier(known) \
                    or known in (_CTX, _STORAGE)
            return True
        if isinstance(func, ast.Name):
            known = self.env.get(func.id)
            return known is not None and known[0] == "method"
        return False

    def _storage_calls_in(self, stmts) -> list[tuple[ast.Call, str]]:
        found = []
        nodes = stmts if isinstance(stmts, list) else [stmts]
        for stmt in nodes:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) \
                        and self._looks_like_storage_recv(sub.func):
                    if isinstance(sub.func, ast.Attribute):
                        kind = "get" if sub.func.attr in _GETS else "put"
                    else:
                        kind = "get" if self.env[sub.func.id][1] in _GETS \
                            else "put"
                    found.append((sub, kind))
        return found

    def _contains_storage_call(self, node, *, body_only: bool = False,
                               puts: bool = True) -> bool:
        stmts = node.body if body_only else node
        calls = self._storage_calls_in(
            stmts if isinstance(stmts, list) else [stmts])
        if not puts:
            calls = [c for c in calls if c[1] == "get"]
        return bool(calls)

    def _has_loop_exit(self, body: list[ast.stmt]) -> bool:
        """Break/continue at this loop's own level (nested loops own
        their own exits)."""
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.For, ast.While)):
                    continue
                if isinstance(sub, (ast.Break, ast.Continue)):
                    return True
        return False

    def _closes_over_carrier(self, node: ast.AST) -> bool:
        carriers = {name for name, val in self.env.items()
                    if _is_carrier(val)}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in carriers:
                return True
        return False


# ---------------------------------------------------------------- API


def infer_handler(handler, n_inputs: int, n_outputs: int,
                  *, name: str | None = None) -> InferenceResult:
    """Statically recover the storage-call sequence of ``handler``."""
    name = name or getattr(handler, "__name__", "<handler>")
    try:
        src_lines, start = inspect.getsourcelines(handler)
        src_file = inspect.getsourcefile(handler) or "<unknown>"
    except (OSError, TypeError):
        res = InferenceResult(name, "<unavailable>")
        res.diagnostics.append(Diagnostic(
            PC_NO_SOURCE, "warn",
            f"source for {name} unavailable; static inference skipped"))
        return res

    tree = ast.parse(textwrap.dedent("".join(src_lines)))
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and n.name == handler.__name__), None)
    if fn is None or len(fn.args.args) < 2:
        res = InferenceResult(name, src_file)
        res.diagnostics.append(Diagnostic(
            PC_NO_SOURCE, "warn",
            f"could not locate a handler(event, ctx) definition "
            f"for {name}"))
        return res

    walker = _HandlerWalker(fn.args.args[0].arg, fn.args.args[1].arg,
                            n_inputs, n_outputs, line_base=start)
    walker.walk(fn.body)

    res = InferenceResult(name, src_file, ops=walker.ops,
                          diagnostics=walker.diags)
    _check_duplicate_puts(res)
    return res


def _check_duplicate_puts(res: InferenceResult) -> None:
    seen: dict[tuple[str, str], InferredOp] = {}
    for i, op in enumerate(res.ops):
        if op.kind != "put" or "?" in op.bucket or "?" in op.key:
            continue
        dup = seen.get((op.bucket, op.key))
        if dup is not None:
            res.diagnostics.append(Diagnostic(
                PC_DUP_KEY, "error",
                f"put_object at line {op.line} writes the same "
                f"(bucket, key) as line {dup.line}: "
                f"({op.bucket}, {op.key}) — the runtime rejects "
                "duplicate durable writes", op.line, op_index=i))
        else:
            seen[(op.bucket, op.key)] = op


_CHECK_CACHE: dict[tuple, InferenceResult] = {}


def render_kinds(kinds) -> str:
    return "[" + " ".join(kinds) + "]" if kinds else "[]"


def check_workload(w: Workload) -> InferenceResult:
    """Verify ``w.handler`` against ``w.profile`` — the registration-
    time entry point. Raises `PlanCheckError` on any error-severity
    finding or shape mismatch; returns the (cached) inference result
    otherwise."""
    cache_key = (w.handler, w.profile)
    cached = _CHECK_CACHE.get(cache_key)
    if cached is not None:
        return cached

    profile: IOProfile = w.profile
    declared = profile.io_kinds
    n_in = sum(1 for k in declared if k == "get")
    n_out = len(declared) - n_in
    res = infer_handler(w.handler, n_in, n_out, name=w.name)

    for d in res.errors:
        raise PlanCheckError(d.code, d.message, subject=w.name,
                             op_index=d.op_index, line=d.line)

    if not any(d.code == PC_NO_SOURCE for d in res.diagnostics):
        inferred = res.kinds
        if inferred != declared:
            i = next((j for j in range(min(len(inferred), len(declared)))
                      if inferred[j] != declared[j]),
                     min(len(inferred), len(declared)))
            if i < len(inferred):
                line = res.ops[i].line
                got = f"{inferred[i]} ({res.ops[i].method}, line {line})"
            else:
                line = res.ops[-1].line if res.ops else None
                got = "no further storage call"
            want = declared[i] if i < len(declared) else "nothing"
            raise PlanCheckError(
                PC_SHAPE,
                f"handler op {i} is {got} but its IOProfile declares "
                f"{want}; inferred {render_kinds(inferred)} vs declared "
                f"{render_kinds(declared)}",
                subject=w.name, op_index=i, line=line)

    # Declared-profile lint: a GET after the final compute segment can
    # never overlap compute and drags the release barrier later.
    last_compute = max((j for j, op in enumerate(profile.ops)
                        if isinstance(op, ComputeSegment)), default=-1)
    if any(isinstance(op, Get) for op in profile.ops[last_compute + 1:]):
        res.diagnostics.append(Diagnostic(
            PC_TRAILING_GET, "warn",
            f"{w.name}: IOProfile declares a GET after the final "
            "compute segment — it cannot overlap compute and delays "
            "slot release"))

    _CHECK_CACHE[cache_key] = res
    return res
