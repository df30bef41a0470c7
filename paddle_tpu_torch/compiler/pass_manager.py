"""Ordered, named pass pipeline over captured programs: the counterpart
of ``paddle_tpu/compiler/pass_manager.py``, with a ``torch.fx``
``GraphModule`` (an ATen-level capture, ``compiler.capture``) where the
JAX package has a ClosedJaxpr.

A pass maps GraphModule -> GraphModule and keeps its placeholders and
outputs exactly (count, order, shapes, types): the manager relies on that
to drop any pass. A pass that raises is skipped, its input graph kept,
and the failure is a counted event, never a user-facing error.

Observability, under the JAX names: every run increments
``compiler_programs_total``, each pass records its wall time in
``compiler_pass_seconds{pass=}``, a skipped pass counts in
``compiler_pass_errors_total`` and records ``compiler_pass_error``, each
top-level run records ``compiler_program``, and
``PADDLE_TPU_COMPILER_DUMP=<dir>`` writes the fx graph text before and
after each pass that changed the program, and the final program.

Identity contract: a pass that changes nothing returns the SAME object it
was given; the manager uses identity to skip dumps and report
"unchanged". A pass never mutates its input: a change is a new
GraphModule.
"""

from __future__ import annotations

import os
import time

from ..observability.events import EVENTS as _EVENTS
from ..observability.metrics import REGISTRY as _REG

__all__ = [
    "Pass", "FunctionPass", "PassContext", "PassManager", "PASS_REGISTRY",
    "register_graph_pass", "default_pipeline", "default_pass_manager",
    "graph_text", "n_nodes",
]

_C_PROGRAMS = _REG.counter("compiler_programs_total",
                           "programs run through the graph pass pipeline")
_C_PASS_ERRORS = _REG.counter("compiler_pass_errors_total",
                              "passes skipped because they raised")

# dump sequence numbers per program name (a program captured N times gets
# N dump prefixes instead of overwriting itself)
_DUMP_SEQ = {}


def n_nodes(gm):
    """The program's operations: its call nodes (placeholders, constants
    and the output are no operation), the counterpart of a jaxpr's
    equation count."""
    return sum(1 for n in gm.graph.nodes
               if n.op in ("call_function", "call_module", "call_method"))


def graph_text(gm):
    """The fx graph as text, with each node's checkpoint name
    (``remat``) where it has one."""
    lines = [str(gm.graph)]
    tags = [f"#   {n.name}: {n.meta['checkpoint_name']}"
            for n in gm.graph.nodes if "checkpoint_name" in n.meta]
    if tags:
        lines.append("# checkpoint names:")
        lines.extend(tags)
    return "\n".join(lines) + "\n"


class PassContext:
    """Carried through one PassManager.run: per-pass timings, rewrite
    records ({pattern, status, ...} dicts appended by rewrite passes) and
    free-form options read by passes (e.g. fusion's pattern subset)."""

    def __init__(self, program="program", options=None):
        self.program = program
        self.options = dict(options or {})
        self.records = []     # rewrite-level: applied / fallback entries
        self.timings = []     # (pass name, seconds, changed)
        self.depth = 0        # > 0 inside a descended subgraph

    def applied(self, pattern=None):
        return [r for r in self.records
                if r.get("status") == "applied"
                and (pattern is None or r.get("pattern") == pattern)]

    def fallbacks(self, pattern=None):
        return [r for r in self.records
                if r.get("status") != "applied"
                and (pattern is None or r.get("pattern") == pattern)]


class Pass:
    """Base pass. Subclasses set ``name`` and implement run()."""

    name = "pass"

    def run(self, gm, ctx):  # pragma: no cover - interface
        return gm

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class FunctionPass(Pass):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def run(self, gm, ctx):
        return self._fn(gm, ctx)


# name -> zero-arg factory returning a Pass. One registry shared by graph
# passes and distributed passes (distributed.passes re-exports it).
PASS_REGISTRY = {}


def register_graph_pass(name, factory=None):
    """Register a pass factory under ``name``. Usable as a decorator over
    a Pass subclass (instantiated with no args) or a factory callable."""
    def deco(obj):
        PASS_REGISTRY[name] = obj
        return obj
    if factory is not None:
        return deco(factory)
    return deco


def default_pipeline():
    """Pass order of the default pipeline: fusion first (patterns match
    the raw capture, before cleanup rewires it), remat tags right after
    (they anchor on the fused ops), then constant folding, CSE and a final
    DCE sweep that drops the unfused originals."""
    return ["pattern_fusion", "remat_tag", "constant_fold", "cse", "dce"]


def default_pass_manager():
    return PassManager(default_pipeline())


class PassManager:
    """Ordered pass list with lookup/insert/remove by name."""

    def __init__(self, passes=None):
        self._passes = []
        for p in (default_pipeline() if passes is None else passes):
            self.add(p)

    # -- composition -----------------------------------------------------
    def _resolve(self, p):
        if isinstance(p, Pass):
            return p
        if isinstance(p, str):
            if p not in PASS_REGISTRY:
                raise KeyError(
                    f"unknown graph pass {p!r}; registered: "
                    f"{sorted(PASS_REGISTRY)}")
            return PASS_REGISTRY[p]()
        if callable(p):
            made = p()
            if isinstance(made, Pass):
                return made
        raise TypeError(f"not a pass: {p!r}")

    def add(self, p, after=None, before=None):
        p = self._resolve(p)
        if after is not None:
            i = self._index(after) + 1
        elif before is not None:
            i = self._index(before)
        else:
            i = len(self._passes)
        self._passes.insert(i, p)
        return p

    def _index(self, name):
        for i, p in enumerate(self._passes):
            if p.name == name:
                return i
        raise KeyError(f"no pass named {name!r} in pipeline")

    def remove(self, name):
        self._passes.pop(self._index(name))

    def get(self, name):
        return self._passes[self._index(name)]

    def names(self):
        return [p.name for p in self._passes]

    # -- execution -------------------------------------------------------
    def run(self, gm, program="program", ctx=None):
        """Run every pass in order. Never raises out of a pass: a failing
        pass is skipped (its input graph kept) and counted and logged."""
        ctx = ctx if ctx is not None else PassContext(program)
        if ctx.depth == 0:
            _C_PROGRAMS.inc()
        dump_dir = os.environ.get("PADDLE_TPU_COMPILER_DUMP")
        prefix = None
        if dump_dir and ctx.depth == 0:
            os.makedirs(dump_dir, exist_ok=True)
            seq = _DUMP_SEQ[program] = _DUMP_SEQ.get(program, -1) + 1
            prefix = os.path.join(dump_dir,
                                  f"{program.replace(os.sep, '_')}."
                                  f"{seq:03d}")
        n_before = n_nodes(gm)
        for i, p in enumerate(self._passes):
            before = gm
            t0 = time.perf_counter()
            try:
                gm = p.run(gm, ctx)
                if gm is None:
                    gm = before
            except Exception as e:  # noqa: BLE001 — pass fallback guarantee
                gm = before
                _C_PASS_ERRORS.inc()
                _EVENTS.record("compiler_pass_error", program=ctx.program,
                               pass_name=p.name,
                               error=f"{type(e).__name__}: {e}"[:300])
            dt = time.perf_counter() - t0
            changed = gm is not before
            _REG.histogram("compiler_pass_seconds",
                           "per-pass graph pipeline wall time",
                           labels={"pass": p.name}).observe(dt)
            ctx.timings.append((p.name, dt, changed))
            if prefix and changed:
                self._dump(f"{prefix}.{i:02d}.{p.name}", before, gm)
        if ctx.depth == 0:
            _EVENTS.record(
                "compiler_program", program=ctx.program,
                eqns_before=n_before, eqns_after=n_nodes(gm),
                rewrites=len(ctx.applied()),
                fallbacks=len(ctx.fallbacks()),
                passes=[(n, round(t * 1e3, 3), c)
                        for n, t, c in ctx.timings])
            if prefix:
                with open(prefix + ".final.txt", "w") as f:
                    f.write(graph_text(gm))
        return gm

    @staticmethod
    def _dump(prefix, before, after):
        try:
            with open(prefix + ".before.txt", "w") as f:
                f.write(graph_text(before))
            with open(prefix + ".after.txt", "w") as f:
                f.write(graph_text(after))
        except OSError:  # pragma: no cover - dumps are best-effort
            pass
