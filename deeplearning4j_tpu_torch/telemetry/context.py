"""TraceContext — Dapper-style trace/span ids carried via contextvars (the
port's own copy of deeplearning4j_tpu/telemetry/context.py).

The tracer (telemetry/trace.py) records spans; this module gives them an
*identity*: one ``trace_id`` per logical operation (a serving request, a
distributed fit), a ``span_id`` per span, and a ``parent_id`` linking the
span to the one that caused it. The Tracer stamps the active context's ids
onto every span/instant it records, so a p99 serving outlier or a worker's
slow fit is attributable to the exact request/fit that produced it, across
threads (the TF-large-scale-system / Dapper propagation model, PAPERS.md).

Propagation rules:

  * Within a thread, the context flows implicitly through a
    ``contextvars.ContextVar`` — ``with tracer().span(...)`` both reads
    the current context for parenting AND installs its own span as the
    parent for anything nested inside it.
  * Across threads, contextvars do NOT propagate. The handoff contract is
    explicit: the producing thread captures ``current()`` (or the
    per-item context it minted), hands it over with the work item, and
    the consuming thread wraps the work in ``activate(ctx)`` (or paired
    ``attach``/``detach``). The serving dispatcher follows exactly this
    contract.
  * ``new_trace()`` mints a fresh root; ``ctx.child()`` derives a child
    whose ``parent_id`` is the caller's ``span_id``. Ids are 64-bit
    random hex — unique enough to join traces across workers without any
    coordination.

Cost model: with no context attached (the default), ``current()`` is one
ContextVar read returning None and the Tracer stamps nothing — the
telemetry-off path allocates zero objects here, the same contract as
NULL_SPAN. Context creation happens only at the instrumented entry points
(request admission, fit start), which are themselves behind the
``DL4J_TPU_TELEMETRY`` gate.
"""
from __future__ import annotations

import contextvars
import os
from contextlib import contextmanager
from typing import Optional

__all__ = [
    "TraceContext", "new_trace", "new_span_id", "current", "attach",
    "detach", "activate", "current_trace_id",
]


def new_span_id() -> str:
    """64 random bits as 16 hex chars (the Dapper id width)."""
    return os.urandom(8).hex()


class TraceContext:
    """Immutable id triple for one span's position in a trace."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        """A context for work *caused by* this span: same trace, fresh
        span_id, parented to this span."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def __repr__(self) -> str:
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, parent_id={self.parent_id!r})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.parent_id))


_var: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("dl4j_tpu_trace_context", default=None)


def new_trace() -> TraceContext:
    """Mint a fresh root context (trace_id == span_id, no parent) — one
    per logical operation: a serving request, a distributed fit."""
    root = new_span_id()
    return TraceContext(root, root, None)


def current() -> Optional[TraceContext]:
    """The thread's (strictly: the contextvars context's) active
    TraceContext, or None when nothing is being traced."""
    return _var.get()


def current_trace_id() -> Optional[str]:
    """Convenience for stamping artifacts (flight bundles): the active
    trace_id or None — never raises, never allocates when untraced."""
    ctx = _var.get()
    return None if ctx is None else ctx.trace_id


def attach(ctx: Optional[TraceContext]) -> contextvars.Token:
    """Install ``ctx`` as the active context; returns the token for the
    paired ``detach``. This is the cross-thread handoff primitive: the
    consuming thread attaches the context it was handed, does the work,
    and detaches in a finally block."""
    return _var.set(ctx)


def detach(token: contextvars.Token) -> None:
    """Restore whatever was active before the paired ``attach``."""
    _var.reset(token)


@contextmanager
def activate(ctx: Optional[TraceContext]):
    """``attach``/``detach`` as a context manager — the recommended form
    for thread-entry functions (dispatcher loops, worker executors)."""
    token = _var.set(ctx)
    try:
        yield ctx
    finally:
        _var.reset(token)
