"""Tracing: spans woven through the hot path, no-op when disabled.

The port's copy of gubernator_tpu/utils/tracing.py (stdlib only; the
OTel branch imports its packages lazily and warns when they are
missing).  Upstream Gubernator weaves holster tracing through every
function (SURVEY.md §5.1 — e.g. gubernator.go:198-202,
algorithms.go:32-44) and exports via OTEL_* env configuration
(cmd/gubernator/main.go:57-69).

Three backends, selected by `init_tracing()`:

- disabled (default): `span()` is one global check — the decision hot
  path never pays for tracing that is off.
- OTel (when OTEL_EXPORTER_OTLP_ENDPOINT / OTEL_TRACES_EXPORTER is set
  and the opentelemetry SDK is importable): real OTLP export.
- in-memory recorder (`InMemoryTracer`, or
  GUBER_TRACING=memory): dependency-free span capture with parent
  links, attributes, and events — the test oracle
  (tests/test_tracing.py) and the tail flight recorder's feed
  (utils/flight_recorder.py).

Cross-tier context (OBSERVABILITY.md describes the JAX package's, which
this copy keeps):

Every span carries a W3C-traceparent-shaped context — (trace_id,
span_id, sampled) — and spans can be parented three ways:

- nesting (same thread, like OTel's implicit context);
- ``parent_ctx=`` — an explicit LOCAL parent, for work handed to
  another thread (forward pool, flush workers, fan-out pools);
- ``remote_parent=`` — a context extracted from an incoming RPC's
  ``traceparent`` metadata: the span joins the caller's trace across
  the process boundary (``remote=True`` on the recorded span).

`grpc_metadata()` injects the current context into outgoing gRPC
metadata; `remote_parent_from_metadata()` extracts it server-side.
Both are None/no-op while tracing is disabled, so the wire paths pay
one global check and nothing else.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

log = logging.getLogger("gubernator_tpu_torch.tracing")

_tracer = None
_initialized = False


@dataclass(frozen=True)
class TraceContext:
    """W3C-traceparent-shaped span identity: 32-hex trace_id, 16-hex
    span_id, sampled flag — what travels on the wire."""

    trace_id: str
    span_id: str
    sampled: bool = True


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(ctx: TraceContext) -> str:
    """``00-<trace_id>-<span_id>-<flags>`` (W3C Trace Context)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def parse_traceparent(value: str) -> Optional[TraceContext]:
    """Inverse of format_traceparent; None on anything malformed (a
    bad header must never fail the RPC carrying it)."""
    try:
        parts = value.strip().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, flags = parts
        if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
            return None
        int(trace_id, 16)
        int(span_id, 16)
        return TraceContext(
            trace_id=trace_id,
            span_id=span_id,
            sampled=bool(int(flags, 16) & 1),
        )
    except (ValueError, AttributeError):
        return None


@dataclass
class RecordedSpan:
    """One finished span in the in-memory recorder."""

    name: str
    attributes: dict = field(default_factory=dict)
    events: List[tuple] = field(default_factory=list)  # (name, attrs)
    parent: Optional[str] = None  # parent span name (None = root)
    start_ns: int = 0
    end_ns: int = 0
    # Cross-tier identity (TraceContext-shaped).
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: Optional[str] = None
    # True when the parent lives in another process (the context came
    # in via RPC metadata).
    remote: bool = False

    @property
    def context(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs) -> None:
        self.events.append((name, attrs))


class InMemoryTracer:
    """Thread-safe span recorder with a per-thread active-span stack
    (parent links come from nesting, like OTel's context) plus
    explicit local/remote parenting for cross-thread and cross-process
    stitching.  Bounded: the oldest finished spans are shed past
    `max_spans` (a long-lived daemon must not grow without bound)."""

    def __init__(self, max_spans: int = 100_000) -> None:
        from collections import deque

        self.finished = deque(maxlen=max(1, max_spans))
        self._lock = threading.Lock()
        self._local = threading.local()
        # Live trace ids by refcount: a metric exemplar links a
        # histogram bucket to a trace_id (utils/metrics.DurationStat),
        # and an exemplar pointing at a trace the deque has fully
        # evicted is a dead link — has_trace() answers membership in
        # O(1) so the exporter can prune instead of publishing it.
        # Every OPEN span holds one ref (acquired at start, released
        # at finish) and every RETAINED finished span holds one: an
        # exemplar is captured while its span is still open, so a
        # scrape racing the span's finish must still see the trace as
        # live — pruning there would drop the link moments before the
        # trace lands in the deque.
        self._trace_refs: dict = {}  # guberlint: guarded-by _lock
        # Root-finish hook (utils/flight_recorder.py): called with the
        # outermost span of a thread's stack right after it finishes.
        self.on_root_finish = None

    def _acquire_ref_locked(self, trace_id: str) -> None:
        self._trace_refs[trace_id] = (
            self._trace_refs.get(trace_id, 0) + 1
        )

    def _release_ref_locked(self, trace_id: str) -> None:
        n = self._trace_refs.get(trace_id, 0) - 1
        if n <= 0:
            self._trace_refs.pop(trace_id, None)
        else:
            self._trace_refs[trace_id] = n

    def _append_finished_locked(self, s: "RecordedSpan") -> None:
        """Append under self._lock, accounting trace-id refcounts
        through the deque's eviction (popleft explicitly — an implicit
        maxlen eviction would be invisible to the refcount table)."""
        if len(self.finished) == self.finished.maxlen:
            old = self.finished.popleft()
            self._release_ref_locked(old.trace_id)
        self.finished.append(s)
        self._acquire_ref_locked(s.trace_id)

    def has_trace(self, trace_id: str) -> bool:
        """Whether any open or retained finished span of this trace
        is still live (exemplar liveness — see _trace_refs above)."""
        with self._lock:
            return trace_id in self._trace_refs

    def _stack(self) -> List[RecordedSpan]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current_context(self) -> Optional[TraceContext]:
        st = getattr(self._local, "stack", None)
        return st[-1].context if st else None

    @contextlib.contextmanager
    def start_span(
        self,
        name: str,
        remote_parent: Optional[TraceContext] = None,
        parent_ctx: Optional[TraceContext] = None,
        **attributes,
    ) -> Iterator[RecordedSpan]:
        stack = self._stack()
        if remote_parent is not None:
            trace_id = remote_parent.trace_id
            parent_span_id: Optional[str] = remote_parent.span_id
            remote = True
            parent_name = None
        elif parent_ctx is not None:
            trace_id = parent_ctx.trace_id
            parent_span_id = parent_ctx.span_id
            remote = False
            parent_name = None
        elif stack:
            trace_id = stack[-1].trace_id
            parent_span_id = stack[-1].span_id
            remote = False
            parent_name = stack[-1].name
        else:
            trace_id = _new_trace_id()
            parent_span_id = None
            remote = False
            parent_name = None
        s = RecordedSpan(
            name=name,
            attributes=dict(attributes),
            parent=parent_name,
            start_ns=time.monotonic_ns(),
            trace_id=trace_id,
            span_id=_new_span_id(),
            parent_span_id=parent_span_id,
            remote=remote,
        )
        stack.append(s)
        # The open span holds a trace ref so an exemplar captured
        # inside it survives a scrape racing the span's finish — but
        # only the thread's STACK ROOT (or a span re-anchored to a
        # different trace) needs one: children share the root's
        # trace_id, so its ref already keeps has_trace() true for
        # exemplars captured in descendants, and skipping them avoids
        # a global-lock acquisition per child span start.
        own_ref = len(stack) == 1 or s.trace_id != stack[0].trace_id
        if own_ref:
            with self._lock:
                self._acquire_ref_locked(s.trace_id)
        try:
            yield s
        finally:
            stack.pop()
            s.end_ns = time.monotonic_ns()
            with self._lock:
                # Retained-ref first, open-ref release second: the
                # trace must never read dead between the two.
                self._append_finished_locked(s)
                if own_ref:
                    self._release_ref_locked(s.trace_id)
            # Fire for this PROCESS's trace roots: spans with no
            # parent anywhere, plus remote-parented handler spans —
            # on an owner node every root is rpc.* with a remote
            # parent, and excluding those would leave its flight
            # recorder permanently empty.  Locally re-anchored pool
            # spans (parent_ctx: global.owner_rpc, forward.group,
            # broadcast pushes) stay excluded — they belong to a
            # local decision's trace, and feeding them would inflate
            # the rolling-p99 threshold with RPC-timeout-scale
            # durations and duplicate their trace's trees.
            if (
                not stack
                and (s.parent_span_id is None or s.remote)
                and self.on_root_finish is not None
            ):
                try:
                    self.on_root_finish(s)
                except Exception:  # noqa: BLE001 — recording must not
                    # fail the traced operation.
                    log.exception("root-finish hook failed")

    def record_span(
        self,
        name: str,
        start_ns: int,
        end_ns: int,
        parent_ctx: Optional[TraceContext] = None,
        **attributes,
    ) -> RecordedSpan:
        """Record an already-finished span from externally measured
        timestamps (monotonic ns) — the native event collector's span
        stubs (utils/native_events.py)."""
        if parent_ctx is not None:
            trace_id, parent_span_id = parent_ctx.trace_id, parent_ctx.span_id
        else:
            trace_id, parent_span_id = _new_trace_id(), None
        s = RecordedSpan(
            name=name,
            attributes=dict(attributes),
            start_ns=start_ns,
            end_ns=end_ns,
            trace_id=trace_id,
            span_id=_new_span_id(),
            parent_span_id=parent_span_id,
        )
        with self._lock:
            self._append_finished_locked(s)
        return s

    def add_event(self, name: str, **attrs) -> None:
        """Attach an event to this thread's current span (no-op when
        none is open)."""
        st = getattr(self._local, "stack", None)
        if st:
            st[-1].add_event(name, **attrs)

    # Test helpers -----------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[RecordedSpan]:
        with self._lock:
            out = list(self.finished)
        return [s for s in out if name is None or s.name == name]

    def trace(
        self, trace_id: str, max_scan: Optional[int] = None
    ) -> List[RecordedSpan]:
        """Finished spans of one trace.  `max_scan` bounds the walk to
        the NEWEST that many spans (the flight recorder captures at
        root finish, when the trace's spans are by construction the
        most recent — an unbounded filter of a 100k-span deque under
        this lock would stall every concurrent span finish)."""
        import itertools

        with self._lock:
            if max_scan is None or len(self.finished) <= max_scan:
                return [s for s in self.finished if s.trace_id == trace_id]
            # islice actually STOPS the walk at max_scan (a filtering
            # comprehension over the whole deque would still iterate
            # every element under this lock).
            out = [
                s
                for s in itertools.islice(
                    reversed(self.finished), max_scan
                )
                if s.trace_id == trace_id
            ]
            out.reverse()
            return out

    def clear(self) -> None:
        with self._lock:
            self.finished.clear()
            self._trace_refs.clear()


class _OtelTracer:
    """Adapter presenting the start_span interface over an OTel tracer
    (remote parents become OTel remote SpanContexts)."""

    def __init__(self, tracer) -> None:
        self._tracer = tracer

    @contextlib.contextmanager
    def start_span(
        self,
        name: str,
        remote_parent: Optional[TraceContext] = None,
        parent_ctx: Optional[TraceContext] = None,
        **attributes,
    ) -> Iterator[object]:
        from opentelemetry import context as otel_context
        from opentelemetry import trace as otel_trace

        ctx = None
        parent = remote_parent or parent_ctx
        if parent is not None:
            span_ctx = otel_trace.SpanContext(
                trace_id=int(parent.trace_id, 16),
                span_id=int(parent.span_id, 16),
                is_remote=remote_parent is not None,
                trace_flags=otel_trace.TraceFlags(
                    otel_trace.TraceFlags.SAMPLED if parent.sampled else 0
                ),
            )
            ctx = otel_trace.set_span_in_context(
                otel_trace.NonRecordingSpan(span_ctx),
                otel_context.get_current(),
            )
        with self._tracer.start_as_current_span(name, context=ctx) as s:
            for k, v in attributes.items():
                s.set_attribute(k, v)
            yield s

    def current_context(self) -> Optional[TraceContext]:
        from opentelemetry import trace as otel_trace

        sc = otel_trace.get_current_span().get_span_context()
        if not sc.is_valid:
            return None
        return TraceContext(
            trace_id=format(sc.trace_id, "032x"),
            span_id=format(sc.span_id, "016x"),
            sampled=bool(sc.trace_flags & 1),
        )

    def add_event(self, name: str, **attrs) -> None:
        from opentelemetry import trace as otel_trace

        s = otel_trace.get_current_span()
        if s.get_span_context().is_valid:
            s.add_event(name, attributes=attrs)


def init_tracing(service_name: str = "gubernator_tpu_torch") -> bool:
    """Configure the global tracer from OTEL_*/GUBER_TRACING env;
    returns whether tracing is active.
    reference: cmd/gubernator/main.go:57-69."""
    global _tracer, _initialized
    if _initialized:
        return _tracer is not None
    _initialized = True
    if os.environ.get("GUBER_TRACING", "") == "memory":
        _tracer = InMemoryTracer()
        log.info("in-memory tracing active")
        return True
    want = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT") or os.environ.get(
        "OTEL_TRACES_EXPORTER"
    )
    if not want:
        return False
    try:
        from opentelemetry import trace
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
    except ImportError as e:
        log.warning("tracing requested but exporter unavailable: %s", e)
        return False
    provider = TracerProvider(
        resource=Resource.create({"service.name": service_name})
    )
    provider.add_span_processor(BatchSpanProcessor(OTLPSpanExporter()))
    trace.set_tracer_provider(provider)
    _tracer = _OtelTracer(trace.get_tracer("gubernator_tpu_torch"))
    log.info("OTel tracing active (service=%s)", service_name)
    return True


def set_tracer(tracer) -> None:
    """Install a tracer directly (tests: an InMemoryTracer); None
    disables tracing."""
    global _tracer, _initialized
    _tracer = tracer
    _initialized = True


def current_tracer():
    return _tracer


def active() -> bool:
    """One global check — what the disabled hot path pays."""
    return _tracer is not None


def current_context() -> Optional[TraceContext]:
    """The active span's context on THIS thread (None when tracing is
    off or no span is open) — capture it before handing work to
    another thread, then re-anchor with span(..., parent_ctx=ctx)."""
    if _tracer is None:
        return None
    try:
        return _tracer.current_context()
    except Exception:  # noqa: BLE001 — a custom tracer without contexts
        return None


def current_trace_id() -> str:
    """Hex trace id of the active span ('' when none) — what the
    structured log lines carry (utils/logging_setup.py)."""
    ctx = current_context()
    return ctx.trace_id if ctx is not None else ""


def grpc_metadata() -> Optional[Tuple[Tuple[str, str], ...]]:
    """Outgoing gRPC metadata carrying the current trace context as a
    W3C ``traceparent`` pair, or None when tracing is off / no span is
    active (grpc accepts metadata=None)."""
    ctx = current_context()
    if ctx is None:
        return None
    return (("traceparent", format_traceparent(ctx)),)


def remote_parent_from_metadata(metadata) -> Optional[TraceContext]:
    """Extract a ``traceparent`` context from incoming RPC metadata
    (server side).  None when tracing is off or no valid header is
    present."""
    if _tracer is None or metadata is None:
        return None
    for k, v in metadata:
        if k == "traceparent":
            return parse_traceparent(v)
    return None


@contextlib.contextmanager
def span(
    name: str,
    remote_parent: Optional[TraceContext] = None,
    parent_ctx: Optional[TraceContext] = None,
    **attributes,
) -> Iterator[Optional[object]]:
    """Start a span when tracing is active, else a no-op context.
    `remote_parent` joins an RPC caller's trace; `parent_ctx` anchors
    to a local span on another thread."""
    if _tracer is None:
        yield None
        return
    with _tracer.start_span(
        name, remote_parent=remote_parent, parent_ctx=parent_ctx,
        **attributes,
    ) as s:
        yield s


def add_event(name: str, **attrs) -> None:
    """Attach an event to the current span (no-op when tracing is off
    or no span is open) — degraded answers and circuit-open refusals
    mark themselves this way so the flight recorder can show WHY a
    tail request took the path it took.  Delegates to the backend
    (both the in-memory recorder and the OTel adapter implement
    add_event), so the events reach real exporters, not just tests."""
    if _tracer is None:
        return
    hook = getattr(_tracer, "add_event", None)
    if hook is not None:
        hook(name, **attrs)


def shutdown_tracing() -> None:
    global _tracer, _initialized
    if isinstance(_tracer, _OtelTracer):
        try:
            from opentelemetry import trace

            trace.get_tracer_provider().shutdown()  # type: ignore[attr-defined]
        except Exception:  # noqa: BLE001
            log.exception("tracing shutdown failed")
    _tracer = None
    _initialized = False
