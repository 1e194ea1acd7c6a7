"""Transport-agnostic prediction service: coalesced fleet queries.

A copy of ``repro.serve.service`` over the port's planner: a union
pass is one ``FleetPlanner.sweep`` on the predictor's torch device, so on
the card a cold pass launches the block scorer kernel and a cell-masked
one the row scorer kernel.  Coalesced answers are bitwise equal to the
direct planner call on the analytical paths, as in the reference; across
the packages they agree to float rounding only.

Where the port differs: an engine pass is timed by its thread's CPU
seconds (``time.thread_time``), not the wall clock the reference reads.
The pass model prices admission and the union/split plan from these
samples.  Under a burst the front end's threads decode trace documents
in the same interpreter, and a pass's wall time grows with the queue
for the interpreter lock (tens of times a pass alone), not with its
work.  Fitted from the wall clock, the model can price a sweep above the
whole in-flight budget: it is then refused on an idle worker until its
client gives up, and every refused retry decodes its document again.
The pass's own CPU time counts its Python work and the device waits
its thread spins through, and stays the same under such a burst.

``PredictionService`` sits between a transport (HTTP in
:mod:`repro_torch.serve.http`, or plain Python threads in-process) and the
:class:`~repro_torch.serve.fleet.FleetPlanner` policy layer.  Its job is
**request coalescing**: concurrent rank/sweep queries arriving within a
short window are stacked into ONE ragged ``predict_sweep`` pass instead
of paying one engine dispatch per request.

How a request flows::

    rank()/sweep()/submit_*()  ->  enqueue on the pending list
        the first request of a batch elects a LEADER (a daemon thread):
        it waits out the coalescing window (or until ``flush_at``
        requests queued), takes the whole queue, and executes it;
        waiters block on their handle, non-blocking submitters collect
        results later via ``PendingQuery.get``.
    execute:  stack ALL destination fleets into one deduped union device
              axis -> dedupe traces by fingerprint -> ONE planner.sweep()
              over the union grid -> slice each request's columns out.

Union coalescing (vs the spelling-grouped batcher, retained as
``union_grid=False``): requests no longer need identically-spelled
destination fleets to share an engine pass — subset, superset, and
partially-overlapping fleets all land in the same ragged grid, and the
per-cell math is independent of which columns co-batch, so a sliced
answer still equals the direct planner answer (bitwise on the analytical
paths).  Requests naming unknown devices fail individually at validation
time and never poison the shared grid.

Union/split planning (``split_planner``, default on): the union
rectangle prices (every unique trace) x (every union device), so a batch
of *near-disjoint* fleets pays for cells nobody requested.  Before
committing, the batch is partitioned into connected components (requests
sharing a device or a trace merge) and a cost model — per-pass overhead
and per-op-cell cost, seeded from env knobs and refined from measured
engine passes, with the rectangles discounted by the measured cold
fraction so fully-warm repeat traffic is not split for savings the
result cache already provides — decides between one union pass and k
sub-union passes.  Cell values are independent of co-batching, so the
answer is the same under either plan.

Answer fidelity: the ranking math is :func:`repro_torch.serve.fleet.rank_rows`
— the same function ``FleetPlanner.rank`` uses — and on the analytical
prediction paths a ragged sweep row is bitwise-identical to a solo
``predict_fleet`` call (pinned by the golden-trace suite), so a
coalesced answer equals the direct planner answer bit for bit.
Deduplication also makes cache accounting exact: K concurrent queries
for the same trace cost exactly one miss per unique
(trace, device, config, fleet) key.

Adaptive coalescing (``adaptive_window``, default on): the window is no
longer a fixed constant.  A full queue still closes the batch instantly
(``flush_at``), and the effective window *stretches* toward
``window_max_ms`` while recent batches run well under ``flush_at`` —
light, trickling traffic gets grouped into fewer engine passes — then
collapses back to ``coalesce_window_ms`` as batches fill (heavy traffic
closes on the flush anyway, so a long tail would only tax stragglers).
The rule is the pure function :func:`adaptive_window_ms`.

Admission control (``admission``, default on): the wire-format entry
points (``rank_request``/``sweep_request`` and the asyncio front end in
:mod:`repro_torch.serve.aserver`) price each request in estimated engine
seconds via the SAME fitted cost model the union/split planner uses,
and :class:`~repro_torch.serve.admission.AdmissionController` refuses work
the worker cannot afford — 429/503 with a Retry-After hint instead of
unbounded queueing.  Interactive rank traffic outranks bulk sweeps (see
:mod:`repro_torch.serve.admission`).  In-process callers of
``rank()``/``sweep()``/``submit_*`` bypass admission by design: it is a
front-door policy, not an engine limit.

Wire format: ``rank_request``/``sweep_request`` accept JSON payloads
whose traces are ``TrackedTrace.to_json``/``to_dict`` documents, so any
transport that can move JSON can front this service.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

from repro_torch.core import integrity
from repro_torch.core.batched import env_float, env_int
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve import faults
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.serve.admission import AdmissionController, \
    DeadlineExceeded, Ticket, current_deadline, deadline_scope
from repro_torch.serve.cache import BackendLike
from repro_torch.serve.fleet import FleetChoice, FleetPlanner, rank_rows
from repro_torch.serve.optimizer import OptimizeResult, WhatIfOptimizer, \
    encode_optimize

__all__ = ["PredictionService", "QuarantinedTrace", "adaptive_window_ms"]


def adaptive_window_ms(base_ms: float, max_ms: float, batch_ewma: float,
                       flush_at: int) -> float:
    """Effective coalescing window under the adaptive policy (pure).

    ``batch_ewma`` is an exponential moving average of recent batch
    sizes — the load signal.  Solo traffic (ewma ~ 1) stretches the
    window all the way to ``max_ms`` to collect company; as batches
    approach ``flush_at`` the window collapses linearly back to
    ``base_ms`` (full batches close early on the flush regardless, so a
    stretched window would only delay the requests that *just* miss a
    batch).  ``max_ms`` below ``base_ms`` degenerates to the static
    window — stretching never *shrinks* the configured base, so burst
    benchmarks tuned to a wide static window keep their semantics."""
    hi = max(float(max_ms), float(base_ms))
    span = max(float(flush_at) - 1.0, 1.0)
    fill = min(max((float(batch_ewma) - 1.0) / span, 0.0), 1.0)
    return float(base_ms) + (hi - float(base_ms)) * (1.0 - fill)


class QuarantinedTrace(ValueError):
    """A trace fingerprint is quarantined after repeated engine crashes.

    Raised by :meth:`PredictionService.check_quarantine` at the WIRE
    entry points only (``rank_request`` / ``sweep_request`` /
    ``optimize_request``), before admission — a poison trace must not
    keep buying engine passes that are known to crash.  Front ends
    catch it BEFORE their generic ``ValueError -> 400`` mapping and
    answer a structured **422** carrying the stored failure ``reason``
    and ``retry_after_s`` (the quarantine TTL remainder).  In-process
    callers (``rank``/``sweep``/``optimize``) bypass quarantine the
    same way they bypass admission."""

    def __init__(self, message: str, fingerprint: str = "",
                 reason: str = "", retry_after_s: float = 0.0):
        super().__init__(message)
        self.fingerprint = fingerprint
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class PendingQuery:
    """A submitted query: wait on :meth:`get` (the async-submit handle).

    ``on_done`` is an optional completion hook for event-loop callers
    (the asyncio front end): it fires on the LEADER thread right after
    ``done`` is set, so it must only schedule work (e.g.
    ``loop.call_soon_threadsafe``), never do it.  A callback attached
    after completion is the caller's race to handle — check
    ``done.is_set()`` after assigning (see ``aserver._await_handle``).

    ``deadline`` is an *absolute* ``time.monotonic()`` instant; a query
    whose deadline lapses before its batch answers is **cancelled** —
    :meth:`get` raises :class:`DeadlineExceeded` — while the shared
    engine pass still completes for the other batch members (the
    leader's late ``finish`` finds the query already finalized and
    no-ops).  Exactly one of ``finish``/``cancel`` wins; both are
    idempotent, so the leader racing a cancelling waiter is safe."""
    kind: str                                   # "rank" | "sweep"
    traces: List[TrackedTrace]
    dests: Optional[Tuple[str, ...]]
    batch_size: int = 0
    by: str = "throughput"
    deadline: Optional[float] = None            # absolute monotonic
    #: window-closing reserve (seconds): the leader closes its window
    #: this long BEFORE the deadline so the engine pass itself still
    #: fits in the budget — firing at the deadline instant would turn
    #: every capped window into a guaranteed cancellation race
    exec_reserve_s: float = 0.0
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    on_done: Optional[Callable[["PendingQuery"], None]] = None
    _finalize_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    _finalized: bool = dataclasses.field(default=False, repr=False)

    @property
    def lane(self) -> str:
        """The admission lane this query's kind maps to."""
        return "interactive" if self.kind == "rank" else "bulk"

    def remaining_s(self) -> Optional[float]:
        """Seconds of deadline budget left (``None`` = unbounded)."""
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)

    def get(self, timeout: Optional[float] = None):
        """Block until the batch containing this query executed.

        Waits at most until the query's deadline; a lapsed deadline
        cancels the query (per-query — the batch keeps going) and
        raises :class:`DeadlineExceeded`.  A plain ``timeout`` lapse
        without a deadline raises ``TimeoutError`` and leaves the query
        pending, exactly as before."""
        limit = None if timeout is None else time.monotonic() + timeout
        while not self.done.is_set():
            now = time.monotonic()
            bounds = [b for b in (limit, self.deadline) if b is not None]
            if not bounds:
                self.done.wait()
                break
            if self.done.wait(max(min(bounds) - now, 0.0)):
                break
            now = time.monotonic()
            if self.deadline is not None and now >= self.deadline:
                err = DeadlineExceeded(
                    f"{self.kind} deadline lapsed before the batch "
                    "answered", lane=self.lane)
                if self.cancel(err):
                    raise err
                break       # finish won the race: deliver the answer
            if limit is not None and now >= limit:
                raise TimeoutError(f"{self.kind} query still pending")
        if self.error is not None:
            raise self.error
        return self.result

    def finish(self) -> None:
        """Mark complete and wake waiters (threads AND event loops).

        No-ops if the query was already cancelled — the late engine
        answer must not resurrect a request the caller already gave up
        on (its transport may have moved on or closed)."""
        with self._finalize_lock:
            if self._finalized:
                return
            self._finalized = True
        self._fire()

    def cancel(self, error: BaseException) -> bool:
        """Finalize with ``error`` unless already finished.

        Returns True when this call won (the query is now answered by
        ``error``); False when ``finish``/an earlier ``cancel`` got
        there first.  Used by deadline lapse and client disconnect —
        the leader's eventual ``finish`` then no-ops."""
        with self._finalize_lock:
            if self._finalized:
                return False
            self._finalized = True
            self.error = error
        self._fire()
        return True

    def _fire(self) -> None:
        """Set ``done`` + run ``on_done`` (exactly once, via the flag).

        A broken ``on_done`` hook must not kill the leader thread —
        every other waiter in the batch is still counting on it."""
        self.done.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb(self)
            except BaseException:
                pass


class PredictionService:
    """Coalesce concurrent fleet queries into ragged engine passes.

    Parameters
    ----------
    planner:
        A ready :class:`FleetPlanner`; built from the remaining kwargs
        when omitted.
    predictor / fleet / cache / cache_size:
        Forwarded to :class:`FleetPlanner` (``cache`` accepts a sqlite
        path for the cross-process shared backend).
    coalesce_window_ms:
        How long the first request of a batch waits for company before
        the batch executes.  0 still coalesces whatever queued while a
        previous batch was executing; larger windows trade per-request
        latency for fewer engine passes.
    flush_at:
        Queue length that fires the batch early — lets barrier-style
        bursts (benchmarks, load tests) execute the instant the burst is
        fully queued instead of waiting out the window.
    adaptive_window:
        Stretch the coalescing window toward ``window_max_ms`` while
        recent batches run under ``flush_at`` and collapse it back to
        ``coalesce_window_ms`` as they fill (see
        :func:`adaptive_window_ms`).  ``False`` restores the fixed
        window (kill switch).
    window_max_ms:
        Upper bound of the adaptive stretch; defaults to
        ``REPRO_WINDOW_MAX_MS`` (25.0).  Values below
        ``coalesce_window_ms`` leave the window static.
    admission:
        Front-door admission control (see
        :mod:`repro_torch.serve.admission`).  ``True`` builds an env-seeded
        :class:`AdmissionController`; ``False`` builds one with
        enforcement off (kill switch — counters stay live so ``/stats``
        keeps its shape); a ready controller instance passes through.
        Enforced only on the wire-format entry points
        (``rank_request``/``sweep_request``) and the front ends built on
        them — never on in-process ``rank()``/``sweep()`` calls.
    union_grid:
        Stack heterogeneous destination fleets into one union device
        axis and slice per-request columns out (the default).  ``False``
        restores the grouped batcher that only merged identically-spelled
        fleets — kept as the benchmark baseline and as a kill switch.
    split_planner:
        Cost-model the union rectangle before committing to it (the
        default).  A union pass prices (unique traces) x (union
        devices); when the batch decomposes into request groups that
        share no device and no trace — near-disjoint fleets — the
        rectangle's never-requested cells are pure waste.  The planner
        compares ``k x per-pass-overhead + split cells`` against
        ``per-pass-overhead + rectangle cells`` (constants seeded from
        ``REPRO_SPLIT_PASS_OVERHEAD_MS`` / ``REPRO_SPLIT_CELL_NS``,
        defaults 1.5 ms / 40 ns, then refined from measured engine
        passes) and runs k sub-union passes when the rectangle loses.
        Per-request answers are identical either way — cell values are
        independent of co-batching — so ``False`` (always one union
        pass) is a pure kill switch.
    """

    def __init__(self, planner: Optional[FleetPlanner] = None,
                 predictor=None, fleet: Optional[Sequence[str]] = None,
                 cache: BackendLike = None, cache_size: int = 4096,
                 coalesce_window_ms: float = 5.0, flush_at: int = 64,
                 union_grid: bool = True, split_planner: bool = True,
                 adaptive_window: bool = True,
                 window_max_ms: Optional[float] = None,
                 admission: Union[bool, AdmissionController] = True):
        if planner is None:
            planner = FleetPlanner(predictor=predictor, fleet=fleet,
                                   cache_size=cache_size, cache=cache)
        self.planner = planner
        self.coalesce_window_ms = float(coalesce_window_ms)
        self.flush_at = max(int(flush_at), 1)
        self.union_grid = bool(union_grid)
        self.split_planner = bool(split_planner)
        self.adaptive_window = bool(adaptive_window)
        self.window_max_ms = (env_float("REPRO_WINDOW_MAX_MS", 25.0)
                              if window_max_ms is None
                              else float(window_max_ms))
        if isinstance(admission, AdmissionController):
            self.admission = admission
        else:
            self.admission = AdmissionController(enabled=bool(admission))
        #: default end-to-end deadline for wire requests that carry
        #: neither a ``deadline_ms`` field nor an ``X-Deadline-Ms``
        #: header; 0 (the default) means unbounded
        self.default_deadline_ms = env_float("REPRO_DEADLINE_MS", 0.0)
        #: draining: leaders flush immediately and front ends shed new
        #: work with 503 (see :meth:`drain`)
        self._draining = False
        #: EWMA of recent batch sizes — the adaptive window's load signal
        self._batch_ewma = 1.0
        #: seed constants of the union/split cost model; measured engine
        #: passes refine them online (see ``_pass_model``)
        self.split_pass_overhead_s = env_float(
            "REPRO_SPLIT_PASS_OVERHEAD_MS", 1.5) * 1e-3
        self.split_cell_cost_s = env_float(
            "REPRO_SPLIT_CELL_NS", 40.0) * 1e-9
        self._cond = threading.Condition()
        self._pending: List[PendingQuery] = []
        self._leader_active = False
        self._executing = 0     # batches between snapshot and finish
        # counters (every mutation AND every read happens under
        # self._cond — including the union counters bumped from the
        # leader's _execute, which runs outside the queue lock)
        self._requests = {"rank": 0, "sweep": 0, "optimize": 0}
        self._batches = 0
        self._coalesced_requests = 0    # requests that shared their batch
        self._max_batch = 0
        self._union_batches = 0         # union engine passes executed
        self._sliced_columns = 0        # device columns served by slicing
        self._split_batches = 0         # batches split into sub-unions
        self._split_passes = 0          # sub-union passes those batches ran
        #: per-pass samples (cold op-cells computed, rectangle op-cells,
        #: the pass thread's CPU seconds) — the cost model's time fit uses
        #: the cold cells, the
        #: warmth discount uses the cold/rectangle ratio
        self._pass_samples: List[Tuple[int, int, float]] = []
        # what-if optimizer accounting (the ``/stats`` "optimizer"
        # block, mirroring the admission block): searches served, total
        # generations and engine sweeps those searches ran, candidates
        # priced, and the cell-dedup win — candidate cell references
        # served without engine work
        self._opt_searches = 0
        self._opt_generations = 0
        self._opt_sweeps = 0
        self._opt_candidates = 0
        self._opt_cells_priced = 0
        self._opt_cells_deduped = 0
        # poison-trace quarantine (wire entry only): a fingerprint whose
        # engine execution crashed REPRO_QUARANTINE_THRESHOLD times in a
        # row is refused with a structured 422 until its
        # REPRO_QUARANTINE_TTL_S lapses (threshold 0 disables).  Guarded
        # by its own lock — recording runs on the leader thread's error
        # path, checks run on request threads, and neither may contend
        # on the queue condvar.
        self.quarantine_threshold = env_int("REPRO_QUARANTINE_THRESHOLD", 3)
        self.quarantine_ttl_s = env_float("REPRO_QUARANTINE_TTL_S", 300.0)
        self._quar_lock = threading.Lock()
        self._fail_counts: Dict[str, int] = {}      # fp -> crash streak
        self._quarantined: Dict[str, Tuple[float, str]] = {}
        self._quar_total = 0        # fingerprints ever quarantined
        self._quar_rejected = 0     # wire requests refused with 422
        self._quar_readmitted = 0   # TTL lapses + success-clears
        #: optional :class:`repro_torch.serve.snapshot.SnapshotManager`; the
        #: front ends attach one so ``/stats`` surfaces durability
        self._snapshot: Optional[Any] = None
        # wire-level response cache (REPRO_RESPONSE_CACHE entries, 0 =
        # off): identical request BYTES are answered from the stored
        # response without re-parsing the trace or touching admission or
        # the engine.  Trace decode costs ~10us/op — more than a warm
        # engine pass — so repeat traffic's floor is the transport, not
        # the parser.  Only byte payloads are cached (in-process dict
        # callers skip it); only 200 responses are stored, so a poison
        # trace can never be cached.  Snapshots persist the entries —
        # a restored worker answers repeat traffic at wire speed.
        self.response_cache_max = env_int("REPRO_RESPONSE_CACHE", 0)
        self._resp_lock = threading.Lock()
        self._resp_cache: "OrderedDict[str, str]" = OrderedDict()
        self._resp_hits = 0
        self._resp_misses = 0
        self._resp_restored = 0

    # -- public query API ---------------------------------------------------
    def rank(self, trace: TrackedTrace, batch_size: int,
             by: str = "throughput",
             dests: Optional[Sequence[str]] = None,
             deadline: Optional[float] = None) -> List[FleetChoice]:
        """Coalesced equivalent of ``FleetPlanner.rank`` (same answer)."""
        return self._submit(self.submit_rank(trace, batch_size, by, dests,
                                             deadline=deadline))

    def sweep(self, traces: Sequence[TrackedTrace],
              dests: Optional[Sequence[str]] = None,
              deadline: Optional[float] = None
              ) -> List[Dict[str, float]]:
        """Coalesced equivalent of ``FleetPlanner.sweep`` (same answer)."""
        return self._submit(self.submit_sweep(traces, dests,
                                              deadline=deadline))

    def optimize(self, traces: Sequence[TrackedTrace],
                 batch_sizes: Sequence[int],
                 dests: Optional[Sequence[str]] = None,
                 **knobs) -> OptimizeResult:
        """Run one what-if Pareto search through this service.

        The search's generations ride the coalescer: each generation's
        deduped cell set is ONE ``sweep`` submission, so engine passes
        are bounded by generations and can be shared with concurrent
        traffic (the tests counter-assert the bound).
        ``knobs`` forward to :class:`~repro_torch.serve.optimizer.
        WhatIfOptimizer` (``epoch_samples``, ``max_replicas``,
        ``generation_size``, ``max_generations``, ``frontier_cap``,
        ``seed``)."""
        result = WhatIfOptimizer(self, traces, batch_sizes,
                                 dests=dests, **knobs).run()
        with self._cond:
            self._requests["optimize"] += 1
            self._opt_searches += 1
            self._opt_generations += result.generations
            self._opt_sweeps += result.sweeps
            self._opt_candidates += result.candidates
            self._opt_cells_priced += result.cells_priced
            self._opt_cells_deduped += result.cells_deduped
        return result

    # -- non-blocking submission --------------------------------------------
    def submit_rank(self, trace: TrackedTrace, batch_size: int,
                    by: str = "throughput",
                    dests: Optional[Sequence[str]] = None,
                    deadline: Optional[float] = None) -> PendingQuery:
        """Enqueue a rank query without blocking; ``handle.get()`` waits.

        Lets a transport with its own event loop (or a burst generator)
        keep many queries in flight from one thread — they coalesce
        exactly like queries from concurrent threads.  ``deadline`` is
        an absolute monotonic instant; omitted, it inherits any
        enclosing :func:`~repro_torch.serve.admission.deadline_scope` (so
        e.g. an optimizer search's internal sweeps share the search's
        budget)."""
        if by not in ("throughput", "cost"):    # fail before queueing: a
            # bad request must never poison the batch it would share
            raise ValueError(f"unknown ranking objective {by!r}")
        if deadline is None:
            deadline = current_deadline()
        req = PendingQuery(kind="rank", traces=[trace],
                           dests=tuple(dests) if dests is not None else None,
                           batch_size=int(batch_size), by=by,
                           deadline=deadline)
        if deadline is not None:
            req.exec_reserve_s = self._deadline_reserve_s([trace], dests)
        self._enqueue(req)
        return req

    def submit_sweep(self, traces: Sequence[TrackedTrace],
                     dests: Optional[Sequence[str]] = None,
                     deadline: Optional[float] = None) -> PendingQuery:
        """Enqueue a sweep query without blocking; ``handle.get()`` waits."""
        traces = list(traces)
        if not traces:
            raise ValueError("sweep needs at least one trace")
        if deadline is None:
            deadline = current_deadline()
        req = PendingQuery(kind="sweep", traces=traces,
                           dests=tuple(dests) if dests is not None else None,
                           deadline=deadline)
        if deadline is not None:
            req.exec_reserve_s = self._deadline_reserve_s(traces, dests)
        self._enqueue(req)
        return req

    # -- wire format --------------------------------------------------------
    @staticmethod
    def _trace_from_wire(doc: Union[str, Dict]) -> TrackedTrace:
        """Decode one trace from its JSON wire spelling (str or dict)."""
        if isinstance(doc, str):
            return TrackedTrace.from_json(doc)
        return TrackedTrace.from_dict(doc)

    def decode_rank(self, payload: Union[str, Dict]
                    ) -> Tuple[TrackedTrace, int, str, Optional[List]]:
        """Decode a wire rank payload -> (trace, batch_size, by, dests).

        Shared by the threaded and asyncio front ends so both validate
        (and 400) identically; malformed payloads raise
        KeyError/ValueError/TypeError *here*, before admission or
        queueing."""
        p = json.loads(payload) if isinstance(payload, str) else payload
        return (self._trace_from_wire(p["trace"]), int(p["batch_size"]),
                p.get("by", "throughput"), p.get("dests"))

    def decode_sweep(self, payload: Union[str, Dict]
                     ) -> Tuple[List[TrackedTrace], Optional[List]]:
        """Decode a wire sweep payload -> (traces, dests)."""
        p = json.loads(payload) if isinstance(payload, str) else payload
        return ([self._trace_from_wire(t) for t in p["traces"]],
                p.get("dests"))

    @classmethod
    def encode_rank(cls, trace: TrackedTrace, choices: List[FleetChoice]
                    ) -> Dict:
        """Rank answer as its wire document (``{"label", "ranking"}``)."""
        return {"label": trace.label,
                "ranking": [cls._wire_choice(c) for c in choices]}

    @staticmethod
    def encode_sweep(traces: Sequence[TrackedTrace],
                     rows: List[Dict[str, float]]) -> Dict:
        """Sweep answer as its wire document (``{"labels", "times"}``)."""
        return {"labels": [t.label for t in traces], "times": rows}

    def resolve_deadline(self, payload: Optional[Dict] = None,
                         header_ms: Optional[float] = None
                         ) -> Optional[float]:
        """Resolve a request's deadline to an absolute monotonic instant.

        Precedence: the payload's ``deadline_ms`` field, then the
        transport's ``X-Deadline-Ms`` header (``header_ms``), then the
        ``REPRO_DEADLINE_MS`` default.  All are *relative* milliseconds
        of budget from now; ``None``/0/negative means unbounded."""
        ms: Optional[float] = None
        if payload is not None and payload.get("deadline_ms") is not None:
            ms = float(payload["deadline_ms"])
        elif header_ms is not None:
            ms = float(header_ms)
        elif self.default_deadline_ms > 0:
            ms = self.default_deadline_ms
        if ms is None or ms <= 0:
            return None
        return time.monotonic() + ms / 1e3

    # -- wire-level response cache ------------------------------------------
    def response_key(self, kind: str,
                     payload: Union[str, bytes, Dict]) -> Optional[str]:
        """Cache key for a wire payload, or ``None`` when uncacheable.

        Only raw byte/str payloads are keyed — hashing them is ~1us/KB,
        while canonicalizing a decoded dict would cost as much as the
        decode the cache exists to skip.  The endpoint name is part of
        the key so ``/rank`` and ``/sweep`` bodies can never collide."""
        if self.response_cache_max <= 0 or self._draining:
            return None
        if isinstance(payload, str):
            payload = payload.encode("utf-8", "surrogatepass")
        elif not isinstance(payload, bytes):
            return None
        return kind + ":" + hashlib.sha256(payload).hexdigest()

    def response_lookup(self, key: Optional[str]) -> Optional[Dict]:
        """Stored response for ``key`` (decoded fresh), or ``None``."""
        if key is None:
            return None
        with self._resp_lock:
            hit = self._resp_cache.get(key)
            if hit is None:
                self._resp_misses += 1
                return None
            self._resp_cache.move_to_end(key)
            self._resp_hits += 1
        # decode a fresh copy per hit: callers may mutate the dict, and
        # a shared reference would let one request corrupt another's
        return json.loads(hit)

    def response_store(self, key: Optional[str], result: Dict) -> None:
        """Store a successful response under ``key`` (LRU-bounded)."""
        if key is None:
            return
        try:
            encoded = json.dumps(result)
        except (TypeError, ValueError):
            return      # non-JSON-serializable: transports would have
            # failed to emit it anyway; never let caching raise
        with self._resp_lock:
            self._resp_cache[key] = encoded
            self._resp_cache.move_to_end(key)
            while len(self._resp_cache) > self.response_cache_max:
                self._resp_cache.popitem(last=False)

    def export_response_cache(self) -> List[Tuple[str, str]]:
        """Entries as ``(key, encoded_response)`` pairs, LRU order."""
        with self._resp_lock:
            return list(self._resp_cache.items())

    def import_response_cache(self, entries: Sequence[Tuple[str, str]]
                              ) -> int:
        """Restore exported entries (snapshot restore path).

        Malformed entries are dropped one by one — a half-bad snapshot
        still restores its good half.  Returns the count restored."""
        if self.response_cache_max <= 0:
            return 0    # cache disabled here: snapshot may carry entries
            # written under a different configuration
        n = 0
        for pair in entries:
            try:
                key, encoded = pair
                if not (isinstance(key, str) and isinstance(encoded, str)):
                    continue
                json.loads(encoded)     # must decode, or the hit would
                # raise at serve time — reject it here instead
            except Exception:
                continue
            with self._resp_lock:
                self._resp_cache[key] = encoded
                while len(self._resp_cache) > max(self.response_cache_max,
                                                  0):
                    self._resp_cache.popitem(last=False)
            n += 1
        with self._resp_lock:
            self._resp_restored += n
        return n

    def response_cache_stats(self) -> Dict:
        """The ``/stats`` ``response_cache`` block."""
        with self._resp_lock:
            return {"max_entries": self.response_cache_max,
                    "entries": len(self._resp_cache),
                    "hits": self._resp_hits,
                    "misses": self._resp_misses,
                    "restored_entries": self._resp_restored}

    def rank_request(self, payload: Union[str, Dict],
                     deadline_ms: Optional[float] = None) -> Dict:
        """Serve one wire-format rank query (admission applies).

        Payload: ``{"trace": <to_dict() doc or to_json() str>,
        "batch_size": int, "by"?: "throughput"|"cost",
        "dests"?: [device, ...], "deadline_ms"?: float}``.  Returns
        ``{"label", "ranking"}`` where ranking rows are ``FleetChoice``
        dicts, best first.  Raises
        :class:`~repro_torch.serve.admission.AdmissionError` when the
        admission controller sheds the request (transports map it to
        429/503 + Retry-After) and
        :class:`~repro_torch.serve.admission.DeadlineExceeded` (504) when the
        deadline budget is blown at admission or delivery."""
        rkey = self.response_key("rank", payload)
        cached = self.response_lookup(rkey)
        if cached is not None:
            return cached
        p = json.loads(payload) if isinstance(payload, str) else payload
        trace, batch_size, by, dests = self.decode_rank(p)
        self.check_quarantine([trace])
        deadline = self.resolve_deadline(p, deadline_ms)
        ticket = self.admit_request("rank", [trace], dests,
                                    deadline=deadline)
        try:
            choices = self.rank(trace, batch_size, by=by, dests=dests,
                                deadline=deadline)
        except DeadlineExceeded:
            self.admission.record_deadline_shed(ticket.lane)
            raise
        finally:
            self.admission.release(ticket)
        out = self.encode_rank(trace, choices)
        self.response_store(rkey, out)
        return out

    @staticmethod
    def _wire_choice(choice: FleetChoice) -> Dict:
        """FleetChoice as a strictly-JSON-safe dict.

        A free device's samples/$ is ``float("inf")`` (see
        ``cost_normalized_throughput``), which ``json.dumps`` would emit
        as the RFC-8259-invalid token ``Infinity`` — strict parsers
        (browsers, jq, Go) reject the whole body.  The wire spelling is
        the string ``"Infinity"``; ``PredictionClient`` decodes it back."""
        d = dataclasses.asdict(choice)
        if d["cost_normalized"] == float("inf"):
            d["cost_normalized"] = "Infinity"
        return d

    def decode_optimize(self, payload: Union[str, Dict]
                        ) -> Tuple[List[TrackedTrace], List[int],
                                   Optional[List], Dict]:
        """Decode a wire optimize payload.

        Returns ``(traces, batch_sizes, dests, knobs)`` where ``knobs``
        holds only the recognized search parameters — unknown keys are
        ignored so clients can pin newer knobs without breaking older
        servers.  Shape errors (missing keys, misaligned lists, bad
        numbers) raise KeyError/ValueError/TypeError here, before
        admission or any engine work."""
        p = json.loads(payload) if isinstance(payload, str) else payload
        traces = [self._trace_from_wire(t) for t in p["traces"]]
        batch_sizes = [int(b) for b in p["batch_sizes"]]
        knobs = {k: p[k] for k in ("epoch_samples", "max_replicas",
                                   "generation_size", "max_generations",
                                   "frontier_cap", "seed") if k in p}
        return traces, batch_sizes, p.get("dests"), knobs

    def optimize_request(self, payload: Union[str, Dict],
                         deadline_ms: Optional[float] = None) -> Dict:
        """Serve one wire-format what-if search (bulk-lane admission).

        Payload: ``{"traces": [<trace doc>, ...], "batch_sizes":
        [int, ...], "dests"?: [...], "epoch_samples"?, "max_replicas"?,
        "generation_size"?, "max_generations"?, "frontier_cap"?,
        "seed"?}``.  Returns ``{"frontier": [...], "search": {...}}``
        (see :func:`repro_torch.serve.optimizer.encode_optimize`).  Admission
        prices the full traces x devices cell rectangle — an upper
        bound on every generation's engine work, since cells are priced
        at most once per search.  Raises
        :class:`~repro_torch.serve.admission.AdmissionError` when shed."""
        rkey = self.response_key("optimize", payload)
        cached = self.response_lookup(rkey)
        if cached is not None:
            return cached
        p = json.loads(payload) if isinstance(payload, str) else payload
        traces, batch_sizes, dests, knobs = self.decode_optimize(p)
        self.check_quarantine(traces)
        deadline = self.resolve_deadline(p, deadline_ms)
        ticket = self.admit_request("optimize", traces, dests,
                                    deadline=deadline)
        try:
            # the scope makes every generation's internal sweep inherit
            # the search's remaining budget (submit_* pick it up)
            with deadline_scope(deadline):
                result = self.optimize(traces, batch_sizes, dests=dests,
                                       **knobs)
        except DeadlineExceeded:
            self.admission.record_deadline_shed(ticket.lane)
            raise
        finally:
            self.admission.release(ticket)
        out = encode_optimize(result)
        self.response_store(rkey, out)
        return out

    def sweep_request(self, payload: Union[str, Dict],
                      deadline_ms: Optional[float] = None) -> Dict:
        """Serve one wire-format sweep query (bulk-lane admission).

        Payload: ``{"traces": [<trace doc>, ...], "dests"?: [...],
        "deadline_ms"?: float}``.  Returns ``{"labels": [...], "times":
        [{device: ms}, ...]}`` in input trace order.  Raises
        :class:`~repro_torch.serve.admission.AdmissionError` when shed and
        :class:`~repro_torch.serve.admission.DeadlineExceeded` when the
        deadline budget is blown."""
        rkey = self.response_key("sweep", payload)
        cached = self.response_lookup(rkey)
        if cached is not None:
            return cached
        p = json.loads(payload) if isinstance(payload, str) else payload
        traces, dests = self.decode_sweep(p)
        self.check_quarantine(traces)
        deadline = self.resolve_deadline(p, deadline_ms)
        ticket = self.admit_request("sweep", traces, dests,
                                    deadline=deadline)
        try:
            rows = self.sweep(traces, dests=dests, deadline=deadline)
        except DeadlineExceeded:
            self.admission.record_deadline_shed(ticket.lane)
            raise
        finally:
            self.admission.release(ticket)
        out = self.encode_sweep(traces, rows)
        self.response_store(rkey, out)
        return out

    # -- admission ----------------------------------------------------------
    def estimate_cost_s(self, traces: Sequence[TrackedTrace],
                        dests: Optional[Sequence[str]] = None) -> float:
        """Estimated engine cost (seconds) of one request.

        The SAME fitted model the union/split planner prices passes
        with: per-pass overhead + (op-cells x per-cell cost), discounted
        by the measured cold fraction so warm repeat traffic is priced
        near the pass overhead alone.  Conservative by construction —
        it charges a full pass overhead even though a coalesced request
        usually shares one — because admission must bound the worst
        case, not the average.

        Where the port differs: a request whose every cell the result
        cache holds runs no engine work of its own, and is priced at the
        median of the recent passes that computed no cell (the reference
        prices it as above, so on the card, where the fitted overhead of
        a pass under a burst is tens to hundreds of milliseconds, a warm
        burst was shed)."""
        warm_s = [s[2] for s in self.export_pass_samples() if not s[0]]
        try:
            if warm_s and self.planner.sweep_cached(traces, dests):
                return float(statistics.median(warm_s))
        except Exception:       # a malformed trace is priced below
            pass
        c_pass, c_cell = self._pass_model()
        n_dests = (len(dests) if dests is not None
                   else len(self.planner.fleet))
        ops = 0
        for t in traces:
            try:
                ops += t.to_arrays().n_ops
            except Exception:   # a malformed trace still costs *something*;
                ops += len(getattr(t, "ops", ()))  # let validation 400 it
        return c_pass + self._warm_discount() * ops * n_dests * c_cell

    def _deadline_reserve_s(self, traces: Sequence[TrackedTrace],
                            dests: Optional[Sequence[str]] = None) -> float:
        """Window-closing reserve for a deadlined query (seconds).

        The leader must close its coalescing window this long before
        the query's deadline so the engine pass still fits inside the
        budget.  The estimate is the same fitted pass model admission
        prices with, floored at 10 ms: scheduling jitter between the
        leader finishing and the deadline waiter waking is real, and a
        reserve below it makes every tight deadline a coin flip."""
        try:
            est = self.estimate_cost_s(traces, dests)
        except Exception:       # an unpriceable trace still gets the floor
            est = 0.0
        return max(est, 0.010)

    def admit_request(self, kind: str,
                      traces: Sequence[TrackedTrace],
                      dests: Optional[Sequence[str]] = None,
                      deadline: Optional[float] = None) -> Ticket:
        """Price one front-door request and reserve admission budget.

        ``kind`` maps to the priority lane: "rank" -> interactive,
        anything else -> bulk.  Returns the ticket to release when the
        request finishes; raises
        :class:`~repro_torch.serve.admission.AdmissionError` when shed.

        With a ``deadline`` (absolute monotonic), a request whose
        *projected* engine cost already exceeds the remaining budget is
        shed instantly with :class:`DeadlineExceeded` (504) — queueing
        work the caller will never read only steals capacity from
        requests that can still make their deadlines."""
        lane = "interactive" if kind == "rank" else "bulk"
        cost_s = self.estimate_cost_s(traces, dests)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if cost_s > remaining:
                self.admission.record_deadline_shed(lane)
                raise DeadlineExceeded(
                    f"projected cost {cost_s:.3f}s exceeds remaining "
                    f"deadline budget {max(remaining, 0.0):.3f}s",
                    lane=lane, remaining_s=max(remaining, 0.0))
        return self.admission.admit(lane, cost_s)

    # -- poison-trace quarantine --------------------------------------------
    def check_quarantine(self, traces: Sequence[TrackedTrace]) -> None:
        """Refuse wire requests that reference a quarantined fingerprint.

        Called by the three ``*_request`` entry points after decode and
        before admission.  A lapsed TTL re-admits the fingerprint with
        ONE strike left — a still-poisonous trace re-quarantines on its
        next crash instead of buying a fresh run of N."""
        if self.quarantine_threshold <= 0:
            return
        now = time.monotonic()
        with self._quar_lock:
            for t in traces:
                fp = t.fingerprint()
                entry = self._quarantined.get(fp)
                if entry is None:
                    continue
                until, reason = entry
                if now >= until:
                    del self._quarantined[fp]
                    self._fail_counts[fp] = self.quarantine_threshold - 1
                    self._quar_readmitted += 1
                    continue
                self._quar_rejected += 1
                raise QuarantinedTrace(
                    f"trace {fp[:12]} is quarantined for another "
                    f"{until - now:.0f}s after repeated engine failures "
                    f"({reason})",
                    fingerprint=fp, reason=reason,
                    retry_after_s=until - now)

    def _record_trace_failure(self, trace: TrackedTrace,
                              error: BaseException) -> None:
        """Count one engine crash against a trace's fingerprint.

        Fed from the per-query isolation fallback (``_execute_singly``),
        where blame is as narrow as the engine can assign it: a
        multi-trace sweep that crashes strikes all its traces, but
        innocents recover because any later success clears the streak."""
        if self.quarantine_threshold <= 0:
            return
        try:
            fp = trace.fingerprint()
        except Exception:       # unfingerprintable -> can't track it
            return
        reason = f"{type(error).__name__}: {error}"[:500]
        with self._quar_lock:
            n = self._fail_counts.get(fp, 0) + 1
            self._fail_counts[fp] = n
            if (n >= self.quarantine_threshold
                    and fp not in self._quarantined):
                self._quarantined[fp] = (
                    time.monotonic() + self.quarantine_ttl_s, reason)
                self._quar_total += 1

    def _record_trace_success(self, traces: Sequence[TrackedTrace]) -> None:
        """A successful engine pass clears its traces' crash streaks
        (and lifts any quarantine early — in-process callers bypass the
        wire check, so their successes are the recovery signal)."""
        if self.quarantine_threshold <= 0:
            return
        if not self._fail_counts and not self._quarantined:
            return              # racy peek is fine: worst case we lock
        with self._quar_lock:
            for t in traces:
                fp = t.fingerprint()
                self._fail_counts.pop(fp, None)
                if self._quarantined.pop(fp, None) is not None:
                    self._quar_readmitted += 1

    def quarantine_stats(self) -> Dict:
        """The ``/stats`` ``quarantine`` block (always present)."""
        with self._quar_lock:
            return {"enabled": self.quarantine_threshold > 0,
                    "threshold": self.quarantine_threshold,
                    "ttl_s": self.quarantine_ttl_s,
                    "active": len(self._quarantined),
                    "tracked_failures": len(self._fail_counts),
                    "quarantined_total": self._quar_total,
                    "rejected": self._quar_rejected,
                    "readmitted": self._quar_readmitted}

    # -- durable warm state --------------------------------------------------
    def attach_snapshot(self, manager: Any) -> None:
        """Attach a :class:`repro_torch.serve.snapshot.SnapshotManager` so the
        ``/stats`` ``snapshot`` block reports it (done by its ctor)."""
        self._snapshot = manager

    def export_pass_samples(self) -> List[Tuple[int, int, float]]:
        """Snapshot hook: the fitted split-planner model's samples."""
        with self._cond:
            return list(self._pass_samples)

    def import_pass_samples(self, samples: Sequence) -> int:
        """Restore hook: seed the split-planner pass model from a
        snapshot so a restarted worker prices/splits like its
        predecessor instead of re-learning from scratch."""
        cleaned = [(int(c), int(r), float(s)) for c, r, s in samples]
        with self._cond:
            self._pass_samples = cleaned[-64:]
        return len(cleaned)

    def stats(self) -> Dict:
        """Service + cache accounting (the ``/stats`` payload).

        Every coalescing counter is snapshot under the queue lock in one
        critical section — the leader thread increments them under the
        same lock (including the union counters, bumped from
        ``_execute`` which otherwise runs unlocked), so a reader can
        never observe a torn batch (e.g. ``union_batches`` ahead of
        ``batches``).  The engine-pass counter is read under the
        planner's own lock for the same reason."""
        with self._cond:
            requests = dict(self._requests)
            coalescing = {
                "batches": self._batches,
                "coalesced_requests": self._coalesced_requests,
                "max_batch": self._max_batch,
                "union_batches": self._union_batches,
                "sliced_columns": self._sliced_columns,
                "split_batches": self._split_batches,
                "split_passes": self._split_passes,
                "window_ms": self.coalesce_window_ms,
                "window_max_ms": self.window_max_ms,
                "adaptive_window": self.adaptive_window,
                "batch_ewma": round(self._batch_ewma, 3),
                "flush_at": self.flush_at,
                "union_grid": self.union_grid,
                "split_planner": self.split_planner,
                "executing": self._executing,
            }
            optimizer = {
                "optimize_searches": self._opt_searches,
                "optimize_generations": self._opt_generations,
                "optimize_sweeps": self._opt_sweeps,
                "optimize_candidates": self._opt_candidates,
                "optimize_cells_priced": self._opt_cells_priced,
                "optimize_cells_deduped": self._opt_cells_deduped,
            }
            n_samples = len(self._pass_samples)
        coalescing["effective_window_ms"] = round(
            self.effective_window_ms(), 3)
        c_pass, c_cell = self._pass_model()
        cache = self.planner.stats.as_dict()
        cache["backend"] = self.planner.cache.describe()
        cache["entries"] = len(self.planner.cache)
        # network backends expose the server's GLOBAL cross-worker
        # accounting alongside this worker's local counters (None while
        # the server is unreachable — the block says so rather than
        # vanishing, so dashboards can alert on it)
        server_stats = getattr(self.planner.cache, "server_stats", None)
        if callable(server_stats):
            cache["netcache"] = server_stats()
            # breaker observability: closed | open | half_open — "open"
            # here is what a netcache=None block looks like from the
            # client's side, so dashboards can tell outage from idle
            cache["breaker_state"] = getattr(self.planner.cache,
                                             "breaker_state", "closed")
        return {"requests": requests, "coalescing": coalescing,
                "engine_passes": self.planner.engine_pass_count(),
                "split_model": {"pass_overhead_ms": c_pass * 1e3,
                                "cell_cost_ns": c_cell * 1e9,
                                "warm_discount": self._warm_discount(),
                                "samples": n_samples},
                "admission": self.admission.stats(),
                "optimizer": optimizer,
                "cache": cache,
                "response_cache": self.response_cache_stats(),
                "engine_caches": self.planner.engine_cache_stats(),
                "fleet": self.planner.fleet,
                "draining": self._draining,
                "integrity": integrity.COUNTERS.stats(),
                "quarantine": self.quarantine_stats(),
                "snapshot": (self._snapshot.stats()
                             if self._snapshot is not None
                             else snapshot_mod.empty_stats()),
                "faults": faults.stats()}

    # -- coalescing core ----------------------------------------------------
    def _enqueue(self, req: PendingQuery) -> None:
        """Queue a request; the first request of a batch elects a leader.

        The leader runs on its own daemon thread so non-blocking
        submitters return immediately; a blocking caller simply waits on
        the handle like everyone else."""
        with self._cond:
            self._pending.append(req)
            self._requests[req.kind] += 1
            if len(self._pending) >= self.flush_at:
                self._cond.notify_all()
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            threading.Thread(target=self._lead_batch, daemon=True).start()

    @staticmethod
    def _submit(req: PendingQuery):
        return req.get()

    def _lead_batch(self) -> None:
        """Leader: wait out the window, take the queue, execute it.

        ``_leader_active`` flips off under the same lock that snapshots
        the queue, so a request arriving mid-execution starts the NEXT
        batch (with itself as leader) instead of being dropped.

        The wait is capped by the tightest pending *deadline*: the
        adaptive window may stretch for company, but never past the
        instant a queued request's budget — minus its execution reserve
        (the estimated cost of the pass it will join) — lapses.
        Stretching past that would turn a meetable deadline into a
        guaranteed 504: a window that closes AT the deadline leaves the
        pass itself no budget at all.  Draining also cuts the wait — a
        shutting-down worker flushes what it has now."""
        window_end = time.monotonic() + self.effective_window_ms() / 1e3
        with self._cond:
            while len(self._pending) < self.flush_at:
                if self._draining:
                    break
                end = window_end
                for q in self._pending:
                    if q.deadline is None:
                        continue
                    cut = q.deadline - q.exec_reserve_s
                    if cut < end:
                        end = cut
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch, self._pending = self._pending, []
            self._leader_active = False
            self._executing += 1
            self._batches += 1
            self._max_batch = max(self._max_batch, len(batch))
            if len(batch) > 1:
                self._coalesced_requests += len(batch)
            # the adaptive window's load signal: EWMA over batch sizes
            # (alpha 0.3 — a handful of batches to adapt, so one odd
            # batch cannot whip the window around)
            self._batch_ewma += 0.3 * (len(batch) - self._batch_ewma)
        try:
            self._execute(batch)
        finally:
            with self._cond:
                self._executing -= 1
                self._cond.notify_all()     # wake a waiting drain()

    def effective_window_ms(self) -> float:
        """The window the NEXT leader will wait (adaptive or static)."""
        if not self.adaptive_window:
            return self.coalesce_window_ms
        with self._cond:
            ewma = self._batch_ewma
        return adaptive_window_ms(self.coalesce_window_ms,
                                  self.window_max_ms, ewma, self.flush_at)

    # -- graceful drain ------------------------------------------------------
    @property
    def draining(self) -> bool:
        """True once :meth:`drain` began — front ends shed new work."""
        return self._draining

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Flush in-flight coalescing windows and wait for quiescence.

        Sets the draining flag (front ends consult it to shed new work
        with 503 + Retry-After), wakes every waiting leader so open
        windows close *now* instead of stretching for company, then
        waits until no request is pending and no leader is running.
        Returns True on quiescence, False on timeout.  Idempotent —
        a second SIGTERM just re-waits."""
        limit = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._pending or self._leader_active or self._executing:
                remaining = (None if limit is None
                             else limit - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                # executing leaders notify on finish; the short cap
                # covers the snapshot gap (leader off, execute not yet
                # counted) without a busy loop
                self._cond.wait(0.05 if remaining is None
                                else min(remaining, 0.05))
            return True

    def _execute(self, batch: List[PendingQuery]) -> None:
        """Union-grid engine pass(es) for the whole batch.

        All requests' destination fleets are stacked into one deduped
        union device axis and all traces are deduplicated by fingerprint,
        so K concurrent queries — however heterogeneous their fleets —
        cost ONE ragged ``planner.sweep`` and exactly one cache miss per
        unique (trace, device, config, fleet) key.  Before committing,
        the union/split cost model (``_plan_groups``) may carve a
        near-disjoint batch into a few sub-union passes instead of
        paying the full rectangle.  Each request's answer is sliced back
        out of its pass's union row; cell values are independent of
        which columns co-batched, so the slice equals the direct planner
        answer (bitwise on the analytical paths) under any plan."""
        if not self.union_grid:
            return self._execute_grouped(batch)
        resolved = self._resolve_batch(batch)
        if not resolved:
            return
        try:
            groups = self._plan_groups(resolved)
        except BaseException:
            # planning is advisory — it touches every trace's
            # fingerprint/arrays, and a trace that fails there must flow
            # into the union pass's error-isolation path (which answers
            # the healthy requests and errors the culprit), never kill
            # the leader with every waiter's done-event unset
            groups = [resolved]
        if len(groups) > 1:
            with self._cond:
                self._split_batches += 1
                self._split_passes += len(groups)
        for group in groups:
            self._union_pass(group)

    def _resolve_batch(self, batch: List[PendingQuery]
                       ) -> List[Tuple[PendingQuery, List[str]]]:
        """Resolve each request's destination list, failing bad requests
        individually so they never poison the shared grid."""
        from repro_torch.core import devices

        fleet: Optional[List[str]] = None
        resolved: List[Tuple[PendingQuery, List[str]]] = []
        for req in batch:
            try:
                if req.dests is None:
                    if fleet is None:
                        fleet = self.planner.fleet
                    dlist = fleet
                else:
                    for name in req.dests:  # unknown devices fail THIS
                        devices.get(name)   # request, not the shared grid
                    dlist = list(req.dests)
                resolved.append((req, dlist))
            except BaseException as e:
                req.error = e
                req.finish()
        return resolved

    # -- union/split cost model ---------------------------------------------
    def _plan_groups(self, resolved: List[Tuple[PendingQuery, List[str]]]
                     ) -> List[List[Tuple[PendingQuery, List[str]]]]:
        """Split a near-disjoint batch into sub-union passes when the
        rectangle loses.

        Requests sharing a device or a trace are merged (union-find):
        within a connected component the union rectangle wastes nothing
        a smaller split would save, and across components every
        (trace, device) cell of the joint rectangle that crosses a
        component boundary is work nobody asked for.  The decision
        prices both plans in op-cells (rows x columns of the ragged
        grid actually computed) against the measured per-pass overhead:
        splitting pays one extra engine pass per component, the
        rectangle pays the cross-component fill."""
        if not self.split_planner or len(resolved) < 2:
            return [resolved]
        parent = list(range(len(resolved)))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        owner: Dict[Tuple[str, str], int] = {}
        for i, (req, dlist) in enumerate(resolved):
            for name in dlist:
                j = owner.setdefault(("dev", name), i)
                parent[find(i)] = find(j)
            for t in req.traces:
                j = owner.setdefault(("trace", t.fingerprint()), i)
                parent[find(i)] = find(j)
        components: Dict[int, List[Tuple[PendingQuery, List[str]]]] = {}
        for i, item in enumerate(resolved):
            components.setdefault(find(i), []).append(item)
        if len(components) == 1:
            return [resolved]

        def rect_cells(items) -> int:
            ops: Dict[str, int] = {}
            devs = set()
            for req, dlist in items:
                devs.update(dlist)
                for t in req.traces:
                    ops[t.fingerprint()] = t.to_arrays().n_ops
            return sum(ops.values()) * len(devs)

        parts = list(components.values())
        c_pass, c_cell = self._pass_model()
        # discount the rectangles by the measured cold fraction: with
        # cell-level cache fills, warm cells cost nothing under either
        # plan, so a fully-warm repeat burst must not be split for a
        # compute saving that does not exist (the extra pass overhead is
        # real either way)
        discount = self._warm_discount()
        cost_union = c_pass + rect_cells(resolved) * discount * c_cell
        cost_split = (len(parts) * c_pass
                      + sum(rect_cells(p) for p in parts)
                      * discount * c_cell)
        return parts if cost_split < cost_union else [resolved]

    def _warm_discount(self) -> float:
        """Recent cold fraction of rectangle op-cells, in [0.1, 1.0].

        1.0 (everything cold) with no history — right for a fresh
        worker; floored at 0.1 so a long warm streak cannot blind the
        planner to a traffic shift (the first cold rectangles it then
        pays re-raise the fraction)."""
        with self._cond:
            cold = sum(s[0] for s in self._pass_samples)
            rect = sum(s[1] for s in self._pass_samples)
        if rect <= 0:
            return 1.0
        return min(max(cold / rect, 0.1), 1.0)

    def _pass_model(self) -> Tuple[float, float]:
        """(per-pass overhead s, per-op-cell s) of one engine pass.

        Seeded from the env-configurable constants, then refined by a
        least-squares fit over the (op-cells, CPU seconds) samples recorded
        around every executed engine pass — the same pass granularity
        ``engine_passes`` counts.  The fit only replaces the seeds when
        BOTH terms come out positive: intercept and slope come from one
        regression, and adopting an intercept inflated by a rejected
        negative slope (or vice versa) would price passes with an
        internally inconsistent model — noisy bursts must not make every
        split look free or every pass look ruinous."""
        with self._cond:
            samples = list(self._pass_samples)
        a, b = self.split_pass_overhead_s, self.split_cell_cost_s
        if len(samples) >= 8:
            n = len(samples)
            mx = sum(s[0] for s in samples) / n
            mt = sum(s[2] for s in samples) / n
            var = sum((s[0] - mx) ** 2 for s in samples) / n
            if var > 0:
                cov = sum((s[0] - mx) * (s[2] - mt) for s in samples) / n
                b_fit = cov / var
                a_fit = mt - b_fit * mx
                if b_fit > 0 and a_fit > 0:
                    a, b = a_fit, b_fit
        return a, b

    def _record_pass(self, cold_cells: int, rect_cells: int,
                     seconds: float) -> None:
        with self._cond:
            self._pass_samples.append((int(cold_cells), int(rect_cells),
                                       float(seconds)))
            if len(self._pass_samples) > 64:
                del self._pass_samples[0]

    def _union_pass(self,
                    resolved: List[Tuple[PendingQuery, List[str]]]) -> None:
        """One union engine pass over a (sub-)batch: dedupe traces, sweep
        the union fleet, slice each request's columns back out."""
        union: List[str] = []
        seen = set()
        for _, dlist in resolved:
            for name in dlist:
                if name not in seen:
                    seen.add(name)
                    union.append(name)
        try:
            uniq: Dict[str, TrackedTrace] = {}
            for req, _ in resolved:
                for t in req.traces:
                    uniq.setdefault(t.fingerprint(), t)
            order = list(uniq)
            miss0 = self.planner.stats.misses
            # bind the tightest member deadline for the pass: deep
            # layers (netcache, router) derive socket timeouts from it,
            # degrading to a local compute instead of blocking past the
            # budget.  The scope never aborts the sweep itself — the
            # pass still completes for every member.
            scope = None
            for req, _ in resolved:
                if req.deadline is not None and (scope is None
                                                 or req.deadline < scope):
                    scope = req.deadline
            faults.inject("engine.pass")
            t0 = time.thread_time()     # the pass's own CPU seconds
            with deadline_scope(scope):
                rows = self.planner.sweep([uniq[fp] for fp in order],
                                          dests=union)
            dt = time.thread_time() - t0
            # credit the sample with the op-cells actually COMPUTED, not
            # the full rectangle: with cell-level cache fills a warm pass
            # computes almost nothing, and pricing it as the rectangle
            # would fit the per-cell cost toward zero and stop the
            # planner from ever splitting genuinely cold bursts.  The
            # result-cache miss delta counts the cold (trace, device)
            # pairs; scale to op-cells by the mean segment length.  The
            # delta is over a shared counter, so a concurrently executing
            # leader's misses can land inside this window — the clamp to
            # the pass's own rectangle bounds that cross-attribution, and
            # the positive-fit guard in _pass_model tolerates the
            # remaining noise.
            total_pairs = len(order) * len(union)
            cold_pairs = min(max(self.planner.stats.misses - miss0, 0),
                             total_pairs)
            rect_cells = (sum(uniq[fp].to_arrays().n_ops for fp in order)
                          * len(union))
            cells = (rect_cells * cold_pairs // total_pairs
                     if total_pairs else 0)
            self._record_pass(cells, rect_cells, dt)
            by_fp = dict(zip(order, rows))
            sliced = 0
            for req, dlist in resolved:
                if len(dlist) != len(union):
                    sliced += len(dlist)
                if req.kind == "rank":
                    t = req.traces[0]
                    row = by_fp[t.fingerprint()]
                    req.result = rank_rows(
                        {name: row[name] for name in dlist},
                        req.batch_size, t.run_time_ms, req.by)
                else:
                    req.result = [
                        {name: by_fp[t.fingerprint()][name]
                         for name in dlist}
                        for t in req.traces]
            with self._cond:
                self._union_batches += 1
                self._sliced_columns += sliced
            self._record_trace_success([uniq[fp] for fp in order])
        except BaseException:
            # a trace-level engine error (e.g. an unmeasured op) must not
            # fate-share across the union batch the way a per-fleet group
            # confined it before: retry each request alone so only the
            # culprit sees its error.  Errors are the rare path — the
            # retry costs nothing in steady state.
            self._execute_singly(resolved)
        finally:
            for req, _ in resolved:
                req.finish()

    def _execute_singly(self,
                        resolved: List[Tuple[PendingQuery, List[str]]]
                        ) -> None:
        """Per-request fallback after a failed union pass: isolate the
        failing request(s), answer the healthy ones."""
        for req, dlist in resolved:
            try:
                rows = self.planner.sweep(req.traces, dests=dlist)
                if req.kind == "rank":
                    t = req.traces[0]
                    req.result = rank_rows(dict(rows[0]), req.batch_size,
                                           t.run_time_ms, req.by)
                else:
                    req.result = [dict(r) for r in rows]
                self._record_trace_success(req.traces)
            except BaseException as e:
                req.error = e
                # per-query isolation = the narrowest blame the engine
                # can assign; the quarantine learns from it
                for t in req.traces:
                    self._record_trace_failure(t, e)

    def _execute_grouped(self, batch: List[PendingQuery]) -> None:
        """The grouped batcher: one engine pass per destination-fleet
        *spelling*.  Kept verbatim as the ``union_grid=False`` baseline
        (and as a kill switch)."""
        groups: Dict[Optional[Tuple[str, ...]], List[PendingQuery]] = {}
        for req in batch:
            groups.setdefault(req.dests, []).append(req)
        for dests, reqs in groups.items():
            try:
                uniq: Dict[str, TrackedTrace] = {}
                for req in reqs:
                    for t in req.traces:
                        uniq.setdefault(t.fingerprint(), t)
                order = list(uniq)
                rows = self.planner.sweep(
                    [uniq[fp] for fp in order],
                    dests=list(dests) if dests is not None else None)
                by_fp = dict(zip(order, rows))
                for req in reqs:
                    if req.kind == "rank":
                        t = req.traces[0]
                        req.result = rank_rows(
                            dict(by_fp[t.fingerprint()]), req.batch_size,
                            t.run_time_ms, req.by)
                    else:
                        req.result = [dict(by_fp[t.fingerprint()])
                                      for t in req.traces]
            except BaseException as e:  # propagate to every waiter
                for req in reqs:
                    req.error = e
            finally:
                for req in reqs:
                    req.finish()
