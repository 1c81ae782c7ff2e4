"""Serve telemetry: request lifecycle spans, step timeline, metrics.

Three surfaces, one ``Telemetry`` object threaded through the stack
(``ServeOptions.build`` hands the same instance to every engine, the
router, the elastic controller and the frontend):

* **Request spans** — every :class:`~repro_torch.serve.scheduler.Request`
  accumulates typed :class:`SpanEvent` s on its ``trace`` list
  (``submitted -> admitted -> chunk_prefilled* -> promoted ->
  decode_round* -> finished``, with ``preempted`` / ``replayed`` /
  ``migrated`` / ``cancelled`` interleaved as chaos happens).  Times
  are the serve stack's synthetic step clock (the ``now`` passed to
  ``step``; the engine substitutes its step index when driven with
  ``now=inf``) plus optional wall time, so TTFT / TPOT / queue delay
  are derivable per request and per tenant / SLO class.

* **Step timeline** — scheduler / router / controller emit one record
  per step (dispatch kind, rows per group, page deltas, fleet size,
  drains in flight).  :meth:`Telemetry.write_jsonl` exports spans +
  timeline as JSONL; :func:`chrome_trace` converts the same lines to
  Chrome trace-event format viewable in Perfetto / chrome://tracing.

* **Metrics registry** — :class:`MetricsRegistry` holds labelled
  counters / gauges / histograms.  The serve components register their
  counters here and keep the legacy ``stats()`` keys as a
  compatibility view (read-only properties over registry counters), so
  the registry *subsumes* the ad-hoc stats dicts instead of shadowing
  them.  The dispatch-accounting identity ``total = prefill + decode +
  replay - fused`` is re-checked by :meth:`MetricsRegistry.audit` on
  every step record while tracing.

Zero-cost-when-off: ``bool(Telemetry())`` is ``False`` and every hook
is guarded by ``if self.tel:`` — with tracing off the serve stack does
no span/record work at all (registry counters always run; they replace
the ``+=`` the stats dicts already paid for).  This module is
stdlib-only: the port's own copy of ``repro.serve.telemetry``, whose
JSONL schema ``scripts/trace_report.py`` reads.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

# Event kinds a request span may contain (the JSONL schema contract;
# scripts/trace_report.py --validate enforces it).  ``failed`` marks a
# request lost to a replica crash/stall, ``recovered`` its journal
# reconstruction (re-admission then rides the normal replay path), and
# ``shed`` a typed admission rejection under degraded capacity.
EVENT_KINDS = ("submitted", "admitted", "chunk_prefilled", "promoted",
               "decode_round", "preempted", "replayed", "migrated",
               "failed", "recovered", "shed",
               "cancelled", "finished")
TERMINAL_KINDS = ("finished", "cancelled")

# Ratio stats keys -> (numerator counter, denominator counter).  These
# are re-derived from summed counters by merge_stats so per-replica and
# fleet-wide views agree (the router's departed-replica accumulation
# and launch/serve's summary both go through here).
RATIO_FIELDS: Dict[str, Tuple[str, str]] = {
    "prefill_rows_mean": ("n_prefill_chunks", "n_prefill_dispatches"),
    "accept_rate": ("n_draft_accepted", "n_drafted"),
}

# The dispatch-accounting identity (see docs/serving.md of the reference):
#   n_total = n_prefill + n_decode + n_replay - n_fused
_IDENTITY = ("n_total_dispatches", "n_prefill_dispatches",
             "n_decode_steps", "n_replay_steps", "n_fused_dispatches")

# Crash-recovery counters (see docs/robustness.md): recovery implies
# failure, and replay burden implies recovered requests — audit()
# checks the implication chain wherever these are registered.
_RECOVERY = ("n_failures", "n_recovered_requests",
             "n_recovery_replayed_tokens")

_uid_counters: Dict[str, "itertools.count[int]"] = {}


def next_uid(prefix: str) -> str:
    """Process-wide unique component id, e.g. ``e0, e1, ...`` for
    engines — used as the ``replica`` metric label and in span/step
    records so migrations are attributable across fleet churn."""
    c = _uid_counters.setdefault(prefix, itertools.count())
    return f"{prefix}{next(c)}"


def merge_stats(dicts: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Sum stats dicts, re-deriving ratio fields from the summed
    counters (a mean of means is wrong once replicas differ in size).
    The single aggregation point for engine stats, the router's
    live+departed fold, and launch/serve's end-of-run summary."""
    agg: Dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            if k not in RATIO_FIELDS:
                agg[k] = agg.get(k, 0) + v
    for k, (num, den) in RATIO_FIELDS.items():
        agg[k] = agg.get(num, 0) / max(agg.get(den, 0), 1)
    return agg


# ------------------------------------------------------------- metrics
class Counter:
    """Monotonic counter.  ``.value`` is exact (int-in, int-out)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Raw-sample histogram (serve runs are small enough that keeping
    samples beats choosing bucket boundaries up front)."""
    __slots__ = ("samples",)

    def __init__(self) -> None:
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples \
            else 0.0

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over raw samples, stdlib-only."""
    if not samples:
        return 0.0
    s = sorted(samples)
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[i]


_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


class MetricsRegistry:
    """Labelled metric store: ``counter/gauge/histogram(name,
    **labels)`` get-or-create, ``snapshot()`` flattens to
    ``name{k=v,...} -> value`` for JSONL / summary.json, ``audit()``
    re-checks the dispatch identity per labelled component."""

    def __init__(self) -> None:
        self._metrics: "OrderedDict[_Key, Any]" = OrderedDict()

    def _get(self, cls, name: str, labels: Dict[str, Any]):
        key = (name, tuple(sorted((k, str(v))
                                  for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name}{dict(key[1])} already "
                            f"registered as {type(m).__name__}")
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across all label sets."""
        return sum(m.value for (n, _), m in self._metrics.items()
                   if n == name and not isinstance(m, Histogram))

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (name, labels), m in self._metrics.items():
            lbl = ("{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
                   if labels else "")
            if isinstance(m, Histogram):
                out[name + lbl + ".count"] = m.count
                out[name + lbl + ".mean"] = m.mean
                out[name + lbl + ".p50"] = m.percentile(50)
                out[name + lbl + ".p99"] = m.percentile(99)
            else:
                out[name + lbl] = m.value
        return out

    def audit(self) -> List[str]:
        """Check ``n_total = n_prefill + n_decode + n_replay -
        n_fused`` for every label set that registered the identity
        counters, plus fleet-wide over the summed totals.  Returns a
        list of violation strings (empty = healthy)."""
        groups: Dict[Tuple[Tuple[str, str], ...],
                     Dict[str, float]] = {}
        rec_groups: Dict[Tuple[Tuple[str, str], ...],
                         Dict[str, float]] = {}
        for (name, labels), m in self._metrics.items():
            if name in _IDENTITY:
                groups.setdefault(labels, {})[name] = m.value
            elif name in _RECOVERY:
                rec_groups.setdefault(labels, {})[name] = m.value
        errs = []
        for labels, vals in rec_groups.items():
            if vals.get("n_recovered_requests", 0) \
                    and not vals.get("n_failures", 0):
                errs.append(f"{dict(labels)}: n_recovered_requests="
                            f"{vals['n_recovered_requests']} with "
                            "n_failures=0")
            if vals.get("n_recovery_replayed_tokens", 0) \
                    and not vals.get("n_recovered_requests", 0):
                errs.append(f"{dict(labels)}: "
                            "n_recovery_replayed_tokens="
                            f"{vals['n_recovery_replayed_tokens']} "
                            "with n_recovered_requests=0")
        fleet = {k: 0.0 for k in _IDENTITY}
        for labels, vals in groups.items():
            for k in _IDENTITY:
                fleet[k] += vals.get(k, 0)
            if "n_total_dispatches" not in vals:
                continue
            want = (vals.get("n_prefill_dispatches", 0)
                    + vals.get("n_decode_steps", 0)
                    + vals.get("n_replay_steps", 0)
                    - vals.get("n_fused_dispatches", 0))
            if vals["n_total_dispatches"] != want:
                errs.append(f"{dict(labels)}: n_total_dispatches="
                            f"{vals['n_total_dispatches']} != {want}")
        want = (fleet["n_prefill_dispatches"] + fleet["n_decode_steps"]
                + fleet["n_replay_steps"] - fleet["n_fused_dispatches"])
        if groups and fleet["n_total_dispatches"] != want:
            errs.append(f"fleet: n_total_dispatches="
                        f"{fleet['n_total_dispatches']} != {want}")
        return errs


def expose_counters(*names: str):
    """Class decorator: install read-only legacy attributes (e.g.
    ``engine.n_decode_steps``) backed by registry counters stored in
    ``self._c`` — the stats()-compatibility view of the registry."""
    def deco(cls):
        for n in names:
            setattr(cls, n,
                    property(lambda self, _n=n: self._c[_n].value))
        return cls
    return deco


# --------------------------------------------------------------- spans
@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One typed lifecycle event on a request's trace."""
    kind: str
    t: float                      # synthetic step clock
    wall: Optional[float] = None  # perf_counter seconds, if enabled
    attrs: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "t": self.t}
        if self.wall is not None:
            d["wall"] = self.wall
        if self.attrs:
            d.update(self.attrs)
        return d


class Telemetry:
    """The tracing switchboard.  ``bool(tel)`` is the trace-enabled
    flag (so hooks read ``if self.tel:``); the metrics registry is
    always live.  One instance is shared by every component of a serve
    stack so spans survive migration across replicas and the registry
    sees the whole fleet."""

    def __init__(self, *, trace: bool = False, wall: bool = False,
                 metrics_interval: int = 0,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.trace = bool(trace)
        self.wall = bool(wall)
        self.metrics_interval = int(metrics_interval)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.records: List[Dict[str, Any]] = []
        self.clock_label = "steps"   # launch sets "seconds" (realtime)
        self._requests: "OrderedDict[int, Any]" = OrderedDict()
        self._since_snapshot = 0

    def __bool__(self) -> bool:
        return self.trace

    # -- spans
    def event(self, req, kind: str, t: float, **attrs: Any) -> None:
        if not self.trace:
            return
        req.trace.append(SpanEvent(
            kind, float(t),
            time.perf_counter() if self.wall else None,
            attrs or None))
        self._requests[req.rid] = req

    def request_submitted(self, req, t: float) -> None:
        """Dedup'd ``submitted`` marker: layered backends (frontend ->
        router -> engine) and migration re-submits all call this; only
        the first submission opens the span."""
        if self.trace and not req.trace:
            self.event(req, "submitted", t)

    # -- step timeline
    def record(self, component: str, t: float, **fields: Any) -> None:
        if not self.trace:
            return
        rec: Dict[str, Any] = {"type": "step", "component": component,
                               "t": float(t), **fields}
        if self.wall:
            rec["wall"] = time.perf_counter()
        self.records.append(rec)
        errs = self.registry.audit()
        if errs:
            raise RuntimeError("metrics self-audit failed: "
                               + "; ".join(errs))
        if self.metrics_interval > 0:
            self._since_snapshot += 1
            if self._since_snapshot >= self.metrics_interval:
                self._since_snapshot = 0
                self.records.append({"type": "metrics", "t": float(t),
                                     "values":
                                     self.registry.snapshot()})

    # -- export
    def jsonl_lines(self) -> Iterator[Dict[str, Any]]:
        yield {"type": "meta", "version": 1, "clock": self.clock_label,
               "wall": self.wall}
        for rid, req in self._requests.items():
            yield {"type": "span", "rid": rid,
                   "tenant": getattr(req, "tenant", "default"),
                   "slo": getattr(req, "slo_class", "batch"),
                   "prompt_tokens": int(len(req.prompt)),
                   "generated": int(len(req.generated)),
                   "events": [ev.to_dict() for ev in req.trace]}
        yield from self.records
        last_t = self.records[-1]["t"] if self.records else 0.0
        yield {"type": "metrics", "t": last_t, "final": True,
               "values": self.registry.snapshot()}

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for line in self.jsonl_lines():
                f.write(json.dumps(line) + "\n")

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(chrome_trace(self.jsonl_lines()), f)


def chrome_trace(lines: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert parsed telemetry JSONL lines to Chrome trace-event JSON
    (load in Perfetto / chrome://tracing).  Step records become "X"
    slices on one track per component/replica; request spans become
    async "b"/"e" pairs with instant events for each lifecycle step.
    One step-clock unit renders as 1ms (1s when the meta line says the
    clock was wall seconds)."""
    scale = 1000.0
    events: List[Dict[str, Any]] = []
    for ln in lines:
        typ = ln.get("type")
        if typ == "meta" and ln.get("clock") == "seconds":
            scale = 1e6
        elif typ == "step":
            tid = ln.get("replica", ln.get("component", "?"))
            events.append({
                "ph": "X", "pid": "timeline", "tid": str(tid),
                "name": str(ln.get("kind", ln.get("component"))),
                "ts": ln["t"] * scale, "dur": scale,
                "args": {k: v for k, v in ln.items()
                         if k not in ("type", "t")}})
        elif typ == "span":
            evs = ln.get("events", [])
            if not evs:
                continue
            rid, cat = ln["rid"], f"tenant={ln.get('tenant')}"
            name = f"req{rid}"
            events.append({"ph": "b", "cat": cat, "id": rid,
                           "pid": "requests", "tid": name,
                           "name": name, "ts": evs[0]["t"] * scale})
            for ev in evs:
                events.append({"ph": "n", "cat": cat, "id": rid,
                               "pid": "requests", "tid": name,
                               "name": ev["kind"],
                               "ts": ev["t"] * scale,
                               "args": {k: v for k, v in ev.items()
                                        if k not in ("kind",)}})
            events.append({"ph": "e", "cat": cat, "id": rid,
                           "pid": "requests", "tid": name,
                           "name": name, "ts": evs[-1]["t"] * scale})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -------------------------------------------------------- verification
def check_spans(reqs, *, cancelled: Iterable[int] = (),
                backend=None) -> None:
    """The trace-exactness bar (used by ``drive_and_check``'s telemetry
    sweep and tests/test_serve_telemetry.py):

    * every span starts with exactly one ``submitted`` and ends with
      exactly one terminal event matching the request's fate;
    * confirmed-token events sum to ``len(generated)`` exactly;
    * admissions reconcile with preemptions + migrations +
      crash recoveries (each ``recovered`` pairs with a ``failed``);
    * ``migrated`` events carry ``src != dst`` and the next admission
      lands on ``dst``;
    * a ``shed`` span is a rejected submit: nothing before or after
      the shed marker, and the request generated nothing;
    * against ``backend`` (optional): finished events == finished
      list, replayed tokens == ``n_replay_steps``, and the registry
      audit is clean.
    """
    finish_events = replay_total = 0
    for r in reqs:
        evs = list(r.trace)
        assert evs, f"rid {r.rid}: traced request has no span events"
        kinds = [e.kind for e in evs]
        if "shed" in kinds:
            # shed at submit: the request never entered the stack
            assert kinds == ["shed"], (r.rid, kinds)
            assert len(r.generated) == 0, (r.rid, r.generated)
            continue
        assert kinds[0] == "submitted", (r.rid, kinds)
        assert kinds.count("submitted") == 1, (r.rid, kinds)
        terms = [k for k in kinds if k in TERMINAL_KINDS]
        assert len(terms) == 1, \
            f"rid {r.rid}: {len(terms)} terminal events in {kinds}"
        assert kinds[-1] in TERMINAL_KINDS, (r.rid, kinds)
        want_term = ("cancelled" if r.rid in set(cancelled)
                     else "finished")
        assert terms[0] == want_term, (r.rid, terms, want_term)
        for e in evs:
            assert e.kind in EVENT_KINDS, e
        ntok = sum((e.attrs or {}).get("n", 0) for e in evs
                   if e.kind in ("decode_round", "promoted"))
        assert ntok == len(r.generated), \
            (f"rid {r.rid}: span confirms {ntok} tokens, request "
             f"holds {len(r.generated)}")
        n_adm = kinds.count("admitted")
        n_pre = kinds.count("preempted")
        n_mig = kinds.count("migrated")
        n_fail = kinds.count("failed")
        n_rec = kinds.count("recovered")
        # every reconstruction answers exactly one loss (a request can
        # crash more than once, but never recovers without failing)
        assert n_fail == n_rec, (r.rid, n_fail, n_rec, kinds)
        if want_term == "finished":
            assert 1 <= n_adm <= 1 + n_pre + n_mig + n_rec, \
                (r.rid, n_adm, n_pre, n_mig, n_rec)
        replay_total += sum((e.attrs or {}).get("n", 0) for e in evs
                            if e.kind == "replayed")
        finish_events += kinds.count("finished")
        for j, e in enumerate(evs):
            if e.kind == "migrated":
                a = e.attrs or {}
                assert a.get("src") != a.get("dst"), (r.rid, a)
                nxt = next((x for x in evs[j:]
                            if x.kind == "admitted"), None)
                if nxt is not None:
                    assert (nxt.attrs or {}).get("replica") == \
                        a.get("dst"), (r.rid, nxt, a)
    if backend is not None:
        st = backend.stats()
        assert finish_events == len(backend.finished), \
            (finish_events, len(backend.finished))
        assert replay_total == st["n_replay_steps"], \
            (replay_total, st["n_replay_steps"])
        tel = getattr(backend, "tel", None)
        if tel is not None:
            errs = tel.registry.audit()
            assert not errs, errs
