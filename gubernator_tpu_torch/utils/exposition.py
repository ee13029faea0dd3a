"""Prometheus exposition, stdlib only: metric families, a registry and
the two text formats /metrics serves.

The JAX package builds its /metrics with `prometheus_client`, which the
card's machine does not have.  This module writes the same bytes for the
family kinds the collector uses (counter, gauge, summary, histogram, with
and without labels) in both formats the gateway serves:

* Prometheus text 0.0.4 (`generate_latest`, `CONTENT_TYPE_LATEST`): a
  counter family is named without `_total` and its HELP / TYPE lines and
  samples carry it; HELP escapes `\\` and newlines; exemplars are dropped;
* OpenMetrics 1.0.0 (`generate_openmetrics`,
  `CONTENT_TYPE_OPENMETRICS`): HELP / TYPE name the family as built
  (a counter without `_total`), HELP also escapes `"`, histogram buckets
  carry their exemplar as ` # {trace_id="..."} value`, and the text ends
  with `# EOF`.

Label values escape `\\`, newlines and `"`; labels print sorted by name;
values print as prometheus_client's `floatToGoString` prints them
(`+Inf`, `-Inf`, `NaN`, `1.0`, `1.234567e+06`).  The families add no
`_created` sample, as the JAX package's collector passes none.  Names
outside the legacy character set are escaped to underscores, as
prometheus_client's default escaping does.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = "application/openmetrics-text; version=1.0.0; charset=utf-8"

INF = float("inf")
MINUS_INF = float("-inf")

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Exemplar(NamedTuple):
    labels: Dict[str, str]
    value: float


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float
    exemplar: Optional[Exemplar] = None


class Metric:
    """One metric family: name, HELP text, type and samples."""

    def __init__(self, name: str, documentation: str, typ: str, labels=None):
        if not name:
            raise ValueError("metric name cannot be empty")
        self.name = name
        self.documentation = documentation
        self.type = typ
        self._labelnames = tuple(labels or ())
        self.samples: List[Sample] = []

    def _labels(self, values: Sequence[str]) -> Dict[str, str]:
        return dict(zip(self._labelnames, values))


class CounterMetricFamily(Metric):
    """A counter; a name ending in `_total` loses the suffix (the samples
    put it back)."""

    def __init__(self, name: str, documentation: str, value=None, labels=None):
        if name.endswith("_total"):
            name = name[:-6]
        super().__init__(name, documentation, "counter", labels)
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, labels: Sequence[str], value) -> None:
        self.samples.append(Sample(self.name + "_total", self._labels(labels), value))


class GaugeMetricFamily(Metric):
    def __init__(self, name: str, documentation: str, value=None, labels=None):
        super().__init__(name, documentation, "gauge", labels)
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, labels: Sequence[str], value) -> None:
        self.samples.append(Sample(self.name, self._labels(labels), value))


class SummaryMetricFamily(Metric):
    def __init__(self, name: str, documentation: str, count_value=None, sum_value=None,
                 labels=None):
        if (sum_value is None) != (count_value is None):
            raise ValueError("count_value and sum_value must be provided together.")
        super().__init__(name, documentation, "summary", labels)
        if count_value is not None:
            self.add_metric([], count_value, sum_value)

    def add_metric(self, labels: Sequence[str], count_value, sum_value) -> None:
        lab = self._labels(labels)
        self.samples.append(Sample(self.name + "_count", lab, count_value))
        self.samples.append(Sample(self.name + "_sum", dict(lab), sum_value))


class HistogramMetricFamily(Metric):
    """Buckets are `(le, cumulative count)` or `(le, count, Exemplar)`,
    sorted, ending at "+Inf"; `_count` is the last bucket's count."""

    def __init__(self, name: str, documentation: str, buckets=None, sum_value=None,
                 labels=None):
        super().__init__(name, documentation, "histogram", labels)
        if buckets is not None:
            self.add_metric([], buckets, sum_value)

    def add_metric(self, labels: Sequence[str], buckets, sum_value) -> None:
        for b in buckets:
            self.samples.append(Sample(
                self.name + "_bucket",
                dict(list(zip(self._labelnames, labels)) + [("le", b[0])]),
                b[1],
                b[2] if len(b) == 3 else None,
            ))
        if float(buckets[0][0]) >= 0 and sum_value is not None:
            self.samples.append(Sample(self.name + "_count", self._labels(labels), buckets[-1][1]))
            self.samples.append(Sample(self.name + "_sum", self._labels(labels), sum_value))


class CollectorRegistry:
    """Collectors (objects with `collect()` yielding families), scraped
    in the order they were registered."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: list = []

    def register(self, collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def collect(self) -> Iterable[Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for c in collectors:
            yield from c.collect()


def float_to_go_string(d) -> str:
    """A sample value as Go prints it (prometheus_client floatToGoString)."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == MINUS_INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python.
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _label_rune(c: str, i: int) -> bool:
    return ("a" <= c <= "z") or ("A" <= c <= "Z") or c == "_" or ("0" <= c <= "9" and i > 0)


def _underscores(s: str, metric: bool) -> str:
    return "".join(c if _label_rune(c, i) or (metric and c == ":") else "_"
                   for i, c in enumerate(s))


def _metric_name(s: str) -> str:
    return s if _METRIC_NAME_RE.match(s) else _underscores(s, True)


def _label_name(s: str) -> str:
    return s if _LABEL_NAME_RE.match(s) else _underscores(s, False)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labelstr(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{_label_name(k)}="{_escape(v)}"'
                          for k, v in sorted(labels.items())) + "}"


def generate_latest(registry) -> bytes:
    """The Prometheus text format 0.0.4 of every family of `registry`."""
    out: List[str] = []
    for metric in registry.collect():
        mname = metric.name + "_total" if metric.type == "counter" else metric.name
        name = _metric_name(mname)
        doc = metric.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {name} {doc}\n")
        out.append(f"# TYPE {name} {metric.type}\n")
        for s in metric.samples:
            out.append(f"{_metric_name(s.name)}{_labelstr(s.labels)} "
                       f"{float_to_go_string(s.value)}\n")
    return "".join(out).encode("utf-8")


def generate_openmetrics(registry) -> bytes:
    """The OpenMetrics 1.0.0 text of every family of `registry`, with
    exemplars, ending in `# EOF`."""
    out: List[str] = []
    for metric in registry.collect():
        name = _metric_name(metric.name)
        out.append(f"# HELP {name} {_escape(metric.documentation)}\n")
        out.append(f"# TYPE {name} {metric.type}\n")
        for s in metric.samples:
            ex = ""
            if s.exemplar is not None:
                if not (s.name.endswith("_bucket") and metric.type == "histogram"
                        or s.name.endswith("_total") and metric.type == "counter"
                        or s.name == metric.name):
                    raise ValueError(f"Metric {metric.name} has exemplars, but is not a "
                                     "histogram bucket or counter")
                elabels = ",".join(f'{k}="{_escape(v)}"'
                                   for k, v in sorted(s.exemplar.labels.items()))
                ex = f" # {{{elabels}}} {float_to_go_string(s.exemplar.value)}"
            out.append(f"{_underscores(s.name, False)}{_labelstr(s.labels)} "
                       f"{float_to_go_string(s.value)}{ex}\n")
    out.append("# EOF\n")
    return "".join(out).encode("utf-8")
