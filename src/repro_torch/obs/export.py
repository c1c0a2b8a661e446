"""Prometheus-style text exposition for a ``MetricsRegistry``.

Implements the text format subset dashboards actually scrape: one
``# HELP`` / ``# TYPE`` header per metric name, one sample line per
series, histograms expanded to cumulative ``_bucket{le=...}`` +
``_sum`` + ``_count``.  No external client library — the format is
five line templates, and the CI image must not grow a dependency for
them (see docs/observability.md#exposition-format).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["to_prometheus"]


def _fmt_labels(labels, extra: Dict[str, str] = ()) -> str:
    pairs = list(labels) + list(dict(extra).items() if extra else [])
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render every registered series in exposition text format."""
    lines: List[str] = []
    seen_header = set()
    for inst in registry.collect():
        if inst.name not in seen_header:
            seen_header.add(inst.name)
            if inst.help:
                lines.append(f"# HELP {inst.name} {_escape(inst.help)}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
        if inst.kind in ("counter", "gauge"):
            lines.append(
                f"{inst.name}{_fmt_labels(inst.labels)} "
                f"{_fmt_value(inst.value)}")
        else:   # histogram
            for le, c in inst.cumulative():
                lines.append(
                    f"{inst.name}_bucket"
                    f"{_fmt_labels(inst.labels, {'le': _fmt_value(le)})} "
                    f"{c}")
            lines.append(f"{inst.name}_sum{_fmt_labels(inst.labels)} "
                         f"{_fmt_value(inst.sum)}")
            lines.append(f"{inst.name}_count{_fmt_labels(inst.labels)} "
                         f"{inst.count}")
    return "\n".join(lines) + ("\n" if lines else "")
