"""Parser for the Prometheus text exposition format (0.0.4), a copy of
``paddle_tpu/monitor/promtext.py``: the consuming half of
``MetricsRegistry.to_prometheus()``, so a scrape of the port's registry
reads back with its own parser (hostile HELP strings and label values
round-trip per spec).

Tolerant of the full format (comments, unknown TYPE kinds, arbitrary
label order, escaped ``\\``/``\\"``/``\\n`` in label values,
``+Inf``/``-Inf``/``NaN`` sample values) but strict about structural
garbage: a line that is neither a comment nor a parseable sample raises
``PromParseError``, never a silent partial parse.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["PromParseError", "ParsedFamily", "parse_prometheus_text",
           "histogram_snapshot_from_samples"]


class PromParseError(ValueError):
    """The text body is not valid exposition format."""


class ParsedFamily:
    """One metric family reassembled from the text form."""

    def __init__(self, name: str):
        self.name = name
        self.kind: Optional[str] = None    # from # TYPE, if present
        self.help: Optional[str] = None    # from # HELP, if present
        # [(labels dict, float value)] in document order
        self.samples: List[Tuple[Dict[str, str], float]] = []

    def value(self, **labels) -> Optional[float]:
        want = {str(k): str(v) for k, v in labels.items()}
        for lab, v in self.samples:
            if lab == want:
                return v
        return None


def _unescape_help(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(body: str, line: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        j = body.find("=", i)
        if j < 0:
            raise PromParseError(f"bad label pair in: {line!r}")
        name = body[i:j].strip().lstrip(",").strip()
        if not name:
            raise PromParseError(f"empty label name in: {line!r}")
        j += 1
        if j >= n or body[j] != '"':
            raise PromParseError(f"unquoted label value in: {line!r}")
        j += 1
        val = []
        while j < n:
            c = body[j]
            if c == "\\" and j + 1 < n:
                nxt = body[j + 1]
                if nxt == "\\":
                    val.append("\\")
                elif nxt == '"':
                    val.append('"')
                elif nxt == "n":
                    val.append("\n")
                else:           # unknown escape: keep verbatim
                    val.append(c)
                    val.append(nxt)
                j += 2
                continue
            if c == '"':
                break
            val.append(c)
            j += 1
        else:
            raise PromParseError(f"unterminated label value in: {line!r}")
        labels[name] = "".join(val)
        i = j + 1
    return labels


def _parse_value(tok: str, line: str) -> float:
    try:
        return float(tok)       # handles +Inf/-Inf/NaN spellings too
    except ValueError:
        raise PromParseError(f"bad sample value in: {line!r}")


def parse_prometheus_text(text: str) -> Dict[str, ParsedFamily]:
    """Parse an exposition body into ``{family_name: ParsedFamily}``.

    Histogram series keep their ``_bucket``/``_sum``/``_count`` suffixed
    sample names but are grouped under the BASE family name when a
    ``# TYPE <base> histogram`` line declared them (the shape our own
    exporter emits); without a TYPE line each suffixed series stands as
    its own family.
    """
    if isinstance(text, bytes):
        try:
            text = text.decode("utf-8")
        except UnicodeDecodeError as e:
            raise PromParseError(f"not utf-8: {e}")
    families: Dict[str, ParsedFamily] = {}
    histogram_bases = set()

    def fam(name: str) -> ParsedFamily:
        f = families.get(name)
        if f is None:
            f = families[name] = ParsedFamily(name)
        return f

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "HELP":
                fam(parts[2]).help = _unescape_help(
                    parts[3] if len(parts) > 3 else "")
            elif len(parts) >= 4 and parts[1] == "TYPE":
                fam(parts[2]).kind = parts[3]
                if parts[3] == "histogram":
                    histogram_bases.add(parts[2])
            # other comments are ignored per spec
            continue
        # sample: name[{labels}] value [timestamp]
        if "{" in line:
            brace = line.index("{")
            name = line[:brace]
            close = line.rfind("}")
            if close < brace:
                raise PromParseError(f"unbalanced braces in: {line!r}")
            labels = _parse_labels(line[brace + 1:close], line)
            rest = line[close + 1:].split()
        else:
            toks = line.split()
            if len(toks) < 2:
                raise PromParseError(f"missing value in: {line!r}")
            name, rest = toks[0], toks[1:]
            labels = {}
        if not rest:
            raise PromParseError(f"missing value in: {line!r}")
        if not name or not (name[0].isalpha() or name[0] in "_:"):
            raise PromParseError(f"bad metric name in: {line!r}")
        value = _parse_value(rest[0], line)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] \
                    in histogram_bases:
                base = name[:-len(suffix)]
                break
        f = fam(base)
        if base != name:
            labels = dict(labels)
            labels["__series__"] = name[len(base) + 1:]
        f.samples.append((labels, value))
    return families


def histogram_snapshot_from_samples(family: ParsedFamily) -> dict:
    """Rebuild a histogram SNAPSHOT dict (the ``Histogram.snapshot()``
    shape minus min/max, which the text form does not carry) from a
    parsed histogram family's ``_bucket``/``_sum``/``_count`` samples.
    Labeled histograms: pass a family filtered to one label set."""
    buckets: Dict[str, float] = {}
    count = total = 0.0
    for labels, v in family.samples:
        series = labels.get("__series__")
        if series == "bucket":
            le = labels.get("le")
            if le is None:
                raise PromParseError(
                    f"_bucket sample without le in {family.name}")
            buckets[le] = v
        elif series == "sum":
            total = v
        elif series == "count":
            count = v
    snap = {
        "count": int(count),
        "sum": total,
        "min": None,
        "max": None,
        "avg": (total / count) if count else None,
        "buckets": {k: int(v) for k, v in buckets.items()},
    }
    return snap
