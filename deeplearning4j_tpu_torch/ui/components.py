"""UI components — declarative chart/table/text value objects.

Reference: deeplearning4j-ui-components (SURVEY.md §2.10): Java classes
(ChartLine, ChartScatter, ChartHistogram, ComponentTable, ComponentText,
ComponentDiv + Style*) serialized to JSON for the front-end's JS renderer.
Same design here: components are data, `to_json` is the wire format the
dashboard (ui/server.py) ships to the browser; `render_html` gives a
dependency-free static rendering for reports.
"""
from __future__ import annotations

import html as html_mod
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_COMPONENTS: Dict[str, type] = {}


def register_component(cls):
    _COMPONENTS[cls.__name__] = cls
    return cls


@dataclass
class Style:
    """Subset of StyleChart/StyleTable/StyleText the JS renderer consumes."""

    width: Optional[float] = None
    height: Optional[float] = None
    background_color: Optional[str] = None
    series_colors: Optional[List[str]] = None
    font_size: Optional[int] = None

    def to_json(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class Component:
    title: str = ""
    style: Optional[Style] = None

    def to_json(self) -> dict:
        import dataclasses

        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Style):
                v = v.to_json()
            d[f.name] = v
        return d

    def json(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_json(d) -> "Component":
        if isinstance(d, str):
            d = json.loads(d)
        d = dict(d)
        t = d.pop("type")
        if isinstance(d.get("style"), dict):
            d["style"] = Style(**d["style"])
        if t == "ComponentDiv" and d.get("children"):
            d["children"] = [Component.from_json(c) for c in d["children"]]
        return _COMPONENTS[t](**d)


@register_component
@dataclass
class ComponentText(Component):
    text: str = ""

    def render_html(self) -> str:
        return f"<p>{html_mod.escape(self.text)}</p>"


@register_component
@dataclass
class ComponentTable(Component):
    header: List[str] = field(default_factory=list)
    rows: List[List[str]] = field(default_factory=list)

    def render_html(self) -> str:
        head = "".join(f"<th>{html_mod.escape(str(h))}</th>"
                       for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{html_mod.escape(str(c))}</td>"
                             for c in row) + "</tr>"
            for row in self.rows)
        return (f"<table><thead><tr>{head}</tr></thead>"
                f"<tbody>{body}</tbody></table>")


@dataclass
class _XYChart(Component):
    series_names: List[str] = field(default_factory=list)
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)

    def add_series(self, name: str, x, y) -> "_XYChart":
        self.series_names.append(name)
        self.x.append([float(v) for v in x])
        self.y.append([float(v) for v in y])
        return self

    def render_html(self) -> str:  # minimal inline-SVG polyline rendering
        if not self.x or not any(self.x):
            return f"<svg data-title={json.dumps(self.title)}></svg>"
        xs = [v for s in self.x for v in s]
        ys = [v for s in self.y for v in s]
        x0, x1 = min(xs), max(xs) or 1.0
        y0, y1 = min(ys), max(ys) or 1.0
        w, h = 400.0, 250.0

        def pt(a, b):
            px = (a - x0) / max(x1 - x0, 1e-12) * w
            py = h - (b - y0) / max(y1 - y0, 1e-12) * h
            return f"{px:.1f},{py:.1f}"

        polys = "".join(
            f'<polyline fill="none" stroke="currentColor" points="'
            + " ".join(pt(a, b) for a, b in zip(sx, sy)) + '"/>'
            for sx, sy in zip(self.x, self.y))
        return (f'<svg viewBox="0 0 {w:g} {h:g}" '
                f'data-title={json.dumps(self.title)}>{polys}</svg>')


@register_component
@dataclass
class ChartLine(_XYChart):
    """Multi-series line chart (components ChartLine.java)."""


@register_component
@dataclass
class ChartScatter(_XYChart):
    """Multi-series scatter (ChartScatter.java); same payload, point marks."""


@register_component
@dataclass
class ChartHistogram(Component):
    """Bin edges + counts (ChartHistogram.java)."""

    lower: List[float] = field(default_factory=list)
    upper: List[float] = field(default_factory=list)
    y: List[float] = field(default_factory=list)

    def add_bin(self, lower: float, upper: float, count: float):
        self.lower.append(float(lower))
        self.upper.append(float(upper))
        self.y.append(float(count))
        return self

    @staticmethod
    def from_histogram(hist) -> "ChartHistogram":
        """Build from an eval.curves.Histogram."""
        edges = hist.bin_edges()
        out = ChartHistogram(title=hist.title)
        for lo, hi, c in zip(edges[:-1], edges[1:], hist.counts):
            out.add_bin(lo, hi, c)
        return out

    def render_html(self) -> str:
        total_w, h = 400.0, 250.0
        if not self.y:
            return f"<svg data-title={json.dumps(self.title)}></svg>"
        lo, hi = min(self.lower), max(self.upper)
        ymax = max(self.y) or 1.0
        rects = "".join(
            f'<rect x="{(l - lo) / max(hi - lo, 1e-12) * total_w:.1f}" '
            f'y="{h - v / ymax * h:.1f}" '
            f'width="{(u - l) / max(hi - lo, 1e-12) * total_w:.1f}" '
            f'height="{v / ymax * h:.1f}"/>'
            for l, u, v in zip(self.lower, self.upper, self.y))
        return (f'<svg viewBox="0 0 {total_w:g} {h:g}" '
                f'data-title={json.dumps(self.title)}>{rects}</svg>')


@register_component
@dataclass
class ComponentDiv(Component):
    """Container (ComponentDiv.java)."""

    children: List[Component] = field(default_factory=list)

    def to_json(self) -> dict:
        d = super().to_json()
        d["children"] = [c.to_json() for c in self.children]
        return d

    def render_html(self) -> str:
        return ("<div>" + "".join(c.render_html() for c in self.children)
                + "</div>")
