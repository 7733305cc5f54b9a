"""Model-architecture visualization — the UI's flow page (counterpart of
deeplearning4j_tpu/ui/flow.py: the same nodes, edges and HTML; a node's
param count is summed over the network's params, nested ones included).

Reference: deeplearning4j-ui's flow module (SURVEY.md §2.10 'pages: ...
flow'): render the network as a box-and-edge graph. Self-contained SVG/HTML
like the other ui pages: layer boxes (name, type, output shape, param
count) in topological layers, straight edges between them.
"""
from __future__ import annotations

import html as html_mod
from typing import Dict, List, Tuple

from deeplearning4j_tpu_torch.models._training import flat_items


def _count(tree) -> int:
    return sum(int(t.numel()) for _, t in flat_items(tree))


def _mln_graph(net) -> Tuple[List[dict], List[Tuple[str, str]]]:
    nodes, edges = [], []
    prev = "input"
    nodes.append({"name": "input", "kind": "Input",
                  "shape": str(net._input_types[0].shape()), "params": 0,
                  "depth": 0})
    for i, layer in enumerate(net.layers):
        name = f"layer_{i}"
        n = _count(net.params[name]) if net.params else 0
        nodes.append({"name": name, "kind": type(layer).__name__,
                      "shape": str(net._input_types[i + 1].shape()),
                      "params": n, "depth": i + 1})
        edges.append((prev, name))
        prev = name
    return nodes, edges


def _cg_graph(net) -> Tuple[List[dict], List[Tuple[str, str]]]:
    depth: Dict[str, int] = {n: 0 for n in net.conf.network_inputs}
    nodes = [{"name": n, "kind": "Input", "shape": "", "params": 0,
              "depth": 0} for n in net.conf.network_inputs]
    edges: List[Tuple[str, str]] = []
    for name in net.topo:
        v = net.conf.vertices[name]
        ins = net.conf.vertex_inputs[name]
        d = 1 + max((depth.get(i, 0) for i in ins), default=0)
        depth[name] = d
        kind = (type(v.layer).__name__ if hasattr(v, "layer") and
                getattr(v, "layer", None) is not None else type(v).__name__)
        n = _count(net.params.get(name, {})) if net.params else 0
        shape = ""
        t = net.vertex_types.get(name)
        if t is not None:
            shape = str(t.shape())
        nodes.append({"name": name, "kind": kind, "shape": shape,
                      "params": n, "depth": d})
        edges.extend((i, name) for i in ins)
    return nodes, edges


def build_graph(net) -> Tuple[List[dict], List[Tuple[str, str]]]:
    """(nodes, edges) of a MultiLayerNetwork or ComputationGraph — the
    shared graph builder behind write_model_graph_html and the live
    /flow page's static report (ui/stats.py)."""
    return _cg_graph(net) if hasattr(net, "topo") else _mln_graph(net)


def write_model_graph_html(net, path: str, title: str = "model flow") -> str:
    """Render a MultiLayerNetwork or ComputationGraph as a flow diagram."""
    nodes, edges = build_graph(net)
    by_depth: Dict[int, List[dict]] = {}
    for nd in nodes:
        by_depth.setdefault(nd["depth"], []).append(nd)
    bw, bh, hgap, vgap, pad = 190.0, 54.0, 30.0, 40.0, 20.0
    pos: Dict[str, Tuple[float, float]] = {}
    max_row = max(len(v) for v in by_depth.values())
    width = pad * 2 + max_row * (bw + hgap)
    height = pad * 2 + (max(by_depth) + 1) * (bh + vgap)
    for d, row in sorted(by_depth.items()):
        total = len(row) * (bw + hgap) - hgap
        x0 = (width - total) / 2
        for j, nd in enumerate(row):
            pos[nd["name"]] = (x0 + j * (bw + hgap), pad + d * (bh + vgap))
    marks = []
    for a, b in edges:
        ax, ay = pos[a]
        bx, by_ = pos[b]
        marks.append(
            f'<line x1="{ax + bw / 2:.0f}" y1="{ay + bh:.0f}" '
            f'x2="{bx + bw / 2:.0f}" y2="{by_:.0f}"/>')
    for nd in nodes:
        x, y = pos[nd["name"]]
        label = html_mod.escape(f"{nd['name']} · {nd['kind']}")
        sub = html_mod.escape(
            f"{nd['shape']}" + (f" · {nd['params']:,}p" if nd["params"]
                                else ""))
        marks.append(
            f'<g><rect x="{x:.0f}" y="{y:.0f}" width="{bw:g}" '
            f'height="{bh:g}" rx="6"/>'
            f'<text x="{x + bw / 2:.0f}" y="{y + 22:.0f}">{label}</text>'
            f'<text class="sub" x="{x + bw / 2:.0f}" y="{y + 40:.0f}">'
            f'{sub}</text></g>')
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html_mod.escape(title)}</title><style>
body{{font:14px system-ui;margin:2rem;color:#1a1a19;background:#fff}}
svg{{width:100%;max-width:{width:g}px}}
rect{{fill:#fff;stroke:#2a78d6;stroke-width:1.5}}
line{{stroke:#6b6a63;stroke-width:1}}
text{{font-size:11px;text-anchor:middle;fill:#1a1a19}}
.sub{{font-size:9px;fill:#6b6a63}}
@media (prefers-color-scheme: dark){{
 body{{color:#fff;background:#1a1a19}}
 rect{{fill:#1a1a19;stroke:#3987e5}} text{{fill:#fff}}
 .sub{{fill:#c3c2b7}} line{{stroke:#c3c2b7}}}}
</style></head><body><h2>{html_mod.escape(title)}</h2>
<svg viewBox="0 0 {width:g} {height:g}">{''.join(marks)}</svg>
</body></html>"""
    with open(path, "w") as f:
        f.write(doc)
    return path
