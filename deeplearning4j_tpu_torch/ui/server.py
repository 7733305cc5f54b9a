"""UIServer — the training dashboard and the telemetry endpoints
(counterpart of deeplearning4j_tpu/ui/server.py: the same pages, routes,
status codes and JSON keys, over the port's telemetry and serving
modules).

Mirrors deeplearning4j-play's PlayUIServer/api/UIServer (SURVEY.md §2.10):
`UIServer.get_instance().attach(statsStorage)` serves a live train-overview
page; a /remote POST endpoint accepts reports from other processes
(RemoteReceiverModule), paired with storage.RemoteUIStatsStorageRouter. The
Play framework + SBE + Scala templates collapse into a stdlib
ThreadingHTTPServer with JSON endpoints and one self-contained HTML page —
no dependencies, works over an SSH tunnel to the GPU host.

Page anatomy: stat tiles (score / iteration / throughput / memory), the
score-vs-iteration line, and the per-layer log10(update/param) ratio chart
(the reference train page's headline diagnostics). Colors are the validated
categorical palette (fixed slot order, light+dark selected); single-series
charts carry no legend; the multi-series ratio chart always does; a table
view covers the no-color case.

Endpoints: the train pages and ``/api/*``; ``/metrics`` (Prometheus text),
``/trace`` (Chrome trace, incremental with ``?cursor=``), ``/slo``,
``/models`` and ``/fleet`` (each scrape ticks the live routers' and
autoscalers' ``evaluate``: scraping is their control loop), the
``/fleet/*`` federation views (404 with ``DL4J_TPU_TELEMETRY`` off),
``/healthz`` (the training health snapshot merged with the serving,
models, fleet and SLO sections) and POST ``/remote``. Still missing
(ROADMAP A.11): ``/profile`` (item 3, telemetry/introspect.py) and
``/tune`` (item 4, the closed-loop tuner) answer 501 with a JSON error,
and ``attach_embedding`` (item 6, ui/embedding.py needs knn/tsne) raises
NotImplementedError, so ``/api/tsne`` lists nothing, as in JAX with no
embedding attached.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.ui.storage import (
    InMemoryStatsStorage,
    StatsStorage,
)

# validated categorical palette (dataviz reference instance; slot order fixed)
_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
          "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500",
         "#d55181", "#008300", "#9085e9", "#e66767"]

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>deeplearning4j-tpu · train overview</title><style>
:root{color-scheme:light dark;
 --surface:#ffffff;--ink:#1a1a19;--ink2:#6b6a63;--grid:#ebebe6;
 --s1:@@LIGHT@@}
@media (prefers-color-scheme: dark){:root{
 --surface:#1a1a19;--ink:#ffffff;--ink2:#c3c2b7;--grid:#33332f;
 --s1:@@DARK@@}}
body{font:14px/1.45 system-ui,sans-serif;background:var(--surface);
 color:var(--ink);margin:24px;max-width:1080px}
h1{font-size:18px;font-weight:600} h2{font-size:14px;color:var(--ink2);
 font-weight:600;margin:28px 0 8px}
.tiles{display:flex;gap:12px;flex-wrap:wrap}
.tile{border:1px solid var(--grid);border-radius:8px;padding:12px 16px;
 min-width:150px}
.tile .v{font-size:24px;font-weight:650;font-variant-numeric:tabular-nums}
.tile .l{color:var(--ink2);font-size:12px}
svg{display:block} .axis{stroke:var(--grid)} text{fill:var(--ink2);
 font-size:11px}
.legend{display:flex;gap:16px;margin:6px 2px;font-size:12px;
 color:var(--ink2)} .legend i{display:inline-block;width:10px;height:10px;
 border-radius:2px;margin-right:5px;vertical-align:-1px}
.tip{position:fixed;pointer-events:none;background:var(--surface);
 border:1px solid var(--grid);border-radius:6px;padding:6px 9px;
 font-size:12px;display:none;box-shadow:0 2px 8px rgba(0,0,0,.12)}
table{border-collapse:collapse;font-size:12px;margin-top:8px}
td,th{border:1px solid var(--grid);padding:3px 9px;text-align:right}
th{color:var(--ink2)} select{margin-left:12px}
a{color:inherit}
nav{margin:0 0 18px;font-size:13px} nav a{margin-right:14px;
 color:var(--ink2);text-decoration:none} nav a.on{color:var(--ink);
 font-weight:600;border-bottom:2px solid var(--ink)}
</style></head><body>
@@NAV@@
<h1>Train overview
 <select id="sess"></select>
 <span id="meta" style="font-size:12px;color:var(--ink2)"></span></h1>
<div class="tiles" id="tiles"></div>
<h2>Model score vs. iteration</h2>
<svg id="score" width="1040" height="240"></svg>
<h2>log<sub>10</sub> mean |update| / mean |param| (per parameter)</h2>
<div class="legend" id="legend"></div>
<svg id="ratio" width="1040" height="240"></svg>
<h2><a href="#" id="tbl_toggle">Toggle data table</a></h2>
<div id="tbl" style="display:none"></div>
<div class="tip" id="tip"></div>
<script>
const css = getComputedStyle(document.documentElement);
const PAL = css.getPropertyValue('--s1').split(',').map(s=>s.trim());
const tip = document.getElementById('tip');
let session = null, updates = [];

function esc(x){ return String(x).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c])); }

function fmt(x){ if(x==null||isNaN(x)) return '–';
  const a=Math.abs(x); if(a>=1e9)return (x/1e9).toFixed(2)+'G';
  if(a>=1e6)return (x/1e6).toFixed(2)+'M'; if(a>=1e3)return (x/1e3).toFixed(1)+'k';
  if(a>=1)return x.toFixed(3); return x.toPrecision(3); }

function line(svg, series, colors, names){
  svg.innerHTML=''; const W=svg.width.baseVal.value,H=svg.height.baseVal.value;
  const m={l:56,r:12,t:10,b:24};
  const xs=series[0].map(p=>p[0]);
  let ys=[].concat(...series.map(s=>s.map(p=>p[1]))).filter(v=>v!=null&&isFinite(v));
  if(!ys.length) return;
  const x0=Math.min(...xs),x1=Math.max(...xs,x0+1);
  let y0=Math.min(...ys),y1=Math.max(...ys); if(y0===y1){y0-=1;y1+=1;}
  const X=v=>m.l+(v-x0)/(x1-x0)*(W-m.l-m.r);
  const Y=v=>H-m.b-(v-y0)/(y1-y0)*(H-m.t-m.b);
  let g='';
  for(let i=0;i<=4;i++){ const yv=y0+(y1-y0)*i/4, y=Y(yv);
    g+=`<line class="axis" x1="${m.l}" y1="${y}" x2="${W-m.r}" y2="${y}"/>`+
       `<text x="${m.l-6}" y="${y+4}" text-anchor="end">${fmt(yv)}</text>`; }
  for(let i=0;i<=6;i++){ const xv=x0+(x1-x0)*i/6;
    g+=`<text x="${X(xv)}" y="${H-6}" text-anchor="middle">${Math.round(xv)}</text>`; }
  series.forEach((s,si)=>{
    const pts=s.filter(p=>p[1]!=null&&isFinite(p[1]));
    if(!pts.length) return;
    const d=pts.map((p,i)=>(i?'L':'M')+X(p[0]).toFixed(1)+' '+Y(p[1]).toFixed(1)).join('');
    g+=`<path d="${d}" fill="none" stroke="${colors[si%colors.length]}"
        stroke-width="2" stroke-linejoin="round"/>`;});
  g+=`<line id="ch" class="axis" y1="${m.t}" y2="${H-m.b}" style="display:none"/>`;
  svg.innerHTML=g;
  svg.onmousemove=e=>{
    const r=svg.getBoundingClientRect(), px=e.clientX-r.left;
    if(px<m.l||px>W-m.r){svg.onmouseleave();return;}
    const xv=x0+(px-m.l)/(W-m.l-m.r)*(x1-x0);
    let best=0,bd=1e18;
    xs.forEach((v,i)=>{const d=Math.abs(v-xv); if(d<bd){bd=d;best=i;}});
    const ch=svg.querySelector('#ch');
    ch.style.display=''; ch.setAttribute('x1',X(xs[best])); ch.setAttribute('x2',X(xs[best]));
    tip.style.display='block';
    tip.style.left=(e.clientX+14)+'px'; tip.style.top=(e.clientY+10)+'px';
    tip.innerHTML='iter '+xs[best]+'<br>'+series.map((s,si)=>
      `<i style="background:${colors[si%colors.length]};display:inline-block;width:8px;height:8px;border-radius:2px;margin-right:4px"></i>${esc(names[si])}: <b>${fmt(s[best]&&s[best][1])}</b>`).join('<br>');
  };
  svg.onmouseleave=()=>{tip.style.display='none';
    const ch=svg.querySelector('#ch'); if(ch)ch.style.display='none';};
}

async function refresh(){
  const sess=await (await fetch('api/sessions')).json();
  const sel=document.getElementById('sess');
  if(sel.options.length!==sess.sessions.length){
    sel.innerHTML=sess.sessions.map(s=>`<option>${esc(s.id)}</option>`).join('');
  }
  if(!session) session=new URLSearchParams(location.search).get('session');
  if(!session && sess.sessions.length) session=sess.sessions[0].id;
  if(sel.value!==session && session) sel.value=session;
  if(!session) return;
  // the selected session follows you across the nav pages
  document.querySelectorAll('nav a').forEach(a=>{
    const u=new URL(a.getAttribute('href'), location.origin);
    u.searchParams.set('session', session); a.href=u.pathname+u.search;});
  const info=sess.sessions.find(s=>s.id===session)||{};
  document.getElementById('meta').textContent =
    (info.model_class||'')+' · '+(info.num_params||0).toLocaleString()+
    ' params · '+(info.backend||'');
  updates=(await (await fetch('api/updates?session='+encodeURIComponent(session))).json()).updates;
  if(!updates.length) return;
  const last=updates[updates.length-1];
  const t=last.timing||{};
  document.getElementById('tiles').innerHTML=[
    ['score',fmt(last.score)],['iteration',last.iteration],
    ['samples/sec',fmt(t.samples_per_sec)],
    ['memory (RSS)',fmt((last.memory||{}).rss_bytes||0)+'B']]
   .map(([l,v])=>`<div class="tile"><div class="v">${v}</div><div class="l">${l}</div></div>`).join('');
  line(document.getElementById('score'),
    [updates.map(u=>[u.iteration,u.score])],[PAL[0]],['score']);
  const names=Object.keys((updates.find(u=>u.updates)||{}).updates||{}).slice(0,8);
  document.getElementById('legend').innerHTML=names.map((n,i)=>
    `<span><i style="background:${PAL[i%PAL.length]}"></i>${esc(n)}</span>`).join('');
  if(names.length)
    line(document.getElementById('ratio'),
      names.map(n=>updates.map(u=>[u.iteration,(u.updates&&u.updates[n]||{}).ratio_log10])),
      PAL,names);
  const tbl=document.getElementById('tbl');
  if(tbl.style.display!=='none'){
    tbl.innerHTML='<table><tr><th>iter</th><th>score</th><th>samples/s</th>'+
     names.map(n=>`<th>${esc(n)} ratio</th>`).join('')+'</tr>'+
     updates.slice(-50).map(u=>`<tr><td>${u.iteration}</td><td>${fmt(u.score)}</td>`+
       `<td>${fmt((u.timing||{}).samples_per_sec)}</td>`+
       names.map(n=>`<td>${fmt((u.updates&&u.updates[n]||{}).ratio_log10)}</td>`).join('')+
       '</tr>').join('')+'</table>';}
}
document.getElementById('sess').onchange=e=>{session=e.target.value;refresh();};
document.getElementById('tbl_toggle').onclick=e=>{e.preventDefault();
  const t=document.getElementById('tbl');
  t.style.display=t.style.display==='none'?'':'none';refresh();};
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


def _nav(active: str) -> str:
    items = [("overview", "/train/overview"), ("model", "/train/model"),
             ("system", "/train/system"), ("flow", "/flow"),
             ("embeddings", "/tsne"), ("activations", "/activations")]
    return "<nav>" + "".join(
        f'<a href="{href}"{" class=on" if name == active else ""}>'
        f'{name}</a>' for name, href in items) + "</nav>"


_STYLE_RE = _PAGE[_PAGE.index("<style>"):_PAGE.index("</style>") + 8]


def _page(title: str, active: str, body: str, script: str) -> str:
    """Assemble one nav-linked page from the shared stylesheet."""
    doc = ("<!doctype html><html><head><meta charset=\"utf-8\">"
           f"<title>deeplearning4j-tpu · {title}</title>" + _STYLE_RE
           + "</head><body>" + _nav(active) + body
           + "<div class=\"tip\" id=\"tip\"></div><script>\n"
           + _COMMON_JS + script + "</script></body></html>")
    return (doc.replace("@@LIGHT@@", ",".join(_LIGHT))
               .replace("@@DARK@@", ",".join(_DARK)))


_COMMON_JS = """
const css = getComputedStyle(document.documentElement);
const PAL = css.getPropertyValue('--s1').split(',').map(s=>s.trim());
function esc(x){ return String(x).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c])); }
function fmt(x){ if(x==null||isNaN(x)) return '–';
  const a=Math.abs(x); if(a>=1e9)return (x/1e9).toFixed(2)+'G';
  if(a>=1e6)return (x/1e6).toFixed(2)+'M';
  if(a>=1e3)return (x/1e3).toFixed(1)+'k';
  if(a>=1)return x.toFixed(3); return x.toPrecision(3); }
function qsession(){ return new URLSearchParams(location.search).get('session'); }
function wireNav(s){ if(!s) return;
  document.querySelectorAll('nav a').forEach(a=>{
    const u=new URL(a.getAttribute('href'), location.origin);
    u.searchParams.set('session', s); a.href=u.pathname+u.search;}); }
async function firstSession(){
  const s = qsession(); if(s){ wireNav(s); return s; }
  const r = await (await fetch('/api/sessions')).json();
  const id = r.sessions.length ? r.sessions[0].id : null;
  wireNav(id); return id; }
function sline(svg, series, colors, names){
  svg.innerHTML=''; const W=svg.width.baseVal.value,H=svg.height.baseVal.value;
  const m={l:56,r:12,t:10,b:24};
  const xs=series[0].map(p=>p[0]);
  let ys=[].concat(...series.map(s=>s.map(p=>p[1]))).filter(v=>v!=null&&isFinite(v));
  if(!ys.length) return;
  const x0=Math.min(...xs),x1=Math.max(...xs,x0+1);
  let y0=Math.min(...ys),y1=Math.max(...ys); if(y0===y1){y0-=1;y1+=1;}
  const X=v=>m.l+(v-x0)/(x1-x0)*(W-m.l-m.r);
  const Y=v=>H-m.b-(v-y0)/(y1-y0)*(H-m.t-m.b);
  let g='';
  for(let i=0;i<=4;i++){ const yv=y0+(y1-y0)*i/4, y=Y(yv);
    g+=`<line class="axis" x1="${m.l}" y1="${y}" x2="${W-m.r}" y2="${y}"/>`+
       `<text x="${m.l-6}" y="${y+4}" text-anchor="end">${fmt(yv)}</text>`; }
  for(let i=0;i<=6;i++){ const xv=x0+(x1-x0)*i/6;
    g+=`<text x="${X(xv)}" y="${H-6}" text-anchor="middle">${Math.round(xv)}</text>`; }
  series.forEach((s,si)=>{
    const pts=s.filter(p=>p[1]!=null&&isFinite(p[1]));
    if(!pts.length) return;
    const d=pts.map((p,i)=>(i?'L':'M')+X(p[0]).toFixed(1)+' '+Y(p[1]).toFixed(1)).join('');
    g+=`<path d="${d}" fill="none" stroke="${colors[si%colors.length]}"
        stroke-width="2" stroke-linejoin="round"/>`;});
  svg.innerHTML=g;
}
"""


_MODEL_BODY = """
<h1>Model <span id="meta" style="font-size:12px;color:var(--ink2)"></span></h1>
<h2>Parameters (latest iteration)</h2>
<div id="ptable"></div>
<h2>Parameter histograms</h2>
<div id="hists" style="display:flex;flex-wrap:wrap;gap:18px"></div>
"""

_MODEL_JS = """
function hist(h, color){
  if(!h || !h.counts || !h.counts.length) return '';
  const W=220,H=90,n=h.counts.length,mx=Math.max(...h.counts,1);
  let bars='';
  for(let i=0;i<n;i++){const bh=h.counts[i]/mx*(H-18);
    bars+=`<rect x="${i*(W/n)+1}" y="${H-14-bh}" width="${W/n-2}"
      height="${bh}" fill="${color}"/>`;}
  return `<svg width="${W}" height="${H}">${bars}
    <text x="2" y="${H-2}">${fmt(h.min)}</text>
    <text x="${W-2}" y="${H-2}" text-anchor="end">${fmt(h.max)}</text></svg>`;
}
async function refresh(){
  const s = await firstSession(); if(!s) return;
  const d = await (await fetch('/api/model?session='+encodeURIComponent(s))).json();
  const st = d.static||{};
  document.getElementById('meta').textContent =
    (st.model_class||'')+' · '+(st.num_layers||0)+' layers · '+
    (st.num_params||0).toLocaleString()+' params';
  const params=(d.latest||{}).params||{}, ups=(d.latest||{}).updates||{};
  const names=Object.keys(params);
  document.getElementById('ptable').innerHTML =
    '<table><tr><th>parameter</th><th>mean</th><th>stdev</th><th>min</th>'+
    '<th>max</th><th>log10 upd/param</th></tr>'+names.map(n=>{
      const p=params[n],u=ups[n]||{};
      return `<tr><td style="text-align:left">${esc(n)}</td><td>${fmt(p.mean)}</td>
        <td>${fmt(p.stdev)}</td><td>${fmt(p.min)}</td><td>${fmt(p.max)}</td>
        <td>${fmt(u.ratio_log10)}</td></tr>`;}).join('')+'</table>';
  document.getElementById('hists').innerHTML = names.map((n,i)=>
    `<div><div style="font-size:12px;color:var(--ink2)">${esc(n)}</div>`+
    hist((params[n]||{}).histogram, PAL[i%PAL.length])+'</div>').join('');
}
refresh(); setInterval(refresh, 5000);
"""

_SYSTEM_BODY = """
<h1>System <span id="meta" style="font-size:12px;color:var(--ink2)"></span></h1>
<div class="tiles" id="tiles"></div>
<h2>Memory (RSS bytes)</h2>
<svg id="mem" width="1040" height="220"></svg>
<h2>Iterations / second</h2>
<svg id="ips" width="1040" height="220"></svg>
"""

_SYSTEM_JS = """
async function refresh(){
  const s = await firstSession(); if(!s) return;
  const d = await (await fetch('/api/system?session='+encodeURIComponent(s))).json();
  const st=d.static||{}, ups=d.updates||[];
  document.getElementById('meta').textContent =
    (st.backend||'')+' · '+((st.devices||[]).join(', '));
  if(!ups.length) return;
  const last=ups[ups.length-1];
  document.getElementById('tiles').innerHTML=[
    ['backend',esc(st.backend||'–')],
    ['devices',(st.devices||[]).length],
    ['RSS',fmt((last.memory||{}).rss_bytes||0)+'B'],
    ['iter/sec',fmt((last.timing||{}).iterations_per_sec)],
    ['ETL ms',fmt((last.timing||{}).etl_ms)]]
   .map(([l,v])=>`<div class="tile"><div class="v">${v}</div><div class="l">${l}</div></div>`).join('');
  sline(document.getElementById('mem'),
    [ups.map(u=>[u.iteration,(u.memory||{}).rss_bytes])],[PAL[0]],['rss']);
  sline(document.getElementById('ips'),
    [ups.map(u=>[u.iteration,(u.timing||{}).iterations_per_sec])],[PAL[1]],['iter/s']);
}
refresh(); setInterval(refresh, 3000);
"""

_FLOW_BODY = """
<h1>Model flow</h1>
<div id="graph"></div>
"""

_FLOW_JS = """
async function refresh(){
  const s = await firstSession(); if(!s) return;
  const d = await (await fetch('/api/flow?session='+encodeURIComponent(s))).json();
  const g = d.graph; if(!g){document.getElementById('graph').textContent=
    'no architecture graph reported for this session'; return;}
  const byd={}; g.nodes.forEach(n=>{(byd[n.depth]=byd[n.depth]||[]).push(n);});
  const bw=190,bh=54,hg=30,vg=40,pad=20;
  const maxRow=Math.max(...Object.values(byd).map(r=>r.length));
  const depths=Object.keys(byd).map(Number);
  const W=pad*2+maxRow*(bw+hg), H=pad*2+(Math.max(...depths)+1)*(bh+vg);
  const pos={};
  depths.sort((a,b)=>a-b).forEach(dp=>{
    const row=byd[dp], total=row.length*(bw+hg)-hg, x0=(W-total)/2;
    row.forEach((n,j)=>{pos[n.name]=[x0+j*(bw+hg), pad+dp*(bh+vg)];});});
  let m='';
  g.edges.forEach(([a,b])=>{const [ax,ay]=pos[a],[bx,by]=pos[b];
    m+=`<line class="axis" x1="${ax+bw/2}" y1="${ay+bh}" x2="${bx+bw/2}" y2="${by}" stroke-width="1.5"/>`;});
  g.nodes.forEach((n,i)=>{const [x,y]=pos[n.name];
    m+=`<rect x="${x}" y="${y}" width="${bw}" height="${bh}" rx="8"
       fill="none" stroke="${PAL[i%PAL.length]}" stroke-width="1.5"/>
     <text x="${x+10}" y="${y+18}" style="fill:var(--ink);font-weight:600">${esc(n.name)} · ${esc(n.kind)}</text>
     <text x="${x+10}" y="${y+34}">${esc(n.shape||'')}</text>
     <text x="${x+10}" y="${y+48}">${(n.params||0).toLocaleString()} params</text>`;});
  document.getElementById('graph').innerHTML =
    `<svg width="${W}" height="${H}">${m}</svg>`;
}
refresh();
"""

_TSNE_BODY = """
<h1>Embeddings (Barnes-Hut t-SNE)</h1>
<div id="plots"></div>
"""

_TSNE_JS = """
async function refresh(){
  const d = await (await fetch('/api/tsne')).json();
  const div=document.getElementById('plots');
  if(!d.embeddings.length){div.textContent=
    'no embeddings attached — UIServer.get_instance().attach_embedding(vectors, labels)';
    return;}
  div.innerHTML = d.embeddings.map((e,ei)=>{
    const xs=e.points.map(p=>p[0]), ys=e.points.map(p=>p[1]);
    const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
    const W=900,H=560,pad=40;
    const X=v=>pad+(v-x0)/Math.max(x1-x0,1e-12)*(W-2*pad);
    const Y=v=>H-pad-(v-y0)/Math.max(y1-y0,1e-12)*(H-2*pad);
    return '<h2>'+esc(e.title)+'</h2><svg width="'+W+'" height="'+H+'">'+
      e.points.map(p=>`<circle cx="${X(p[0]).toFixed(1)}" cy="${Y(p[1]).toFixed(1)}"
        r="3" fill="${PAL[ei%PAL.length]}"/>`+(p[2]?
        `<text x="${(X(p[0])+5).toFixed(1)}" y="${(Y(p[1])-5).toFixed(1)}">${esc(p[2])}</text>`:''))
      .join('')+'</svg>';}).join('');
}
refresh();
"""

_ACT_BODY = """
<h1>Convolutional activations</h1>
<div id="grids" style="display:flex;flex-wrap:wrap;gap:18px"></div>
"""

_ACT_JS = """
async function refresh(){
  const s = await firstSession(); if(!s) return;
  const d = await (await fetch('/api/activations?session='+encodeURIComponent(s))).json();
  const div=document.getElementById('grids');
  if(!d.grids.length){div.textContent=
    'no activation grids — add a ConvolutionalIterationListener(router=storage)';
    return;}
  div.innerHTML=d.grids.map(g=>
    `<div><div style="font-size:12px;color:var(--ink2)">layer ${g.layer} ·
      iter ${g.iteration}</div><canvas data-l="${g.layer}"
      width="${g.shape[1]}" height="${g.shape[0]}"
      style="image-rendering:pixelated;width:${Math.min(g.shape[1]*2,480)}px"></canvas></div>`).join('');
  d.grids.forEach(g=>{
    const cv=div.querySelector(`canvas[data-l="${g.layer}"]`);
    const ctx=cv.getContext('2d');
    const img=ctx.createImageData(g.shape[1], g.shape[0]);
    let k=0;
    for(const row of g.image) for(const v of row){
      img.data[k++]=v; img.data[k++]=v; img.data[k++]=v; img.data[k++]=255;}
    ctx.putImageData(img,0,0);});
}
refresh(); setInterval(refresh, 5000);
"""

_PAGE = (_PAGE.replace("@@NAV@@", _nav("overview"))
         .replace("@@LIGHT@@", ",".join(_LIGHT))
         .replace("@@DARK@@", ",".join(_DARK)))


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-ui/1.0"

    def log_message(self, *a):  # silence request logging
        pass

    @property
    def ui(self) -> "UIServer":
        return self.server.ui_server  # type: ignore[attr-defined]

    def _json(self, obj, code: int = 200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _html(self, doc: str):
        body = doc.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, doc: str, content_type: str = "text/plain"):
        body = doc.encode()
        self.send_response(200)
        self.send_header("Content-Type", f"{content_type}; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        u = urlparse(self.path)
        q = parse_qs(u.query)
        sid = (q.get("session") or [""])[0]
        if u.path in ("/", "/train", "/train/overview"):
            self._html(_PAGE)
        elif u.path == "/train/model":
            self._html(_page("model", "model", _MODEL_BODY, _MODEL_JS))
        elif u.path == "/train/system":
            self._html(_page("system", "system", _SYSTEM_BODY, _SYSTEM_JS))
        elif u.path == "/flow":
            self._html(_page("flow", "flow", _FLOW_BODY, _FLOW_JS))
        elif u.path == "/tsne":
            self._html(_page("embeddings", "embeddings", _TSNE_BODY,
                             _TSNE_JS))
        elif u.path == "/activations":
            self._html(_page("activations", "activations", _ACT_BODY,
                             _ACT_JS))
        elif u.path == "/api/sessions":
            self._json({"sessions": self.ui._sessions()})
        elif u.path == "/api/updates":
            limit = int((q.get("limit") or ["500"])[0])
            self._json({"updates": self.ui._updates(sid, limit)})
        elif u.path == "/api/model":
            self._json(self.ui._model_data(sid))
        elif u.path == "/api/system":
            self._json(self.ui._system_data(sid))
        elif u.path == "/api/flow":
            self._json({"graph": (self.ui._static(sid) or {}).get("graph")})
        elif u.path == "/api/tsne":
            self._json({"embeddings": self.ui._embeddings})
        elif u.path == "/api/activations":
            self._json({"grids": self.ui._activation_grids(sid)})
        elif u.path == "/metrics":
            # Prometheus text exposition over the process-global registry
            # (telemetry/metrics.py) — scrape-ready, no deps
            from deeplearning4j_tpu_torch.telemetry import (
                metrics as metrics_mod,
            )

            self._text(metrics_mod.render_prometheus(),
                       "text/plain; version=0.0.4")
        elif u.path == "/trace":
            # Chrome trace-event JSON of the process-global tracer: save
            # the response body and open it in Perfetto/chrome://tracing.
            # With ?cursor=N (a cursor from a previous response) the
            # reply is INCREMENTAL — only records after the cursor, via
            # the same ring-delta seam telemetry frames use
            # (Tracer.records_since), so a polling scraper stops
            # re-serializing the whole ring under the ring lock. The
            # no-param default stays the full ring.
            from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

            cursor_q = (q.get("cursor") or [None])[0]
            tr = trace_mod.tracer()
            if cursor_q is None:
                doc = tr.to_chrome_trace()
                doc["cursor"] = tr.cursor()
                self._json(doc)
            else:
                try:
                    cur = int(cursor_q)
                except ValueError:
                    self._json({"error": "cursor must be an integer"},
                               400)
                    return
                recs, new_cursor, gap = tr.records_since(cur)
                self._json({
                    "traceEvents": [r.to_chrome() for r in recs],
                    "displayTimeUnit": "ms",
                    "cursor": new_cursor,
                    "gap": gap,
                })
        elif u.path == "/profile":
            self._json({"error": "not ported yet: /profile needs "
                                 "telemetry/introspect.py and profiler.py "
                                 "(ROADMAP A.11 item 3)"}, 501)
        elif u.path == "/slo":
            # SLO burn-rate status (telemetry/slo.py): one tick
            # (sample + evaluate) per request — the engine is
            # pull-driven, scraping IS the sampling cadence. Empty list
            # while the telemetry gate is off.
            from deeplearning4j_tpu_torch.telemetry import slo as slo_mod

            self._json({"slo": slo_mod.tick() or []})
        elif u.path == "/tune":
            self._json({"error": "not ported yet: /tune needs the "
                                 "closed-loop tuner, telemetry/tuner.py and "
                                 "tuning/* (ROADMAP A.11 item 4)"}, 501)
        elif u.path == "/models":
            # multi-model fleet snapshot (serving/router.py): registry
            # contents, per-version server state, rollout ramps, and the
            # router's per-version SLO rows. Pull-driven like /slo — each
            # scrape ticks evaluate() on every live router, so watching
            # this endpoint IS the rollout's control loop. The router
            # module is only consulted when ALREADY imported
            # (sys.modules, not an import): training-only processes
            # stay fleet-free.
            import sys as _sys

            router_mod = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.router")
            section = None
            if router_mod is not None:
                for r in list(router_mod._ROUTERS):
                    r.evaluate()
                section = router_mod.models_section()
            if section is None:
                self._json({"error": "no serving fleet in this process"},
                           404)
            else:
                self._json(section)
        elif u.path in ("/fleet/metrics", "/fleet/trace", "/fleet/slo",
                        "/fleet/status"):
            # fleet federation (telemetry/aggregate.py): the merged
            # view across every registered source — hosts, replicas,
            # spooled DCN frames. Each scrape ticks poll() (pull frames
            # from registered sources / drain spools), so scraping IS
            # the federation cadence — the collector runs no threads.
            # 404 while the telemetry gate is off: no collector state
            # exists, and the scrape must not allocate any.
            from deeplearning4j_tpu_torch.telemetry import (
                aggregate as agg_mod,
            )

            coll = agg_mod.collector()
            if coll is None:
                self._json({"error": "telemetry gate off "
                                     "(DL4J_TPU_TELEMETRY)"}, 404)
            elif u.path == "/fleet/metrics":
                coll.poll()
                self._text(coll.render(), "text/plain; version=0.0.4")
            elif u.path == "/fleet/trace":
                coll.poll()
                self._json(coll.merged_chrome_trace())
            elif u.path == "/fleet/slo":
                self._json({"slo": coll.slo_tick() or []})
            else:
                coll.poll()
                self._json(coll.status())
        elif u.path == "/fleet":
            # autoscaled replica pools (serving/autoscaler.py): replica
            # table, scaling signals vs hysteresis bands, storm-guard
            # and spawn-episode state, per-tenant quota/shed/latency.
            # Pull-driven like /models — each scrape ticks evaluate()
            # on every live autoscaler, so scraping this endpoint IS
            # the scaling control loop. Same sys.modules guard:
            # processes that never built a pool stay pool-free.
            import sys as _sys

            auto_mod = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.autoscaler")
            section = None
            if auto_mod is not None:
                for a in list(auto_mod._AUTOSCALERS):
                    if not a.stopped:
                        a.evaluate()
                section = auto_mod.fleet_section()
            if section is None:
                self._json({"error": "no autoscaled pool in this "
                                     "process"}, 404)
            else:
                self._json(section)
        elif u.path == "/healthz":
            # liveness verdict from the training health monitor
            # (telemetry/health.py): 503 until the first heartbeat (and
            # while a stall episode is open), the JSON snapshot after —
            # phase, iteration, step age, stragglers, input verdict.
            # Serving processes add breaker + queue state
            # (serving/runtime.py): 503 while any breaker is open, and a
            # live healthy serving runtime counts as liveness even
            # without a training heartbeat. The serving module is only
            # consulted when ALREADY imported (sys.modules, not an
            # import) so training-only processes allocate nothing.
            import sys as _sys

            from deeplearning4j_tpu_torch.telemetry import (
                health as health_mod,
            )

            snap = health_mod.healthz()
            srv_mod = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.runtime")
            if srv_mod is not None:
                serving_sec = srv_mod.healthz_section()
                if serving_sec is not None:
                    snap["serving"] = serving_sec
                    if serving_sec["breaker_open"]:
                        snap["ok"] = False
                        snap["reason"] = "serving circuit breaker open"
                    elif (not snap.get("ok")
                          and str(snap.get("reason", "")).startswith(
                              "no heartbeat yet")):
                        # ONLY the never-trained payload is overridden: a
                        # real training failure (open stall episode) must
                        # keep its 503 — a healthy serving side does not
                        # make a hung trainer live
                        snap["ok"] = True
                        snap["reason"] = ("serving runtime live "
                                          "(no training heartbeat)")
            # per-version fleet view (serving/router.py): model/version
            # inventory + rollout ramps merged under "models". Same
            # sys.modules guard — a rolled-back rollout is visible here
            # but does NOT flip liveness: the stable path is serving.
            router_mod = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.router")
            if router_mod is not None:
                models_sec = router_mod.models_section()
                if models_sec is not None:
                    snap["models"] = models_sec
            # autoscaled pool view (serving/autoscaler.py): replica
            # counts, storm guard, firing tenant SLOs merged under
            # "fleet". Same guard; an active storm guard or a bursting
            # tenant degrades nothing here — the quiet tenants are
            # being served, which is the point of the isolation.
            auto_mod = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.autoscaler")
            if auto_mod is not None:
                fleet_sec = auto_mod.fleet_section()
                if fleet_sec is not None:
                    snap["fleet"] = fleet_sec
            # SLO burn status (telemetry/slo.py): a firing burn-rate
            # alert degrades the process even while liveness is fine —
            # the pager and the load balancer read the same bit.
            # healthz_section() is gate-checked and never allocates.
            from deeplearning4j_tpu_torch.telemetry import slo as slo_mod

            slo_sec = slo_mod.healthz_section()
            if slo_sec is not None:
                snap["slo"] = slo_sec
                if slo_sec["firing"]:
                    snap["ok"] = False
                    snap["reason"] = ("slo burn-rate alert firing: "
                                      + ", ".join(slo_sec["firing"]))
            self._json(snap, 200 if snap.get("ok") else 503)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        if urlparse(self.path).path != "/remote":
            return self._json({"error": "not found"}, 404)
        n = int(self.headers.get("Content-Length", 0))
        try:
            report = json.loads(self.rfile.read(n))
        except json.JSONDecodeError:
            return self._json({"error": "bad json"}, 400)
        if not isinstance(report, dict) or \
                not isinstance(report.get("session_id"), str):
            # 4xx tells the router to DROP the report, not re-buffer it
            return self._json({"error": "report must be an object with a "
                                        "string session_id"}, 400)
        store = self.ui.remote_storage()
        try:
            if report.get("static"):
                store.put_static_info(report)
            else:
                store.put_update(report)
        except Exception as e:
            return self._json({"error": f"bad report: {e}"}, 400)
        self._json({"ok": True})


class UIServer:
    """Singleton HTTP dashboard (api/UIServer.java semantics)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000):
        self.port = port
        self._storages: List[StatsStorage] = []
        self._remote: Optional[InMemoryStatsStorage] = None
        self._embeddings: List[dict] = []
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.ui_server = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    def attach(self, storage: StatsStorage) -> "UIServer":
        if storage not in self._storages:
            self._storages.append(storage)
        return self

    def detach(self, storage: StatsStorage):
        if storage in self._storages:
            self._storages.remove(storage)

    def remote_storage(self) -> InMemoryStatsStorage:
        """Storage backing the /remote receiver (auto-attached on first POST)."""
        if self._remote is None:
            self._remote = InMemoryStatsStorage()
            self.attach(self._remote)
        return self._remote

    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if UIServer._instance is self:
            UIServer._instance = None

    def attach_embedding(self, vectors, labels=None,
                         title: str = "embedding", **tsne_kw) -> "UIServer":
        """The JAX server projects `vectors` with Barnes-Hut t-SNE and
        serves the scatter on /tsne; ui/embedding.py needs knn/tsne, which
        is not ported yet, so this raises (/api/tsne lists nothing)."""
        raise NotImplementedError(
            "attach_embedding needs ui/embedding.py and knn/tsne, which are "
            "not ported yet (ROADMAP A.11 item 6)")

    # ---- data access for the handler ----
    def _storage_for(self, sid: str) -> Optional[StatsStorage]:
        for st in self._storages:
            if sid in st.list_session_ids():
                return st
        return None

    def _static(self, sid: str) -> Optional[dict]:
        st = self._storage_for(sid)
        return (st.get_static_info(sid) or {}) if st is not None else None

    def _model_data(self, sid: str) -> dict:
        """Static info + the latest StatsListener update WITH histograms
        (the overview strips them; the model page is where they live)."""
        latest = None
        st = self._storage_for(sid)
        if st is not None:
            for u in reversed(st.get_all_updates(sid)):
                if u.get("type_id") != "ConvolutionalListener":
                    latest = u
                    break
        return {"static": self._static(sid), "latest": latest}

    def _system_data(self, sid: str) -> dict:
        ups = []
        st = self._storage_for(sid)
        if st is not None:
            for u in st.get_all_updates(sid)[-500:]:
                if u.get("type_id") == "ConvolutionalListener":
                    continue
                ups.append({"iteration": u.get("iteration"),
                            "memory": u.get("memory"),
                            "timing": u.get("timing")})
        return {"static": self._static(sid), "updates": ups}

    def _activation_grids(self, sid: str) -> List[dict]:
        """Latest ConvolutionalListener grid per layer."""
        by_layer: dict = {}
        st = self._storage_for(sid)
        if st is not None:
            for u in st.get_all_updates(sid):
                if u.get("type_id") == "ConvolutionalListener":
                    by_layer[u.get("layer")] = u
        return [by_layer[k] for k in sorted(by_layer)]

    def _sessions(self) -> List[dict]:
        out = []
        for st in self._storages:
            for sid in st.list_session_ids():
                info = st.get_static_info(sid) or {}
                out.append({"id": sid,
                            "model_class": info.get("model_class"),
                            "num_params": info.get("num_params"),
                            "backend": info.get("backend"),
                            "workers": st.list_worker_ids(sid)})
        return out

    def _updates(self, sid: str, limit: int) -> List[dict]:
        st = self._storage_for(sid)
        if st is None:
            return []
        ups = [u for u in st.get_all_updates(sid)
               if u.get("type_id") != "ConvolutionalListener"][-limit:]
        # strip histograms: the overview charts don't need them and
        # they dominate payload size
        slim = []
        for u in ups:
            u = dict(u)
            for key in ("params", "updates"):
                if key in u:
                    u[key] = {
                        k: {kk: vv for kk, vv in v.items()
                            if kk != "histogram"}
                        for k, v in u[key].items()}
            slim.append(u)
        return slim
