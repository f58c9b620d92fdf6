"""Browser-served XcorrDB results viewer (stdlib http.server + inline SVG).

Feature parity with the reference's interactive dearpygui browser
(xcorrDatabase/viewer.py:19-342): open one or more databases,
list the xcorr_metadata registry, browse each results table, inspect blob
columns as hex/uint8 text, and plot type-1 rows as linked QF^2-vs-TD and
freq-index-vs-TD charts with the peak annotated (viewer.py plotDataWindow
:309-342). Beyond the reference: type-2 rows render as a TDxFD CAF heatmap
(the reference raises NotImplementedError for 2-D, viewer.py:166) and type-0
peak tables get a QF^2-vs-TD scatter.

Design: no GUI toolkit and no third-party JS — a ThreadingHTTPServer serving
one self-contained HTML page plus a tiny JSON API, so the whole tier is
drivable headlessly (tests/test_webviewer.py) and usable over SSH port
forwarding, which is how results browsing actually happens next to a
compute cluster.

API:
  GET /                 the single-page app
  GET /api/dbs          [{db, tables: [{name, fc, fs, s1, s2, xctype}]}]
  GET /api/rows         ?db=I&table=T -> {cols, xctype, rows} (blobs -> meta)
  GET /api/result       ?db=I&table=T&rowid=R -> decoded arrays for plotting
  GET /api/blob         ?db=I&table=T&rowid=R&col=C -> uint8 preview

A copy of the JAX package's ``pydsproutines_tpu/viz/webviewer.py``, which
does not import JAX: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_MAX_HEATMAP_CELLS = 512 * 512
_MAX_BLOB_PREVIEW = 4096


def _connect(path: str) -> sqlite3.Connection:
    # one connection per request: sqlite3 objects are not thread-safe and
    # ThreadingHTTPServer handles each request on its own thread
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    con.row_factory = sqlite3.Row
    return con


def _table_names(con: sqlite3.Connection) -> set[str]:
    rows = con.execute(
        "SELECT name FROM sqlite_master WHERE type='table'").fetchall()
    return {r["name"] for r in rows}


def _td_axis(row: dict) -> np.ndarray | None:
    """TD scan axis from the base columns (reference regenerate1Dresults)."""
    start, nsteps, step = (row.get("td_scan_start"),
                           row.get("td_scan_numsteps"), row.get("td_scan_step"))
    if nsteps is None:
        return None
    start = 0.0 if start is None else float(start)
    step = 1.0 if step is None else float(step)
    return start + np.arange(int(nsteps)) * step


def _fd_axis(row: dict) -> np.ndarray | None:
    nsteps = row.get("fd_scan_numsteps")
    if nsteps is None:
        return None
    start = float(row.get("fd_scan_start") or 0.0)
    step = float(row.get("fd_scan_step") or 1.0)
    return start + np.arange(int(nsteps)) * step


class XcorrWebViewer:
    """Serve one or more XcorrDB sqlite files for browsing/plotting."""

    def __init__(self, dbpaths):
        if isinstance(dbpaths, (str, bytes)):
            dbpaths = [dbpaths]
        self.dbpaths = [str(p) for p in dbpaths]

    # ------------------------------------------------------------------ API
    def api_dbs(self):
        out = []
        for i, path in enumerate(self.dbpaths):
            con = _connect(path)
            try:
                tables = []
                if "xcorr_metadata" in _table_names(con):
                    for r in con.execute("SELECT * FROM xcorr_metadata"):
                        d = dict(r)
                        desc = d.get("desc")
                        tables.append({
                            "name": d["data_tblname"], "fc": d.get("fc"),
                            "fs": d.get("fs"), "s1": d.get("s1"),
                            "s2": d.get("s2"), "xctype": d.get("xctype"),
                            "desc": (desc.decode("utf-8", "replace")
                                     if isinstance(desc, bytes) else desc),
                        })
                out.append({"db": path, "index": i, "tables": tables})
            finally:
                con.close()
        return out

    def _xctype(self, con, table: str) -> int:
        r = con.execute(
            "SELECT xctype FROM xcorr_metadata WHERE data_tblname=?",
            (table,)).fetchone()
        if r is None:
            raise KeyError(f"table {table!r} not registered in xcorr_metadata")
        return int(r["xctype"])

    def _check(self, con, table: str):
        if table not in _table_names(con):
            raise KeyError(f"no such table {table!r}")

    def api_rows(self, db: int, table: str):
        con = _connect(self.dbpaths[db])
        try:
            self._check(con, table)
            xctype = self._xctype(con, table)
            rows, cols = [], None
            for r in con.execute(f'SELECT rowid AS _rowid, * FROM "{table}"'):
                d = dict(r)
                if cols is None:
                    cols = list(d.keys())
                rows.append([
                    {"_blob": len(v)} if isinstance(v, bytes) else v
                    for v in d.values()])
            return {"cols": cols or [], "xctype": xctype, "rows": rows}
        finally:
            con.close()

    def api_result(self, db: int, table: str, rowid: int):
        con = _connect(self.dbpaths[db])
        try:
            self._check(con, table)
            xctype = self._xctype(con, table)
            r = con.execute(
                f'SELECT rowid AS _rowid, * FROM "{table}" WHERE rowid=?',
                (rowid,)).fetchone()
            if r is None:
                raise KeyError(f"rowid {rowid} not in {table!r}")
            d = dict(r)
            if xctype == 0:
                return {"xctype": 0, "row": {
                    k: (None if isinstance(v, bytes) else v)
                    for k, v in d.items()}}
            if xctype == 1:
                qf2 = np.frombuffer(d["qf2"], dtype=np.float64)
                fi = np.frombuffer(d["freqIdx"], dtype=np.uint32)
                td = _td_axis(d)
                if td is None or len(td) != len(qf2):
                    td = np.arange(len(qf2), dtype=float)
                mi = int(np.argmax(qf2)) if len(qf2) else 0
                return {"xctype": 1, "td": td.tolist(),
                        "qf2": qf2.tolist(), "freq_idx": fi.tolist(),
                        "peak": {"qf2": float(qf2[mi]) if len(qf2) else None,
                                 "td": float(td[mi]) if len(qf2) else None,
                                 "freq_idx": int(fi[mi]) if len(fi) else None}}
            # xctype == 2: full CAF heatmap, downsampled for transfer
            caf = np.frombuffer(d["caf"], dtype=np.float64)
            ntd = int(d.get("td_scan_numsteps") or 0)
            if ntd <= 0 or caf.size % ntd:
                ntd = 1
            caf = caf.reshape(ntd, -1)
            td = _td_axis(d)
            fd = _fd_axis(d)
            if td is None or len(td) != caf.shape[0]:
                td = np.arange(caf.shape[0], dtype=float)
            if fd is None or len(fd) != caf.shape[1]:
                fd = np.arange(caf.shape[1], dtype=float)
            dst, dsf = 1, 1
            while (caf.shape[0] // dst) * (caf.shape[1] // dsf) > _MAX_HEATMAP_CELLS:
                if caf.shape[0] // dst >= caf.shape[1] // dsf:
                    dst *= 2
                else:
                    dsf *= 2
            caf_ds = caf[::dst, ::dsf]
            i, j = np.unravel_index(int(np.argmax(caf)), caf.shape)
            return {"xctype": 2, "caf": caf_ds.tolist(),
                    "td": td[::dst].tolist(), "fd": fd[::dsf].tolist(),
                    "downsample": [dst, dsf],
                    "peak": {"qf2": float(caf[i, j]), "td": float(td[i]),
                             "fd": float(fd[j])}}
        finally:
            con.close()

    def api_blob(self, db: int, table: str, rowid: int, col: str):
        con = _connect(self.dbpaths[db])
        try:
            self._check(con, table)
            cols = [r[1] for r in con.execute(f'PRAGMA table_info("{table}")')]
            if col not in cols:
                raise KeyError(f"no such column {col!r}")
            r = con.execute(
                f'SELECT "{col}" FROM "{table}" WHERE rowid=?',
                (rowid,)).fetchone()
            if r is None or not isinstance(r[0], bytes):
                raise KeyError("not a blob")
            raw = r[0]
            u8 = np.frombuffer(raw[:_MAX_BLOB_PREVIEW], dtype=np.uint8)
            return {"nbytes": len(raw), "truncated": len(raw) > len(u8),
                    "uint8": u8.tolist(),
                    "hex": " ".join(f"{b:02X}" for b in u8)}
        finally:
            con.close()

    # -------------------------------------------------------------- server
    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def do_GET(self):
                url = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                try:
                    if url.path == "/":
                        self._send(200, _PAGE.encode(),
                                   "text/html; charset=utf-8")
                    elif url.path == "/api/dbs":
                        self._json(viewer.api_dbs())
                    elif url.path == "/api/rows":
                        self._json(viewer.api_rows(
                            int(q["db"]), q["table"]))
                    elif url.path == "/api/result":
                        self._json(viewer.api_result(
                            int(q["db"]), q["table"], int(q["rowid"])))
                    elif url.path == "/api/blob":
                        self._json(viewer.api_blob(
                            int(q["db"]), q["table"], int(q["rowid"]),
                            q["col"]))
                    else:
                        self._json({"error": "not found"}, 404)
                except (KeyError, IndexError, ValueError) as e:
                    self._json({"error": str(e)}, 400)

        return ThreadingHTTPServer((host, port), Handler)

    def serve_background(self, host: str = "127.0.0.1", port: int = 0):
        """Start serving on a daemon thread; returns (server, actual_port)."""
        srv = self.make_server(host, port)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, srv.server_address[1]


# --------------------------------------------------------------------- page
# Single-series charts carry no legend (the title names the series); hover
# crosshair + tooltip on lines, per-cell tooltip on the heatmap; palette =
# validated default (series blue #2a78d6 light / #3987e5 dark; sequential =
# one-hue blue ramp); text wears ink tokens, never series color.
_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>XcorrDB Viewer</title>
<style>
:root{color-scheme:light;
 --surface:#fcfcfb;--panel:#f2f1ee;--ink:#0b0b0b;--ink2:#52514e;
 --grid:#e4e2dc;--series:#2a78d6;--accent:#eb6834}
@media (prefers-color-scheme: dark){:root{color-scheme:dark;
 --surface:#1a1a19;--panel:#232322;--ink:#ffffff;--ink2:#c3c2b7;
 --grid:#3a3935;--series:#3987e5;--accent:#d95926}}
body{margin:0;font:14px/1.45 system-ui,sans-serif;background:var(--surface);
 color:var(--ink);display:flex;min-height:100vh}
#side{width:260px;min-width:260px;background:var(--panel);padding:12px;
 border-right:1px solid var(--grid)}
#main{flex:1;padding:16px;overflow:auto}
h1{font-size:16px;margin:0 0 10px}h2{font-size:14px;margin:14px 0 6px}
.db{margin-bottom:10px}.dbpath{font-size:12px;color:var(--ink2);
 word-break:break-all}
button.tbl{display:block;width:100%;text-align:left;margin:3px 0;padding:5px 8px;
 border:1px solid var(--grid);border-radius:6px;background:var(--surface);
 color:var(--ink);cursor:pointer}
button.tbl:hover{border-color:var(--series)}
table{border-collapse:collapse;font-size:12.5px;margin:6px 0}
th,td{border:1px solid var(--grid);padding:3px 8px;text-align:right}
th{color:var(--ink2);font-weight:600}
td.blob button,td .act{padding:1px 7px;font-size:12px;cursor:pointer;
 border:1px solid var(--grid);border-radius:5px;background:var(--panel);
 color:var(--ink)}
#plots svg{display:block;margin:8px 0;background:var(--surface)}
.meta{color:var(--ink2);font-size:12.5px}
#blobview{white-space:pre-wrap;word-break:break-all;font:12px monospace;
 background:var(--panel);border:1px solid var(--grid);border-radius:6px;
 padding:8px;max-height:200px;overflow:auto;margin:6px 0}
#tip{position:fixed;pointer-events:none;background:var(--panel);
 border:1px solid var(--grid);border-radius:6px;padding:4px 8px;
 font-size:12px;display:none;z-index:5}
.peak{color:var(--ink2)}
</style></head><body>
<div id="side"><h1>XcorrDB Viewer</h1><div id="dblist">loading…</div></div>
<div id="main"><div class="meta">Select a results table.</div></div>
<div id="tip"></div>
<script>
"use strict";
const $=s=>document.querySelector(s);
const esc=s=>String(s).replace(/[&<>"]/g,c=>({"&":"&amp;","<":"&lt;",
 ">":"&gt;",'"':"&quot;"}[c]));
const fmt=v=>v==null?"":(typeof v==="number"&&!Number.isInteger(v)?
 v.toPrecision(6):v);
const tip=$("#tip");
function showTip(ev,html){tip.innerHTML=html;tip.style.display="block";
 tip.style.left=(ev.clientX+14)+"px";tip.style.top=(ev.clientY+10)+"px";}
function hideTip(){tip.style.display="none";}
async function j(url){const r=await fetch(url);const d=await r.json();
 if(!r.ok)throw new Error(d.error||r.status);return d;}

const XCTYPE={0:"scalar peaks",1:"1-D qf2",2:"2-D CAF"};
async function loadDbs(){
 const dbs=await j("/api/dbs");
 $("#dblist").innerHTML=dbs.map(d=>`<div class="db">
  <div class="dbpath">${esc(d.db)}</div>${d.tables.map(t=>
  `<button class="tbl" data-db="${d.index}" data-t="${esc(t.name)}">
   ${esc(t.name)} <span class="meta">(${XCTYPE[t.xctype]??t.xctype})</span>
  </button>`).join("")}</div>`).join("")||"no tables";
 document.querySelectorAll("button.tbl").forEach(b=>b.onclick=
  ()=>loadTable(+b.dataset.db,b.dataset.t));
}
let cur={};
async function loadTable(db,table){
 cur={db,table};
 const d=await j(`/api/rows?db=${db}&table=${encodeURIComponent(table)}`);
 const hide=new Set(["_rowid"]);
 const cols=d.cols.filter(c=>!hide.has(c));
 const ridIdx=d.cols.indexOf("_rowid");
 let html=`<h2>${esc(table)} <span class="meta">— ${XCTYPE[d.xctype]}, `+
  `${d.rows.length} rows</span></h2><table><tr>`+
  cols.map(c=>`<th>${esc(c)}</th>`).join("")+
  (d.xctype!==0?"<th>view</th>":"")+"</tr>";
 for(const r of d.rows){
  const rid=r[ridIdx];
  html+="<tr>"+d.cols.map((c,i)=>{
   if(hide.has(c))return "";
   const v=r[i];
   if(v&&typeof v==="object"&&"_blob"in v)
    return `<td class="blob"><button data-rid="${rid}" data-col="${esc(c)}">`+
     `BLOB ${v._blob}B</button></td>`;
   return `<td>${esc(fmt(v))}</td>`;}).join("")+
   (d.xctype!==0?`<td><button class="act plot" data-rid="${rid}">plot</button></td>`:"")+
   "</tr>";
 }
 html+="</table><div id='blobwrap'></div><div id='plots'></div>";
 $("#main").innerHTML=html;
 document.querySelectorAll("td.blob button").forEach(b=>b.onclick=
  ()=>showBlob(+b.dataset.rid,b.dataset.col));
 document.querySelectorAll("button.plot").forEach(b=>b.onclick=
  ()=>plotRow(+b.dataset.rid));
 if(d.xctype===0)plotType0(d);
}
let blobHex=true,blobData=null;
async function showBlob(rid,col){
 blobData=await j(`/api/blob?db=${cur.db}&table=${encodeURIComponent(cur.table)}`+
  `&rowid=${rid}&col=${encodeURIComponent(col)}`);
 $("#blobwrap").innerHTML=`<div class="meta">${col} — ${blobData.nbytes} bytes`+
  (blobData.truncated?" (preview truncated)":"")+
  ` <button class="act" id="hextoggle">toggle hex/uint8</button></div>`+
  `<div id="blobview"></div>`;
 const render=()=>{$("#blobview").textContent=blobHex?blobData.hex:
  blobData.uint8.map(v=>String(v).padStart(3)).join(" ");};
 $("#hextoggle").onclick=()=>{blobHex=!blobHex;render();};
 render();
}
// ---- SVG helpers -----------------------------------------------------------
const W=640,H=220,M={l:64,r:12,t:10,b:30};
function scale(dom,rng){const d=dom[1]-dom[0]||1;
 return v=>rng[0]+(v-dom[0])/d*(rng[1]-rng[0]);}
function ticks(lo,hi,n){const span=hi-lo||1,
 step=Math.pow(10,Math.floor(Math.log10(span/n))),
 err=span/n/step,m=err>=7.5?10:err>=3.5?5:err>=1.5?2:1,s=m*step,out=[];
 for(let v=Math.ceil(lo/s)*s;v<=hi+1e-12*span;v+=s)out.push(v);return out;}
function lineChart(title,xs,ys,xl,yl,peak){
 const xd=[Math.min(...xs),Math.max(...xs)],yd=[Math.min(...ys),Math.max(...ys)];
 if(yd[0]===yd[1]){yd[0]-=1;yd[1]+=1;}
 const sx=scale(xd,[M.l,W-M.r]),sy=scale(yd,[H-M.b,M.t]);
 let g="";
 for(const t of ticks(yd[0],yd[1],4))g+=`<line x1="${M.l}" x2="${W-M.r}" `+
  `y1="${sy(t)}" y2="${sy(t)}" stroke="var(--grid)"/>`+
  `<text x="${M.l-6}" y="${sy(t)+4}" text-anchor="end" fill="var(--ink2)" `+
  `font-size="11">${+t.toPrecision(4)}</text>`;
 for(const t of ticks(xd[0],xd[1],6))g+=`<text x="${sx(t)}" y="${H-8}" `+
  `text-anchor="middle" fill="var(--ink2)" font-size="11">`+
  `${+t.toPrecision(4)}</text>`;
 const pts=xs.map((x,i)=>`${sx(x).toFixed(1)},${sy(ys[i]).toFixed(1)}`).join(" ");
 let pk="";
 if(peak)pk=`<circle cx="${sx(peak[0])}" cy="${sy(peak[1])}" r="4" `+
  `fill="var(--accent)" stroke="var(--surface)" stroke-width="2"/>`;
 return `<figure><figcaption class="meta">${esc(title)}</figcaption>`+
  `<svg viewBox="0 0 ${W} ${H}" width="${W}" height="${H}" class="line" `+
  `data-xs="${xs.map(v=>+v.toPrecision(7))}" data-ys="${ys.map(v=>+v.toPrecision(7))}" `+
  `data-xl="${esc(xl)}" data-yl="${esc(yl)}">`+g+
  `<polyline points="${pts}" fill="none" stroke="var(--series)" `+
  `stroke-width="2" stroke-linejoin="round"/>`+pk+
  `<line class="cross" y1="${M.t}" y2="${H-M.b}" stroke="var(--ink2)" `+
  `stroke-dasharray="3 3" visibility="hidden"/>`+
  `<text x="${M.l}" y="${H-8}" fill="var(--ink2)" font-size="11">${esc(xl)}</text>`+
  `</svg></figure>`;}
function wireLineHover(){
 document.querySelectorAll("svg.line").forEach(svg=>{
  const xs=svg.dataset.xs.split(",").map(Number),
   ys=svg.dataset.ys.split(",").map(Number),
   xd=[Math.min(...xs),Math.max(...xs)],
   sx=scale(xd,[M.l,W-M.r]),cross=svg.querySelector(".cross");
  svg.addEventListener("mousemove",ev=>{
   const r=svg.getBoundingClientRect(),
    px=(ev.clientX-r.left)*W/r.width,
    xv=xd[0]+(px-M.l)/(W-M.l-M.r)*(xd[1]-xd[0]);
   let best=0,bd=1/0;
   xs.forEach((x,i)=>{const d=Math.abs(x-xv);if(d<bd){bd=d;best=i;}});
   cross.setAttribute("x1",sx(xs[best]));cross.setAttribute("x2",sx(xs[best]));
   cross.setAttribute("visibility","visible");
   showTip(ev,`${svg.dataset.xl}: <b>${+xs[best].toPrecision(6)}</b><br>`+
    `${svg.dataset.yl}: <b>${+ys[best].toPrecision(6)}</b>`);});
  svg.addEventListener("mouseleave",()=>{hideTip();
   cross.setAttribute("visibility","hidden");});});}
// one-hue sequential ramp (surface -> series blue -> ink) for magnitude
function seq(t){const a=[252,252,251],b=[42,120,214],c=[8,28,60];
 const mix=(u,v,s)=>u.map((x,i)=>Math.round(x+(v[i]-x)*s));
 const rgb=t<0.5?mix(a,b,t*2):mix(b,c,(t-0.5)*2);
 return `rgb(${rgb[0]},${rgb[1]},${rgb[2]})`;}
async function plotRow(rid){
 const d=await j(`/api/result?db=${cur.db}&table=${encodeURIComponent(cur.table)}`+
  `&rowid=${rid}`);
 if(d.xctype===1){
  $("#plots").innerHTML=
   `<div class="peak">peak QF² <b>${+d.peak.qf2.toPrecision(6)}</b> at `+
   `TD <b>${+d.peak.td.toPrecision(6)}</b>, freq index `+
   `<b>${d.peak.freq_idx}</b></div>`+
   lineChart("QF² vs TD",d.td,d.qf2,"TD","QF²",[d.peak.td,d.peak.qf2])+
   lineChart("Frequency index vs TD",d.td,d.freq_idx.map(Number),"TD",
    "freq index",[d.peak.td,d.peak.freq_idx]);
  wireLineHover();
 }else if(d.xctype===2){
  const nr=d.caf.length,nc=d.caf[0].length;
  let lo=1/0,hi=-1/0;
  d.caf.forEach(r=>r.forEach(v=>{if(v<lo)lo=v;if(v>hi)hi=v;}));
  const cw=Math.max(1,Math.floor(560/nc)),ch=Math.max(1,Math.floor(360/nr));
  const cv=document.createElement("canvas");
  cv.width=nc*cw;cv.height=nr*ch;
  const ctx=cv.getContext("2d");
  d.caf.forEach((row,i)=>row.forEach((v,jj)=>{
   ctx.fillStyle=seq((v-lo)/(hi-lo||1));
   ctx.fillRect(jj*cw,i*ch,cw,ch);}));
  $("#plots").innerHTML=
   `<div class="peak">peak QF² <b>${+d.peak.qf2.toPrecision(6)}</b> at `+
   `TD <b>${+d.peak.td.toPrecision(6)}</b>, FD <b>${+d.peak.fd.toPrecision(6)}</b>`+
   (d.downsample[0]*d.downsample[1]>1?` <span class="meta">(display `+
   `downsampled ${d.downsample[0]}×${d.downsample[1]})</span>`:"")+`</div>`+
   `<figure><figcaption class="meta">CAF (TD rows × FD cols) — `+
   `light→dark = low→high QF²</figcaption></figure>`;
  $("#plots figure").appendChild(cv);
  cv.addEventListener("mousemove",ev=>{
   const r=cv.getBoundingClientRect(),
    jj=Math.min(nc-1,Math.floor((ev.clientX-r.left)/r.width*nc)),
    i=Math.min(nr-1,Math.floor((ev.clientY-r.top)/r.height*nr));
   showTip(ev,`TD <b>${+d.td[i].toPrecision(6)}</b>, `+
    `FD <b>${+d.fd[jj].toPrecision(6)}</b><br>QF² <b>`+
    `${+d.caf[i][jj].toPrecision(6)}</b>`);});
  cv.addEventListener("mouseleave",hideTip);
 }else{
  $("#plots").innerHTML=`<pre>${esc(JSON.stringify(d.row,null,1))}</pre>`;
 }
}
function plotType0(d){
 const it=d.cols.indexOf("td"),iq=d.cols.indexOf("qf2");
 if(it<0||iq<0)return;
 const xs=d.rows.map(r=>r[it]).filter(v=>typeof v==="number"),
  ys=d.rows.map(r=>r[iq]).filter(v=>typeof v==="number");
 if(xs.length<1||xs.length!==ys.length)return;
 $("#plots").innerHTML=lineChart("Peak QF² vs TD",xs,ys,"TD","QF²",null)
  .replace('<polyline','<polyline visibility="hidden"')+
  "";
 const svg=$("#plots svg"),xd=[Math.min(...xs),Math.max(...xs)],
  yd=[Math.min(...ys),Math.max(...ys)];
 const sx=scale(xd,[M.l,W-M.r]),
  sy=scale(yd[0]===yd[1]?[yd[0]-1,yd[1]+1]:yd,[H-M.b,M.t]);
 xs.forEach((x,i)=>{const c=document.createElementNS(
  "http://www.w3.org/2000/svg","circle");
  c.setAttribute("cx",sx(x));c.setAttribute("cy",sy(ys[i]));
  c.setAttribute("r",4);c.setAttribute("fill","var(--series)");
  c.setAttribute("stroke","var(--surface)");c.setAttribute("stroke-width",2);
  svg.appendChild(c);});
 wireLineHover();
}
loadDbs();
</script></body></html>
"""


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="XcorrDB web viewer")
    ap.add_argument("dbpaths", nargs="+", help="sqlite xcorr database(s)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    args = ap.parse_args(argv)
    viewer = XcorrWebViewer(args.dbpaths)
    srv = viewer.make_server(args.host, args.port)
    print(f"serving on http://{args.host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
