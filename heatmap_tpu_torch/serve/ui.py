"""Embedded Leaflet map UI.

A copy of ``heatmap_tpu/serve/ui.py``, byte for byte in the page it
renders (its space-time history slider answers "history fetch failed"
against the port's 501 for ``/api/tiles/range``).  A hex choropleth over the latest window, vehicle
markers with popups, periodic refresh of both endpoints, waiting toast,
auto-fit.  Additions over the reference: a live metrics readout (events/sec,
batch p50) fed by /metrics.json, and a count/speed legend.

Tile refresh rides the query tier: the UI polls ``/api/tiles/delta``
with its last-seen view seq and upserts only the changed hexes (a
mode="full" response replaces the set).  It negotiates the BINARY
columnar frame first (``?fmt=bin``, serve/wire.py — decoded with a
DataView/BigInt parser, ~10x fewer wire bytes): binary deltas restyle
known hexes in place (geometry is a pure function of the cellId and
already on the map), while a resync or an unseen cell falls through to
one full JSON fetch that restores geometry; any negotiation or decode
trouble latches the session back to JSON automatically.  The HUD shows
the negotiated format and the wire bytes the binary path saved.  A
delta failure falls back to a full ``/api/tiles/latest`` fetch for
that tick; only a 404 (older server) or 503 (view disabled) latches
full-fetch mode for the session — transient blips retry delta on the
next tick.

Continuous queries ride along: registered geofence/range regions
(``/api/queries``) draw as dashed outlines, and up to four of them get
a live ``EventSource`` on ``/api/queries/stream`` — a pushed match
flashes the fence outline and, when the matched cell is on the map,
the cell polygon itself.  Workers without the engine (404/503) skip
the layer silently; the query list refreshes once a minute so fences
registered after page load appear.

Streaming-inference overlays (infer.engine) degrade the same
way: tiles carrying the optional ``vxKmh``/``vyKmh`` velocity columns
draw a per-cell arrow along the smoothed field (absent columns — the
count-only configuration — draw nothing), and ``anomaly`` standing
queries ride the same EventSource as fences: a pushed anomaly match
drops a pulsing marker at the event position naming the entity and
reason, with the plain fence flash as the fallback when the event has
no coordinates."""

from __future__ import annotations

_PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>heatmap-tpu — live mobility</title>
<meta name="viewport" content="width=device-width,initial-scale=1"/>
<link rel="stylesheet" href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<style>
  html, body, #map { height: 100%; margin: 0; }
  .hud {
    position: absolute; bottom: 12px; left: 12px; z-index: 1000;
    background: rgba(255,255,255,.92); border-radius: 8px;
    padding: 8px 12px; font: 12px/1.5 system-ui, sans-serif;
    box-shadow: 0 1px 4px rgba(0,0,0,.3);
  }
  .hud .swatch { display:inline-block; width:12px; height:12px;
                 border-radius:2px; margin-right:4px; vertical-align:-2px; }
  #status {
    position: absolute; top: 12px; left: 50%; transform: translateX(-50%);
    z-index: 1000; background: rgba(20,20,20,.8); color: #fff;
    padding: 5px 12px; border-radius: 14px; font: 12px system-ui, sans-serif;
    visibility: hidden;
  }
  #histbar {
    position: absolute; bottom: 12px; left: 50%; transform: translateX(-50%);
    z-index: 1000; background: rgba(255,255,255,.92); border-radius: 8px;
    padding: 6px 12px; font: 12px system-ui, sans-serif;
    box-shadow: 0 1px 4px rgba(0,0,0,.3); display: none;
    white-space: nowrap;
  }
  #histbar input[type=range] { width: 280px; vertical-align: middle; }
  #histbtn {
    position: absolute; top: 12px; right: 12px; z-index: 1000;
    background: rgba(255,255,255,.92); border-radius: 8px; border: 0;
    padding: 6px 10px; font: 12px system-ui, sans-serif; cursor: pointer;
    box-shadow: 0 1px 4px rgba(0,0,0,.3);
  }
</style>
</head>
<body>
<div id="map"></div>
<div id="status"></div>
<div class="hud" id="hud">loading…</div>
<button id="histbtn" title="scrub the space-time history tier">&#x23f1; history</button>
<div id="histbar">
  <input type="range" id="histslider" min="0" max="0" value="0"/>
  <span id="histlabel"></span>
  <button id="histlive">live</button>
</div>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<script>
"use strict";
const REFRESH_MS = __REFRESH_MS__;
// [resolution, grid] pairs of the multi-res pyramid (default window),
// lowest res first; empty/single => fixed default grid, as the reference
const GRIDS = __GRIDS__;
const RAMP = [[0,'#ffffcc'],[3,'#ffeda0'],[6,'#fed976'],[11,'#feb24c'],
              [21,'#fd8d3c'],[51,'#f03b20'],[101,'#bd0026']];

const map = L.map('map', {zoomControl: true}).setView([42.3601, -71.0589], 12);
L.tileLayer('https://tile.openstreetmap.org/{z}/{x}/{y}.png', {
  maxZoom: 19, attribution: '&copy; OpenStreetMap contributors'
}).addTo(map);

const cellLayers = new Map();  // cellId -> layer (delta upserts)
const hexes = L.geoJSON(null, {
  style: f => ({weight: 0.7, color: '#666', fillOpacity: 0.55,
                fillColor: rampColor(f.properties.count)}),
  onEachFeature: (f, layer) => {
    const p = f.properties;
    let html = `<b>${esc(p.cellId)}</b><br/>count: ${Number(p.count)}` +
               `<br/>avg speed: ${Number(p.avgSpeedKmh).toFixed(1)} km/h`;
    if (p.p95SpeedKmh !== undefined)
      html += `<br/>p95 speed: ${Number(p.p95SpeedKmh).toFixed(1)} km/h`;
    if (p.vxKmh !== undefined && p.vyKmh !== undefined)
      html += `<br/>velocity: ${Math.hypot(Number(p.vxKmh),
               Number(p.vyKmh)).toFixed(1)} km/h`;
    layer.bindPopup(html);
    cellLayers.set(p.cellId, layer);
  }
}).addTo(map);
const vehicles = L.layerGroup().addTo(map);
// inference velocity-field arrows (optional vxKmh/vyKmh tile columns)
const velArrows = L.layerGroup().addTo(map);
const arrowLayers = new Map();              // cellId -> arrow layer

function rampColor(c) {
  let col = RAMP[0][1];
  for (const [min, color] of RAMP) if (c >= min) col = color;
  return col;
}

function esc(v) {  // event fields are untrusted ingress data
  return String(v).replace(/[&<>"']/g,
    ch => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[ch]));
}

function status(msg) {
  const el = document.getElementById('status');
  el.textContent = msg;
  el.style.visibility = 'visible';
  clearTimeout(status._t);
  status._t = setTimeout(() => el.style.visibility = 'hidden', 2000);
}

// zoom-adaptive pyramid: the finest resolution whose detail the current
// zoom can show (threshold ~1.5*res - 1: res 7 from z10, 8 from z11, 9
// from z12.5); coarser cells when zoomed out keep tile counts sane
function gridForZoom(z) {
  if (GRIDS.length < 2) return GRIDS.length ? GRIDS[0][1] : null;
  let g = GRIDS[0][1];
  for (const [res, grid] of GRIDS) if (z >= 1.5 * res - 1) g = grid;
  return g;
}
let activeGrid = null;
map.on('zoomend', () => {
  const g = gridForZoom(map.getZoom());
  if (g !== activeGrid) tick();
});

let fitted = false;
let tickSeq = 0;
// delta-sync state: the last view seq applied, per active grid; reset
// on grid switch (each grid's delta stream is independent)
let tilesSince = 0;
let deltaBroken = false;  // one failure -> full fetches for the session
// binary wire negotiation: try the compact columnar frame first
// (?fmt=bin, serve/wire.py); any decode/endpoint trouble latches the
// session back to JSON — the automatic fallback
let wireFmt = 'bin';
let wireBytes = 0;      // wire bytes received on binary tile polls
let wireSaved = 0;      // estimated JSON bytes the binary path avoided
let jsonPerFeat = 600;  // learned from real full-JSON bodies

function clearHexes() {
  hexes.clearLayers();
  cellLayers.clear();
  velArrows.clearLayers();
  arrowLayers.clear();
}

// one arrow along the cell's smoothed velocity: shaft = ~30 s of
// travel at the field speed, head = two short back-swept segments.
// No-op (and removes a stale arrow) when the tile carries no velocity
// columns — the count-only configuration renders exactly as before.
function updateArrow(cellId, p, center) {
  const old = arrowLayers.get(cellId);
  if (old) { velArrows.removeLayer(old); arrowLayers.delete(cellId); }
  if (p.vxKmh === undefined || p.vyKmh === undefined || !center) return;
  const vx = Number(p.vxKmh), vy = Number(p.vyKmh);
  const spd = Math.hypot(vx, vy);
  if (!(spd > 0.5)) return;           // parked cells stay clean
  const mPerDeg = 111320;
  const cos = Math.max(Math.cos(center.lat * Math.PI / 180), 1e-6);
  const dLat = (vy / 3.6) * 30 / mPerDeg;
  const dLng = (vx / 3.6) * 30 / (mPerDeg * cos);
  const tip = [center.lat + dLat, center.lng + dLng];
  const ang = Math.atan2(dLat, dLng * cos);
  const hl = Math.hypot(dLat, dLng * cos) * 0.35;
  const head = a => [tip[0] - hl * Math.sin(a),
                     tip[1] - hl * Math.cos(a) / cos];
  const arrow = L.polyline(
    [[center.lat, center.lng], tip, head(ang + 0.5), tip, head(ang - 0.5)],
    {color: '#083d77', weight: 2, opacity: 0.85, interactive: false});
  velArrows.addLayer(arrow);
  arrowLayers.set(cellId, arrow);
}

function applyFeatures(features) {
  for (const f of features) {
    const old = cellLayers.get(f.properties.cellId);
    if (old) hexes.removeLayer(old);
    hexes.addData(f);  // onEachFeature re-registers the cellId
    const layer = cellLayers.get(f.properties.cellId);
    if (layer && layer.getBounds)
      updateArrow(f.properties.cellId, f.properties,
                  layer.getBounds().getCenter());
  }
}

// ---- binary wire frame decoder (serve/wire.py layout, DataView) ----
function decodeWireFrame(buf) {
  const dv = new DataView(buf);
  const u8 = new Uint8Array(buf);
  if (u8.length < 12 || u8[0] !== 0x48 || u8[1] !== 0x57 || u8[2] !== 1)
    throw new Error('not a wire frame');
  const flags = u8[3];
  const seq = Number(dv.getBigUint64(4, true));
  const glen = dv.getUint16(12, true);
  let pos = 14 + glen;
  if (flags & 2) pos += 16;  // window (ws_us, we_us) — unused by the map
  function varint() {
    let shift = 0n, v = 0n;
    for (;;) {
      const b = u8[pos++];
      v |= BigInt(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7n;
    }
  }
  const zz = u => (u >> 1n) ^ -(u & 1n);
  const n = Number(varint());
  const dflags = u8.subarray(pos, pos + n); pos += n;
  const M = (1n << 64n) - 1n;
  const cells = []; let prev = 0n;
  for (let i = 0; i < n; i++) {
    prev = (prev + zz(varint())) & M;
    cells.push(prev.toString(16));
  }
  const counts = [];
  for (let i = 0; i < n; i++) counts.push(Number(varint()));
  function fcol(m) {  // one float column: raw f64 or x100 fixed-point
    if (n === 0) return [];
    const enc = u8[pos++]; const out = [];
    if (enc === 0) {
      for (let i = 0; i < m; i++) { out.push(dv.getFloat64(pos, true)); pos += 8; }
    } else {
      for (let i = 0; i < m; i++) out.push(Number(zz(varint())) / 100);
    }
    return out;
  }
  let np = 0, ns = 0, nw = 0, no = 0, nx = 0, ny = 0;
  for (const f of dflags) {
    if (f & 1) np++; if (f & 2) ns++; if (f & 4) nw++;
    if (f & 8) no++; if (f & 16) nx++; if (f & 32) ny++;
  }
  const speeds = fcol(n), p95 = fcol(np); fcol(ns);  // stddev unused
  for (let i = 0; i < nw; i++) varint();  // windowMinutes unused
  pos += 16 * no;                         // per-doc window overrides
  // velocity columns are present only when some doc is flagged
  const vx = nx ? fcol(nx) : [], vy = ny ? fcol(ny) : [];
  const feats = []; let ip = 0, xp = 0, yp = 0;
  for (let i = 0; i < n; i++) {
    const f = {cellId: cells[i], count: counts[i], avgSpeedKmh: speeds[i]};
    if (dflags[i] & 1) f.p95SpeedKmh = p95[ip++];
    if (dflags[i] & 16) f.vxKmh = vx[xp++];
    if (dflags[i] & 32) f.vyKmh = vy[yp++];
    feats.push(f);
  }
  return {mode: (flags & 1) ? 'full' : 'delta', seq: seq, features: feats};
}

function updateCellInPlace(layer, p) {
  // geometry is a pure function of the cellId and already on the map:
  // a binary delta only needs to restyle + re-describe the hex
  layer.setStyle({fillColor: rampColor(p.count)});
  let html = `<b>${esc(p.cellId)}</b><br/>count: ${Number(p.count)}` +
             `<br/>avg speed: ${Number(p.avgSpeedKmh).toFixed(1)} km/h`;
  if (p.p95SpeedKmh !== undefined)
    html += `<br/>p95 speed: ${Number(p.p95SpeedKmh).toFixed(1)} km/h`;
  if (p.vxKmh !== undefined && p.vyKmh !== undefined)
    html += `<br/>velocity: ${Math.hypot(Number(p.vxKmh),
             Number(p.vyKmh)).toFixed(1)} km/h`;
  layer.setPopupContent ? layer.setPopupContent(html) : layer.bindPopup(html);
  if (layer.feature && layer.feature.properties)
    Object.assign(layer.feature.properties, p);
  if (layer.getBounds)
    updateArrow(p.cellId, p, layer.getBounds().getCenter());
}

async function fetchFullJson(gridQS) {
  const r = await fetch('/api/tiles/latest' + (gridQS ? '?' + gridQS : ''));
  const text = await r.text();
  const tiles = JSON.parse(text);
  if (tiles.features && tiles.features.length)
    jsonPerFeat = text.length / tiles.features.length;
  return tiles;
}

async function fetchTiles(gridQS) {
  // binary delta path first: columnar frame, ~10x fewer wire bytes;
  // properties-only, so it can restyle KNOWN hexes in place — a full
  // resync or an unseen cell (its geometry isn't on the map yet)
  // falls through to one full JSON fetch, which also re-teaches the
  // bytes-saved estimate
  if (!deltaBroken && wireFmt === 'bin') {
    try {
      const r = await fetch(`/api/tiles/delta?since=${tilesSince}&fmt=bin${gridQS ? '&' + gridQS : ''}`);
      if (!r.ok) {
        if (r.status === 404 || r.status === 503) deltaBroken = true;
        throw new Error(`delta ${r.status}`);
      }
      const ct = r.headers.get('Content-Type') || '';
      if (ct.indexOf('vnd.heatmap.tiles') < 0) {
        // server negotiated us back to JSON (old server / fallback)
        wireFmt = 'json';
        throw new Error('binary not negotiated');
      }
      const buf = await r.arrayBuffer();
      const d = decodeWireFrame(buf);
      wireBytes += buf.byteLength;
      const unknown = d.features.some(f => !cellLayers.has(f.cellId));
      if (d.mode !== 'full' && !unknown) {
        wireSaved += Math.max(0, d.features.length * jsonPerFeat - buf.byteLength);
        return {binDelta: d};
      }
      // resync / new cells: one JSON full fetch restores geometry,
      // then binary deltas resume from the frame's seq
      const tiles = await fetchFullJson(gridQS);
      return {full: tiles, seq: d.seq};
    } catch (err) {
      if (wireFmt === 'bin' && !deltaBroken) wireFmt = 'json';
      console.warn('binary delta failed; falling back to JSON', err);
    }
  }
  // JSON delta path: changed hexes only, O(changed) per poll
  if (!deltaBroken) {
    try {
      const r = await fetch(`/api/tiles/delta?since=${tilesSince}${gridQS ? '&' + gridQS : ''}`);
      if (!r.ok) {
        // 404 (older server) / 503 (view disabled) are permanent for
        // the session; anything else — a blip, a restart — retries on
        // the next tick after one full-fetch fallback
        if (r.status === 404 || r.status === 503) deltaBroken = true;
        throw new Error(`delta ${r.status}`);
      }
      const d = await r.json();
      return {delta: d};
    } catch (err) {
      console.warn('delta fetch failed; full fetch this tick', err);
    }
  }
  // full-fetch fallback: the reference-shaped endpoint
  const tiles = await fetchFullJson(gridQS);
  return {full: tiles};
}

async function tick() {
  if (histSeries) return;  // scrubbing history: the live poller pauses
  const seq = ++tickSeq;  // a newer tick invalidates slower in-flight ones
  try {
    const newGrid = gridForZoom(map.getZoom());
    if (newGrid !== activeGrid) { tilesSince = 0; clearHexes(); }
    activeGrid = newGrid;
    const gridQS = activeGrid ? `grid=${encodeURIComponent(activeGrid)}` : '';
    const [tiles, pts, metrics] = await Promise.all([
      fetchTiles(gridQS),
      fetch('/api/positions/latest').then(r => r.json()),
      fetch('/metrics.json').then(r => r.json()).catch(() => ({})),
    ]);
    if (seq !== tickSeq) return;  // stale response; a fresher one renders
    if (tiles.binDelta) {
      // properties-only binary delta: every cell is already on the map
      for (const p of tiles.binDelta.features)
        updateCellInPlace(cellLayers.get(p.cellId), p);
      tilesSince = tiles.binDelta.seq;
    } else if (tiles.delta) {
      if (tiles.delta.mode === 'full') clearHexes();
      applyFeatures(tiles.delta.features || []);
      tilesSince = tiles.delta.seq;
    } else {
      clearHexes();
      if (tiles.full.features) applyFeatures(tiles.full.features);
      if (tiles.seq !== undefined) tilesSince = tiles.seq;
    }
    if (cellLayers.size && !fitted) {
      const b = hexes.getBounds();
      if (b.isValid()) { map.fitBounds(b, {maxZoom: 14}); fitted = true; }
    }
    vehicles.clearLayers();
    for (const f of (pts.features || [])) {
      const [lng, lat] = f.geometry.coordinates;
      const m = L.circleMarker([lat, lng],
        {radius: 4, weight: 1, color: '#1451c4', fillOpacity: 0.9});
      const p = f.properties;
      m.bindPopup(`<b>${esc(p.provider)}</b> ${esc(p.vehicleId)}<br/>${esc(p.ts)}`);
      vehicles.addLayer(m);
    }
    const nt = cellLayers.size, np = (pts.features || []).length;
    if (!nt && !np) status('Waiting for data…');
    renderHud(nt, np, metrics);
  } catch (err) {
    console.error(err);
    status('Fetch failed — is the pipeline up?');
  }
}

function renderHud(nt, np, m) {
  const sw = RAMP.map(([min, c]) =>
    `<span class="swatch" style="background:${c}"></span>&ge;${min}`).join(' ');
  let line = `${nt} tiles · ${np} vehicles`;
  if (activeGrid && GRIDS.length > 1) line += ` · ${activeGrid}`;
  if (m && m.events_per_sec !== undefined)
    line += ` · ${Number(m.events_per_sec).toLocaleString()} ev/s` +
            ` · p50 ${m.batch_latency_p50_ms} ms`;
  // negotiated wire format + bytes the binary path saved vs GeoJSON
  line += ` · wire ${deltaBroken ? 'full-json' : wireFmt}`;
  if (wireSaved > 0)
    line += ` (saved ~${(wireSaved / 1024).toFixed(0)} KB)`;
  document.getElementById('hud').innerHTML = line + '<br/>' + sw;
}

// ---- continuous queries: geofence outlines + live match flashes ----
const fences = L.layerGroup().addTo(map);   // dashed region outlines
const fenceLayers = new Map();              // query id -> outline layer
const fenceStreams = new Map();             // query id -> EventSource
const MAX_FENCE_STREAMS = 4;
let cqBroken = false;  // 404/503 => no engine on this worker

function flash(layer, color) {
  if (!layer || !layer.setStyle) return;
  const orig = {color: layer.options.color,
                weight: layer.options.weight,
                fillOpacity: layer.options.fillOpacity};
  layer.setStyle({color: color, weight: 3, fillOpacity: 0.85});
  setTimeout(() => layer.setStyle(orig), 700);
}

function fenceOutline(q) {
  const style = {color: q.type === 'geofence' ? '#7b1fa2'
                        : q.type === 'anomaly' ? '#c62828' : '#1451c4',
                 weight: 1.5, dashArray: '6 4', fill: false};
  if (q.bbox) {
    const [w, s, e, n] = q.bbox;
    if (w <= e)
      return L.rectangle([[s, w], [n, e]], style);
    // antimeridian-wrapping bbox: draw the two straddling boxes
    return L.layerGroup([L.rectangle([[s, w], [n, 180]], style),
                         L.rectangle([[s, -180], [n, e]], style)]);
  }
  if (q.polygon)
    return L.polygon(q.polygon.map(([lon, lat]) => [lat, lon]), style);
  return null;
}

const anomalyMarks = L.layerGroup().addTo(map);

function anomalyPulse(m) {
  const mk = L.circleMarker([Number(m.lat), Number(m.lon)],
    {radius: 10, weight: 2, color: '#c62828', fillColor: '#ff5252',
     fillOpacity: 0.6});
  mk.bindPopup(`<b>${esc(m.reason || 'anomaly')}</b> ` +
               `${esc(m.entity || '?')}` +
               (m.score !== undefined
                ? `<br/>score: ${Number(m.score).toFixed(1)}` : '') +
               (m.speedKmh !== undefined
                ? `<br/>speed: ${Number(m.speedKmh).toFixed(1)} km/h` : ''));
  anomalyMarks.addLayer(mk);
  // fade after 15 s so a busy stream never accumulates markers
  setTimeout(() => anomalyMarks.removeLayer(mk), 15000);
}

function subscribeFence(q) {
  if (fenceStreams.size >= MAX_FENCE_STREAMS ||
      fenceStreams.has(q.id) || !window.EventSource) return;
  const es = new EventSource(`/api/queries/stream?id=${q.id}`);
  fenceStreams.set(q.id, es);
  es.addEventListener('match', ev => {
    let m;
    try { m = JSON.parse(ev.data); } catch (e) { return; }
    if (m.kind === 'anomaly') {
      // inference anomaly push: pulse a marker at the event position
      // naming entity + reason; no coordinates (older server) falls
      // back to the plain fence/cell flash below
      if (m.lat !== undefined && m.lon !== undefined)
        anomalyPulse(m);
      flash(fenceLayers.get(q.id), '#c62828');
      if (m.cell) flash(cellLayers.get(m.cell), '#c62828');
      status(`anomaly ${esc(m.reason || '?')} ${esc(m.entity || '?')}`);
      return;
    }
    flash(fenceLayers.get(q.id), m.kind === 'exit' ? '#607d8b' : '#e91e63');
    if (m.cell) flash(cellLayers.get(m.cell), '#e91e63');
    status(`${q.type} ${m.kind}${m.cell ? ' ' + esc(m.cell) : ''}`);
  });
  es.addEventListener('gone', () => { es.close(); });
  es.onerror = () => { es.close(); fenceStreams.delete(q.id); };
}

async function refreshQueries() {
  if (cqBroken) return;
  try {
    const r = await fetch('/api/queries');
    if (!r.ok) { if (r.status === 404 || r.status === 503) cqBroken = true;
                 return; }
    const d = await r.json();
    const seen = new Set();
    for (const q of (d.queries || [])) {
      seen.add(q.id);
      if (!fenceLayers.has(q.id) && (q.bbox || q.polygon)) {
        const layer = fenceOutline(q);
        if (layer) { fences.addLayer(layer); fenceLayers.set(q.id, layer); }
      }
      if (q.type === 'geofence' || q.type === 'range' ||
          q.type === 'anomaly') subscribeFence(q);
    }
    for (const [id, layer] of fenceLayers) {
      if (!seen.has(id)) {  // expired/deleted: drop outline + stream
        fences.removeLayer(layer); fenceLayers.delete(id);
        const es = fenceStreams.get(id);
        if (es) { es.close(); fenceStreams.delete(id); }
      }
    }
  } catch (err) { console.warn('query list fetch failed', err); }
}

// ---- space-time history slider (/api/tiles/range, query/history.py) ----
// Enter history mode: fetch the last 6 h of compacted windows for the
// active grid and scrub them with the slider; live polling pauses
// until the "live" button (or a 503 on a worker without the tier).
let histSeries = null;
const histBar = document.getElementById('histbar');
const histSlider = document.getElementById('histslider');
const histLabel = document.getElementById('histlabel');

function showHistWindow(i) {
  const w = histSeries[i];
  if (!w) return;
  clearHexes();
  applyFeatures(w.features || []);
  histLabel.textContent =
    `${esc(w.windowStart || '?')} · ${(w.features || []).length} tiles ` +
    `(${Number(i) + 1}/${histSeries.length})`;
}

async function enterHistory() {
  try {
    const now = Date.now() / 1000;
    const gridQS = activeGrid ? `&grid=${encodeURIComponent(activeGrid)}` : '';
    const r = await fetch(`/api/tiles/range?t0=${now - 21600}&t1=${now}${gridQS}`);
    if (!r.ok) {
      status(r.status === 503 ? 'no history tier on this worker'
                              : `history fetch failed (${r.status})`);
      return;
    }
    const d = await r.json();
    if (!d.series || !d.series.length) { status('no history yet'); return; }
    histSeries = d.series;
    histSlider.max = String(histSeries.length - 1);
    histSlider.value = String(histSeries.length - 1);
    histBar.style.display = 'block';
    showHistWindow(histSeries.length - 1);
  } catch (err) { console.warn('history fetch failed', err); }
}

function exitHistory() {
  histSeries = null;
  histBar.style.display = 'none';
  tilesSince = 0;        // the live delta stream resyncs from scratch
  clearHexes();
  tick();
}

document.getElementById('histbtn').addEventListener('click', () => {
  if (histSeries) exitHistory(); else enterHistory();
});
document.getElementById('histlive').addEventListener('click', exitHistory);
histSlider.addEventListener('input',
  () => { if (histSeries) showHistWindow(Number(histSlider.value)); });

tick();
setInterval(tick, REFRESH_MS);
refreshQueries();
setInterval(refreshQueries, 60000);
</script>
</body>
</html>"""


def render_index(refresh_ms: int = 5000,
                 resolutions=None) -> str:
    """``resolutions``: the multi-res pyramid (cfg.resolutions); with more
    than one the UI switches grid by zoom level."""
    import json

    grids = [[int(r), f"h3r{int(r)}"] for r in sorted(resolutions or [])]
    return (_PAGE
            .replace("__REFRESH_MS__", str(int(refresh_ms)))
            .replace("__GRIDS__", json.dumps(grids)))
