"""Dashboard page for ui.server — single file, zero external assets.

The port's copy of mujoco_mpc_tpu/ui/page.py (the port imports nothing of
the JAX package); it also shows a failure the server reports under
/api/state's "error".

Reproduces the reference GUI's observables (mjpc/simulate.cc sidebar +
mjpc/planners/planner.cc::Plots figures) as a web page: rendered view,
task/planner/mode selectors, cost-weight + task-parameter sliders,
pause/speed/noise/trace controls, and two live charts (per-term cost
history; planner iteration time). Chart colors are a validated
colorblind-safe categorical palette; light/dark both supported.
"""

PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8">
<title>mjpc_torch dashboard</title>
<style>
:root {
  color-scheme: light;
  --surface: #fcfcfb; --page: #f9f9f7;
  --ink: #0b0b0b; --ink2: #52514e; --muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7; --ring: rgba(11,11,11,0.10);
  --s1: #2a78d6; --s2: #eb6834; --s3: #1baf7a; --s4: #eda100;
  --s5: #e87ba4; --s6: #008300; --s7: #4a3aa7; --s8: #e34948;
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface: #1a1a19; --page: #0d0d0d;
    --ink: #ffffff; --ink2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835; --ring: rgba(255,255,255,0.10);
    --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
    --s5: #d55181; --s6: #008300; --s7: #9085e9; --s8: #e66767;
  }
}
* { box-sizing: border-box; }
body { margin: 0; background: var(--page); color: var(--ink);
  font: 13px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif; }
header { display: flex; gap: 12px; align-items: center; flex-wrap: wrap;
  padding: 10px 16px; background: var(--surface);
  border-bottom: 1px solid var(--ring); }
header h1 { font-size: 15px; margin: 0 8px 0 0; font-weight: 650; }
header label { color: var(--ink2); }
select, button, input[type=number] { font: inherit; color: var(--ink);
  background: var(--surface); border: 1px solid var(--axis);
  border-radius: 6px; padding: 3px 8px; }
button { cursor: pointer; }
button:hover { border-color: var(--muted); }
.stat { color: var(--ink2); }
.stat b { color: var(--ink); font-variant-numeric: tabular-nums; }
main { display: grid; grid-template-columns: minmax(320px, 500px) 1fr;
  gap: 14px; padding: 14px 16px; align-items: start; }
.card { background: var(--surface); border: 1px solid var(--ring);
  border-radius: 10px; padding: 12px; }
.card h2 { font-size: 12px; font-weight: 650; color: var(--ink2);
  margin: 0 0 8px; text-transform: uppercase; letter-spacing: .04em; }
#view { width: 100%; border-radius: 6px; display: block;
  background: var(--page); }
.noview { color: var(--muted); padding: 30px 10px; text-align: center; }
.sl { display: grid; grid-template-columns: 9em 1fr 4.5em; gap: 8px;
  align-items: center; margin: 3px 0; }
.sl span { color: var(--ink2); overflow: hidden; text-overflow: ellipsis;
  white-space: nowrap; }
.sl output { text-align: right; font-variant-numeric: tabular-nums; }
input[type=range] { width: 100%; accent-color: var(--s1); margin: 0; }
canvas { width: 100%; display: block; }
.legend { display: flex; flex-wrap: wrap; gap: 4px 14px; margin: 6px 0 0;
  color: var(--ink2); }
.legend i { display: inline-block; width: 10px; height: 10px;
  border-radius: 3px; margin-right: 5px; vertical-align: -1px; }
.tip { position: fixed; pointer-events: none; background: var(--surface);
  border: 1px solid var(--ring); border-radius: 6px; padding: 6px 9px;
  font-size: 12px; display: none; box-shadow: 0 2px 10px rgba(0,0,0,.12);
  z-index: 9; max-width: 260px; }
.tip b { font-variant-numeric: tabular-nums; }
.right { display: grid; gap: 14px; }
</style></head><body>
<header>
  <h1>mjpc_torch</h1>
  <label>task <select id="task"></select></label>
  <label>planner <select id="planner"></select></label>
  <label>mode <select id="mode"></select></label>
  <button id="pause"></button>
  <button id="reset">reset</button>
  <label><input type="checkbox" id="traces"> traces</label>
  <span class="stat">t <b id="time">–</b> s</span>
  <span class="stat">plan <b id="phz">–</b> Hz</span>
  <span class="stat">cost <b id="cost">–</b></span>
  <span class="stat" id="error" style="display:none; color: var(--s8)"></span>
</header>
<main>
  <div class="right">
    <div class="card"><h2>View</h2>
      <img id="view" alt="rendered scene">
      <div id="noview" class="noview" style="display:none">
        no GL backend on this host — plots-only</div>
    </div>
    <div class="card"><h2>Run</h2>
      <div class="sl"><span>speed ×</span>
        <input type="range" id="speed" min="-1.3" max="1" step="0.01">
        <output id="speedv"></output></div>
      <div class="sl"><span>ctrl noise</span>
        <input type="range" id="noise" min="0" max="0.5" step="0.01">
        <output id="noisev"></output></div>
    </div>
    <div class="card"><h2>Cost weights</h2><div id="weights"></div></div>
    <div class="card" id="paramcard"><h2>Task parameters</h2>
      <div id="params"></div></div>
  </div>
  <div class="right">
    <div class="card"><h2>Cost terms</h2>
      <canvas id="costchart" height="240"></canvas>
      <div class="legend" id="costlegend"></div></div>
    <div class="card"><h2>Planner iteration time</h2>
      <canvas id="timechart" height="140"></canvas></div>
  </div>
</main>
<div class="tip" id="tip"></div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const SER = ['--s1','--s2','--s3','--s4','--s5','--s6','--s7','--s8'];
const css = v => getComputedStyle(document.documentElement)
    .getPropertyValue(v).trim();
let S = null;           // last /api/state
let planMs = [];        // planner-ms ring (client side)
const post = (path, body) => fetch(path, {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(body)}).then(r => r.json());

function fillSelect(el, items, cur) {
  if (el.dataset.sig === items.join('|') + '@' + cur) return;
  el.dataset.sig = items.join('|') + '@' + cur;
  el.innerHTML = '';
  for (const it of items) {
    const o = document.createElement('option');
    o.value = o.textContent = it; o.selected = (it === cur);
    el.appendChild(o);
  }
}

function slider(holder, name, val, max, oninput) {
  let row = holder.querySelector(`[data-k="${CSS.escape(name)}"]`);
  if (!row) {
    row = document.createElement('div');
    row.className = 'sl'; row.dataset.k = name;
    row.innerHTML = `<span title="${name}">${name}</span>
      <input type="range" min="0" step="any"><output></output>`;
    const inp = row.querySelector('input');
    inp.addEventListener('input', () => {
      row.querySelector('output').value = (+inp.value).toPrecision(3);
      oninput(+inp.value);
    });
    holder.appendChild(row);
  }
  const inp = row.querySelector('input');
  inp.max = Math.max(max, 1e-6);
  if (document.activeElement !== inp) {
    inp.value = val;
    row.querySelector('output').value = (+val).toPrecision(3);
  }
}

async function refresh() {
  try { S = await (await fetch('/api/state')).json(); } catch { return; }
  fillSelect($('task'), S.tasks, S.task);
  fillSelect($('planner'), S.planners, S.planner);
  fillSelect($('mode'), S.modes.length ? S.modes : ['—'], S.mode);
  $('mode').disabled = S.modes.length < 2;
  $('pause').textContent = S.paused ? 'resume' : 'pause';
  $('traces').checked = S.traces;
  $('time').textContent = S.time.toFixed(2);
  $('phz').textContent = S.planner_hz ?? '–';
  $('error').style.display = S.error ? '' : 'none';
  $('error').textContent = S.error ? 'stopped: ' + S.error : '';
  const last = S.history[S.history.length - 1];
  $('cost').textContent = last ? last.total.toFixed(3) : '–';
  if (S.planner_ms != null) {
    planMs.push(S.planner_ms);
    if (planMs.length > 240) planMs.shift();
  }
  if (document.activeElement !== $('speed')) {
    $('speed').value = Math.log10(S.speed);
    $('speedv').value = S.speed.toFixed(2);
  }
  if (document.activeElement !== $('noise')) {
    $('noise').value = S.ctrl_noise;
    $('noisev').value = S.ctrl_noise.toFixed(2);
  }
  const wmax = Math.max(1, ...Object.values(S.weights).map(v => 2 * v));
  for (const [k, v] of Object.entries(S.weights))
    slider($('weights'), k, v, wmax, nv => post('/api/set',
        {weights: {[k]: nv}}));
  $('paramcard').style.display =
      Object.keys(S.params).length ? '' : 'none';
  for (const [k, v] of Object.entries(S.params))
    slider($('params'), k, v, Math.max(2 * Math.abs(v), 1),
        nv => post('/api/set', {params: {[k]: nv}}));
  drawCost(); drawTime();
}

// ---------------------------------------------------------------- charts
function setup(cv) {
  const r = cv.getBoundingClientRect(), dpr = devicePixelRatio || 1;
  cv.width = r.width * dpr; cv.height = cv.clientHeight * dpr;
  const ctx = cv.getContext('2d');
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  return [ctx, r.width, cv.clientHeight];
}
function frame(ctx, W, H, ymax, yfmt) {
  const L = 42, R = 8, T = 8, B = 18;
  ctx.clearRect(0, 0, W, H);
  ctx.strokeStyle = css('--grid'); ctx.lineWidth = 1;
  ctx.fillStyle = css('--muted');
  ctx.font = '11px system-ui'; ctx.textAlign = 'right';
  for (let i = 0; i <= 3; i++) {
    const y = T + (H - T - B) * i / 3;
    ctx.beginPath(); ctx.moveTo(L, y); ctx.lineTo(W - R, y); ctx.stroke();
    ctx.fillText(yfmt(ymax * (1 - i / 3)), L - 5, y + 4);
  }
  ctx.strokeStyle = css('--axis');
  ctx.beginPath(); ctx.moveTo(L, H - B); ctx.lineTo(W - R, H - B);
  ctx.stroke();
  return [L, R, T, B];
}
function line(ctx, xs, ys, X, Y, color) {
  ctx.strokeStyle = color; ctx.lineWidth = 2;
  ctx.lineJoin = 'round'; ctx.beginPath();
  for (let i = 0; i < xs.length; i++) {
    const x = X(xs[i]), y = Y(ys[i]);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  }
  ctx.stroke();
}

let costSeries = [];  // [{name, color, ys}], xs shared
let costXs = [], costGeom = null;
function drawCost() {
  const cv = $('costchart');
  const [ctx, W, H] = setup(cv);
  const hist = S.history;
  if (hist.length < 2) { costGeom = null; return; }
  costXs = hist.map(h => h.t);
  const names = Object.keys(hist[hist.length - 1].terms);
  // total + up to 7 terms; extras fold into "other" (palette cap)
  const shown = names.slice(0, 7);
  costSeries = [{name: 'total', color: css('--s1'),
                 ys: hist.map(h => h.total)}];
  shown.forEach((n, i) => costSeries.push({name: n, color: css(SER[i + 1]),
      ys: hist.map(h => h.terms[n] ?? 0)}));
  if (names.length > 7)
    costSeries.push({name: 'other', color: css('--muted'),
        ys: hist.map(h => names.slice(7).reduce(
            (a, n) => a + (h.terms[n] ?? 0), 0))});
  const ymax = Math.max(1e-9, ...costSeries.flatMap(s => s.ys)) * 1.05;
  const [L, R, T, B] = frame(ctx, W, H, ymax,
      v => v >= 100 ? v.toFixed(0) : v.toPrecision(3));
  const x0 = costXs[0], x1 = costXs[costXs.length - 1];
  const X = t => L + (W - L - R) * (t - x0) / Math.max(x1 - x0, 1e-9);
  const Y = v => T + (H - T - B) * (1 - v / ymax);
  for (const s of costSeries) line(ctx, costXs, s.ys, X, Y, s.color);
  costGeom = {X, Y, L, R, T, B, W, H};
  const lg = $('costlegend');
  const sig = costSeries.map(s => s.name).join('|');
  if (lg.dataset.sig !== sig) {
    lg.dataset.sig = sig;
    lg.innerHTML = costSeries.map(s =>
        `<span><i style="background:${s.color}"></i>${s.name}</span>`)
        .join('');
  }
}
function drawTime() {
  const cv = $('timechart');
  const [ctx, W, H] = setup(cv);
  if (planMs.length < 2) return;
  const ymax = Math.max(...planMs) * 1.1;
  const [L, R, T, B] = frame(ctx, W, H, ymax, v => v.toFixed(1) + 'ms');
  const X = i => L + (W - L - R) * i / (planMs.length - 1);
  const Y = v => T + (H - T - B) * (1 - v / ymax);
  line(ctx, planMs.map((_, i) => i), planMs, X, Y, css('--s1'));
}

// crosshair + tooltip on the cost chart
$('costchart').addEventListener('mousemove', ev => {
  if (!costGeom || !costXs.length) return;
  const r = ev.target.getBoundingClientRect();
  const mx = ev.clientX - r.left;
  let best = 0, bd = 1e18;
  for (let i = 0; i < costXs.length; i++) {
    const d = Math.abs(costGeom.X(costXs[i]) - mx);
    if (d < bd) { bd = d; best = i; }
  }
  const tip = $('tip');
  tip.style.display = 'block';
  tip.style.left = (ev.clientX + 14) + 'px';
  tip.style.top = (ev.clientY + 10) + 'px';
  tip.innerHTML = `t = <b>${costXs[best].toFixed(2)}</b> s<br>` +
      costSeries.map(s => `<i style="display:inline-block;width:8px;
        height:8px;border-radius:2px;background:${s.color};
        margin-right:4px"></i>${s.name}: <b>${
        s.ys[best].toPrecision(4)}</b>`).join('<br>');
});
$('costchart').addEventListener('mouseleave',
    () => $('tip').style.display = 'none');

// ---------------------------------------------------------------- control
$('task').addEventListener('change', e => post('/api/task',
    {task: e.target.value}));
$('planner').addEventListener('change', e => post('/api/planner',
    {planner: e.target.value}));
$('mode').addEventListener('change', e => post('/api/set',
    {mode: e.target.value}));
$('pause').addEventListener('click',
    () => post('/api/set', {paused: !S.paused}).then(refresh));
$('reset').addEventListener('click', () => post('/api/reset', {}));
$('traces').addEventListener('change',
    e => post('/api/set', {traces: e.target.checked}));
$('speed').addEventListener('input', e => {
  const v = Math.pow(10, +e.target.value);
  $('speedv').value = v.toFixed(2);
  post('/api/set', {speed: v});
});
$('noise').addEventListener('input', e => {
  $('noisev').value = (+e.target.value).toFixed(2);
  post('/api/set', {ctrl_noise: +e.target.value});
});

// ----------------------------------------------------------------- frames
let frameTimer = null;
function pollFrames() {
  if (!S) { setTimeout(pollFrames, 300); return; }
  if (!S.render) {
    $('view').style.display = 'none';
    $('noview').style.display = '';
    return;
  }
  const img = $('view');
  img.onload = () => { frameTimer = setTimeout(pollFrames, 80); };
  img.onerror = () => { frameTimer = setTimeout(pollFrames, 500); };
  img.src = '/frame.jpg?ts=' + Date.now();
}
refresh().then(pollFrames);
setInterval(refresh, 500);
</script></body></html>
"""
