"""Embedded multi-page web UI — zero build step, zero assets. The port's
copy of ``agentfield_tpu/control_plane/dashboard.py``: the same document,
byte for byte, served on ``/`` by the port's control plane.

The reference embeds a full React SPA in its binary (web/client, 302 TS
files, ui_embed.go:15) with pages for dashboard, nodes, executions,
workflows (DAG viz), reasoners, DID explorer and credentials. This is the
TPU build's equivalent page inventory as ONE hash-routed HTML document
driven entirely by the existing REST/SSE surface:

  #/          dashboard   /api/ui/v1/summary + /api/ui/v1/nodes
  #/nodes     nodes       /api/ui/v1/nodes (+ per-node detail w/ SQL metrics)
  #/execs     executions  /api/ui/v1/executions (server-side pagination/
                          filters/groups; detail live-updates over SSE)
  #/runs      workflows   /api/v1/runs → /api/v1/workflows/{run}/dag (SVG DAG)
  #/reasoners reasoners   /api/v1/reasoners (+ per-target metrics)
  #/pkgs      packages    /api/v1/packages (`af install` registry)
  #/creds     credentials /api/ui/v1/credentials (persisted issued VCs)
  #/did       DID / VC    /api/v1/did/* + /api/v1/vc/verify (paste-to-verify)
  #/memory    memory      /api/v1/memory?scope=... browser

List pages render server-side aggregations (control_plane/ui_service.py) —
the browser never fetches raw tables to re-aggregate client-side, matching
the reference's UIService/ExecutionsUIService split (ui_service.go:78,
executions_ui_service.go:112).
"""

DASHBOARD_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8"><title>agentfield_tpu</title>
<style>
  :root { --bg:#0d1117; --panel:#161b22; --line:#30363d; --fg:#c9d1d9;
          --dim:#8b949e; --blue:#58a6ff; --green:#3fb950; --red:#f85149;
          --amber:#d29922; }
  body { font-family: ui-monospace, SFMono-Regular, monospace; background:var(--bg);
         color:var(--fg); max-width:1100px; margin:1.2rem auto; padding:0 1rem; }
  nav { display:flex; gap:0.2rem; border-bottom:1px solid var(--line);
        margin-bottom:1rem; flex-wrap:wrap; }
  nav a { color:var(--dim); text-decoration:none; padding:0.45rem 0.8rem; }
  nav a.on { color:var(--blue); border-bottom:2px solid var(--blue); }
  h1 { color:var(--blue); font-size:1.15rem; display:inline-block; margin:0 1rem 0 0; }
  .cards { display:flex; gap:1rem; flex-wrap:wrap; margin:0.5rem 0 1rem; }
  .card { background:var(--panel); border:1px solid var(--line); border-radius:8px;
          padding:0.7rem 1.1rem; min-width:120px; }
  .card .num { font-size:1.5rem; color:var(--blue); }
  table { width:100%; border-collapse:collapse; margin-top:0.6rem; }
  th, td { text-align:left; padding:0.32rem 0.55rem; border-bottom:1px solid #21262d;
           font-size:0.84rem; vertical-align:top; }
  tr.click { cursor:pointer; } tr.click:hover td { background:#1c2128; }
  .completed,.active,.ok { color:var(--green); } .failed,.timeout,.dead_letter,.error { color:var(--red); }
  .running,.queued,.starting { color:var(--amber); } .inactive,.stopping { color:var(--dim); }
  small, .dim { color:var(--dim); }
  pre { background:var(--panel); border:1px solid var(--line); border-radius:6px;
        padding:0.6rem; overflow-x:auto; font-size:0.8rem; white-space:pre-wrap; }
  input, textarea, select, button {
        background:var(--panel); color:var(--fg); border:1px solid var(--line);
        border-radius:6px; padding:0.35rem 0.5rem; font-family:inherit; font-size:0.84rem; }
  textarea { width:100%; min-height:90px; }
  button { cursor:pointer; } button:hover { border-color:var(--blue); }
  svg text { font-family:inherit; }
  .row { display:flex; gap:1rem; align-items:baseline; flex-wrap:wrap; margin:0.4rem 0; }
  #live { color:var(--green); font-size:0.78rem; }
</style>
</head>
<body>
<div><h1>agentfield_tpu</h1><span id="live"></span></div>
<nav id="nav"></nav>
<div id="page"></div>
<small id="ts"></small>
<script>
const $ = (id) => document.getElementById(id);
const esc = (s) => String(s ?? '').replace(/[&<>"']/g, c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
const J = async (url, opts) => { const r = await fetch(url, opts);
  if (!r.ok) throw new Error(url + ' -> ' + r.status); return r.json(); };
const fmtT = (t) => t ? new Date(t * 1000).toLocaleTimeString() : '';
const stat = (s) => `<span class="${esc(s)}">${esc(s)}</span>`;

const PAGES = [['','dashboard'],['nodes','nodes'],['execs','executions'],
  ['runs','workflows'],['reasoners','reasoners'],['pkgs','packages'],
  ['creds','credentials'],['mcp','mcp'],['did','did / vc'],['memory','memory']];
function nav() {
  const cur = location.hash.replace(/^#\\/?/, '').split('?')[0].split('/')[0];
  $('nav').innerHTML = PAGES.map(([p, label]) =>
    `<a href="#/${p}" class="${cur === p ? 'on' : ''}">${label}</a>`).join('');
}

let timer = null, sse = null, viewEpoch = 0;
function setRefresh(fn, ms) {
  if (timer) clearInterval(timer); timer = null;
  if (sse) { sse.close(); sse = null; $('live').textContent = ''; }
  viewEpoch++;  // invalidates any pending liveRender retries of the old view
  if (fn && ms) timer = setInterval(fn, ms);
}
// SSE-driven re-render pump: never two renders in flight (an older fetch
// can't overwrite a newer one), and an event storm coalesces into at most
// one follow-up render instead of one /dag fetch per event.
function liveRender(render) {
  const epoch = viewEpoch;  // retries die with the view they belong to
  let running = false, pending = false, retryTimer = null;
  const pump = async () => {
    if (epoch !== viewEpoch) return;  // user navigated away
    if (running) { pending = true; return; }
    running = true;
    try {
      await render();
      if (retryTimer) { clearTimeout(retryTimer); retryTimer = null; }
      if (epoch === viewEpoch) $('live').textContent = '· live';
    } catch (e) {
      // surface + retry (ONE outstanding retry, not a chain per event):
      // a silently-stale page labeled "live" is worse than a visible error
      if (epoch === viewEpoch) {
        $('live').textContent = '· live (error, retrying)';
        $('ts').textContent = 'refresh failed: ' + e;
        if (!retryTimer) retryTimer = setTimeout(() => { retryTimer = null; pump(); }, 3000);
      }
    }
    running = false;
    if (pending) { pending = false; setTimeout(pump, 600); }
  };
  return pump;
}
const done = () => $('ts').textContent = 'refreshed ' + new Date().toLocaleTimeString();

// ---- dashboard --------------------------------------------------------
async function pgDash() {
  const s = await J('/api/ui/v1/summary'), n = await J('/api/v1/nodes');
  const ex = s.executions_by_status;
  $('page').innerHTML = `
    <div class="cards">${[['nodes', s.nodes.active + '/' + s.nodes.total],
      ['models', s.nodes.models], ['completed', ex.completed],
      ['failed', ex.failed + ex.timeout + (ex.dead_letter || 0)], ['running', ex.running + ex.queued],
      ['queue', s.queue_depth]]
      .map(([k, v]) => `<div class="card"><div class="num">${v}</div>${k}</div>`).join('')}</div>
    <h2 style="font-size:1rem">nodes</h2><table>${n.nodes.map(x =>
      `<tr class="click" data-go="#/nodes/${esc(x.node_id)}">
       <td>${esc(x.node_id)}</td><td>${esc(x.kind)}</td><td>${stat(x.status)}</td>
       <td>${(x.reasoners || []).length + (x.skills || []).length} components</td></tr>`).join('')}</table>
    <h2 style="font-size:1rem">recent runs</h2><table>${s.recent_runs.map(r =>
      `<tr class="click" data-go="#/runs/${esc(r.run_id)}">
       <td>${esc(r.run_id)}</td><td>${stat(r.overall_status)}</td>
       <td>${r.executions} exec</td><td class="dim">${esc(r.targets.join(', '))}</td></tr>`).join('')}</table>`;
  done();
}

// ---- nodes ------------------------------------------------------------
async function pgNodes(id) {
  if (id) {
    const n = await J('/api/ui/v1/nodes/' + id);
    const hb = n.metadata && n.metadata.stats ? n.metadata.stats : null;
    const tm = n.target_metrics || {};
    $('page').innerHTML = `
      <div class="row"><b>${esc(n.node_id)}</b> ${stat(n.status)}
        <span class="dim">${esc(n.kind)} @ ${esc(n.base_url)}</span>
        <span class="dim">heartbeat ${n.last_heartbeat_age_s}s ago</span></div>
      <div class="row dim">did: ${esc(n.did || '—')}</div>
      ${hb ? `<h3 style="font-size:0.9rem">engine stats</h3><pre>${esc(JSON.stringify(hb, null, 1))}</pre>` : ''}
      <h3 style="font-size:0.9rem">components</h3>
      <table><tr><th>id</th><th>kind</th><th>description</th><th>calls</th>
        <th>success</th><th>p50 / p95 ms</th></tr>
      ${[...(n.reasoners || []), ...(n.skills || [])].map(c => {
        const m = tm[n.node_id + '.' + c.id], d = m && m.duration_s;
        return `<tr><td>${esc(c.id)}</td><td>${esc(c.kind)}</td>
         <td class="dim">${esc(c.description)}</td>
         <td>${m ? m.executions : '—'}</td>
         <td>${m && m.success_rate != null ? (m.success_rate * 100).toFixed(0) + '%' : '—'}</td>
         <td>${d && d.p50 != null ? (d.p50 * 1000).toFixed(0) + ' / ' + (d.p95 * 1000).toFixed(0) : '—'}</td></tr>`;
      }).join('')}</table>`;
  } else {
    const n = await J('/api/ui/v1/nodes');
    $('page').innerHTML = `<div class="row"><span class="dim">
      ${n.active}/${n.total} active</span></div>
      <table><tr><th>node</th><th>kind</th><th>status</th>
      <th>reasoners</th><th>skills</th><th>heartbeat age</th><th>engine</th></tr>
      ${n.nodes.map(x => `<tr class="click" data-go="#/nodes/${esc(x.node_id)}">
        <td>${esc(x.node_id)}</td><td>${esc(x.kind)}</td><td>${stat(x.status)}</td>
        <td>${x.reasoners}</td><td>${x.skills}</td>
        <td class="dim">${x.last_heartbeat_age_s}s</td>
        <td class="dim">${x.engine ? esc(
          (x.engine.decode_tokens ?? 0) + ' tok, ' +
          (x.engine.active_slots ?? 0) + ' slots') : ''}</td></tr>`).join('')}</table>`;
  }
  done();
}

// ---- executions -------------------------------------------------------
async function pgExecs(id) {
  if (id) {
    const render = async () => {
      const e = await J('/api/v1/executions/' + id);
      $('page').innerHTML = `
        <div class="row"><b>${esc(e.execution_id)}</b> ${stat(e.status)}
          <span class="dim">${esc(e.target)}</span>
          <a href="#/runs/${esc(e.run_id)}">run ${esc(e.run_id)}</a></div>
        <h3 style="font-size:0.9rem">input</h3><pre>${esc(JSON.stringify(e.input, null, 1))}</pre>
        <h3 style="font-size:0.9rem">result</h3><pre>${esc(JSON.stringify(e.result, null, 1))}</pre>
        ${e.error ? `<h3 style="font-size:0.9rem" class="error">error</h3><pre>${esc(e.error)}</pre>` : ''}
        ${(e.notes || []).length ? `<h3 style="font-size:0.9rem">notes</h3><pre>${esc(
          e.notes.map(n => JSON.stringify(n)).join('\\n'))}</pre>` : ''}`;
      done();
    };
    await render();
    // live detail: re-render when THIS execution's events arrive
    const pump = liveRender(render);
    sse = new EventSource('/api/v1/events/executions');
    sse.onmessage = (ev) => {
      try { const d = JSON.parse(ev.data);
        if (d.execution_id && d.execution_id !== id) return; } catch (_) {}
      $('live').textContent = '· live'; pump();
    };
    return;
  }
  const q = new URLSearchParams(location.hash.split('?')[1] || '');
  const page = +(q.get('page') || 1), st = q.get('status') || '', grp = q.get('group_by') || '';
  // Hash-derived values are percent-decoded by URLSearchParams; re-encode
  // before embedding in URLs/href attributes (quote/angle-safe in both).
  const stE = encodeURIComponent(st), grpE = encodeURIComponent(grp);
  const render = async () => {
    const d = await J('/api/ui/v1/executions?page=' + page + '&page_size=25'
      + (st ? '&status=' + stE : '') + (grp ? '&group_by=' + grpE : ''));
    const base = '#/execs?' + (st ? 'status=' + stE + '&' : '') + (grp ? 'group_by=' + grpE + '&' : '');
    $('page').innerHTML = `
      <div class="row">status: ${['', 'running', 'completed', 'failed', 'dead_letter', 'queued'].map(s =>
        `<a href="#/execs?${grp ? 'group_by=' + grpE + '&' : ''}${s ? 'status=' + s : ''}"
          class="${s === st ? 'on' : 'dim'}">${s || 'all'}</a>`).join(' ')}
        group: ${['', 'target', 'status', 'run_id'].map(g =>
        `<a href="#/execs?${st ? 'status=' + stE + '&' : ''}${g ? 'group_by=' + g : ''}"
          class="${g === grp ? 'on' : 'dim'}">${g || 'none'}</a>`).join(' ')}
        <span class="dim">${d.total} total</span></div>
      ${d.groups ? `<table><tr><th>${esc(grp)}</th><th>executions</th><th>completed</th>
        <th>failed</th><th>latest</th></tr>${d.groups.map(g =>
        `<tr><td>${esc(g.group)}</td><td>${g.executions}</td><td class="ok">${g.completed}</td>
         <td class="${g.failed ? 'error' : 'dim'}">${g.failed}</td>
         <td class="dim">${fmtT(g.latest)}</td></tr>`).join('')}</table><hr style="border-color:var(--line)">` : ''}
      <table><tr><th>execution</th><th>target</th><th>status</th>
      <th>run</th><th>duration</th><th>created</th></tr>
      ${d.executions.map(e => `<tr class="click" data-go="#/execs/${esc(e.execution_id)}">
        <td>${esc(e.execution_id)}</td><td>${esc(e.target)}</td><td>${stat(e.status)}</td>
        <td class="dim">${esc(e.run_id)}</td>
        <td class="dim">${e.duration_s != null ? e.duration_s.toFixed(2) + 's' : ''}</td>
        <td class="dim">${fmtT(e.created_at)}</td></tr>`).join('')}</table>
      <div class="row">
        ${d.has_prev ? `<a href="${base}page=${page - 1}">‹ prev</a>` : ''}
        <span class="dim">page ${d.page} / ${d.total_pages}</span>
        ${d.has_next ? `<a href="${base}page=${page + 1}">next ›</a>` : ''}</div>`;
    done();
  };
  await render();
  const pump = liveRender(render);
  sse = new EventSource('/api/v1/events/executions');
  sse.onmessage = () => { $('live').textContent = '· live'; pump(); };
}

// ---- workflows / DAG --------------------------------------------------
function dagSvg(dag) {
  const nodes = dag.nodes, byId = {};
  nodes.forEach(n => byId[n.execution_id] = n);
  const depth = {}, children = {};
  nodes.forEach(n => {
    const p = n.parent_execution_id;
    (children[p] = children[p] || []).push(n.execution_id);
  });
  const roots = nodes.filter(n => !n.parent_execution_id || !byId[n.parent_execution_id]);
  const layers = []; let frontier = roots.map(n => n.execution_id); const seen = {};
  while (frontier.length) {
    layers.push(frontier); frontier.forEach(id => seen[id] = layers.length - 1);
    frontier = frontier.flatMap(id => children[id] || []).filter(id => !(id in seen));
  }
  // Big runs render compact and WRAP wide layers into rows, so a 100+
  // node fan-out stays on screen instead of stretching 10k px sideways.
  const compact = nodes.length > 40;
  const W = compact ? 108 : 170, H = compact ? 34 : 52;
  const GX = compact ? 12 : 30, GY = compact ? 14 : 26;
  const perRow = Math.max(1, Math.floor(1340 / (W + GX)));
  const pos = {};
  let y = 16;
  layers.forEach(ids => {
    ids.forEach((id, i) => {
      pos[id] = { x: 20 + (i % perRow) * (W + GX),
                  y: y + Math.floor(i / perRow) * (H + GY) };
    });
    y += Math.ceil(ids.length / perRow) * (H + GY) + (compact ? 10 : 0);
  });
  const colors = { completed: 'var(--green)', failed: 'var(--red)', timeout: 'var(--red)', dead_letter: 'var(--red)',
                   running: 'var(--amber)', queued: 'var(--amber)' };
  const edges = nodes.filter(n => n.parent_execution_id && pos[n.parent_execution_id])
    .map(n => { const a = pos[n.parent_execution_id], b = pos[n.execution_id];
      return `<line x1="${a.x + W / 2}" y1="${a.y + H}" x2="${b.x + W / 2}" y2="${b.y}"
        stroke="var(--line)" stroke-width="1"/>`; }).join('');
  const fs1 = compact ? 9 : 11, fs2 = compact ? 8 : 10;
  const boxes = nodes.filter(n => pos[n.execution_id]).map(n => { const p = pos[n.execution_id];
    const label = compact && n.target.length > 16 ? n.target.slice(0, 15) + '…' : n.target;
    return `<g class="click" data-go="#/execs/${esc(n.execution_id)}" cursor="pointer">
      <rect x="${p.x}" y="${p.y}" width="${W}" height="${H}" rx="${compact ? 4 : 7}" fill="var(--panel)"
        stroke="${colors[n.status] || 'var(--line)'}" stroke-width="1.4"/>
      <text x="${p.x + 7}" y="${p.y + (compact ? 13 : 20)}" fill="var(--fg)" font-size="${fs1}">${esc(label)}</text>
      <text x="${p.x + 7}" y="${p.y + (compact ? 26 : 38)}" fill="${colors[n.status] || 'var(--dim)'}"
        font-size="${fs2}">${esc(n.status)}</text></g>`; }).join('');
  const w = Math.max(...Object.values(pos).map(p => p.x + W + 20), 300);
  const h = Math.max(...Object.values(pos).map(p => p.y + H + 20), 120);
  return `<svg width="${w}" height="${h}" id="dag">${edges}${boxes}</svg>`;
}
async function pgRuns(id) {
  if (id) {
    const render = async () => {
      const dag = await J('/api/v1/workflows/' + id + '/dag');
      // live re-renders must not wipe an open "verify VC chain" result:
      // carry the #chain contents across the innerHTML replacement
      const prevChain = $('chain') ? $('chain').innerHTML : '';
      $('page').innerHTML = `<div class="row"><b>run ${esc(id)}</b>
        ${stat(dag.overall_status)} <span class="dim">${dag.nodes.length} executions</span>
        <button id="chainbtn">verify VC chain</button></div>
        <div id="chain"></div>${dagSvg(dag)}`;
      $('chain').innerHTML = prevChain;
      $('chainbtn').onclick = () => vcChain(id);
      done();
    };
    await render();
    // live DAG: re-render as THIS run's executions progress
    const pump = liveRender(render);
    sse = new EventSource('/api/v1/events/executions');
    sse.onmessage = (ev) => {
      try { const d = JSON.parse(ev.data);
        if (d.run_id && d.run_id !== id) return; } catch (_) {}
      $('live').textContent = '· live'; pump();
    };
    return;
  }
  const render = async () => {
    const d = await J('/api/v1/runs');
    $('page').innerHTML = `<table><tr><th>run</th><th>status</th><th>executions</th>
      <th>started</th></tr>${d.runs.map(r =>
      `<tr class="click" data-go="#/runs/${esc(r.run_id)}">
       <td>${esc(r.run_id)}</td><td>${stat(r.overall_status)}</td>
       <td>${r.executions}</td><td class="dim">${fmtT(r.started_at)}</td></tr>`).join('')}</table>`;
    done();
  };
  await render();
  const pump = liveRender(render);
  sse = new EventSource('/api/v1/events/executions');
  sse.onmessage = () => { $('live').textContent = '· live'; pump(); };
}
async function vcChain(runId) {
  try { const c = await J('/api/v1/vc/workflows/' + runId);
    $('chain').innerHTML = `<pre>${esc(JSON.stringify(c, null, 1))}</pre>`; }
  catch (e) { $('chain').innerHTML = `<pre class="error">${esc(e)}</pre>`; }
}

// ---- reasoners --------------------------------------------------------
async function pgReasoners() {
  const d = await J('/api/v1/reasoners');
  const rows = await Promise.all(d.reasoners.map(async r => {
    let m = null;
    try { m = await J('/api/v1/reasoners/' + r.node_id + '.' + r.id + '/metrics'); }
    catch (e) {}
    const d50 = m && m.duration_s && m.duration_s.p50 != null ? m.duration_s : null;
    return `<tr><td>${esc(r.node_id)}.${esc(r.id)}</td><td class="dim">${esc(r.description)}</td>
      <td>${m ? m.executions : '—'}</td>
      <td>${m && m.success_rate != null ? (m.success_rate * 100).toFixed(0) + '%' : '—'}</td>
      <td>${d50 ? (d50.p50 * 1000).toFixed(0) + ' / ' + (d50.p95 * 1000).toFixed(0) : '—'}</td></tr>`;
  }));
  $('page').innerHTML = `<table><tr><th>reasoner</th><th>description</th><th>calls</th>
    <th>success</th><th>p50 / p95 ms</th></tr>${rows.join('')}</table>`;
  done();
}

// ---- packages ---------------------------------------------------------
async function pgPkgs() {
  const d = await J('/api/v1/packages');
  $('page').innerHTML = `
    <table><tr><th>package</th><th>entry</th><th>origin</th><th>installed</th>
      <th>description</th></tr>
    ${(d.packages || []).map(p => `<tr>
      <td>${esc(p.name)}</td><td class="dim">${esc(p.entry || '')}</td>
      <td class="dim">${esc(p.origin ? (p.origin.url || p.origin.path || p.origin.type) : '')}</td>
      <td class="dim">${fmtT(p.installed_at)}</td>
      <td class="dim">${esc(p.description || '')}</td></tr>`).join('')}</table>
    ${d.total ? '' : '<p class="dim">no packages installed (aftpu install &lt;source&gt;)</p>'}`;
  done();
}

// ---- credentials ------------------------------------------------------
async function pgCreds() {
  const q = new URLSearchParams(location.hash.split('?')[1] || '');
  const page = +(q.get('page') || 1), st = q.get('subject_type') || '';
  const stE = encodeURIComponent(st);
  const d = await J('/api/ui/v1/credentials?page=' + page + '&page_size=25'
    + (st ? '&subject_type=' + stE : ''));
  const base = '#/creds?' + (st ? 'subject_type=' + stE + '&' : '');
  $('page').innerHTML = `
    <div class="row">type: ${['', 'execution', 'workflow'].map(s =>
      `<a href="#/creds?${s ? 'subject_type=' + s : ''}" class="${s === st ? 'on' : 'dim'}">${s || 'all'}</a>`).join(' ')}
      <span class="dim">${d.total} issued</span></div>
    <table><tr><th>credential</th><th>type</th><th>subject</th><th>issued</th><th></th></tr>
    ${(d.credentials || []).map((c, i) => `<tr>
      <td class="dim">${esc(String(c.vc_id).slice(0, 40))}</td>
      <td>${esc(c.subject_type)}</td>
      <td><a href="${c.subject_type === 'execution' ? '#/execs/' : '#/runs/'}${esc(c.subject_id)}">${esc(c.subject_id)}</a></td>
      <td class="dim">${fmtT(c.issued_at)}</td>
      <td><button data-show="${i}">view</button></td></tr>
      <tr id="vc${i}" style="display:none"><td colspan="5"><pre>${esc(JSON.stringify(c.vc, null, 1))}</pre></td></tr>`).join('')}
    </table>
    ${d.total ? '' : '<p class="dim">no credentials issued yet (POST /api/v1/vc/executions/{id})</p>'}
    <div class="row">
      ${d.page > 1 ? `<a href="${base}page=${page - 1}">‹ prev</a>` : ''}
      <span class="dim">page ${d.page} / ${d.total_pages}</span>
      ${d.page < d.total_pages ? `<a href="${base}page=${page + 1}">next ›</a>` : ''}</div>`;
  document.querySelectorAll('[data-show]').forEach(b => b.onclick = () => {
    const row = $('vc' + b.getAttribute('data-show'));
    row.style.display = row.style.display === 'none' ? '' : 'none';
  });
  done();
}

// ---- DID / VC ---------------------------------------------------------
async function pgDid() {
  let org = null; try { org = await J('/api/v1/did/org'); } catch (e) {}
  const n = await J('/api/v1/nodes');
  $('page').innerHTML = `
    <h3 style="font-size:0.9rem">organization</h3>
    <pre>${esc(org ? JSON.stringify(org, null, 1) : 'DID layer disabled')}</pre>
    <h3 style="font-size:0.9rem">node identities</h3>
    <table><tr><th>node</th><th>did</th></tr>${n.nodes.map(x =>
      `<tr><td>${esc(x.node_id)}</td><td class="dim">${esc(x.did || '—')}</td></tr>`).join('')}</table>
    <h3 style="font-size:0.9rem">verify a credential</h3>
    <textarea id="vcin" placeholder='paste a verifiable credential JSON'></textarea>
    <div class="row"><button onclick="vcVerify()">verify</button><span id="vcout"></span></div>`;
  done();
}
async function vcVerify() {
  try {
    const vc = JSON.parse($('vcin').value);
    const r = await J('/api/v1/vc/verify', { method: 'POST',
      headers: { 'Content-Type': 'application/json' }, body: JSON.stringify({ vc }) });
    $('vcout').innerHTML = r.valid ? '<span class="ok">valid ✓</span>'
      : `<span class="error">invalid: ${esc(r.reason || '')}</span>`;
  } catch (e) { $('vcout').innerHTML = `<span class="error">${esc(e)}</span>`; }
}

// ---- memory -----------------------------------------------------------
async function pgMemory() {
  const q = location.hash.split('?')[1] || '';
  const params = new URLSearchParams(q);
  const scope = params.get('scope') || 'global';
  const sid = params.get('scope_id') || '';
  const url = '/api/v1/memory?scope=' + scope + (sid ? '&scope_id=' + encodeURIComponent(sid) : '');
  let items = {};
  let err = null;
  try { items = (await J(url)).items || {}; } catch (e) { err = e; }
  const keys = Object.keys(items);
  $('page').innerHTML = `
    <div class="row">scope: ${['global', 'session', 'actor', 'workflow'].map(s =>
      `<a href="#/memory?scope=${s}" class="${s === scope ? 'on' : 'dim'}">${s}</a>`).join(' ')}
      ${scope !== 'global' ? `<input id="sid" placeholder="scope_id" value="${esc(sid)}">
        <button id="sidload">load</button>` : ''}
    </div>
    ${err ? `<p class="dim">${esc(err.message || err)}</p>` : `
    <table><tr><th>key</th><th>value</th></tr>
    ${keys.map(k => `<tr><td>${esc(k)}</td>
      <td class="dim"><pre style="margin:0">${esc(JSON.stringify(items[k])).slice(0, 400)}</pre></td></tr>`).join('')}
    </table>${keys.length ? '' : '<p class="dim">no keys in scope</p>'}`}`;
  if ($('sidload')) $('sidload').onclick = () =>
    location.hash = '#/memory?scope=' + scope + '&scope_id=' + encodeURIComponent($('sid').value);
  done();
}

async function pgMcp() {
  const doc = await J('/api/v1/mcp/servers');
  const servers = doc.servers || [];
  $('page').innerHTML = `
    <h2>mcp servers</h2>
    <table><tr><th>alias</th><th>state</th><th>pid</th><th>restarts</th>
      <th>tools</th><th>resources</th><th>last error</th><th></th></tr>
    ${servers.map(s => `<tr>
      <td>${esc(s.alias)}</td>
      <td class="${s.state === 'running' ? 'ok' : s.state === 'failed' ? 'error' : 'dim'}">${esc(s.state)}</td>
      <td class="dim">${s.pid ?? ''}</td><td class="dim">${s.restarts}</td>
      <td>${s.tools}</td><td>${s.resources}</td>
      <td class="dim">${esc(s.last_error || '')}</td>
      <td>${s.state === 'running'
        ? `<button data-mcp="stop" data-alias="${esc(s.alias)}">stop</button>
           <button data-mcp="restart" data-alias="${esc(s.alias)}">restart</button>`
        : `<button data-mcp="start" data-alias="${esc(s.alias)}">start</button>`}</td>
    </tr>`).join('')}</table>
    ${servers.length ? '' : '<p class="dim">no MCP servers configured (POST /api/v1/mcp/servers)</p>'}`;
  document.querySelectorAll('[data-mcp]').forEach(b => b.onclick = async () => {
    const r = await fetch('/api/v1/mcp/servers/' + encodeURIComponent(b.getAttribute('data-alias')) +
      '/' + b.getAttribute('data-mcp'), {method: 'POST'});
    if (!location.hash.startsWith('#/mcp')) return;  // user navigated away
    if (!r.ok) {
      let msg = 'HTTP ' + r.status;
      try { msg = (await r.json()).error || msg; } catch (_) {}
      $('page').insertAdjacentHTML('afterbegin', `<p class="error">${esc(msg)}</p>`);
      return;
    }
    pgMcp();
  });
  done();
}

// ---- router -----------------------------------------------------------
async function route() {
  nav(); setRefresh(null, 0);
  const parts = location.hash.replace(/^#\\/?/, '').split('?')[0].split('/');
  const [p, id] = [parts[0], parts.slice(1).join('/') || null];
  try {
    if (p === 'nodes') { await pgNodes(id); setRefresh(() => pgNodes(id), 4000); }
    else if (p === 'execs') await pgExecs(id);
    else if (p === 'runs') await pgRuns(id);
    else if (p === 'reasoners') { await pgReasoners(); setRefresh(pgReasoners, 6000); }
    else if (p === 'pkgs') await pgPkgs();
    else if (p === 'creds') await pgCreds();
    else if (p === 'mcp') { await pgMcp(); setRefresh(pgMcp, 5000); }
    else if (p === 'did') await pgDid();
    else if (p === 'memory') await pgMemory();
    else { await pgDash(); setRefresh(pgDash, 3000); }
  } catch (e) { $('page').innerHTML = `<pre class="error">${esc(e)}</pre>`; }
}
document.addEventListener('click', (e) => {
  const el = e.target.closest && e.target.closest('[data-go]');
  if (el) location.hash = el.getAttribute('data-go');
});
window.addEventListener('hashchange', route);
route();
</script>
</body>
</html>
"""
