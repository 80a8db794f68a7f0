"""Web dashboard serving (reference: src/actix/web_ui.rs — `/dashboard`
serves `service.static_content_dir` [default ./static] when
`service.enable_static_content` is on, with X-Frame-Options: DENY).

Divergence: when the static folder is absent the reference logs a warning
and serves nothing (its UI ships as a separate artifact); here a built-in
single-file dashboard (collections / cluster / telemetry over the public
JSON APIs) is served instead so the endpoint is useful out of the box.
"""

from __future__ import annotations

import mimetypes
import os
from typing import Optional, Tuple

BUILTIN_INDEX = """<!doctype html>
<html><head><meta charset="utf-8"><title>qdrant-tpu dashboard</title>
<style>
body{font-family:system-ui,sans-serif;margin:2rem;max-width:72rem;color:#1a202c}
h1{font-size:1.4rem} h2{font-size:1.1rem;margin-top:1.6rem}
table{border-collapse:collapse;width:100%;font-size:.9rem}
td,th{border:1px solid #cbd5e0;padding:.35rem .6rem;text-align:left}
th{background:#edf2f7} code{background:#edf2f7;padding:0 .25rem}
.err{color:#c53030} .muted{color:#718096;font-size:.85rem}
input{padding:.3rem;margin-right:.5rem;border:1px solid #cbd5e0}
pre{background:#f7fafc;border:1px solid #e2e8f0;padding:.8rem;overflow:auto;font-size:.8rem}
</style></head><body>
<h1>qdrant-tpu</h1>
<p class="muted">Built-in dashboard. Place a static web UI under the
<code>service.static_content_dir</code> folder to replace this page.
<span id="err" class="err"></span></p>
<p><label>API key: <input id="key" type="password" placeholder="api-key (if auth enabled)"></label>
<button onclick="refresh()">Refresh</button></p>
<h2>Collections</h2><table id="colls"><tr><th>name</th><th>status</th>
<th>points</th><th>vectors</th><th>segments</th></tr></table>
<h2>Cluster</h2><pre id="cluster">…</pre>
<h2>Telemetry</h2><pre id="telemetry">…</pre>
<script>
async function j(path){
  const h = {}; const k = document.getElementById('key').value;
  if (k) h['api-key'] = k;
  const r = await fetch(path, {headers: h});
  if (!r.ok) throw new Error(path + ' -> HTTP ' + r.status);
  return (await r.json()).result;
}
async function refresh(){
  const err = document.getElementById('err'); err.textContent = '';
  try {
    const cols = (await j('/collections')).collections || [];
    const t = document.getElementById('colls');
    t.innerHTML = '<tr><th>name</th><th>status</th><th>points</th>' +
                  '<th>vectors</th><th>segments</th></tr>';
    for (const c of cols) {
      const info = await j('/collections/' + encodeURIComponent(c.name));
      const row = t.insertRow();
      for (const v of [c.name, info.status, info.points_count,
                       info.vectors_count, info.segments_count])
        row.insertCell().textContent = v ?? '';
    }
    document.getElementById('cluster').textContent =
      JSON.stringify(await j('/cluster'), null, 2);
    document.getElementById('telemetry').textContent =
      JSON.stringify(await j('/telemetry?details_level=2'), null, 2);
  } catch (e) { err.textContent = ' ' + e.message; }
}
refresh();
</script></body></html>
"""


def resolve_static(
    static_dir: Optional[str], rest: str
) -> Optional[Tuple[bytes, str]]:
    """→ (content, mime) for `rest` inside `static_dir`, or None when the
    folder/file is absent. Rejects path escapes."""
    from ..storage.io_tier import IoTierError, resolve_in_root

    if not static_dir or not os.path.isdir(static_dir):
        return None
    rel = rest.lstrip("/") or "index.html"
    try:
        full = resolve_in_root(static_dir, rel)
    except IoTierError:
        return None
    if os.path.isdir(full):
        full = os.path.join(full, "index.html")
    if not os.path.isfile(full):
        return None
    mime = mimetypes.guess_type(full)[0] or "application/octet-stream"
    with open(full, "rb") as f:
        return f.read(), mime


def dashboard_content(
    static_dir: Optional[str], rest: str
) -> Tuple[bytes, str]:
    """Static file if available, else the built-in page for the index
    (404 for any other missing path, signalled by empty content)."""
    hit = resolve_static(static_dir, rest)
    if hit is not None:
        return hit
    if rest.strip("/") in ("", "index.html"):
        return BUILTIN_INDEX.encode(), "text/html; charset=utf-8"
    return b"", ""
