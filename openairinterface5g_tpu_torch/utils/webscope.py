"""Live PHY web scope — the reference's scope family analog
(openair1/PHY/TOOLS/nr_phy_scope.c XForms, nr_phy_qt_scope.cpp Qt,
common/utils/websrv web UI).

A stdlib-only HTTP server: PHY code publishes named arrays
(constellation points, LLR histograms, |H| per subcarrier, sync
correlation) with `publish()`; the browser polls /data.json and renders
SVG panels client-side.  No external deps, safe to run next to the
softmodem loop (publishing is a lock-guarded dict swap, O(downsample)).

Port of openairinterface5g_tpu/utils/webscope.py: the same server, page and
JSON, except that ``publish`` also takes a tensor on any device, which it
downsamples there before one copy of the kept values to the host (the JAX
package's ``np.asarray`` cannot read a CUDA tensor).
tests/test_torch_utils.py holds the JSON equal to the JAX package's.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>oai5g-tpu scope</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:16px}
.panel{display:inline-block;margin:8px;border:1px solid #444;padding:4px}
svg{background:#181818}text{fill:#aaa;font-size:11px}
</style></head><body>
<h3>openairinterface5g_tpu live scope</h3><div id="panels"></div>
<script>
async function tick(){
  const r = await fetch('data.json'); const data = await r.json();
  const root = document.getElementById('panels'); root.innerHTML='';
  for (const [name, d] of Object.entries(data)){
    const div = document.createElement('div'); div.className='panel';
    const W=320,H=240; let svg=`<svg width="${W}" height="${H}">`;
    if (d.kind=='scatter'){
      const m = Math.max(1e-9, ...d.x.map(Math.abs), ...d.y.map(Math.abs));
      for (let i=0;i<d.x.length;i++){
        const px=W/2+d.x[i]/m*(W/2-10), py=H/2-d.y[i]/m*(H/2-10);
        svg+=`<circle cx="${px}" cy="${py}" r="1.5" fill="#4fc3f7"/>`;}
    } else {
      const mx=Math.max(1e-9,...d.y), mn=Math.min(0,...d.y);
      let pts='';
      for (let i=0;i<d.y.length;i++){
        pts+=`${10+i/(d.y.length-1)*(W-20)},${H-15-(d.y[i]-mn)/(mx-mn)*(H-30)} `;}
      svg+=`<polyline points="${pts}" fill="none" stroke="#81c784"/>`;}
    svg+=`<text x="6" y="14">${name}</text></svg>`;
    div.innerHTML=svg; root.appendChild(div);
  }
}
setInterval(tick, 500); tick();
</script></body></html>"""


class WebScope:
    """Singleton-ish scope server; publish() from anywhere."""

    def __init__(self, port: int = 8090, max_points: int = 512):
        self._data: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.max_points = max_points
        scope = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.endswith("data.json"):
                    body = scope.snapshot_json().encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, name: str, arr, kind: str | None = None) -> None:
        """Publish an array, or a tensor on any device: complex ->
        constellation scatter, real -> line plot.  Downsampled to
        max_points (a tensor on its device, then one copy to the host)."""
        if isinstance(arr, torch.Tensor):
            t = arr.detach().reshape(-1)
            a = t[:: max(1, t.numel() // self.max_points)].cpu().numpy()
        else:
            a = np.asarray(arr).ravel()
            a = a[:: max(1, len(a) // self.max_points)]
        if kind is None:
            kind = "scatter" if np.iscomplexobj(a) else "line"
        if kind == "scatter":
            d = {"kind": "scatter",
                 "x": np.round(a.real, 4).tolist(),
                 "y": np.round(a.imag, 4).tolist()}
        else:
            d = {"kind": "line", "y": np.round(a.astype(np.float64), 5).tolist()}
        with self._lock:
            self._data[name] = d

    def snapshot_json(self) -> str:
        with self._lock:
            return json.dumps(self._data)

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
