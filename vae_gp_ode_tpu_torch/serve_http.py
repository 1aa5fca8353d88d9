"""A minimal HTTP server around a saved serving artifact (port of
`tools/serve_http.py`).

An artifact exported with ``python -m vae_gp_ode_tpu_torch.serving`` is
served over plain HTTP with torch, the port's `serving` and `ops` modules
(which register the kernels' operators) and the Python standard library;
the model code is not imported.

  python -m vae_gp_ode_tpu_torch.serve_http --artifact forecaster.pt2 \\
      [--port 8089] [--device cuda]

API (JSON):
  POST /predict   {"x": <nested list, shape (N, T, 1, 28, 28)>,
                   "seed": 0}
              ->  {"y": <nested list>, "shape": [...], "ms": ...}
  GET  /health   ->  {"ok": true, "input_shape": [...], "platforms": [...],
                      "device": "..."}

Single-threaded by design (one card, one program); put a load balancer in
front for fan-out.
"""

import argparse
import json
import sys
import time
from http.server import BaseHTTPRequestHandler, HTTPServer


def make_handler(fc):
    import numpy as np
    import torch

    class Handler(BaseHTTPRequestHandler):
        # bound every socket read: a client that promises a large
        # Content-Length and then stalls would otherwise block the
        # single-threaded server inside rfile.read() forever
        timeout = 30

        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._reply(200, {
                    'ok': True,
                    'input_shape': [str(d) for d in fc.input_shape],
                    'platforms': list(fc.platforms),
                    'device': str(fc.device)})
            else:
                self._reply(404, {'error': 'unknown path'})

        def do_POST(self):
            if self.path != '/predict':
                self._reply(404, {'error': 'unknown path'})
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                raw = self.rfile.read(n)
            except OSError:
                # the client never delivered its promised body (socket
                # timeout); the connection is unusable - drop it
                self.close_connection = True
                return
            try:
                req = json.loads(raw)
                x = np.asarray(req['x'], dtype=np.float32)
                seed = int(req.get('seed', 0))
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {'error': f'{type(e).__name__}: {e}'})
                return
            want = fc.input_shape  # a symbolic batch ('b') takes any N
            if len(x.shape) != len(want) or any(
                    isinstance(w, int) and w != s
                    for w, s in zip(want, x.shape)):
                self._reply(400, {
                    'error': f'x has shape {list(x.shape)}, artifact '
                             f'expects {[str(d) for d in want]}'})
                return
            try:
                t0 = time.perf_counter()
                y = fc(x, seed=seed)
                if y.device.type == 'cuda':
                    torch.cuda.synchronize(y.device)
                ms = (time.perf_counter() - t0) * 1e3
                y = y.cpu().numpy()
                self._reply(200, {'y': y.tolist(), 'shape': list(y.shape),
                                  'ms': round(ms, 3)})
            except Exception as e:  # noqa: BLE001 - an execution fault is
                # the server's, reported to the client, and the server
                # goes on serving
                self._reply(500, {'error': f'{type(e).__name__}: {e}'})

        def log_message(self, fmt, *a):
            print(f'[serve_http] {fmt % a}', file=sys.stderr)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser('Serve a saved forecaster over HTTP')
    p.add_argument('--artifact', required=True)
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8089)
    p.add_argument('--device', default='cuda',
                   help='device to serve on (cuda, or cpu)')
    a = p.parse_args(argv)
    from vae_gp_ode_tpu_torch import serving
    fc = serving.load_forecaster(a.artifact, device=a.device)
    srv = HTTPServer((a.host, a.port), make_handler(fc))
    print(json.dumps({'serving': a.artifact, 'host': a.host,
                      'port': srv.server_address[1],
                      'device': str(fc.device)}), flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == '__main__':
    main()
