"""Live training monitor: a browser preview of the model as it trains.

Port of easygaussiansplatting_tpu/viewer/monitor.py (``TrainingMonitor``):
the training loop's ``epoch_cb`` renders the current model once per epoch
(``render_pool_image``, on the card K1, K3's three calls and K4), and a
small HTTP server hands the latest frame and the loss / PSNR history to a
page that refreshes itself. The frame is a JPEG at quality 88 with PIL's
bytes, encoded where it was rendered (on the card by K11,
``ops/kernels/jpeg.py``) and served at ``/preview.jpg``, as in JAX.

    monitor = TrainingMonitor(cam, config, port=8090)
    train(..., epoch_cb=monitor.epoch_cb)
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from easygaussiansplatting_tpu_torch.ops.kernels.jpeg import encode_jpeg
from easygaussiansplatting_tpu_torch.train.loop import render_pool_image
from easygaussiansplatting_tpu_torch.utils.image import frame_u8

_PAGE = """<!doctype html><html><head><title>training monitor</title><style>
body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{max-width:95vw;border:1px solid #444;margin-top:8px}
#stats{margin:8px}</style></head><body>
<div id="stats">waiting for first epoch...</div>
<img id="frame" src="/preview.jpg">
<script>
async function tick(){
  try{
    const h = await (await fetch('/history')).json();
    const loss = h.loss.length ? h.loss[h.loss.length-1].toFixed(5) : '-';
    const ps = h.psnr.length ? h.psnr[h.psnr.length-1][1].toFixed(2) : '-';
    document.getElementById('stats').textContent =
      `epoch ${h.epoch} | loss ${loss} | psnr ${ps} | alive ` +
      (h.n_alive.length ? h.n_alive[h.n_alive.length-1] : '-');
    document.getElementById('frame').src = '/preview.jpg?t=' + Date.now();
  }catch(e){}
  setTimeout(tick, 2000);
}
tick();
</script></body></html>"""


class TrainingMonitor:
    """Serves the latest per-epoch render of `cam` plus the training history
    (port 0 takes a free port; ``self.port`` says which)."""

    def __init__(self, cam, config, port=8090, host="127.0.0.1", log_fn=print):
        self.cam = cam
        self.config = config
        self.lock = threading.Lock()
        self.frame = None  # JPEG bytes
        self.epoch = 0
        self.history = {"loss": [], "psnr": [], "n_alive": []}
        self.httpd = ThreadingHTTPServer((host, port), self._handler())
        self.port = self.httpd.server_address[1]
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        log_fn(f"training monitor: http://{host}:{self.port}/")

    def epoch_cb(self, epoch, pool, adam_state=None, stats=None, key=None, history=None):
        img, _ = render_pool_image(pool, self.cam, self.config, need_grads=False)
        frame = encode_jpeg(frame_u8(img), quality=88)
        with self.lock:
            self.frame = frame
            self.epoch = epoch
            if history is not None:
                self.history = {
                    "loss": list(history.get("loss", [])),
                    "psnr": [list(p) for p in history.get("psnr", [])],
                    "n_alive": list(history.get("n_alive", [])),
                }

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def _handler(self):
        mon = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/preview.jpg":
                    with mon.lock:
                        frame = mon.frame
                    if frame is None:
                        self._send(404, b"no frame yet", "text/plain")
                    else:
                        self._send(200, frame, "image/jpeg")
                elif path == "/history":
                    with mon.lock:
                        body = json.dumps({"epoch": mon.epoch, **mon.history})
                    self._send(200, body.encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

        return Handler
