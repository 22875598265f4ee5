"""webcv2: ``cv2.imshow`` / ``waitKey`` over HTTP, on the standard library.

Counterpart of ``slenderobjdet_tpu/utils/webcv2.py``: images queued by
``imshow`` are served as an auto-refreshing HTML gallery at
http://<host>:<port>/ by ``http.server`` in a daemon thread. The JAX module
encodes JPEG with cv2; the card's machine has no image codec, so this one
encodes PNG with ``zlib`` (``utils/png.py``) and serves ``image/png``.
"""

from __future__ import annotations

import http.server
import threading
from typing import Dict, Optional

import numpy as np

from . import png

_images: Dict[str, bytes] = {}
_lock = threading.Lock()
_server: Optional[http.server.ThreadingHTTPServer] = None

_PAGE = b"""<html><head><meta http-equiv="refresh" content="2">
<style>body{background:#222;color:#eee;font-family:monospace}
img{max-width:45%%;margin:4px;border:1px solid #555}</style></head>
<body><h3>webcv2</h3>%s</body></html>"""


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):  # silent
        pass

    def do_GET(self):
        with _lock:
            if self.path == "/":
                tags = "".join(f'<div>{name}<br><img src="/img/{name}"></div>'
                               for name in sorted(_images)).encode()
                self._send(200, "text/html", _PAGE % tags)
                return
            if self.path.startswith("/img/"):
                data = _images.get(self.path[len("/img/"):])
                if data is not None:
                    self._send(200, "image/png", data)
                    return
        self.send_response(404)
        self.end_headers()

    def _send(self, code, kind, body):
        self.send_response(code)
        self.send_header("Content-Type", kind)
        self.end_headers()
        self.wfile.write(body)


def _ensure_server(port: int = 8888, host: str = "0.0.0.0"):
    global _server
    if _server is not None:
        return _server
    _server = http.server.ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=_server.serve_forever, daemon=True).start()
    return _server


def imshow(name: str, image: np.ndarray, port: int = 8888, host: str = "0.0.0.0"):
    """Queue an image (BGR uint8) for display at http://host:port/ (port 0:
    a free one, ``address()`` says which)."""
    _ensure_server(port, host)
    data = png.encode(np.ascontiguousarray(image))
    with _lock:
        _images[str(name)] = data


def address():
    """(host, port) the gallery serves on, or None before the first imshow."""
    return None if _server is None else _server.server_address[:2]


def waitKey(delay: int = 0) -> int:
    """No-op for API compatibility (images are already being served)."""
    return -1


def shutdown() -> None:
    """Stop the server and forget the queued images."""
    global _server
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server = None
    with _lock:
        _images.clear()
