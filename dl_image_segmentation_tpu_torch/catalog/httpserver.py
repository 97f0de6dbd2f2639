"""Minimal COG-style scene server: static files + HTTP Range support.

A copy of the JAX package's ``catalog/httpserver.py``. Serves a
directory (a LocalCatalog root: ``index.json`` + ``scenes/*.tif``, or a
chip folder) on loopback, so HTTPCatalog and the read-only http(s)://
storage backend can run without the network: the stand-in for the
remote scene service the reference's chip engine is a client of
(``_descartes_img_chips.py:512-513, 612, 626``). Failure injection
(``fail_next``) reproduces that service's flakiness, which shaped the
reference's fetch-None / bounded-retry protocol (its :589-593,
718-722).

In the package, like storage/fake_gcs.py, so that ``chip_smoke.py``
and local trials can start a 'remote catalog' in two lines.
"""

from __future__ import annotations

import json
import os
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["SceneServer"]


class SceneServer:
    """``with SceneServer(root) as srv:`` serves ``root`` read-only on
    ``srv.url``. Supports GET with single-range ``Range: bytes=a-b``
    headers (206 + Content-Range), HEAD, 404 for misses, and counts
    requests/bytes so tests can assert windowed reads stay small."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self.root = os.path.abspath(root)
        self.requests = 0
        self.bytes_served = 0
        self.range_requests = 0
        self._fail_remaining = 0
        self._fail_status = 503
        self._lock = threading.Lock()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _maybe_fail(self) -> bool:
                with srv._lock:
                    srv.requests += 1
                    if srv._fail_remaining > 0:
                        srv._fail_remaining -= 1
                        status = srv._fail_status
                    else:
                        return False
                body = json.dumps({"error": "injected"}).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return True

            def _resolve(self) -> Optional[str]:
                # unquote like a real web server: chip filenames
                # contain '#' (the DLTile-key contract), which clients
                # must send %23-quoted
                rel = urllib.parse.unquote(
                    self.path.partition("?")[0]).lstrip("/")
                path = os.path.normpath(os.path.join(srv.root, rel))
                if not path.startswith(srv.root):  # no traversal
                    return None
                return path if os.path.isfile(path) else None

            def _autoindex(self) -> bool:
                """Directory listing (the <a href> autoindex format of
                python -m http.server / Apache / nginx) so the
                storage layer's https:// backend can walk chip
                folders served from here."""
                rel = urllib.parse.unquote(
                    self.path.partition("?")[0]).lstrip("/")
                d = os.path.normpath(os.path.join(srv.root, rel))
                if not d.startswith(srv.root) or not os.path.isdir(d):
                    return False
                rows = []
                for e in sorted(os.scandir(d), key=lambda e: e.name):
                    name = e.name + ("/" if e.is_dir() else "")
                    q = urllib.parse.quote(name)
                    rows.append(f'<li><a href="{q}">{name}</a></li>')
                body = ("<!DOCTYPE html><html><body><ul>"
                        + "".join(rows)
                        + "</ul></body></html>").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return True

            def do_HEAD(self):
                if self._maybe_fail():
                    return
                path = self._resolve()
                if path is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Content-Length",
                                 str(os.path.getsize(path)))
                self.end_headers()

            def do_GET(self):
                if self._maybe_fail():
                    return
                path = self._resolve()
                if path is None:
                    if self._autoindex():
                        return
                    body = b'{"error": "not found"}'
                    self.send_response(404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                size = os.path.getsize(path)
                rng = self.headers.get("Range")
                start, end = 0, size - 1
                status = 200
                if rng:
                    m = re.fullmatch(r"bytes=(\d+)-(\d*)", rng.strip())
                    if m:
                        start = int(m.group(1))
                        if m.group(2):
                            end = min(int(m.group(2)), size - 1)
                        if start >= size:
                            self.send_response(416)
                            self.send_header("Content-Range",
                                             f"bytes */{size}")
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            return
                        status = 206
                        with srv._lock:
                            srv.range_requests += 1
                with open(path, "rb") as f:
                    f.seek(start)
                    body = f.read(end - start + 1)
                self.send_response(status)
                self.send_header("Accept-Ranges", "bytes")
                if status == 206:
                    self.send_header(
                        "Content-Range",
                        f"bytes {start}-{start + len(body) - 1}/{size}")
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                with srv._lock:
                    srv.bytes_served += len(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        a = self._httpd.server_address
        return f"http://{a[0]}:{a[1]}"

    def fail_next(self, n: int, status: int = 503) -> None:
        with self._lock:
            self._fail_remaining = n
            self._fail_status = status

    def start(self) -> "SceneServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "SceneServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
