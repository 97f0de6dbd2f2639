"""In-process fake GCS server (JSON API v1 subset) for hermetic tests.

Implements exactly the surface storage/gcs.py speaks — media
upload/download (with Range), metadata GET, paged list with
prefix/delimiter, delete, rewrite — over an in-memory object store.
Point a client at it via ``STORAGE_EMULATOR_HOST`` (the standard
emulator convention). Failure injection (``fail_next``) exercises the
client's retry path.

A copy of the JAX package's ``storage/fake_gcs.py``. It lives in the
package so that ``chip_smoke.py`` and local trials can start a loopback
'cloud' without the network; it needs nothing beyond the stdlib and is
never started implicitly.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

__all__ = ["FakeGCS"]

_PAGE_SIZE = 1000


class FakeGCS:
    """``with FakeGCS() as fake:`` serves on 127.0.0.1:<port>.

    - ``fake.host``: value for STORAGE_EMULATOR_HOST
    - ``fake.objects``: {(bucket, name): bytes} — direct fixture access
    - ``fake.fail_next(n, status=503)``: the next n requests answer
      ``status`` before the server behaves again (retry testing)
    - ``fake.requests``: count of requests handled
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.objects: Dict[Tuple[str, str], bytes] = {}
        self.generations: Dict[Tuple[str, str], int] = {}
        # resumable upload sessions: sid -> {bucket, name, buf}
        self.sessions: Dict[str, dict] = {}
        self.requests = 0
        self._fail_remaining = 0
        self._fail_status = 503
        self._next_session = 0
        self._lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: bytes = b"",
                       ctype: str = "application/json",
                       extra: Optional[dict] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj: dict):
                self._reply(code, json.dumps(obj).encode())

            def _maybe_fail(self) -> bool:
                with fake._lock:
                    fake.requests += 1
                    if fake._fail_remaining > 0:
                        fake._fail_remaining -= 1
                        status = fake._fail_status
                    else:
                        return False
                self._json(status, {"error": {"code": status,
                                              "message": "injected"}})
                return True

            # -- routing -------------------------------------------------
            def do_GET(self):
                if self._maybe_fail():
                    return
                path, _, query = self.path.partition("?")
                qs = urllib.parse.parse_qs(query)
                m = re.fullmatch(r"/storage/v1/b/([^/]+)/o/(.+)", path)
                if m:
                    bucket = m.group(1)
                    name = urllib.parse.unquote(m.group(2))
                    key = (bucket, name)
                    with fake._lock:
                        data = fake.objects.get(key)
                    if data is None:
                        return self._json(404, {"error": {"code": 404}})
                    if qs.get("alt", [""])[0] == "media":
                        return self._media(data)
                    return self._json(200, fake._meta(bucket, name, data))
                m = re.fullmatch(r"/storage/v1/b/([^/]+)/o", path)
                if m:
                    return self._list(m.group(1), qs)
                self._json(404, {"error": {"code": 404,
                                           "message": "no route"}})

            def _media(self, data: bytes):
                rng = self.headers.get("Range")
                if rng:
                    m = re.fullmatch(r"bytes=(\d+)-(\d*)", rng.strip())
                    if m:
                        start = int(m.group(1))
                        end = int(m.group(2)) if m.group(2) else \
                            len(data) - 1
                        if start >= len(data):
                            return self._reply(416, b"")
                        part = data[start:end + 1]
                        return self._reply(
                            206, part, "application/octet-stream",
                            {"Content-Range":
                             f"bytes {start}-{start + len(part) - 1}"
                             f"/{len(data)}"})
                self._reply(200, data, "application/octet-stream")

            def _list(self, bucket: str, qs):
                prefix = qs.get("prefix", [""])[0]
                delimiter = qs.get("delimiter", [None])[0]
                token = qs.get("pageToken", ["0"])[0]
                start = int(token or 0)
                with fake._lock:
                    names = sorted(n for (b, n) in fake.objects
                                   if b == bucket and n.startswith(prefix))
                items: List[dict] = []
                prefixes: List[str] = []
                for n in names:
                    if delimiter:
                        rest = n[len(prefix):]
                        if delimiter in rest:
                            p = prefix + rest.split(delimiter)[0] \
                                + delimiter
                            if p not in prefixes:
                                prefixes.append(p)
                            continue
                    items.append(n)
                doc: dict = {}
                page = items[start:start + _PAGE_SIZE]
                with fake._lock:
                    doc["items"] = [fake._meta(bucket, n,
                                               fake.objects[(bucket, n)])
                                    for n in page]
                if prefixes and start == 0:
                    doc["prefixes"] = prefixes
                if start + _PAGE_SIZE < len(items):
                    doc["nextPageToken"] = str(start + _PAGE_SIZE)
                self._json(200, doc)

            def do_POST(self):
                if self._maybe_fail():
                    return
                path, _, query = self.path.partition("?")
                qs = urllib.parse.parse_qs(query)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                m = re.fullmatch(r"/upload/storage/v1/b/([^/]+)/o", path)
                if m:
                    bucket = m.group(1)
                    name = qs.get("name", [""])[0]
                    if not name:
                        return self._json(400, {"error": {"code": 400}})
                    if qs.get("uploadType", [""])[0] == "resumable":
                        # initiation: answer with a session URI in
                        # Location (the resumable protocol)
                        with fake._lock:
                            fake._next_session += 1
                            sid = f"sess{fake._next_session}"
                            fake.sessions[sid] = {
                                "bucket": bucket, "name": name,
                                "buf": bytearray()}
                        host = self.headers.get("Host", "")
                        return self._reply(
                            200, b"{}", extra={
                                "Location":
                                f"http://{host}/upload/session/{sid}"})
                    with fake._lock:
                        key = (bucket, name)
                        fake.objects[key] = body
                        fake.generations[key] = \
                            fake.generations.get(key, 0) + 1
                    return self._json(200,
                                      fake._meta(bucket, name, body))
                m = re.fullmatch(
                    r"/storage/v1/b/([^/]+)/o/(.+)/rewriteTo/b/([^/]+)"
                    r"/o/(.+)", path)
                if m:
                    sb = m.group(1)
                    sn = urllib.parse.unquote(m.group(2))
                    db = m.group(3)
                    dn = urllib.parse.unquote(m.group(4))
                    with fake._lock:
                        data = fake.objects.get((sb, sn))
                        if data is None:
                            return self._json(404,
                                              {"error": {"code": 404}})
                        fake.objects[(db, dn)] = data
                    return self._json(200, {"done": True,
                                            "resource": fake._meta(
                                                db, dn, data)})
                self._json(404, {"error": {"code": 404}})

            def do_PUT(self):
                # resumable session chunks (offset-addressed via
                # Content-Range, so retried chunks are idempotent):
                # 308 + Range while incomplete, 200 + metadata once
                # the declared total is reached
                if self._maybe_fail():
                    return
                path = self.path.partition("?")[0]
                m = re.fullmatch(r"/upload/session/([^/]+)", path)
                if not m:
                    return self._json(404, {"error": {"code": 404}})
                with fake._lock:
                    sess = fake.sessions.get(m.group(1))
                if sess is None:
                    return self._json(404, {"error": {"code": 404}})
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                cr = self.headers.get("Content-Range", "")
                mm = re.fullmatch(r"bytes (?:(\d+)-(\d+)|\*)/(\d+|\*)",
                                  cr.strip())
                if not mm:
                    return self._json(400, {"error": {
                        "code": 400, "message": f"bad range {cr!r}"}})
                total = None if mm.group(3) == "*" else int(mm.group(3))
                with fake._lock:
                    buf = sess["buf"]
                    if mm.group(1) is not None:
                        start = int(mm.group(1))
                        end = int(mm.group(2))
                        if end - start + 1 != len(body):
                            return self._json(400, {"error": {
                                "code": 400,
                                "message": "range/body mismatch"}})
                        if len(buf) < start:
                            return self._json(400, {"error": {
                                "code": 400,
                                "message": "chunk gap"}})
                        buf[start:start + len(body)] = body
                    done = total is not None and len(buf) >= total
                    if done:
                        key = (sess["bucket"], sess["name"])
                        # store the bytearray itself -- a bytes() copy
                        # of a multi-GiB object takes minutes on a
                        # memory-starved VM and times out the waiting
                        # client; bytearray slices/compares like bytes
                        # for every read path
                        del buf[total:]
                        data = buf
                        fake.objects[key] = data
                        fake.generations[key] = \
                            fake.generations.get(key, 0) + 1
                        fake.sessions.pop(m.group(1), None)
                if done:
                    return self._json(200, fake._meta(
                        sess["bucket"], sess["name"], data))
                extra = {}
                if len(buf):
                    extra["Range"] = f"bytes=0-{len(buf) - 1}"
                self._reply(308, b"", extra=extra)

            def do_DELETE(self):
                if self._maybe_fail():
                    return
                path = self.path.partition("?")[0]
                m = re.fullmatch(r"/storage/v1/b/([^/]+)/o/(.+)", path)
                if not m:
                    return self._json(404, {"error": {"code": 404}})
                bucket = m.group(1)
                name = urllib.parse.unquote(m.group(2))
                with fake._lock:
                    existed = fake.objects.pop((bucket, name),
                                               None) is not None
                if not existed:
                    return self._json(404, {"error": {"code": 404}})
                self._reply(204)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    def _meta(self, bucket: str, name: str, data: bytes) -> dict:
        return {"kind": "storage#object", "bucket": bucket, "name": name,
                "size": str(len(data)),
                "generation": str(self.generations.get((bucket, name), 1))}

    @property
    def host(self) -> str:
        a = self._httpd.server_address
        return f"{a[0]}:{a[1]}"

    def fail_next(self, n: int, status: int = 503) -> None:
        with self._lock:
            self._fail_remaining = n
            self._fail_status = status

    def start(self) -> "FakeGCS":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "FakeGCS":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
