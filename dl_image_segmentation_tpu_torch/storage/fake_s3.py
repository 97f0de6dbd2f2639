"""In-process fake S3 server (REST API subset) for hermetic tests.

Implements exactly the surface storage/s3.py speaks — PUT / GET (with
Range) / HEAD / DELETE objects, ListObjectsV2 with
prefix/delimiter/continuation-token, and server-side copy via
``x-amz-copy-source`` — over an in-memory object store. Point a client
at it via ``AWS_ENDPOINT_URL_S3``. Failure injection (``fail_next``)
exercises the client's retry path.

A copy of the JAX package's ``storage/fake_s3.py``. Like fake_gcs, it
lives in the package so that ``chip_smoke.py`` and local trials can
start a loopback 'cloud'; stdlib only, never started implicitly.
Signatures are accepted but not verified (the SigV4 signer is pinned
against the AWS documentation's test vector instead, so a fake-side
verifier written from the same code would add risk, not coverage).
"""

from __future__ import annotations

import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from xml.sax.saxutils import escape

__all__ = ["FakeS3"]

_PAGE_SIZE = 1000


class FakeS3:
    """``with FakeS3() as fake:`` serves on 127.0.0.1:<port>.

    - ``fake.endpoint``: value for AWS_ENDPOINT_URL_S3
    - ``fake.objects``: {(bucket, key): bytes} — direct fixture access
    - ``fake.fail_next(n, status=503)``: next n requests answer
      ``status`` (retry testing)
    - ``fake.requests``: count of requests handled
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.objects: Dict[Tuple[str, str], bytes] = {}
        # multipart uploads: upload_id -> {bucket, key,
        # parts: {num: (etag, bytes)}}
        self.uploads: Dict[str, dict] = {}
        self.requests = 0
        self._fail_remaining = 0
        self._fail_status = 503
        self._next_upload = 0
        self._lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: bytes = b"",
                       ctype: str = "application/xml",
                       extra: Optional[dict] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, s3code: str):
                body = (f"<Error><Code>{s3code}</Code>"
                        f"<Message>{s3code}</Message></Error>").encode()
                self._reply(code, body)

            def _maybe_fail(self) -> bool:
                with fake._lock:
                    fake.requests += 1
                    if fake._fail_remaining > 0:
                        fake._fail_remaining -= 1
                        status = fake._fail_status
                    else:
                        return False
                self._error(status, "SlowDown")
                return True

            def _split(self) -> Tuple[str, str, dict]:
                path, _, query = self.path.partition("?")
                qs = {k: v[0] for k, v in
                      urllib.parse.parse_qs(
                          query, keep_blank_values=True).items()}
                parts = path.lstrip("/").split("/", 1)
                bucket = parts[0]
                key = urllib.parse.unquote(parts[1]) if len(parts) > 1 \
                    else ""
                return bucket, key, qs

            # -- routing -------------------------------------------------
            def do_GET(self):
                if self._maybe_fail():
                    return
                bucket, key, qs = self._split()
                if not key:
                    return self._list(bucket, qs)
                with fake._lock:
                    data = fake.objects.get((bucket, key))
                if data is None:
                    return self._error(404, "NoSuchKey")
                rng = self.headers.get("Range")
                if rng:
                    m = re.fullmatch(r"bytes=(\d+)-(\d*)", rng.strip())
                    if m:
                        start = int(m.group(1))
                        end = int(m.group(2)) if m.group(2) else \
                            len(data) - 1
                        if start >= len(data):
                            return self._error(416, "InvalidRange")
                        part = data[start:end + 1]
                        return self._reply(
                            206, part, "application/octet-stream",
                            {"Content-Range":
                             f"bytes {start}-{start + len(part) - 1}"
                             f"/{len(data)}"})
                self._reply(200, data, "application/octet-stream")

            def _list(self, bucket: str, qs: dict):
                prefix = qs.get("prefix", "")
                delimiter = qs.get("delimiter")
                start = int(qs.get("continuation-token") or 0)
                with fake._lock:
                    names = sorted(
                        k for (b, k) in fake.objects
                        if b == bucket and k.startswith(prefix))
                keys, prefixes = [], []
                for n in names:
                    if delimiter:
                        rest = n[len(prefix):]
                        if delimiter in rest:
                            p = (prefix + rest.split(delimiter)[0]
                                 + delimiter)
                            if p not in prefixes:
                                prefixes.append(p)
                            continue
                    keys.append(n)
                page = keys[start:start + _PAGE_SIZE]
                truncated = start + _PAGE_SIZE < len(keys)
                parts = ["<?xml version='1.0'?>",
                         "<ListBucketResult>",
                         f"<IsTruncated>{'true' if truncated else 'false'}"
                         "</IsTruncated>"]
                with fake._lock:
                    for n in page:
                        size = len(fake.objects[(bucket, n)])
                        parts.append(
                            f"<Contents><Key>{escape(n)}</Key>"
                            f"<Size>{size}</Size></Contents>")
                if start == 0:
                    for p in prefixes:
                        parts.append(f"<CommonPrefixes><Prefix>"
                                     f"{escape(p)}</Prefix>"
                                     f"</CommonPrefixes>")
                if truncated:
                    parts.append(f"<NextContinuationToken>"
                                 f"{start + _PAGE_SIZE}"
                                 f"</NextContinuationToken>")
                parts.append("</ListBucketResult>")
                self._reply(200, "".join(parts).encode())

            def do_POST(self):
                # multipart protocol: ?uploads initiates, ?uploadId
                # completes (assembling parts in number order after
                # verifying the client's ETag manifest)
                if self._maybe_fail():
                    return
                bucket, key, qs = self._split()
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if "uploads" in qs:
                    with fake._lock:
                        fake._next_upload += 1
                        uid = f"mpu{fake._next_upload}"
                        fake.uploads[uid] = {"bucket": bucket,
                                             "key": key, "parts": {}}
                    return self._reply(
                        200,
                        (f"<InitiateMultipartUploadResult>"
                         f"<Bucket>{escape(bucket)}</Bucket>"
                         f"<Key>{escape(key)}</Key>"
                         f"<UploadId>{uid}</UploadId>"
                         f"</InitiateMultipartUploadResult>").encode())
                uid = qs.get("uploadId")
                if uid:
                    with fake._lock:
                        up = fake.uploads.get(uid)
                    if up is None or up["bucket"] != bucket \
                            or up["key"] != key:
                        return self._error(404, "NoSuchUpload")
                    manifest = re.findall(
                        r"<PartNumber>(\d+)</PartNumber>\s*"
                        r"<ETag>([^<]*)</ETag>", body.decode())
                    with fake._lock:
                        parts = up["parts"]
                        nums = sorted(parts)
                        want = [(str(i), parts[i][0])
                                for i in nums]
                        if [(a, b.strip('"')) for a, b in manifest] != \
                                [(a, b.strip('"')) for a, b in want]:
                            return self._error(400, "InvalidPart")
                        data = b"".join(parts[i][1] for i in nums)
                        fake.objects[(bucket, key)] = data
                        fake.uploads.pop(uid, None)
                    return self._reply(
                        200,
                        (f"<CompleteMultipartUploadResult>"
                         f"<Key>{escape(key)}</Key>"
                         f"</CompleteMultipartUploadResult>").encode())
                self._error(400, "InvalidRequest")

            def do_PUT(self):
                if self._maybe_fail():
                    return
                bucket, key, qs = self._split()
                if not key:
                    return self._error(400, "InvalidRequest")
                uid = qs.get("uploadId")
                if uid and "partNumber" in qs:
                    with fake._lock:
                        up = fake.uploads.get(uid)
                    if up is None or up["bucket"] != bucket \
                            or up["key"] != key:
                        return self._error(404, "NoSuchUpload")
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    import hashlib as _hl
                    etag = f'"{_hl.md5(body).hexdigest()}"'
                    with fake._lock:
                        up["parts"][int(qs["partNumber"])] = (
                            etag.strip('"'), body)
                    return self._reply(200, b"", extra={"ETag": etag})
                src = self.headers.get("x-amz-copy-source")
                if src:
                    s = urllib.parse.unquote(src.lstrip("/"))
                    sb, _, sk = s.partition("/")
                    with fake._lock:
                        data = fake.objects.get((sb, sk))
                        if data is None:
                            return self._error(404, "NoSuchKey")
                        fake.objects[(bucket, key)] = data
                    return self._reply(
                        200, b"<CopyObjectResult><ETag>x</ETag>"
                             b"</CopyObjectResult>")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                with fake._lock:
                    fake.objects[(bucket, key)] = body
                self._reply(200, b"", extra={"ETag": '"x"'})

            def do_HEAD(self):
                # HEAD responses carry headers only; Content-Length
                # describes what GET would return (the object size)
                if self._maybe_fail():
                    return
                bucket, key, _qs = self._split()
                with fake._lock:
                    data = fake.objects.get((bucket, key))
                self.send_response(404 if data is None else 200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length",
                                 str(0 if data is None else len(data)))
                self.end_headers()

            def do_DELETE(self):
                if self._maybe_fail():
                    return
                bucket, key, qs = self._split()
                uid = qs.get("uploadId")
                if uid:  # abort multipart: drop accumulated parts
                    with fake._lock:
                        fake.uploads.pop(uid, None)
                    return self._reply(204)
                with fake._lock:
                    fake.objects.pop((bucket, key), None)
                self._reply(204)  # S3: 204 whether or not it existed

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    @property
    def endpoint(self) -> str:
        a = self._httpd.server_address
        return f"http://{a[0]}:{a[1]}"

    def fail_next(self, n: int, status: int = 503) -> None:
        with self._lock:
            self._fail_remaining = n
            self._fail_status = status

    def start(self) -> "FakeS3":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "FakeS3":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
