"""Thin Google Cloud Storage JSON-API client (stdlib only).

A copy of the JAX package's ``storage/gcs.py``. The reference reaches
cloud storage through ``tf.io.gfile``, which reads and writes ``gs://``
URIs in both translation engines (``_img_to_tf_threaded.py:87-88``,
``_img_to_tf_mp.py:43-44``) and in the shard globs of the parse
notebook (``parse_tfrecords.ipynb`` cell 4). Rather than depend on
google-cloud-storage, this is a minimal client over the stable JSON API v1 — upload, download
(ranged), list (paged), stat, delete, rewrite — with bounded
exponential-backoff retries on 429/5xx and connection errors.

Endpoint resolution honors ``STORAGE_EMULATOR_HOST`` (the standard
fake-GCS convention, also used by google's own clients), which is how
the in-process fake (storage/fake_gcs.py) plugs in. Auth is a
bearer token from ``GCS_OAUTH_TOKEN`` when set (e.g. from
``gcloud auth print-access-token``); unset means anonymous — correct
for emulators and public buckets.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

__all__ = ["GCSClient", "get_client", "split_gcs_path", "GCSError",
           "http_request"]

_DEFAULT_ENDPOINT = "https://storage.googleapis.com"
_RETRY_STATUSES = {408, 429, 500, 502, 503, 504}
_MAX_ATTEMPTS = 5
_BACKOFF_BASE = 0.1  # seconds; doubles per attempt


class GCSError(IOError):
    """A GCS request failed after retries (carries the HTTP status)."""

    def __init__(self, msg: str, status: int = 0):
        super().__init__(msg)
        self.status = status


def split_gcs_path(path: str) -> Tuple[str, str]:
    """'gs://bucket/a/b.tif' -> ('bucket', 'a/b.tif')."""
    if not path.startswith("gs://"):
        raise ValueError(f"not a gs:// path: {path!r}")
    rest = path[5:]
    bucket, _, name = rest.partition("/")
    if not bucket:
        raise ValueError(f"gs:// path has no bucket: {path!r}")
    return bucket, name


def http_request(method: str, url: str, data: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 ok_statuses: Tuple[int, ...] = (200,),
                 max_attempts: int = _MAX_ATTEMPTS,
                 timeout: float = 60.0
                 ) -> Tuple[int, bytes, Dict[str, str]]:
    """One HTTP call with bounded exponential-backoff retries on
    transient failures (429/5xx + connection errors). Returns
    (status, body, headers). Raises GCSError when the final status is
    neither ok nor 404/416 (callers map those). Shared by the GCS
    client, the S3 client, the read-only HTTP backend and the remote
    scene catalogs: the same transient-failure discipline the
    reference's retry protocol assumed of its remote service
    (``_descartes_img_chips.py:589-593``)."""
    hdrs = dict(headers or {})
    last_err: Optional[str] = None
    last_status = 0
    for attempt in range(max_attempts):
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            body = e.read()
            if e.code in ok_statuses or e.code in (404, 416):
                return e.code, body, dict(e.headers)
            last_err = f"HTTP {e.code}: {body[:200]!r}"
            last_status = e.code
            if e.code not in _RETRY_STATUSES:
                break
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            last_err = f"{type(e).__name__}: {e}"
            last_status = 0
        time.sleep(_BACKOFF_BASE * (2 ** attempt))
    raise GCSError(f"{method} {url} failed after retries: {last_err}",
                   last_status)


def _endpoint() -> str:
    host = os.environ.get("STORAGE_EMULATOR_HOST", "").strip()
    if not host:
        return _DEFAULT_ENDPOINT
    if not host.startswith(("http://", "https://")):
        host = "http://" + host
    return host.rstrip("/")


class GCSClient:
    """One endpoint's client. Stateless between calls (urllib keeps no
    connection pool; per-request overhead is dwarfed by transfer time
    for shard-sized objects)."""

    def __init__(self, endpoint: Optional[str] = None,
                 token: Optional[str] = None,
                 max_attempts: int = _MAX_ATTEMPTS):
        self.endpoint = (endpoint or _endpoint()).rstrip("/")
        self.token = token if token is not None \
            else os.environ.get("GCS_OAUTH_TOKEN") or None
        self.max_attempts = max_attempts

    # -- low-level ----------------------------------------------------------
    def _request(self, method: str, url: str, data: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 ok_statuses: Tuple[int, ...] = (200,),
                 timeout: float = 60.0,
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        hdrs = dict(headers or {})
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        return http_request(method, url, data=data, headers=hdrs,
                            ok_statuses=ok_statuses,
                            max_attempts=self.max_attempts,
                            timeout=timeout)

    def _obj_url(self, bucket: str, name: str, **params) -> str:
        q = urllib.parse.urlencode(params)
        return (f"{self.endpoint}/storage/v1/b/{bucket}/o/"
                f"{urllib.parse.quote(name, safe='')}" + (f"?{q}" if q
                                                          else ""))

    # -- operations ---------------------------------------------------------
    def download(self, bucket: str, name: str,
                 start: Optional[int] = None,
                 end: Optional[int] = None) -> bytes:
        """Object media; [start, end] (inclusive) selects a byte range.
        Raises FileNotFoundError on 404."""
        headers = {}
        ok: Tuple[int, ...] = (200,)
        if start is not None:
            headers["Range"] = f"bytes={start}-" + (
                "" if end is None else str(end))
            ok = (200, 206)
        status, body, _ = self._request(
            "GET", self._obj_url(bucket, name, alt="media"),
            headers=headers, ok_statuses=ok)
        if status == 404:
            raise FileNotFoundError(f"gs://{bucket}/{name}")
        if status == 416:  # range beyond EOF: empty, like file reads
            return b""
        return body

    def upload(self, bucket: str, name: str, data: bytes) -> dict:
        """Simple media upload. GCS object creation is atomic — the
        object is invisible until the upload completes — which is what
        lets remote shard writes keep the 'existing file == complete
        shard' resume invariant without a .tmp dance."""
        url = (f"{self.endpoint}/upload/storage/v1/b/{bucket}/o"
               f"?uploadType=media&"
               f"{urllib.parse.urlencode({'name': name})}")
        status, body, _ = self._request(
            "POST", url, data=bytes(data),
            headers={"Content-Type": "application/octet-stream"})
        if status == 404:
            raise FileNotFoundError(f"gs://{bucket} (bucket missing?)")
        return json.loads(body or b"{}")

    def upload_stream(self, bucket: str, name: str, src,
                      size: Optional[int] = None,
                      chunk_size: int = 16 * 1024 * 1024) -> dict:
        """Resumable upload streamed from a file-like ``src`` with
        bounded memory (one chunk buffered at a time) — the JSON API's
        resumable protocol: an initiation POST returns a session URI,
        then sequential chunk PUTs with ``Content-Range`` headers (308
        = chunk committed, continue; 200/201 = object finalized).
        Chunks are offset-addressed, so a retried PUT after a
        transient failure is idempotent. This is what tf.io.gfile's
        GCS filesystem does for large objects; the simple ``upload``
        would hold the whole object in memory.

        ``size``: total bytes when known (sent as the range total so
        the server can validate); None streams until EOF with a ``*``
        total. Chunk size must be a multiple of 256 KiB per the
        protocol (enforced here)."""
        if chunk_size % (256 * 1024):
            raise ValueError("GCS resumable chunks must be multiples "
                             f"of 256 KiB, got {chunk_size}")
        url = (f"{self.endpoint}/upload/storage/v1/b/{bucket}/o"
               f"?uploadType=resumable&"
               f"{urllib.parse.urlencode({'name': name})}")
        status, _body, hdrs = self._request(
            "POST", url, data=b"",
            headers={"X-Upload-Content-Type": "application/octet-stream"})
        if status == 404:
            raise FileNotFoundError(f"gs://{bucket} (bucket missing?)")
        session = hdrs.get("Location") or hdrs.get("location")
        if not session:
            raise GCSError("resumable initiation returned no session "
                           "URI", status)
        offset = 0
        while True:
            chunk = src.read(chunk_size)
            last = len(chunk) < chunk_size or (
                size is not None and offset + len(chunk) >= size)
            if not chunk and offset > 0 and size is None:
                # EOF exactly on a chunk boundary: finalize with a
                # zero-length range-total PUT
                total = offset
                status, body, _ = self._request(
                    "PUT", session, data=b"",
                    headers={"Content-Range": f"bytes */{total}"},
                    ok_statuses=(200, 201, 308), timeout=300.0)
                return json.loads(body or b"{}")
            total = (size if size is not None
                     else (offset + len(chunk) if last else "*"))
            end = offset + len(chunk) - 1
            rng = (f"bytes {offset}-{end}/{total}" if chunk
                   else f"bytes */{total}")
            status, body, _ = self._request(
                "PUT", session, data=bytes(chunk),
                headers={"Content-Range": rng},
                ok_statuses=(200, 201, 308), timeout=300.0)
            if status in (200, 201):
                return json.loads(body or b"{}")
            if status == 404:
                raise GCSError("resumable session expired", 404)
            offset += len(chunk)
            if last and status == 308:
                if size is not None:
                    # the final declared chunk got 308 instead of a
                    # finalize: the source delivered fewer bytes than
                    # ``size`` promised -- failing loudly beats
                    # finalizing a silently truncated object
                    raise GCSError(
                        f"source ended at {offset} bytes but "
                        f"size={size} was declared for "
                        f"gs://{bucket}/{name}", 0)
                # unknown size and the last chunk was full-sized: the
                # server has everything but could not finalize yet
                status, body, _ = self._request(
                    "PUT", session, data=b"",
                    headers={"Content-Range": f"bytes */{offset}"},
                    ok_statuses=(200, 201), timeout=300.0)
                return json.loads(body or b"{}")

    def download_stream(self, bucket: str, name: str, dst,
                        chunk_size: int = 16 * 1024 * 1024) -> int:
        """Stream object media into file-like ``dst`` via sequential
        ranged GETs (one chunk in memory at a time; each chunk retries
        independently). Returns bytes written."""
        meta = self.stat(bucket, name)
        if meta is None:
            raise FileNotFoundError(f"gs://{bucket}/{name}")
        total = int(meta.get("size", "0"))
        off = 0
        while off < total:
            end = min(off + chunk_size, total) - 1
            part = self.download(bucket, name, start=off, end=end)
            if not part:
                raise GCSError(f"short ranged read at {off} of "
                               f"gs://{bucket}/{name}", 0)
            dst.write(part)
            off += len(part)
        return off

    def stat(self, bucket: str, name: str) -> Optional[dict]:
        """Object metadata dict, or None when it doesn't exist."""
        status, body, _ = self._request("GET", self._obj_url(bucket, name))
        if status == 404:
            return None
        return json.loads(body)

    def delete(self, bucket: str, name: str) -> bool:
        """True if deleted, False if it didn't exist."""
        status, _, _ = self._request(
            "DELETE", self._obj_url(bucket, name), ok_statuses=(200, 204))
        return status != 404

    def list(self, bucket: str, prefix: str = "",
             delimiter: Optional[str] = None
             ) -> Tuple[List[dict], List[str]]:
        """All objects under a prefix (paged). Returns (items,
        prefixes); with delimiter='/', prefixes are the 'subfolders'."""
        items: List[dict] = []
        prefixes: List[str] = []
        page: Optional[str] = None
        while True:
            params = {"prefix": prefix}
            if delimiter:
                params["delimiter"] = delimiter
            if page:
                params["pageToken"] = page
            url = (f"{self.endpoint}/storage/v1/b/{bucket}/o?"
                   f"{urllib.parse.urlencode(params)}")
            status, body, _ = self._request("GET", url)
            if status == 404:
                raise FileNotFoundError(f"gs://{bucket}")
            doc = json.loads(body)
            items.extend(doc.get("items", []))
            prefixes.extend(doc.get("prefixes", []))
            page = doc.get("nextPageToken")
            if not page:
                return items, prefixes

    def rewrite(self, bucket: str, name: str,
                dst_bucket: str, dst_name: str) -> None:
        """Server-side copy (loops on rewriteToken for large objects)."""
        token: Optional[str] = None
        while True:
            params = {"rewriteToken": token} if token else {}
            q = urllib.parse.urlencode(params)
            url = (f"{self.endpoint}/storage/v1/b/{bucket}/o/"
                   f"{urllib.parse.quote(name, safe='')}/rewriteTo/b/"
                   f"{dst_bucket}/o/"
                   f"{urllib.parse.quote(dst_name, safe='')}"
                   + (f"?{q}" if q else ""))
            status, body, _ = self._request("POST", url)
            if status == 404:
                raise FileNotFoundError(f"gs://{bucket}/{name}")
            doc = json.loads(body)
            if doc.get("done", True):
                return
            token = doc.get("rewriteToken")


_client_cache: Dict[Tuple[str, Optional[str]], GCSClient] = {}


def get_client() -> GCSClient:
    """Endpoint-keyed cached client. The key re-reads the env every
    call so a test fixture that flips STORAGE_EMULATOR_HOST gets a
    fresh client without any reset hook."""
    key = (_endpoint(), os.environ.get("GCS_OAUTH_TOKEN") or None)
    cli = _client_cache.get(key)
    if cli is None:
        cli = _client_cache[key] = GCSClient(endpoint=key[0], token=key[1])
    return cli
