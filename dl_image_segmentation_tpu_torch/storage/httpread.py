"""Read-only ``https://`` / ``http://`` storage backend.

A copy of the JAX package's ``storage/httpread.py``, with one fault
fixed (below). ``tf.io.gfile``'s filesystem registry also reads plain
HTTP(S) URIs, which is why the reference's file reads
(``_img_to_tf_mp.py:43-44``) go through gfile. With this backend, chip
folders, TFRecord shard inputs and whole rasters can live behind any
web server.

Semantics:

* ``download`` is a plain GET (with ``Range`` for partial reads),
  retried with the shared bounded backoff (storage.gcs.http_request).
* ``stat`` is a HEAD. Its size is the HEAD's ``Content-Length``; a
  server that rejects HEAD (405/501) or sends no length is probed with
  a 1-byte ranged GET, whose ``Content-Range`` carries the total; a
  server that gives no total either is read with one plain GET. The
  size is never guessed: the JAX package takes a missing
  ``Content-Length`` as 0, and its ``download_stream`` then writes an
  empty file without complaint. Here ``download_stream`` writes the
  whole object or raises.
* ``list`` crawls directory autoindex pages (the ``<a href>`` listing
  format of python -m http.server, Apache, nginx), enough for
  ``storage.listdir``/``storage.glob`` and therefore ``to-tfrecords
  --directory https://...``. Recursion is bounded (depth, entry count)
  so a link cycle cannot hang a run.
* Writes (``upload``/``delete``/``rewrite``) raise PermissionError:
  the scheme is read-only; anything writable is gs:// or s3://.
"""

from __future__ import annotations

import html.parser
import urllib.parse
from typing import Dict, List, Optional, Tuple

from .gcs import http_request

__all__ = ["HTTPReadClient", "get_http_client"]

_MAX_DEPTH = 16
_MAX_ENTRIES = 100_000


class _HrefParser(html.parser.HTMLParser):
    def __init__(self):
        super().__init__()
        self.hrefs: List[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            for k, v in attrs:
                if k == "href" and v:
                    self.hrefs.append(v)


def _header(headers: Dict[str, str], key: str) -> Optional[str]:
    """A response header by case-insensitive name."""
    key = key.lower()
    for k, v in headers.items():
        if k.lower() == key:
            return v.strip()
    return None


def _index_entries(page: bytes) -> List[str]:
    """Relative child entries from an autoindex page: names (unquoted),
    subdirectories keeping their trailing '/'. Absolute links, parent
    links and query links are navigation, not content."""
    p = _HrefParser()
    try:
        p.feed(page.decode("utf-8", "replace"))
    except Exception:
        return []
    out = []
    for href in p.hrefs:
        if href.startswith(("/", "?", "#")) or "://" in href:
            continue
        if href.startswith(("../", "./")):
            continue
        name = urllib.parse.unquote(href.partition("?")[0])
        if name and name not in ("..", "."):
            out.append(name)
    return out


class HTTPReadClient:
    """Read-only client with the shared backend method surface
    (download/stat/list; writes refuse) so the storage layer treats
    ``https://host/path`` like ``gs://bucket/key`` for every read
    path. ``bucket`` is the authority (host[:port]), ``name`` the
    path."""

    def __init__(self, scheme: str = "https://", max_attempts: int = 5):
        self.scheme = scheme
        self.max_attempts = max_attempts

    def _url(self, bucket: str, name: str = "") -> str:
        return (self.scheme + bucket + "/"
                + urllib.parse.quote(name, safe="/-._~"))

    # -- reads ---------------------------------------------------------------
    def download(self, bucket: str, name: str,
                 start: Optional[int] = None,
                 end: Optional[int] = None) -> bytes:
        headers = {}
        ok: Tuple[int, ...] = (200,)
        if start is not None:
            headers["Range"] = f"bytes={start}-" + (
                "" if end is None else str(end))
            ok = (200, 206)
        status, body, _ = http_request(
            "GET", self._url(bucket, name), headers=headers,
            ok_statuses=ok, max_attempts=self.max_attempts)
        if status == 404:
            raise FileNotFoundError(f"{self.scheme}{bucket}/{name}")
        if status == 416:
            return b""
        if status == 200 and start is not None:
            # server ignored Range: slice locally so callers still get
            # exactly the requested window
            stop = None if end is None else end + 1
            return body[start:stop]
        return body

    def stat(self, bucket: str, name: str) -> Optional[dict]:
        """{"name", "size"} with the object's true size, or None when
        it does not exist (see the module docstring)."""
        found = self._size_or_body(bucket, name)
        if found is None:
            return None
        return {"name": name, "size": str(found[0])}

    def _size_or_body(self, bucket: str, name: str
                      ) -> Optional[Tuple[int, Optional[bytes]]]:
        """(size, body): body is the whole object when finding the size
        took a plain GET (so a caller need not fetch it twice), else
        None. None when the object does not exist."""
        url = self._url(bucket, name)
        status, _body, hdrs = http_request(
            "HEAD", url, ok_statuses=(200, 405, 501),
            max_attempts=self.max_attempts)
        if status == 404:
            return None
        length = _header(hdrs, "Content-Length") if status == 200 \
            else None
        if length is not None and length.isdigit():
            return int(length), None
        # no HEAD, or no length: probe with a ranged GET
        status, body, hdrs = http_request(
            "GET", url, headers={"Range": "bytes=0-0"},
            ok_statuses=(200, 206), max_attempts=self.max_attempts)
        if status == 404:
            return None
        if status == 416:  # an empty object
            return 0, b""
        if status == 200:  # Range ignored: the body is the whole object
            return len(body), body
        total = (_header(hdrs, "Content-Range") or "").rpartition("/")[2]
        if total.isdigit():
            return int(total), None
        # a 206 without a total: one plain GET
        status, body, _ = http_request(
            "GET", url, max_attempts=self.max_attempts)
        if status == 404:
            return None
        return len(body), body

    def _read_index(self, bucket: str, dirname: str) -> List[str]:
        """Child entries of one directory via its autoindex page;
        [] when the server has no index there."""
        url = self._url(bucket, dirname)
        if not url.endswith("/"):
            url += "/"
        try:
            status, body, _ = http_request(
                "GET", url, max_attempts=self.max_attempts)
        except Exception:
            return []
        if status != 200:
            return []
        return _index_entries(body)

    def list(self, bucket: str, prefix: str = "",
             delimiter: Optional[str] = None
             ) -> Tuple[List[dict], List[str]]:
        """GCS-list-shaped directory crawl: (items with 'name',
        prefixes). With delimiter='/' a single autoindex page; without,
        a bounded recursive walk."""
        base = prefix[: prefix.rfind("/") + 1] if "/" in prefix else ""
        items: List[dict] = []
        prefixes: List[str] = []
        stack = [(base, 0)]
        while stack:
            d, depth = stack.pop()
            for entry in self._read_index(bucket, d):
                full = d + entry
                if not full.startswith(prefix):
                    continue
                if entry.endswith("/"):
                    if delimiter:
                        prefixes.append(full)
                    elif depth + 1 <= _MAX_DEPTH:
                        stack.append((full, depth + 1))
                else:
                    items.append({"name": full, "size": "0"})
                    if len(items) >= _MAX_ENTRIES:
                        return sorted(items, key=lambda i: i["name"]), \
                            sorted(prefixes)
        return sorted(items, key=lambda i: i["name"]), sorted(prefixes)

    def download_stream(self, bucket: str, name: str, dst,
                        chunk_size: int = 16 * 1024 * 1024) -> int:
        """Stream the object into ``dst`` in ranged GETs. Writes all of
        its bytes or raises: a short read is an error, never a short
        file."""
        found = self._size_or_body(bucket, name)
        if found is None:
            raise FileNotFoundError(f"{self.scheme}{bucket}/{name}")
        total, body = found
        if body is not None:
            dst.write(body)
            return len(body)
        off = 0
        while off < total:
            end = min(off + chunk_size, total) - 1
            part = self.download(bucket, name, start=off, end=end)
            if not part:
                raise IOError(f"short ranged read at {off} of "
                              f"{self.scheme}{bucket}/{name}")
            dst.write(part)
            off += len(part)
        return off

    # -- writes refuse -------------------------------------------------------
    def _read_only(self, bucket: str, name: str):
        raise PermissionError(
            f"{self.scheme}{bucket}/{name}: http(s):// storage is "
            "read-only; write outputs to a local path, gs:// or s3://")

    def upload(self, bucket: str, name: str, data) -> dict:
        self._read_only(bucket, name)

    def upload_stream(self, bucket: str, name: str, src, **kw) -> dict:
        self._read_only(bucket, name)

    def delete(self, bucket: str, name: str) -> bool:
        self._read_only(bucket, name)

    def rewrite(self, bucket: str, name: str, dst_bucket: str,
                dst_name: str) -> None:
        self._read_only(bucket, name)


_clients: Dict[str, HTTPReadClient] = {}


def get_http_client(scheme: str) -> HTTPReadClient:
    cli = _clients.get(scheme)
    if cli is None:
        cli = _clients[scheme] = HTTPReadClient(scheme)
    return cli
