"""Thin Amazon S3 REST client (stdlib only, SigV4).

A copy of the JAX package's ``storage/s3.py``. The reference reaches
cloud storage through ``tf.io.gfile``, which handles ``s3://`` URIs the
same way it handles ``gs://`` ones (its filesystem registry dispatches
on the scheme). This is the s3 leg of that dispatch: a
minimal client over the S3 REST API — GET (ranged) / PUT / HEAD /
DELETE / ListObjectsV2 / server-side copy — exposing the SAME method
surface as storage.gcs.GCSClient so the storage layer treats the two
backends interchangeably.

Auth is AWS Signature Version 4, implemented in-repo from the
published algorithm (hashlib/hmac only) and pinned against the AWS
documentation's official test vector. Credentials
come from the standard env (``AWS_ACCESS_KEY_ID`` /
``AWS_SECRET_ACCESS_KEY`` [/ ``AWS_SESSION_TOKEN``], region from
``AWS_DEFAULT_REGION``); no credentials means unsigned requests —
correct for public buckets and emulators. The endpoint honors
``AWS_ENDPOINT_URL_S3`` (the AWS SDK convention) and falls back to
``AWS_ENDPOINT_URL`` / ``S3_ENDPOINT_URL``, which is how the in-process
fake (storage/fake_s3.py) plugs in; addressing is path-style
(endpoint/bucket/key), the form every emulator and MinIO-style store
accepts.

Transient failures (429/5xx, connection errors) retry with the same
bounded exponential backoff as the GCS client (shared http_request).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from .gcs import GCSError, http_request

__all__ = ["S3Client", "get_s3_client", "split_s3_path", "sigv4_headers"]

_DEFAULT_REGION = "us-east-1"
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def split_s3_path(path: str) -> Tuple[str, str]:
    """'s3://bucket/a/b.tif' -> ('bucket', 'a/b.tif')."""
    if not path.startswith("s3://"):
        raise ValueError(f"not an s3:// path: {path!r}")
    rest = path[5:]
    bucket, _, name = rest.partition("/")
    if not bucket:
        raise ValueError(f"s3:// path has no bucket: {path!r}")
    return bucket, name


def _endpoint() -> str:
    for var in ("AWS_ENDPOINT_URL_S3", "AWS_ENDPOINT_URL",
                "S3_ENDPOINT_URL"):
        host = os.environ.get(var, "").strip()
        if host:
            if not host.startswith(("http://", "https://")):
                host = "http://" + host
            return host.rstrip("/")
    region = os.environ.get("AWS_DEFAULT_REGION", _DEFAULT_REGION)
    return f"https://s3.{region}.amazonaws.com"


def _uri_encode(s: str, *, encode_slash: bool) -> str:
    """SigV4's URI encoding: RFC 3986 unreserved chars stay, everything
    else percent-encodes (space -> %20, never '+')."""
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def sigv4_headers(method: str, url: str, region: str, service: str,
                  access_key: str, secret_key: str,
                  payload_sha256: str,
                  session_token: Optional[str] = None,
                  now: Optional[_dt.datetime] = None,
                  extra_signed: Optional[Dict[str, str]] = None,
                  content_sha_header: bool = True) -> Dict[str, str]:
    """Headers that authenticate one request under AWS SigV4
    (x-amz-date, Authorization, and — for S3, which mandates it —
    x-amz-content-sha256). Implemented from the published algorithm;
    the AWS documentation's official test vector (an IAM request, so
    ``content_sha_header=False`` + an ``extra_signed`` content-type)
    is pinned by the tests, so any drift here fails loudly."""
    parsed = urllib.parse.urlsplit(url)
    host = parsed.netloc
    now = now or _dt.datetime.now(_dt.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    canonical_uri = _uri_encode(urllib.parse.unquote(parsed.path or "/"),
                                encode_slash=False)
    # canonical query: decode, re-encode strictly, sort by key then value
    pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{_uri_encode(k, encode_slash=True)}="
        f"{_uri_encode(v, encode_slash=True)}"
        for k, v in sorted(pairs))

    headers = {"host": host, "x-amz-date": amz_date}
    if content_sha_header:
        headers["x-amz-content-sha256"] = payload_sha256
    if session_token:
        headers["x-amz-security-token"] = session_token
    for k, v in (extra_signed or {}).items():
        headers[k.lower()] = v
    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k].strip()}\n"
                                for k in sorted(headers))
    canonical_request = "\n".join([
        method.upper(), canonical_uri, canonical_query,
        canonical_headers, signed_names, payload_sha256])

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()

    out = dict(headers)
    del out["host"]  # urllib sets Host itself; it stays signed above
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}")
    return out


class S3Client:
    """One endpoint's client; method surface mirrors GCSClient so the
    storage layer dispatches on scheme and nothing else."""

    def __init__(self, endpoint: Optional[str] = None,
                 region: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 session_token: Optional[str] = None,
                 max_attempts: int = 5):
        self.endpoint = (endpoint or _endpoint()).rstrip("/")
        self.region = region or os.environ.get("AWS_DEFAULT_REGION",
                                               _DEFAULT_REGION)
        self.access_key = access_key if access_key is not None \
            else os.environ.get("AWS_ACCESS_KEY_ID") or None
        self.secret_key = secret_key if secret_key is not None \
            else os.environ.get("AWS_SECRET_ACCESS_KEY") or None
        self.session_token = session_token if session_token is not None \
            else os.environ.get("AWS_SESSION_TOKEN") or None
        self.max_attempts = max_attempts

    # -- low-level ----------------------------------------------------------
    def _url(self, bucket: str, name: str = "", **params) -> str:
        path = f"/{bucket}"
        if name:
            path += "/" + urllib.parse.quote(name, safe="/-._~")
        q = urllib.parse.urlencode(sorted(params.items()))
        return self.endpoint + path + (f"?{q}" if q else "")

    def _request(self, method: str, url: str,
                 data: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 ok_statuses: Tuple[int, ...] = (200,),
                 timeout: float = 60.0,
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        hdrs = dict(headers or {})
        if self.access_key and self.secret_key:
            payload_hash = hashlib.sha256(data or b"").hexdigest()
            # S3 mandates every x-amz-* request header be signed
            # (e.g. rewrite's x-amz-copy-source) — fold them into the
            # signature and let sigv4_headers re-emit them.
            extra = {}
            for k in list(hdrs):
                if k.lower().startswith("x-amz-"):
                    extra[k] = hdrs.pop(k)
            hdrs.update(sigv4_headers(
                method, url, self.region, "s3", self.access_key,
                self.secret_key, payload_hash,
                session_token=self.session_token, extra_signed=extra))
        return http_request(method, url, data=data, headers=hdrs,
                            ok_statuses=ok_statuses,
                            max_attempts=self.max_attempts,
                            timeout=timeout)

    # -- operations (GCSClient-shaped) ---------------------------------------
    def download(self, bucket: str, name: str,
                 start: Optional[int] = None,
                 end: Optional[int] = None) -> bytes:
        headers = {}
        ok: Tuple[int, ...] = (200,)
        if start is not None:
            headers["Range"] = f"bytes={start}-" + (
                "" if end is None else str(end))
            ok = (200, 206)
        status, body, _ = self._request(
            "GET", self._url(bucket, name), headers=headers,
            ok_statuses=ok)
        if status == 404:
            raise FileNotFoundError(f"s3://{bucket}/{name}")
        if status == 416:  # range beyond EOF: empty, like file reads
            return b""
        return body

    def upload(self, bucket: str, name: str, data: bytes) -> dict:
        """PUT object. S3 object creation is atomic (the key is
        invisible until the PUT completes), same as GCS — the
        complete-shard resume invariant holds without a .tmp dance."""
        status, _body, hdrs = self._request(
            "PUT", self._url(bucket, name), data=bytes(data),
            headers={"Content-Type": "application/octet-stream"})
        if status == 404:
            raise FileNotFoundError(f"s3://{bucket} (bucket missing?)")
        return {"name": name, "size": str(len(data)),
                "etag": hdrs.get("ETag", "")}

    def upload_stream(self, bucket: str, name: str, src,
                      size: Optional[int] = None,
                      part_size: int = 16 * 1024 * 1024) -> dict:
        """Multipart upload streamed from file-like ``src`` with
        bounded memory (one part buffered at a time). Objects that fit
        one part use a single PUT. This is how anything past S3's
        5 GiB single-PUT cap gets uploaded at all (stitched BigTIFF
        mosaics can exceed it), and what tf.io.gfile's S3 filesystem
        does.

        Protocol: POST ?uploads -> UploadId; PUT ?partNumber=N
        (1-based) per part collecting ETags (parts except the last
        must be >= 5 MiB; the default far exceeds that); POST
        ?uploadId with the CompleteMultipartUpload document. Any
        failure aborts the upload server-side (DELETE ?uploadId) so
        no orphaned parts accrue storage."""
        if part_size < 5 * 1024 * 1024:
            raise ValueError("S3 parts must be >= 5 MiB (except the "
                             f"last), got part_size={part_size}")
        first = src.read(part_size)
        if len(first) < part_size:
            return self.upload(bucket, name, first)

        status, body, _ = self._request(
            "POST", self._url(bucket, name, uploads=""),
            data=b"",
            headers={"Content-Type": "application/octet-stream"})
        if status == 404:
            raise FileNotFoundError(f"s3://{bucket} (bucket missing?)")
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] \
            if root.tag.startswith("{") else ""
        upload_id = root.findtext(f"{ns}UploadId")
        if not upload_id:
            raise GCSError(f"multipart initiation returned no "
                           f"UploadId: {body[:200]!r}")
        etags = []
        try:
            part = first
            num = 1
            while part:
                status, _b, hdrs = self._request(
                    "PUT", self._url(bucket, name, partNumber=str(num),
                                     uploadId=upload_id),
                    data=bytes(part), timeout=300.0)
                if status == 404:
                    raise FileNotFoundError(f"s3://{bucket}/{name} "
                                            "(upload vanished)")
                etags.append(hdrs.get("ETag", "").strip())
                num += 1
                part = src.read(part_size)
            doc = ["<CompleteMultipartUpload>"]
            for i, tag in enumerate(etags, start=1):
                doc.append(f"<Part><PartNumber>{i}</PartNumber>"
                           f"<ETag>{tag}</ETag></Part>")
            doc.append("</CompleteMultipartUpload>")
            # server-side assembly of a multi-GiB object can take
            # minutes; the complete call must outwait it
            status, body, _ = self._request(
                "POST", self._url(bucket, name, uploadId=upload_id),
                data="".join(doc).encode(),
                headers={"Content-Type": "application/xml"},
                timeout=600.0)
            if status == 404 or b"<Error>" in body[:200]:
                raise GCSError(f"multipart complete failed: "
                               f"{body[:200]!r}", status)
            return {"name": name, "parts": len(etags)}
        except BaseException:
            try:  # abort server-side; orphaned parts bill forever
                self._request(
                    "DELETE", self._url(bucket, name,
                                        uploadId=upload_id),
                    ok_statuses=(200, 204))
            except Exception:
                pass
            raise

    def download_stream(self, bucket: str, name: str, dst,
                        chunk_size: int = 16 * 1024 * 1024) -> int:
        """Stream an object into file-like ``dst`` via sequential
        ranged GETs (one chunk in memory at a time). Returns bytes
        written."""
        meta = self.stat(bucket, name)
        if meta is None:
            raise FileNotFoundError(f"s3://{bucket}/{name}")
        total = int(meta.get("size", "0"))
        off = 0
        while off < total:
            end = min(off + chunk_size, total) - 1
            part = self.download(bucket, name, start=off, end=end)
            if not part:
                raise GCSError(f"short ranged read at {off} of "
                               f"s3://{bucket}/{name}", 0)
            dst.write(part)
            off += len(part)
        return off

    def stat(self, bucket: str, name: str) -> Optional[dict]:
        status, _body, hdrs = self._request(
            "HEAD", self._url(bucket, name))
        if status == 404:
            return None
        return {"name": name,
                "size": hdrs.get("Content-Length", "0")}

    def delete(self, bucket: str, name: str) -> bool:
        """True if deleted, False if it didn't exist. S3's DELETE is
        204 either way, so existence is checked first (two requests —
        unlink is not a hot path)."""
        if self.stat(bucket, name) is None:
            return False
        self._request("DELETE", self._url(bucket, name),
                      ok_statuses=(200, 204))
        return True

    def list(self, bucket: str, prefix: str = "",
             delimiter: Optional[str] = None
             ) -> Tuple[List[dict], List[str]]:
        """ListObjectsV2, paged. Same return shape as GCSClient.list:
        (items with 'name'/'size', common prefixes)."""
        items: List[dict] = []
        prefixes: List[str] = []
        token: Optional[str] = None
        while True:
            params = {"list-type": "2", "prefix": prefix}
            if delimiter:
                params["delimiter"] = delimiter
            if token:
                params["continuation-token"] = token
            status, body, _ = self._request(
                "GET", self._url(bucket, **params))
            if status == 404:
                raise FileNotFoundError(f"s3://{bucket}")
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                items.append({
                    "name": c.findtext(f"{ns}Key", ""),
                    "size": c.findtext(f"{ns}Size", "0")})
            for p in root.findall(f"{ns}CommonPrefixes"):
                prefixes.append(p.findtext(f"{ns}Prefix", ""))
            if root.findtext(f"{ns}IsTruncated", "false") != "true":
                return items, prefixes
            token = root.findtext(f"{ns}NextContinuationToken")
            if not token:
                return items, prefixes

    def rewrite(self, bucket: str, name: str,
                dst_bucket: str, dst_name: str) -> None:
        """Server-side copy (x-amz-copy-source)."""
        src = "/" + urllib.parse.quote(f"{bucket}/{name}", safe="/-._~")
        status, body, _ = self._request(
            "PUT", self._url(dst_bucket, dst_name),
            headers={"x-amz-copy-source": src})
        if status == 404:
            raise FileNotFoundError(f"s3://{bucket}/{name}")
        # CopyObject can return 200 with an error document in the body
        if b"<Error>" in body[:200]:
            raise GCSError(f"s3 copy {bucket}/{name} failed: "
                           f"{body[:200]!r}")


_client_cache: Dict[tuple, S3Client] = {}


def get_s3_client() -> S3Client:
    """Endpoint+credential-keyed cached client; the key re-reads the
    env each call so test fixtures that flip AWS_ENDPOINT_URL_S3 get a
    fresh client without a reset hook (same pattern as gcs.get_client).
    """
    key = (_endpoint(),
           os.environ.get("AWS_ACCESS_KEY_ID") or None,
           os.environ.get("AWS_SECRET_ACCESS_KEY") or None,
           os.environ.get("AWS_SESSION_TOKEN") or None,
           os.environ.get("AWS_DEFAULT_REGION") or None)
    cli = _client_cache.get(key)
    if cli is None:
        cli = _client_cache[key] = S3Client(endpoint=key[0])
    return cli
