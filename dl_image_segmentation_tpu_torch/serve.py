"""Micro-batching inference server: the serving layer of the port.

A stdlib-only HTTP server around ``Trainer.predict_both``, a port of
the JAX package's ``serve.py`` with the same endpoints, status codes and
Prometheus lines:

- requests arriving within a short window (``max_wait_ms``) are packed
  into ONE batch, padded to ``batch_size``, so the card sees one batch
  shape whatever the arrival pattern;
- one forward pass serves BOTH output kinds: probability requests get
  the softmax map, class-map requests the logits' argmax (the same
  int32 map as ``Trainer.predict``);
- request bodies are any raster the port decodes (TIFF/GeoTIFF, JPEG
  2000, PNG, JPEG, GIF, BMP, NetCDF, GRIB, HDF4, HDF5 / NetCDF-4, NITF,
  GeoPackage, ...; decoded as bare bytes and scaled by the offline rules
  of ``scale_image``) or ``.npy`` arrays taken as raw, already-scaled
  float arrays; multi-file ENVI, every VRT and every HDF5 file that
  names other files (external storage, virtual datasets, external links:
  their sources are files or URLs that a client must not choose) and
  corrupt bodies answer 400;
- bounded admission: beyond ``max_queue`` waiting requests the server
  answers 503 at once, and shutdown fails queued requests instead of
  letting them time out. A batch that fails surfaces its error to every
  caller of that batch.

Endpoints:
  GET  /healthz            -> JSON status (model, step, batch size)
  GET  /metrics            -> Prometheus text exposition (request
                              counters, queue depth, latency
                              histograms)
  POST /predict            -> int32 class map as .npy bytes
  POST /predict?probs=1    -> float32 (H, W, num_classes) .npy bytes

Bodies of any OTHER (H, W) with the model's band count run the
sliding-window whole-raster path (``predict_windowed_batched``):
windows of the chip size ride the same micro-batcher, overlaps blend by
averaging softmax probabilities on the host -- the same blend as the
offline ``pipeline.window.predict_windowed`` -- ``?stride=N`` sets the
step, undersized rasters are edge-padded and cropped back, and rasters
beyond ``max_pixels`` answer 413.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["PredictServer", "make_http_server", "scale_image",
           "predict_windowed_batched", "WindowedError"]


def scale_image(src: np.ndarray, scale: str) -> np.ndarray:
    """The offline predict CLI's deterministic scaling rules: 'auto'
    scales by SOURCE dtype (uint8 -> /255, uint16 -> /65535, floats
    untouched), 'none' feeds raw DNs (tifraw/tifarr-trained
    checkpoints), any other value is a float multiplier."""
    imgs = src.astype(np.float32)
    if scale == "auto":
        if src.dtype == np.uint8:
            imgs /= 255.0
        elif src.dtype == np.uint16:
            imgs /= 65535.0
    elif scale != "none":
        imgs *= float(scale)
    return imgs


class _Pending:
    __slots__ = ("img", "probs", "event", "result", "error", "status",
                 "t0")

    def __init__(self, img: np.ndarray, probs: bool):
        self.img = img
        self.probs = probs
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.status: int = 500  # HTTP status when error is set
        self.t0 = time.perf_counter()


class _Hist:
    """Fixed-bucket latency histogram in Prometheus exposition shape
    (cumulative ``le`` buckets + sum + count)."""

    BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
              0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        while i < len(self.BOUNDS) and v > self.BOUNDS[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def lines(self, name: str) -> list:
        out = [f"# TYPE {name} histogram"]
        cum = 0
        with self._lock:
            for bound, c in zip(self.BOUNDS, self.counts):
                cum += c
                out.append(f'{name}_bucket{{le="{bound}"}} {cum}')
            out.append(f'{name}_bucket{{le="+Inf"}} {self.count}')
            out.append(f"{name}_sum {self.sum:.6f}")
            out.append(f"{name}_count {self.count}")
        return out


class PredictServer:
    """Collects requests into fixed-size device batches.

    One background worker drains the queue: the first request opens a
    batch window of ``max_wait_ms``; whatever arrived by then (capped
    at the batch size) rides one ``predict_both`` dispatch.
    Under load the window never idles -- a full batch closes
    immediately -- so max_wait_ms bounds LATENCY, not throughput."""

    def __init__(self, trainer, max_wait_ms: float = 5.0,
                 max_queue: int = 0):
        self.trainer = trainer
        self.batch_size = int(trainer.config.batch_size)
        self.max_wait = max_wait_ms / 1e3
        # backpressure: beyond max_queue waiting requests, submit fails
        # fast with 503 instead of stacking unbounded latency (default:
        # 8 batches' worth in flight)
        self.max_queue = max_queue or 8 * self.batch_size
        self.q: "queue.Queue[_Pending]" = queue.Queue(self.max_queue)
        self.served = 0
        self.batches = 0
        self.rejected = 0
        self.errors = 0
        self.request_latency = _Hist()   # enqueue -> result ready
        self.dispatch_latency = _Hist()  # one device batch
        self._stop = False
        # serializes the _stop check against put_nowait so an enqueue
        # racing close() can never strand a pending in a drained queue
        # (it would otherwise block its caller for the full timeout)
        self._admit = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def enqueue(self, img: np.ndarray, probs: bool) -> _Pending:
        """Queue one window/chip WITHOUT waiting (the windowed
        whole-raster path fans out many of these, then waits). A full
        queue or a shutting-down server fails the pending fast (503);
        check ``.error`` before waiting on it."""
        p = _Pending(img, probs)
        with self._admit:
            if self._stop:
                p.error, p.status = "server shutting down", 503
                return p
            try:
                self.q.put_nowait(p)
            except queue.Full:
                self.rejected += 1
                p.error, p.status = (
                    f"server overloaded ({self.max_queue} requests "
                    f"queued)", 503)
        return p

    def wait(self, p: _Pending, timeout: float = 60.0) -> _Pending:
        """Wait for an enqueued pending (no-op if it already failed
        fast at enqueue time)."""
        if p.error is None and not p.event.wait(timeout):
            p.error = "inference timed out"
        return p

    def submit(self, img: np.ndarray, probs: bool,
               timeout: float = 60.0) -> _Pending:
        """img: float32 (H, W, C), already scaled. Blocks until the
        batch containing this request completes. A full queue or a
        shutting-down server fails fast (503), never blocks."""
        return self.wait(self.enqueue(img, probs), timeout)

    def close(self):
        with self._admit:  # no enqueue can be mid-put past this point
            self._stop = True
        self._worker.join(timeout=5.0)
        # fail anything still queued so callers don't sit out their
        # full timeout against a dead worker
        while True:
            try:
                p = self.q.get_nowait()
            except queue.Empty:
                break
            p.error, p.status = "server shutting down", 503
            p.event.set()

    def _loop(self):
        while not self._stop:
            try:
                first = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.batch_size:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            self._run(batch)

    def _run(self, batch):
        try:
            t_dispatch = time.perf_counter()
            imgs = np.stack([p.img for p in batch])
            if len(batch) < self.batch_size:
                # pad to the batch size: one batch shape forever
                pad = np.zeros((self.batch_size - len(batch),)
                               + imgs.shape[1:], imgs.dtype)
                imgs = np.concatenate([imgs, pad])
            # one forward serves both kinds; class maps are the logits'
            # argmax, int32, the same map as Trainer.predict
            classes, probs = self.trainer.predict_both(imgs)
            for i, p in enumerate(batch):
                p.result = probs[i] if p.probs else classes[i]
            self.served += len(batch)
            self.batches += 1
            self.dispatch_latency.observe(time.perf_counter()
                                          - t_dispatch)
        except Exception as e:  # noqa: BLE001 -- surface to every caller
            self.errors += 1
            for p in batch:
                p.error = f"{type(e).__name__}: {e}"
        finally:
            done = time.perf_counter()
            for p in batch:
                self.request_latency.observe(done - p.t0)
                p.event.set()


class WindowedError(Exception):
    """A windowed request failed partway (overload/shutdown/timeout);
    carries the HTTP status the handler should answer with."""

    def __init__(self, msg: str, status: int):
        super().__init__(msg)
        self.status = status


def predict_windowed_batched(server: PredictServer, image: np.ndarray,
                             stride: Optional[int] = None,
                             probs: bool = False,
                             timeout: float = 300.0) -> np.ndarray:
    """Whole-raster inference THROUGH the micro-batcher.

    Same sliding-window blend as ``pipeline.window.predict_windowed``
    (windows of the chip size, overlaps averaged in softmax
    space), but each window rides the server's queue, so a large
    scene's windows pack into the same fixed-shape device dispatches
    as concurrent single-chip traffic. Windows are fanned out one
    device batch at a time, so a big scene cannot monopolise the
    admission queue. image: float32 (H, W, C), already scaled. Raises
    WindowedError when a window fails."""
    from .pipeline.window import window_origins

    cfg = server.trainer.config
    size = int(cfg.image_size)
    stride = size if stride is None else int(stride)
    img = np.asarray(image)
    h0, w0 = img.shape[:2]
    pad_h = max(0, size - h0)
    pad_w = max(0, size - w0)
    if pad_h or pad_w:  # undersized: edge-pad up, crop the result back
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    h, w = img.shape[:2]
    wins = [(r, c) for r in window_origins(h, size, stride)
            for c in window_origins(w, size, stride)]
    acc = np.zeros((h, w, cfg.num_classes), np.float32)
    cnt = np.zeros((h, w, 1), np.float32)
    bs = server.batch_size
    for i in range(0, len(wins), bs):
        chunk = wins[i:i + bs]
        pend = [server.enqueue(img[r:r + size, c:c + size], probs=True)
                for r, c in chunk]
        for (r, c), p in zip(chunk, pend):
            server.wait(p, timeout)
            if p.error is not None:
                raise WindowedError(p.error, p.status)
            acc[r:r + size, c:c + size] += p.result
            cnt[r:r + size, c:c + size] += 1.0
    out = (acc / cnt)[:h0, :w0]
    if probs:
        return out.astype(np.float32)
    # int32, byte-comparable with the offline predict_windowed output
    return np.argmax(out, axis=-1).astype(np.int32)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def make_http_server(host: str, port: int, server: PredictServer,
                     scale: str = "auto",
                     max_pixels: int = 16_000_000) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer serving /healthz and /predict on top
    of a PredictServer. Caller runs .serve_forever() (and .shutdown()
    to stop). Port 0 binds an ephemeral port (see .server_address).

    Bodies of exactly the chip shape ride the micro-batcher
    directly; LARGER rasters (same band count) run the sliding-window
    path (``predict_windowed_batched``; ``?stride=N`` sets the window
    step, default = window size), capped at ``max_pixels`` (the host
    must hold the float32 probability accumulation) -- beyond it the
    answer is 413."""
    trainer = server.trainer
    cfg = trainer.config
    expect = (cfg.image_size, cfg.image_size, cfg.in_channels)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = self.path.split("?")[0]
            if route == "/metrics":
                return self._metrics()
            if route != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {
                "ok": True, "model": cfg.model,
                "step": int(trainer.state.step),
                "image_size": cfg.image_size,
                "in_channels": cfg.in_channels,
                "num_classes": cfg.num_classes,
                "batch_size": server.batch_size,
                "served": server.served, "batches": server.batches,
                "rejected": server.rejected,
                "max_queue": server.max_queue,
                "max_pixels": max_pixels})

        def _metrics(self):
            """Prometheus text exposition: counters, queue gauge, and
            request/dispatch latency histograms — the standard scrape
            surface for production serving."""
            lines = [
                "# TYPE dlseg_requests_served_total counter",
                f"dlseg_requests_served_total {server.served}",
                "# TYPE dlseg_batches_total counter",
                f"dlseg_batches_total {server.batches}",
                "# TYPE dlseg_requests_rejected_total counter",
                f"dlseg_requests_rejected_total {server.rejected}",
                "# TYPE dlseg_batch_errors_total counter",
                f"dlseg_batch_errors_total {server.errors}",
                "# TYPE dlseg_queue_depth gauge",
                f"dlseg_queue_depth {server.q.qsize()}",
                "# TYPE dlseg_batch_size gauge",
                f"dlseg_batch_size {server.batch_size}",
            ]
            lines += server.request_latency.lines(
                "dlseg_request_latency_seconds")
            lines += server.dispatch_latency.lines(
                "dlseg_dispatch_latency_seconds")
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _npy_response(self, arr: np.ndarray):
            out = _npy_bytes(arr)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npy")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                return self._json(404, {"error": "not found"})
            from urllib.parse import parse_qs
            qs = parse_qs(query)
            want_probs = qs.get("probs", ["0"])[0] == "1"
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                arr = self._decode(body)
            except Exception as e:  # noqa: BLE001 -- client error
                return self._json(400, {"error": f"bad request body: "
                                                 f"{e}"})
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.shape == expect:
                p = server.submit(arr, want_probs)
                if p.error is not None:
                    return self._json(p.status, {"error": p.error})
                return self._npy_response(p.result)
            # any OTHER raster with the model's band count runs the
            # sliding-window path through the same micro-batcher
            if arr.ndim != 3 or arr.shape[2] != expect[2]:
                return self._json(400, {
                    "error": f"expected {expect[2]}-band raster or a "
                             f"{expect} chip, got {tuple(arr.shape)}"})
            if arr.shape[0] * arr.shape[1] > max_pixels:
                return self._json(413, {
                    "error": f"raster {arr.shape[0]}x{arr.shape[1]} "
                             f"exceeds max_pixels={max_pixels}"})
            try:
                stride = int(qs["stride"][0]) if "stride" in qs \
                    else None
                if stride is not None and not \
                        (1 <= stride <= expect[0]):
                    raise ValueError(
                        f"stride must be in [1, {expect[0]}]")
            except ValueError as e:
                return self._json(400, {"error": f"bad stride: {e}"})
            try:
                out = predict_windowed_batched(
                    server, arr, stride=stride, probs=want_probs)
            except WindowedError as e:
                return self._json(e.status, {"error": str(e)})
            return self._npy_response(out)

        @staticmethod
        def _decode(body: bytes) -> np.ndarray:
            if body[:6] == b"\x93NUMPY":
                # raw array: caller already applied its own scaling
                return np.asarray(np.load(io.BytesIO(body),
                                          allow_pickle=False),
                                  np.float32)
            from .raster.image import decode_image_bytes
            # a body never names files or URLs for the server to read
            g = decode_image_bytes(body, allow_sources=False)
            return scale_image(np.asarray(g.array), scale)

    return ThreadingHTTPServer((host, port), Handler)
