"""A world of ``n`` ranks that runs every sharding regime of the trainer.

``dryrun_multichip(n, device="cpu")`` is the port's counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``: it spawns ``n`` ranks
(``torch.multiprocessing``, one process and one device each; gloo on the
CPU, or on one card shared by the ranks, where NCCL refuses a card that
two ranks share; NCCL on separate cards) and runs in that world, for
each regime (pure data parallel, dp x channel TP, dp x FSDP, dp x
spatial, and any the caller names): train steps on given global batches,
``evaluate``, ``predict`` and ``predict_probs`` (an odd batch, padded to
the data axis), a checkpoint saved by the world and restored into a
fresh trainer on the same mesh, and optionally ``train_scanned`` from a
pool stored sharded over "data" and the data plane as ``cli train``
runs it (shards -> a ``TFRecordFeed`` of every shard on every rank, the
same global batches -> ``DevicePrefetcher`` -> sharded steps -> one
``train_scanned`` dispatch from a pool filled from the feed).

It returns one dict per regime: what rank 0 saw (losses, accuracies,
each step's global gradient norm before clipping, the first step's
synced and clipped gradients as full tensors, the SHA-256 digests of the
full parameters after the steps (the arrays are in the checkpoint), the
metrics, the class maps and probabilities, the checkpoint's path) and
each rank's own numbers (bytes of parameters and Adam moments, the
leaves it holds sharded, step times, on a card the step's peak memory
above its resident state, whether the checkpoint restored bitwise).
An inference-only regime returns the logits of its images. Each rank
runs torch on one intra-op thread. If a rank fails, the call raises:
nothing falls back to one rank or to the CPU.

    python -m dl_image_segmentation_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import hashlib
import os
import socket
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["default_regimes", "digests", "dryrun_multichip",
           "seeded_batches", "write_shards"]


def seeded_batches(cfg: dict, n_batches: int, seed: int) -> List[tuple]:
    """Seeded global batches; the first has its first quarter of rows all
    nodata (on a 4-rank data axis, one rank's every pixel)."""
    rng = np.random.RandomState(seed)
    size, b = cfg.get("image_size", 32), cfg.get("batch_size", 8)
    k = cfg.get("num_classes", 3)
    out = []
    for i in range(n_batches):
        x = rng.rand(b, size, size, cfg.get("in_channels", 3)).astype(
            np.float32)
        y = rng.randint(0, k, (b, size, size)).astype(np.int32)
        y[:, :2, :3] = cfg.get("label_nodata", 255)
        if i == 0:
            y[:max(1, b // 4)] = cfg.get("label_nodata", 255)
        out.append((x, y))
    return out


def default_regimes(n: int) -> Dict[str, dict]:
    """The JAX dry run's regimes at tiny shapes: pure DP over all ranks,
    and (for an even n >= 4) dp x TP (with the data plane), dp x FSDP
    and dp x spatial with a model axis of 2; fp32, clipping at 1.0."""
    base = dict(num_classes=3, base_features=16, levels=2, image_size=32,
                batch_size=max(8, n), precision="fp32", grad_clip_norm=1.0)
    m = 2 if n % 2 == 0 and n >= 4 else 1
    out = {"dp": {"n_model": 1, "config": dict(base)}}
    if m > 1:
        out["tp"] = {"n_model": m, "config": dict(base, base_features=128,
                                                  n_model=m),
                     "data_plane": True}
    out["fsdp"] = {"n_model": m, "config": dict(base, n_model=m, fsdp=True)}
    if m > 1:
        out["spatial"] = {"n_model": m, "config": dict(base, n_model=m,
                                                       spatial=True),
                          "scanned": True}
    return out


def write_shards(directory: str, n_shards: int = 3, per_shard: int = 12,
                 size: int = 32, seed: int = 0) -> str:
    """rgbarr shards of seeded uint8 chips (label: red > 127); returns
    their glob."""
    from ..records.example import convert_to_example
    from ..records.tfrecord import TFRecordWriter
    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    for s in range(n_shards):
        w = TFRecordWriter(os.path.join(
            directory, f"dry-{s:05d}-of-{n_shards:05d}"))
        for k in range(per_shard):
            img = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
            lbl = (img[:, :, 0] > 127).astype(np.uint8)
            w.write(convert_to_example(img, lbl, size, size, 3, size, size,
                                       f"dry_{s}_{k}").SerializeToString())
        w.close()
    return os.path.join(directory, "dry-*")


def digests(params: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """SHA-256 of each tensor's bytes, by name."""
    return {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
            for k, v in params.items()}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _run_regime(name: str, spec: dict, n: int, device, workdir: str
                ) -> dict:
    from ..pipeline.input import DevicePrefetcher, TFRecordFeed
    from ..train.pool import DeviceDataPool
    from ..train.trainer import TrainConfig, Trainer
    from .sharding import batch_sharding, make_mesh
    from .spmd import spec_axes

    t_start = time.perf_counter()
    cfg = TrainConfig(**spec["config"])
    nm = spec.get("n_model", 1)
    mesh = make_mesh(n // nm, nm, device=device)
    tr = Trainer(cfg, device=device, mesh=mesh)
    if spec.get("init") is not None:
        tr.load_flax_params(spec["init"])
    batches = spec.get("batches") or seeded_batches(spec["config"], 3, 0)
    if spec.get("infer"):
        return _run_inference(tr, spec, batches, t_start)
    out: dict = {"mesh": dict(mesh.shape), "losses": [], "accuracies": [],
                 "grad_norms": []}
    mine = {"step_ms": [], "activation_bytes": None}
    cuda = torch.device(device).type == "cuda"
    for i, (x, y) in enumerate(batches):
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            resident = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        m = tr.train_step(x, y)
        _sync(device)
        mine["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if cuda:
            # the step's peak above the state it starts from: the
            # activations kept for the backward, the gradients and the
            # transient buffers of its collectives
            peak = torch.cuda.max_memory_allocated(device) - resident
            mine["activation_bytes"] = max(mine["activation_bytes"] or 0,
                                           peak)
        out["losses"].append(m["loss"])
        out["accuracies"].append(m["accuracy"])
        out["grad_norms"].append(None if tr.grad_norm is None
                                 else float(tr.grad_norm))
        if i == 0:
            # the first step's gradients, synced and clipped, whole
            out["grads"] = {n: tr._full(n, p.grad).detach().cpu().clone()
                            for n, p in tr.state.params.items()}
    st = tr.state
    mine["param_bytes"] = _nbytes(st.params.values())
    mine["moment_bytes"] = _nbytes(list(st.opt_state.mu.values())
                                   + list(st.opt_state.nu.values()))
    mine["sharded"] = {n_: "+".join(spec_axes(s))
                       for n_, s in (tr.shardings or {}).items()
                       if not s.is_fully_replicated}
    mine["local_shapes"] = {n_: tuple(p.shape)
                            for n_, p in st.params.items()}
    out["param_digests"] = digests(tr._payload()["params"])
    ex, ey = spec.get("eval") or batches[-1]
    out["eval"] = tr.evaluate([(ex, ey)])
    pimg = ex[:max(1, len(ex) - 1)]
    out["predict"] = tr.predict(pimg)
    out["probs"] = tr.predict_probs(pimg)
    if spec.get("serve"):
        out["serve"] = _serve_world(tr, ex, spec["serve"])
    # a checkpoint the world saves restores bitwise, each rank its
    # shards: saved, stepped on, restored over the step
    path = _checkpoint_path(workdir, name, spec)
    trees = (st.params, st.opt_state.mu, st.opt_state.nu)
    kept = [{k: v.detach().clone() for k, v in t.items()} for t in trees]
    tr.save_checkpoint(path)
    tr.train_step(*batches[0])
    tr.restore_checkpoint(path)
    same = tr.state.step == len(batches)
    for a, b in zip(trees, kept):
        same = same and all(torch.equal(a[k], b[k]) for k in b)
    mine["checkpoint_equal"] = bool(same)
    out["checkpoint"] = path
    if spec.get("restore"):
        # another regime's checkpoint, re-sharded onto this mesh
        src = os.path.join(workdir, spec["restore"])
        out["restored_from"] = src if os.path.isdir(src) else f"{src}.pt"
        tr2 = Trainer(cfg, device=device, mesh=mesh)
        tr2.restore_checkpoint(out["restored_from"])
        out["restored_digests"] = digests(tr2._payload()["params"])
        del tr2
    if spec.get("scanned"):
        rng = np.random.RandomState(1)
        size = cfg.image_size
        pool_x = rng.randint(0, 255, (16, size, size, cfg.in_channels),
                             np.uint8)
        pool_y = (pool_x[..., 0] > 128).astype(np.uint8)
        pool = DeviceDataPool(pool_x, pool_y, sharding=batch_sharding(mesh))
        mine["pool_rows"] = int(pool.images.shape[0])
        before = len(tr.scan_losses)
        tr.train_scanned(pool, total_steps=4, steps_per_dispatch=2, seed=0,
                         augment=True)
        out["scan_losses"] = tr.scan_losses[before:]
    if spec.get("data_plane"):
        mode = spec.get("mode", "rgbarr")
        # every rank deals the same global batches and decodes its rows
        rows = tr.data_rows(cfg.batch_size)
        feed = TFRecordFeed(spec["shards"], mode,
                            batch_size=cfg.batch_size,
                            image_size=cfg.image_size, shuffle_buffer=8,
                            num_workers=2, per_host=False, rows=rows)
        mine["feed_files"] = [os.path.basename(f) for f in feed.files]
        mine["feed_rows"] = rows
        fed = []
        with DevicePrefetcher(feed.batches(), tr.place_rows if rows
                              else tr.place_batch, device=tr.device) as pf:
            it = iter(pf)
            for _ in range(2):
                images, labels = next(it)
                fed.append(tr.train_step(images, labels)["loss"])
        # the batches taken and those prefetched, this rank's rows only
        mine["feed_decoded"] = feed.records_read
        pool_feed = TFRecordFeed(spec["shards"], mode,
                                 batch_size=cfg.batch_size,
                                 image_size=cfg.image_size, shuffle_buffer=8,
                                 num_workers=2, scale="raw",
                                 per_host=False)
        refresh = pool_feed.batches()
        pool = DeviceDataPool.from_feed(pool_feed.batches(),
                                        2 * cfg.batch_size,
                                        sharding=batch_sharding(mesh))
        scan = tr.train_scanned(pool, total_steps=4, steps_per_dispatch=2,
                                refresh_feed=refresh)
        refresh.close()
        out["feed_losses"] = fed + [scan["loss"]]
        mine["feed_pool_rows"] = int(pool.images.shape[0])
    mine["seconds"] = time.perf_counter() - t_start
    return {"out": out, "mine": mine}


def _checkpoint_path(workdir: str, name: str, spec: dict) -> str:
    """Where a regime's world saves its checkpoint: an orbax directory
    with ``orbax``, else a ``.pt`` file."""
    return os.path.join(workdir, name if spec.get("orbax") else f"{name}.pt")


def _run_inference(tr, spec: dict, batches, t_start: float) -> dict:
    """An inference-only regime: (int8-static: calibrate on the first
    batch, every rank the same images) the logits of the eval images,
    gathered whole on every rank."""
    ex = (spec.get("eval") or batches[-1])[0]
    tr.calibrate([batches[0]], max_batches=1)
    logits = torch.cat([lg.cpu() for lg in tr._chunked_logits(ex)])
    out = {"mesh": dict(tr.mesh.shape), "logits": logits.numpy(),
           "quant_vars": tr.quant_vars}
    if spec.get("serve"):
        out["serve"] = _serve_world(tr, ex, spec["serve"])
    return {"out": out, "mine": {"seconds": time.perf_counter() - t_start}}


def _post(base: str, img: np.ndarray, probs: bool) -> tuple:
    """(the .npy answer of one POST /predict, its seconds); no proxy."""
    import io
    import urllib.request
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(img, np.float32))
    req = urllib.request.Request(
        base + "/predict" + ("?probs=1" if probs else ""),
        data=buf.getvalue(), method="POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    t0 = time.perf_counter()
    with opener.open(req, timeout=300) as r:
        body = r.read()
    return np.load(io.BytesIO(body)), time.perf_counter() - t0


def _concurrent(base: str, imgs, probs: bool) -> tuple:
    """POST every image at once, one thread each: (the answers in order,
    each request's seconds, the wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(imgs)) as pool:
        res = list(pool.map(lambda im: _post(base, im, probs), imgs))
    return ([a for a, _ in res], [s for _, s in res],
            time.perf_counter() - t0)


def _serve_world(tr, images: np.ndarray, opts) -> Optional[dict]:
    """A ``PredictServer`` of the world's trainer: on the primary behind
    ``make_http_server`` on loopback, a full batch of class-map requests
    at once, a partial batch, and two probability requests, a uint8 and
    a uint16 chip through ``submit``, then
    ``rounds`` (``opts["rounds"]``, default 0) more full batches timed,
    while every other rank follows; then the world's ``predict`` and
    ``predict_probs`` of the same images (collectives: every rank).
    Returns on the primary the served maps (full, partial, typed) and
    probabilities beside the world's own, the requests' seconds and the
    requests/s of the timed rounds; None elsewhere."""
    import threading
    from ..serve import PredictServer, make_http_server
    opts = opts if isinstance(opts, dict) else {}
    bs = int(tr.config.batch_size)
    imgs = [images[i % len(images)] for i in range(bs)]
    part = max(1, bs // 2 - 1)
    # a window that holds a batch of requests sent at once
    ps = PredictServer(tr, max_wait_ms=50.0)
    res = None
    if ps.primary:
        httpd = make_http_server("127.0.0.1", 0, ps, scale="none")
        base = "http://%s:%d" % httpd.server_address[:2]
        front = threading.Thread(target=httpd.serve_forever, daemon=True)
        front.start()
        try:
            full, _, _ = _concurrent(base, imgs, False)
            partial, _, _ = _concurrent(base, imgs[:part], False)
            probs, _, _ = _concurrent(base, imgs[:2], True)
            # the library path keeps a chip's dtype: uint8 and uint16
            # chips are scaled by predict_both on every rank
            typed = [ps.submit(im, probs=False, timeout=300)
                     for im in _typed(imgs)]
            for p in typed:
                if p.error is not None:
                    raise RuntimeError(f"a typed chip failed: {p.error}")
            lat, wall = [], 0.0
            for _ in range(int(opts.get("rounds", 0))):
                _, secs, w = _concurrent(base, imgs, False)
                lat += secs
                wall += w
        finally:
            httpd.shutdown()
            httpd.server_close()
            ps.close()
        if ps.error is not None:
            raise RuntimeError(f"the world's server failed: {ps.error!r}")
        res = {"maps": np.stack(full), "partial": np.stack(partial),
               "probs": np.stack(probs),
               "typed": [p.result for p in typed], "dispatches": ps.batches,
               "request_seconds": lat,
               "requests_per_s": len(lat) / wall if wall else None}
    else:
        ps.follow()
    stack = np.stack(imgs)
    want, want_p = tr.predict(stack), tr.predict_probs(stack)
    want_t = [tr.predict(im[None])[0] for im in _typed(imgs)]
    if res is not None:
        res.update(predict=want, predict_probs=want_p, predict_typed=want_t)
    return res


def _typed(imgs) -> list:
    """A uint8 and a uint16 chip made from the first two images (values
    in [0, 1] spread over each type's range)."""
    return [(np.clip(imgs[i], 0, 1) * top).astype(t)
            for i, (t, top) in enumerate(((np.uint8, 255),
                                          (np.uint16, 65535)))]


def _rank_main(rank: int, n: int, port: int, device: str, spec_path: str,
               workdir: str) -> None:
    # the ranks share the host's cores
    torch.set_num_threads(1)
    from . import distributed
    # gloo on the CPU and for ranks that share a card ("cuda:0")
    backend = "gloo" if device == "cpu" or ":" in device else "nccl"
    if backend == "nccl":
        device = f"cuda:{rank}"
    distributed.initialize(f"127.0.0.1:{port}", n, rank, device=device,
                           backend=backend)
    try:
        regimes = torch.load(spec_path, weights_only=False)
        results = {}
        for name, spec in regimes.items():
            r = _run_regime(name, spec, n, device, workdir)
            results[name] = r if rank == 0 else {"mine": r["mine"]}
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int = 4, device: str = "cpu",
                     regimes: Optional[Dict[str, dict]] = None,
                     workdir: Optional[str] = None) -> Dict[str, dict]:
    """Run ``regimes`` (default :func:`default_regimes`) in a world of
    ``n_devices`` ranks on ``device`` ("cpu"; "cuda" gives rank r the
    card r; "cuda:0" puts every rank on card 0 over gloo). Each regime:
    ``n_model``, ``config`` (TrainConfig fields), and optionally
    ``batches`` (global (images, labels) host batches; default three
    seeded ones), ``eval`` (one batch), ``init`` (a flax param tree),
    ``scanned``, ``orbax`` (the checkpoint is the orbax directory that
    the JAX ``Trainer`` writes, not a ``.pt`` file), ``data_plane``
    (with ``shards``, a glob, default
    :func:`write_shards` in ``workdir``, and their ``mode``, default
    rgbarr), ``restore`` (the name of an
    earlier regime of the same model, whose checkpoint a fresh trainer
    of this regime restores), ``infer`` (no steps: int8-static
    calibrates on the first batch, and the regime returns the logits of
    the eval images), ``serve`` (True, or ``{"rounds": n}``: a
    ``PredictServer`` of the world answers HTTP
    requests of the eval images on the primary while the other ranks
    follow; see :func:`_serve_world`). Returns {name: {..., "ranks": [each rank's
    numbers]}}; the checkpoints stay in ``workdir`` (default a new
    temporary directory)."""
    import torch.multiprocessing as mp
    if regimes is None:
        regimes = default_regimes(n_devices)
    workdir = workdir or tempfile.mkdtemp(prefix="dlseg_dryrun_")
    os.makedirs(workdir, exist_ok=True)
    for spec in regimes.values():
        if spec.get("data_plane") and not spec.get("shards"):
            spec["shards"] = write_shards(os.path.join(workdir, "shards"),
                                          n_shards=max(3, n_devices))
    spec_path = os.path.join(workdir, "regimes.pt")
    torch.save(regimes, spec_path)
    mp.start_processes(_rank_main, args=(
        n_devices, _free_port(), device, spec_path, workdir),
        nprocs=n_devices, join=True, start_method="spawn")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(n_devices)]
    return {name: dict(ranks[0][name]["out"],
                       ranks=[r[name]["mine"] for r in ranks])
            for name in regimes}


def _main(argv) -> int:
    n = int(argv[0]) if argv else 4
    device = argv[1] if len(argv) > 1 else "cpu"
    res = dryrun_multichip(n, device)
    for name, r in res.items():
        ok = all(k["checkpoint_equal"] for k in r["ranks"])
        print(f"dryrun_multichip ok ({name}): mesh={r['mesh']} "
              f"losses={[round(v, 4) for v in r['losses']]} "
              f"miou={r['eval']['miou']:.4f} checkpoint_equal={ok}")
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
