"""Command-line interface of the PyTorch + CUDA port.

    python -m dl_image_segmentation_tpu_torch.cli <command> ...
    dlseg-torch <command> ...            (the installed console script)

A port of the JAX package's ``cli.py``: the same commands, flags,
defaults and output lines. Commands:

    create-chips   tile an AOI, composite imagery, burn labels, write
                   GeoTIFF chip pairs (catalog: 'synthetic', a
                   LocalCatalog root, an http(s):// scene server or a
                   stac+http(s):// STAC endpoint)
    to-tfrecords   chip folders -> sharded TFRecords (--engine mp for
                   GeoTIFF chips, mt for PNG/JPEG chips)
    convert        GeoTIFF chip folder -> PNG/JPG chip folder
    train          TFRecords -> training on the card (--model unet,
                   deeplab or segformer)
    eval           dataset mIoU / accuracy / loss of a checkpoint
    predict        chips, shards or one large GeoTIFF -> class maps
    serve          micro-batching HTTP inference endpoint
    stitch         tile-key chips -> one GeoTIFF mosaic
    inspect        summarize shards, verify CRCs, label statistics,
                   --preview PNG contact sheet
    push           shards -> records sink (directory or signed URLs)
    doctor         environment self-check (card, nvcc, kernels, codecs)
    map            chips -> interactive HTML map

Every path argument (chip folders, --out, shard globs, --checkpoint,
--geotiff, catalog roots) may be ``gs://bucket/...`` or
``s3://bucket/...``, and for reads ``http(s)://host/...``, through the
storage layer (``storage/``): ``STORAGE_EMULATOR_HOST`` and
``GCS_OAUTH_TOKEN`` configure gs://, the ``AWS_*`` variables s3://.

The device commands (create-chips, train, eval, predict, serve) take
``--device {cuda,cpu}``, default ``cuda``: without a card they raise
unless ``--device cpu`` is given. Checkpoints are written as the port's
``torch.save`` files; ``--restore`` and ``--checkpoint`` also take the
JAX package's orbax checkpoint directories, and a ``--save-every``
directory of its orbax steps resumes from the newest step, locally or
on gs:// / s3:// (``train/orbax.py``). PNG, JPEG, GIF and BMP decode and PNG/JPEG encode
through the port's own codecs (``raster/``), so the default ``train
--mode rgbraw`` reads PNG/JPEG records; JPEG 2000 decodes and encodes
through the port's own codec too, so ``ingest-safe`` walks Sentinel-2
``.SAFE`` trees and JP2 chips take every path a GeoTIFF takes. What is
not ported raises NotImplementedError naming its ROADMAP queue 1 item.
train, eval and predict join a ``torch.distributed`` world when the
environment names one (torchrun's variables, or the JAX package's
``DLSEG_NUM_PROCESSES``, ``DLSEG_PROCESS_ID`` and
``COORDINATOR_ADDRESS``): ``torchrun --nproc-per-node N -m
dl_image_segmentation_tpu_torch.cli train ...`` trains data parallel
over N cards, with ``--n-model``, ``--spatial`` and ``--fsdp`` as in the
JAX package (``--device cpu`` runs the world over gloo); only the
primary rank writes checkpoints and outputs and prints. predict, eval and
serve take ``--quantize int8|int8-static`` (the U-Net only); int8-static
calibrates on ``--calibrate-records`` (``--calibrate-batches`` batches)
or else on the first batch it infers.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import os
import sys

def _date(s: str) -> _dt.date:
    return _dt.date.fromisoformat(s)


def cmd_create_chips(args) -> int:
    from .catalog import LocalCatalog, SyntheticCatalog
    from .pipeline.chips import DLSampleCreationConfig, OGRLabelDataDesc
    from .pipeline.export import run_export

    if args.catalog == "synthetic":
        catalog = SyntheticCatalog()
    elif args.catalog.startswith(("stac+http://", "stac+https://")):
        # STAC endpoint (static tree or item-search API);
        # --processing-level filters items' processing:level property
        from .catalog.stac import STACCatalog
        level = args.processing_level
        catalog = STACCatalog(
            args.catalog,
            processing_level=None if level == "surface" else level)
    elif args.catalog.startswith(("http://", "https://")):
        # remote scene server: COG windowed reads and bounded retries;
        # --processing-level picks the asset level
        from .catalog.http import HTTPCatalog
        catalog = HTTPCatalog(args.catalog,
                              processing_level=args.processing_level)
    else:
        catalog = LocalCatalog(args.catalog)
    cfg = DLSampleCreationConfig(
        tile_size=args.tile_size, tile_padding=args.pad,
        tile_res_m=args.resolution, dl_product=args.product,
        bands=args.bands, sample_folder_root=args.out,
        source_tag=args.tag,
        label_data_config=OGRLabelDataDesc(args.labels, args.layer,
                                           args.attribute),
        max_cloud_fraction=args.max_cloud_fraction,
        label_nodata_value=args.nodata,
        catalog=catalog)
    jobs = cfg.create_tile_job_configs(
        args.loc, args.year, ref_date=args.ref_date,
        min_date=args.min_date, max_date=args.max_date)
    print(f"{len(jobs)} tiles to export into "
          f"{cfg.images_dir_name(args.loc, args.year)}")
    report = run_export(jobs, n_workers=args.workers,
                        max_attempts=args.max_attempts,
                        low_priority=args.low_priority,
                        batch_tiles=args.batch_tiles, device=args.device)
    return 0 if report.ok else 1


def cmd_to_tfrecords(args) -> int:
    from .records.writers import (process_dataset_mp,
                                  process_dataset_multithreaded)
    if args.engine == "mt":
        n = process_dataset_multithreaded(
            args.name, args.directory, args.out, num_shards=args.shards,
            num_threads=args.workers,
            dltile_from_filename=not args.no_dltile_names,
            convert_png_to_jpg=args.png_to_jpg,
            store_as_array=args.store_as_array,
            resume=args.resume)
    else:
        n = process_dataset_mp(
            args.name, args.directory, args.out, num_shards=args.shards,
            num_proc=args.workers,
            dltile_from_filename=not args.no_dltile_names,
            file_ext=args.file_ext,
            store_as_array=args.store_as_array,
            resume=args.resume)
    print(f"wrote {n} examples")
    return 0


def cmd_convert(args) -> int:
    from .pipeline.convert import convert_chip_folder
    convert_chip_folder(
        args.directory, args.out, file_ext=args.file_ext, to=args.to,
        num_workers=args.workers, quality=args.quality,
        rescale=args.rescale, rescale_labels=args.rescale_labels)
    return 0


def _join_world(args):
    """Join the world the environment names (a no-op in one process);
    returns the print of this rank: ``print`` on the primary, a no-op on
    the others."""
    from .parallel import initialize, is_primary
    initialize(device=args.device)
    return print if is_primary() else (lambda *a, **k: None)


def cmd_train(args) -> int:
    from .pipeline.input import DevicePrefetcher, TFRecordFeed
    from .train.trainer import TrainConfig, Trainer

    print = _join_world(args)  # only the primary prints

    cfg = TrainConfig(num_classes=args.classes,
                      in_channels=args.channels,
                      base_features=args.features,
                      levels=args.levels,
                      image_size=args.image_size,
                      batch_size=args.batch_size,
                      learning_rate=args.lr,
                      weight_decay=args.weight_decay,
                      label_nodata=args.nodata,
                      n_model=args.n_model,
                      spatial=args.spatial,
                      fsdp=args.fsdp,
                      remat=args.remat,
                      s2d=args.s2d,
                      seed=args.seed,
                      model=args.model,
                      precision=args.precision,
                      schedule=args.schedule,
                      warmup_steps=args.warmup_steps,
                      total_steps=args.steps,
                      grad_clip_norm=args.grad_clip_norm,
                      class_weights=(
                          tuple(float(w) for w
                                in args.class_weights.split(","))
                          if args.class_weights else None),
                      augment_invert=args.augment_invert,
                      augment_brightness=args.augment_brightness,
                      augment_contrast=args.augment_contrast,
                      augment_geometric=args.augment)
    # any photometric knob implies augmentation (geometric ops stay
    # gated on --augment itself)
    photometric = (args.augment_invert > 0 or args.augment_brightness > 0
                   or args.augment_contrast > 0)
    do_augment = args.augment or photometric
    trainer = Trainer(cfg, device=args.device)
    manager = None
    if args.save_every > 0:
        if not args.checkpoint:
            print("--save-every requires --checkpoint DIR", file=sys.stderr)
            return 2
        # rotating managed checkpoints + automatic latest-step resume: a
        # long run killed mid-way restarts where it left off with the
        # same command line
        manager = trainer.checkpoint_manager(args.checkpoint,
                                             keep=args.keep)
        resumed = trainer.restore_latest(manager)
        if resumed is not None:
            print(f"resumed from managed checkpoint step {resumed}")
    # total-budget semantics apply ONLY to the managed auto-resume. A
    # --restore fine-tune keeps its checkpoint's step counter but still
    # runs the full --steps requested here.
    done_already = int(trainer.state.step)
    if args.restore:
        trainer.restore_checkpoint(args.restore)
        done_already = int(trainer.state.step)
        remaining = args.steps
    else:
        remaining = max(0, args.steps - done_already)
    # scale="raw": the feed keeps the SOURCE dtype (4x less host copy
    # and H2D traffic for uint8); the step scales on the card
    # in a world every rank reads every shard, so each deals the same
    # global batches of --batch-size (the feed's order does not depend on
    # its threads) and decodes only its data rows of them; place_rows
    # keeps its band. A pool (--scan-steps) holds the global examples
    rows = (None if args.scan_steps > 0
            else trainer.data_rows(args.batch_size))
    feed = TFRecordFeed(args.records, args.mode,
                        batch_size=args.batch_size,
                        image_size=args.image_size,
                        shuffle_buffer=args.shuffle_buffer,
                        num_workers=args.workers,
                        scale="raw", verify_crc=args.verify_crc,
                        per_host=False, rows=rows)
    place_feed = trainer.place_batch if rows is None else trainer.place_rows

    def maybe_save():
        # skip when this step is already on disk (e.g. a fully-resumed
        # run's final save)
        if manager is not None and \
                manager.latest_step() != int(trainer.state.step):
            saved = trainer.save_managed(manager)
            print(f"managed checkpoint saved at step {saved}")

    from .parallel import is_primary
    mlog = open(args.metrics_log, "a", buffering=1) \
        if args.metrics_log and is_primary() else None

    def log_metrics(step, **kv):
        # one JSON object per line, appended (resumes continue the same
        # file)
        if mlog is not None:
            mlog.write(json.dumps(
                {"step": int(step),
                 **{k: round(float(v), 6) for k, v in kv.items()}}) + "\n")

    def run_eval(step):
        # a fresh non-repeating feed each time: the validation set is
        # read once, whole (dataset confusion-matrix mIoU)
        erows = _eval_rows(trainer)
        efeed = TFRecordFeed(args.eval_records, args.mode,
                             batch_size=args.batch_size,
                             image_size=args.image_size,
                             num_workers=args.workers, repeat=False,
                             scale="raw", verify_crc=args.verify_crc,
                             per_host=False, rows=erows)
        out = trainer.evaluate(efeed.batches(),
                               max_batches=args.eval_max_batches,
                               rows=erows is not None)
        print(f"val step {step}: loss={out['loss']:.4f} "
              f"acc={out['accuracy']:.4f} miou={out['miou']:.4f} "
              f"over {out['batches']} batches")
        log_metrics(step, val_loss=out["loss"],
                    val_accuracy=out["accuracy"], val_miou=out["miou"])

    try:
        if args.scan_steps > 0:
            # device-resident pool mode: K steps per dispatch, one host
            # sync a dispatch (train/pool.py)
            from .parallel import batch_sharding
            from .train.pool import DeviceDataPool
            pool = DeviceDataPool.from_feed(
                feed.batches(), args.pool_size, device=trainer.device,
                sharding=batch_sharding(trainer.mesh))
            refresh = feed.batches()
            out = None
            while remaining > 0:
                chunk = min(remaining, args.save_every) \
                    if args.save_every > 0 else remaining
                out = trainer.train_scanned(
                    pool, total_steps=chunk,
                    steps_per_dispatch=args.scan_steps,
                    refresh_feed=refresh, augment=do_augment)
                remaining -= chunk
                log_metrics(trainer.state.step, loss=out["loss"],
                            accuracy=out["accuracy"],
                            examples_per_sec=out["examples_per_sec"],
                            duty_cycle=out["duty_cycle"])
                if args.eval_records and remaining > 0:
                    # scan mode evaluates at dispatch-chunk boundaries
                    # (--save-every sized); the final eval is below
                    run_eval(int(trainer.state.step))
                if remaining > 0:  # the final save happens below
                    maybe_save()
            refresh.close()  # stops the refresh feed's parse threads
            if out is not None:
                print(f"final: loss={out['loss']:.4f} "
                      f"acc={out['accuracy']:.4f} "
                      f"imgs/s={out['examples_per_sec']:.1f} "
                      f"duty={out['duty_cycle']:.3f}")
        elif remaining > 0:
            if do_augment:
                import torch
                from .ops.augment import apply_augment, draw_augment
                from .train.trainer import normalize_images
                agen = torch.Generator(device=trainer.device)

                def place(images, labels):
                    # the global batch (or this rank's rows of it):
                    # augmented, then cut
                    return (torch.from_numpy(images).to(trainer.device),
                            torch.from_numpy(labels).to(trainer.device))
            with DevicePrefetcher(feed.batches(),
                                  place if do_augment else place_feed,
                                  device=trainer.device) as pf:
                it = iter(pf)
                for step in range(remaining):
                    images, labels = next(it)
                    if do_augment:
                        # on-device augmentation of the global batch, its
                        # draws seeded from (seed, global step) as the
                        # JAX package folds the step into its key (a
                        # resumed run draws what an unbroken one would,
                        # and every rank of a world draws the same);
                        # then this rank's rows and band. Photometric
                        # ops act on [0,1] images, so integer feeds
                        # normalize first (the step's normalize passes
                        # floats through).
                        if photometric:
                            images = normalize_images(images)
                        agen.manual_seed((cfg.seed << 32)
                                         + done_already + step)
                        # the global batch's draws (augment_pairs'), this
                        # rank's rows of them
                        draws = draw_augment(
                            agen, args.batch_size, hflip=args.augment,
                            vflip=args.augment, rot90=args.augment,
                            invert_prob=args.augment_invert,
                            brightness=args.augment_brightness,
                            contrast=args.augment_contrast,
                            device=trainer.device)
                        if rows is not None:
                            draws = {k: v[rows[0]:rows[1]]
                                     for k, v in draws.items()}
                        images, labels = apply_augment(images, labels,
                                                       draws)
                        images, labels = place_feed(images, labels)
                    metrics = trainer.train_step(images, labels)
                    if step % args.log_every == 0 or step == remaining - 1:
                        stats = trainer.throughput_stats()
                        print(f"step {done_already + step}: "
                              f"loss={metrics['loss']:.4f} "
                              f"acc={metrics['accuracy']:.4f} "
                              f"imgs/s={stats['examples_per_sec']:.1f} "
                              f"duty={stats['duty_cycle']:.3f}")
                        log_metrics(done_already + step,
                                    loss=metrics["loss"],
                                    accuracy=metrics["accuracy"],
                                    examples_per_sec=stats[
                                        "examples_per_sec"],
                                    duty_cycle=stats["duty_cycle"])
                    if (args.save_every > 0 and step != remaining - 1
                            and (step + 1) % args.save_every == 0):
                        maybe_save()
                    if (args.eval_records and args.eval_every > 0
                            and step != remaining - 1
                            and (step + 1) % args.eval_every == 0):
                        run_eval(done_already + step + 1)
            if rows is not None:
                print(f"feed: decoded {feed.records_read} records: rows "
                      f"{rows[0]}-{rows[1] - 1} of each global batch of "
                      f"{args.batch_size}, prefetched batches included")
        if manager is not None:
            maybe_save()
        elif args.checkpoint:
            trainer.save_checkpoint(args.checkpoint)
            print(f"checkpoint saved to {args.checkpoint}")
        if args.eval_records:
            run_eval(int(trainer.state.step))
    finally:
        if mlog is not None:
            mlog.close()
    return 0


def _inference_trainer(args, **extra):
    """Trainer of predict / eval / serve, restored from --checkpoint (in
    a world, a data-parallel trainer over its ranks)."""
    from .train.trainer import TrainConfig, Trainer
    cfg = TrainConfig(num_classes=args.classes, in_channels=args.channels,
                      base_features=args.features, levels=args.levels,
                      image_size=args.image_size,
                      batch_size=args.batch_size, model=args.model,
                      precision=args.precision, quantize=args.quantize,
                      s2d=args.s2d, **extra)
    trainer = Trainer(cfg, device=args.device)
    trainer.restore_checkpoint(args.checkpoint)
    _maybe_calibrate(trainer, args)
    return trainer


def _eval_rows(trainer):
    """The rows of each evaluation batch that this rank decodes: its data
    rows, or every row (None) where int8-static still calibrates on the
    first batch, which needs the whole batch on every rank."""
    if (trainer.config.quantize == "int8-static"
            and not trainer._calibrated):
        return None
    return trainer.data_rows(trainer.config.batch_size)


def _maybe_calibrate(trainer, args) -> None:
    """int8-static calibration from --calibrate-records (a shard glob read
    with the command's --mode, raw dtypes: the calibration forward
    normalizes as inference does). Without it int8-static calibrates on
    the first batch it infers."""
    recs = getattr(args, "calibrate_records", None)
    if trainer.config.quantize != "int8-static" or not recs:
        return
    from .pipeline.input import TFRecordFeed
    # every rank of a world calibrates on the same batches
    feed = TFRecordFeed(recs, getattr(args, "mode", "tifarr"),
                        batch_size=trainer.config.batch_size,
                        image_size=trainer.config.image_size,
                        num_workers=2, repeat=False, scale="raw",
                        per_host=False)
    n = trainer.calibrate(feed.batches(), max_batches=args.calibrate_batches)
    print(f"int8-static: calibrated activation scales over {n} "
          f"batch(es) from {recs}")


def _pad_batch(imgs, batch_size: int):
    """Pad a final short batch with zeros to the batch size."""
    import numpy as np
    n_real = len(imgs)
    if n_real < batch_size:
        pad = np.zeros((batch_size - n_real,) + imgs.shape[1:], imgs.dtype)
        imgs = np.concatenate([imgs, pad])
    return imgs


def cmd_predict(args) -> int:
    """Run the model over a chip folder and write georeferenced
    prediction GeoTIFFs (usable as a LocalCatalog product for the
    multi-product stacking flow, reference :472-518)."""
    import numpy as np

    from . import storage
    from .raster.geotiff import read_geotiff, write_geotiff
    from .serve import scale_image

    print = _join_world(args)  # only the primary prints
    trainer = _inference_trainer(args)
    # in a world every rank infers (the forwards are collectives) and
    # only the primary writes
    from .parallel import is_primary
    if not is_primary():
        def write_geotiff(*a, **k):
            return None
    if args.geotiff:
        # whole-raster sliding-window inference: --out is ONE GeoTIFF
        from .pipeline.window import predict_windowed
        if args.stride is not None and not \
                (1 <= args.stride <= args.image_size):
            print(f"--stride must be in [1, --image-size="
                  f"{args.image_size}], got {args.stride}",
                  file=sys.stderr)
            return 2
        g = read_geotiff(args.geotiff)
        if not storage.is_remote(args.out):
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)

        last = [-1]

        def _progress(done, total):
            # ~10 lines per run, however many windows a scene has
            decile = done * 10 // total
            if decile != last[0] or done == total:
                last[0] = decile
                print(f"windows {done}/{total}", flush=True)

        out = predict_windowed(trainer, g.array, stride=args.stride,
                               scale=args.scale, probs=args.probs,
                               progress=_progress)
        write_geotiff(args.out,
                      out.astype(np.float32 if args.probs else np.uint8),
                      geotransform=g.info.geotransform,
                      epsg=g.info.epsg, bigtiff="auto")
        print(f"wrote {out.shape[0]}x{out.shape[1]} "
              f"{'probability' if args.probs else 'class'} map to "
              f"{args.out}")
        return 0
    if is_primary():
        storage.makedirs(args.out, exist_ok=True)
    if args.records:
        return _predict_from_records(args, trainer, write_geotiff, print)
    if not args.images:
        print("predict needs --images DIR, --records GLOB or "
              "--geotiff FILE", file=sys.stderr)
        return 2
    files = storage.glob(storage.join(args.images, "*.tif"))
    if not files:
        print(f"no .tif chips in {args.images}")
        return 1
    wrote = 0
    for i in range(0, len(files), args.batch_size):
        chunk = files[i:i + args.batch_size]
        gs = [read_geotiff(f) for f in chunk]
        # deterministic scaling chosen by --scale ('auto' = by source
        # dtype; tifraw/tifarr-trained checkpoints need 'none')
        imgs = _pad_batch(scale_image(np.stack([g.array for g in gs]),
                                      args.scale), args.batch_size)
        n_real = len(chunk)
        if args.probs:
            # per-class softmax probabilities as a float32 multi-band
            # GeoTIFF (band k = P(class k))
            outs = trainer.predict_probs(imgs)[:n_real].astype(np.float32)
        else:
            outs = trainer.predict(imgs)[:n_real].astype(np.uint8)
        for f, g, p in zip(chunk, gs, outs):
            write_geotiff(storage.join(args.out, storage.basename(f)), p,
                          geotransform=g.info.geotransform,
                          epsg=g.info.epsg)
            wrote += 1
    print(f"wrote {wrote} prediction chips to {args.out}")
    return 0


def cmd_eval(args) -> int:
    """mIoU / accuracy / loss over TFRecord shards with a checkpoint."""
    from .pipeline.input import TFRecordFeed

    print = _join_world(args)  # only the primary prints
    trainer = _inference_trainer(args, label_nodata=args.nodata)
    # source-dtype batches; the card normalizes. Every rank of a world
    # deals the same batches and decodes its data rows of them
    rows = _eval_rows(trainer)
    feed = TFRecordFeed(args.records, args.mode,
                        batch_size=args.batch_size,
                        image_size=args.image_size,
                        shuffle_buffer=1, num_workers=args.workers,
                        repeat=False, scale="raw",
                        verify_crc=args.verify_crc, per_host=False,
                        rows=rows)
    out = trainer.evaluate(feed.batches(), max_batches=args.max_batches,
                           rows=rows is not None)

    def _round(v):
        if isinstance(v, float):
            return round(v, 6)
        if isinstance(v, list):
            return [_round(x) for x in v]
        return v

    if args.json:
        print(json.dumps({k: _round(v) for k, v in out.items()}))
    else:
        print(f"eval: loss={out['loss']:.4f} acc={out['accuracy']:.4f} "
              f"miou={out['miou']:.4f} over {out['batches']} batches")
        per = ", ".join(
            f"{k}: iou={'--' if i is None else f'{i:.4f}'} "
            f"f1={'--' if f is None else f'{f:.4f}'}"
            for k, (i, f) in enumerate(zip(out["per_class_iou"],
                                           out["per_class_f1"])))
        print(f"per-class: {per}")
    return 0


def cmd_stitch(args) -> int:
    from .pipeline.stitch import stitch_folder
    n, shape = stitch_folder(args.chips, args.out,
                             fill_value=args.fill)
    print(f"stitched {n} tiles into {args.out} ({shape[0]}x{shape[1]})")
    return 0


def cmd_ingest_safe(args) -> int:
    """Walk Sentinel-2 .SAFE product trees into a LocalCatalog."""
    from .catalog.local import LocalCatalog
    cat = LocalCatalog.create(args.catalog)
    total = 0
    for safe in args.safe:
        n = cat.ingest_safe(safe, product=args.product,
                            cloud_fraction=args.cloud_fraction)
        print(f"{safe}: {n} granule(s) registered")
        total += n
    print(f"registered {total} scene(s) in {args.catalog} "
          f"(product {args.product})")
    return 0 if total else 1


def cmd_push(args) -> int:
    """Push finished shards to a records sink (the reference's upload
    flow, parse nb cells 39-46)."""
    from .records.sink import push_shards, sink_from_dest
    push_shards(args.records, sink_from_dest(args.dest),
                resume=not args.no_resume)
    return 0


def cmd_doctor(args) -> int:
    """Environment self-check for this card: its name and power limit,
    nvcc, the kernels' build, each kernel against its plain version on
    one small case, the g++ host builds, and the GeoTIFF and Example
    round trips. Any failing check exits non-zero."""
    import numpy as np

    checks = []

    def check(name, fn):
        try:
            detail = fn()
            checks.append((name, True, detail or ""))
        except Exception as e:  # noqa: BLE001 -- report, don't crash
            checks.append((name, False, f"{type(e).__name__}: {e}"))

    def _card_check():
        import subprocess

        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        return (f"{torch.cuda.device_count()} device(s); "
                f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
                f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    def _nvcc_check():
        import subprocess

        from . import kernels
        out = subprocess.run([kernels.nvcc(), "--version"],
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.strip().splitlines()
        return f"{kernels.nvcc()}: {out[-1]}"

    def _build_check():
        from . import kernels
        built = kernels.build_all()
        return ", ".join(f"{n} ({s:.1f} s)" for n, (s, _) in built.items())

    def _kernel_check():
        import torch

        from . import kernels
        from .ops.compositing import masked_median_composite
        from .ops.rasterize import rasterize
        rng = np.random.RandomState(0)
        stack = rng.randint(0, 4096, (5, 16, 16, 3)).astype(np.uint16)
        valid = rng.rand(5, 16, 16) > 0.4
        got = [t.cpu() for t in masked_median_composite(stack, valid,
                                                        device="cuda")]
        ref = masked_median_composite(stack, valid, device="cpu")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError("masked_median differs from its plain "
                                 "version")
        # one feature burns dense, more than 64 binned
        for n_feats in (1, 80):
            feats = []
            for k in range(n_feats):
                x0, y0 = rng.uniform(0, 24, 2)
                ring = np.array([[x0, y0], [x0 + 9.5, y0 + 1.25],
                                 [x0 + 4.75, y0 + 8.5], [x0, y0]])
                feats.append(([ring], float(k % 9 + 1)))
            card = rasterize(feats, (32, 32), device="cuda")
            if not np.array_equal(card, rasterize(feats, (32, 32),
                                                  device="cpu")):
                raise AssertionError(f"burn of {n_feats} feature(s) differs "
                                     "from its plain version")
        counts = {c.name: c.count for c in kernels.COUNTERS}
        if not all(counts.values()):
            raise AssertionError(f"a kernel was not launched: {counts}")
        return "masked_median, burn_dense, burn_binned == plain versions"

    def _host_check():
        from .raster.lzw import lzw_decode_native, lzw_encode_native
        from .records.crc32c import crc32c, crc32c_native
        from .storage.zstd import compress_raw, decompress
        data = b"doctor" * 1000
        if lzw_decode_native(lzw_encode_native(data),
                             max_size=len(data)) != data:
            raise AssertionError("LZW round trip failed")
        if crc32c_native(data) != crc32c(data):
            raise AssertionError("CRC32C differs from the table version")
        if decompress(compress_raw(data), len(data)) != data:
            raise AssertionError("zstd round trip failed")
        return "g++ builds of LZW + CRC32C + zstd ok"

    def _codec_check():
        from .raster.geotiff import decode_geotiff, encode_geotiff
        from .raster.image import decode_png, encode_png
        a = (np.arange(96, dtype=np.uint16) % 7).reshape(4, 8, 3)
        if not (decode_geotiff(encode_geotiff(a)).array == a).all():
            raise AssertionError("GeoTIFF round trip failed")
        p = (a % 5).astype(np.uint8)
        if not (decode_png(encode_png(p)) == p).all():
            raise AssertionError("PNG round trip failed")
        return "GeoTIFF + PNG codecs roundtrip"

    def _records_check():
        from .records.example import encode_example_features
        from .records.proto import decode_example
        img = np.zeros((4, 4, 3), np.uint8)
        rec = encode_example_features(img, img[:, :, 0], 4, 4, 3, 4, 4, "k")
        if "identifier" not in decode_example(rec):
            raise AssertionError("Example has no identifier")
        return "Example codec bit path ok"

    check("cuda device", _card_check)
    check("nvcc", _nvcc_check)
    check("kernel build", _build_check)
    check("device kernels", _kernel_check)
    check("host builds", _host_check)
    check("raster codecs", _codec_check)
    check("record codec", _records_check)
    width = max(len(n) for n, _, _ in checks)
    ok_all = True
    for name, ok, detail in checks:
        status = "OK " if ok else "FAIL"
        ok_all &= ok
        print(f"{status} {name.ljust(width)}  {detail}")
    return 0 if ok_all else 1


def cmd_map(args) -> int:
    """Interactive HTML map of chip-tile footprints + labels (the
    reference's folium notebook maps, create nb cells 30-41)."""
    from .utils.webmap import write_html_map_for_folder
    out = write_html_map_for_folder(args.out, args.chips,
                                    labels=args.labels)
    print(f"wrote {out}")
    return 0


def _predict_from_records(args, trainer, write_geotiff, print) -> int:
    """predict --records: inference straight from TFRecord shards. Output
    rasters are named from each record's identifier (`:` -> `#`, like
    the chip writer) and georeferenced from tile-key or `name|gt|crs`
    identifiers (geo/georef.py); identifiers without georeferencing
    still produce a plain raster."""
    import numpy as np

    from . import storage
    from .geo.georef import georef_from_identifier
    from .pipeline.input import PARSE_FNS
    from .records.tfrecord import read_records
    from .serve import scale_image

    parse = PARSE_FNS[args.mode]
    files = storage.glob(args.records)
    if not files:
        print(f"no shards match {args.records!r}")
        return 1
    wrote = 0
    batch, idents = [], []
    seen: dict = {}

    def flush():
        nonlocal wrote
        if not batch:
            return
        n_real = len(batch)
        imgs = _pad_batch(scale_image(np.stack(batch), args.scale),
                          args.batch_size)
        if args.probs:
            out = trainer.predict_probs(imgs)[:n_real].astype(np.float32)
        else:
            out = trainer.predict(imgs)[:n_real].astype(np.uint8)
        for ident, arr in zip(idents, out):
            name = ident.decode("utf-8", errors="replace")
            gt, crs = georef_from_identifier(ident)
            epsg = None
            if crs and crs.upper().startswith("EPSG:"):
                epsg = int(crs.split(":")[1])
            stem = name.replace(":", "#").replace("|", "#")
            # duplicate identifiers get _2, _3, ... suffixes instead of
            # silently overwriting earlier predictions
            k = seen.get(stem, 0) + 1
            seen[stem] = k
            if k > 1:
                stem = f"{stem}_{k}"
            write_geotiff(storage.join(args.out, stem + ".tif"), arr,
                          geotransform=gt, epsg=epsg)
            wrote += 1
        batch.clear()
        idents.clear()

    for f in files:
        for rec in read_records(f, verify_crc=args.verify_crc):
            img, _, ident = parse(rec)
            batch.append(np.asarray(img))
            idents.append(ident)
            if len(batch) == args.batch_size:
                flush()
    flush()
    print(f"wrote {wrote} prediction chips to {args.out}")
    return 0


def cmd_serve(args) -> int:
    """Online inference endpoint: micro-batched, one batch shape
    (serve.py)."""
    import numpy as np

    from .serve import PredictServer, make_http_server

    trainer = _inference_trainer(args)
    cfg = trainer.config
    ps = PredictServer(trainer, max_wait_ms=args.max_wait_ms,
                       max_queue=args.max_queue)
    httpd = make_http_server(args.host, args.port, ps, scale=args.scale,
                             max_pixels=args.max_pixels)
    host, port = httpd.server_address[:2]
    try:
        # warm the one batch shape so the first request does not pay
        # cuDNN's plan setup and the conv slot test
        ps.submit(np.zeros((cfg.image_size, cfg.image_size,
                            cfg.in_channels), np.float32), probs=False,
                  timeout=600.0)
        print(f"serving {cfg.model} (step {int(trainer.state.step)}) on "
              f"http://{host}:{port}  "
              f"[POST /predict, /predict?probs=1, GET /healthz]",
              flush=True)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        ps.close()
    return 0


def cmd_inspect(args) -> int:
    from . import storage
    from .records.tfrecord import read_records

    files = storage.glob(args.records)
    total = 0
    first = None
    for f in files:
        for rec in read_records(f, verify_crc=args.verify_crc):
            if first is None:
                first = rec
            total += 1
    print(f"{len(files)} shards, {total} records")
    if first is not None:
        from .records.proto import decode_example
        d = decode_example(first)
        info = {k: (v.kind,
                    len(v.bytes_list[0]) if v.kind == "bytes"
                    else (v.int64_list if v.kind == "int64"
                          else len(v.float_list)))
                for k, v in sorted(d.items())}
        print(json.dumps({k: str(v) for k, v in info.items()}, indent=2))
        # georeferencing reconstruction from the identifier (the lookup
        # the reference promises but never ships,
        # _tfrecord_image_translation.py:70-74)
        from .geo.georef import georef_from_identifier
        try:
            ident = d["identifier"].bytes_list[0]
            gt, crs = georef_from_identifier(ident)
            name = ident.decode("utf-8", errors="replace")
            if gt is not None:
                print(f"identifier {name} -> geotransform "
                      f"{tuple(round(v, 6) for v in gt)} crs {crs}")
            else:
                print(f"identifier {name!r} (no georeferencing)")
        except (KeyError, IndexError, TypeError, AttributeError):
            pass  # foreign TFRecords without our schema
    if args.preview:
        # image | label side by side for the first records, as a PNG
        from .pipeline.input import PARSE_FNS
        from .raster.image import encode_png
        from .utils.preview import render_pair_sheet
        parse = PARSE_FNS[args.mode]
        pairs = []
        for f in files:
            for rec in read_records(f, verify_crc=args.verify_crc):
                out = parse(rec)
                pairs.append((out[0], out[1]))
                if len(pairs) >= args.preview_count:
                    break
            if len(pairs) >= args.preview_count:
                break
        bands = (tuple(int(b) for b in args.rgb_bands.split(","))
                 if args.rgb_bands else None)
        sheet = render_pair_sheet(pairs, rgb_bands=bands,
                                  nodata=args.nodata)
        storage.write_bytes(args.preview, encode_png(sheet))
        print(f"wrote {len(pairs)}-pair preview sheet to {args.preview} "
              f"({sheet.shape[0]}x{sheet.shape[1]})")
    if args.class_stats:
        # label-pixel histogram over the whole dataset + suggested
        # inverse-frequency --class-weights (normalized so the most
        # common class has weight 1); nodata excluded
        import numpy as np
        from .pipeline.input import PARSE_FNS
        parse = PARSE_FNS[args.mode]
        counts: dict = {}
        for f in files:
            for rec in read_records(f, verify_crc=args.verify_crc):
                target = parse(rec)[1]  # (img, target[, identifier])
                v, c = np.unique(np.asarray(target, np.int64),
                                 return_counts=True)
                for vi, ci in zip(v.tolist(), c.tolist()):
                    counts[vi] = counts.get(vi, 0) + ci
        valid = {k: v for k, v in counts.items() if k != args.nodata}
        tot = sum(valid.values())
        print(f"label pixels: {tot} valid"
              + (f", {counts.get(args.nodata, 0)} nodata"
                 if args.nodata in counts else ""))
        for k in sorted(valid):
            print(f"  class {k}: {valid[k]} ({valid[k] / tot:.2%})")
        if valid and min(valid.values()) > 0:
            ref = max(valid.values())
            weights = {k: ref / valid[k] for k in sorted(valid)}
            print("suggested --class-weights "
                  + ",".join(f"{weights[k]:.3g}" for k in sorted(valid)))
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the work runs: the CUDA card (default; "
                        "raises without one) or, only when asked, the "
                        "CPU")


def _model_args(p, batch_size: int) -> None:
    """The model flags that train, predict, serve and eval share."""
    p.add_argument("--classes", type=int, default=2)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--model", default="unet",
                   choices=["unet", "deeplab", "segformer"],
                   help="model family (must match the checkpoint)")


_S2D_HELP = ("space-to-depth block (unet only): every conv runs at 1/s2d "
             "the spatial size with pixels folded into channels. Default "
             "0 = AUTO: the equal-FLOPs s2d=2 packing at features<=48 and "
             "image>=128, the classic tree elsewhere; restore detects a "
             "checkpoint of another reachable variant and adapts. 1 forces "
             "classic; >1 is an explicit packing (features taken as-is)")


def _inference_args(p) -> None:
    """The flags predict, serve and eval share after the model's."""
    p.add_argument("--s2d", type=int, default=0, help=_S2D_HELP)
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8-static"],
                   help="inference compute (unet only): int8 = int8 convs "
                        "with dynamic per-example activation scales; "
                        "int8-static = calibrated constant scales "
                        "(auto-calibrates on the first batch, or pass "
                        "--calibrate-records). Float checkpoints serve "
                        "quantized as is")
    p.add_argument("--calibrate-records", default=None,
                   help="int8-static: shard glob to calibrate activation "
                        "scales on; without it, calibrate on the first "
                        "inference batch")
    p.add_argument("--calibrate-batches", type=int, default=8,
                   help="batches consumed from --calibrate-records")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="compute precision; match the checkpoint's "
                        "training run for identical numerics "
                        "(checkpoints are fp32 either way)")
    _device_arg(p)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dlseg-torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create-chips", help="AOI -> GeoTIFF chip pairs")
    c.add_argument("--labels", required=True)
    c.add_argument("--layer", default=0)
    c.add_argument("--attribute", default=None)
    c.add_argument("--product", required=True)
    c.add_argument("--bands", default="red green blue")
    c.add_argument("--tile-size", type=int, default=256)
    c.add_argument("--pad", type=int, default=2)
    c.add_argument("--resolution", type=float, default=10.0)
    c.add_argument("--out", required=True)
    c.add_argument("--tag", default="export")
    c.add_argument("--loc", default="aoi")
    c.add_argument("--year", default=str(_dt.date.today().year))
    c.add_argument("--ref-date", type=_date,
                   default=_dt.date.today().isoformat())
    c.add_argument("--min-date", type=_date, default=None)
    c.add_argument("--max-date", type=_date, default=None)
    c.add_argument("--max-cloud-fraction", type=float, default=None)
    c.add_argument("--nodata", type=int, default=255)
    c.add_argument("--catalog", required=True,
                   help="local catalog root (or a gs://, s3://, "
                        "http(s):// prefix), 'synthetic', an http(s):// "
                        "scene-server base URL, or a stac+http(s):// STAC "
                        "endpoint (static catalog.json tree or "
                        "item-search API)")
    c.add_argument("--processing-level", default="surface",
                   help="asset level of a remote catalog; local catalogs "
                        "store one level and ignore it")
    c.add_argument("--workers", type=int, default=8)
    c.add_argument("--batch-tiles", type=int, default=16,
                   help="composite+burn K tiles per kernel launch "
                        "(0 = per tile); the label chips of the two may "
                        "differ at polygon-boundary pixels, as in the JAX "
                        "package")
    c.add_argument("--low-priority", action="store_true",
                   help="renice the export so it doesn't starve the "
                        "machine (notebook cell 78 behavior)")
    c.add_argument("--max-attempts", type=int, default=20)
    _device_arg(c)
    c.set_defaults(fn=cmd_create_chips)

    t = sub.add_parser("to-tfrecords", help="chip folder -> TFRecords")
    t.add_argument("--name", required=True)
    t.add_argument("--directory", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--shards", type=int, default=12)
    t.add_argument("--workers", type=int, default=None)
    t.add_argument("--engine", choices=["mt", "mp"], default="mp",
                   help="mp: GeoTIFF chips (--file-ext); mt: PNG/JPEG "
                        "chips")
    t.add_argument("--file-ext", default="tif")
    t.add_argument("--store-as-array", action="store_true")
    t.add_argument("--png-to-jpg", action="store_true")
    t.add_argument("--no-dltile-names", action="store_true")
    t.add_argument("--resume", action="store_true",
                   help="skip shard files that already exist (atomic "
                        "writes make existence mean complete)")
    t.set_defaults(fn=cmd_to_tfrecords)

    cv = sub.add_parser(
        "convert", help="GeoTIFF chip folder -> PNG/JPG chip folder")
    cv.add_argument("--directory", required=True)
    cv.add_argument("--out", required=True)
    cv.add_argument("--file-ext", default="tif")
    cv.add_argument("--to", choices=["png", "jpg"], default="png")
    cv.add_argument("--workers", type=int, default=8)
    cv.add_argument("--quality", type=int, default=100)
    cv.add_argument("--rescale", type=float, nargs=2, default=None,
                    metavar=("LO", "HI"))
    cv.add_argument("--rescale-labels", action="store_true")
    cv.set_defaults(fn=cmd_convert)

    tr = sub.add_parser("train", help="TFRecords -> U-Net training")
    tr.add_argument("--records", required=True, help="shard glob")
    tr.add_argument("--mode", default="rgbraw",
                    choices=["rgbraw", "rgbarr", "tifraw", "tifarr"],
                    help="record storage mode: rgbraw (PNG/JPEG bytes, "
                         "to-tfrecords --engine mt), rgbarr (uint8 arrays, "
                         "--store-as-array of PNG/JPEG chips), tifraw "
                         "(GeoTIFF bytes), tifarr (float arrays, "
                         "--store-as-array of GeoTIFF chips)")
    tr.add_argument("--model", default="unet",
                    choices=["unet", "deeplab", "segformer"],
                    help="model family")
    tr.add_argument("--classes", type=int, default=2)
    tr.add_argument("--channels", type=int, default=3)
    tr.add_argument("--features", type=int, default=32)
    tr.add_argument("--levels", type=int, default=4)
    tr.add_argument("--image-size", type=int, default=256)
    tr.add_argument("--batch-size", type=int, default=32)
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--weight-decay", type=float, default=1e-4)
    tr.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="learning-rate schedule; cosine decays over "
                         "--steps with a linear --warmup-steps ramp")
    tr.add_argument("--warmup-steps", type=int, default=0)
    tr.add_argument("--grad-clip-norm", type=float, default=0.0,
                    help="global-norm gradient clipping (0 = off)")
    tr.add_argument("--class-weights", default=None,
                    help="comma-separated per-class loss weights for "
                         "imbalanced data, e.g. '1,5' (one per class)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--steps", type=int, default=100)
    tr.add_argument("--nodata", type=int, default=255)
    tr.add_argument("--n-model", type=int, default=1,
                    help="model-axis size of the mesh over the world's "
                         "ranks (channel tensor parallelism; the world "
                         "must hold a multiple of it)")
    tr.add_argument("--spatial", action="store_true",
                    help="shard the image height over the model axis "
                         "(halo-exchanging convs) instead of conv "
                         "channels; the U-Net")
    tr.add_argument("--fsdp", action="store_true",
                    help="store large conv kernels and their Adam moments "
                         "sharded over the data axis (gathered before "
                         "use, gradients reduce-scattered; ~n_data-fold "
                         "less parameter and optimizer memory a rank)")
    tr.add_argument("--s2d", type=int, default=0, help=_S2D_HELP)
    tr.add_argument("--remat", action="store_true",
                    help="rematerialise activations in the backward "
                         "pass (more FLOPs, much less HBM)")
    tr.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32"],
                    help="compute precision: bf16 convs with fp32 params "
                         "and optimizer (default), or fp32 everywhere with "
                         "TF32 off; checkpoints are interchangeable")
    tr.add_argument("--scan-steps", type=int, default=0,
                    help="steps per dispatch from a device-resident pool "
                         "(0 = classic per-step feed)")
    tr.add_argument("--pool-size", type=int, default=1024)
    tr.add_argument("--shuffle-buffer", type=int, default=256)
    tr.add_argument("--workers", type=int, default=4)
    tr.add_argument("--log-every", type=int, default=10)
    tr.add_argument("--checkpoint", default=None,
                    help="checkpoint path; with --save-every this is a "
                         "managed rotating-checkpoint DIRECTORY")
    tr.add_argument("--save-every", type=int, default=0,
                    help="save a managed rotating checkpoint every N "
                         "steps into --checkpoint and auto-resume the "
                         "latest one on restart (--steps is the run's "
                         "total budget); 0 = single save at the end")
    tr.add_argument("--keep", type=int, default=3,
                    help="managed checkpoints kept (with --save-every)")
    tr.add_argument("--restore", default=None,
                    help="fine-tune from a single saved checkpoint "
                         "(always runs the full --steps; the step "
                         "counter continues from the checkpoint): a .pt "
                         "file or an orbax checkpoint directory of the JAX "
                         "package")
    tr.add_argument("--eval-records", default=None,
                    help="validation TFRecord glob: evaluated every "
                         "--eval-every steps (per-step mode) or at "
                         "dispatch-chunk boundaries (--scan-steps mode), "
                         "plus once after training")
    tr.add_argument("--eval-every", type=int, default=0,
                    help="validation cadence in steps (per-step mode; "
                         "0 = only the final eval)")
    tr.add_argument("--eval-max-batches", type=int, default=None,
                    help="cap validation batches per eval pass")
    tr.add_argument("--metrics-log", default=None,
                    help="append one JSON line per logged step ({step, "
                         "loss, accuracy, examples_per_sec, duty_cycle}) "
                         "to this file; resumes append to the same file")
    tr.add_argument("--verify-crc", action="store_true",
                    help="validate TFRecord frame CRCs while feeding")
    tr.add_argument("--augment", action="store_true",
                    help="on-device random dihedral augmentation (flips "
                         "and 90-degree rotations of image and label)")
    tr.add_argument("--augment-invert", type=float, default=0.0,
                    metavar="P",
                    help="probability of per-example intensity inversion "
                         "(image only; assumes a [0,1]-normalized, "
                         "integer-dtype feed)")
    tr.add_argument("--augment-brightness", type=float, default=0.0,
                    metavar="B",
                    help="per-example additive brightness jitter "
                         "~ U(-B, +B) on the [0,1] scale, clipped")
    tr.add_argument("--augment-contrast", type=float, default=0.0,
                    metavar="C",
                    help="per-example contrast jitter around the "
                         "per-channel mean, factor ~ U(1-C, 1+C)")
    _device_arg(tr)
    tr.set_defaults(fn=cmd_train)

    pr = sub.add_parser("predict", help="chips -> prediction GeoTIFFs")
    pr.add_argument("--images", default=None,
                    help="folder of .tif chips (an /images folder)")
    pr.add_argument("--records", default=None,
                    help="predict straight from TFRecord shards (glob); "
                         "outputs are named and georeferenced from each "
                         "record's identifier")
    pr.add_argument("--geotiff", default=None,
                    help="sliding-window inference over ONE large "
                         "georeferenced raster: windows of --image-size "
                         "step by --stride, overlaps blend by averaging "
                         "softmax probabilities, and --out is the single "
                         "output GeoTIFF path")
    pr.add_argument("--stride", type=int, default=None,
                    help="--geotiff window step in pixels (default: "
                         "image size)")
    pr.add_argument("--mode", default="tifarr",
                    choices=["rgbraw", "rgbarr", "tifraw",
                             "tifraw_eager", "tifarr"],
                    help="storage mode for --records parsing")
    pr.add_argument("--verify-crc", action="store_true",
                    help="validate TFRecord frame CRCs (--records)")
    pr.add_argument("--checkpoint", required=True)
    pr.add_argument("--out", required=True)
    _model_args(pr, batch_size=8)
    _inference_args(pr)
    pr.add_argument("--probs", action="store_true",
                    help="write per-class softmax probabilities as "
                         "float32 multi-band GeoTIFFs (band k = P(class "
                         "k)) instead of uint8 argmax maps")
    pr.add_argument("--scale", default="auto",
                    help="input scaling, matching how the checkpoint was "
                         "TRAINED: 'auto' = by chip dtype (uint8/255, "
                         "uint16/65535), 'none' = raw values (matches "
                         "tifraw and tifarr training), or a float "
                         "multiplier")
    pr.set_defaults(fn=cmd_predict)

    sv = sub.add_parser("serve", help="online inference HTTP endpoint")
    sv.add_argument("--checkpoint", required=True)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8531)
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batch window: the first queued request waits at "
                         "most this long for others to share its dispatch")
    sv.add_argument("--max-queue", type=int, default=0,
                    help="admission bound: requests beyond this many "
                         "queued are answered 503 (0 = 8 batches' worth)")
    sv.add_argument("--max-pixels", type=int, default=16_000_000,
                    help="largest whole-raster request (H*W) the "
                         "sliding-window path accepts; bigger bodies are "
                         "answered 413")
    _model_args(sv, batch_size=8)
    _inference_args(sv)
    sv.add_argument("--scale", default="auto",
                    help="scaling applied to ENCODED request bodies "
                         "(GeoTIFF, PNG, JPEG, GIF, BMP), same rules as "
                         "predict --scale; .npy bodies are taken as-is")
    sv.set_defaults(fn=cmd_serve)

    ev = sub.add_parser("eval", help="evaluate a checkpoint on shards")
    ev.add_argument("--records", required=True)
    ev.add_argument("--checkpoint", required=True)
    ev.add_argument("--mode", default="tifarr",
                    choices=["rgbraw", "rgbarr", "tifraw", "tifarr"])
    _model_args(ev, batch_size=8)
    ev.add_argument("--nodata", type=int, default=255)
    ev.add_argument("--workers", type=int, default=2)
    ev.add_argument("--max-batches", type=int, default=None)
    ev.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON line instead of "
                         "the human summary")
    ev.add_argument("--verify-crc", action="store_true",
                    help="validate TFRecord frame CRCs while feeding")
    _inference_args(ev)
    ev.set_defaults(fn=cmd_eval)

    stp = sub.add_parser("stitch", help="chips -> one GeoTIFF mosaic")
    stp.add_argument("--chips", required=True,
                     help="folder of tile-key-named .tif chips")
    stp.add_argument("--out", required=True)
    stp.add_argument("--fill", type=float, default=0)
    stp.set_defaults(fn=cmd_stitch)

    ing = sub.add_parser(
        "ingest-safe", help="Sentinel-2 .SAFE tree -> catalog scenes")
    ing.add_argument("--catalog", required=True,
                     help="LocalCatalog root (created if missing)")
    ing.add_argument("--safe", required=True, nargs="+",
                     help="one or more .SAFE product directories")
    ing.add_argument("--product", default="sentinel-2:L1C")
    ing.add_argument("--cloud-fraction", type=float, default=None,
                     help="recorded per-scene cloud fraction (ESA "
                          "metadata is not parsed; pass the value "
                          "when known)")
    ing.set_defaults(fn=cmd_ingest_safe)

    pu = sub.add_parser("push", help="shards -> records sink (dir or "
                                     "signed-URL manifest)")
    pu.add_argument("--records", required=True, help="shard glob")
    pu.add_argument("--dest", required=True,
                    help="destination dir (local, gs:// or s3://), or "
                         ".json of {shard: signed URL}")
    pu.add_argument("--no-resume", action="store_true",
                    help="re-push shards the sink already has")
    pu.set_defaults(fn=cmd_push)

    doc = sub.add_parser("doctor", help="environment self-check")
    doc.set_defaults(fn=cmd_doctor)

    m = sub.add_parser("map", help="chips -> interactive HTML map")
    m.add_argument("--chips", required=True,
                   help="folder of tile-key-named chips (e.g. .../images)")
    m.add_argument("--labels", default=None,
                   help="optional vector label dataset to overlay")
    m.add_argument("--out", default="map.html")
    m.set_defaults(fn=cmd_map)

    i = sub.add_parser("inspect", help="summarize TFRecord shards")
    i.add_argument("--records", required=True)
    i.add_argument("--verify-crc", action="store_true")
    i.add_argument("--class-stats", action="store_true",
                   help="scan every record's label raster and print "
                        "per-class pixel counts plus a suggested "
                        "inverse-frequency --class-weights string")
    i.add_argument("--mode", default="tifarr",
                   choices=["rgbraw", "rgbarr", "tifraw",
                            "tifraw_eager", "tifarr"],
                   help="storage mode for --class-stats parsing")
    i.add_argument("--nodata", type=int, default=255,
                   help="label value excluded from --class-stats")
    i.add_argument("--preview", default=None,
                   help="write a PNG contact sheet (image | label) of the "
                        "first --preview-count records, parsed with "
                        "--mode")
    i.add_argument("--preview-count", type=int, default=4)
    i.add_argument("--rgb-bands", default=None)
    i.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
