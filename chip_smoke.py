"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name, count, and nvidia-smi's name and power limit;
2. build: every CUDA kernel of the chip-creation path, one nvcc per
   source started together, with ptxas' registers, shared memory and
   spills;
3. kernel vs plain: each kernel on the card at the path's shapes,
   launched bare (its wrapper's launch helper, every input prepared
   once) and through its wrapper, each bitwise equal (torch.equal) to
   its plain PyTorch version on the same inputs. CUDA-event times: the
   kernel alone (``ms``, a CUDA graph of bare launches; the median's
   launches rotate over input copies that together exceed the 50 MB L2),
   the wrapper as the main path calls it (``wrapper_ms``), the plain
   version, and for the median the library's yardstick
   (``library_ms``: torch.nanquantile, midpoint, on NaN-masked samples,
   also bitwise equal; the port never calls it); and the least time the
   card could take (bytes over 3.35 TB/s or fp32 operations over
   67 TFLOP/s, whichever is larger);
4. end to end: DLSampleCreationConfig -> create_tile_job_configs ->
   run_export over a seeded 32-tile AOI with ~1,024 label polygons, per
   tile and batched (16 tiles per launch), each on the card and on the
   CPU with the plain versions; the card's GeoTIFF bytes must equal the
   CPU's on each path, and the image chips must be equal across all
   four runs. Once for the Sentinel-2 cloud-masked median (260 px, 13
   bands) and once for the nearest-date mosaic (RGB at 1.0 m). The CPU
   runs (``cpu_exports``) go in a thread beside phase 2's build, which
   leaves most of the host's cores idle, and end before phase 3. The
   launch counters are set to 0 just before the card's runs and read
   just after: every kernel must have been launched there;
5. serving: the U-Net at full width (TrainConfig defaults with batch 8:
   256 px RGB, 2 classes, base_features 32, 4 levels, s2d AUTO, which
   is s2d 2 at width 64; and the classic s2d 1 tree), seeded init, at
   bf16 and at fp32 (TF32 off). Each: predict_probs on 8 images on the
   card against a CPU copy of the same state dict on the first 2
   (fp32 logits within 1e-4 + 1e-4 relative; bf16 probabilities within
   5e-2; class maps equal where the top two are apart), the warm
   forward's CUDA-event time per batch of 8, images/s, the convs'
   FLOPs and their share of the card's peak (989 TFLOP/s bf16, 67
   TFLOP/s fp32), max memory allocated, and torch.profiler's top 5
   device ops and device-busy share over 5 forwards, and the forward's
   time with cuDNN's benchmark mode on and how far apart its logits are
   in two threads (the Trainer runs with it off: PyTorch keeps its
   algorithm choice per thread). Then a
   PredictServer on the card answers 24 concurrent chips (class maps
   == Trainer.predict), one 1000 x 1150 raster through
   predict_windowed_batched at stride 128 (== the offline
   predict_windowed), and one HTTP round trip each of /healthz,
   /predict (.npy and GeoTIFF) and /metrics; any errored request fails
   the run. The same rows (card vs CPU, forward ms, FLOPs share,
   memory, profiler, benchmark mode) for DeepLab-lite (base 32, ASPP
   128) and SegFormer-lite (dims 32/64/160/256, decoder 256) at bf16 and
   fp32, and for the int8 U-Net (int8 and calibrated int8-static, both
   trees, bf16) beside the float bf16 forward, with the int8 model
   against its float twin on the same parameters and the tree's first
   int8 conv on the card against the CPU (int32 sums bitwise equal);
   24 concurrent requests to SegFormer-lite and to each int8 U-Net must
   give predict's class maps, and predict(chips[:7])'s. These paths have
   no hand-written kernel: convs, norms, matmuls and attention are
   cuDNN/cuBLAS calls, the int8 convs torch._int_mm;
6. training, cmd_train's sequence at full width (TrainConfig defaults
   with num_classes=10: 256 px RGB, base_features 32, 4 levels, s2d
   AUTO = s2d 2 at width 64, batch 32, lr 1e-3, wd 1e-4, bf16): a
   32-tile RGB nearest-date export of 256 px chips on the card ->
   process_dataset_mp into 4 tifarr shards (every record read back with
   its CRCs checked) -> TFRecordFeed(scale="raw") -> DevicePrefetcher ->
   20 train_steps at the defaults and 20 with a cosine schedule, 5
   warmup steps and clipping at 1.0 (the mean loss of the last 5 steps
   must be below the first step's) -> DeviceDataPool.from_feed ->
   train_scanned (20 steps, 10 a dispatch, augmented, the pool
   refreshed from a live feed of 16-example batches while each dispatch
   runs; finite losses, and the pool must then hold the two refresh
   batches) ->
   evaluate on one pass over the shards -> save_checkpoint ->
   restore_checkpoint into a fresh Trainer, whose predict on 8 chips
   must equal the trained trainer's bitwise and whose PredictServer
   must answer the same class maps. Then 3 fp32 steps on 2 images from
   one state dict, twice on the card and once on the CPU (losses
   within 1e-4 relative; the largest parameter difference is printed;
   the two card runs must agree bitwise: the step takes cuDNN's
   deterministic algorithms), and at batch 32, bf16
   and fp32: the train step's CUDA-event time, images/s, share of the
   card's peak (3 x the forward's conv FLOPs), max memory allocated,
   and torch.profiler's top 5 device ops and device-busy share over 5
   steps; train_scanned's examples/s and duty cycles; the feed's
   records/s. Then DeepLab-lite and SegFormer-lite at the same config:
   20 steps from the feed (falling loss), 3 fp32 steps card against CPU
   and card against card (bitwise), and the step numbers at bf16 and
   fp32;
7. LocalCatalog + CLI, through ``cli.main`` in-process: a LocalCatalog
   root written with ``LocalCatalog.create`` + ``add_scene`` (10 seeded
   Sentinel-2 scenes of 13 uint16 bands with nodata over phase 4's
   AOI: one 10 m scene of >= 32 MiB, read windowed through the COG
   reader; two in zone 42 at 20 m, warped across zones; seven 10 m
   quarters, decoded whole into the scene LRU) -> ``create-chips
   --max-cloud-fraction 0`` at ``--batch-tiles`` 16 and 0, on the card
   and with ``--device cpu`` (card bytes == CPU bytes, 64 GeoTIFFs a
   run, K1-K3 launched, both read paths and a zone-42 scene taken,
   tiles/s of each; the CPU runs on a thread beside the card's exports
   and the verify sequence, ``CliBeside``) -> the verify sequence at
   full width on a nearest-date RGB export of 256 px chips from the
   same root:
   ``to-tfrecords --store-as-array``, ``inspect --verify-crc
   --class-stats``, ``train --mode tifarr`` at the TrainConfig defaults
   with 10 classes for 20 steps with ``--save-every 10`` (the loss must
   fall; orbax steps ``10`` and ``20`` stay, the port's reader gives back
   the restored trainer's ``orbax_tree()`` bitwise, and what follows
   reads step 20), again with ``--scan-steps 10``, ``eval --json``, ``stitch``,
   ``predict --geotiff`` and ``serve`` in a subprocess on port 0 (one
   /healthz, one /predict equal to ``predict``'s map, then SIGINT);
   then ``train --model segformer`` (20 steps, falling loss), ``predict
   --quantize int8-static --calibrate-records`` and ``eval --quantize
   int8``. Every command must exit 0; the seconds of each are printed;
8. remote storage and catalogs, through the port's loopback fakes
   (``FakeGCS``, ``FakeS3``, ``SceneServer``, ``StacServer``; NO_PROXY
   names loopback) and ``cli.main``, on phase 7's root and outputs:
   ``create-chips --catalog http://... --batch-tiles 16 --out gs://...``
   with the server's first 3 answers failing (retried), all 64
   GeoTIFFs equal to phase 7's card export, tiles/s and the ranged GETs
   and bytes a tile; the RGB export the same way, equal to phase 7's; a
   STAC tree of the same scenes (``stac_tree_from_root``) served in API
   mode, exported per tile on the card (equal to phase 7's per-tile card
   export, which phase 7 holds to the CPU's); the launch counters set to 0
   before the card's exports and read after (every kernel launched);
   ``to-tfrecords`` gs:// -> s3:// (shards equal to phase 7's),
   ``inspect --verify-crc`` on s3://, the feed's records/s from s3://
   beside local's, ``train`` from s3:// with ``--checkpoint gs://...
   --save-every 10 --keep 1`` (falling loss; only the newest orbax step,
   ``20/``, stays in the bucket), ``predict`` and ``eval --json`` from the gs://
   checkpoint equal to a local copy's, ``stitch`` gs:// -> gs:// equal to
   phase 7's mosaic, and ``push`` from s3:// to a directory and to
   presigned URLs on a loopback PUT server (every shard's bytes);
9. the PNG/JPEG chip path, through ``cli.main`` on phase 7's RGB chip
   folder (32 pairs of 256 px chips): ``convert --to png --rescale LO
   HI`` (LO, HI: the chips' range; each PNG decodes to the rescaled
   GeoTIFF, labels unchanged), ``to-tfrecords --engine mt`` into rgbraw
   (payloads == the files, CRCs checked), rgbarr (``--store-as-array``)
   and ``--png-to-jpg`` shards (each JPEG payload is the port's encode of
   its PNG's pixels), ``train`` with no ``--mode`` (rgbraw) and with
   ``--mode rgbarr`` at the TrainConfig defaults with 10 classes, 20 steps
   on one parse thread each (falling loss, equal losses, bitwise equal
   parameters), 3 fp32 steps card against CPU on a rgbraw batch (within
   1e-4), ``train`` from the JPEG shards with 256 classes (JPEG moves
   label values at class edges; falling loss), a PredictServer over HTTP
   answering 8 PNG chips and the port's JPEG encodes of them (class maps
   == predict of the port's decode; a corrupt PNG gets 400), and
   ``inspect --preview`` (the sheet == render_pair_sheet of the first 4
   records). Times, on the host: PNG decode MB/s and MP/s, JPEG decode
   and encode MP/s at 256 px RGB, convert and MT to-tfrecords seconds,
   the rgbraw, rgbarr and tifarr feeds' records/s; on the card: a train
   step fed from rgbraw and from rgbarr shards (ms, images/s). No
   hand-written kernel is on this path;
10. JPEG 2000 and Sentinel-2 ``.SAFE`` ingestion, through ``cli.main``:
   a reduced SAFE tree written by the port's ``encode_jp2`` (2 granules
   on 2 dates over phase 4's AOI in zone 43, 13 bands of 12-bit uint16
   at 10/20/60 m, one granule with GeoJP2 boxes and one with GMLJP2, a
   TCI preview that must not be ingested) -> ``ingest-safe`` ->
   ``create-chips --max-cloud-fraction 0`` at ``--batch-tiles`` 16 and
   0, on the card and with ``--device cpu`` (card bytes == CPU bytes,
   64 GeoTIFFs a run, K1-K3 launched on the card; the CPU runs on a
   thread beside the card's exports and the JP2 chip path; every band
   file decodes to the array encoded); phase 9's PNG chips re-encoded as JP2
   pairs -> ``to-tfrecords --file-ext jp2`` raw (tifraw) and
   ``--store-as-array`` (uint8: the rgbarr layout), CRCs checked, and
   tifarr (FloatList) shards of the same pixels -> ``train --mode
   tifraw`` and ``--mode tifarr`` (5 steps, one parse thread; falling
   loss, equal losses, bitwise equal parameters) -> a PredictServer
   answering 8 JP2 bodies (== predict of the port's decode; a corrupt
   JP2 gets 400). Times with the card's name and power limit: JP2
   decode and encode MP/s on one host thread for a 10 m band and a 256²
   RGB chip, ingest-safe seconds, the tifraw feed's records/s and a fed
   step. The codec is host C++ (``csrc/host/j2k_decode.cc``,
   ``j2k_encode.cc``); the card runs K1-K3 in the export and the model;
11. the JAX package's orbax checkpoints and remat (``orbax_phase``, after
   phase 7): (a) the committed checkpoint that the JAX Trainer wrote
   (``tests/data/orbax_unet``: a U-Net of base 4, 2 levels, clip and a
   cosine schedule, after 2 steps) read by ``train/orbax.py`` on this
   host: every leaf bitwise equal to its ``.npz``, the zstd decoder's
   MB/s on its frames, and ``predict`` on the card equal to the JAX
   class maps where the top two logits are more than 1e-4 apart; (b) the
   U-Net at the TrainConfig defaults with batch 8 (as phase 5): 3 bf16
   steps on the card, ``write_checkpoint(..., managed=True)`` of
   ``orbax_tree()``, ``restore_latest`` into a fresh Trainer: params,
   mu, nu, count and step bitwise equal, ``predict`` on 8 chips equal,
   one further step from each with equal losses and parameters; the
   tree's bytes and the reader's seconds and MB/s; (c) one bf16 step with
   ``remat=True`` and one without from the same state and batch: losses
   and every gradient bitwise equal; each step's CUDA-event ms and
   ``max_memory_allocated``; (d) ``train --remat --steps 2`` on phase
   7's shards and ``predict --checkpoint`` of (b)'s orbax step (its maps
   == Trainer.predict of the restored tree); (e) ``random_rotate_pairs``
   on a batch of 8 chips on the card against ``rotate_pairs`` on the CPU
   with the same angles: labels and images bitwise equal. No
   hand-written kernel is on this path;
12. the scientific raster containers and the library API
   (``containers_phase``, after phase 7): a LocalCatalog root whose 4
   scenes' 13 bands are per-band files in rotating containers (VRT over
   absolute GeoTIFF sources, NetCDF classic with a CF UTM grid mapping,
   GeoPackage, NITF; every file decodes to its array), over 8 tiles of
   phase 7's AOI and polygons -> ``create-chips --max-cloud-fraction
   0`` at ``--batch-tiles`` 0 and 16 on the card (K1, K2 and K3
   launched) and the CPU, and from a GeoTIFF root of the same arrays on
   the card: chips bitwise equal per mode; phase 7's RGB chips as
   NetCDF pairs -> ``to-tfrecords --file-ext nc`` -> ``train --mode
   tifraw`` (falling loss), and as ENVI pairs -> ``--file-ext hdr
   --store-as-array`` (records == the chips); NetCDF, GRIB, HDF4, NITF
   and GeoPackage bodies to a PredictServer (== predict of the port's
   decode; a VRT body naming a file answers 400 unread); each
   container's decode MP/s and sniff us on one host thread;
   ``convert_to_example`` of the card's chips == the MP engine's
   records, the web map's and ``tiles_to_layer``'s footprints == the
   chips' geotransforms, and ``duty_cycle`` of the bf16 U-Net step
   beside the Trainer's own duty.
   The containers are host code; the card runs K1-K3 and the model.
13. HDF5 / NetCDF-4 through the port's own reader (``hdf5_phase``, after
   phase 12): a LocalCatalog root of 4 scenes x 13 bands over phase 12's
   8 tiles, every band an HDF5 file from ``hdf5_utm`` (superblock 0,
   version 1 object headers; chunked deflate+shuffle under a v1 B-tree
   with CF sibling coordinates, and contiguous with NetCDF-4 dimension
   scales, alternating by band) -> ``create-chips`` at ``--batch-tiles``
   0 and 16 on the card (K1, K2 and K3 launched) and the CPU, and from a
   GeoTIFF root of the same arrays: chips bitwise equal per mode; phase
   7's RGB chips as HDF5 pairs -> ``to-tfrecords --file-ext h5`` ->
   ``train --mode tifraw`` (10 steps, falling loss); HDF5 and NetCDF-4
   bodies served == predict of the port's decode, an external-storage
   body and a truncated body answer 400; the committed fixtures of
   ``tests/data/hdf5`` (written by h5py: the layout-v4 chunk indexes,
   dense links and attributes, LZF, szip, n-bit, scale-offset) == their
   ``.npz``; decode MP/s and sniff us of a band in each layout.
14. training across a ``torch.distributed`` world (``parallel_phase``,
   after phase 7, on its tifarr shards): (a) a NCCL world of one joined
   by ``initialize()`` from ``COORDINATOR_ADDRESS``,
   ``DLSEG_NUM_PROCESSES=1`` and ``DLSEG_PROCESS_ID=0``; at the
   TrainConfig defaults with 10 classes (bf16, batch 32) 5 steps with
   ``mesh=None`` and 5 with ``fsdp=True`` are bitwise the plain
   trainer's (losses and parameters), beside its CUDA-event step ms;
   (b) a gloo world of 4 ranks on the one card (``dryrun_multichip(4,
   "cuda:0")``; NCCL refuses a card two ranks share): DP 4x1, TP 2x2,
   spatial 2x2, FSDP 4x1 and FSDP+TP 2x2 of the U-Net, spatial 2x2 of
   DeepLab-lite and SegFormer-lite, and the spatial U-Net at 272 px
   (bands of 136 rows, not a multiple of s2d * 2**levels), at the same
   width in fp32 with clipping at 1.0, 3 steps on one global batch of 8
   each, held against the one-process trainer of the same config here:
   losses within 1e-4 relative, the first step's clipped gradients leaf
   by leaf and its global norm (``NORM_RTOL``, ``GRAD_RTOL``,
   ``GRAD_ATOL``), parameters within 2 x 3 x lr after the steps, and a
   witness (one process through torch's own CUDA convs, cuDNN off)
   inside the same bars; each world's checkpoint restored here bitwise,
   class maps equal to this process's from the restored parameters
   where the top two probabilities are more than 1e-4 apart (and the
   share that differs from its own steps' maps printed beside the
   witness's); int8 inference under TP 2x2 and calibrated int8-static
   on bands against one process's int8 (5e-2 of the largest logit,
   99.5% of the class maps); per rank the bytes of parameters and Adam
   moments (FSDP's below DP's), a step's peak memory above its state
   beside one process's at batch 8, step ms, the leaves TP and FSDP
   shard, and the rows the DP world's feed decodes of phase 7's shards
   (2 of every 8 a rank); after the steps of DP 4x1 and TP 2x2, and on
   int8 TP 2x2, the world serves (``world_server_rows``): the primary's
   ``PredictServer`` behind ``make_http_server`` on loopback answers a
   full batch, a partial batch, probability requests and a uint8 and a
   uint16 chip while the other ranks follow, bitwise the world's own
   predict, with requests/s and
   p50 of 4 more full batches. No hand-written kernel is on this path.

15. the JPEG, BMP and JPEG 2000 variants (``codec_variants_phase``,
   after phase 9), on the committed fixtures of ``tests/data/{jpeg,bmp,
   jp2}`` (128 px RGB chips and small edge cases): (a) each decodes on
   the card's host bitwise to its ``.npz`` (the JAX package's decode,
   written where PIL is), or raises its class and message prefix; the
   block-smoothed progressive file is refused naming ROADMAP item 6;
   (b) the six decodable RGB chips (progressive, arithmetic sequential
   and progressive, lossless JPEG, RLE8 BMP, sYCC 4:2:0 JP2; the MT
   engine lists .png/.jpg names and sniffs the container) with PNG
   labels go through ``cli.main``: ``to-tfrecords --engine mt`` (rgbraw
   payloads == the files, CRCs checked), the first rgbraw batch == the
   ``.npz`` pixels, ``train`` from those shards at the TrainConfig
   defaults with 4 classes and 128 px, 5 bf16 steps (finite, falling
   loss); (c) a PredictServer on the card answers each variant as an
   HTTP body with the class map of ``predict`` of its ``.npz`` pixels,
   which is also its answer to a PNG body of those pixels, and a CMYK
   JPEG body gets the JAX server's 400; (d) decode MP/s on one host
   thread of each 128 px variant beside the baseline JPEG decode of the
   same pixels (the port's quality-90 encode), the RLE8 chip also beside
   an uncompressed 8-bit BMP of its indices, and a train step fed from
   the variant shards (batch 32, bf16, ms). K1-K3 launch 0 times.

16. the formats PIL opens through ``decode_png`` / ``decode_jpeg``
   (``pil_formats_phase``, after phase 15), on the committed fixtures of
   ``tests/data/pil``: (a) each decodes on the card's host through both
   functions bitwise to its ``.npz`` (the JAX package's ``decode_jpeg``:
   array, dtype and byte order), or raises its class and message prefix
   (WebP, TIFF, PPM, TGA, SGI, PCX, QOI, ICO/CUR, IM, XBM, DDS and one
   refusal of each failure class); (b) the eight 128 px RGB chips (WebP
   lossless and lossy, TIFF LZW and JPEG, PPM, TGA RLE, PCX, QOI) named
   ``.jpg`` and ``.png`` with PNG labels through ``cli.main``:
   ``to-tfrecords --engine mt --store-as-array`` (CRCs checked, each
   record's pixels == the ``.npz``), ``train --mode rgbarr`` from those
   shards at the TrainConfig defaults with 4 classes and 128 px, 5 bf16
   steps (finite, falling loss); (c) decode MP/s on one host thread of
   each 128 px chip through ``decode_jpeg`` beside the baseline JPEG of
   the same pixels (the port's quality-90 encode). K1-K3 launch 0 times.

The second-to-last line is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Without a CUDA card the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM data sheet (700 W): device-memory rate and fp32 rate outside
# the tensor cores
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores
INT8_OPS_PER_S = 1979e12  # dense, tensor cores
L2_BYTES = 50 * 2**20
# (S, H, W, B, wrapper reps) of the median cases: one 260 px tile of 13
# bands, the batched stack of 16 tiles, and a year of Sentinel-2 scenes
MEDIAN_CASES = [(10, 260, 260, 13, 20), (10, 4160, 260, 13, 5),
                (73, 260, 260, 13, 5)]
# fp32 operations a burn needs with ALL_TOUCHED, counted on what the
# inputs need rather than on what a kernel evaluates:
# * per (row, edge) pair whose y-span dilated 0.5 px meets the row
#   (inside the canvas and the feature's window): the y half of the box
#   test (2 compares), straddle (2 compares, 1 xor), cy - y0, the
#   division, the fused multiply-add (2), ny * (cy - y0), and the two
#   compares that place the crossing and the box in x -- 12;
# * per (pixel, edge) pair whose centre lies in the edge's bbox dilated
#   0.5 px: the x half of the box test (2 offsets, 2 compares), cx - x0,
#   the fused multiply-add (2), absolute value, compare with reach, and,
#   or into touch, and the parity compare, and, xor -- 14;
# * one per pixel: crossings of a row left of the box need no per-pixel
#   work beyond a running xor along the row.
BURN_ROW_EDGE_OPS = 12
BURN_PIXEL_EDGE_OPS = 14
# the full predicate on every (pixel, edge) pair of each feature's dilated
# bbox: parity 9 (2 compares, 3 subtractions, select, division, fused
# multiply-add as 2, compare) + touch 18 (4 min/max, 4 offsets, 4
# compares, 2 subtractions, multiply, fused multiply-add as 2, 3 absolute
# values, add, multiply, compare) -- rounded down to 27; kept as a second
# figure, comparable with earlier rows of PERF.md
BURN_OPS_PER_EDGE = 27
# phase 14's gradient bars, first step, fp32: the global norm before the
# clip within NORM_RTOL relative of the one process's; each leaf's
# difference within GRAD_RTOL of the leaf's norm plus GRAD_ATOL of the
# whole gradient's. The backward of a GroupNorm subtracts the group's
# mean, so what is left of a gradient can be small against its rounding:
# one process through another conv implementation (the witness) must
# stay inside these bars too. A gradient counted twice is off by 1 of its
# norm, a shard counted twice in the clip's norm by tens of percent
NORM_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-2, 1e-6
S2_BANDS = ["coastal-aerosol", "blue", "green", "red", "red-edge",
            "red-edge-2", "red-edge-3", "nir", "red-edge-4", "water-vapor",
            "cirrus", "swir1", "swir2"]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(launch, n=20, reps=10):
    """Mean milliseconds of one ``launch`` on the card alone: CUDA events
    around ``reps`` replays of a CUDA graph of ``n`` launches, so that no
    host work sits between them."""
    import torch
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def spills(build_log):
    """(kernels compiled, lines of those that spill or keep a stack
    frame) from a build log of ``-Xptxas -v``."""
    lines = [ln.strip() for ln in build_log.splitlines()
             if "bytes stack frame" in ln]
    return len(lines), [ln for ln in lines
                        if re.search(r"\b[1-9]\d* bytes", ln)]


def bound(nbytes, nops):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_case(S, H, W, B, seed):
    """Catalog-like scene stack: uint16 (S, H, W, B), blotchy (S, H, W)
    validity with some pixels invalid in every scene."""
    import torch
    rng = np.random.RandomState(seed)
    stack = rng.randint(0, 4096, size=(S, H, W, B)).astype(np.uint16)
    base = rng.rand(S, H // 16 + 1, W // 16 + 1)
    valid = np.kron(base, np.ones((1, 16, 16)))[:, :H, :W] > 0.3
    valid[:, :3, :3] = False
    return (torch.from_numpy(stack).cuda(), torch.from_numpy(valid).cuda())


def rotating_median_launches(stack, valid, launch):
    """(launch_next, outputs) for timing bare median launches: enough
    copies of (stack, valid), each with its own outputs, that together
    they exceed the L2, so that a replayed launch reads its inputs from
    device memory as the main path does; ``launch(stack, valid, med,
    any_valid)`` is called on the copies in turn."""
    import itertools
    import torch
    nbytes = stack.numel() * stack.element_size() + valid.numel()
    copies = L2_BYTES // nbytes + 1
    ins = [(stack, valid)] + [(stack.clone(), valid.clone())
                              for _ in range(copies - 1)]
    S, H, W, B = stack.shape
    outs = [(torch.full((H, W, B), float("nan"), device="cuda"),
             torch.ones((H, W, B), dtype=torch.bool, device="cuda"))
            for _ in range(copies)]
    turn = itertools.cycle(range(copies))

    def launch_next():
        i = next(turn)
        launch(*ins[i], *outs[i])
    return launch_next, outs


def median_compare(oc, S, H, W, B, reps):
    """One median case: the plain version, the bare kernel (on every
    input copy) and the wrapper, all bitwise equal, and the library's
    midpoint quantile on NaN-masked samples; times of each, and the
    bound."""
    import torch
    name = f"masked_median S={S} {H}x{W}x{B} uint16"
    stack, valid = median_case(S, H, W, B, seed=S + H)
    n = H * W * B
    nbytes = stack.numel() * 2 + valid.numel() + n * 4 + n
    nops = n * S * math.ceil(math.log2(max(S, 2)))  # comparison sort
    plain = lambda: oc.masked_median(stack, valid)  # noqa: E731
    ref = plain()
    bare, outs = rotating_median_launches(stack, valid,
                                          oc._launch_masked_median)
    for _ in outs:
        bare()
    torch.cuda.synchronize()
    if not all(torch.equal(m, ref[0]) and torch.equal(a, ref[1])
               for m, a in outs):
        raise AssertionError(f"{name}: bare kernel differs from the plain "
                             f"version")
    ms = graph_ms(bare, n=len(outs) * max(1, 20 // len(outs)))
    # the library's yardstick, nothing in the port calls it: invalid
    # samples as NaN, prepared outside the timed window
    x = torch.where(valid[..., None], stack.float(),
                    torch.tensor(float("nan"), device="cuda"))

    def library():
        q = torch.nanquantile(x, 0.5, dim=0, interpolation="midpoint")
        any_valid = ~torch.isnan(q)
        return torch.where(any_valid, q, 0.0), any_valid
    wrapper = lambda: oc.masked_median_kernel(stack, valid)  # noqa: E731
    err = 0.0
    for what, fn in (("torch.nanquantile", library), ("wrapper", wrapper)):
        got = fn()
        torch.cuda.synchronize()
        err = max(err, float((got[0] - ref[0]).abs().max()))
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{name}: {what} differs from the plain "
                                 f"version (max abs err {err})")
    wrapper_ms = cuda_ms(wrapper, reps)
    plain_ms = cuda_ms(plain, 2)
    library_ms = cuda_ms(library, 2)
    bound_ms, bound_by = bound(nbytes, nops)
    row = {"case": name, "equal": True, "max_abs_err": err, "ms": ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "input_copies": len(outs)}
    log(f"  {name}: equal; kernel alone {ms:.4f} ms ({len(outs)} input "
        f"copies), wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.nanquantile {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / ms:.1%} of bound")
    return row


def star_features(rng, F, E, xlo, xhi, ylo, yhi, rmin, rmax):
    """F star polygons of E vertices (pixel coordinates)."""
    theta = np.linspace(0, 2 * np.pi, E, endpoint=False)
    cx = rng.uniform(xlo, xhi, F)
    cy = rng.uniform(ylo, yhi, F)
    rad = rng.uniform(rmin, rmax, (F, 1)) * (1 + 0.3 * rng.rand(F, E))
    px = cx[:, None] + rad * np.cos(theta)[None]
    py = cy[:, None] + rad * np.sin(theta)[None]
    values = rng.randint(1, 255, F)
    return [([np.stack([px[f], py[f]], 1)], float(values[f]))
            for f in range(F)]


def burn_work(edges, windows, height, width, bins=None):
    """(bytes, operations, operations over all pairs) of one burn with
    ALL_TOUCHED. Bytes: what these inputs need read once -- the real
    edges (16 bytes each), 32 bytes (bbox, window, edge count, value)
    for each feature the kernel culls (all F of the dense kernel, the
    binned ones of the binned kernel), and with ``bins`` = (count,
    table) the count array and the count[b] table entries of each
    block -- and the float32 canvas written once. Padding edges,
    padded features and unused table slots are not read and not
    counted. Operations: BURN_ROW_EDGE_OPS per (row, edge) pair and
    BURN_PIXEL_EDGE_OPS per (pixel, edge) pair that these inputs need,
    plus one per pixel. Operations over all pairs: pixels of each
    feature's 0.5 px dilated bbox inside its row window and the canvas,
    times its real edges, times BURN_OPS_PER_EDGE."""
    real = edges[:, :, 0] != -1.0e9
    x0, y0, x1, y1 = (edges[:, :, i].astype(np.float64) for i in range(4))
    w0, w1 = (windows[:, i:i + 1].astype(np.float64) for i in range(2))
    # rows r (centre r + 0.5) with r + 1 >= min y, r <= max y, inside
    # the window and the canvas; columns likewise against the x span
    r0 = np.maximum(np.maximum(np.ceil(np.minimum(y0, y1) - 1.0),
                               np.ceil(w0 - 0.5)), 0)
    r1 = np.minimum(np.minimum(np.floor(np.maximum(y0, y1)),
                               np.ceil(w1 - 0.5) - 1), height - 1)
    c0 = np.maximum(np.ceil(np.minimum(x0, x1) - 1.0), 0)
    c1 = np.minimum(np.floor(np.maximum(x0, x1)), width - 1)
    rows = np.where(real, np.clip(r1 - r0 + 1, 0, None), 0)
    cols = np.clip(c1 - c0 + 1, 0, None)
    ops = (BURN_ROW_EDGE_OPS * int(rows.sum())
           + BURN_PIXEL_EDGE_OPS * int((rows * cols).sum())
           + height * width)

    ne = real.sum(1)
    xs = np.where(real[..., None], edges[:, :, 0::2], np.nan)
    ys = np.where(real[..., None], edges[:, :, 1::2], np.nan)
    all_pairs = 0
    for f in np.nonzero(ne)[0]:
        x0 = max(0, math.ceil(np.nanmin(xs[f]) - 1.0))
        x1 = min(width, math.floor(np.nanmax(xs[f])) + 1)
        y0 = max(0, math.ceil(max(np.nanmin(ys[f]) - 1.0,
                                  windows[f, 0] - 0.5)))
        y1 = min(height, math.floor(min(np.nanmax(ys[f]),
                                        windows[f, 1] - 0.5)) + 1)
        all_pairs += max(0, x1 - x0) * max(0, y1 - y0) * int(ne[f])
    if bins is None:
        n_read, table_bytes = len(edges), 0
    else:
        count, table = bins
        used = np.arange(table.shape[2]) < count[..., None]
        n_read = len(np.unique(table[used]))
        table_bytes = 4 * (int(count.sum()) + count.size)
    nbytes = (16 * int(real.sum()) + 32 * n_read + table_bytes
              + height * width * 4)
    return nbytes, ops, all_pairs * BURN_OPS_PER_EDGE


def burn_compare(rz, kind, label, feats, H, W):
    """One burn case: the plain version, the bare kernel and the wrapper,
    all bitwise equal; times of each, and bounds."""
    import torch
    name = f"{kind} {label}"
    e, v, w = rz.pack_features(feats)
    if (kind == "burn_binned") != (len(e) > rz._BIN_THRESHOLD):
        raise AssertionError(f"{label}: dispatch would not take {kind}")
    ins = [torch.from_numpy(x).cuda()
           for x in (e, v, w, *rz.feature_bounds(e))]
    bins = (rz._bin_features(e, w, H, W, *rz.BURN_BLOCK)
            if kind == "burn_binned" else None)
    nbytes, nops, nops_all = burn_work(e, w, H, W, bins)
    tables = [torch.from_numpy(x).cuda() for x in bins or ()]
    burn, launch = ((rz.burn_dense, rz._launch_burn_dense)
                    if kind == "burn_dense"
                    else (rz.burn_binned, rz._launch_burn_binned))
    plain = lambda: rz._rasterize_torch(ins[0], ins[1], 255.0, H, W, True,  # noqa: E731
                                        ins[2])
    wrapper = lambda: burn(*ins, *tables, 255.0, H, W, True)  # noqa: E731
    ref = plain()
    out = torch.empty((H, W), dtype=torch.float32, device="cuda")
    # the kernel alone, every input prepared once
    bare = lambda: launch(*ins, *tables, 255.0, True, out)  # noqa: E731
    out.fill_(float("nan"))
    bare()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"{name}: bare kernel differs from the plain "
                             f"version")
    ms = graph_ms(bare)
    got = wrapper()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: wrapper differs from the plain "
                             f"version (max abs err {err})")
    wrapper_ms = cuda_ms(wrapper, 10)
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by = bound(nbytes, nops)
    bound_all_ms, _ = bound(nbytes, nops_all)
    row = {"case": name, "equal": True, "max_abs_err": err, "ms": ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_all_pairs": bound_all_ms, "bytes": nbytes,
           "operations": nops, "operations_all_pairs": nops_all}
    log(f"  {name}: equal; kernel alone {ms:.4f} ms, "
        f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {bound_all_ms:.4f} counting all "
        f"pairs), {bound_ms / ms:.1%} of bound")
    return row


def kernel_phase():
    from dl_image_segmentation_tpu_torch.ops import compositing as oc
    import importlib
    rz = importlib.import_module("dl_image_segmentation_tpu_torch.ops."
                                 "rasterize")
    rows = {"masked_median": [], "burn_dense": [], "burn_binned": []}

    log("phase 3: kernel vs plain on the card")
    for S, H, W, B, reps in MEDIAN_CASES:
        rows["masked_median"].append(median_compare(oc, S, H, W, B, reps))

    def burn_cases():
        rng = np.random.RandomState(3)
        # one 260 px tile: ~48 features of up to 256 edges (dense)
        feats = star_features(rng, 48, 256, 10, 250, 10, 250, 4, 26)
        for f, (rings, v) in enumerate(feats):
            k = rng.randint(3, 257)
            feats[f] = ([rings[0][:: max(1, 256 // k)]], v)
        yield "burn_dense", "tile 260x260, 48 features", feats, (260, 260)
        # the batched canvas: 16 tiles stacked by rows, row windows
        feats = []
        for k in range(16):
            for rings, v in star_features(rng, 40, 256, 10, 250, -20, 280,
                                          4, 26):
                shifted = [np.stack([r[:, 0], r[:, 1] + k * 260], 1)
                           for r in rings]
                feats.append((shifted, v, (k * 260.0, (k + 1) * 260.0)))
        yield ("burn_binned", "batched 4160x260, 640 features, row windows",
               feats, (4160, 260))
        # production scale: 1,024 features x 256 edges on 1,024^2
        yield ("burn_binned", "1024x1024, 1024 features x 256 edges",
               star_features(rng, 1024, 256, 40, 984, 40, 984, 8, 25.6),
               (1024, 1024))

    for kind, label, feats, (H, W) in burn_cases():
        rows[kind].append(burn_compare(rz, kind, label, feats, H, W))
    return rows


def write_labels(path, zone, res, nx, ny, n, seed):
    """Seeded GeoJSON: ``n`` star polygons of 3..256 vertices, integer
    attribute ``cls``, inside an nx x ny block of 256-px tiles at
    ``res`` metres (away from its outer edge, so that planning yields
    exactly those tiles)."""
    from dl_image_segmentation_tpu_torch.geo import Tile, crs
    rng = np.random.RandomState(seed)
    x0, y0, _, _ = Tile(256, 2, res, zone, -10, 1400).bounds_unpadded
    span = 256 * res
    margin = 0.12 * span
    feats = []
    for _ in range(n):
        k = rng.randint(3, 257)
        c = (rng.uniform(x0 + margin, x0 + nx * span - margin),
             rng.uniform(y0 + margin, y0 + ny * span - margin))
        ang = np.sort(rng.rand(k) * 2 * np.pi)
        rad = rng.uniform(0.02, 0.1) * span * (0.6 + 0.4 * rng.rand(k))
        ex = c[0] + rad * np.cos(ang)
        ey = c[1] + rad * np.sin(ang)
        lon, lat = crs.utm_to_lonlat(np.r_[ex, ex[:1]], np.r_[ey, ey[:1]],
                                     zone)
        feats.append({"type": "Feature",
                      "geometry": {"type": "Polygon", "coordinates": [
                          np.stack([lon, lat], 1).tolist()]},
                      "properties": {"cls": int(rng.randint(1, 10))}})
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    return path


def read_tree(folder):
    """{relative path: bytes} of every file under ``folder``."""
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, folder).replace(os.sep, "/")] = \
                    fh.read()
    return out


EXPORT_MODES = {"median": ("sentinel-2:L1C", S2_BANDS, 10.0, 0),
                "nearest": ("airbus:oneatlas:phr:v2", "red green blue", 1.0,
                            None)}


def export_run(tmp, mode, device, batch):
    """One run_export of phase 4's 32 tiles in ``mode`` on ``device``:
    (the files it wrote, its run record)."""
    import torch
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.catalog import SyntheticCatalog
    from dl_image_segmentation_tpu_torch.pipeline.chips import (
        DLSampleCreationConfig, OGRLabelDataDesc)
    from dl_image_segmentation_tpu_torch.pipeline.export import run_export

    product, bands, res, mcf = EXPORT_MODES[mode]
    cfg = DLSampleCreationConfig(
        260, 2, res, product, bands,
        os.path.join(tmp, f"{mode}-{device}-{batch}"), "smoke",
        OGRLabelDataDesc(os.path.join(tmp, f"{mode}.geojson"), 0, "cls"),
        max_cloud_fraction=mcf, catalog=SyntheticCatalog())
    jobs = cfg.create_tile_job_configs("aoi", 2020, dt.date(2020, 11, 1))
    if len(jobs) != 32:
        raise AssertionError(f"{mode}: {len(jobs)} tiles, not 32")
    if device == "cuda":
        torch.cuda.synchronize()
        for c in kernels.COUNTERS:
            c.reset()
    t0 = time.perf_counter()
    report = run_export(jobs, n_workers=8, progress=None,
                        batch_tiles=batch, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not report.ok or report.attempts != 1:
        raise AssertionError(f"{mode} {device} batch={batch}: failed "
                             f"{report.failed}, attempts {report.attempts}")
    run = {"mode": mode, "device": device, "batch_tiles": batch,
           "tiles": len(jobs), "seconds": secs,
           "tiles_per_s": len(jobs) / secs,
           "launches": ({c.name: c.count for c in kernels.COUNTERS}
                        if device == "cuda" else None),
           "key": jobs[0].DLTILE.key}
    return read_tree(jobs[0].OUTFOLDER), run


def write_export_labels(tmp):
    """Phase 4's label polygons, one file per mode."""
    for mode, (_, _, res, _) in EXPORT_MODES.items():
        write_labels(os.path.join(tmp, f"{mode}.geojson"), 43, res, 8, 4,
                     1024, seed=11)


def cpu_exports(tmp):
    """Phase 4's CPU reference: each mode per tile and batched with the
    plain versions, {(mode, batch): (files, run record)}. They touch
    neither the card nor the launch counts, so ``main`` runs them in a
    thread beside the build (their seconds are taken beside it)."""
    return {(mode, batch): export_run(tmp, mode, "cpu", batch)
            for mode in EXPORT_MODES for batch in (0, 16)}


def export_phase(tmp, card, cpu_refs):
    from dl_image_segmentation_tpu_torch import kernels

    log("phase 4: end to end")
    launches = {c.name: 0 for c in kernels.COUNTERS}
    runs = []
    for mode in EXPORT_MODES:
        trees = {}
        for device, batch in (("cuda", 0), ("cuda", 16), ("cpu", 0),
                              ("cpu", 16)):
            if device == "cuda":
                tree, run = export_run(tmp, mode, device, batch)
                for k, v in run["launches"].items():
                    launches[k] += v
            else:
                tree, run = cpu_refs[(mode, batch)]
            trees[(device, batch)] = tree
            runs.append(run)
            where = card if device == "cuda" else \
                "the host CPU, beside the build"
            log(f"  {mode} {device} batch_tiles={batch}: {run['tiles']} "
                f"tiles in {run['seconds']:.3f} s = "
                f"{run['tiles_per_s']:.3f} tiles/s on {where}; launches "
                f"{run['launches'] or '-'}")
        for batch in (0, 16):
            ref, got = trees[("cpu", batch)], trees[("cuda", batch)]
            if len(ref) != 64:
                raise AssertionError(f"{mode}: {len(ref)} files, not 64")
            if got != ref:
                bad = [k for k in ref if got.get(k) != ref[k]][:3]
                raise AssertionError(f"{mode} batch_tiles={batch}: card's "
                                     f"bytes differ from the CPU's, e.g. "
                                     f"{bad}")
        images = {k: v for k, v in ref.items() if k.startswith("images/")}
        for key, tree in trees.items():
            if any(tree[k] != v for k, v in images.items()):
                raise AssertionError(f"{mode} {key}: image chips differ "
                                     f"from the CPU's batched run")
        # The batched burn shifts tile k's geometry by k * 260 rows in
        # float32 and so rounds the predicate differently from the
        # per-tile burn (as the JAX package's batched burn does): a few
        # boundary pixels may differ between the two, never between the
        # card and the CPU on the same path.
        moved = sorted(k for k in ref if k.startswith("labels/")
                       and trees[("cpu", 0)][k] != ref[k])
        log(f"  {mode}: card == CPU bytes per tile and batched (64 "
            f"GeoTIFFs each); images equal across all four runs; "
            f"{len(moved)} of 32 label chips differ between per-tile and "
            f"batched burns {moved[:4]}")
        # the chips are valid rasters of the expected shape
        img = next(v for k, v in ref.items() if k.startswith("images/"))
        if img[:4] != b"II*\x00":
            raise AssertionError(f"{mode}: image chip is not a TIFF")
    for name in ("masked_median", "burn_dense", "burn_binned"):
        if launches[name] == 0:
            raise AssertionError(f"{name}: not launched on the main path")
    return launches, runs


def forward_ms(trainer, x, reps=20):
    """Warm CUDA-event milliseconds of one ``trainer.logits`` forward on
    the device batch ``x``."""
    return cuda_ms(lambda: trainer.logits(x), reps)


def benchmark_mode(trainer, x, reps=20):
    """The forward with cuDNN's benchmark mode on, which
    ``Trainer.logits`` turns off: (warm milliseconds, largest difference
    between the logits of two threads). PyTorch keeps the algorithms that
    benchmark mode picks per thread, so each forward runs in a new thread
    (which also keeps this thread's choices out of it), and a server's
    worker thread may not compute the bits that ``predict`` does. ``x``
    holds floats, so the model sees what ``logits`` would give it."""
    import threading
    import torch
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.allow_tf32
    cudnn.benchmark = True
    cudnn.allow_tf32 = trainer.compute_dtype != torch.float32
    xm = x.permute(0, 3, 1, 2)
    runs = []

    def forward():
        with torch.inference_mode():
            return trainer.model(xm)

    def run(timed):
        ms = cuda_ms(forward, reps) if timed else None
        runs.append((ms, forward()))
    try:
        for timed in (True, False):
            th = threading.Thread(target=run, args=(timed,))
            th.start()
            th.join(timeout=300)
    finally:
        cudnn.benchmark, cudnn.allow_tf32 = saved
    if len(runs) != 2:
        raise AssertionError("a benchmark-mode forward did not finish")
    return runs[0][0], float((runs[0][1] - runs[1][1]).abs().max())


def profile_steps(fn, n=5):
    """torch.profiler over ``n`` steady calls of ``fn`` (a forward or a
    train step): (top 5 (kernel, device ms per call) by device time,
    device-busy share: the kernels' time over the window's wall time);
    busy share None when the profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) or 0
    # the kernels themselves (device events), not the aten ops that
    # launched them, so that no time is counted twice
    rows = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows)
    top = [(e.key, dev_us(e) / 1e3 / n) for e in rows[:5] if dev_us(e)]
    return top, (total_us / 1e6 / wall if total_us else None)


def top2_gap(x):
    s = np.sort(x, axis=-1)
    return s[..., -1] - s[..., -2]


def card_vs_cpu(card_t, cpu_t, images):
    """Card against CPU on the first 2 images: fp32 logits within 1e-4 +
    1e-4 relative and class maps equal where the CPU's top two logits
    differ by more than 1e-3; bf16 probabilities within 5e-2 and class
    maps equal where the CPU's top two probabilities differ by more than
    0.1. Returns the largest difference."""
    import torch
    x = images[:2]
    card = card_t.predict_probs(images)[:2]
    ref = cpu_t.predict_probs(x)
    cls = card_t.predict(images)[:2]
    if card_t.config.precision == "fp32":
        got = card_t.logits(torch.from_numpy(images).cuda())[:2].cpu().numpy()
        want = cpu_t.logits(torch.from_numpy(x)).numpy()
        err = float(np.abs(got - want).max())
        if not np.all(np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)):
            raise AssertionError(f"fp32 logits: card differs from the CPU "
                                 f"by {err}")
        sure = top2_gap(want) > 1e-3
        want_cls = want.argmax(-1)
    else:
        err = float(np.abs(card - ref).max())
        if err > 5e-2:
            raise AssertionError(f"bf16 probabilities: card differs from "
                                 f"the CPU by {err}")
        sure = top2_gap(ref) > 0.1
        want_cls = ref.argmax(-1)
    if not np.array_equal(cls[sure], want_cls[sure]):
        raise AssertionError("class maps: card differs from the CPU where "
                             "the top two are apart")
    if not np.all(np.isfinite(card)) or card.shape != ref.shape:
        raise AssertionError("probabilities not finite or misshapen")
    return err, float(sure.mean())


def serve_requests(ps, images):
    """Submit every image at once from its own thread; returns (pendings,
    seconds from the first submit to the last result, latencies)."""
    import threading
    pend = [None] * len(images)
    done = [0.0] * len(images)

    def call(i):
        pend[i] = ps.submit(images[i], probs=False, timeout=120)
        done[i] = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(images))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a served request hung")
    return pend, max(done) - t0, [d - p.t0 for d, p in zip(done, pend)]


def http_round_trip(ps, trainer, rng):
    """/healthz, /predict (.npy), /predict (GeoTIFF) and /metrics over
    127.0.0.1; the served class maps must equal ``predict``'s."""
    import io
    import threading
    import urllib.request
    from dl_image_segmentation_tpu_torch.raster import encode_geotiff
    from dl_image_segmentation_tpu_torch.serve import (make_http_server,
                                                       scale_image)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    size = trainer.config.image_size
    bs = trainer.config.batch_size

    def post(body):
        req = urllib.request.Request(base + "/predict", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.load(io.BytesIO(r.read()))

    def alone(img):
        batch = np.zeros((bs,) + img.shape, np.float32)
        batch[0] = img
        return trainer.predict(batch)[0]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"] or health["batch_size"] != bs:
            raise AssertionError(f"/healthz: {health}")
        img = rng.rand(size, size, 3).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, img)
        if not np.array_equal(post(buf.getvalue()), alone(img)):
            raise AssertionError("/predict (.npy) differs from predict")
        img8 = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        got = post(encode_geotiff(img8, epsg=32643))
        if not np.array_equal(got, alone(scale_image(img8, "auto"))):
            raise AssertionError("/predict (GeoTIFF) differs from predict")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        served = [ln for ln in metrics.splitlines()
                  if ln.startswith("dlseg_requests_served_total ")]
        if not served:
            raise AssertionError("/metrics lacks dlseg_requests_served_total")
        return health, served[0]
    finally:
        httpd.shutdown()
        thread.join(timeout=30)


def forward_row(label, card_t, images, smi, bf16_ms=None, bench=True):
    """Card against CPU, forward time, FLOPs share, memory and profiler
    (and with ``bench`` cuDNN's benchmark mode) of one trainer's forward
    on a batch of 8 at 256 px; a CPU copy holds the card's parameters
    and, for int8-static, its calibrated scales."""
    import torch
    from dl_image_segmentation_tpu_torch.train import Trainer
    t0 = time.perf_counter()
    cfg = card_t.config
    precision = cfg.precision
    cpu_t = Trainer(cfg, device="cpu")
    cpu_t.model.load_state_dict(card_t.model.state_dict())
    if cfg.quantize == "int8-static":
        cpu_t.load_flax_quant(card_t.quant_vars)
    err, sure = card_vs_cpu(card_t, cpu_t, images)
    del cpu_t
    x = torch.from_numpy(images).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = forward_ms(card_t, x)
    peak_mem = torch.cuda.max_memory_allocated()
    flops = card_t.model.flops(256, 256)
    int8 = cfg.quantize != "none"
    peak = (INT8_OPS_PER_S if int8 else
            BF16_OPS_PER_S if precision == "bf16" else FP32_OPS_PER_S)
    share = flops * 8 / (ms / 1e3) / peak
    top, busy = profile_steps(lambda: card_t.logits(x))
    bench_ms, bench_diff = benchmark_mode(card_t, x) if bench else (None,
                                                                    None)
    row = {"config": label, "model": cfg.model, "precision": precision,
           "quantize": cfg.quantize, "s2d": card_t.s2d,
           "width": card_t.model_features,
           "forward_ms": ms, "images_per_s": 8 / (ms / 1e3),
           "cudnn_benchmark_mode_ms": bench_ms,
           "cudnn_benchmark_mode_thread_diff": bench_diff,
           "gflop_per_image": flops / 1e9, "peak_share": share,
           "max_memory_allocated": peak_mem,
           "card_vs_cpu_max_err": err, "decided_share": sure,
           "device_busy_share": busy,
           "top_device_ops": [[k, v] for k, v in top]}
    if bf16_ms is not None:
        row["float_bf16_forward_ms"] = bf16_ms
    row["seconds"] = time.perf_counter() - t0
    log(f"  {label}, {precision} (s2d {card_t.s2d}, width "
        f"{card_t.model_features}): card vs CPU max "
        f"{'logit' if precision == 'fp32' else 'probability'} "
        f"difference {err:.3g} ({sure:.1%} of pixels decided); "
        f"forward {ms:.4f} ms per batch of 8 = "
        f"{row['images_per_s']:.1f} images/s"
        + (f" (float bf16 {bf16_ms:.4f} ms)" if bf16_ms else "")
        + f"; {flops / 1e9:.3f} GFLOP per image = {share:.2%} of "
        f"{peak / 1e12:.0f} T{'OP' if int8 else 'FLOP'}/s ({smi}); max "
        f"memory allocated {peak_mem / 2**20:.1f} MiB"
        + (f"; with cuDNN benchmark mode (not used) {bench_ms:.4f} ms, "
           f"logits of two threads apart by {bench_diff:.3g}" if bench
           else "") + f"; row in {row['seconds']:.1f} s")
    log("    device-busy share over 5 forwards: "
        + (f"{busy:.1%}" if busy is not None else "not measured")
        + "; top device ops (ms per forward): "
        + "; ".join(f"{k[:70]} {v:.4f}" for k, v in top))
    return row


def int8_checks(card_t, images):
    """The int8 U-Net against its float twin on the same parameters and
    images (class maps agreeing, largest logit difference), and the first
    int8 conv of the tree on the card against the CPU: int32 sums bitwise
    equal."""
    import torch
    from dl_image_segmentation_tpu_torch.models.quant import (
        int8_conv2d, quantize_tensor)
    from dl_image_segmentation_tpu_torch.models.unet import space_to_depth
    from dl_image_segmentation_tpu_torch.train.trainer import (
        normalize_images)
    x = torch.from_numpy(images).cuda()
    q = card_t.logits(x)
    with torch.inference_mode():
        card_t.model.eval()
        f = card_t.model(normalize_images(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    if not torch.isfinite(q).all():
        raise AssertionError("int8 logits are not finite")
    agree = float((q.argmax(-1) == f.argmax(-1)).float().mean())
    diff = float((q - f).abs().max() / f.abs().max())
    conv = card_t.infer_model.down_blocks[0].conv0
    xin = normalize_images(x).permute(0, 3, 1, 2).to(card_t.compute_dtype)
    if card_t.s2d > 1:
        xin = space_to_depth(xin, card_t.s2d)
    qx, _ = quantize_tensor(xin, dims=(1, 2, 3), keepdim=True)
    qw, _ = quantize_tensor(conv.weight.detach(), dims=(1, 2, 3))
    got = int8_conv2d(qx, qw)
    want = int8_conv2d(qx.cpu(), qw.cpu())
    if not torch.equal(got.cpu(), want):
        raise AssertionError("int8 conv: the card's int32 sums differ from "
                             "the CPU's")
    return {"int8_vs_float_class_agreement": agree,
            "int8_vs_float_max_logit_diff_rel": diff,
            "int8_conv_card_equals_cpu": True,
            "int8_conv_shape": [list(qx.shape), list(qw.shape)]}


def served_equals_predict(trainer, chips):
    """24 concurrent requests (after 8 to warm up) through a PredictServer
    on ``trainer``: every class map must equal ``predict``'s in batches
    of 8 and ``predict(chips[:7])``'s. Returns (pendings, seconds,
    latencies, dispatches)."""
    from dl_image_segmentation_tpu_torch.serve import PredictServer
    ps = PredictServer(trainer, max_wait_ms=5.0)
    try:
        serve_requests(ps, chips[:8])  # warm-up
        batches0 = ps.batches
        pend, secs, lat = serve_requests(ps, chips)
        errors = [p.error for p in pend if p.error is not None]
        if errors:
            raise AssertionError(f"served requests errored: {errors[:3]}")
        dispatches = ps.batches - batches0
        if ps.errors:
            raise AssertionError(f"{ps.errors} server batches failed")
    finally:
        ps.close()
    want = np.concatenate([trainer.predict(chips[i:i + 8])
                           for i in range(0, len(chips), 8)])
    if not all(np.array_equal(p.result, w) for p, w in zip(pend, want)):
        raise AssertionError("served class maps differ from predict's")
    # an odd, unpadded batch, as __graft_entry__.py:146 asserts
    seven = trainer.predict(chips[:7])
    if not all(np.array_equal(p.result, w) for p, w in zip(pend, seven)):
        raise AssertionError("served class maps differ from predict of 7 "
                             "images")
    return pend, secs, lat, dispatches


def serving_phase(smi):
    """Serving at full width on the card: the U-Net (both s2d trees),
    DeepLab-lite and SegFormer-lite at bf16 and fp32 and the int8 U-Net
    against the CPU, forward times, the micro-batching server, a windowed
    raster and HTTP."""
    import torch
    from dl_image_segmentation_tpu_torch.pipeline.window import (
        predict_windowed, window_origins)
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, predict_windowed_batched)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    log("phase 5: serving")
    rng = np.random.RandomState(5)
    out = {"forward": [], "serve": None, "served_equals_predict": []}
    configs = [("TrainConfig defaults, batch 8, s2d AUTO", {}),
               ("classic tree (s2d 1)", {"s2d": 1}),
               ("DeepLab-lite", {"model": "deeplab"}),
               ("SegFormer-lite", {"model": "segformer"})]
    keep = {}
    bf16_ms = {}
    for label, kw in configs:
        for precision in ("bf16", "fp32"):
            card_t = Trainer(TrainConfig(batch_size=8, precision=precision,
                                         **kw))
            images = rng.rand(8, 256, 256, 3).astype(np.float32)
            row = forward_row(label, card_t, images, smi,
                              bench="model" not in kw)
            out["forward"].append(row)
            if precision == "bf16":
                bf16_ms[label] = row["forward_ms"]
                if label in (configs[0][0], "SegFormer-lite"):
                    keep[label] = card_t
            del card_t
            torch.cuda.empty_cache()
    # the int8 U-Net on both trees: its own rows, the float twin, one
    # int8 conv card == CPU
    for label, kw in configs[:2]:
        for quantize in ("int8", "int8-static"):
            card_t = Trainer(TrainConfig(batch_size=8, quantize=quantize,
                                         **kw))
            images = rng.rand(8, 256, 256, 3).astype(np.float32)
            if card_t.calibrate([images]) != (quantize == "int8-static"):
                raise AssertionError("calibrate consumed no batch")
            row = forward_row(f"{label}, {quantize}", card_t, images, smi,
                              bf16_ms=bf16_ms[label], bench=False)
            row.update(int8_checks(card_t, images))
            out["forward"].append(row)
            log(f"    int8 vs float on the same parameters: class maps "
                f"agree on {row['int8_vs_float_class_agreement']:.2%}, "
                f"largest logit difference "
                f"{row['int8_vs_float_max_logit_diff_rel']:.3g} of the "
                f"largest |logit|; int8 conv {row['int8_conv_shape']} card "
                f"int32 == CPU int32")
            if label == configs[0][0]:
                keep[f"U-Net {quantize}"] = card_t
            else:
                del card_t
            torch.cuda.empty_cache()

    chips = rng.rand(24, 256, 256, 3).astype(np.float32)
    for name in ("SegFormer-lite", "U-Net int8", "U-Net int8-static"):
        _, secs, lat, dispatches = served_equals_predict(keep[name], chips)
        lat = sorted(lat)
        out["served_equals_predict"].append({
            "trainer": name, "requests": 24, "seconds": secs,
            "requests_per_s": 24 / secs,
            "p50_latency_s": lat[len(lat) // 2], "dispatches": dispatches})
        log(f"  PredictServer, {name} (bf16): 24 concurrent chips in "
            f"{secs:.4f} s = {24 / secs:.1f} requests/s, p50 "
            f"{lat[len(lat) // 2] * 1e3:.2f} ms; served == predict, == "
            f"predict(chips[:7])")
        del keep[name]
        torch.cuda.empty_cache()

    trainer = keep[configs[0][0]]
    pend, secs, lat, dispatches = served_equals_predict(trainer, chips)
    ps = PredictServer(trainer, max_wait_ms=5.0)
    try:
        raster = rng.rand(1000, 1150, 3).astype(np.float32)
        n_win = (len(window_origins(1000, 256, 128))
                 * len(window_origins(1150, 256, 128)))
        t0 = time.perf_counter()
        served_probs = predict_windowed_batched(ps, raster, stride=128,
                                                probs=True)
        win_secs = time.perf_counter() - t0
        served_cls = predict_windowed_batched(ps, raster, stride=128)
        offline = predict_windowed(trainer, raster, stride=128,
                                   scale="none", probs=True)
        if not np.array_equal(served_probs, offline):
            raise AssertionError("windowed probabilities differ from the "
                                 "offline predict_windowed's")
        if not np.array_equal(served_cls, offline.argmax(-1)):
            raise AssertionError("windowed class map differs from the "
                                 "offline predict_windowed's")
        health, served_line = http_round_trip(ps, trainer, rng)
        if ps.errors:
            raise AssertionError(f"{ps.errors} server batches failed")
    finally:
        ps.close()
    lat = sorted(lat)
    out["serve"] = {
        "requests": 24, "seconds": secs, "requests_per_s": 24 / secs,
        "p50_latency_s": lat[len(lat) // 2], "max_latency_s": lat[-1],
        "dispatches": dispatches, "windowed_windows": n_win,
        "windowed_seconds": win_secs, "served_total": served_line}
    log(f"  PredictServer on the card (bf16, s2d {trainer.s2d}): 24 "
        f"concurrent chips in {secs:.4f} s = {24 / secs:.1f} requests/s, "
        f"p50 latency {lat[len(lat) // 2] * 1e3:.2f} ms, {dispatches} "
        f"dispatches; served == predict")
    log(f"  windowed 1000 x 1150 at stride 128: {n_win} windows in "
        f"{win_secs:.3f} s, probabilities and class map == offline "
        f"predict_windowed; HTTP /healthz, /predict (.npy, GeoTIFF) == "
        f"predict, /metrics '{served_line}'")
    return out


def train_steps(trainer, feed, steps):
    """``steps`` train_steps fed by TFRecordFeed -> DevicePrefetcher
    (pinned batches copied on a side stream); the per-step losses."""
    from dl_image_segmentation_tpu_torch.pipeline.input import (
        DevicePrefetcher)
    losses = []
    with DevicePrefetcher(iter(feed), trainer.place_batch) as pf:
        for _ in range(steps):
            losses.append(trainer.train_step(*next(pf))["loss"])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses


def step_numbers(trainer, x, y, smi, reps=10):
    """Warm CUDA-event ms of one train step on the device batch (x, y),
    images/s, the convs' share of the card's peak (3 x forward FLOPs),
    max memory allocated, and the profiler's top device ops and
    device-busy share over 5 steps."""
    import torch
    n = x.shape[0]
    step = lambda: trainer.train_step_async(x, y)  # noqa: E731
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, reps)
    peak_mem = torch.cuda.max_memory_allocated()
    size = trainer.config.image_size
    flops = 3 * trainer.model.flops(size, size) * n
    fp32 = trainer.compute_dtype == torch.float32
    peak = FP32_OPS_PER_S if fp32 else BF16_OPS_PER_S
    top, busy = profile_steps(step)
    row = {"model": trainer.config.model,
           "precision": trainer.config.precision, "batch": n,
           "train_step_ms": ms, "images_per_s": n / (ms / 1e3),
           "gflop_per_step": flops / 1e9,
           "peak_share": flops / (ms / 1e3) / peak,
           "max_memory_allocated": peak_mem, "device_busy_share": busy,
           "top_device_ops": [[k, v] for k, v in top]}
    log(f"  train step ({row['model']}) at {row['precision']}, batch {n}: "
        f"{ms:.4f} ms = "
        f"{row['images_per_s']:.1f} images/s; {flops / 1e9:.1f} GFLOP a "
        f"step = {row['peak_share']:.2%} of {peak / 1e12:.0f} TFLOP/s "
        f"({smi}); max memory allocated {peak_mem / 2**20:.1f} MiB; "
        "device-busy share over 5 steps "
        + (f"{busy:.1%}" if busy is not None else "not measured"))
    log("    top device ops (ms a step): "
        + "; ".join(f"{k[:70]} {v:.4f}" for k, v in top))
    return row


def card_vs_cpu_steps(cfg, x, y, steps=3):
    """``steps`` fp32 train steps on (x, y) from one state dict, twice on
    the card and once on the CPU: per-step loss differences (card against
    CPU, within 1e-4 relative), the largest parameter difference, and the
    two card runs, which must agree bitwise (the step takes cuDNN's
    deterministic algorithms)."""
    import torch
    from dl_image_segmentation_tpu_torch.train import Trainer
    first = Trainer(cfg)
    state = {k: v.detach().cpu().clone()
             for k, v in first.model.state_dict().items()}
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        t = first if not runs else Trainer(cfg, device=device)
        t.model.load_state_dict(state)
        losses = [t.train_step(x, y)["loss"] for _ in range(steps)]
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in t.state.params.items()}))
        del t
    (card, p_card), (card2, p_card2), (cpu, p_cpu) = runs
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    if max(rel) > 1e-4:
        raise AssertionError(f"fp32 steps: card losses {card} differ from "
                             f"the CPU's {cpu}")
    param_diff = max(float((p_card[n] - p_cpu[n]).abs().max())
                     for n in p_cpu)
    bitwise = card == card2 and all(torch.equal(p_card[n], p_card2[n])
                                    for n in p_card)
    if not bitwise:
        raise AssertionError("two card runs of the same fp32 steps differ")
    return {"card_losses": card, "cpu_losses": cpu,
            "loss_rel_diff": rel, "max_param_diff": param_diff,
            "card_runs_bitwise_equal": bitwise}


def training_phase(smi):
    """U-Net training at full width on the card from exported chips to a
    served checkpoint (TrainConfig defaults with num_classes=10)."""
    import torch
    from dl_image_segmentation_tpu_torch.catalog import SyntheticCatalog
    from dl_image_segmentation_tpu_torch.pipeline.chips import (
        DLSampleCreationConfig, OGRLabelDataDesc)
    from dl_image_segmentation_tpu_torch.pipeline.export import run_export
    from dl_image_segmentation_tpu_torch.pipeline.input import TFRecordFeed
    from dl_image_segmentation_tpu_torch.records import (
        list_shards, process_dataset_mp, read_records)
    from dl_image_segmentation_tpu_torch.serve import PredictServer
    from dl_image_segmentation_tpu_torch.train import (
        DeviceDataPool, TrainConfig, Trainer)

    log(f"phase 6: training ({smi})")
    kw = {"num_classes": 10}
    cfg = TrainConfig(**kw)
    bs = cfg.batch_size
    out = {"config": {k: getattr(cfg, k) for k in (
        "num_classes", "base_features", "levels", "image_size",
        "batch_size", "learning_rate", "weight_decay", "precision")}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # 1. export: 32 RGB nearest-date tiles of 256 px chips
        labels = write_labels(os.path.join(tmp, "labels.geojson"), 43, 1.0,
                              8, 4, 1024, seed=11)
        dlcfg = DLSampleCreationConfig(
            256, 0, 1.0, "airbus:oneatlas:phr:v2", "red green blue",
            os.path.join(tmp, "chips"), "smoke",
            OGRLabelDataDesc(labels, 0, "cls"), catalog=SyntheticCatalog())
        jobs = dlcfg.create_tile_job_configs("aoi", 2020,
                                             dt.date(2020, 11, 1))
        if len(jobs) != 32:
            raise AssertionError(f"export: {len(jobs)} tiles, not 32")
        t0 = time.perf_counter()
        report = run_export(jobs, n_workers=8, progress=None)
        if not report.ok:
            raise AssertionError(f"export failed: {report.failed}")
        out["export_seconds"] = time.perf_counter() - t0
        # 2. shards: 4 tifarr shards, every record's CRCs checked
        shards = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        written = process_dataset_mp("smoke", jobs[0].OUTFOLDER, shards, 4,
                                     store_as_array=True)
        out["shard_seconds"] = time.perf_counter() - t0
        files = list_shards(shards, "smoke")
        n_rec = sum(1 for f in files for _ in read_records(f,
                                                           verify_crc=True))
        if written != 32 or len(files) != 4 or n_rec != 32:
            raise AssertionError(f"shards: {written} written, {len(files)} "
                                 f"files, {n_rec} records")
        log(f"  export: 32 tiles of 256 px in {out['export_seconds']:.3f}"
            f" s; 4 tifarr shards ({written} records, CRCs checked) in "
            f"{out['shard_seconds']:.3f} s")
        pattern = os.path.join(shards, "smoke-*")

        def feed(**over):
            return TFRecordFeed(pattern, "tifarr", **{
                "batch_size": bs, "image_size": cfg.image_size,
                "scale": "raw", **over})
        # feed alone: records/s through parse and batching (host only)
        f = iter(feed(seed=3))
        next(f)
        t0 = time.perf_counter()
        for _ in range(4):
            next(f)
        out["feed_records_per_s"] = 4 * bs / (time.perf_counter() - t0)
        del f
        # 3. steps: TFRecordFeed -> DevicePrefetcher -> train_step
        runs = {}
        for name, extra in (("defaults", {}),
                            ("cosine, warmup 5, clip 1.0",
                             {"schedule": "cosine", "warmup_steps": 5,
                              "grad_clip_norm": 1.0})):
            t = Trainer(TrainConfig(**kw, **extra))
            runs[name] = train_steps(t, feed(seed=1), 20)
            log(f"  20 steps ({name}): losses {runs[name][0]:.4f} -> "
                f"{np.mean(runs[name][-5:]):.4f} (mean of the last 5)")
            if name == "defaults":
                trainer = t
        out["losses"] = runs
        # 4. scanned: a pool of 32 on the device, 10 steps a dispatch; a
        # live feed of 16-example batches refreshes the pool after each
        # dispatch (offsets 0, then 16) while the dispatch runs
        pool = DeviceDataPool.from_feed(iter(feed(seed=2)), 32)
        given = []

        def refresh_batches():
            for b in feed(seed=6, batch_size=16):
                given.append(b)
                yield b
        step0 = trainer.state.step
        trainer.wall_start = None
        trainer.device_seconds = trainer.feed_seconds = 0.0
        trainer.examples_seen = 0
        refresh = refresh_batches()
        scan = trainer.train_scanned(pool, total_steps=20,
                                     steps_per_dispatch=10, augment=True,
                                     refresh_feed=refresh)
        refresh.close()  # stops the feed's parse threads
        if (trainer.state.step != step0 + 20
                or not np.all(np.isfinite(trainer.scan_losses[-20:]))):
            raise AssertionError(f"train_scanned: step {trainer.state.step}"
                                 f", losses {trainer.scan_losses[-20:]}")
        if len(given) != 2 or not (
                np.array_equal(pool.images.cpu().numpy(),
                               np.concatenate([b[0] for b in given]))
                and np.array_equal(pool.labels.cpu().numpy(),
                                   np.concatenate([b[1] for b in given]))):
            raise AssertionError(f"train_scanned: the pool does not hold the "
                                 f"{len(given)} refresh batches")
        out["scanned"] = scan
        log(f"  train_scanned 20 steps (10 a dispatch, augmented, pool "
            f"refreshed from the feed after each dispatch; pool == the 2 "
            f"refresh batches): {scan['examples_per_sec']:.1f} examples/s, "
            f"duty_cycle {scan['duty_cycle']:.3f}, duty_cycle_lower "
            f"{scan['duty_cycle_lower']:.3f}, refresh feed "
            f"{trainer.feed_seconds:.3f} s, last loss {scan['loss']:.4f}")
        # 5. evaluate on one pass over the shards
        ev = trainer.evaluate(iter(feed(repeat=False, drop_remainder=False)))
        if ev["batches"] < 1 or not np.isfinite(ev["loss"]):
            raise AssertionError(f"evaluate: {ev}")
        out["evaluate"] = ev
        log(f"  evaluate: loss {ev['loss']:.4f}, accuracy "
            f"{ev['accuracy']:.4f}, mIoU {ev['miou']:.4f}, per-class IoU "
            + ", ".join("-" if v is None else f"{v:.3f}"
                        for v in ev["per_class_iou"]))
        # 6. checkpoint -> fresh trainer -> predict and serve
        ckpt = os.path.join(tmp, "ckpt", "model.pt")
        trainer.save_checkpoint(ckpt)
        restored = Trainer(cfg)
        restored.restore_checkpoint(ckpt)
        chips = next(iter(feed(seed=4)))[0][:8]
        want = trainer.predict(chips)
        if not np.array_equal(restored.predict(chips), want):
            raise AssertionError("restored predict differs from the "
                                 "trained trainer's")
        padded = np.zeros((bs,) + chips.shape[1:], chips.dtype)
        padded[:len(chips)] = chips
        batch_maps = restored.predict(padded)[:len(chips)]
        ps = PredictServer(restored, max_wait_ms=50.0)
        try:
            pend, _, _ = serve_requests(ps, chips)
        finally:
            ps.close()
        if any(p.error for p in pend) or not all(
                np.array_equal(p.result, w) for p, w in zip(pend,
                                                            batch_maps)):
            raise AssertionError("served class maps differ from the "
                                 "restored trainer's predict")
        log(f"  checkpoint (step {restored.state.step}) restored: predict on "
            f"8 chips == the trained trainer's bitwise; PredictServer "
            f"answers == restored predict")
        del restored, ps, trainer, pool
        torch.cuda.empty_cache()
        # 7. card against CPU, 3 fp32 steps on 2 images
        x, y = next(iter(feed(seed=5)))
        cmp = card_vs_cpu_steps(TrainConfig(**{**kw, "batch_size": 2,
                                               "precision": "fp32"}),
                                x[:2], y[:2])
        out["card_vs_cpu"] = cmp
        log(f"  card vs CPU, 3 fp32 steps on 2 images: loss relative "
            f"differences {', '.join(f'{v:.3g}' for v in cmp['loss_rel_diff'])}"
            f"; largest parameter difference {cmp['max_param_diff']:.3g}; "
            f"two card runs bitwise equal: {cmp['card_runs_bitwise_equal']}")
        # 8. step numbers at batch 32, bf16 and fp32
        out["steps"] = []
        for precision in ("bf16", "fp32"):
            t = Trainer(TrainConfig(**{**kw, "precision": precision}))
            xd, yd = t.place_batch(x, y)
            out["steps"].append(step_numbers(t, xd, yd, smi))
            del t, xd, yd
            torch.cuda.empty_cache()
        # 9. DeepLab-lite and SegFormer-lite (TrainConfig defaults with
        # the model, 10 classes, batch 32): 20 steps from the feed, 3 fp32
        # steps card against CPU and card against card, step numbers
        out["families"] = []
        for model in ("deeplab", "segformer"):
            fam = {**kw, "model": model}
            t = Trainer(TrainConfig(**fam))
            losses = train_steps(t, feed(seed=1), 20)
            del t
            log(f"  {model}: 20 steps: losses {losses[0]:.4f} -> "
                f"{np.mean(losses[-5:]):.4f} (mean of the last 5)")
            cmp = card_vs_cpu_steps(TrainConfig(**{
                **fam, "batch_size": 2, "precision": "fp32"}), x[:2], y[:2])
            log(f"  {model}: card vs CPU, 3 fp32 steps on 2 images: loss "
                "relative differences "
                + ", ".join(f"{v:.3g}" for v in cmp["loss_rel_diff"])
                + f"; largest parameter difference "
                f"{cmp['max_param_diff']:.3g}; two card runs bitwise "
                f"equal: {cmp['card_runs_bitwise_equal']}")
            steps = []
            for precision in ("bf16", "fp32"):
                t = Trainer(TrainConfig(**{**fam, "precision": precision}))
                xd, yd = t.place_batch(x, y)
                steps.append(step_numbers(t, xd, yd, smi))
                del t, xd, yd
                torch.cuda.empty_cache()
            out["families"].append({"model": model, "losses": losses,
                                    "card_vs_cpu": cmp, "steps": steps})
        log(f"  feed: {out['feed_records_per_s']:.1f} records/s "
            f"(tifarr, {cfg.image_size} px, parse and batch; {smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def write_catalog(root, x0, y0, span, nx, ny):
    """A LocalCatalog root written with LocalCatalog.create + add_scene:
    10 dated Sentinel-2 L1C scenes of 13 uint16 bands (DNs 1-4095, nodata
    0 in blotches) over the nx x ny tiles of ``span`` metres whose corner
    is (x0, y0), zone 43: one at 10 m over the whole block (a file of
    >= 32 MiB, read windowed), two in zone 42 at 20 m over the whole block
    (warped across zones) and seven at 10 m over 4 x 2-tile quarters, all
    smaller than 32 MiB (decoded whole into the scene LRU)."""
    from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
    from dl_image_segmentation_tpu_torch.catalog.base import (
        reproject_bounds)
    cat = LocalCatalog.create(root)
    rng = np.random.RandomState(17)
    margin = 200.0
    block = (x0 - margin, y0 - margin, x0 + nx * span + margin,
             y0 + ny * span + margin)
    scenes = [("s2-big", 43, 10.0, block)]
    scenes += [(f"s2-z42-{k}", 42, 20.0, block) for k in "ab"]
    for k, (i, j) in enumerate([(0, 0), (4, 0), (0, 2), (4, 2), (2, 0),
                                (2, 2), (2, 1)]):
        scenes.append((f"s2-q{k}", 43, 10.0, (
            x0 + i * span - margin, y0 + j * span - margin,
            x0 + (i + 4) * span + margin, y0 + (j + 2) * span + margin)))
    for k, (sid, zone, res, bounds) in enumerate(scenes):
        bx0, by0, bx1, by1 = reproject_bounds(bounds, 43, zone, margin=res)
        w = int(np.ceil((bx1 - bx0) / res))
        h = int(np.ceil((by1 - by0) / res))
        arr = rng.randint(1, 4096, (h, w, len(S2_BANDS))).astype(np.uint16)
        blot = np.kron(rng.rand(h // 32 + 1, w // 32 + 1) < 0.1,
                       np.ones((32, 32), bool))[:h, :w]
        arr[blot] = 0
        gt = (np.floor(bx0) + 0.5, res, 0.0, np.ceil(by1) - 0.25, 0.0, -res)
        cat.add_scene("sentinel-2:L1C", S2_BANDS, sid,
                      dt.date(2020, 6, 1) + dt.timedelta(days=12 * k), arr,
                      gt, 32600 + zone, cloud_fraction=0.01 * k, nodata=0,
                      save_index=False)
    cat._save_index()
    sizes = {sid: os.path.getsize(os.path.join(root, "scenes", f"{sid}.tif"))
             for sid, _, _, _ in scenes}
    big = [sid for sid, n in sizes.items() if n >= 32 << 20]
    if big != ["s2-big"]:
        raise AssertionError(f"scene files of >= 32 MiB: {big} ({sizes})")
    return sizes


def stac_tree_from_root(root, tree):
    """A static STAC tree under ``tree`` (the port's StacBuilder) that
    publishes the scenes of the LocalCatalog root ``root``: one
    collection a product, one item a scene with one multi-band asset
    ("data", eo:bands = the product's bands, its nodata), the scene's
    date and cloud cover. Returns the number of items."""
    from dl_image_segmentation_tpu_torch.catalog.stacserver import (
        StacBuilder)
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    with open(os.path.join(root, "index.json")) as f:
        index = json.load(f)
    builder = StacBuilder(tree)
    n = 0
    for product, p in index["products"].items():
        builder.add_collection(product, bands=p["bands"])
        for s in p["scenes"]:
            g = read_geotiff(os.path.join(root, s["path"]))
            cf = s.get("cloud_fraction")
            builder.add_item(
                product, s["id"], dt.date.fromisoformat(s["date"]),
                {"data": {"array": g.array, "epsg": g.info.epsg,
                          "geotransform": g.info.geotransform,
                          "eo_bands": p["bands"],
                          "nodata": s.get("nodata", g.info.nodata)}},
                cloud_cover=None if cf is None else 100.0 * cf)
            n += 1
    return n


def cli_run(argv, secs, name):
    """One in-process call of the port's CLI; its exit code must be 0.
    Returns the lines it printed (echoed here once it ends)."""
    import contextlib
    import io
    from dl_image_segmentation_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        secs[name] = time.perf_counter() - t0
        sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"{name}: exit code {rc}")
    log(f"  {name}: {secs[name]:.3f} s")
    return buf.getvalue().splitlines()


class CliBeside:
    """``runs`` ([(name, argv)]) through ``cli.main`` one after another on
    a thread beside the caller's card work, as phase 4's CPU exports run
    beside the build: each run's seconds go into ``secs``, and ``after``
    (if given) is called on the thread after each run with its name.
    Only the main thread captures stdout (``cli_run``), so these print
    straight out. ``join()`` waits and re-raises a failure or a non-zero
    exit code."""

    def __init__(self, runs, secs, after=None):
        self.error = None

        def work():
            from dl_image_segmentation_tpu_torch import cli
            try:
                for name, argv in runs:
                    t0 = time.perf_counter()
                    rc = cli.main(argv)
                    secs[name] = time.perf_counter() - t0
                    if rc != 0:
                        raise AssertionError(f"{name}: exit code {rc}")
                    log(f"  {name}: {secs[name]:.3f} s (on a thread beside "
                        "the card's work)")
                    if after is not None:
                        after(name)
            except BaseException as e:  # noqa: BLE001 -- raised in join
                self.error = e
        self.thread = threading.Thread(target=work, name="cli-beside")
        self.thread.start()

    def join(self):
        t0 = time.perf_counter()
        self.thread.join()
        log(f"  the CPU runs beside the card's work ended "
            f"{time.perf_counter() - t0:.1f} s after it")
        if self.error is not None:
            raise self.error


def serve_round_trip(ckpt, chip, secs):
    """``serve`` in a subprocess on port 0: one /healthz and one /predict
    of ``chip`` (a .npy body), then SIGINT; returns the served class
    map."""
    import io
    import queue
    import signal
    import threading
    import urllib.request
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dl_image_segmentation_tpu_torch.cli", "serve",
         "--checkpoint", ckpt, "--classes", "10", "--port", "0", "--scale",
         "none"], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        line = lines.get(timeout=300)
        m = re.search(r"(http://\S+)", line)
        if not m:
            raise AssertionError(f"serve printed {line!r}")
        base = m.group(1)
        secs["serve start"] = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"]:
            raise AssertionError(f"/healthz: {health}")
        buf = io.BytesIO()
        np.save(buf, chip)
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served = np.load(io.BytesIO(r.read()))
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            raise
    if rc != 0:
        raise AssertionError(f"serve exited {rc} after SIGINT")
    secs["serve"] = time.perf_counter() - t0
    log(f"  serve: {secs['serve']:.3f} s (up in {secs['serve start']:.3f} s;"
        f" /healthz {health})")
    return served


def cli_phase(smi, tmp, share):
    """Phase 7: chip creation from a LocalCatalog root and the verify
    sequence, through the port's CLI in-process (``cli.main``). It writes
    into ``tmp`` and leaves its outputs there for phase 8, naming them in
    ``share``."""
    import glob
    import torch
    import dl_image_segmentation_tpu_torch.catalog as catalog_pkg
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.geo import Tile

    log(f"phase 7: LocalCatalog + CLI on the card ({smi})")
    out = {"seconds": {}, "exports": []}
    secs = out["seconds"]
    labels = write_labels(os.path.join(tmp, "labels.geojson"), 43, 10.0,
                          8, 4, 1024, seed=11)
    x0, y0, _, _ = Tile(256, 2, 10.0, 43, -10, 1400).bounds_unpadded
    root = os.path.join(tmp, "catalog")
    t0 = time.perf_counter()
    sizes = write_catalog(root, x0, y0, 2560.0, 8, 4)
    secs["write catalog"] = time.perf_counter() - t0
    log(f"  LocalCatalog root: 10 scenes in {secs['write catalog']:.3f} "
        f"s; file sizes (MiB) "
        + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in sizes.items()))
    base = ["create-chips", "--labels", labels, "--attribute", "cls",
            "--product", "sentinel-2:L1C", "--bands", " ".join(S2_BANDS),
            "--tile-size", "260", "--pad", "2", "--resolution", "10.0",
            "--tag", "smoke", "--loc", "aoi", "--year", "2020",
            "--ref-date", "2020-11-01", "--catalog", root,
            "--workers", "8"]
    made = {}
    original = catalog_pkg.LocalCatalog

    class Recording(original):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.setdefault(threading.get_ident(), []).append(self)

    launches = {c.name: 0 for c in kernels.COUNTERS}
    trees = {}

    def export_argv(device, batch):
        return base + ["--out", os.path.join(tmp, f"s2-{device}-{batch}"),
                       "--max-cloud-fraction", "0", "--batch-tiles",
                       str(batch), "--device", device]

    def check(device, batch, cat):
        """The run's LocalCatalog read both ways and a zone-42 scene; its
        chips; its row."""
        name = f"create-chips {device} --batch-tiles {batch}"
        if not (cat._readers and cat._cache):
            raise AssertionError(f"{name}: windowed reads "
                                 f"{sorted(cat._readers)}, whole-decoded "
                                 f"scenes {sorted(cat._cache)}")
        if not any("z42" in k for k in cat._cache):
            raise AssertionError(f"{name}: no zone-42 scene was loaded")
        folder, = glob.glob(os.path.join(tmp, f"s2-{device}-{batch}", "*"))
        trees[(device, batch)] = read_tree(folder)
        run = {"device": device, "batch_tiles": batch, "tiles": 32,
               "seconds": secs[name], "tiles_per_s": 32 / secs[name],
               "windowed": sorted(cat._readers),
               "whole_decoded": len(cat._cache)}
        out["exports"].append(run)
        log(f"    {name}: {run['tiles_per_s']:.3f} tiles/s on "
            f"{smi if device == 'cuda' else 'the host CPU'}; windowed "
            f"{run['windowed']}, {run['whole_decoded']} scenes decoded "
            "whole (zone 42 among them)")

    cpu_cats = {}
    catalog_pkg.LocalCatalog = Recording
    # the CPU exports run on a thread beside the card's exports and the
    # verify sequence below; their chips are held to the card's at the end
    cpu = CliBeside(
        [(f"create-chips cpu --batch-tiles {b}", export_argv("cpu", b))
         for b in (16, 0)], secs,
        after=lambda name: cpu_cats.__setitem__(
            name, made[threading.get_ident()][-1]))
    try:
        for batch in (16, 0):
            torch.cuda.synchronize()
            for c in kernels.COUNTERS:
                c.reset()
            cli_run(export_argv("cuda", batch), secs,
                    f"create-chips cuda --batch-tiles {batch}")
            torch.cuda.synchronize()
            for c in kernels.COUNTERS:
                launches[c.name] += c.count
            check("cuda", batch, made[threading.get_ident()][-1])
        for name in ("masked_median", "burn_dense", "burn_binned"):
            if launches[name] == 0:
                raise AssertionError(f"{name}: not launched by the "
                                     "LocalCatalog export")
        out["launches"] = launches
        log(f"  LocalCatalog export on the card: launches {launches}")
        share.update(root=root, base=base, s2_trees={
            b: trees[("cuda", b)] for b in (16, 0)},
            s2_folder=os.path.basename(glob.glob(os.path.join(
                tmp, "s2-cuda-16", "*"))[0]))
        verify_sequence(smi, tmp, share, out)
    finally:
        cpu.join()
        catalog_pkg.LocalCatalog = original
    for batch in (16, 0):
        check("cpu", batch, cpu_cats[f"create-chips cpu --batch-tiles "
                                     f"{batch}"])
        ref, got = trees[("cpu", batch)], trees[("cuda", batch)]
        if len(ref) != 64 or got != ref:
            bad = [k for k in ref if got.get(k) != ref[k]][:3]
            raise AssertionError(f"LocalCatalog export batch_tiles="
                                 f"{batch}: {len(ref)} files; card's "
                                 f"bytes differ from the CPU's {bad}")
    log("  LocalCatalog export: card == CPU bytes per tile and batched "
        "(64 GeoTIFFs each)")
    return out


def verify_sequence(smi, tmp, share, out):
    """Phase 7's verify sequence: a nearest-date RGB mosaic of 256 px
    chips from the LocalCatalog root, shards, inspect, train, eval,
    stitch, predict, serve, the other families and int8 inference."""
    import glob
    import torch
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.train import (TrainConfig, Trainer,
                                                       orbax)
    secs = out["seconds"]
    base = share["base"]
    rgb = os.path.join(tmp, "rgb")
    argv = base + ["--out", rgb, "--bands", "red green blue",
                   "--tile-size", "256", "--pad", "0"]
    cli_run(argv, secs, "create-chips rgb")
    folder, = glob.glob(os.path.join(rgb, "*"))
    share.update(rgb_argv=argv, rgb_folder=folder)
    shards = os.path.join(tmp, "shards")
    cli_run(["to-tfrecords", "--name", "smoke", "--directory", folder,
             "--out", shards, "--shards", "4", "--workers", "4",
             "--engine", "mp", "--store-as-array"], secs, "to-tfrecords")
    pattern = os.path.join(shards, "smoke-*")
    cli_run(["inspect", "--records", pattern, "--verify-crc",
             "--class-stats"], secs, "inspect")
    ckdir = os.path.join(tmp, "managed")
    mlog = os.path.join(tmp, "metrics.jsonl")
    cli_run(["train", "--records", pattern, "--mode", "tifarr",
             "--classes", "10", "--steps", "20", "--log-every", "1",
             "--save-every", "10", "--checkpoint", ckdir,
             "--metrics-log", mlog], secs, "train")
    losses = [json.loads(ln)["loss"] for ln in open(mlog)]
    if len(losses) != 20 or not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    out["losses"] = losses
    # orbax steps, as the JAX CLI's CheckpointManager leaves them
    ckpt = orbax.step_path(ckdir, 20)
    if sorted(os.listdir(ckdir)) != ["10", "20"] \
            or orbax.all_steps(ckdir) != [10, 20]:
        raise AssertionError(f"managed checkpoints {os.listdir(ckdir)}")
    cli_run(["train", "--records", pattern, "--mode", "tifarr",
             "--classes", "10", "--steps", "20", "--scan-steps", "10",
             "--pool-size", "32", "--checkpoint",
             os.path.join(tmp, "scanned.pt")], secs, "train --scan-steps")
    cli_run(["eval", "--records", pattern, "--checkpoint", ckpt,
             "--classes", "10", "--json"], secs, "eval")
    mosaic = os.path.join(tmp, "mosaic.tif")
    cli_run(["stitch", "--chips", os.path.join(folder, "images"),
             "--out", mosaic], secs, "stitch")
    share.update(shards=shards, mosaic=mosaic, losses=losses)
    pred = os.path.join(tmp, "pred.tif")
    cli_run(["predict", "--geotiff", mosaic, "--checkpoint", ckpt,
             "--classes", "10", "--scale", "none", "--out", pred], secs,
            "predict --geotiff")
    g, m = read_geotiff(pred), read_geotiff(mosaic)
    if g.array.shape[:2] != m.array.shape[:2] \
            or g.info.geotransform != m.info.geotransform:
        raise AssertionError(f"predict --geotiff: {g.array.shape} vs "
                             f"{m.array.shape}")
    chip = read_geotiff(sorted(glob.glob(os.path.join(
        folder, "images", "*.tif")))[0]).array.astype(np.float32)
    served = serve_round_trip(ckpt, chip, secs)
    t = Trainer(TrainConfig(num_classes=10, batch_size=8))
    t.restore_checkpoint(ckpt)
    if not np.array_equal(served, t.predict(chip[None])[0]):
        raise AssertionError("served class map differs from predict's")
    # the port's reader gives back the trainer's tree bitwise
    got = flat_tree(orbax.read_checkpoint(ckpt))
    want = flat_tree(t.orbax_tree())
    if sorted(got) != sorted(want) or int(want["step"]) != 20 or any(
            np.asarray(got[k]).dtype != np.asarray(v).dtype
            or np.asarray(got[k]).tobytes() != np.asarray(v).tobytes()
            for k, v in want.items()):
        raise AssertionError("read_checkpoint of the managed step differs "
                             "from the restored trainer's orbax_tree()")
    del t
    torch.cuda.empty_cache()
    log(f"  loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean of "
        f"the last 5 of 20); managed orbax steps {sorted(os.listdir(ckdir))}"
        f", read back bitwise as the restored trainer's orbax_tree() "
        f"({len(want)} leaves); served /predict from the orbax step == "
        f"predict; {smi}")
    # the other families and int8 inference through the CLI
    seg_log = os.path.join(tmp, "segformer.jsonl")
    cli_run(["train", "--records", pattern, "--mode", "tifarr",
             "--classes", "10", "--model", "segformer", "--steps", "20",
             "--log-every", "1", "--metrics-log", seg_log,
             "--checkpoint", os.path.join(tmp, "segformer.pt")], secs,
            "train --model segformer")
    seg = [json.loads(ln)["loss"] for ln in open(seg_log)]
    if len(seg) != 20 or not np.mean(seg[-5:]) < seg[0]:
        raise AssertionError(f"train --model segformer: losses {seg}")
    out["segformer_losses"] = seg
    qdir = os.path.join(tmp, "pred-int8-static")
    cli_run(["predict", "--images", os.path.join(folder, "images"),
             "--checkpoint", ckpt, "--classes", "10", "--scale", "none",
             "--quantize", "int8-static", "--calibrate-records", pattern,
             "--calibrate-batches", "1", "--out", qdir], secs,
            "predict --quantize int8-static")
    if len(glob.glob(os.path.join(qdir, "*.tif"))) != 32:
        raise AssertionError("predict --quantize int8-static: "
                             f"{os.listdir(qdir)[:3]}")
    cli_run(["eval", "--records", pattern, "--checkpoint", ckpt,
             "--classes", "10", "--quantize", "int8", "--json"], secs,
            "eval --quantize int8")
    log(f"  segformer loss {seg[0]:.4f} -> {np.mean(seg[-5:]):.4f} (mean "
        f"of the last 5 of 20); int8-static predict wrote 32 maps")
    return out


def with_flags(argv, **flags):
    """``argv`` with the value after each ``--flag`` replaced (flag names
    with '_' for '-'), or the pair appended where it is missing."""
    argv = list(argv)
    for key, value in flags.items():
        flag = "--" + key.replace("_", "-")
        if flag in argv:
            argv[argv.index(flag) + 1] = str(value)
        else:
            argv += [flag, str(value)]
    return argv


def objects_under(fake, bucket, prefix):
    """{key below ``prefix``: bytes} of a fake's objects."""
    return {k[1][len(prefix):]: v for k, v in list(fake.objects.items())
            if k[0] == bucket and k[1].startswith(prefix)}


def feed_rate(pattern, batch_size, image_size, mode="tifarr", batches=4):
    """Records/s of ``mode`` through the feed's read, parse (4 threads)
    and batching, after one warm batch (host only)."""
    from dl_image_segmentation_tpu_torch.pipeline.input import TFRecordFeed
    it = iter(TFRecordFeed(pattern, mode, batch_size,
                           image_size=image_size, scale="raw", seed=3))
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return batches * batch_size / (time.perf_counter() - t0)


@contextlib.contextmanager
def put_server():
    """A loopback server that keeps the body of every PUT by path: the
    stand-in for presigned upload URLs."""
    import http.server
    import threading
    received = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_PUT(self):
            n = int(self.headers["Content-Length"])
            received[self.path] = self.rfile.read(n)
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", received
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)


def remote_phase(smi, share):
    """Phase 8: remote storage and catalogs, through the port's loopback
    fakes (FakeGCS, FakeS3, SceneServer, StacServer) and ``cli.main``,
    on phase 7's root, chips, shards and mosaic (``share``)."""
    import urllib.request
    import torch
    from dl_image_segmentation_tpu_torch import kernels, storage
    from dl_image_segmentation_tpu_torch.catalog.httpserver import (
        SceneServer)
    from dl_image_segmentation_tpu_torch.catalog.stacserver import StacServer
    from dl_image_segmentation_tpu_torch.storage.fake_gcs import FakeGCS
    from dl_image_segmentation_tpu_torch.storage.fake_s3 import FakeS3

    log(f"phase 8: remote storage and catalogs on the card ({smi})")
    log(f"  urllib.request.getproxies(): {urllib.request.getproxies()}")
    out = {"seconds": {}, "launches": {c.name: 0 for c in kernels.COUNTERS}}
    secs = out["seconds"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_remote_")
    saved = {k: os.environ.get(k) for k in ("STORAGE_EMULATOR_HOST",
                                            "AWS_ENDPOINT_URL_S3")}

    def counted(argv, name):
        """One CLI call whose kernel launches count as phase 8's."""
        torch.cuda.synchronize()
        for c in kernels.COUNTERS:
            c.reset()
        lines = cli_run(argv, secs, name)
        torch.cuda.synchronize()
        for c in kernels.COUNTERS:
            out["launches"][c.name] += c.count
        return lines

    def must_equal(got, want, what):
        if not want or got != want:
            bad = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            raise AssertionError(f"{what}: {len(got)} files against "
                                 f"{len(want)}; differ: {bad[:4]}")

    try:
        with FakeGCS() as gcs, FakeS3() as s3:
            os.environ["STORAGE_EMULATOR_HOST"] = gcs.host
            os.environ["AWS_ENDPOINT_URL_S3"] = s3.endpoint
            s2 = with_flags(share["base"], max_cloud_fraction=0)
            with SceneServer(share["root"]) as srv:
                srv.fail_next(3)
                name = "create-chips http:// --batch-tiles 16"
                counted(with_flags(s2, catalog=srv.url, batch_tiles=16,
                                   out="gs://smoke/chips", device="cuda"),
                        name)
                got = objects_under(gcs, "smoke",
                                    f"chips/{share['s2_folder']}/")
                must_equal(got, share["s2_trees"][16],
                           "HTTP catalog -> gs:// against phase 7's export")
                tiles = len(got) // 2
                http = {"tiles": tiles, "tiles_per_s": tiles / secs[name],
                        "requests": srv.requests,
                        "range_gets_per_tile": srv.range_requests / tiles,
                        "bytes_per_tile": srv.bytes_served / tiles}
                out["http_export"] = http
                log(f"    {http['tiles_per_s']:.3f} tiles/s; "
                    f"{http['range_gets_per_tile']:.1f} ranged GETs and "
                    f"{http['bytes_per_tile'] / 2**20:.2f} MiB a tile "
                    f"({srv.requests} requests, 3 failed on purpose); "
                    f"{len(got)} GeoTIFFs == phase 7's card export; {smi}")
                cli_run(with_flags(share["rgb_argv"], catalog=srv.url,
                                   out="gs://smoke/rgb", device="cuda"),
                        secs, "create-chips http:// rgb")
            rgb = f"smoke/rgb/{os.path.basename(share['rgb_folder'])}"
            must_equal(objects_under(gcs, "smoke", rgb[len("smoke/"):] + "/"),
                       read_tree(share["rgb_folder"]),
                       "HTTP catalog rgb -> gs:// against phase 7's")

            t0 = time.perf_counter()
            n = stac_tree_from_root(share["root"], os.path.join(tmp, "stac"))
            secs["STAC tree"] = time.perf_counter() - t0
            log(f"  STAC tree of {n} items in {secs['STAC tree']:.3f} s")
            # card only: phase 7 holds its per-tile card export to the
            # CPU's bytes, and this export to phase 7's
            with StacServer(os.path.join(tmp, "stac"), api=True) as ss:
                dest = os.path.join(tmp, "stac-cuda")
                counted(with_flags(s2, catalog="stac+" + ss.url,
                                   batch_tiles=0, out=dest, device="cuda"),
                        "create-chips stac+http:// --device cuda")
                stac = read_tree(os.path.join(dest, share["s2_folder"]))
                out["stac_search_requests"] = ss.search_requests
            must_equal(stac, share["s2_trees"][0],
                       "STAC export against phase 7's per-tile export")
            log(f"    STAC (API mode, {out['stac_search_requests']} searches):"
                f" card bytes == phase 7's per-tile card export (== its "
                f"CPU's)")
            idle = [k for k, v in out["launches"].items() if not v]
            if idle:
                raise AssertionError(f"not launched in phase 8: {idle}")
            log(f"  launches in phase 8's card exports {out['launches']}")

            cli_run(["to-tfrecords", "--name", "smoke", "--directory",
                     f"gs://{rgb}", "--out", "s3://smoke/recs", "--shards",
                     "4", "--workers", "4", "--engine", "mp",
                     "--store-as-array"], secs, "to-tfrecords gs:// -> s3://")
            must_equal(objects_under(s3, "smoke", "recs/"),
                       read_tree(share["shards"]),
                       "s3:// shards against phase 7's local shards")
            pattern = "s3://smoke/recs/smoke-*"
            cli_run(["inspect", "--records", pattern, "--verify-crc"], secs,
                    "inspect s3://")
            local_pattern = os.path.join(share["shards"], "smoke-*")
            rates = {"local": [], "s3": []}
            for where in ("local", "s3", "s3", "local"):
                rates[where].append(feed_rate(
                    local_pattern if where == "local" else pattern, 32, 256))
            out["feed_records_per_s"] = rates
            log("  feed: tifarr records/s, local "
                + ", ".join(f"{r:.1f}" for r in rates["local"]) + "; s3:// "
                + ", ".join(f"{r:.1f}" for r in rates["s3"])
                + f" (turns: local, s3, s3, local; host)")

            mlog = os.path.join(tmp, "metrics.jsonl")
            lines = cli_run(["train", "--records", pattern, "--mode",
                             "tifarr", "--classes", "10", "--steps", "20",
                             "--log-every", "1", "--save-every", "10",
                             "--keep", "1", "--checkpoint",
                             "gs://smoke/ckpt", "--metrics-log", mlog,
                             "--device", "cuda"], secs, "train from s3://")
            losses = [json.loads(ln)["loss"] for ln in open(mlog)]
            if len(losses) != 20 or not np.mean(losses[-5:]) < losses[0]:
                raise AssertionError(f"train from s3://: losses {losses}")
            saved_at = [ln for ln in lines if "managed checkpoint saved" in ln]
            remote = sorted({k.split("/")[0] for k in
                             objects_under(gcs, "smoke", "ckpt/")})
            if remote != ["20"] or len(saved_at) != 2:
                raise AssertionError(f"checkpoints on gs://: {remote}; "
                                     f"saves {saved_at}")
            out["losses"] = losses
            out["losses_equal_phase_7"] = losses == share.get("losses")
            log(f"  loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean "
                f"of the last 5 of 20; equal to phase 7's from local shards: "
                f"{out['losses_equal_phase_7']}); gs://smoke/ckpt holds "
                f"{remote} after saves at 10 and 20 with --keep 1")

            ckpt = "gs://smoke/ckpt/20/default"
            local_ckpt = os.path.join(tmp, "20")
            storage.download_dir(ckpt, local_ckpt)
            inf = ["--classes", "10", "--device", "cuda"]
            cli_run(["predict", "--images", f"gs://{rgb}/images",
                     "--checkpoint", ckpt, "--scale", "none", "--out",
                     "gs://smoke/pred", *inf], secs, "predict gs://")
            cli_run(["predict", "--images",
                     os.path.join(share["rgb_folder"], "images"),
                     "--checkpoint", local_ckpt, "--scale", "none", "--out",
                     os.path.join(tmp, "pred"), *inf], secs, "predict local")
            must_equal(objects_under(gcs, "smoke", "pred/"),
                       read_tree(os.path.join(tmp, "pred")),
                       "predict from gs:// against the local checkpoint's")
            evals = []
            for recs, ck, where in ((pattern, ckpt, "s3:// + gs://"),
                                    (local_pattern, local_ckpt, "local")):
                lines = cli_run(["eval", "--records", recs, "--checkpoint",
                                 ck, "--json", *inf], secs, f"eval {where}")
                evals.append(json.loads(lines[-1]))
            if evals[0] != evals[1]:
                raise AssertionError(f"eval: {evals}")
            out["eval_miou"] = evals[0]["miou"]
            log(f"  predict and eval from gs:// == the local checkpoint's "
                f"({len(read_tree(os.path.join(tmp, 'pred')))} maps; mIoU "
                f"{evals[0]['miou']})")

            cli_run(["stitch", "--chips", f"gs://{rgb}/images", "--out",
                     "gs://smoke/mosaic.tif"], secs, "stitch gs:// -> gs://")
            with open(share["mosaic"], "rb") as f:
                if gcs.objects[("smoke", "mosaic.tif")] != f.read():
                    raise AssertionError("stitch: gs:// mosaic differs "
                                         "from phase 7's")
            sink = os.path.join(tmp, "sink")
            cli_run(["push", "--records", pattern, "--dest", sink], secs,
                    "push s3:// -> dir")
            shards = read_tree(share["shards"])
            with open(os.path.join(sink, "manifest.json")) as f:
                manifest = json.load(f)
            if sorted(manifest) != sorted(shards) or any(
                    read_tree(sink)[k] != v for k, v in shards.items()):
                raise AssertionError(f"push to a dir: {sorted(manifest)}")
            cli_run(["push", "--records", pattern, "--dest",
                     "gs://smoke/sink"], secs, "push s3:// -> gs://")
            pushed = objects_under(gcs, "smoke", "sink/")
            if json.loads(pushed.pop("manifest.json")) != manifest \
                    or pushed != shards:
                raise AssertionError(f"push to gs://: {sorted(pushed)}")
            with put_server() as (base, received):
                urls = os.path.join(tmp, "urls.json")
                with open(urls, "w") as f:
                    json.dump({k: f"{base}/up/{k}" for k in shards}, f)
                cli_run(["push", "--records", pattern, "--dest", urls],
                        secs, "push s3:// -> signed URLs")
            if received != {f"/up/{k}": v for k, v in shards.items()}:
                raise AssertionError(f"push to URLs: {sorted(received)}")
            log("  stitch gs:// == phase 7's mosaic; push to a dir, to "
                "gs:// and to signed URLs: every shard's bytes")
            out["fake_requests"] = {"gcs": gcs.requests, "s3": s3.requests}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def tree_files(folder, sub, ext):
    """{stem: path} of ``folder/sub/*.ext``."""
    import glob
    return {os.path.basename(p)[:-len(ext) - 1]: p for p in sorted(
        glob.glob(os.path.join(folder, sub, f"*.{ext}")))}


def rate(fn, items, min_s=0.5):
    """Calls of ``fn`` on each of ``items`` in turn for at least min_s
    seconds; (calls, seconds)."""
    n, t0 = 0, time.perf_counter()
    while True:
        for x in items:
            fn(x)
        n += len(items)
        dt_ = time.perf_counter() - t0
        if dt_ >= min_s:
            return n, dt_


def fed_step_ms(pattern, mode, size, steps=20):
    """Wall ms a step of ``Trainer.train_step`` at the TrainConfig
    defaults (10 classes, batch 32, bf16) fed by TFRecordFeed(mode) ->
    DevicePrefetcher, after 3 warm steps, synchronised at both ends."""
    import torch
    from dl_image_segmentation_tpu_torch.pipeline.input import (
        DevicePrefetcher, TFRecordFeed)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    t = Trainer(TrainConfig(num_classes=10))
    feed = TFRecordFeed(pattern, mode, 32, image_size=size, scale="raw",
                        seed=4)
    with DevicePrefetcher(iter(feed), t.place_batch) as pf:
        for _ in range(3):
            t.train_step_async(*next(pf))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            t.train_step_async(*next(pf))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    del t
    torch.cuda.empty_cache()
    return ms


def codec_phase(smi, tmp, share):
    """Phase 9: the PNG/JPEG chip path on the card, on phase 7's RGB
    chip folder (32 pairs of 256 px uint16 chips), through ``cli.main``:
    ``convert --to png --rescale`` (each PNG decodes to the rescaled
    GeoTIFF, labels pass through), ``to-tfrecords --engine mt`` (rgbraw:
    payloads == the files, CRCs checked; ``--store-as-array``: rgbarr;
    ``--png-to-jpg``: every JPEG payload decodes to its chip's shape and
    is the port's encode of its PNG's pixels), ``train`` with no
    ``--mode`` (rgbraw) and ``--mode rgbarr``, 20 steps each on one parse
    thread (falling loss; equal losses and bitwise equal parameters),
    3 fp32 steps card against CPU on a rgbraw batch, ``train`` from the
    JPEG shards (256 classes: JPEG's rounding moves label values at class
    edges; falling loss), a PredictServer answering the PNG chips and
    the port's JPEG encodes of them over HTTP (class maps == predict of
    the port's decode of each body; a corrupt PNG gets 400), and
    ``inspect --preview`` (the sheet decodes to render_pair_sheet of the
    first records). Times: PNG decode, JPEG decode and encode, convert,
    the MT writer, the rgbraw / rgbarr / tifarr feeds' records/s, and a
    fed train step from rgbraw and rgbarr shards."""
    import glob
    import io
    import threading
    import urllib.error
    import urllib.request
    import torch
    from dl_image_segmentation_tpu_torch.pipeline.convert import _to_uint8
    from dl_image_segmentation_tpu_torch.pipeline.input import (
        PARSE_FNS, TFRecordFeed)
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_image, decode_png, encode_jpeg)
    from dl_image_segmentation_tpu_torch.records.proto import decode_example
    from dl_image_segmentation_tpu_torch.records.tfrecord import read_records
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, make_http_server, scale_image)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    from dl_image_segmentation_tpu_torch.utils.preview import (
        render_pair_sheet)

    log(f"phase 9: PNG/JPEG chip path on the card ({smi})")
    os.makedirs(tmp, exist_ok=True)
    out = {"seconds": {}}
    secs = out["seconds"]
    folder = share["rgb_folder"]
    tifs = {sub: tree_files(folder, sub, "tif")
            for sub in ("images", "labels")}
    arrays = {k: read_geotiff(p).array for k, p in tifs["images"].items()}
    size = next(iter(arrays.values())).shape[0]
    lo = int(min(a.min() for a in arrays.values()))
    hi = int(max(a.max() for a in arrays.values()))
    # 1. convert --to png, rescaled to the scenes' range
    png = os.path.join(tmp, "png")
    cli_run(["convert", "--directory", folder, "--out", png, "--to", "png",
             "--rescale", str(lo), str(hi)], secs, "convert")
    pngs = {sub: tree_files(png, sub, "png") for sub in ("images", "labels")}
    share["png"] = png
    if sorted(pngs["images"]) != sorted(arrays) or len(arrays) != 32:
        raise AssertionError(f"convert wrote {len(pngs['images'])} images")
    for k, a in arrays.items():
        with open(pngs["images"][k], "rb") as f:
            got = decode_image(f.read())
        if not np.array_equal(got, _to_uint8(a, (lo, hi))):
            raise AssertionError(f"convert: {k}.png != the rescaled chip")
        with open(pngs["labels"][k], "rb") as f:
            got = decode_image(f.read())
        if not np.array_equal(got, read_geotiff(tifs["labels"][k]).array):
            raise AssertionError(f"convert: label {k}.png != its GeoTIFF")
    log(f"  convert --rescale {lo} {hi}: 64 PNGs, each == _to_uint8 of its "
        "GeoTIFF (labels unchanged)")
    # 2. the MT engine: rgbraw, rgbarr, --png-to-jpg
    shards = {}
    for kind, extra in (("rgbraw", []), ("rgbarr", ["--store-as-array"]),
                        ("jpg", ["--png-to-jpg"])):
        shards[kind] = os.path.join(tmp, f"mt-{kind}")
        cli_run(["to-tfrecords", "--name", "rgb", "--directory", png,
                 "--out", shards[kind], "--shards", "4", "--workers", "4",
                 "--engine", "mt", *extra], secs, f"to-tfrecords mt {kind}")
    recs = {}
    for kind, d in shards.items():
        recs[kind] = [decode_example(r) for f in sorted(glob.glob(
            os.path.join(d, "rgb-*"))) for r in read_records(f,
                                                             verify_crc=True)]
        if len(recs[kind]) != 32:
            raise AssertionError(f"{kind}: {len(recs[kind])} records")
    for d in recs["rgbraw"]:
        key = d["identifier"].bytes_list[0].decode().replace(":", "#")
        for sub, feat in (("images", "image/image_data"),
                          ("labels", "target/target_data")):
            with open(pngs[sub][key], "rb") as f:
                if d[feat].bytes_list[0] != f.read():
                    raise AssertionError(f"rgbraw {key}: {feat} != file")
    for d in recs["jpg"]:
        key = d["identifier"].bytes_list[0].decode().replace(":", "#")
        for sub, feat, bands in (("images", "image/image_data", 3),
                                 ("labels", "target/target_data", 1)):
            payload = d[feat].bytes_list[0]
            if decode_image(payload).shape != (size, size, bands):
                raise AssertionError(f"jpg {key}: {feat} shape")
            with open(pngs[sub][key], "rb") as f:
                if payload != encode_jpeg(decode_png(f.read()), 100):
                    raise AssertionError(f"jpg {key}: {feat} != the port's "
                                         "encode of its PNG")
    log("  to-tfrecords --engine mt: rgbraw payloads == the PNG files, "
        "CRCs checked; rgbarr; --png-to-jpg payloads == encode_jpeg(PNG "
        "pixels, 100), 32 records each")
    # 3. train with no --mode (rgbraw) and from rgbarr: the same arrays
    losses, params = {}, {}
    for kind, mode in (("rgbraw", []), ("rgbarr", ["--mode", "rgbarr"])):
        mlog = os.path.join(tmp, f"{kind}.jsonl")
        ckpt = os.path.join(tmp, f"{kind}.pt")
        cli_run(["train", "--records", os.path.join(shards[kind], "rgb-*"),
                 *mode, "--classes", "10", "--steps", "20", "--log-every",
                 "1", "--workers", "1", "--metrics-log", mlog,
                 "--checkpoint", ckpt], secs, f"train {kind}")
        losses[kind] = [json.loads(ln)["loss"] for ln in open(mlog)]
        params[kind] = torch.load(ckpt, weights_only=False)
    ls = losses["rgbraw"]
    if len(ls) != 20 or not np.mean(ls[-5:]) < ls[0]:
        raise AssertionError(f"train rgbraw: losses {ls}")
    if ls != losses["rgbarr"]:
        raise AssertionError(f"rgbraw losses {ls} != rgbarr "
                             f"{losses['rgbarr']}")
    pa, pb = (params[k]["params"] for k in ("rgbraw", "rgbarr"))
    if not all(torch.equal(pa[n], pb[n]) for n in pa):
        raise AssertionError("rgbraw and rgbarr runs end in other parameters")
    out["losses"] = ls
    log(f"  train (rgbraw, the default): loss {ls[0]:.4f} -> "
        f"{np.mean(ls[-5:]):.4f}; == the rgbarr run's losses, parameters "
        "bitwise equal")
    x, y = next(iter(TFRecordFeed(
        os.path.join(shards["rgbraw"], "rgb-*"), "rgbraw", 2,
        image_size=size, scale="raw", seed=5, num_workers=1)))
    cmp = card_vs_cpu_steps(TrainConfig(num_classes=10, batch_size=2,
                                        precision="fp32"), x, y)
    out["card_vs_cpu"] = cmp
    log(f"  card vs CPU, 3 fp32 steps on 2 rgbraw images: loss relative "
        f"differences {', '.join(f'{v:.3g}' for v in cmp['loss_rel_diff'])}"
        f"; largest parameter difference {cmp['max_param_diff']:.3g}")
    # 4. train from the JPEG shards
    mlog = os.path.join(tmp, "jpg.jsonl")
    cli_run(["train", "--records", os.path.join(shards["jpg"], "rgb-*"),
             "--classes", "256", "--steps", "20", "--log-every", "1",
             "--metrics-log", mlog], secs, "train jpg")
    lj = [json.loads(ln)["loss"] for ln in open(mlog)]
    if len(lj) != 20 or not np.mean(lj[-5:]) < lj[0]:
        raise AssertionError(f"train jpg: losses {lj}")
    moved = sum(int((decode_image(d["target/target_data"].bytes_list[0])
                     != decode_image(r["target/target_data"].bytes_list[0])
                     ).sum()) for d, r in zip(
        sorted(recs["jpg"], key=lambda d: d["identifier"].bytes_list[0]),
        sorted(recs["rgbraw"], key=lambda d: d["identifier"].bytes_list[0])))
    out["jpg_losses"], out["jpg_label_pixels_moved"] = lj, moved
    log(f"  train from --png-to-jpg shards (256 classes): loss {lj[0]:.4f} "
        f"-> {np.mean(lj[-5:]):.4f}; JPEG moved {moved} of "
        f"{32 * size * size} label pixels")
    # 5. serve PNG and JPEG bodies
    trainer = Trainer(TrainConfig(num_classes=10, batch_size=8))
    trainer.restore_checkpoint(os.path.join(tmp, "rgbraw.pt"))
    ps = PredictServer(trainer)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    keys = sorted(pngs["images"])[:8]
    bodies = []
    for k in keys:
        with open(pngs["images"][k], "rb") as f:
            body = f.read()
        bodies += [body, encode_jpeg(decode_png(body), 90)]
    served = [None] * len(bodies)

    def post(i):
        req = urllib.request.Request(base + "/predict", data=bodies[i],
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served[i] = np.load(io.BytesIO(r.read()))
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=300)
        secs["serve 16 bodies"] = time.perf_counter() - t0
        want = trainer.predict(np.stack([scale_image(decode_image(b), "auto")
                                         for b in bodies]))
        for i, got in enumerate(served):
            if got is None or not np.array_equal(got, want[i]):
                kind = "JPEG" if i % 2 else "PNG"
                raise AssertionError(f"served body {i} ({kind}) differs "
                                     "from predict")
        req = urllib.request.Request(base + "/predict",
                                     data=bodies[0][:-40], method="POST")
        try:
            urllib.request.urlopen(req, timeout=60)
            raise AssertionError("a corrupt PNG body was answered 200")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise AssertionError(f"corrupt PNG: HTTP {e.code}")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        ps.close()
    del trainer, ps
    torch.cuda.empty_cache()
    log(f"  serve: 8 PNG + 8 JPEG bodies in {secs['serve 16 bodies']:.3f} "
        "s, class maps == predict of the port's decode; corrupt PNG -> 400")
    # 6. inspect --preview
    sheet_path = os.path.join(tmp, "preview.png")
    pattern = os.path.join(shards["rgbraw"], "rgb-*")
    cli_run(["inspect", "--records", pattern, "--mode", "rgbraw",
             "--preview", sheet_path, "--preview-count", "4"], secs,
            "inspect --preview")
    first = [PARSE_FNS["rgbraw"](r) for r in read_records(sorted(
        glob.glob(pattern))[0])][:4]
    with open(sheet_path, "rb") as f:
        sheet = decode_image(f.read())
    if not np.array_equal(sheet, render_pair_sheet([(a, b)
                                                    for a, b, _ in first])):
        raise AssertionError("inspect --preview sheet != render_pair_sheet")
    log(f"  inspect --preview: {sheet.shape} sheet == render_pair_sheet of "
        "the first 4 records")
    # 7. times on the host and the fed step on the card
    blobs = []
    for k in sorted(pngs["images"]):
        with open(pngs["images"][k], "rb") as f:
            blobs.append(f.read())
    n, dt_ = rate(decode_png, blobs)
    mb = sum(map(len, blobs)) * n / len(blobs) / 1e6
    out["png_decode_mb_per_s"] = mb / dt_
    out["png_decode_mp_per_s"] = n * size * size / 1e6 / dt_
    jpgs = [encode_jpeg(decode_png(b), 100) for b in blobs]
    n, dt_ = rate(decode_image, jpgs)
    out["jpeg_decode_mp_per_s"] = n * size * size / 1e6 / dt_
    pix = [decode_png(b) for b in blobs]
    n, dt_ = rate(lambda a: encode_jpeg(a, 100), pix)
    out["jpeg_encode_mp_per_s"] = n * size * size / 1e6 / dt_
    out["feed_records_per_s"] = {
        "rgbraw": feed_rate(pattern, 8, size, "rgbraw"),
        "rgbarr": feed_rate(os.path.join(shards["rgbarr"], "rgb-*"), 8,
                            size, "rgbarr"),
        "tifarr": feed_rate(os.path.join(share["shards"], "smoke-*"), 8,
                            size)}
    out["fed_step_ms"] = {m: fed_step_ms(os.path.join(shards[m], "rgb-*"), m,
                                         size) for m in ("rgbraw", "rgbarr")}
    out["fed_images_per_s"] = {m: 32 / (v / 1e3)
                               for m, v in out["fed_step_ms"].items()}
    out["card"] = smi
    log(f"  PNG decode {out['png_decode_mb_per_s']:.1f} MB/s = "
        f"{out['png_decode_mp_per_s']:.2f} MP/s; JPEG ({size} px RGB, q100) "
        f"decode {out['jpeg_decode_mp_per_s']:.2f} MP/s, encode "
        f"{out['jpeg_encode_mp_per_s']:.2f} MP/s (one host thread of the "
        f"machine of {smi})")
    log(f"  convert {secs['convert']:.3f} s; MT to-tfrecords "
        f"{secs['to-tfrecords mt rgbraw']:.3f} s (rgbraw), "
        f"{secs['to-tfrecords mt rgbarr']:.3f} s (rgbarr), "
        f"{secs['to-tfrecords mt jpg']:.3f} s (--png-to-jpg); {smi}")
    log("  feed records/s (4 parse threads): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["feed_records_per_s"].items())
        + f"; {smi}")
    log("  fed train step (batch 32, bf16): " + ", ".join(
        f"{k} {v:.4f} ms = {out['fed_images_per_s'][k]:.1f} images/s"
        for k, v in out["fed_step_ms"].items()) + f"; {smi}")
    return out


CODEC_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data")
# the decodable RGB chips of phase 15, as (folder, file)
VARIANT_CHIPS = [("jpeg", "progressive.jpg"), ("jpeg", "arith.jpg"),
                 ("jpeg", "arith-progressive.jpg"), ("jpeg", "lossless.jpg"),
                 ("bmp", "rle8.bmp"), ("jp2", "sycc-420.jp2")]


def codec_variants_phase(smi, tmp):
    """Phase 15: the JPEG, BMP and JPEG 2000 variants (see the module
    docstring), on the committed fixtures."""
    import glob
    import io
    import threading
    import urllib.error
    import urllib.request
    import torch
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.pipeline.input import TFRecordFeed
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_image, decode_image_bytes, encode_jpeg, encode_png)
    from dl_image_segmentation_tpu_torch.records.proto import decode_example
    from dl_image_segmentation_tpu_torch.records.tfrecord import read_records
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, make_http_server, scale_image)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    log(f"phase 15: JPEG, BMP and JPEG 2000 variants ({smi})")
    os.makedirs(tmp, exist_ok=True)
    for c in kernels.COUNTERS:
        c.reset()
    out = {"seconds": {}, "card": smi}
    secs = out["seconds"]
    # (a) every fixture against its .npz
    paths = sorted(p for sub in ("jpeg", "bmp", "jp2")
                   for p in glob.glob(os.path.join(CODEC_DATA, sub, "*"))
                   if not p.endswith((".npz", ".c")))
    if len(paths) < 30:
        raise AssertionError(f"{len(paths)} codec fixtures in {CODEC_DATA}")
    decoded = refused = 0
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        ref = np.load(path.rsplit(".", 1)[0] + ".npz")
        name = os.path.basename(path)
        try:
            got, err = decode_image_bytes(data).array, None
        except Exception as e:  # noqa: BLE001 -- the outcome is compared
            got, err = None, (type(e).__name__, str(e).split(";")[0])
        if name == "smoothing.jpg":
            if err is None or err[0] != "UnsupportedFormatError" or \
                    "item 6" not in err[1]:
                raise AssertionError(f"{name}: {err}")
            refused += 1
        elif "array" in ref.files:
            want = ref["array"]
            if got is None or got.dtype != want.dtype or \
                    not np.array_equal(got, want):
                raise AssertionError(f"{name}: decode != its .npz ({err})")
            decoded += 1
        else:
            want = (str(ref["error_class"]), str(ref["error_prefix"]))
            if err != want:
                raise AssertionError(f"{name}: {err} != the JAX outcome "
                                     f"{want}")
            refused += 1
    out["fixtures"] = {"decoded": decoded, "refused": refused}
    log(f"  {decoded} fixtures decode bitwise to their .npz, {refused} "
        "raise the JAX package's class and prefix (one, block smoothing, "
        "names item 6)")
    # (b) a chip folder of the six RGB variants through cli.main
    chips = os.path.join(tmp, "chips")
    pix = {}
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(chips, sub))
    rng = np.random.RandomState(15)
    for i, (sub, name) in enumerate(VARIANT_CHIPS):
        with open(os.path.join(CODEC_DATA, sub, name), "rb") as f:
            data = f.read()
        arr = np.load(os.path.join(CODEC_DATA, sub,
                                   name.rsplit(".", 1)[0] + ".npz"))["array"]
        stem = f"128#2#10.0#43#{i}#3512"
        pix[stem.replace("#", ":")] = (name, data, arr)
        lbl = np.zeros(arr.shape[:2], np.uint8)
        lbl[arr[:, :, 0] > 128] = 1
        lbl[arr[:, :, 1] > 128] += 2
        for folder, body in (("images", data), ("labels", encode_png(lbl))):
            with open(os.path.join(chips, folder, f"{stem}.jpg"), "wb") as f:
                f.write(body)
    shards = os.path.join(tmp, "shards")
    cli_run(["to-tfrecords", "--name", "v", "--directory", chips, "--out",
             shards, "--shards", "2", "--workers", "2", "--engine", "mt"],
            secs, "to-tfrecords mt variants")
    recs = [decode_example(r) for f in sorted(glob.glob(
        os.path.join(shards, "v-*"))) for r in read_records(f,
                                                            verify_crc=True)]
    if len(recs) != len(VARIANT_CHIPS):
        raise AssertionError(f"{len(recs)} records")
    for d in recs:
        key = d["identifier"].bytes_list[0].decode()
        if d["image/image_data"].bytes_list[0] != pix[key][1]:
            raise AssertionError(f"rgbraw {pix[key][0]}: payload != file")
    pattern = os.path.join(shards, "v-*")
    x, _ = next(iter(TFRecordFeed(pattern, "rgbraw", len(VARIANT_CHIPS),
                                  image_size=128, scale="raw", seed=5,
                                  num_workers=1, shuffle_buffer=1)))
    want = sorted(a.astype(np.float32).tobytes() for _, _, a in pix.values())
    got = sorted(np.asarray(x[i], np.float32).tobytes()
                 for i in range(len(VARIANT_CHIPS)))
    if got != want:
        raise AssertionError("the first rgbraw batch != the .npz pixels")
    mlog = os.path.join(tmp, "train.jsonl")
    ckpt = os.path.join(tmp, "variants.pt")
    cli_run(["train", "--records", pattern, "--classes", "4",
             "--image-size", "128", "--steps", "5", "--log-every", "1",
             "--workers", "1", "--metrics-log", mlog, "--checkpoint", ckpt],
            secs, "train variants")
    ls = [json.loads(ln)["loss"] for ln in open(mlog)]
    if len(ls) != 5 or not all(math.isfinite(v) for v in ls) or \
            not ls[-1] < ls[0]:
        raise AssertionError(f"train from the variant shards: losses {ls}")
    out["losses"] = ls
    log(f"  to-tfrecords --engine mt: 6 rgbraw payloads == the files, CRCs "
        f"checked; first batch == the .npz pixels; train (bf16, 128 px, 4 "
        f"classes): loss {ls[0]:.4f} -> {ls[-1]:.4f} in 5 steps")
    # (c) the variants as request bodies
    trainer = Trainer(TrainConfig(num_classes=4, batch_size=8,
                                  image_size=128))
    trainer.restore_checkpoint(ckpt)
    ps = PredictServer(trainer)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/predict"

    def post(body):
        req = urllib.request.Request(base, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.load(io.BytesIO(r.read()))
    try:
        t0 = time.perf_counter()
        names = [n for n, _, _ in pix.values()]
        arrays = [a for _, _, a in pix.values()]
        want = trainer.predict(np.stack([scale_image(a, "auto")
                                         for a in arrays]))
        for i, (name, data, arr) in enumerate(pix.values()):
            got = post(data)
            png = post(encode_png(arr))
            if not (np.array_equal(got, want[i]) and
                    np.array_equal(png, want[i])):
                raise AssertionError(f"served {name} != predict of its "
                                     ".npz pixels (or of its PNG body)")
        with open(os.path.join(CODEC_DATA, "jpeg", "cmyk.jpg"), "rb") as f:
            cmyk = f.read()
        try:
            post(cmyk)
            raise AssertionError("a CMYK JPEG body was answered 200")
        except urllib.error.HTTPError as e:
            text = e.read()
            if e.code != 400 or b"expected 3-band raster" not in text:
                raise AssertionError(f"CMYK body: HTTP {e.code} {text!r}")
        secs["serve 6 variants + 6 PNG + CMYK"] = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        ps.close()
    del trainer, ps
    torch.cuda.empty_cache()
    log(f"  serve: {', '.join(names)} and PNG bodies of their pixels == "
        "predict of the .npz pixels; CMYK JPEG -> 400 (as the JAX server)")
    # (d) decode rates on one host thread
    rates = {}
    for name, data, arr in pix.values():
        n, dt_ = rate(decode_image, [data], min_s=0.3)
        base_jpg = encode_jpeg(arr, 90)
        nb, dtb = rate(decode_image, [base_jpg], min_s=0.3)
        mp = arr.shape[0] * arr.shape[1] / 1e6
        rates[name] = {"mp_per_s": n * mp / dt_,
                       "baseline_jpeg_q90_mp_per_s": nb * mp / dtb}
        rates[name]["ratio"] = (rates[name]["mp_per_s"] /
                                rates[name]["baseline_jpeg_q90_mp_per_s"])
    # the RLE8 chip beside an uncompressed 8-bit BMP of its indices (the
    # palette maps each index to one colour)
    name, data, arr = next(v for v in pix.values() if v[0] == "rle8.bmp")
    off = struct.unpack("<I", data[10:14])[0]
    pal = np.frombuffer(data[54:off], np.uint8).reshape(-1, 4)[:, 2::-1]
    keys = pal.astype(np.int64) @ np.array([65536, 256, 1])
    order = np.argsort(keys)
    flat = arr.reshape(-1, 3).astype(np.int64) @ np.array([65536, 256, 1])
    idx = order[np.searchsorted(keys[order], flat)].astype(np.uint8)
    h, w = arr.shape[:2]
    body = np.flipud(idx.reshape(h, w)).tobytes()  # w % 4 == 0: no padding
    raw8 = data[:2] + struct.pack("<I", off + len(body)) + data[6:30] + \
        struct.pack("<I", 0) + data[34:off] + body
    if not np.array_equal(decode_image(raw8), arr):
        raise AssertionError("the uncompressed BMP of the RLE8 chip's "
                             "indices decodes to other pixels")
    n, dt_ = rate(decode_image, [raw8], min_s=0.3)
    rates["rle8.bmp"]["uncompressed_8bit_bmp_mp_per_s"] = n * h * w / 1e6 / dt_
    out["decode"] = rates
    log("  decode MP/s on one host thread (128 px RGB; beside the baseline "
        "q90 JPEG of the same pixels): " + "; ".join(
            f"{k} {v['mp_per_s']:.2f} vs {v['baseline_jpeg_q90_mp_per_s']:.2f}"
            f" ({v['ratio']:.2f}x)" for k, v in rates.items()) + "; RLE8 "
        "beside its uncompressed 8-bit BMP "
        f"{rates['rle8.bmp']['uncompressed_8bit_bmp_mp_per_s']:.2f}; {smi}")
    out["fed_step_ms"] = fed_step_ms(pattern, "rgbraw", 128, steps=10)
    log(f"  fed train step from the variant shards (batch 32, bf16, 128 "
        f"px, 4 parse threads): {out['fed_step_ms']:.4f} ms; {smi}")
    out["launches"] = {c.name: c.count for c in kernels.COUNTERS}
    if any(out["launches"].values()):
        raise AssertionError(f"phase 15 launched a kernel: {out['launches']}")
    return out


PIL_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "pil")
PIL_CHIPS = ["chip128-webp-lossless.webp", "chip128-webp-lossy.webp",
             "chip128-tiff-lzw.tif", "chip128-tiff-jpeg.tif",
             "chip128-ppm.ppm", "chip128-tga-rle.tga", "chip128-pcx.pcx",
             "chip128-qoi.qoi"]


def _msg_prefix(msg):
    return re.split(r"[(<]", msg)[0].strip()


def pil_formats_phase(smi, tmp):
    """Phase 16: the formats PIL opens, through ``decode_png`` and
    ``decode_jpeg`` (see the module docstring), on the committed
    fixtures."""
    import glob
    import torch
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_jpeg, decode_png, encode_jpeg, encode_png)
    from dl_image_segmentation_tpu_torch.records.proto import decode_example
    from dl_image_segmentation_tpu_torch.records.tfrecord import read_records

    log(f"phase 16: the formats PIL opens, through decode_png / "
        f"decode_jpeg ({smi})")
    os.makedirs(tmp, exist_ok=True)
    for c in kernels.COUNTERS:
        c.reset()
    out = {"seconds": {}, "card": smi}
    secs = out["seconds"]
    t0 = time.perf_counter()
    # (a) every fixture against its .npz, through both functions
    paths = sorted(p for p in glob.glob(os.path.join(PIL_DATA, "*"))
                   if not p.endswith(".npz"))
    if len(paths) < 100:
        raise AssertionError(f"{len(paths)} fixtures in {PIL_DATA}")
    decoded, refused = {}, {}
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        ref = np.load(path.rsplit(".", 1)[0] + ".npz")
        name = os.path.basename(path)
        for fn in (decode_jpeg, decode_png):
            try:
                got, err = fn(data), None
            except Exception as e:  # noqa: BLE001 -- compared below
                got, err = None, (type(e).__name__, _msg_prefix(str(e)))
            if "array" in ref.files:
                want = ref["array"]
                if got is None or got.dtype.str != want.dtype.str or \
                        got.shape != want.shape or \
                        got.tobytes() != want.tobytes():
                    raise AssertionError(f"{name} ({fn.__name__}): decode "
                                         f"!= its .npz ({err})")
            else:
                cls = str(ref["error_class"])
                want = (cls, "" if cls == "AssertionError" else
                        _msg_prefix(str(ref["error_prefix"])))
                if err is None or (err[0], "" if err[0] == "AssertionError"
                                   else err[1]) != want:
                    raise AssertionError(f"{name} ({fn.__name__}): {err} != "
                                         f"the JAX outcome {want}")
        stem = name.split("-")[0]
        bucket = decoded if "array" in ref.files else refused
        bucket[stem] = bucket.get(stem, 0) + 1
    out["fixtures"] = {"decoded": decoded, "refused": refused}
    secs["fixtures"] = time.perf_counter() - t0
    log(f"  {sum(decoded.values())} fixtures decode bitwise to their .npz "
        f"through decode_jpeg and decode_png ({decoded}); "
        f"{sum(refused.values())} raise the JAX package's class and prefix "
        f"({refused})")
    # (b) the 128 px chips through cli.main: MT engine, decode mode
    chips = os.path.join(tmp, "chips")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(chips, sub))
    pix = {}
    for i, name in enumerate(PIL_CHIPS):
        with open(os.path.join(PIL_DATA, name), "rb") as f:
            data = f.read()
        arr = np.load(os.path.join(PIL_DATA, name.rsplit(".", 1)[0]
                                   + ".npz"))["array"]
        stem = f"128#2#10.0#43#{i}#3512"
        ext = "png" if i % 2 else "jpg"
        pix[stem.replace("#", ":")] = (name, data, arr)
        lbl = np.zeros(arr.shape[:2], np.uint8)
        lbl[arr[:, :, 0] > 128] = 1
        lbl[arr[:, :, 1] > 128] += 2
        for folder, body in (("images", data), ("labels", encode_png(lbl))):
            with open(os.path.join(chips, folder, f"{stem}.{ext}"),
                      "wb") as f:
                f.write(body)
    shards = os.path.join(tmp, "shards")
    cli_run(["to-tfrecords", "--name", "p", "--directory", chips, "--out",
             shards, "--shards", "2", "--workers", "2", "--engine", "mt",
             "--store-as-array"], secs, "to-tfrecords mt --store-as-array")
    recs = [decode_example(r) for f in sorted(glob.glob(
        os.path.join(shards, "p-*"))) for r in read_records(f,
                                                            verify_crc=True)]
    if len(recs) != len(PIL_CHIPS):
        raise AssertionError(f"{len(recs)} records of {len(PIL_CHIPS)}")
    for d in recs:
        key = d["identifier"].bytes_list[0].decode()
        if d["image/image_data"].bytes_list[0] != pix[key][2].tobytes():
            raise AssertionError(f"rgbarr {pix[key][0]}: record pixels != "
                                 "its .npz")
    pattern = os.path.join(shards, "p-*")
    mlog = os.path.join(tmp, "train.jsonl")
    cli_run(["train", "--records", pattern, "--mode", "rgbarr", "--classes",
             "4", "--image-size", "128", "--steps", "5", "--log-every", "1",
             "--workers", "1", "--metrics-log", mlog], secs,
            "train rgbarr from the PIL-format chips")
    ls = [json.loads(ln)["loss"] for ln in open(mlog)]
    if len(ls) != 5 or not all(math.isfinite(v) for v in ls) or \
            not ls[-1] < ls[0]:
        raise AssertionError(f"train from the PIL-format shards: losses {ls}")
    out["losses"] = ls
    torch.cuda.empty_cache()
    log(f"  to-tfrecords --engine mt --store-as-array: {len(recs)} records, "
        f"CRCs checked, pixels == the .npz; train --mode rgbarr (bf16, 128 "
        f"px, 4 classes): loss {ls[0]:.4f} -> {ls[-1]:.4f} in 5 steps")
    # (c) decode rates on one host thread
    rates = {}
    for name, data, arr in pix.values():
        n, dt_ = rate(decode_jpeg, [data], min_s=0.3)
        base = encode_jpeg(arr, 90)
        nb, dtb = rate(decode_jpeg, [base], min_s=0.3)
        mp = arr.shape[0] * arr.shape[1] / 1e6
        rates[name] = {"mp_per_s": n * mp / dt_,
                       "baseline_jpeg_q90_mp_per_s": nb * mp / dtb}
        rates[name]["ratio"] = (rates[name]["mp_per_s"] /
                                rates[name]["baseline_jpeg_q90_mp_per_s"])
    out["decode"] = rates
    log("  decode_jpeg MP/s on one host thread (128 px RGB; beside the "
        "baseline q90 JPEG of the same pixels): " + "; ".join(
            f"{k} {v['mp_per_s']:.2f} vs {v['baseline_jpeg_q90_mp_per_s']:.2f}"
            f" ({v['ratio']:.2f}x)" for k, v in rates.items()) + f"; {smi}")
    out["launches"] = {c.name: c.count for c in kernels.COUNTERS}
    if any(out["launches"].values()):
        raise AssertionError(f"phase 16 launched a kernel: {out['launches']}")
    return out


# A 64 x 48 RGB codestream PIL wrote with the 9/7 wavelet, the ICT and
# one layer at rate 12 (OpenJPEG 2.5.4), and the SHA-256 of PIL's decode
# of it: the float path's bits on the card's host, which has no PIL.
J2K_97_B64 = (
    "/0//UQAvAAAAAABAAAAAMAAAAAAAAAAAAAAAQAAAADAAAAAAAAAAAAADBwEBBwEBBwEB"
    "/1IADAAAAAEBAwQEAAD/XAAXQmc4Z1BnUGdoUAVQBVBHV9NX01di/2QAJQABQ3JlYXRl"
    "ZCBieSBPcGVuSlBFRyB2ZXJzaW9uIDIuNS40/5AACgAAAAACgQAB/5PH2GQX4HKbQ+p1"
    "eZ059914+6kf/2Zut9qxXjsTtCMRUT2aJJxki2L29VSJWtRMmK0TjEbykMPrISutf9OR"
    "9F0DVbh/SYU2O+kBzUgcyJLgiz+eqFxZO98MQ8PrHic4gIfdZSqU9a0foLH+Exv3XH7z"
    "XVJAtefFQTViasD5SsHzFQA0fNu0ZRkWAIIRMRWmQwMZXfOuty5Ai6CAcgW/5u8b2Xta"
    "prkpDlgM4CHAPHwBxYA17jFTOKyyHPQaYSPmp38dyV4Mj0UBwHIz7cH0FAA2nSFd5Q+P"
    "AKftfnaX5ml3TQCBJcBWQfI7gOVwFKJl9bHugvIGNiYIjKJ2CV38tVHfiwROyrGchjW3"
    "8HIS+xZ4yEIpc3/YSlvL8ythblS+hWr+lW4zlEElyP7kj0f6cFG+FrAsaw+K+0eYE9/e"
    "An0O5t5w4VfzEdBTBcDykBVwFUBdoNIK1lG/HD/2u/jB32OXjU+gbQwUttL/bzPdKWmF"
    "EoiP42rgVS1428HwEABfp8G4brjxVMBbsDtTAWyADilkpbo/GX9sYBcMeHKaV9wLoipU"
    "aenzutGjv9bZzqul9lP+TrkJLF18sTk57vi8cFhKOBKWqYoJfdpd3CVKutwy0yl9AVL0"
    "NRmFP3lgReqw0Cmj8ZjbnfbYAEgRxiHAc3sBaoAw+hhhZvLqaytjSb1pSZ7yrlLtkcO9"
    "nZJanGUsuZdjfaqtL3PnWHTcdhqX8EJIHE7KtsBZZluWFpJx3GB3PJCNRFfeWc61BY+g"
    "5fnTdkdmORaZwO1gw846YP8FkFXvq2zygE2+61BrSMTF9eCfgLMVCoSpSJGTLfiNnlNQ"
    "qOT88V7/2Q==")
J2K_97_SHA256 = ("7d0db5fe44f6c3b0377177bf56411a4b"
                 "07ee28618cf610a4a344d47b2662e8f8")

S2_SAFE_BANDS = {"B01": 60.0, "B02": 10.0, "B03": 10.0, "B04": 10.0,
                 "B05": 20.0, "B06": 20.0, "B07": 20.0, "B08": 10.0,
                 "B8A": 20.0, "B09": 60.0, "B10": 60.0, "B11": 20.0,
                 "B12": 20.0}


def gml_box(gt, epsg, w, h):
    """A GMLJP2 ``xml `` box (RectifiedGrid origin, offset vectors, EPSG
    srsName): the Sentinel-2 convention."""
    import struct
    srs = f'srsName="urn:ogc:def:crs:EPSG::{epsg}"'
    xml = (f'<gml:FeatureCollection><gml:RectifiedGrid dimension="2">'
           f'<gml:limits><gml:GridEnvelope><gml:low>0 0</gml:low>'
           f'<gml:high>{w - 1} {h - 1}</gml:high></gml:GridEnvelope>'
           f'</gml:limits><gml:origin><gml:Point gml:id="p" {srs}>'
           f'<gml:pos>{gt[0]} {gt[3]}</gml:pos></gml:Point></gml:origin>'
           f'<gml:offsetVector {srs}>{gt[1]} {gt[2]}</gml:offsetVector>'
           f'<gml:offsetVector {srs}>{gt[4]} {gt[5]}</gml:offsetVector>'
           f'</gml:RectifiedGrid></gml:FeatureCollection>').encode()
    return struct.pack(">I", 8 + len(xml)) + b"xml " + xml


def l1c_band(rng, h, w):
    """12-bit L1C-like DNs: a smooth field (bilinear over a 40 px grid)
    plus a few DNs of noise, nodata 0 in 64 px blotches."""
    gh, gw = h // 40 + 2, w // 40 + 2
    coarse = rng.rand(gh, gw)
    yi, xi = np.linspace(0, gh - 1.001, h), np.linspace(0, gw - 1.001, w)
    y0, x0 = yi.astype(int), xi.astype(int)
    fy, fx = (yi - y0)[:, None], (xi - x0)[None, :]
    f = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
         + coarse[y0 + 1][:, x0] * fy * (1 - fx)
         + coarse[y0][:, x0 + 1] * (1 - fy) * fx
         + coarse[y0 + 1][:, x0 + 1] * fy * fx)
    arr = (300 + 3000 * f + rng.randint(0, 24, (h, w))).astype(np.uint16)
    blot = np.kron(rng.rand(h // 64 + 1, w // 64 + 1) < 0.04,
                   np.ones((64, 64), bool))[:h, :w]
    arr[blot] = 0
    return arr


def write_safe(tmp, x0, y0, span, nx, ny):
    """A reduced Sentinel-2 L1C ``.SAFE`` product, written by the port's
    ``encode_jp2`` (lossless 5/3): 2 granules on 2 dates in zone 43, each
    with the 13 bands at their own resolution (10, 20, 60 m) and a
    ``_TCI.jp2`` preview that ingestion must skip; the first granule
    carries GeoJP2 boxes, the second a GMLJP2 ``xml `` box. A real granule is
    10,980 px square at 10 m (109.8 km); this one is cut to the nx x ny
    tiles of ``span`` metres whose corner is (x0, y0) plus one tile on
    every side, about 2,600 x 1,560 px at 10 m, on a 60 m grid so that
    every resolution tiles it exactly. Encodes on 8 threads. Returns
    (SAFE directory, {band file: array}, seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from dl_image_segmentation_tpu_torch.raster.jp2 import encode_jp2
    safe = os.path.join(tmp, "S2A_MSIL1C_20201015T053641_N0209_R005_"
                             "T43QBB_20201015T070000.SAFE")
    jobs = []
    for k in range(2):
        date = dt.date(2020, 10, 1) + dt.timedelta(days=10 * k)
        stamp = f"{date:%Y%m%d}T053641"
        img = os.path.join(safe, "GRANULE",
                           f"L1C_T43QBB_A02{7000 + k}_{stamp}", "IMG_DATA")
        os.makedirs(img)
        ox = math.floor((x0 - span) / 60.0) * 60.0 - 60.0 * k
        oy = math.ceil((y0 + (ny + 1) * span) / 60.0) * 60.0 + 60.0 * k
        w60 = math.ceil((x0 + (nx + 1) * span - ox) / 60.0) + k
        h60 = math.ceil((oy - (y0 - span)) / 60.0) + k
        rng = np.random.RandomState(90 + k)
        for band, res in S2_SAFE_BANDS.items():
            f = int(60.0 / res)
            arr = l1c_band(rng, h60 * f, w60 * f)
            gt = (ox, res, 0.0, oy, 0.0, -res)
            jobs.append((os.path.join(img, f"T43QBB_{stamp}_{band}.jp2"), arr,
                         gt, k == 1))
        jobs.append((os.path.join(img, f"T43QBB_{stamp}_TCI.jp2"),
                     rng.randint(0, 256, (64, 64, 3)).astype(np.uint8), None,
                     False))

    def write(job):
        path, arr, gt, gml = job
        if gt is None:
            data = encode_jp2(arr)
        elif gml:
            plain = encode_jp2(arr)
            at = plain.index(b"jp2c") - 4
            data = plain[:at] + gml_box(gt, 32643, arr.shape[1],
                                        arr.shape[0]) + plain[at:]
        else:
            data = encode_jp2(arr, geotransform=gt, epsg=32643, nodata=0)
        with open(path, "wb") as fh:
            fh.write(data)
        return path, arr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        arrays = dict(ex.map(write, jobs))
    return safe, arrays, time.perf_counter() - t0


def safe_phase(smi, tmp, share):
    """Phase 10: JPEG 2000 and Sentinel-2 ``.SAFE`` ingestion on the
    card, through ``cli.main``: a reduced SAFE tree (``write_safe``) ->
    ``ingest-safe`` -> ``create-chips --max-cloud-fraction 0`` over phase
    7's AOI at ``--batch-tiles`` 16 and 0, on the card and with
    ``--device cpu`` (card bytes == CPU bytes, 64 GeoTIFFs a run, K1-K3
    launched on the card, gather errors raised with DLSEG_DEBUG); every
    band file decodes to the array encoded. Then phase 9's PNG chips and
    labels re-encoded as JP2 pairs (georeferenced as phase 7's GeoTIFF
    chips), ``to-tfrecords --file-ext jp2`` raw (tifraw: payloads == the
    files) and ``--store-as-array`` (its records hold the decoded pixels;
    uint8 arrays take the rgbarr layout), CRCs checked; tifarr records
    (FloatList) of the tifraw records' decoded pixels, in their order;
    ``train --mode tifraw`` and ``--mode tifarr`` at the TrainConfig
    defaults with 10 classes, 10 steps on one parse thread (falling loss,
    equal losses, bitwise equal parameters); a PredictServer answering 8 JP2
    bodies (class maps == predict of the port's decode; a corrupt JP2
    gets 400). Times: JP2 decode and encode MP/s on one host thread (a
    10 m band, a 256² RGB chip), ingest-safe seconds, the tifraw feed's
    records/s and a fed step from tifraw shards."""
    import glob
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.geo import Tile
    from dl_image_segmentation_tpu_torch.raster.jp2 import decode_jp2

    log(f"phase 10: JPEG 2000 and .SAFE ingestion on the card ({smi})")
    os.makedirs(tmp, exist_ok=True)
    out = {"seconds": {}, "exports": []}
    secs = out["seconds"]
    x0, y0, _, _ = Tile(256, 2, 10.0, 43, -10, 1400).bounds_unpadded
    safe, arrays, secs["write SAFE"] = write_safe(tmp, x0, y0, 2560.0, 8, 4)
    px = sum(a.size for a in arrays.values())
    log(f"  SAFE tree: 2 granules x 13 bands + TCI, {px / 1e6:.1f} MP, "
        f"{sum(os.path.getsize(p) for p in arrays) / 2**20:.1f} MiB of JP2, "
        f"encoded in {secs['write SAFE']:.3f} s on 8 threads")
    root = os.path.join(tmp, "catalog")
    lines = cli_run(["ingest-safe", "--catalog", root, "--safe", safe,
                     "--cloud-fraction", "0"], secs, "ingest-safe")
    with open(os.path.join(root, "index.json")) as f:
        scenes = json.load(f)["products"]["sentinel-2:L1C"]["scenes"]
    if len(scenes) != 2 or any(len(s["band_paths"]) != 13 for s in scenes) \
            or any("TCI" in p for s in scenes
                   for p in s["band_paths"].values()):
        raise AssertionError(f"ingest-safe: {lines}")
    base = with_flags(share["base"], bands=" ".join(S2_SAFE_BANDS),
                      catalog=root)
    launches = {c.name: 0 for c in kernels.COUNTERS}
    trees = {}

    def export(device, batch):
        return base + ["--out", os.path.join(tmp, f"safe-{device}-{batch}"),
                       "--max-cloud-fraction", "0", "--batch-tiles",
                       str(batch), "--device", device]

    def collect(device, batch):
        name = f"create-chips SAFE {device} --batch-tiles {batch}"
        folder, = glob.glob(os.path.join(tmp, f"safe-{device}-{batch}",
                                         "*"))
        trees[(device, batch)] = read_tree(folder)
        run = {"device": device, "batch_tiles": batch, "tiles": 32,
               "seconds": secs[name], "tiles_per_s": 32 / secs[name]}
        out["exports"].append(run)
        log(f"    {name}: {run['tiles_per_s']:.3f} tiles/s on "
            f"{smi if device == 'cuda' else 'the host CPU'}")

    os.environ["DLSEG_DEBUG"] = "1"
    # the CPU exports run on a thread beside the card's exports and the
    # JP2 shards and training below; their chips are held to the card's
    # before the phase ends
    cpu = CliBeside([(f"create-chips SAFE cpu --batch-tiles {b}",
                      export("cpu", b)) for b in (16, 0)], secs)
    try:
        for batch in (16, 0):
            torch.cuda.synchronize()
            for c in kernels.COUNTERS:
                c.reset()
            cli_run(export("cuda", batch), secs,
                    f"create-chips SAFE cuda --batch-tiles {batch}")
            torch.cuda.synchronize()
            for c in kernels.COUNTERS:
                launches[c.name] += c.count
            collect("cuda", batch)
        jp2_chip_path(smi, tmp, share, out, next(
            a for p, a in arrays.items() if p.endswith("_B02.jp2")))
    finally:
        cpu.join()
        del os.environ["DLSEG_DEBUG"]
    for batch in (16, 0):
        collect("cpu", batch)
    for batch in (16, 0):
        ref, got = trees[("cpu", batch)], trees[("cuda", batch)]
        if len(ref) != 64 or got != ref:
            bad = [k for k in ref if got.get(k) != ref[k]][:3]
            raise AssertionError(f"SAFE export batch_tiles={batch}: "
                                 f"{len(ref)} files; card's bytes differ "
                                 f"from the CPU's {bad}")
    for name in ("masked_median", "burn_dense", "burn_binned"):
        if launches[name] == 0:
            raise AssertionError(f"{name}: not launched by the SAFE export")
    out["launches"] = launches
    import base64
    import hashlib
    got = decode_jp2(base64.b64decode(J2K_97_B64)).array
    if hashlib.sha256(got.tobytes()).hexdigest() != J2K_97_SHA256:
        raise AssertionError("the 9/7 codestream decodes to other bits than "
                             "OpenJPEG's")

    def lossless(item):
        path, arr = item
        with open(path, "rb") as fh:
            got = decode_jp2(fh.read()).array
        return np.array_equal(got.reshape(arr.shape), arr)
    with ThreadPoolExecutor(8) as ex:
        if not all(ex.map(lossless, arrays.items())):
            raise AssertionError("a SAFE band file does not decode to the "
                                 "array encoded")
    log(f"  SAFE export: card == CPU bytes per tile and batched (64 "
        f"GeoTIFFs each); launches on the card {launches}; {len(arrays)} "
        "JP2 files decode to the arrays encoded; a 9/7 RGB file decodes "
        "to OpenJPEG's bits")
    return out


def jp2_chip_path(smi, tmp, share, out, band):
    """Phase 10's second half: phase 9's PNG chips and labels as JP2
    pairs (georeferenced as phase 7's GeoTIFF chips) through the MP
    engine, training, serving, and the codec's times on ``band`` (a 10 m
    SAFE band) and a chip; fills ``out``."""
    import glob
    import io
    import threading
    import urllib.error
    import urllib.request
    import torch
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_image, decode_png)
    from dl_image_segmentation_tpu_torch.raster.jp2 import (
        decode_jp2, encode_jp2)
    from dl_image_segmentation_tpu_torch.records.example import (
        write_example_framed)
    from dl_image_segmentation_tpu_torch.records.parsers import (
        parse_8bit_array_proto, parse_encoded_gdal_proto_eager)
    from dl_image_segmentation_tpu_torch.records.proto import decode_example
    from dl_image_segmentation_tpu_torch.records.tfrecord import (
        TFRecordWriter, read_records)
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, make_http_server, scale_image)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    secs = out["seconds"]
    png = share["png"]
    tifs = tree_files(share["rgb_folder"], "images", "tif")
    chips = os.path.join(tmp, "jp2-chips")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(chips, sub))
        for k, p in tree_files(png, sub, "png").items():
            info = read_geotiff(tifs[k]).info
            with open(p, "rb") as fh:
                a = decode_png(fh.read())
            with open(os.path.join(chips, sub, f"{k}.jp2"), "wb") as fh:
                fh.write(encode_jp2(a, geotransform=info.geotransform,
                                    epsg=info.epsg))
    jp2s = {sub: tree_files(chips, sub, "jp2") for sub in ("images",
                                                           "labels")}
    size = decode_image(open(next(iter(jp2s["images"].values())),
                             "rb").read()).shape[0]
    shards = {}
    for kind, extra in (("tifraw", []), ("array", ["--store-as-array"])):
        shards[kind] = os.path.join(tmp, f"jp2-{kind}")
        cli_run(["to-tfrecords", "--name", "jp2", "--directory", chips,
                 "--out", shards[kind], "--shards", "4", "--workers", "4",
                 "--engine", "mp", "--file-ext", "jp2", *extra], secs,
                f"to-tfrecords jp2 {kind}")
        recs = [r for f in sorted(glob.glob(os.path.join(
            shards[kind], "jp2-*"))) for r in read_records(f,
                                                           verify_crc=True)]
        if len(recs) != 32:
            raise AssertionError(f"{kind}: {len(recs)} records")
        for r in recs:
            d = decode_example(r)
            key = d["identifier"].bytes_list[0].decode().replace(":", "#")
            if kind == "tifraw":
                for sub, feat in (("images", "image/image_data"),
                                  ("labels", "target/target_data")):
                    with open(jp2s[sub][key], "rb") as fh:
                        if d[feat].bytes_list[0] != fh.read():
                            raise AssertionError(f"tifraw {key}: {feat} "
                                                 "!= the file")
            else:
                img, lbl, _ = parse_8bit_array_proto(r)
                for sub, a in (("images", img), ("labels", lbl)):
                    with open(jp2s[sub][key], "rb") as fh:
                        want = decode_jp2(fh.read()).array
                    if not np.array_equal(a, want.reshape(a.shape)):
                        raise AssertionError(f"--store-as-array {key}: "
                                             f"{sub} != the decoded JP2")
    # the MP engine stores uint8 arrays as bytes (the rgbarr layout,
    # which the step scales by 1/255); tifarr records (FloatList) of the
    # same pixels, in the tifraw shards' names and order
    shards["tifarr"] = os.path.join(tmp, "jp2-tifarr")
    os.makedirs(shards["tifarr"])
    for f in sorted(glob.glob(os.path.join(shards["tifraw"], "jp2-*"))):
        w = TFRecordWriter(os.path.join(shards["tifarr"],
                                        os.path.basename(f)))
        for r in read_records(f, verify_crc=True):
            img, lbl, ident = parse_encoded_gdal_proto_eager(r)
            write_example_framed(w.fileobj, img.astype(np.float32),
                                 lbl[:, :, 0].astype(np.float32), *img.shape,
                                 *lbl.shape[:2], ident)
        w.close()
    log("  to-tfrecords --file-ext jp2: tifraw payloads == the JP2 files, "
        "--store-as-array pixels == their decode (uint8: the rgbarr "
        "layout); 32 records each, CRCs checked; tifarr (FloatList) "
        "shards of the same pixels")
    losses, params = {}, {}
    for kind in ("tifraw", "tifarr"):
        mlog = os.path.join(tmp, f"{kind}.jsonl")
        ckpt = os.path.join(tmp, f"{kind}.pt")
        # 5 steps: each tifraw step waits on the host's JP2 decode
        cli_run(["train", "--records", os.path.join(shards[kind], "jp2-*"),
                 "--mode", kind, "--classes", "10", "--steps", "5",
                 "--log-every", "1", "--workers", "1", "--metrics-log", mlog,
                 "--checkpoint", ckpt], secs, f"train {kind}")
        losses[kind] = [json.loads(ln)["loss"] for ln in open(mlog)]
        params[kind] = torch.load(ckpt, weights_only=False)
    ls = losses["tifraw"]
    if len(ls) != 5 or not np.mean(ls[-3:]) < ls[0]:
        raise AssertionError(f"train tifraw: losses {ls}")
    if ls != losses["tifarr"]:
        raise AssertionError(f"tifraw losses {ls} != tifarr "
                             f"{losses['tifarr']}")
    pa, pb = (params[k]["params"] for k in ("tifraw", "tifarr"))
    if not all(torch.equal(pa[n], pb[n]) for n in pa):
        raise AssertionError("tifraw and tifarr runs end in other parameters")
    out["losses"] = ls
    log(f"  train --mode tifraw (JP2 payloads): loss {ls[0]:.4f} -> "
        f"{np.mean(ls[-3:]):.4f}; == the tifarr run's losses, parameters "
        "bitwise equal")
    # serve JP2 bodies
    trainer = Trainer(TrainConfig(num_classes=10, batch_size=8))
    trainer.restore_checkpoint(os.path.join(tmp, "tifraw.pt"))
    ps = PredictServer(trainer)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    bodies = []
    for k in sorted(jp2s["images"])[:8]:
        with open(jp2s["images"][k], "rb") as fh:
            bodies.append(fh.read())
    served = [None] * len(bodies)

    def post(i):
        req = urllib.request.Request(url, data=bodies[i], method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served[i] = np.load(io.BytesIO(r.read()))
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=300)
        secs["serve 8 JP2 bodies"] = time.perf_counter() - t0
        want = trainer.predict(np.stack([scale_image(decode_image(b), "auto")
                                         for b in bodies]))
        for i, got in enumerate(served):
            if got is None or not np.array_equal(got, want[i]):
                raise AssertionError(f"served JP2 body {i} differs from "
                                     "predict")
        req = urllib.request.Request(url, data=bodies[0][:-200],
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=60)
            raise AssertionError("a corrupt JP2 body was answered 200")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise AssertionError(f"corrupt JP2: HTTP {e.code}")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        ps.close()
    del trainer, ps
    torch.cuda.empty_cache()
    log(f"  serve: 8 JP2 bodies in {secs['serve 8 JP2 bodies']:.3f} s, "
        "class maps == predict of the port's decode; corrupt JP2 -> 400")
    # times
    chip = decode_png(open(next(iter(tree_files(png, "images",
                                                "png").values())),
                           "rb").read())
    band_bytes, chip_bytes = encode_jp2(band), encode_jp2(chip)
    out["jp2_mp_per_s"] = {}
    for what, fn, x, arr in (("decode", decode_jp2, band_bytes, band),
                             ("encode", encode_jp2, band, band),
                             ("decode", decode_jp2, chip_bytes, chip),
                             ("encode", encode_jp2, chip, chip)):
        n, dt_ = rate(fn, [x])
        key = f"{what} {'10 m band' if arr is band else f'{size}² RGB chip'}"
        out["jp2_mp_per_s"][key] = n * arr.shape[0] * arr.shape[1] / 1e6 / dt_
    pattern = os.path.join(shards["tifraw"], "jp2-*")
    out["feed_records_per_s"] = {
        "tifraw": feed_rate(pattern, 8, size, "tifraw"),
        "tifarr": feed_rate(os.path.join(shards["tifarr"], "jp2-*"), 8,
                            size)}
    out["fed_step_ms"] = {"tifraw": fed_step_ms(pattern, "tifraw", size,
                                                steps=8)}
    out["fed_images_per_s"] = {m: 32 / (v / 1e3)
                               for m, v in out["fed_step_ms"].items()}
    out["card"] = smi
    log("  JP2 on one host thread: " + ", ".join(
        f"{k} {v:.2f} MP/s" for k, v in out["jp2_mp_per_s"].items())
        + f" ({band.shape[1]} x {band.shape[0]} uint16 band); host of {smi}")
    log(f"  ingest-safe {secs['ingest-safe']:.3f} s; SAFE export "
        + ", ".join(f"{r['device']} --batch-tiles {r['batch_tiles']} "
                    f"{r['seconds']:.3f} s" for r in out["exports"])
        + f"; {smi}")
    log("  feed records/s (4 parse threads): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["feed_records_per_s"].items())
        + f"; fed train step (batch 32, bf16) tifraw "
        f"{out['fed_step_ms']['tifraw']:.4f} ms = "
        f"{out['fed_images_per_s']['tifraw']:.1f} images/s; {smi}")
    return out


ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "orbax_unet")


def flat_tree(tree, prefix=""):
    """{"opt_state/1/0/mu/...": array} of a tree of train/orbax.py."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}/"))
    return out


def tree_bytes(tree) -> int:
    return sum(np.asarray(v).nbytes for v in flat_tree(tree).values())


def remat_pair(cfg, x, y, smi):
    """(c): one bf16 step with remat and one without, from one state and
    batch: losses and gradients bitwise equal; then each step's warm
    CUDA-event ms and max memory allocated."""
    import dataclasses
    import torch
    from dl_image_segmentation_tpu_torch.train import Trainer
    plain = Trainer(cfg)
    remat = Trainer(dataclasses.replace(cfg, remat=True))
    remat.model.load_state_dict(plain.model.state_dict())
    out = {}
    for name, t in (("plain", plain), ("remat", remat)):
        out[f"{name}_loss"] = t.train_step(x, y)["loss"]
    if out["plain_loss"] != out["remat_loss"]:
        raise AssertionError(f"remat step: loss {out['remat_loss']} != "
                             f"{out['plain_loss']}")
    bad = [n for n, p in plain.state.params.items()
           if not torch.equal(p.grad, remat.state.params[n].grad)]
    if bad:
        raise AssertionError(f"remat step: gradients differ: {bad[:4]}")
    for name, t in (("plain", plain), ("remat", remat)):
        step = lambda: t.train_step_async(x, y)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[f"{name}_ms"] = cuda_ms(step, 5)
        out[f"{name}_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["ms_ratio"] = out["remat_ms"] / out["plain_ms"]
    out["memory_ratio"] = (out["remat_max_memory_allocated"]
                           / out["plain_max_memory_allocated"])
    log(f"  (c) remat step at bf16, batch {x.shape[0]}: loss and every "
        f"gradient bitwise equal to the plain step; {out['remat_ms']:.4f} "
        f"ms against {out['plain_ms']:.4f} ms ({out['ms_ratio']:.3f}x), max "
        f"memory allocated {out['remat_max_memory_allocated'] / 2**20:.1f} "
        f"MiB against {out['plain_max_memory_allocated'] / 2**20:.1f} MiB "
        f"({out['memory_ratio']:.3f}x) ({smi})")
    return out


def orbax_phase(smi, tmp, share):
    """Phase 11: the JAX package's orbax checkpoints (read and written by
    train/orbax.py), remat and random_rotate_pairs on the card. Uses
    phase 7's shards and RGB chips (``share``)."""
    import glob
    import torch
    from dl_image_segmentation_tpu_torch.ops.augment import (
        random_rotate_pairs, rotate_pairs)
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.storage import zstd
    from dl_image_segmentation_tpu_torch.train import (TrainConfig, Trainer,
                                                       orbax)

    log(f"phase 11: orbax checkpoints, remat and rotation ({smi})")
    os.makedirs(tmp, exist_ok=True)
    out = {"seconds": {}}
    # (a) the checkpoint the JAX Trainer wrote
    ck = os.path.join(ORBAX_FIXTURE, "ckpt")
    t0 = time.perf_counter()
    tree = orbax.read_checkpoint(ck)
    read_s = time.perf_counter() - t0
    with np.load(os.path.join(ORBAX_FIXTURE, "leaves.npz")) as z:
        want = {k[5:]: z[k] for k in z.files if k.startswith("tree/")}
        images, maps = z["images"], z["maps"]
    got = flat_tree(tree)
    if sorted(got) != sorted(want) or any(
            got[k].dtype != v.dtype or got[k].tobytes() != v.tobytes()
            for k, v in want.items()):
        raise AssertionError("(a) the fixture's leaves differ from its .npz")
    store = orbax._Store(ck)
    frames = [store.get(k.decode()) for k in store.entries]
    frames = [f for f in frames if f[:4] == b"\x28\xb5\x2f\xfd"]
    sizes = [len(zstd.decompress(f, 1 << 30)) for f in frames]
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        for f, n in zip(frames, sizes):
            zstd.decompress(f, n)
    zstd_s = (time.perf_counter() - t0) / reps
    with open(os.path.join(ORBAX_FIXTURE, "config.json")) as f:
        fcfg = TrainConfig(**json.load(f))
    t = Trainer(fcfg)
    t.restore_checkpoint(ck)
    logits = torch.cat(list(t._chunked_logits(images))).cpu().numpy()
    clear = top2_gap(logits) > 1e-4
    pred = t.predict(images)
    if clear.mean() < 0.9 or not np.array_equal(pred[clear], maps[clear]):
        raise AssertionError("(a) predict on the card differs from the JAX "
                             "maps where the top two logits are apart")
    out["fixture"] = {
        "leaves": len(got), "bytes": tree_bytes(tree), "read_s": read_s,
        "zstd_frames": len(frames), "zstd_bytes": sum(sizes),
        "zstd_mb_per_s": sum(sizes) / zstd_s / 1e6,
        "clear_share": float(clear.mean())}
    log(f"  (a) fixture: {len(got)} leaves bitwise equal to the .npz; "
        f"read in {read_s:.3f} s; zstd decode "
        f"{out['fixture']['zstd_mb_per_s']:.1f} MB/s over {len(frames)} "
        f"frames ({sum(sizes)} bytes, host); predict == JAX maps on "
        f"{clear.mean():.2%} of pixels (top two > 1e-4 apart) ({smi})")
    del t
    # (b) full width: train, write orbax, restore_latest
    cfg = TrainConfig(batch_size=8)
    n, size = cfg.batch_size, cfg.image_size
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    y = rng.randint(0, cfg.num_classes, (n, size, size)).astype(np.int32)
    y[rng.rand(n, size, size) < 0.05] = 255
    a = Trainer(cfg)
    for _ in range(3):
        a.train_step(x, y)
    tree = a.orbax_tree()
    nbytes = tree_bytes(tree)
    run_dir = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    step_dir = orbax.write_checkpoint(run_dir, tree, managed=True)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    orbax.read_checkpoint(step_dir)
    read_s = time.perf_counter() - t0
    b = Trainer(cfg)
    t0 = time.perf_counter()
    step = b.restore_latest(b.checkpoint_manager(run_dir))
    restore_s = time.perf_counter() - t0
    same = step == a.state.step == b.state.step == 3 and \
        a.state.opt_state.count == b.state.opt_state.count
    for d in ("params", "mu", "nu"):
        src = a.state.params if d == "params" else getattr(
            a.state.opt_state, d)
        dst = b.state.params if d == "params" else getattr(
            b.state.opt_state, d)
        same = same and all(torch.equal(v, dst[n]) for n, v in src.items())
    if not same:
        raise AssertionError("(b) the restored state differs")
    chips = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    if not np.array_equal(a.predict(chips), b.predict(chips)):
        raise AssertionError("(b) predict of the restored state differs")
    la, lb = a.train_step(x, y)["loss"], b.train_step(x, y)["loss"]
    if la != lb or not all(torch.equal(v, b.state.params[n])
                           for n, v in a.state.params.items()):
        raise AssertionError(f"(b) the next step differs: {la} vs {lb}")
    out["full_width"] = {
        "tree_bytes": nbytes, "write_s": write_s, "read_s": read_s,
        "read_mb_per_s": nbytes / read_s / 1e6, "restore_latest_s":
        restore_s, "next_loss": la}
    log(f"  (b) full width (s2d {a.s2d}, width {a.model_features}, bf16): "
        f"orbax tree of {nbytes} bytes written in {write_s:.3f} s, read in "
        f"{read_s:.3f} s = {nbytes / read_s / 1e6:.1f} MB/s (host), "
        f"restore_latest {restore_s:.3f} s; params, mu, nu, count and step "
        f"bitwise; predict equal; next step loss {la} on both ({smi})")
    del a, b
    torch.cuda.empty_cache()
    # (c) remat at full width
    out["remat"] = remat_pair(cfg, *(torch.from_numpy(v).cuda()
                                     for v in (x, y)), smi)
    torch.cuda.empty_cache()
    # (d) the CLI: train --remat, predict from the orbax step
    secs = out["seconds"]
    model = ["--features", str(cfg.base_features), "--levels",
             str(cfg.levels), "--image-size", str(size), "--batch-size",
             str(n)]
    pattern = os.path.join(share["shards"], "smoke-*")
    cli_run(["train", "--records", pattern, "--mode", "tifarr",
             "--classes", "10", *model, "--steps", "2", "--remat",
             "--checkpoint", os.path.join(tmp, "remat.pt")], secs,
            "train --remat")
    pdir = os.path.join(tmp, "pred-orbax")
    images_dir = os.path.join(share["rgb_folder"], "images")
    cli_run(["predict", "--images", images_dir, "--checkpoint", step_dir,
             "--classes", str(cfg.num_classes), *model, "--scale", "none",
             "--out", pdir], secs, "predict --checkpoint ORBAX")
    chip_files = sorted(glob.glob(os.path.join(images_dir, "*.tif")))
    first = chip_files[0]
    t = Trainer(cfg)
    t.restore_checkpoint(step_dir)
    chip = read_geotiff(first).array.astype(np.float32)
    written = read_geotiff(os.path.join(pdir, os.path.basename(first))).array
    if len(glob.glob(os.path.join(pdir, "*.tif"))) != len(chip_files) or \
            not np.array_equal(written[..., 0] if written.ndim == 3
                               else written, t.predict(chip[None])[0]):
        raise AssertionError("(d) predict --checkpoint ORBAX differs from "
                             "Trainer.predict of the restored tree")
    del t
    torch.cuda.empty_cache()
    # (e) rotation, card against CPU on the same angles
    xi = torch.from_numpy(chips.astype(np.float32) / 255.0).cuda()
    yl = torch.from_numpy(y).cuda()
    gen = torch.Generator(device=xi.device).manual_seed(5)
    ri, rl = random_rotate_pairs(gen, xi, yl, max_degrees=180.0)
    u = torch.rand(n, generator=torch.Generator(device=xi.device).manual_seed(
        5), device=xi.device) * 2.0 - 1.0
    angles = u * float(math.pi)
    ci, cl = rotate_pairs(xi.cpu(), yl.cpu(), angles.cpu())
    if not (torch.equal(rl.cpu(), cl) and torch.equal(ri.cpu(), ci)):
        raise AssertionError("(e) rotation on the card differs from the CPU")
    rot_ms = cuda_ms(lambda: rotate_pairs(xi, yl, angles), 5)
    out["rotation"] = {"card_equals_cpu": True, "ms": rot_ms}
    log(f"  (e) random_rotate_pairs of {n} chips of {size} px: card == CPU "
        f"bitwise (labels and images); {rot_ms:.3f} ms a batch ({smi})")
    return out


HDF5_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "hdf5")
CONTAINER_KINDS = ("vrt", "netcdf", "gpkg", "nitf")
# phase 13's band files: the two layouts of ``hdf5_utm``
HDF5_KINDS = {"h5chunked": "chunked", "h5contiguous": "contiguous"}


def netcdf_utm(arr, gt, zone, typecode, name="band"):
    """NetCDF classic bytes (scipy.io.netcdf_file) of a (H, W) or (B, H,
    W) array on the grid ``gt``: CF x/y coordinates of pixel centres and
    a transverse_mercator grid mapping of UTM ``zone``, _FillValue 0."""
    import io
    from scipy.io import netcdf_file
    h, w = arr.shape[-2:]
    buf = io.BytesIO()
    f = netcdf_file(buf, "w")
    dims = ("y", "x")
    if arr.ndim == 3:
        f.createDimension("band", arr.shape[0])
        dims = ("band",) + dims
    f.createDimension("y", h)
    f.createDimension("x", w)
    y = f.createVariable("y", "d", ("y",))
    y[:] = gt[3] + gt[5] * (np.arange(h) + 0.5)
    y.standard_name = b"projection_y_coordinate"
    x = f.createVariable("x", "d", ("x",))
    x[:] = gt[0] + gt[1] * (np.arange(w) + 0.5)
    x.standard_name = b"projection_x_coordinate"
    crs = f.createVariable("crs", "i", ())
    crs.grid_mapping_name = b"transverse_mercator"
    # float64 arrays: scipy stores a bare float as a float32 attribute
    crs.scale_factor_at_central_meridian = np.array([0.9996])
    crs.longitude_of_central_meridian = np.array([zone * 6 - 183.0])
    crs.false_easting = np.array([500000.0])
    crs.false_northing = np.array([0.0])
    v = f.createVariable(name, typecode, dims)
    v[:] = arr
    v.grid_mapping = b"crs"
    v._FillValue = np.zeros((), np.dtype(v.typecode()))
    f.flush()
    data = buf.getvalue()
    f.close()
    return data


def _h5_type(dt):
    """HDF5 datatype message body of a little-endian numpy dtype."""
    import struct
    dt = np.dtype(dt)
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f":
        exp, mant, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * dt.itemsize - 1,
                           0, dt.itemsize, 0, 8 * dt.itemsize, mant, exp, 0,
                           mant, bias)
    raise ValueError(f"no HDF5 type for {dt}")


def _h5_space(shape):
    import struct
    return struct.pack(f"<BBBB4x{len(shape)}Q", 1, len(shape), 0, 0, *shape)


def _h5_pad(b):
    return b + bytes(-len(b) % 8)


def _h5_msg(mtype, body):
    import struct
    body = _h5_pad(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _h5_attr(name, tbody, shape, data):
    """A version 1 attribute message (name, type and space padded to 8)."""
    import struct
    nm = name.encode() + b"\0"
    space = _h5_space(shape)
    return _h5_msg(0x0C, struct.pack("<BBHHH", 1, 0, len(nm), len(tbody),
                                     len(space))
                   + _h5_pad(nm) + _h5_pad(tbody) + _h5_pad(space) + data)


def _h5_text(name, text):
    import struct
    raw = text.encode() + b"\0"
    return _h5_attr(name, struct.pack("<BBBBI", 0x13, 0, 0, 0, len(raw)), (),
                    raw)


def _h5_scalar(name, value, dt):
    return _h5_attr(name, _h5_type(dt), (), np.array(value, dt).tobytes())


def hdf5_utm(arr, gt, zone, layout, name="band", nodata=0):
    """HDF5 bytes of a (H, W) or (B, H, W) little-endian array on the
    grid ``gt`` in UTM ``zone``, written as h5py's default does: superblock
    version 0, version 1 object headers, a symbol-table root group. x/y
    coordinates of pixel centres (float64, CF ``standard_name``), a
    ``crs`` dataset with a transverse_mercator grid mapping, and
    ``_FillValue`` ``nodata``. ``layout`` "chunked": deflate+shuffle
    chunks under a v1 B-tree, x/y found as CF siblings; "contiguous":
    x/y are NetCDF-4 dimension scales attached through ``DIMENSION_LIST``
    (object references in a global heap collection)."""
    import struct
    import zlib
    arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
    h, w = arr.shape[-2:]
    undef = 0xFFFFFFFFFFFFFFFF
    out = bytearray(96)                          # the superblock, last

    def alloc(blob):
        out.extend(bytes(-len(out) % 8))
        at = len(out)
        out.extend(blob)
        return at

    def ohdr(msgs):
        body = b"".join(msgs)
        return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body

    def layout_contig(addr, n):
        return _h5_msg(0x08, struct.pack("<BBQQ", 3, 1, addr, n))

    names = sorted(["x", "y", "crs", name])
    heap = bytearray(8)                          # "" at offset 0
    offs = {}
    for n in names:
        offs[n] = len(heap)
        heap.extend(_h5_pad(n.encode() + b"\0"))
    heap_data = alloc(bytes(heap))
    heap_hdr = alloc(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap), 1,
                                                      heap_data))
    gbtree = alloc(bytes(24 + 33 * 8 + 32 * 8))  # group K = 16
    snod = alloc(bytes(8 + 8 * 40))              # leaf K = 4
    root = alloc(ohdr([_h5_msg(0x11, struct.pack("<QQ", gbtree,
                                                 heap_hdr))]))
    coords = {"x": gt[0] + gt[1] * (np.arange(w) + 0.5),
              "y": gt[3] + gt[5] * (np.arange(h) + 0.5)}
    objs = {}
    for axis in ("x", "y"):
        v = coords[axis]
        data = alloc(v.astype("<f8").tobytes())
        msgs = [_h5_msg(0x01, _h5_space(v.shape)), _h5_msg(0x03, _h5_type(
            "<f8")), layout_contig(data, v.nbytes), _h5_text(
            "standard_name", f"projection_{axis}_coordinate")]
        if layout == "contiguous":
            msgs += [_h5_text("CLASS", "DIMENSION_SCALE"),
                     _h5_text("NAME", axis)]
        objs[axis] = alloc(ohdr(msgs))
    crs_data = alloc(np.int32(0).tobytes())
    objs["crs"] = alloc(ohdr([
        _h5_msg(0x01, _h5_space(())), _h5_msg(0x03, _h5_type("<i4")),
        layout_contig(crs_data, 4),
        _h5_text("grid_mapping_name", "transverse_mercator"),
        _h5_scalar("scale_factor_at_central_meridian", 0.9996, "<f8"),
        _h5_scalar("longitude_of_central_meridian", zone * 6 - 183.0, "<f8"),
        _h5_scalar("false_easting", 500000.0, "<f8"),
        _h5_scalar("false_northing", 0.0, "<f8")]))
    es = arr.dtype.itemsize
    msgs = [_h5_msg(0x01, _h5_space(arr.shape)),
            _h5_msg(0x03, _h5_type(arr.dtype))]
    if layout == "chunked":
        lead = arr.shape[:-2]
        c = 128
        while int(np.prod(lead)) * -(-h // c) * -(-w // c) > 64:
            c *= 2                               # one B-tree leaf: <= 64
        chunk = (1,) * len(lead) + (c, c)
        keys, kids = [], []
        for idx in np.ndindex(*[-(-s // k) for s, k in zip(arr.shape,
                                                           chunk)]):
            lo = [i * k for i, k in zip(idx, chunk)]
            block = np.zeros(chunk, arr.dtype)
            part = arr[tuple(slice(a, a + k) for a, k in zip(lo, chunk))]
            block[tuple(slice(0, s) for s in part.shape)] = part
            raw = block.tobytes()
            shuffled = np.frombuffer(raw, np.uint8).reshape(-1, es).T
            comp = zlib.compress(shuffled.tobytes(), 4)
            kids.append(alloc(comp))
            keys.append(struct.pack(f"<II{len(chunk) + 1}Q", len(comp), 0,
                                    *lo, 0))
        keys.append(struct.pack(f"<II{len(chunk) + 1}Q", 0, 0, *lo, es))
        ksize = 8 + 8 * (len(chunk) + 1)
        node = b"TREE" + struct.pack("<BBHQQ", 1, 0, len(kids), undef,
                                     undef)
        for k, child in zip(keys, kids):
            node += k + struct.pack("<Q", child)
        node += keys[-1]
        btree = alloc(node + bytes(24 + 65 * ksize + 64 * 8 - len(node)))
        pipe = struct.pack("<BB6x", 1, 2)
        for fid, fname, val in ((2, b"shuffle\0", es), (1, b"deflate\0", 4)):
            pipe += struct.pack("<HHHH", fid, 8, 1, 1) + fname + struct.pack(
                "<I4x", val)
        msgs += [_h5_msg(0x0B, pipe), _h5_msg(0x08, struct.pack(
            f"<BBBQ{len(chunk) + 1}I", 3, 2, len(chunk) + 1, btree, *chunk,
            es))]
    else:
        data = alloc(arr.tobytes())
        msgs.append(layout_contig(data, arr.nbytes))
        # DIMENSION_LIST: per dimension a vlen of object references
        objects = [objs["y"], objs["x"]]
        gcol = bytearray(b"GCOL" + struct.pack("<B3xQ", 1, 4096))
        for i, ref in enumerate(objects, 1):
            gcol += struct.pack("<HH4xQQ", i, 1, 8, ref)
        gcol += struct.pack("<HH4xQ", 0, 0, 4096 - len(gcol))
        gheap = alloc(bytes(gcol) + bytes(4096 - len(gcol)))
        lead = len(arr.shape) - 2
        refs = b"".join([struct.pack("<IQI", 0, 0, 0)] * lead
                        + [struct.pack("<IQI", 1, gheap, i)
                           for i in (1, 2)])
        vlen_ref = struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + struct.pack(
            "<BBBBI", 0x17, 0, 0, 0, 8)
        msgs.append(_h5_attr("DIMENSION_LIST", vlen_ref, (arr.ndim,), refs))
    msgs += [_h5_text("grid_mapping", "crs"),
             _h5_scalar("_FillValue", nodata, arr.dtype)]
    objs[name] = alloc(ohdr(msgs))
    entries = b"".join(struct.pack("<QQII16x", offs[n], objs[n], 0, 0)
                       for n in names)
    out[snod:snod + 8 + len(entries)] = b"SNOD" + struct.pack(
        "<BBH", 1, 0, len(names)) + entries
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, undef, undef) + \
        struct.pack("<QQQ", 0, snod, offs[names[-1]])
    out[gbtree:gbtree + len(node)] = node
    out[:96] = b"\x89HDF\r\n\x1a\n" + struct.pack(
        "<BBBBBBBBHHIQQQQ", 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0, 0, undef,
        len(out), undef) + struct.pack("<QQII", 0, root, 1, 0) + \
        struct.pack("<QQ", gbtree, heap_hdr)
    return bytes(out)


def container_band(kind, folder, name, band, gt, epsg):
    """One (H, W) uint16 band as a ``kind`` file under ``folder`` (the
    port's encoders; scipy for NetCDF, which stores it as float32: the
    classic format has no uint16); returns (path, the array that the
    file holds)."""
    from dl_image_segmentation_tpu_torch.raster.geotiff import (
        encode_geotiff)
    from dl_image_segmentation_tpu_torch.raster.gpkg_raster import (
        encode_gpkg)
    from dl_image_segmentation_tpu_torch.raster.nitf import encode_nitf
    h5 = kind in HDF5_KINDS
    path = os.path.join(folder, f"{name}.{'h5' if h5 else kind}")
    held = band
    if h5:
        data = hdf5_utm(band, gt, epsg % 100, HDF5_KINDS[kind])
    elif kind == "vrt":
        src = os.path.join(folder, f"{name}-src.tif")
        with open(src, "wb") as f:
            f.write(encode_geotiff(band, geotransform=gt, epsg=epsg))
        h, w = band.shape
        data = (f'<VRTDataset rasterXSize="{w}" rasterYSize="{h}">'
                f"<SRS>EPSG:{epsg}</SRS><GeoTransform>"
                f'{", ".join(repr(float(v)) for v in gt)}</GeoTransform>'
                '<VRTRasterBand dataType="UInt16" band="1">'
                "<NoDataValue>0</NoDataValue><SimpleSource>"
                f'<SourceFilename relativeToVRT="0">{src}</SourceFilename>'
                "<SourceBand>1</SourceBand></SimpleSource></VRTRasterBand>"
                "</VRTDataset>").encode()
    elif kind == "netcdf":
        held = band.astype(np.float32)
        data = netcdf_utm(held, gt, epsg % 100, "f")
    elif kind == "gpkg":
        data = encode_gpkg(band, tile_size=256, geotransform=gt, epsg=epsg)
    else:
        data = encode_nitf(band, geotransform=gt, epsg=epsg)
    with open(path, "wb") as f:
        f.write(data)
    return path, held


def write_container_roots(tmp, block, n_scenes=4, kinds=CONTAINER_KINDS):
    """Two LocalCatalog roots of the same ``n_scenes`` Sentinel-2 L1C
    scenes (13 bands, 10 m, DNs 1-4095 with nodata 0 in blotches, zone
    43, over ``block`` = (x0, y0, x1, y1) in metres): one whose per-band
    files rotate through ``kinds`` (band b of scene s in kind
    (b + s) % len(kinds)) and one of GeoTIFF band files holding the same
    arrays.
    Every container file must decode to its array, georeferencing and
    nodata. Returns (container root, GeoTIFF root, {kind: [paths]})."""
    from dl_image_segmentation_tpu_torch.raster.geotiff import (
        encode_geotiff)
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_image_bytes)
    rng = np.random.RandomState(23)
    x0, y0, x1, y1 = block
    gt = (float(x0), 10.0, 0.0, float(y1), 0.0, -10.0)
    w, h = int((x1 - x0) / 10.0), int((y1 - y0) / 10.0)
    roots = {k: os.path.join(tmp, f"{k}-root") for k in ("containers",
                                                          "geotiff")}
    scenes = {k: [] for k in roots}
    files = {k: [] for k in kinds}
    for k in roots:
        os.makedirs(os.path.join(roots[k], "bands"))
    for s in range(n_scenes):
        arr = rng.randint(1, 4096, (h, w, len(S2_BANDS))).astype(np.uint16)
        blot = np.kron(rng.rand(h // 32 + 1, w // 32 + 1) < 0.1,
                       np.ones((32, 32), bool))[:h, :w]
        arr[blot] = 0
        paths = {k: {} for k in roots}
        for b, band in enumerate(S2_BANDS):
            kind = kinds[(b + s) % len(kinds)]
            path, held = container_band(
                kind, os.path.join(roots["containers"], "bands"),
                f"s{s}-{band}", arr[:, :, b], gt, 32643)
            with open(path, "rb") as f:
                g = decode_image_bytes(f.read())
            a = g.array[:h, :w, 0]
            if (a.dtype != held.dtype or not np.array_equal(a, held)
                    or g.info.geotransform != gt or g.info.epsg != 32643
                    or g.info.nodata not in (0.0, None)):
                raise AssertionError(f"{path}: decodes to other pixels or "
                                     f"georeferencing ({g.info})")
            files[kind].append(path)
            paths["containers"][band] = path
            tif = os.path.join(roots["geotiff"], "bands", f"s{s}-{band}.tif")
            with open(tif, "wb") as f:
                f.write(encode_geotiff(held[:, :, None], geotransform=gt,
                                       epsg=32643, nodata=0))
            paths["geotiff"][band] = tif
        for k in roots:
            scenes[k].append({
                "id": f"s{s}", "date": str(dt.date(2020, 6, 1)
                                           + dt.timedelta(days=12 * s)),
                "cloud_fraction": 0.01 * s, "nodata": 0,
                "band_paths": paths[k], "epsg": 32643,
                "bounds": [float(x0), float(y0), float(x1), float(y1)]})
    for k, root in roots.items():
        with open(os.path.join(root, "index.json"), "w") as f:
            json.dump({"products": {"sentinel-2:L1C": {
                "bands": S2_BANDS, "scenes": scenes[k]}}}, f)
    return roots["containers"], roots["geotiff"], files


def sub_aoi_labels(labels, path, tiles_x=4, tiles_y=2):
    """The features of ``labels`` (phase 7's GeoJSON) whose tiles
    (``--tile-size 260 --pad 2``: 256 px and a 2 px pad) all lie in the
    ``tiles_x`` x ``tiles_y`` tiles at the AOI's south-west corner,
    written to ``path``; returns (those tiles' keys, their padded bounds'
    union)."""
    from dl_image_segmentation_tpu_torch.geo.geometry import Geometry
    from dl_image_segmentation_tpu_torch.geo.tilegrid import tiles_from_shape
    with open(labels) as f:
        fc = json.load(f)
    per = [{(t.ti, t.tj): t for t in tiles_from_shape(
        Geometry.coerce(ft["geometry"]), 10.0, 256, 2)}
        for ft in fc["features"]]
    cols = sorted({ij[0] for p in per for ij in p})[:tiles_x]
    rows = sorted({ij[1] for p in per for ij in p})[:tiles_y]
    keep, tiles = [], {}
    for ft, p in zip(fc["features"], per):
        if all(i in cols and j in rows for i, j in p):
            keep.append(ft)
            tiles.update(p)
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": keep}, f)
    bounds = np.array([t.bounds for t in tiles.values()])
    return sorted(t.key for t in tiles.values()), (
        bounds[:, 0].min(), bounds[:, 1].min(), bounds[:, 2].max(),
        bounds[:, 3].max())


def export_roots(base, croot, groot, tmp, secs):
    """``create-chips --max-cloud-fraction 0`` (8 tiles) from a container
    root ``croot`` at ``--batch-tiles`` 0 and 16 on the card and the CPU,
    and from the GeoTIFF root ``groot`` of the same pixels on the card:
    all chips bitwise equal per mode, and K1, K2 and K3 launched in the
    card exports of the container root (the counters are set to 0 before
    each and read after). Returns (the exports' rows, the launches, the
    folder of the batched card export)."""
    import glob
    import torch
    from dl_image_segmentation_tpu_torch import kernels
    launches = {c.name: 0 for c in kernels.COUNTERS}
    trees, exports, batched = {}, [], None
    os.environ["DLSEG_DEBUG"] = "1"
    try:
        for root_name, root, device, batch in (
                ("containers", croot, "cuda", 0),
                ("containers", croot, "cuda", 16),
                ("geotiff", groot, "cuda", 0),
                ("geotiff", groot, "cuda", 16),
                ("containers", croot, "cpu", 0),
                ("containers", croot, "cpu", 16)):
            dest = os.path.join(tmp, f"{root_name}-{device}-{batch}")
            name = f"create-chips {root_name} {device} --batch-tiles {batch}"
            counted = root_name == "containers" and device == "cuda"
            if counted:
                torch.cuda.synchronize()
                for c in kernels.COUNTERS:
                    c.reset()
            cli_run(with_flags(base, catalog=root) + [
                "--out", dest, "--max-cloud-fraction", "0", "--batch-tiles",
                str(batch), "--device", device], secs, name)
            if counted:
                torch.cuda.synchronize()
                for c in kernels.COUNTERS:
                    launches[c.name] += c.count
            folder, = glob.glob(os.path.join(dest, "*"))
            trees[(root_name, device, batch)] = read_tree(folder)
            if root_name == "containers" and device == "cuda" and batch:
                batched = folder
            exports.append({
                "root": root_name, "device": device, "batch_tiles": batch,
                "tiles": 8, "seconds": secs[name],
                "tiles_per_s": 8 / secs[name]})
    finally:
        del os.environ["DLSEG_DEBUG"]
    for batch in (0, 16):
        ref = trees[("containers", "cuda", batch)]
        if len(ref) != 16:
            raise AssertionError(f"container export: {len(ref)} files")
        for other in (("geotiff", "cuda", batch), ("containers", "cpu",
                                                   batch)):
            got = trees[other]
            if got != ref:
                bad = [k for k in ref if got.get(k) != ref[k]][:3]
                raise AssertionError(f"{other}: chips differ from the "
                                     f"container root's on the card {bad}")
    if not launches["masked_median"] or not (launches["burn_dense"]
                                             and launches["burn_binned"]):
        raise AssertionError(f"container exports launched {launches}")
    log(f"  container root == GeoTIFF root == CPU chips, per tile and "
        f"batched (16 GeoTIFFs each); launches on the card {launches}; "
        + ", ".join(f"{r['root']} {r['device']} b{r['batch_tiles']} "
                    f"{r['seconds']:.3f} s" for r in exports))
    return exports, launches, batched


def containers_phase(smi, tmp, share):
    """Phase 12: the scientific raster containers and the public library
    API on the card (after ``cli_phase``). (1) A LocalCatalog root whose
    scenes' 13 bands are per-band files in rotating containers (VRT over
    GeoTIFF sources, NetCDF classic with a CF UTM grid mapping,
    GeoPackage, NITF), over 8 tiles of phase 7's AOI and polygons ->
    ``create-chips --max-cloud-fraction 0`` at ``--batch-tiles`` 0 and
    16 on the card (K1 and K2/K3 launched: the counters are set to 0
    before each card export of this root and read after) and the CPU,
    and from a GeoTIFF root of the same pixels on the card: all chips
    bitwise equal per mode. (2) ``to-tfrecords --file-ext nc`` over
    phase 7's RGB chips as NetCDF pairs (tifraw) and ``--file-ext hdr
    --store-as-array`` over them as ENVI pairs (the MP engine finds each
    data file from its header's directory and name); ``train --mode
    tifraw`` (20 steps, falling loss). (3) NetCDF, GRIB, HDF4, NITF and
    GeoPackage request bodies to a PredictServer over HTTP (the serving
    config: TrainConfig defaults, bf16, batch 8, the trained weights):
    class maps == ``Trainer.predict`` of the port's decode; a VRT body
    naming a file answers 400 before the file is read. (4) Each
    container's decode MP/s and sniff us on one host thread. (5)
    ``convert_to_example`` of the card's chips (torch tensors on the
    card) == the MP engine's records; the web map's and
    ``tiles_to_layer``'s footprints == those of the chips'
    geotransforms; ``duty_cycle`` of the bf16 U-Net step beside the
    Trainer's own duty."""
    import glob
    import io
    import itertools
    import threading
    import urllib.error
    import urllib.request
    import torch
    from dl_image_segmentation_tpu_torch import convert_to_example
    from dl_image_segmentation_tpu_torch.geo import crs as tcrs
    from dl_image_segmentation_tpu_torch.geo.tilegrid import (
        tile_from_key, tiles_to_layer)
    from dl_image_segmentation_tpu_torch.raster import (envi, grib, hdf4,
                                                        nitf, gpkg_raster)
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_image_bytes, sniff_image_info)
    from dl_image_segmentation_tpu_torch.records.proto import decode_example
    from dl_image_segmentation_tpu_torch.records.tfrecord import read_records
    from dl_image_segmentation_tpu_torch.records.writers import (
        _tile_key_from_filename)
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, make_http_server, scale_image)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    from dl_image_segmentation_tpu_torch.utils import profiling, webmap

    t_phase = time.perf_counter()
    log(f"phase 12: raster containers and the library API on the card "
        f"({smi})")
    os.makedirs(tmp, exist_ok=True)
    out = {"seconds": {}, "exports": [], "card": smi}
    secs = out["seconds"]
    labels = share["base"][share["base"].index("--labels") + 1]
    sub_labels = os.path.join(tmp, "labels-sub.geojson")
    keys, (bx0, by0, bx1, by1) = sub_aoi_labels(labels, sub_labels)
    if len(keys) != 8:
        raise AssertionError(f"sub-AOI: {len(keys)} tiles {keys}")
    block = (bx0 - 200.0, by0 - 200.0, bx1 + 200.0, by1 + 200.0)
    t0 = time.perf_counter()
    croot, groot, files = write_container_roots(tmp, block)
    secs["write roots"] = time.perf_counter() - t0
    counts = ", ".join(f"{k} {len(v)}" for k, v in files.items())
    log(f"  roots: 4 scenes x 13 bands, {counts} band files (each decodes "
        f"to its array and georeferencing), {secs['write roots']:.3f} s")

    # (1) exports
    base = with_flags(share["base"], labels=sub_labels)
    out["exports"], launches, share["container_chips"] = export_roots(
        base, croot, groot, tmp, secs)
    out["launches"] = launches

    # (2) tifraw from NetCDF chips, ENVI through the MP engine
    tifs = {sub: tree_files(share["rgb_folder"], sub, "tif")
            for sub in ("images", "labels")}
    nc_dir, envi_dir = (os.path.join(tmp, d) for d in ("nc-chips",
                                                       "envi-chips"))
    decoded = {}
    # int16 for both: NetCDF classic has no uint8, and labels hold 255
    # (nodata), which int8 would turn into -1
    for sub in ("images", "labels"):
        for d in (nc_dir, envi_dir):
            os.makedirs(os.path.join(d, sub))
        for k, p in tifs[sub].items():
            g = read_geotiff(p)
            a = g.array
            decoded[(sub, k)] = a
            with open(os.path.join(nc_dir, sub, f"{k}.nc"), "wb") as f:
                f.write(netcdf_utm(np.moveaxis(a, 2, 0).astype(np.int16),
                                   g.info.geotransform, g.info.epsg % 100,
                                   "h", name="chip"))
            hdr, body = envi.encode_envi(a, geotransform=g.info.geotransform,
                                         epsg=g.info.epsg)
            with open(os.path.join(envi_dir, sub, f"{k}.hdr"), "wb") as f:
                f.write(hdr)
            with open(os.path.join(envi_dir, sub, f"{k}.img"), "wb") as f:
                f.write(body)
    shards = {}
    for kind, folder, ext, extra in (("nc", nc_dir, "nc", []),
                                     ("envi", envi_dir, "hdr",
                                      ["--store-as-array"])):
        shards[kind] = os.path.join(tmp, f"{kind}-shards")
        cli_run(["to-tfrecords", "--name", kind, "--directory", folder,
                 "--out", shards[kind], "--shards", "4", "--workers", "4",
                 "--engine", "mp", "--file-ext", ext, *extra], secs,
                f"to-tfrecords --file-ext {ext}")
    from dl_image_segmentation_tpu_torch.records.parsers import (
        parse_8bit_array_proto, parse_encoded_gdal_proto_wrapped,
        parse_higher_dtype_array_proto)
    # the MP engine stores a uint8 pair as bytes (rgbarr), else FloatList
    stored = (parse_8bit_array_proto if all(
        a.dtype == np.uint8 for a in decoded.values())
        else parse_higher_dtype_array_proto)
    n = 0
    for kind, parse in (("nc", parse_encoded_gdal_proto_wrapped),
                        ("envi", stored)):
        for f in sorted(glob.glob(os.path.join(shards[kind], f"{kind}-*"))):
            for r in read_records(f, verify_crc=True):
                img, lbl, ident = parse(r)
                k = ident.decode().replace(":", "#")
                want_i = decoded[("images", k)]
                want_l = decoded[("labels", k)][:, :, 0]
                if not (np.array_equal(img, want_i.astype(img.dtype))
                        and np.array_equal(np.asarray(lbl).reshape(
                            want_l.shape), want_l.astype(lbl.dtype))):
                    raise AssertionError(f"{kind} record {k}: other pixels")
                n += 1
    if n != 2 * len(tifs["images"]):
        raise AssertionError(f"{n} container records, not 2 x "
                             f"{len(tifs['images'])}")
    mlog = os.path.join(tmp, "nc.jsonl")
    ckpt = os.path.join(tmp, "nc.pt")
    cli_run(["train", "--records", os.path.join(shards["nc"], "nc-*"),
             "--mode", "tifraw", "--classes", "10", "--steps", "20",
             "--log-every", "1", "--workers", "1", "--metrics-log", mlog,
             "--checkpoint", ckpt], secs, "train --mode tifraw (NetCDF)")
    share["container_ckpt"] = ckpt
    losses = [json.loads(ln)["loss"] for ln in open(mlog)]
    if len(losses) != 20 or not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"train tifraw (NetCDF): losses {losses}")
    out["losses"] = losses
    log(f"  to-tfrecords: NetCDF tifraw and ENVI --store-as-array records "
        f"== the chips ({n}, CRCs checked); train --mode tifraw from NetCDF "
        f"chips: loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f}")

    # (3) container bodies: a 256² RGB chip as uint8 (GeoPackage's PNG
    # tiles take 3 bands only at 8 bits)
    chip = decoded[("images", sorted(tifs["images"])[0])]
    if chip.dtype != np.uint8:
        chip = np.clip(chip >> 4, 0, 255).astype(np.uint8)
    bodies = {
        "netcdf": netcdf_utm(np.moveaxis(chip, 2, 0).astype(np.int16),
                             (0.0, 1.0, 0.0, 0.0, 0.0, -1.0), 43, "h"),
        "grib": b"".join(grib.encode_grib2(
            chip[:, :, b].astype(np.float64), 19.0, 72.0, 1e-4, 1e-4,
            nbits=8, packing="complex-sd2") for b in range(3)),
        "hdf4": hdf4.encode_hdf4({"rgb": np.moveaxis(chip, 2, 0)},
                                 storage="chunked"),
        "nitf": nitf.encode_nitf(chip, imode="B",
                                 block_size=chip.shape[0] // 2),
        "gpkg": gpkg_raster.encode_gpkg(chip, tile_size=chip.shape[0] // 2)}
    trainer = Trainer(TrainConfig(num_classes=10, batch_size=8))
    trainer.restore_checkpoint(ckpt)
    ps = PredictServer(trainer)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    names = sorted(bodies)
    served = {}

    def post(kind):
        req = urllib.request.Request(url, data=bodies[kind], method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served[kind] = np.load(io.BytesIO(r.read()))
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(k,)) for k in names]
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=300)
        secs["serve 5 container bodies"] = time.perf_counter() - t0
        want = trainer.predict(np.stack([scale_image(
            decode_image_bytes(bodies[k]).array, "auto") for k in names]))
        for i, k in enumerate(names):
            if k not in served or not np.array_equal(served[k], want[i]):
                raise AssertionError(f"served {k} body differs from predict")
        # a VRT body would make the server read the file it names
        src = tifs["images"][sorted(tifs["images"])[0]]
        vrt = (f'<VRTDataset rasterXSize="8" rasterYSize="8"><VRTRasterBand '
               f'dataType="Byte" band="1"><SimpleSource><SourceFilename '
               f'relativeToVRT="0">{src}</SourceFilename></SimpleSource>'
               f'</VRTRasterBand></VRTDataset>').encode()
        try:
            urllib.request.urlopen(urllib.request.Request(
                url, data=vrt, method="POST"), timeout=120)
            raise AssertionError("a VRT body naming a file was served")
        except urllib.error.HTTPError as e:
            msg = e.read().decode()
            if e.code != 400 or "VRT refused" not in msg or src in msg:
                raise AssertionError(f"VRT body: {e.code} {msg}") from e
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        ps.close()
    del trainer, ps
    torch.cuda.empty_cache()
    log(f"  serve: {', '.join(names)} bodies in "
        f"{secs['serve 5 container bodies']:.3f} s, class maps == predict "
        "of the port's decode; a VRT body naming a file: 400, unread")

    # (4) decode MP/s and sniff us on one host thread
    band = decode_image_bytes(open(files["nitf"][0], "rb").read()).array[
        :, :, 0]
    rest = {
        "envi": envi.encode_envi(band),
        "hdf4": hdf4.encode_hdf4({"band": band}),
        "grib": grib.encode_grib2(band.astype(np.float64), 19.0, 72.0,
                                  1e-4, 1e-4, nbits=12)}
    samples = {k: open(v[0], "rb").read() for k, v in files.items()}
    samples["grib"], samples["hdf4"] = rest["grib"], rest["hdf4"]
    envi_dir1 = os.path.join(tmp, "envi-band")
    os.makedirs(envi_dir1)
    with open(os.path.join(envi_dir1, "band.img"), "wb") as f:
        f.write(rest["envi"][1])
    samples["envi"] = rest["envi"][0]
    out["decode_mp_per_s"], out["sniff_us"] = {}, {}
    for kind, data in samples.items():
        kw = ({"base_dir": envi_dir1, "origin": "band.hdr"}
              if kind == "envi" else {})
        px = decode_image_bytes(data, **kw).array.shape
        calls, took = rate(lambda d: decode_image_bytes(d, **kw), [data],
                           min_s=0.3)
        out["decode_mp_per_s"][kind] = calls * px[0] * px[1] / 1e6 / took
        calls, took = rate(sniff_image_info, [data], min_s=0.2)
        out["sniff_us"][kind] = took / calls * 1e6
    log(f"  decode MP/s ({band.shape[1]} x {band.shape[0]} uint16 band; "
        "one host thread): " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["decode_mp_per_s"].items())
        + "; sniff us: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["sniff_us"].items())
        + f"; host of {smi}")

    # (5) the library API
    folder = share["container_chips"]
    tif_i = tree_files(folder, "images", "tif")
    tif_l = tree_files(folder, "labels", "tif")
    api_shards = os.path.join(tmp, "api-shards")
    cli_run(["to-tfrecords", "--name", "api", "--directory", folder,
             "--out", api_shards, "--shards", "1", "--workers", "1",
             "--engine", "mp", "--store-as-array"], secs,
            "to-tfrecords container chips")
    recs = [r for f in sorted(glob.glob(os.path.join(api_shards, "api-*")))
            for r in read_records(f, verify_crc=True)]
    by_key = {decode_example(r)["identifier"].bytes_list[0].decode(): r
              for r in recs}
    for k in tif_i:
        img = torch.from_numpy(read_geotiff(tif_i[k]).array).cuda()
        lbl = torch.from_numpy(read_geotiff(tif_l[k]).array[:, :, 0]).cuda()
        key = _tile_key_from_filename(tif_i[k])
        ex = convert_to_example(img, lbl, *img.shape, *lbl.shape, key)
        if ex.SerializeToString() != by_key[key]:
            raise AssertionError(f"convert_to_example({key}) != the MP "
                                 "engine's record")
    html = webmap.write_html_map_for_folder(os.path.join(tmp, "map.html"),
                                            os.path.join(folder, "images"))
    text = open(html, encoding="utf-8").read()
    shown = json.loads(re.search(r"var tiles = (.*);\n", text).group(1))
    # the web map draws tiles_to_layer's footprints: hold them against
    # footprints computed apart, from each chip's own geotransform less
    # its pad, in degrees (1e-9 is about 0.1 mm)
    layer = tiles_to_layer([tile_from_key(k) for k in sorted(keys)])
    drawn = {f["properties"]["key"]: np.asarray(
        f["geometry"]["coordinates"][0]) for f in shown["features"]}
    built = {ft.properties["key"]: ft.geometry.polygons()[0][0]
             for ft in layer.features}
    chips = {k.replace("#", ":"): p for k, p in tif_i.items()}
    if sorted(drawn) != sorted(chips) or sorted(built) != sorted(chips):
        raise AssertionError("the web map's or tiles_to_layer's keys are "
                             "not the chips'")
    for k, path in chips.items():
        info = read_geotiff(path).info
        gx, rx, _, gy, _, ry = info.geotransform
        pad = int(k.split(":")[1])
        xs = gx + rx * np.array([pad, info.width - pad])
        ys = gy + ry * np.array([info.height - pad, pad])
        lon, lat = tcrs.utm_to_lonlat(xs[[0, 1, 1, 0, 0]],
                                      ys[[0, 0, 1, 1, 0]],
                                      info.epsg - 32600)
        ring = np.stack([lon, lat], axis=1)
        for name, got in (("the web map", drawn[k]),
                          ("tiles_to_layer", built[k])):
            if not np.allclose(got, ring, rtol=0, atol=1e-9):
                raise AssertionError(f"{name}'s footprint of {k} is not "
                                     "its chip's")
    t = Trainer(TrainConfig(num_classes=10))
    cfg = t.config
    rng = np.random.RandomState(24)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size)
    host = [(rng.randint(0, 255, shape + (cfg.in_channels,)).astype(
        np.uint8), rng.randint(0, 10, shape).astype(np.int32))
            for _ in range(4)]
    feed = itertools.cycle(host)
    first = next(feed)
    d = profiling.duty_cycle(t.train_step_async, feed, 10,
                             device_only_batch=t.place_batch(*first))
    for _ in range(10):
        t.train_step(*next(feed))
    own = t.throughput_stats()
    out["duty_cycle"] = d
    out["trainer_duty"] = {k: own[k] for k in ("duty_cycle",
                                               "duty_cycle_lower")}
    del t
    torch.cuda.empty_cache()
    secs["phase"] = time.perf_counter() - t_phase
    log(f"  API: convert_to_example of the card's 8 chips (cuda tensors) == "
        f"the MP engine's records; the web map's and tiles_to_layer's "
        f"footprints == the chips' geotransforms; "
        f"duty_cycle of the bf16 U-Net step (batch {cfg.batch_size}): duty "
        f"{d['duty_cycle']:.3f}, {d['steps_per_sec']:.2f} steps/s fed; the "
        f"Trainer's own duty {own['duty_cycle']:.3f} (lower "
        f"{own['duty_cycle_lower']:.3f}); {smi}")
    log(f"  phase 12: {secs['phase']:.1f} s")
    return out


def hdf5_phase(smi, tmp, share):
    """Phase 13: HDF5 / NetCDF-4 through the port's own reader on the
    card (after ``containers_phase``). (a) A LocalCatalog root of 4 scenes
    x 13 bands over phase 12's 8 tiles, every band an HDF5 file from
    ``hdf5_utm`` (layouts alternating by band: chunked deflate+shuffle
    under a v1 B-tree with CF sibling coordinates, and contiguous with
    NetCDF-4 dimension scales), each decoding to its array and
    georeferencing; (b) ``create-chips --max-cloud-fraction 0`` from it
    at ``--batch-tiles`` 0 and 16 on the card and the CPU, and from a
    GeoTIFF root of the same arrays: chips bitwise equal per mode, K1-K3
    launched; (c) phase 7's RGB chips as HDF5 pairs -> ``to-tfrecords
    --file-ext h5`` (tifraw, records == the chips, CRCs checked) ->
    ``train --mode tifraw`` (10 steps, falling loss); (d) HDF5 and
    NetCDF-4 request bodies served == ``Trainer.predict`` of the port's
    decode (phase 12's trained U-Net), the committed fixture with
    external storage and a truncated body answer 400; (e) the committed
    fixtures of ``tests/data/hdf5`` decode to their ``.npz``; (f) decode
    MP/s and sniff us of a band in each layout on one host thread."""
    import glob
    import io
    import threading
    import urllib.error
    import urllib.request
    import torch
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.raster.image import (
        decode_image_bytes, sniff_image_info)
    from dl_image_segmentation_tpu_torch.records.parsers import (
        parse_encoded_gdal_proto_wrapped)
    from dl_image_segmentation_tpu_torch.records.tfrecord import read_records
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, make_http_server, scale_image)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    t_phase = time.perf_counter()
    log(f"phase 13: HDF5 / NetCDF-4 on the card ({smi})")
    os.makedirs(tmp, exist_ok=True)
    out = {"seconds": {}, "card": smi}
    secs = out["seconds"]
    labels = share["base"][share["base"].index("--labels") + 1]
    sub_labels = os.path.join(tmp, "labels-sub.geojson")
    keys, (bx0, by0, bx1, by1) = sub_aoi_labels(labels, sub_labels)
    block = (bx0 - 200.0, by0 - 200.0, bx1 + 200.0, by1 + 200.0)

    # (a) the roots, (b) the exports
    t0 = time.perf_counter()
    hroot, groot, files = write_container_roots(tmp, block,
                                                kinds=tuple(HDF5_KINDS))
    secs["write roots"] = time.perf_counter() - t0
    log(f"  roots: 4 scenes x 13 bands, "
        + ", ".join(f"{HDF5_KINDS[k]} {len(v)}" for k, v in files.items())
        + f" HDF5 band files (each decodes to its array, geotransform, EPSG "
        f"and nodata), {secs['write roots']:.3f} s")
    base = with_flags(share["base"], labels=sub_labels)
    out["exports"], out["launches"], _ = export_roots(base, hroot, groot,
                                                      tmp, secs)

    # (c) the feed: phase 7's RGB chips as HDF5 pairs through tifraw
    tifs = {sub: tree_files(share["rgb_folder"], sub, "tif")
            for sub in ("images", "labels")}
    h5_dir = os.path.join(tmp, "h5-chips")
    decoded = {}
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(h5_dir, sub))
        for k, p in tifs[sub].items():
            g = read_geotiff(p)
            decoded[(sub, k)] = g.array
            layout = "chunked" if sub == "images" else "contiguous"
            with open(os.path.join(h5_dir, sub, f"{k}.h5"), "wb") as f:
                f.write(hdf5_utm(np.moveaxis(g.array, 2, 0),
                                 g.info.geotransform, g.info.epsg % 100,
                                 layout, name="chip",
                                 nodata=0 if sub == "images" else 255))
    shards = os.path.join(tmp, "h5-shards")
    cli_run(["to-tfrecords", "--name", "h5", "--directory", h5_dir, "--out",
             shards, "--shards", "4", "--workers", "4", "--engine", "mp",
             "--file-ext", "h5"], secs, "to-tfrecords --file-ext h5")
    n = 0
    for f in sorted(glob.glob(os.path.join(shards, "h5-*"))):
        for r in read_records(f, verify_crc=True):
            img, lbl, ident = parse_encoded_gdal_proto_wrapped(r)
            k = ident.decode().replace(":", "#")
            want_l = decoded[("labels", k)][:, :, 0]
            if not (np.array_equal(img, decoded[("images", k)])
                    and np.array_equal(np.asarray(lbl).reshape(
                        want_l.shape), want_l)):
                raise AssertionError(f"HDF5 record {k}: other pixels")
            n += 1
    if n != len(tifs["images"]):
        raise AssertionError(f"{n} HDF5 records, not {len(tifs['images'])}")
    mlog = os.path.join(tmp, "h5.jsonl")
    cli_run(["train", "--records", os.path.join(shards, "h5-*"), "--mode",
             "tifraw", "--classes", "10", "--steps", "10", "--log-every", "1",
             "--workers", "1", "--metrics-log", mlog], secs,
            "train --mode tifraw (HDF5)")
    losses = [json.loads(ln)["loss"] for ln in open(mlog)]
    if len(losses) != 10 or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train tifraw (HDF5): losses {losses}")
    out["losses"] = losses
    log(f"  to-tfrecords --file-ext h5: tifraw records == the chips ({n}, "
        f"CRCs checked); train --mode tifraw from HDF5 chips: loss "
        f"{losses[0]:.4f} -> {np.mean(losses[-3:]):.4f}")

    # (d) request bodies
    k0 = sorted(tifs["images"])[0]
    chip = decoded[("images", k0)]
    gt0 = read_geotiff(tifs["images"][k0]).info.geotransform
    bodies = {"hdf5": hdf5_utm(np.moveaxis(chip, 2, 0), gt0, 43, "chunked"),
              "netcdf4": hdf5_utm(np.moveaxis(chip, 2, 0), gt0, 43,
                                  "contiguous")}
    fixtures = sorted(glob.glob(os.path.join(HDF5_FIXTURES, "*.h5")))
    refused = {"external storage": open(os.path.join(
        HDF5_FIXTURES, "external.h5"), "rb").read(),
        "truncated": bodies["hdf5"][:len(bodies["hdf5"]) // 3]}
    trainer = Trainer(TrainConfig(num_classes=10, batch_size=8))
    trainer.restore_checkpoint(share["container_ckpt"])
    ps = PredictServer(trainer)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    names = sorted(bodies)
    served, answers = {}, {}

    def post(kind):
        req = urllib.request.Request(url, data=bodies[kind], method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served[kind] = np.load(io.BytesIO(r.read()))
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(k,)) for k in names]
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=300)
        secs["serve 2 HDF5 bodies"] = time.perf_counter() - t0
        want = trainer.predict(np.stack([scale_image(
            decode_image_bytes(bodies[k]).array, "auto") for k in names]))
        for i, k in enumerate(names):
            if k not in served or not np.array_equal(served[k], want[i]):
                raise AssertionError(f"served {k} body differs from predict")
        for what, body in refused.items():
            try:
                urllib.request.urlopen(urllib.request.Request(
                    url, data=body, method="POST"), timeout=120)
                raise AssertionError(f"an HDF5 body ({what}) was served")
            except urllib.error.HTTPError as e:
                answers[what] = (e.code, e.read().decode())
        code, msg = answers["external storage"]
        if code != 400 or "refused" not in msg:
            raise AssertionError(f"external storage body: {code} {msg}")
        code, msg = answers["truncated"]
        if code != 400 or "corrupt or unreadable HDF5" not in msg:
            raise AssertionError(f"truncated body: {code} {msg}")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        ps.close()
    del trainer, ps
    torch.cuda.empty_cache()
    log(f"  serve: {', '.join(names)} bodies in "
        f"{secs['serve 2 HDF5 bodies']:.3f} s, class maps == predict of the "
        "port's decode; external storage and truncated bodies: 400 "
        f"({answers['external storage'][1][:60]!r}, "
        f"{answers['truncated'][1][:60]!r})")

    # (e) the committed fixtures (h5py wrote them; the card's host has none)
    checked = []
    for path in fixtures:
        if path.endswith("external.h5"):
            continue
        g = decode_image_bytes(open(path, "rb").read())
        want = np.load(path[:-3] + ".npz")
        wi = json.loads(str(want["info"]))
        got = json.loads(json.dumps(vars(g.info)))
        if (g.array.dtype != want["array"].dtype or g.array.tobytes()
                != want["array"].tobytes() or got != wi):
            raise AssertionError(f"{path}: decodes to other pixels or "
                                 f"metadata ({got} != {wi})")
        checked.append(os.path.basename(path))
    if len(checked) < 11:
        raise AssertionError(f"committed HDF5 fixtures: {checked}")
    out["fixtures"] = checked
    log(f"  committed fixtures == their .npz (the JAX package's decode): "
        f"{', '.join(checked)}")

    # (f) decode MP/s and sniff us on one host thread
    out["decode_mp_per_s"], out["sniff_us"] = {}, {}
    for kind, paths in files.items():
        data = open(paths[0], "rb").read()
        px = decode_image_bytes(data).array.shape
        calls, took = rate(decode_image_bytes, [data], min_s=0.3)
        out["decode_mp_per_s"][HDF5_KINDS[kind]] = (
            calls * px[0] * px[1] / 1e6 / took)
        calls, took = rate(sniff_image_info, [data], min_s=0.2)
        out["sniff_us"][HDF5_KINDS[kind]] = took / calls * 1e6
    log(f"  decode MP/s ({px[1]} x {px[0]} uint16 band; one host thread): "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    out["decode_mp_per_s"].items())
        + "; sniff us: " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in out["sniff_us"].items())
        + f"; host of {smi}")
    secs["phase"] = time.perf_counter() - t_phase
    log(f"  phase 13: {secs['phase']:.1f} s")
    return out


def parallel_phase(smi, tmp, share):
    """Phase 14: training across a torch.distributed world (``parallel/``),
    after phase 7 (its tifarr shards of 256 px RGB chips). (a) A NCCL
    world of one joined through ``initialize()`` from the environment:
    TrainConfig defaults with 10 classes (bf16), 5 steps with
    ``mesh=None`` and 5 with ``fsdp=True``, both bitwise the plain
    trainer's losses and parameters on the same batches, fed through
    ``host_shard_files`` by rank; the step's CUDA-event ms beside the
    plain step's. (b) A gloo world of 4 ranks on the one card
    (``dryrun_multichip(4, "cuda:0")``: one process and one CUDA context
    a rank; NCCL refuses a card that two ranks share): DP 4x1, TP 2x2,
    spatial 2x2, FSDP 4x1 and FSDP+TP 2x2 of the U-Net, and spatial 2x2
    of DeepLab-lite, SegFormer-lite and the U-Net at 272 px (bands of 136
    rows), at the TrainConfig width in fp32 with clipping at 1.0, 3 steps
    each on one global batch of 8, held against the one-process trainer
    of the same config in this process: losses within 1e-4 relative, the
    first step's gradients and global norm within the gradient bars,
    parameters within 2 x 3 x lr (a witness, one process through torch's
    own CUDA convs, inside the same bars), each world's checkpoint
    restored here bitwise, and its class maps equal to this process's
    from the same (restored) parameters wherever the top two
    probabilities are apart; int8 inference under TP 2x2 and calibrated
    int8-static on bands against one process's int8 (5e-2 of the
    largest logit, 99.5% of the class maps). Per rank: bytes of
    parameters and Adam moments, a step's peak memory above its state,
    step ms, the leaves TP and FSDP shard, and in the DP world the rows
    its feed decoded of phase 7's shards. After the steps of DP 4x1 and
    TP 2x2, and on int8 TP 2x2, the world serves: the primary's
    ``PredictServer`` behind ``make_http_server`` on loopback answers a
    full batch, a partial batch and probability requests, bitwise the
    world's own predict, while the other ranks follow; requests/s and
    p50 of 4 more full batches."""
    import socket
    import torch
    import torch.distributed as dist
    from dl_image_segmentation_tpu_torch.parallel import initialize
    from dl_image_segmentation_tpu_torch.pipeline.input import TFRecordFeed
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    log(f"phase 14: training across a torch.distributed world ({smi})")
    out = {}
    pattern = os.path.join(share["shards"], "smoke-*")
    cfg = TrainConfig(num_classes=10)
    feed = iter(TFRecordFeed(pattern, "tifarr", batch_size=cfg.batch_size,
                             image_size=cfg.image_size, scale="raw",
                             num_workers=2, seed=5))
    batches = [next(feed) for _ in range(5)]
    del feed

    def run(tr):
        losses = [tr.train_step(x, y)["loss"] for x, y in batches]
        return losses, {n: p.detach().clone()
                        for n, p in tr.state.params.items()}

    def step_ms(tr):
        x, y = tr.place_batch(*batches[0])
        return cuda_ms(lambda: tr.train_step_async(x, y), 5)

    # (a) the plain trainer outside any world, then a NCCL world of one
    t0 = time.perf_counter()
    plain = Trainer(cfg)
    want, want_p = run(plain)
    plain_ms = step_ms(plain)
    del plain
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "DLSEG_NUM_PROCESSES": "1", "DLSEG_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize()
        if not dist.is_initialized() or dist.get_backend() != "nccl":
            raise AssertionError("initialize() formed no NCCL world")
        files = TFRecordFeed(pattern, "tifarr", batch_size=1).files
        if len(files) != 4:
            raise AssertionError(f"host_shard_files gave rank 0 {files}")
        rows = []
        for name, over in (("mesh=None", {}), ("fsdp=True", {"fsdp": True})):
            tr = Trainer(TrainConfig(num_classes=10, **over))
            got, got_p = run(tr)
            same = got == want and all(torch.equal(got_p[n], want_p[n])
                                       for n in want_p)
            ms = step_ms(tr)
            rows.append({"run": name, "mesh": dict(tr.mesh.shape),
                         "losses": got, "bitwise_equal": same,
                         "step_ms": ms, "plain_step_ms": plain_ms})
            log(f"  (a) NCCL world of one, {name}: mesh {tr.mesh.shape}, 5 "
                f"bf16 steps at batch {cfg.batch_size}, losses and "
                f"parameters bitwise the plain trainer's: {same}; step "
                f"{ms:.4f} ms (CUDA events) beside the plain step's "
                f"{plain_ms:.4f} ms ({smi})")
            del tr
            if not same:
                raise AssertionError(f"world of one ({name}): losses {got} "
                                     f"differ from the plain {want}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["world_of_one"] = rows
    out["world_of_one_seconds"] = time.perf_counter() - t0

    out.update(world_of_four(smi, tmp, pattern, batches))
    out["seconds"] = out["world_of_one_seconds"] + out["world_of_four"
                                                       "_seconds"]
    log(f"  phase 14: {out['seconds']:.1f} s (world of one "
        f"{out['world_of_one_seconds']:.1f} s, world of four "
        f"{out['world_of_four_seconds']:.1f} s with its spawn and "
        "references)")
    return out


def world_of_four(smi, tmp, pattern, batches, mode="tifarr"):
    """Phase 14 (b): a gloo world of 4 ranks on the one card, full width
    at fp32, clipping at 1.0 (the clip's global norm counts each shard
    once); see :func:`parallel_phase`. ``pattern``: the shards (of
    ``mode``) that the DP world's feed decodes its rows of; ``batches``:
    host batches of 256 px chips, the first of which the steps take."""
    import hashlib
    import torch
    from dl_image_segmentation_tpu_torch.parallel.dryrun import (
        dryrun_multichip, seeded_batches)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    out = {}
    t0 = time.perf_counter()
    base = dict(num_classes=10, batch_size=8, precision="fp32",
                grad_clip_norm=1.0)
    x, y = (a[:8] for a in batches[0])
    # 272 px: bands of 136 rows, not a multiple of s2d * 2**levels = 32
    x272, y272 = seeded_batches(dict(base, image_size=272), 1, 5)[0]
    # config: (one-process config, its batch); each regime: (config,
    # n_model, its own fields)
    configs = {"unet": (base, (x, y)),
               "deeplab": (dict(base, model="deeplab"), (x, y)),
               "segformer": (dict(base, model="segformer"), (x, y)),
               "unet 272": (dict(base, image_size=272), (x272, y272))}
    regimes = {
        "dp 4x1": ("unet", 1, {}),
        "tp 2x2": ("unet", 2, {}),
        "spatial 2x2": ("unet", 2, {"spatial": True}),
        "fsdp 4x1": ("unet", 1, {"fsdp": True}),
        "fsdp+tp 2x2": ("unet", 2, {"fsdp": True}),
        "spatial deeplab 2x2": ("deeplab", 2, {"spatial": True}),
        "spatial segformer 2x2": ("segformer", 2, {"spatial": True}),
        "spatial unet 272 2x2": ("unet 272", 2, {"spatial": True}),
    }
    # int8 inference on sharded layers, against one process's int8
    int8 = {"int8 tp 2x2": (2, {"quantize": "int8"}),
            "int8-static spatial 2x2": (2, {"quantize": "int8-static",
                                            "spatial": True})}
    specs = {}
    for name, (kind, nm, over) in regimes.items():
        cfg, (bx, by) = configs[kind]
        specs[name] = {"n_model": nm, "config": dict(cfg, n_model=nm, **over),
                       "batches": [(bx, by)] * 3, "eval": (bx, by)}
    # the data plane: phase 7's tifarr shards, each rank decoding its rows
    specs["dp 4x1"].update(data_plane=True, shards=pattern, mode=mode)
    for name, (nm, over) in int8.items():
        specs[name] = {"n_model": nm, "config": dict(base, n_model=nm,
                                                     **over),
                       "batches": [(x, y)], "eval": (x, y), "infer": True}
    # the world's PredictServer over HTTP on the primary, the other ranks
    # following: after the steps of DP and TP, and on int8 TP
    for name in SERVED_REGIMES:
        specs[name]["serve"] = {"rounds": 4}
    work = os.path.join(tmp, "world")
    res = dryrun_multichip(4, "cuda:0", specs, workdir=work)
    world_s = time.perf_counter() - t0

    def steps(cfg, bx, by, cudnn):
        """3 one-process steps on the world's batch: losses, the first
        step's clipped gradients and norm, the parameters, the trainer
        (``cudnn=False``: torch's own CUDA convs, the same sums in other
        orders: the witness)."""
        tr = Trainer(TrainConfig(**cfg))
        losses = []
        with torch.backends.cudnn.flags(enabled=cudnn):
            for i in range(3):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                losses.append(tr.train_step(bx, by)["loss"])
                if i == 0:
                    tr.peak_bytes = (torch.cuda.max_memory_allocated()
                                     - resident)
                    norm = float(tr.grad_norm)
                    grads = {n: p.grad.detach().cpu()
                             for n, p in tr.state.params.items()}
        params = {n: p.detach().cpu().numpy().copy()
                  for n, p in tr.state.params.items()}
        return losses, norm, grads, params, tr

    def grad_gap(grads, norm, want_grads, want_norm):
        """(the norm's relative difference, the largest leaf's difference
        over its bar: the leaf's norm x GRAD_RTOL plus the whole
        gradient's x GRAD_ATOL)"""
        whole = float(torch.sqrt(sum(g.double().square().sum()
                                     for g in want_grads.values())))
        worst = max(float((grads[n] - w).norm())
                    / (GRAD_RTOL * float(w.norm()) + GRAD_ATOL * whole)
                    for n, w in want_grads.items())
        return abs(norm - want_norm) / want_norm, worst

    def param_gap(params, want):
        return max(float(np.abs(params[n] - v).max())
                   for n, v in want.items())

    t1 = time.perf_counter()
    wit_losses, wit_norm, wit_grads, wit_p, wit = steps(base, x, y, False)
    wit_probs = wit.predict_probs(x[:7])
    del wit
    refs = {}
    for kind, (cfg, (bx, by)) in configs.items():
        losses, norm, grads, params, tr = steps(cfg, bx, by, True)
        probs = tr.predict_probs(bx[:7])
        srt = np.sort(probs, axis=-1)
        refs[kind] = {"losses": losses, "norm": norm, "grads": grads,
                      "params": params, "trainer": tr, "batch": (bx, by),
                      "classes": probs.argmax(-1),
                      "apart": srt[..., -1] - srt[..., -2] > 1e-4}
    ref = refs["unet"]
    bound = 2 * 3 * ref["trainer"].config.learning_rate
    w_norm_rel, w_worst = grad_gap(wit_grads, wit_norm, ref["grads"],
                                   ref["norm"])
    witness = {
        "losses": wit_losses, "grad_norm": wit_norm,
        "grad_norm_rel_diff": w_norm_rel, "grad_worst_over_bar": w_worst,
        "max_param_diff": param_gap(wit_p, ref["params"]),
        "class_maps_disagree_where_apart": float(
            (wit_probs.argmax(-1) != ref["classes"])[ref["apart"]].mean()),
        "seconds": time.perf_counter() - t1}
    log(f"  (b) the witness, one process through torch's own CUDA convs "
        f"(cuDNN off): losses {wit_losses} vs cuDNN's {ref['losses']}; "
        f"first gradient norm {wit_norm} vs {ref['norm']} "
        f"({w_norm_rel:.3g} relative); largest leaf difference "
        f"{w_worst:.3g} of its bar; largest parameter difference after 3 "
        f"steps {witness['max_param_diff']:.3g} (bound 2 x 3 x lr = "
        f"{bound:g}); class maps differ on "
        f"{witness['class_maps_disagree_where_apart']:.3%} of the pixels "
        f"whose top two are > 1e-4 apart")
    bad_witness = (w_norm_rel > NORM_RTOL or w_worst > 1
                   or witness["max_param_diff"] > bound)
    rows = []
    for name, (kind, _, _) in regimes.items():
        r, want = res[name], refs[kind]
        bx = want["batch"][0]
        tr = want["trainer"]
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                    want["losses"])]
        norm_rel, worst = grad_gap(r["grads"], r["grad_norms"][0],
                                   want["grads"], want["norm"])
        tr.restore_checkpoint(r["checkpoint"])
        got = {n: p.detach().cpu().numpy()
               for n, p in tr.state.params.items()}
        restored = all(hashlib.sha256(v.tobytes()).hexdigest()
                       == r["param_digests"][n] for n, v in got.items())
        diff = param_gap(got, want["params"])
        # the world's class maps against this process's from the same
        # (restored) parameters, and against its own steps'
        probs = tr.predict_probs(bx[:7])
        srt = np.sort(probs, axis=-1)
        apart = srt[..., -1] - srt[..., -2] > 1e-4
        classes = probs.argmax(-1)
        maps = bool((r["predict"][apart] == classes[apart]).all())
        own = float((r["predict"] != want["classes"])[want["apart"]].mean())
        ranks = [{"param_bytes": k["param_bytes"],
                  "moment_bytes": k["moment_bytes"],
                  "activation_bytes": k["activation_bytes"],
                  "step_ms": k["step_ms"],
                  "feed_rows": k.get("feed_rows"),
                  "feed_decoded": k.get("feed_decoded"),
                  "sharded": sorted(set(k["sharded"].values())),
                  "n_sharded": len(k["sharded"]),
                  "checkpoint_equal": k["checkpoint_equal"]}
                 for k in r["ranks"]]
        row = {"regime": name, "mesh": r["mesh"], "losses": r["losses"],
               "one_process_losses": want["losses"], "loss_rel_diff": rel,
               "grad_norm": r["grad_norms"][0],
               "grad_norm_rel_diff": norm_rel,
               "grad_worst_over_bar": worst,
               "max_param_diff": diff, "checkpoint_restores_here": restored,
               "class_maps_equal_where_apart": maps,
               "apart_share": float(apart.mean()),
               "class_maps_disagree_own_steps": own,
               "regime_seconds": r["ranks"][0]["seconds"],
               "one_process_activation_bytes": tr.peak_bytes,
               "ranks": ranks}
        rows.append(row)
        log(f"  (b) gloo world of 4 on the card, {name}: losses "
            f"{r['losses']} vs one process {want['losses']} (largest "
            f"relative difference {max(rel):.3g}); first gradient norm "
            f"{r['grad_norms'][0]} ({norm_rel:.3g} relative), largest leaf "
            f"difference {worst:.3g} of its bar; largest parameter "
            f"difference {diff:.3g} (bound {bound:g}); its checkpoint "
            f"restores here bitwise: {restored}; class maps equal to this "
            f"process's from the same parameters where the top two are "
            f"apart ({apart.mean():.1%} of pixels): {maps}; against its "
            f"own steps' they differ on {own:.3%} of those pixels; "
            f"{r['ranks'][0]['seconds']:.1f} s in the world; one process's "
            f"step at batch 8 peaks {tr.peak_bytes / 2**20:.1f} MiB above "
            "its state")
        for i, k in enumerate(ranks):
            act = ("not measured" if k["activation_bytes"] is None
                   else f"{k['activation_bytes'] / 2**20:.1f} MiB")
            fed = ("" if k["feed_rows"] is None else
                   f", the feed decoded {k['feed_decoded']} records (rows "
                   f"{k['feed_rows'][0]}-{k['feed_rows'][1] - 1} of each "
                   f"batch of 8)")
            log(f"    rank {i}: parameters {k['param_bytes'] / 2**20:.1f} "
                f"MiB, Adam moments {k['moment_bytes'] / 2**20:.1f} MiB, "
                f"a step's peak above its state {act}, steps "
                f"{', '.join(f'{v:.1f}' for v in k['step_ms'])} ms, "
                f"{k['n_sharded']} leaves sharded over {k['sharded']}, "
                f"checkpoint restored in the world bitwise: "
                f"{k['checkpoint_equal']}{fed}")
        if (max(rel) > 1e-4 or norm_rel > NORM_RTOL or worst > 1
                or diff > bound or not restored or not maps
                or not all(k["checkpoint_equal"] for k in ranks)):
            raise AssertionError(f"world regime {name} failed: {row}")
    if bad_witness:
        raise AssertionError(f"the witness is outside the bars the world "
                             f"is held to: {witness}")
    for kind in refs:
        refs[kind]["trainer"] = None
    refs.clear()
    # int8 on sharded layers: logits of the 8 images against one
    # process's int8 (int8-static calibrated on the same batch), held to
    # the int8 bars of tests/test_torch_quant.py (5e-2 of the largest
    # logit, class maps equal on 99.5%)
    int8_rows = []
    for name, (nm, over) in int8.items():
        tr = Trainer(TrainConfig(**dict(base, **{
            k: v for k, v in over.items() if k != "spatial"})))
        tr.calibrate([(x, y)], max_batches=1)
        want = torch.cat([lg.cpu() for lg in tr._chunked_logits(x)]
                         ).numpy()
        del tr
        got = res[name]["logits"]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        same = float((got.argmax(-1) == want.argmax(-1)).mean())
        row = {"regime": name, "mesh": res[name]["mesh"],
               "bitwise_equal": bool(np.array_equal(got, want)),
               "max_err_of_largest": err, "class_maps_equal": same,
               "seconds": res[name]["ranks"][0]["seconds"]}
        int8_rows.append(row)
        log(f"  (b) {name}: logits of 8 images against one process's int8 "
            f"(bitwise equal: {row['bitwise_equal']}), largest difference "
            f"{err:.3g} of the largest logit (bar 5e-2), class maps equal "
            f"on {same:.4%} (bar 99.5%); {row['seconds']:.1f} s in the "
            f"world")
        if err > 5e-2 or same < 0.995:
            raise AssertionError(f"int8 regime {name} failed: {row}")
    out["world_server"] = world_server_rows(smi, res)
    fs = [row for row in rows if row["regime"] == "fsdp 4x1"][0]
    dp = [row for row in rows if row["regime"] == "dp 4x1"][0]
    if not fs["ranks"][0]["param_bytes"] < dp["ranks"][0]["param_bytes"]:
        raise AssertionError("FSDP stored no less than DP a rank")
    if [k["feed_decoded"] % 2 for k in dp["ranks"]] != [0] * 4 or \
            [tuple(k["feed_rows"]) for k in dp["ranks"]] != [
                (2 * i, 2 * i + 2) for i in range(4)]:
        raise AssertionError(f"the DP feed decoded other rows: "
                             f"{[k['feed_rows'] for k in dp['ranks']]}")
    out["world_of_four"] = rows
    out["int8"] = int8_rows
    out["witness"] = witness
    out["world_spawn_seconds"] = world_s
    out["world_of_four_seconds"] = time.perf_counter() - t0
    return out


# phase 14's regimes whose world also serves (dryrun's ``serve`` field)
SERVED_REGIMES = ("dp 4x1", "tp 2x2", "int8 tp 2x2")


def world_server_rows(smi, res):
    """Phase 14's world server: for each served regime, the maps of a full
    batch of requests at once, of a partial batch, the probability
    requests and a uint8 and a uint16 chip (kept in their dtype) must be
    bitwise the world's own predict / predict_probs of the same images;
    requests/s and the p50 of the timed rounds (4 full
    batches of concurrent requests over loopback HTTP)."""
    rows = []
    for name in SERVED_REGIMES:
        sv = res[name]["serve"]
        k = len(sv["partial"])
        same = (np.array_equal(sv["maps"], sv["predict"])
                and np.array_equal(sv["partial"], sv["predict"][:k])
                and np.array_equal(sv["probs"], sv["predict_probs"][:2])
                and len(sv["typed"]) == 2
                and all(np.array_equal(a, b) for a, b in
                        zip(sv["typed"], sv["predict_typed"])))
        lat = sorted(sv["request_seconds"])
        row = {"regime": name, "bitwise_equal_world_predict": same,
               "requests": len(lat), "dispatches": sv["dispatches"],
               "requests_per_s": sv["requests_per_s"],
               "p50_ms": 1e3 * float(np.median(lat)),
               "p90_ms": 1e3 * float(np.percentile(lat, 90))}
        rows.append(row)
        log(f"  (b) world server, {name}: served maps (a full batch of "
            f"{len(sv['maps'])}, a partial batch of {k}, a uint8 and a "
            f"uint16 chip) and probabilities bitwise the world's predict: "
            f"{same}; {row['requests']} timed "
            f"requests in {row['dispatches']} dispatches all told: "
            f"{row['requests_per_s']:.2f} requests/s, p50 "
            f"{row['p50_ms']:.1f} ms, p90 {row['p90_ms']:.1f} ms (loopback "
            f"HTTP, 4 gloo ranks on one card; {smi})")
        if not same:
            raise AssertionError(f"world server {name}: served maps differ "
                                 "from the world's predict")
    return rows


def build_export_phases(card):
    """Phases 2-4: the build, with phase 4's CPU exports in a thread
    beside it; each kernel against its plain version; the end-to-end
    exports on the card, held against the CPU's."""
    from dl_image_segmentation_tpu_torch import kernels
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cpu_refs = {}

    def cpu_side():
        try:
            cpu_refs.update(cpu_exports(tmp))
        except BaseException as e:  # noqa: BLE001 -- raised after join
            cpu_refs["error"] = e
    cpu_thread = threading.Thread(target=cpu_side, name="cpu-exports")
    try:
        write_export_labels(tmp)
        cpu_thread.start()
        log("phase 2: build")
        for name, (secs, text) in kernels.build_all().items():
            n, spilled = spills(text)
            log(f"  {name}: built in {secs:.1f} s (wall clock, parallel "
                f"builds, phase 4's CPU exports beside them); {n} kernels, "
                f"{len(spilled)} with spills or a stack frame")
            for line in text.splitlines():
                if "Used" in line or "spill" in line or "Compiling" in line:
                    log("   ", line.strip())
        t0 = time.perf_counter()
        cpu_thread.join()
        log(f"  phase 4's CPU exports ended {time.perf_counter() - t0:.1f} "
            f"s after the build")
        if "error" in cpu_refs:
            raise cpu_refs["error"]
        rows = kernel_phase()
        launches, runs = export_phase(tmp, card, cpu_refs)
    finally:
        if cpu_thread.is_alive():
            cpu_thread.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return rows, launches, runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from dl_image_segmentation_tpu_torch import kernels

    # phase 8's fakes listen on loopback: urllib must not send those
    # requests to a proxy that the machine's environment names
    os.environ["NO_PROXY"] = os.environ["no_proxy"] = "127.0.0.1,localhost"
    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1: device {card}, count {count}, nvidia-smi: {smi}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    rows, launches, runs = build_export_phases(card)
    results = []
    for phase in (serving_phase, training_phase):
        t0 = time.perf_counter()
        results.append(phase(smi))
        log(f"  {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    serving, training = results
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    share = {}
    try:
        t0 = time.perf_counter()
        cli = cli_phase(smi, work, share)
        log(f"  cli_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        remote = remote_phase(smi, share)
        log(f"  remote_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        codecs = codec_phase(smi, os.path.join(work, "codecs"), share)
        log(f"  codec_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        variants = codec_variants_phase(smi, os.path.join(work, "variants"))
        log(f"  codec_variants_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pil_formats = pil_formats_phase(smi, os.path.join(work, "pil"))
        log(f"  pil_formats_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        safe = safe_phase(smi, os.path.join(work, "safe"), share)
        log(f"  safe_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        orbax_ck = orbax_phase(smi, os.path.join(work, "orbax"), share)
        log(f"  orbax_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        containers = containers_phase(smi, os.path.join(work, "containers"),
                                      share)
        log(f"  containers_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        hdf5 = hdf5_phase(smi, os.path.join(work, "hdf5"), share)
        log(f"  hdf5_phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for c in kernels.COUNTERS:
            c.reset()
        world = parallel_phase(smi, os.path.join(work, "parallel"), share)
        world["launches"] = {c.name: c.count for c in kernels.COUNTERS}
        log(f"  parallel_phase: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out = []
    for c in kernels.COUNTERS:
        cases = rows[c.name]
        main_case = cases[1] if c.name == "masked_median" else cases[0]
        out.append({
            "name": c.name, "route": "cuda", "source": c.source,
            "replaces": c.replaces, "launches": launches[c.name],
            "launches_by_phase": {
                "4": launches[c.name], "7": cli["launches"][c.name],
                "8": remote["launches"][c.name],
                "10": safe["launches"][c.name],
                "12": containers["launches"][c.name],
                "13": hdf5["launches"][c.name],
                "14": world["launches"][c.name],
                "15": variants["launches"][c.name],
                "16": pil_formats["launches"][c.name]},
            "equal": all(r["equal"] for r in cases),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main_case["ms"], "wrapper_ms": main_case["wrapper_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            "case": main_case["case"], "cases": cases})
    log(json.dumps({"serving": serving}))
    log(json.dumps({"training": training}))
    log(json.dumps({"cli": cli}))
    log(json.dumps({"remote": remote}))
    log(json.dumps({"codecs": codecs}))
    log(json.dumps({"codec_variants": variants}))
    log(json.dumps({"pil_formats": pil_formats}))
    log(json.dumps({"safe": safe}))
    log(json.dumps({"orbax": orbax_ck}))
    log(json.dumps({"containers": containers}))
    log(json.dumps({"hdf5": hdf5}))
    log(json.dumps({"parallel": world}))
    log(f"seconds {time.perf_counter() - t_start:.1f}; runs "
        f"{json.dumps(runs)}")
    log(f"{smi}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
