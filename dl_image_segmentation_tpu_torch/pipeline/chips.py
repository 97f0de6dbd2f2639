"""Chip-creation pipeline: tile planning, per-tile jobs, compositing
dispatch, label burning, GeoTIFF pair writing.

PyTorch counterpart of the JAX package's pipeline/chips.py, the
drop-in facade for the reference's _descartes_img_chips module
(dl_segmentation_utils/_descartes_img_chips.py), with the remote
Descartes Labs service replaced by the pluggable Catalog (catalog/) and
local tile-grid math (geo/tilegrid.py), and the two hot loops --
cloud-masked median compositing and vector->raster burning -- running
as hand-written CUDA kernels (ops/compositing.py, ops/rasterize.py).

Entry points take ``device=None``, which means the CUDA card; the CPU
runs only with ``device="cpu"``. Failures keep the reference's
(job, None, None) retry protocol only for the catalog gather (missing
scenes, unreadable sources); errors of the device stage propagate.

Preserved public names and semantics:
  DLTileJobConfig, OGRLabelDataDesc, DLSampleCreationConfig,
  create_chips_for_tile, create_img_array_for_tile,
  create_cloudmasked_s2_array, create_label_array_for_tile,
  stack_products_for_tile
Preserved on-disk contracts:
  /images + /labels folders, identically-named LZW tiled GeoTIFFs,
  filename = tile key with ':' -> '#', label nodata in metadata, folder
  naming '{tag}[-cf{frac}]_{res}m_{pad}pad_{size}_{loc}_{year}'.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from .. import storage
from ..catalog.base import (Catalog, get_default_catalog,
                            validate_resampler)
from ..device import resolve_device
from ..geo import crs as _crs
from ..geo.spatialindex import BBoxGrid, feature_bboxes
from ..geo.tilegrid import Tile, tiles_from_shape
from ..geo.vector import VectorLayer, open_vector
from ..ops.compositing import (masked_median_composite,
                               nearest_valid_mosaic)
from ..ops.rasterize import rasterize
from ..raster.geotiff import write_geotiff

S2_PRODUCT = "sentinel-2:L1C"
S2_CLOUD_PRODUCT = "sentinel-2:L1C:dlcloud:v1"


class DLTileJobConfig:
    """Pickleable per-tile job description (reference :12-102). Carries
    everything needed to create one image/label chip pair."""

    def __init__(self, dltile, out_folder_base, dl_product, ref_date,
                 labels_data, min_date=None, max_date=None,
                 max_cloud_fraction=None, label_attr=None, label_lyr_num=0,
                 bands="red green blue", label_nodata_value=255,
                 catalog: Optional[Catalog] = None):
        self.DLTILE = dltile if isinstance(dltile, Tile) \
            else Tile.from_key(str(dltile))
        self.OUTFOLDER = out_folder_base
        self.PRODUCT = dl_product
        self.TARGETDATE = ref_date
        self.MIN_DATE = min_date
        self.MAX_DATE = max_date
        self.MAX_CLOUD_FRACTION = max_cloud_fraction
        self.LABEL_DS = labels_data
        self.LABEL_BURN_ATTR = label_attr
        self.LABEL_LYR_NUM = label_lyr_num
        self.BANDS = bands
        self.LABEL_NODATA_VALUE = label_nodata_value
        self.CATALOG = catalog

    @classmethod
    def from_run_config(cls, run_config, dltile, out_folder_base, ref_date,
                        min_date=None, max_date=None,
                        max_cloud_fraction=None):
        lbl = run_config.LABEL_DATA()
        return cls(dltile=dltile, out_folder_base=out_folder_base,
                   dl_product=run_config.PRODUCT(), ref_date=ref_date,
                   min_date=min_date, max_date=max_date,
                   max_cloud_fraction=max_cloud_fraction,
                   labels_data=lbl.OGR_DATASET,
                   label_attr=lbl.BURN_ATTRIB,
                   label_lyr_num=lbl.get_layer_index(),
                   bands=run_config.BANDS(),
                   label_nodata_value=run_config.GET_LABEL_NODATA_VALUE(),
                   catalog=run_config.CATALOG())


class OGRLabelDataDesc:
    """Pointer to (vector dataset, layer, integer attribute)
    (reference :105-144). Works on GeoJSON/Shapefile via geo.vector."""

    def __init__(self, ogr_dataset, ogr_layer_name_or_idx=0,
                 attrib_to_burn=None):
        self.OGR_DATASET = ogr_dataset
        self.OGR_LAYER_REF = ogr_layer_name_or_idx
        self.BURN_ATTRIB = attrib_to_burn
        self._cached_layer_idx = None

    def get_layer_index(self):
        """Layer index in the dataset; -1 if a named layer is absent."""
        if isinstance(self.OGR_LAYER_REF, int):
            return self.OGR_LAYER_REF
        if self._cached_layer_idx is None:
            ds = open_vector(self.OGR_DATASET)
            self._cached_layer_idx = ds.get_layer_index(self.OGR_LAYER_REF)
        return self._cached_layer_idx


class DLSampleCreationConfig:
    """Run-level configuration + tile planner (reference :148-457).

    Stores tile size NET of padding (constructor takes the padded size;
    reference :221) and re-derives the total via _total_tile_size."""

    def __init__(self, tile_size, tile_padding, tile_res_m, dl_product,
                 bands, sample_folder_root, source_tag,
                 label_data_config: OGRLabelDataDesc,
                 label_coverage_config: Optional[OGRLabelDataDesc] = None,
                 max_cloud_fraction=None, label_nodata_value=255,
                 catalog: Optional[Catalog] = None):
        self._TILE_SIZE = tile_size - 2 * tile_padding
        self._TILE_PAD = tile_padding
        self._TILE_RES = tile_res_m
        self._LABEL_DATA = label_data_config
        self._LABEL_COVERAGE = label_coverage_config
        self._root = sample_folder_root
        self._tag = source_tag
        self._PRODUCT = dl_product
        self._BANDS = bands
        self._MAX_CLOUD_FRACTION = max_cloud_fraction
        self._LABEL_NDV = label_nodata_value
        self._catalog = catalog
        self._dl_tiles = None
        self._dl_tile_ids = None
        self._gdf_wgs84 = None
        self._gdf_coverage_wgs84 = None

    # -- getters/setters (reference's Java-style accessors) -------------
    def TILE_SIZE_PAD_RES(self, size_pad_res=None):
        if size_pad_res is None:
            return (self._TILE_SIZE, self._TILE_PAD, self._TILE_RES)
        s, p, r = size_pad_res
        s = s - (2 * p)
        if s != self._TILE_SIZE or p != self._TILE_PAD or r != self._TILE_RES:
            print("Updating tile configuration: tiles will be re-populated "
                  "on next request")
            self._TILE_SIZE = s
            self._TILE_PAD = p
            self._TILE_RES = r
            self._invalidate_tiles()
        return (self._TILE_SIZE, self._TILE_PAD, self._TILE_RES)

    def LABEL_DATA(self):
        return self._LABEL_DATA

    def LABEL_COVERAGE_DATA(self):
        return self._LABEL_COVERAGE

    def PRODUCT(self):
        return self._PRODUCT

    def BANDS(self):
        return self._BANDS

    def CATALOG(self):
        return self._catalog

    def GET_MAX_CLOUD_FRACTION(self):
        return self._MAX_CLOUD_FRACTION

    def SET_MAX_CLOUD_FRACTION(self, new_cf):
        self._MAX_CLOUD_FRACTION = new_cf

    def GET_LABEL_NODATA_VALUE(self):
        return self._LABEL_NDV

    def SET_LABEL_NODATA_VALUE(self, value):
        self._LABEL_NDV = value

    def _invalidate_tiles(self):
        self._dl_tiles = None
        self._dl_tile_ids = None

    # -- naming contracts (reference :292-317) ---------------------------
    def _tag_with_cf(self):
        if self._MAX_CLOUD_FRACTION is None:
            return self._tag
        return (f"{self._tag}-cf"
                f"{str(self._MAX_CLOUD_FRACTION).replace('.', 'p')}")

    def _total_tile_size(self):
        return self._TILE_SIZE + (2 * self._TILE_PAD)

    def images_dir_name(self, loc, year):
        """`tag[-cf]_resolution m_padding pad_tilesize_loc_year` under
        the configured root (reference :302-310)."""
        return storage.join(
            self._root,
            f"{self._tag_with_cf()}_{self._TILE_RES}m_{self._TILE_PAD}pad_"
            f"{self._total_tile_size()}_{loc}_{year}")

    def dataset_name(self, loc, year, tfrecord_type="arr"):
        return f"{self._tag_with_cf()}_{tfrecord_type}_{loc}_{year}"

    # -- tile planning ----------------------------------------------------
    def get_tiles(self, tile_ids=None):
        if self._dl_tiles is None:
            self._populate_tiles(tile_ids)
        return self._dl_tiles

    def get_tile_ids(self):
        if self._dl_tile_ids is None:
            self._populate_tiles()
        return self._dl_tile_ids

    def get_labeldata_wgs84_df(self) -> VectorLayer:
        """Label features reprojected to EPSG:4326 (reference
        :342-351; a VectorLayer stands in for the GeoDataFrame)."""
        if self._gdf_wgs84 is None:
            ds = open_vector(self._LABEL_DATA.OGR_DATASET)
            lyr = ds.get_layer(self._LABEL_DATA.get_layer_index())
            self._gdf_wgs84 = lyr.to_wgs84()
        return self._gdf_wgs84

    def get_label_coverage_wgs84_df(self) -> Optional[VectorLayer]:
        if self._gdf_coverage_wgs84 is not None:
            return self._gdf_coverage_wgs84
        if self._LABEL_COVERAGE is None:
            return None
        ds = open_vector(self._LABEL_COVERAGE.OGR_DATASET)
        lyr = ds.get_layer(self._LABEL_COVERAGE.get_layer_index())
        self._gdf_coverage_wgs84 = lyr.to_wgs84()
        return self._gdf_coverage_wgs84

    def _populate_tiles(self, tile_ids=None):
        if tile_ids is not None:
            # rebuild from saved keys: pure local math here (the
            # reference's slow server round-trip, :389-398, is gone)
            unique = sorted(set(tile_ids))
            self._dl_tiles = [Tile.from_key(k) for k in unique]
            self._dl_tile_ids = set(unique)
            return
        layer = self.get_label_coverage_wgs84_df()
        if layer is None:
            layer = self.get_labeldata_wgs84_df()
        seen = set()
        tiles: List[Tile] = []
        for feat in layer.features:
            for t in tiles_from_shape(feat.geometry, self._TILE_RES,
                                      self._TILE_SIZE, self._TILE_PAD):
                if t.key not in seen:
                    seen.add(t.key)
                    tiles.append(t)
        self._dl_tiles = tiles
        self._dl_tile_ids = seen

    def create_tile_job_configs(self, loc_label, year_label, ref_date,
                                min_date=None, max_date=None
                                ) -> List[DLTileJobConfig]:
        return [DLTileJobConfig.from_run_config(
                    self, dltile=t,
                    out_folder_base=self.images_dir_name(loc_label,
                                                         year_label),
                    ref_date=ref_date, min_date=min_date, max_date=max_date,
                    max_cloud_fraction=self._MAX_CLOUD_FRACTION)
                for t in self.get_tiles()]


# ---------------------------------------------------------------------------
# per-tile mosaic functions (reference :461-629)
# ---------------------------------------------------------------------------

def _debug_errors() -> bool:
    """DLSEG_DEBUG=1 re-raises catalog gather errors instead of
    returning None (the reference's retry protocol swallows them, which
    is right for production but opaque when debugging a catalog)."""
    return bool(os.environ.get("DLSEG_DEBUG"))


def _resolve_catalog(catalog) -> Catalog:
    return catalog if catalog is not None else get_default_catalog()


def _gather_nearest(ctx, product, reference_date, min_date, max_date,
                    max_cloud_fraction, band_list, cat):
    """Host-side gather for the nearest-to-date mosaic: returns
    (stack (S,H,W,B), valid (S,H,W), dist (S,)) or None when no
    scenes match."""
    scenes = cat.search(ctx, product, start=min_date, end=max_date,
                        max_cloud_fraction=max_cloud_fraction)
    if len(scenes) == 0:
        return None
    stack, valid = cat.load(scenes, ctx, band_list)
    dist = np.array(
        [abs((m.date - reference_date).days) for m in scenes],
        np.float32)
    return stack, valid, dist


def create_img_array_for_tile(ctx, product, reference_date, min_date=None,
                              max_date=None, bands="red green blue",
                              max_cloud_fraction=None, catalog=None,
                              device=None) -> Optional[np.ndarray]:
    """Nearest-to-reference-date valid-pixel mosaic (reference
    :571-629). Returns (H, W, B), or None when the catalog gather fails
    or finds no data."""
    cat = _resolve_catalog(catalog)
    band_list = bands.split() if isinstance(bands, str) else list(bands)
    try:
        gathered = _gather_nearest(ctx, product, reference_date,
                                   min_date, max_date,
                                   max_cloud_fraction, band_list, cat)
    except Exception:
        if _debug_errors():
            raise
        return None
    if gathered is None:
        return None
    stack, valid, dist = gathered
    mosaic, _ = nearest_valid_mosaic(stack, valid, dist, device=device)
    return mosaic.cpu().numpy().astype(stack.dtype)


def create_cloudmasked_s2_array(ctx, min_date=None, max_date=None,
                                bands="red green blue", catalog=None,
                                device=None
                                ) -> Optional[np.ma.MaskedArray]:
    """Cloud-masked temporal median composite (reference :521-568):
    stack all Sentinel-2 scenes in range, apply the separate cloud
    product's valid_cloudfree mask pixelwise, return the per-pixel
    median of unmasked values -- through the masked-median CUDA kernel
    (ops/compositing.masked_median_composite) instead of np.ma.median
    on the host. Returns a masked array (parity with np.ma.median), or
    None when the catalog gather fails or finds no data."""
    cat = _resolve_catalog(catalog)
    band_list = bands.split() if isinstance(bands, str) else list(bands)
    try:
        gathered = _gather_s2_masked(ctx, min_date, max_date, band_list,
                                     cat)
    except Exception:
        if _debug_errors():
            raise
        return None
    if gathered is None:
        return None
    stack, valid = gathered
    med, any_valid = masked_median_composite(stack, valid, device=device)
    return np.ma.masked_array(med.cpu().numpy(),
                              mask=~any_valid.cpu().numpy())


def _gather_s2_masked(ctx, min_date, max_date, band_list, cat):
    """Host-side gather for the cloud-masked median: returns
    (stack (S,H,W,B), valid (S,H,W)) or None when no scenes match."""
    s2_scenes = cat.search(ctx, S2_PRODUCT, start=min_date, end=max_date)
    if len(s2_scenes) == 0:
        return None
    stack, coverage = cat.load(s2_scenes, ctx, band_list)
    cloud_scenes = cat.search(ctx, S2_CLOUD_PRODUCT, start=min_date,
                              end=max_date)
    if cloud_scenes:
        # pair cloud scenes to S2 scenes by acquisition DATE, not
        # list position: positional pairing silently applies masks
        # to the wrong dates when one search is missing a scene (a
        # latent assumption in the reference,
        # _descartes_img_chips.py:557-563, deliberately improved).
        by_date = {}
        for cs in cloud_scenes:
            by_date.setdefault(cs.date, cs)
        matched = [by_date.get(m.date) for m in s2_scenes]
        unmatched = [m.scene_id for m, c in zip(s2_scenes, matched)
                     if c is None]
        if unmatched:
            print(f"WARNING: {len(unmatched)} S2 scene(s) have no "
                  f"same-date {S2_CLOUD_PRODUCT} scene (e.g. "
                  f"{unmatched[0]}); using coverage-only validity "
                  "for those scenes.")
        present = [c for c in matched if c is not None]
        valid = coverage.copy()
        if present:
            cmask, _ = cat.load(present, ctx, ["valid_cloudfree"])
            j = 0
            for i, c in enumerate(matched):
                if c is not None:
                    valid[i] &= cmask[j, :, :, 0] > 0
                    j += 1
    else:
        valid = coverage
    return stack, valid


def _gather_products(ctx, products, bands_per_product, resampler, cat):
    """Host-side gather for band stacking: [(stack, valid), ...] per
    product; raises RuntimeError when a product has no scenes."""
    gathered = []
    for i, product in enumerate(products):
        band_list = bands_per_product[i]
        band_list = band_list.split() if isinstance(band_list, str) \
            else list(band_list)
        scenes = cat.search(ctx, product)
        stack, valid = cat.load(scenes, ctx, band_list,
                                resampler=resampler)
        if len(stack) == 0:
            raise RuntimeError(f"no scenes for product {product}")
        gathered.append((stack, valid))
    return gathered


def _stack_gathered(gathered, device) -> np.ndarray:
    all_arrays = []
    for stack, valid in gathered:
        # first-wins == nearest with distance = scene index
        dist = np.arange(len(stack), dtype=np.float32)
        mosaic, _ = nearest_valid_mosaic(stack, valid, dist, device=device)
        all_arrays.append(mosaic.cpu().numpy().astype(stack.dtype))
    return np.dstack(all_arrays)


def stack_products_for_tile(ctx, products, bands_per_product,
                            resampler="near", catalog=None,
                            device=None) -> np.ndarray:
    """First-wins mosaic per product, all bands stacked (reference
    :472-518). No date filtering (whole-collection mosaic).

    resampler: any of catalog.base.RESAMPLERS ("near", "bilinear",
    "cubic", "cubicspline", "lanczos"), applied when scene rasters
    are windowed/resampled onto the tile grid (the reference forwards
    it to SceneCollection.mosaic, _descartes_img_chips.py:483,
    512-513); unknown values raise ValueError."""
    validate_resampler(resampler)
    cat = _resolve_catalog(catalog)
    return _stack_gathered(
        _gather_products(ctx, products, bands_per_product, resampler, cat),
        device)


# ---------------------------------------------------------------------------
# label burning (reference :633-689)
# ---------------------------------------------------------------------------

def _label_features_px(ctx, layer, attrib_to_burn, candidates=None):
    """Project a WGS84 vector layer into the tile's pixel space:
    [(rings_px, value), ...] ready for ops.rasterize.

    Features whose pixel-space bbox misses the padded canvas are
    dropped here: they can never burn a pixel (the rasterizer clips to
    the canvas), and keeping them would pad the packed edge arrays of
    EVERY feature to the layer-wide maximum edge count -- quadratic
    memory on large label datasets, where a 68 px tile sees only a
    handful of its 10^5 features.

    ``candidates``: optional ascending feature indices (from the
    layer's BBoxGrid spatial index) -- only these are projected, so a
    big export pays O(features near the tile) per tile, not
    O(all features) (GDAL filtered spatially inside RasterizeLayer for
    the reference, _descartes_img_chips.py:682-685). Ascending order
    preserves last-writer-wins burn ties."""
    # equator-referenced frame: lonlat_to_utm below returns negative
    # northings south of the equator (no false northing)
    gt = ctx.geotrans_equator
    zone = ctx.zone
    size = ctx.raster_size
    feats = []
    feature_list = layer.features if candidates is None else \
        [layer.features[i] for i in candidates]
    for f in feature_list:
        if attrib_to_burn:
            value = f.properties.get(attrib_to_burn)
            if value is None:
                continue
            value = float(value)
        else:
            value = 1.0
        rings_px = []
        on_canvas = False
        for rings in f.geometry.polygons():
            for ring in rings:
                e, n = _crs.lonlat_to_utm(ring[:, 0], ring[:, 1], zone)
                px = (e - gt[0]) / gt[1]
                py = (n - gt[3]) / gt[5]
                rings_px.append(np.stack([px, py], axis=1))
                if (px.size  # degenerate empty rings burn nothing
                        and px.max() >= -0.5 and px.min() <= size + 0.5
                        and py.max() >= -0.5 and py.min() <= size + 0.5):
                    on_canvas = True
        if rings_px and on_canvas:
            feats.append((rings_px, value))
    return feats


_layer_cache_lock = threading.Lock()
_layer_cache: dict = {}  # (path, layer_idx, mtime) -> (layer, BBoxGrid)
_LAYER_CACHE_MAX = 4


def _indexed_layer(label_data, layer_idx):
    """(wgs84 layer, BBoxGrid) for a vector dataset path, parsed and
    indexed ONCE per export (keyed by path+mtime): per-tile re-parsing
    plus all-features projection costs O(features x tiles) on large
    label sets. Non-path datasets (an in-memory VectorDataset) skip the
    cache."""
    key = None
    if isinstance(label_data, str):
        try:
            mtime = os.stat(label_data).st_mtime_ns
        except OSError:
            mtime = 0
        key = (os.path.abspath(label_data), layer_idx, mtime)
        with _layer_cache_lock:
            hit = _layer_cache.get(key)
        if hit is not None:
            return hit
    ds = open_vector(label_data) if isinstance(label_data, str) \
        else label_data
    layer = ds.get_layer(layer_idx).to_wgs84()
    grid = BBoxGrid(feature_bboxes(layer.features))
    if key is not None:
        with _layer_cache_lock:
            _layer_cache[key] = (layer, grid)
            while len(_layer_cache) > _LAYER_CACHE_MAX:
                _layer_cache.pop(next(iter(_layer_cache)))
    return layer, grid


def _tile_lonlat_bbox(ctx):
    """The padded tile's lon/lat bbox, with a margin of ~one pixel in
    degrees so border-touching features stay in."""
    return _crs.utm_bounds_to_lonlat_bbox(
        ctx.bounds, ctx.zone, margin=abs(ctx.resolution) / 100000.0)


def create_label_array_for_tile(ctx, label_data, attrib_to_burn=None,
                                layer_idx=0, background_value=255,
                                device=None) -> np.ndarray:
    """Rasterise an OGR-style dataset onto the tile's padded grid with
    ALL_TOUCHED semantics (reference :633-689), through the burn CUDA
    kernels (ops/rasterize). Returns uint8 (H, W). The layer is parsed
    and spatially indexed once per process (see _indexed_layer); each
    tile projects only the features its bbox can touch."""
    layer, grid = _indexed_layer(label_data, layer_idx)
    bbox = _tile_lonlat_bbox(ctx)
    candidates = grid.query(*bbox)
    feats = _label_features_px(ctx, layer, attrib_to_burn,
                               candidates=candidates)
    size = ctx.raster_size
    return rasterize(feats, (size, size), background=background_value,
                     all_touched=True, dtype=np.uint8, device=device)


# ---------------------------------------------------------------------------
# main per-tile entry (reference :693-800)
# ---------------------------------------------------------------------------

def create_chips_for_tile(job_details: DLTileJobConfig,
                          device=None) -> tuple:
    """Create the GeoTIFF image/label chip pair for one tile job, on
    ``device`` (None -> CUDA).

    Dispatch (reference :756-770): list product -> band stacking;
    Sentinel-2 with max_cloud_fraction == 0 -> cloud-masked median;
    otherwise nearest-to-date mosaic with scene-level cloud filter.
    Returns (job, img_path, lbl_path), or (job, None, None) when the
    catalog gather produced no image (caller retries; reference
    :718-722). Device-stage errors propagate."""
    device = resolve_device(device)
    dltile = job_details.DLTILE
    out_base = job_details.OUTFOLDER
    product = job_details.PRODUCT
    bands = job_details.BANDS
    catalog = job_details.CATALOG

    out_img_folder = storage.join(out_base, "images")
    out_lbl_folder = storage.join(out_base, "labels")
    storage.makedirs(out_img_folder, exist_ok=True)
    storage.makedirs(out_lbl_folder, exist_ok=True)

    fn = dltile.key.replace(":", "#")

    if isinstance(product, list):
        if not isinstance(bands, list):
            raise TypeError("a list of products needs a list of band "
                            "lists, one per product")
        try:
            gathered = _gather_products(dltile, product, bands, "near",
                                        _resolve_catalog(catalog))
        except Exception:
            if _debug_errors():
                raise
            gathered = None
        img_arr = (None if gathered is None
                   else _stack_gathered(gathered, device))
    elif job_details.MAX_CLOUD_FRACTION == 0 and product == S2_PRODUCT:
        img_arr = create_cloudmasked_s2_array(
            ctx=dltile, min_date=job_details.MIN_DATE,
            max_date=job_details.MAX_DATE, bands=bands, catalog=catalog,
            device=device)
    else:
        img_arr = create_img_array_for_tile(
            ctx=dltile, product=product,
            reference_date=job_details.TARGETDATE,
            min_date=job_details.MIN_DATE, max_date=job_details.MAX_DATE,
            max_cloud_fraction=job_details.MAX_CLOUD_FRACTION,
            bands=bands, catalog=catalog, device=device)

    if img_arr is None:
        return (job_details, None, None)
    if isinstance(img_arr, np.ma.MaskedArray):
        img_arr = img_arr.filled(0)

    lbl_arr = create_label_array_for_tile(
        ctx=dltile, label_data=job_details.LABEL_DS,
        attrib_to_burn=job_details.LABEL_BURN_ATTR,
        layer_idx=job_details.LABEL_LYR_NUM,
        background_value=job_details.LABEL_NODATA_VALUE, device=device)

    img_file = storage.join(out_img_folder, fn) + ".tif"
    lbl_file = storage.join(out_lbl_folder, fn) + ".tif"
    # hemisphere-aware CRS: EPSG:326xx north / 327xx south with the
    # matching false-northing geotransform (Tile.geotrans), so chips
    # open correctly in standard GIS tools in both hemispheres
    epsg = dltile.epsg
    write_geotiff(img_file, np.asarray(img_arr),
                  geotransform=dltile.geotrans, epsg=epsg)
    write_geotiff(lbl_file, lbl_arr, geotransform=dltile.geotrans,
                  epsg=epsg, nodata=job_details.LABEL_NODATA_VALUE)
    return (job_details, img_file, lbl_file)


def is_done(job_details: DLTileJobConfig) -> bool:
    """Idempotent-resume check: both chip files already exist (the
    notebook's resume pattern, create nb cell 76; gs:// and s3:// output
    folders through the storage layer)."""
    fn = job_details.DLTILE.key.replace(":", "#") + ".tif"
    return (storage.exists(storage.join(job_details.OUTFOLDER, "images", fn))
            and storage.exists(
                storage.join(job_details.OUTFOLDER, "labels", fn)))
