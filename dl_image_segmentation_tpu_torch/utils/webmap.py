"""Interactive HTML map of tile footprints + label overlays.

A copy of the JAX package's ``utils/webmap.py``: the folium-equivalent
for the reference's notebook maps
(create_training_samples.ipynb cells 30-41: tile grid
+ label geometries on an OSM basemap). Emits ONE self-contained HTML
file embedding the GeoJSON; Leaflet js/css load from the same CDN
folium uses, so the file behaves exactly like a saved folium map.
No Python web dependencies.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

_LEAFLET_CSS = "https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"
_LEAFLET_JS = "https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<meta name="viewport" content="width=device-width, initial-scale=1.0"/>
<title>{title}</title>
<link rel="stylesheet" href="{css}"/>
<script src="{js}"></script>
<style>html, body, #map {{ height: 100%; margin: 0; }}</style>
</head>
<body>
<div id="map"></div>
<script>
var tiles = {tiles_geojson};
var labels = {labels_geojson};
var map = L.map('map');
L.tileLayer('https://tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
            {{maxZoom: 19, attribution: '&copy; OpenStreetMap'}}
           ).addTo(map);
var tileLayer = L.geoJSON(tiles, {{
  style: {{color: '#3388ff', weight: 1, fill: false}},
  onEachFeature: function (f, l) {{
    if (f.properties && f.properties.key)
      l.bindPopup('tile ' + f.properties.key);
  }}
}}).addTo(map);
var labelLayer = L.geoJSON(labels, {{
  style: {{color: '#d62728', weight: 1, fillOpacity: 0.35}},
  onEachFeature: function (f, l) {{
    if (f.properties) l.bindPopup(JSON.stringify(f.properties));
  }}
}}).addTo(map);
L.control.layers(null, {{'tiles': tileLayer, 'labels': labelLayer}})
  .addTo(map);
var b = tiles.features.length ? tileLayer.getBounds()
                              : labelLayer.getBounds();
if (labels.features.length) b = b.extend(labelLayer.getBounds());
if (b.isValid()) map.fitBounds(b); else map.setView([0, 0], 2);
</script>
</body>
</html>
"""


def _tiles_to_geojson(tiles) -> dict:
    from ..geo.tilegrid import tiles_to_layer
    return _layer_to_geojson(tiles_to_layer(tiles))


def _layer_to_geojson(layer) -> dict:
    feats = []
    for f in layer.features:
        polys = []
        for rings in f.geometry.polygons():
            polys.append([[[float(x), float(y)] for x, y in ring]
                          for ring in rings])
        if len(polys) == 1:
            geom = {"type": "Polygon", "coordinates": polys[0]}
        else:
            geom = {"type": "MultiPolygon", "coordinates": polys}
        feats.append({"type": "Feature", "geometry": geom,
                      "properties": {k: v for k, v in f.properties.items()
                                     if _json_safe(v)}})
    return {"type": "FeatureCollection", "features": feats}


def _json_safe(v) -> bool:
    return isinstance(v, (str, int, float, bool)) or v is None


def write_html_map(out_path: str, tiles: Sequence = (),
                   labels_layer=None, title: str = "tile map") -> str:
    """Write a self-contained interactive map. ``tiles``: Tile objects
    (footprints drawn in blue with key popups); ``labels_layer``:
    optional geo.vector.VectorLayer in WGS84 (red overlay with
    property popups). ``out_path`` may be local, gs:// or s3://.
    Returns out_path."""
    tiles = list(tiles)
    if not tiles and labels_layer is None:
        raise ValueError(
            "nothing to map: no tile-key-named chips found and no "
            "labels layer given")
    tiles_gj = _tiles_to_geojson(tiles) if tiles else \
        {"type": "FeatureCollection", "features": []}
    if labels_layer is not None:
        labels_gj = _layer_to_geojson(labels_layer.to_wgs84())
    else:
        labels_gj = {"type": "FeatureCollection", "features": []}
    # "<" escaped as \\u003c inside the JSON (valid JSON, identical
    # parse): a feature attribute containing a closing script tag
    # would otherwise terminate the inline script element (broken map
    # / markup injection when the HTML is shared)
    def _safe(obj) -> str:
        return json.dumps(obj).replace("<", "\\u003c")

    import html as _html
    title = _html.escape(str(title))
    html = _TEMPLATE.format(title=title, css=_LEAFLET_CSS, js=_LEAFLET_JS,
                            tiles_geojson=_safe(tiles_gj),
                            labels_geojson=_safe(labels_gj))
    from .. import storage
    storage.write_bytes(out_path, html.encode("utf-8"))
    return out_path


def write_html_map_for_folder(out_path: str, chip_dir: str,
                              labels: Optional[str] = None) -> str:
    """Map every chip in a folder (tile-key filenames) plus an optional
    vector label dataset -- the `map` CLI command's backend. The folder
    may be local, gs://, s3:// or http(s)://."""
    from .. import storage
    from ..geo.tilegrid import Tile

    tiles = []
    for f in (storage.glob(storage.join(chip_dir, "*.tif"))
              + storage.glob(storage.join(chip_dir, "*.png"))):
        try:
            tiles.append(Tile.from_filename(storage.basename(f)))
        except ValueError:
            continue
    layer = None
    if labels:
        from ..geo.vector import open_vector
        layer = open_vector(labels).get_layer(0)
    return write_html_map(out_path, tiles, layer)
