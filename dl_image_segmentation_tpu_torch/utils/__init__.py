"""Host utilities: the HTML tile map (webmap)."""
