"""Host utilities: the HTML tile map (webmap) and contact-sheet previews
of record pairs (preview)."""
