"""Host utilities: the HTML tile map (webmap), contact-sheet previews of
record pairs (preview), profiling (StageTimer, trace, duty_cycle) and
matplotlib plots (viz)."""
