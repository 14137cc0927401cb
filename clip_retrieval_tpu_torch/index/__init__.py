"""Vector indices on torch: flat, int8 flat, IVF-int8 (on kernel K3), IVF-PQ
(on kernel K4), re-ranking, index loading and the `clip_index` build.
Modules are imported on use."""
