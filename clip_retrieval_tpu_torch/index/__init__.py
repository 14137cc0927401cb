"""Vector indices on torch: flat, IVF-int8 (on kernel K3), re-ranking and
index loading.  Modules are imported on use."""
