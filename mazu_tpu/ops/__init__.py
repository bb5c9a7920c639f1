"""Device primitives: scatter-free lane compaction and the mono2 probe kernel."""
