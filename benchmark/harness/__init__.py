"""The benchmark's engine: it finds a cell's configuration, traffic mix,
codec adapter and per-layer metric readers by the names in
``BENCHMARK.json``, draws weights and inputs from the seed, runs the
window, reads the trace, and decides ``correct`` against the plain
reference."""
