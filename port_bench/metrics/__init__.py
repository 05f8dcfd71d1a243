"""One reader per per-layer metric, named as in ``BENCHMARK.json``:
``read(ctx) -> float | None`` (None where the trace holds nothing for
it)."""
