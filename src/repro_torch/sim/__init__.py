"""The cluster simulator: copies of ``src/repro/sim``'s modules (see each)."""
