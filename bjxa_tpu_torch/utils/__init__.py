"""Host-side utilities: the corpus manifest and throughput counters."""
