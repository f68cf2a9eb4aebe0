"""Host-side utilities: logging, interrupts, throughput and traces,
plotting and GIF rendering."""
