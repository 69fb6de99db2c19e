"""The benchmark harness of gscream_tpu_torch: scene and traffic
generation from a seed, the two cell runners (the training loop and the render
loop), the profiler's reduction, the operation and byte counts, the peaks
of the card, and the comparison that decides ``correct``."""
