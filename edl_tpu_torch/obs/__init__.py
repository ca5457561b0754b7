"""Trimmed copies of the ``edl_tpu.obs`` pieces the port calls: metrics,
spans and the flight recorder."""
