"""Trimmed copies of the ``edl_tpu.obs`` pieces the serving shell calls."""
