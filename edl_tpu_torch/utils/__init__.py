"""Trimmed copies of the jax-free helpers of ``edl_tpu.utils``."""
