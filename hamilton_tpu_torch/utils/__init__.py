"""Measurement helpers: timing on the card, and roofline accounting with the
speed-of-light probes (counterpart of :mod:`hamilton_tpu.utils`'s
``profiling`` and ``roofline``)."""
