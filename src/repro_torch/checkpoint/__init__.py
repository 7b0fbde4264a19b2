"""Atomic, async checkpoints of tensor trees (``repro.checkpoint``
counterparts)."""
