"""Checkpoints (mirrors ``repro/ckpt``), readable by the reference and from it."""
