"""int8 absmax gradient compression with error feedback (mirrors
``repro/dist/compression.py``).

``compress_decompress`` models the wire format: per-row (last-axis) absmax
scaling to int8 and back. Quantization error per element is bounded by
scale/2 = amax/254. ``ErrorFeedback`` carries the residual so the scheme is
lossless in expectation: quantized + residual == input + residual_in.

The scale rule here, ``amax / 127`` or 1 where a row is all zeros, is not
the int8 optimizer moments' (``max(amax, 1e-12) / 127``,
``train/optimizer.py``): the two are kept apart as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map


def quantize_absmax_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) absmax int8 quantization: returns ``(q, scale)``
    with ``q`` int8 in [-127, 127] and ``scale`` float32 keeping the last
    axis as size 1. Error per element is bounded by scale/2 = amax/254. A 0-d
    input has no last axis and raises, as in the reference."""
    if x.ndim == 0:
        raise ValueError("quantize_absmax_int8: a 0-d array has no last axis")
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_absmax_int8(q: torch.Tensor, scale: torch.Tensor,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_absmax_int8` (up to the bounded error)."""
    return (q.float() * scale).to(dtype)


def _quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """x -> dequantize(quantize_int8(x)), computed in float32."""
    q, scale = quantize_absmax_int8(x)
    return q.float() * scale


def compress_decompress(tree):
    """Quantize-dequantize every leaf, each cast back to its own dtype.
    Returns (tree', max_abs_error) with the error a 0-d float32 tensor."""
    out = tree_map(lambda g: _quantize_roundtrip(g).to(g.dtype), tree)
    errs = [(a.float() - b.float()).abs().max()
            for a, b in zip(tree_leaves(out), tree_leaves(tree))]
    err = torch.stack(errs).max() if errs else torch.zeros((), dtype=torch.float32)
    return out, err


class ErrorFeedback:
    """Residual bookkeeping: feed quantization error back into the next step."""

    @staticmethod
    def init(tree):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), tree)

    @staticmethod
    def apply(tree, residual):
        """Returns (quantized, new_residual) with the identity
        quantized + new_residual == tree + residual."""
        corrected = tree_map(lambda g, r: g.float() + r, tree, residual)
        quantized = tree_map(lambda c, g: _quantize_roundtrip(c).to(g.dtype),
                             corrected, tree)
        # residual measured against the dtype-cast value actually emitted, so
        # the cast's own rounding also feeds back (exact identity on any dtype)
        new_residual = tree_map(lambda c, q: c - q.float(), corrected, quantized)
        return quantized, new_residual
