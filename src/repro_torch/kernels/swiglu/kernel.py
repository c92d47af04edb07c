"""Hopper kernel (Triton): fused SwiGLU, silu(gate) * up.

Replaces ``repro/kernels/swiglu/kernel.py:swiglu_2d`` (body
``_swiglu_kernel``), the Pallas TPU elementwise kernel.

What bounds it on the H100: bytes. Two inputs read and one output written
per element (6 B in bf16) against ~4 flops, far below the ridge; its floor
is 3·N·itemsize / 3.35 TB/s.

What the design does about it: one pass over a flat grid of 1024-element
blocks — gate and up are each read once, the sigmoid and both products stay
in f32 registers, and only the result is written. That is the whole gain
over the unfused silu-then-multiply (which writes and re-reads silu(g)).
"""

import functools

from ..common import cdiv, use_checkout_triton_cache

# triton.language, bound by _build() at first launch (no triton on the host)
tl = None

_BLOCK = 1024


@functools.cache
def _build():
    global tl
    use_checkout_triton_cache()
    import triton
    import triton.language as _tl

    tl = _tl

    @triton.jit
    def _swiglu_fwd(g_ptr, u_ptr, o_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        u = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = g * tl.sigmoid(g) * u
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return _swiglu_fwd


def swiglu_flat(gate, up, out) -> None:
    """gate, up, out: contiguous CUDA tensors of one dtype and size.
    Launches on the current stream; checks are the caller's (ops.swiglu)."""
    n = gate.numel()
    _build()[(cdiv(n, _BLOCK),)](gate, up, out, n, BLOCK=_BLOCK, num_warps=4)
