"""Hopper kernel (Triton): fused RMSNorm over row blocks.

Replaces ``repro/kernels/rmsnorm/kernel.py:rmsnorm_2d`` (body
``_rmsnorm_kernel``), the Pallas TPU row-block kernel.

What bounds it on the H100: bytes. It reads x and the weight once and writes
y once, about 4 flops per element against 4 bytes of traffic (bf16 in and
out) — two orders of magnitude below the card's ~295 flop/byte ridge — so
its floor is (2·rows·d + d)·itemsize / 3.35 TB/s.

What the design does about it: one program per block of rows, the whole row
(``d`` padded to a power of two) held in registers, so x crosses HBM exactly
once and the f32 statistics never leave the SM; at the model's d = 1024
several rows share a program so each one moves enough bytes to keep the
memory system busy. No shared memory, no cross-program state.
"""

import functools

from ..common import cdiv, next_power_of_2, use_checkout_triton_cache

# triton.language, bound by _build() at first launch: the host that runs the
# tests has no triton, so nothing here may import it at module import
tl = None

_MAX_BLOCK_ELEMS = 4096   # elements a program holds (rows x padded d)


@functools.cache
def _build():
    global tl
    use_checkout_triton_cache()
    import triton
    import triton.language as _tl

    tl = _tl

    @triton.jit
    def _rmsnorm_fwd(x_ptr, w_ptr, o_ptr, n_rows, d, eps,
                     BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        inv = tl.rsqrt(tl.sum(x * x, axis=1) / d + eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = x * inv[:, None] * w[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return _rmsnorm_fwd


def rmsnorm_2d(x, weight, out, *, eps: float) -> None:
    """x, out: contiguous (rows, d) CUDA tensors of one dtype; weight (d,).
    Launches on the current stream; checks are the caller's (ops.rmsnorm)."""
    rows, d = x.shape
    block_d = next_power_of_2(d)
    block_r = max(1, min(_MAX_BLOCK_ELEMS // block_d, next_power_of_2(rows)))
    _build()[(cdiv(rows, block_r),)](
        x, weight, out, rows, d, float(eps),
        BLOCK_R=block_r, BLOCK_D=block_d,
        num_warps=4 if block_r * block_d <= 4096 else 8)
