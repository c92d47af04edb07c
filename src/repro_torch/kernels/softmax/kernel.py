"""Hopper kernel (Triton): stable row softmax, statistics in f32, output in
x's dtype.

Replaces ``repro/kernels/softmax/kernel.py:softmax_2d`` (body
``_softmax_kernel``), the Pallas TPU kernel that holds a block of whole rows
in VMEM.

What bounds it on the H100: bytes. About 5 flops per element against two
bytes in and two out (bf16): its floor is 2·rows·d·itemsize / 3.35 TB/s.

What the design does about it: a row that fits one block (d ≤ 4096 after
padding to a power of two) is held in registers, several rows per program,
so x crosses HBM once: max, exp, sum and the division happen on the SM. A
wider row (a vocabulary row of 152064) cannot stay in registers: one
program per row walks it in blocks of 4096 with a running max and sum per
lane (the online softmax: a new max rescales the sum by exp(m_old − m_new)),
combines the lanes once, then walks the row again to write exp(x − m) / l,
reading x twice. Entries of −inf weigh 0; a row of only −inf gives NaN, as
the plain version does. No shared memory, no cross-program state.
"""

import functools

from ..common import cdiv, next_power_of_2, use_checkout_triton_cache

# triton.language, bound by _build() at first launch: the host that runs the
# tests has no triton, so nothing here may import it at module import
tl = None

MAX_ROW_BLOCK = 4096        # widest row held whole in one program
_MAX_BLOCK_ELEMS = 4096     # elements a program holds (rows x padded d)


@functools.cache
def _build():
    global tl
    use_checkout_triton_cache()
    import triton
    import triton.language as _tl

    tl = _tl

    @triton.jit
    def _softmax_rows(x_ptr, o_ptr, n_rows, d, BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_D)
        mask = (rows < n_rows)[:, None] & (cols < d)[None, :]
        offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=float("-inf")).to(tl.float32)
        m = tl.max(x, axis=1)
        p = tl.where(mask, tl.exp(x - m[:, None]), 0.0)
        y = p / tl.sum(p, axis=1)[:, None]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _softmax_wide(x_ptr, o_ptr, d, BLOCK_D: tl.constexpr):
        base = tl.program_id(0).to(tl.int64) * d
        cols = tl.arange(0, BLOCK_D)
        m = tl.full([BLOCK_D], float("-inf"), tl.float32)
        l = tl.zeros([BLOCK_D], tl.float32)
        for start in range(0, d, BLOCK_D):
            x = tl.load(x_ptr + base + start + cols, mask=start + cols < d,
                        other=float("-inf")).to(tl.float32)
            m_new = tl.maximum(m, x)
            alive = m_new > float("-inf")
            l = tl.where(alive, l * tl.exp(m - m_new) + tl.exp(x - m_new), 0.0)
            m = m_new
        row_max = tl.max(m, axis=0)
        total = tl.sum(tl.where(m > float("-inf"), l * tl.exp(m - row_max), 0.0), axis=0)
        for start in range(0, d, BLOCK_D):
            mask = start + cols < d
            x = tl.load(x_ptr + base + start + cols, mask=mask, other=float("-inf"))
            y = tl.exp(x.to(tl.float32) - row_max) / total
            tl.store(o_ptr + base + start + cols, y.to(o_ptr.dtype.element_ty), mask=mask)

    return _softmax_rows, _softmax_wide


def softmax_2d(x, out) -> None:
    """x, out: contiguous (rows, d) CUDA tensors of one dtype, rows, d >= 1.
    Launches on the current stream; checks are the caller's (ops.softmax)."""
    rows, d = x.shape
    rows_kernel, wide_kernel = _build()
    block_d = next_power_of_2(d)
    if block_d <= MAX_ROW_BLOCK:
        block_r = max(1, min(_MAX_BLOCK_ELEMS // block_d, next_power_of_2(rows)))
        rows_kernel[(cdiv(rows, block_r),)](x, out, rows, d, BLOCK_R=block_r,
                                            BLOCK_D=block_d,
                                            num_warps=4 if block_r * block_d <= 2048 else 8)
    else:
        wide_kernel[(rows,)](x, out, d, BLOCK_D=MAX_ROW_BLOCK, num_warps=8)
