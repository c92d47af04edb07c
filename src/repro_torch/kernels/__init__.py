"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package mirrors the JAX package's split:

* ``ref.py``    — the plain PyTorch version (the ``torch_cpu`` definition,
  and what the kernel is held against on the card);
* ``kernel.py`` — the launcher: builds the kernel at first use (Triton JIT,
  or ``nvcc`` into ``build/torch_kernels/`` for CUDA C++) and launches it;
* ``ops.py``    — the wrapper the ``h100`` definition calls: a CUDA tensor
  launches the kernel (or raises), a CPU tensor takes ``ref``; it carries
  the launch counter (``<wrapper>.launches``);
* ``csrc/``     — the CUDA C++ sources, where the kernel is CUDA.

``wkv6/``, ``ssd/`` and ``moe/`` are the exceptions: they hold the RWKV6
and the Mamba2 SSD recurrences and the mixture-of-experts primitives in
plain torch and no kernel of their own (the JAX package runs no Pallas
kernel for any of them; the ``h100`` ``expert_ffn`` calls the swiglu
kernel).

Neither Triton nor the CUDA toolkit is imported when a module is imported:
the host that runs the tests has neither.
"""


def launch_counters() -> dict:
    """{name: wrapper} of every kernel wrapper that counts its launches in
    ``wrapper.launches`` (imported here, not when this package is)."""
    from .flash_attention.ops import (flash_attention, flash_attention_bwd_dkv,
                                      flash_attention_bwd_dq, flash_attention_fwd_lse)
    from .hadd.ops import hadd
    from .paged.ops import paged_attention
    from .range_count.ops import range_count
    from .rmsnorm.ops import rmsnorm
    from .softmax.ops import softmax
    from .swiglu.ops import swiglu
    from .to_integral.ops import to_integral

    return {"rmsnorm": rmsnorm, "swiglu": swiglu, "flash_attention": flash_attention,
            "paged_attention": paged_attention, "range_count": range_count, "hadd": hadd,
            "to_integral": to_integral, "softmax": softmax,
            "flash_attention_fwd_lse": flash_attention_fwd_lse,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv}

