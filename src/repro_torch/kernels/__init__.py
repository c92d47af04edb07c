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

Neither Triton nor the CUDA toolkit is imported when a module is imported:
the host that runs the tests has neither.
"""
