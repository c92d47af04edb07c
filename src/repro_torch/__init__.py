"""PyTorch port of the TSLGen reproduction, for NVIDIA Hopper (H100, sm_90a).

Mirrors the module layout of the JAX package ``repro`` so each counterpart
is easy to find, but never imports it (nor JAX): the UPD corpus, the
generator, the generated library behind ``tsl_api``, the dense ``lm``
family and the lane-mode ``ServeEngine`` are all this package's own.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; the generated library for the device's target (``h100`` or
``torch_cpu``) decides whether a primitive runs a hand-written Hopper kernel
or its plain PyTorch version.
"""
