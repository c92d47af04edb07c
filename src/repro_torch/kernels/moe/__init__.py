"""The four mixture-of-experts primitives (mirrors ``repro/tsl_data/
primitives/moe.yaml``): ``ref`` holds the plain torch versions, the
``torch_cpu`` definitions, and ``ops`` the ``h100`` ``expert_ffn``, whose
activation runs the swiglu kernel. This folder holds NO kernel of its own:
the JAX package computes these in jnp on every target."""
