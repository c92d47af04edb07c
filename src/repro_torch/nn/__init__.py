"""The dense ``lm`` family on the generated TSL primitives (mirrors
``repro.nn``). Every function takes the generated ops namespace ``tsl``
explicitly (``repro_torch.tsl_api.ops(device)``), so the same code runs the
Hopper kernels (``h100``) or their plain versions (``torch_cpu``)."""
