"""The Mamba2 SSD recurrence in plain torch (mirrors ``repro/kernels/ssd``):
``ref`` is the time-step scan and the single decode step, ``ops`` the
chunked state-space-duality form. This folder holds NO kernel: the reference
runs none for the SSD (its ssd code is jnp on every target), and the folder
carries the reference's name so that a reader finds the counterpart."""
