"""The RWKV6 (Finch) WKV recurrence in plain torch (mirrors
``repro/kernels/wkv6``): ``ref`` is the time-step scan and the single decode
step, ``ops`` the chunked form. This folder holds NO kernel: the reference
runs none for rwkv (its wkv6 code is jnp on every target), and the folder
carries the reference's name so that a reader finds the counterpart."""
