"""The planted faults of tests/test_torch_cuda_kernels.py against the sources
they are planted in. Needs no card: an edit of a kernel source or of the
flash-attention glue that removes the text a fault replaces would silently
disarm that fault (its on-card test would build an unfaulted copy), so it
fails here, on the host, first."""

import pytest

from repro_torch.kernels.flash_attention import kernel, ops
from test_torch_cuda_kernels import CUDA_FAULTS, GLUE_FAULTS


@pytest.mark.parametrize("fault", list(CUDA_FAULTS))
def test_every_planted_kernel_fault_names_one_place_in_its_source(fault):
    sources = {p.name: p.read_text() for p in kernel.SOURCES + kernel.BWD_SOURCES}
    for name, old, new in CUDA_FAULTS[fault]:
        assert old != new
        assert sources[name].count(old) == 1, (fault, name, old)


@pytest.mark.parametrize("fault", list(GLUE_FAULTS))
def test_every_planted_glue_fault_occurs_in_ops(fault):
    old, new = GLUE_FAULTS[fault]
    assert old != new
    with open(ops.__file__) as f:
        assert old in f.read(), (fault, old)
