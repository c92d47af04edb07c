"""The planted faults of tests/test_torch_cuda_kernels.py against the sources
they are planted in, and chip_smoke.py's reading of the flash libraries'
instantiations. Needs no card: an edit of a kernel source or of the
flash-attention glue that removes the text a fault replaces would silently
disarm that fault (its on-card test would build an unfaulted copy), and a
kernel renamed out of phase 1's tensor-core gate would silently leave it, so
both fail here, on the host, first."""

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


# chip_smoke.py's phase 1 reads the flash libraries' instantiations by their
# mangled names (the Itanium ABI's, as nvcc and g++ write them); a kernel
# renamed or retyped out of the gate's sight must fail here, on the host
FLASH_SYMBOLS = {
    "_ZN42_GLOBAL__N__5c2a_22_flash_attention_cu_5c2a20flash_fwd_mma_kernelILi64ELb1EEEvPK13"
    "__nv_bfloat16S3_S3_PS1_Pfiiiiiiiif": "flash_fwd_mma_kernel<64, true>",
    "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi128ELb0EEEvPKfS2_S2_PfS3_iiiiiiif":
        "flash_fwd_f32_kernel<128, false>",
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_PS1_iiiiiiif":
        "flash_bwd_dq_kernel<float, 128>",
    "_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_"
    "iiiiiiif": "flash_bwd_dq_mma_kernel<64>",
    "_ZN12_GLOBAL__N_124flash_bwd_dkv_mma_kernelILi128ELi32EEEvPK13__nv_bfloat16S3_S3_S3_"
    "PKfS5_PfS6_iiiiiiif": "flash_bwd_dkv_mma_kernel<128, 32>",
    "_Z14rmsnorm_kernelPKfS0_Pfif": None,
}


def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("mangled", list(FLASH_SYMBOLS))
def test_chip_smoke_labels_every_flash_instantiation(mangled):
    assert _chip_smoke().kernel_label(mangled) == FLASH_SYMBOLS[mangled]


def _full_counts():
    counts = {}
    for d in (64, 128):
        counts |= {f"flash_fwd_mma_kernel<{d}, true>": 96,
                   f"flash_fwd_mma_kernel<{d}, false>": 96,
                   f"flash_bwd_dq_mma_kernel<{d}>": 128,
                   f"flash_bwd_dkv_mma_kernel<{d}, {64 if d == 64 else 32}>": 192,
                   f"flash_fwd_f32_kernel<{d}, true>": 0, f"flash_bwd_dq_kernel<float, {d}>": 0,
                   f"flash_bwd_dkv_kernel<float, {d}>": 0}
    return counts


@pytest.mark.parametrize("edit", ["none", "bf16 dq without HMMA", "float32 dk/dv with HMMA",
                                  "no bf16 dk/dv at D 128", "no float32 instantiation"])
def test_chip_smoke_tensor_core_gate(edit):
    """Phase 1's gate passes the expected instantiations and fails each way
    a bf16 backward kernel could leave the tensor cores unseen."""
    counts = _full_counts()
    if edit == "bf16 dq without HMMA":
        counts["flash_bwd_dq_mma_kernel<128>"] = 0
    elif edit == "float32 dk/dv with HMMA":
        counts["flash_bwd_dkv_kernel<float, 64>"] = 4
    elif edit == "no bf16 dk/dv at D 128":
        del counts["flash_bwd_dkv_mma_kernel<128, 32>"]
    elif edit == "no float32 instantiation":
        counts = {k: n for k, n in counts.items() if "_mma_" in k}
    gate = _chip_smoke().tensor_core_gate
    if edit == "none":
        gate(counts)
    else:
        with pytest.raises(AssertionError, match="flash instantiations"):
            gate(counts)


def test_chip_smoke_reads_registers_and_spills_per_instantiation():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_bwd_dkv_mma_"
           "kernelILi128ELi32EEEvPK13__nv_bfloat16' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_bwd_dkv_mma_"
           "kernelILi128ELi32EEEvPK13__nv_bfloat16\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers, 416 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
           "ptxas info    : Used 12 registers\n")
    assert _chip_smoke().ptxas_report(log) == {
        "flash_bwd_dkv_mma_kernel<128, 32>": {"spill_bytes": 12, "registers": 255}}
