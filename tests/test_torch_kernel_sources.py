"""The planted faults of tests/test_torch_cuda_kernels.py against the sources
they are planted in, chip_smoke.py's reading of the flash and paged
libraries' instantiations, and the build's digest of the headers a kernel
includes from another directory. Needs no card: an edit of a kernel source
or of the flash-attention glue that removes the text a fault replaces would
silently disarm that fault (its on-card test would build an unfaulted copy),
a kernel renamed out of phase 1's tensor-core gate would silently leave it,
and a header edit the digest missed would reuse a stale library, so all
fail here, on the host, first."""

import pytest

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.hadd import kernel as hadd_kernel
from repro_torch.kernels.paged import kernel as paged_kernel
from repro_torch.kernels.softmax import kernel as softmax_kernel
from repro_torch.kernels.to_integral import kernel as to_integral_kernel
from test_torch_cuda_kernels import (CUDA_FAULTS, GLUE_FAULTS, HADD_FAULTS, PAGED_FAULTS,
                                     SOFTMAX_FAULTS, TO_INTEGRAL_FAULTS, _chip_smoke)


@pytest.mark.parametrize("fault", list(CUDA_FAULTS))
def test_every_planted_kernel_fault_names_one_place_in_its_source(fault):
    sources = {p.name: p.read_text() for p in kernel.SOURCES + kernel.BWD_SOURCES}
    for name, old, new in CUDA_FAULTS[fault]:
        assert old != new
        assert sources[name].count(old) == 1, (fault, name, old)


SOURCE_FAULTS = {**PAGED_FAULTS, **HADD_FAULTS, **TO_INTEGRAL_FAULTS, **SOFTMAX_FAULTS}


@pytest.mark.parametrize("fault", list(SOURCE_FAULTS))
def test_every_planted_split_fault_names_one_place_in_its_source(fault):
    sources = {p.name: p.read_text() for p in paged_kernel.SOURCES + hadd_kernel.SOURCES +
               to_integral_kernel.SOURCES + softmax_kernel.SOURCES}
    for name, old, new in SOURCE_FAULTS[fault]:
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
    "_ZN12_GLOBAL__N_116paged_mma_kernelILi128ELi4EEEvPK13__nv_bfloat16S3_S3_PKiS5_PS1_PfPi"
    "iiiiiiif": "paged_mma_kernel<128, 4>",
    # as nvcc names it: the namespace holds the file name, paged_attention_cu
    "_ZN51_GLOBAL__N__e79d8b2a_18_paged_attention_cu_5ac9a22116paged_mma_kernelILi64ELi2EEEv"
    "PK13__nv_bfloat16S3_S3_PKiS5_PS1_PfPiiiiiiiif": "paged_mma_kernel<64, 2>",
    "_ZN12_GLOBAL__N_116paged_f32_kernelILi64EEEvPKfS2_S2_PKiS4_PfS5_Piiiiiiiiif":
        "paged_f32_kernel<64>",
    "_Z14rmsnorm_kernelPKfS0_Pfif": None,
}


@pytest.mark.parametrize("mangled", list(FLASH_SYMBOLS))
def test_chip_smoke_labels_every_flash_instantiation(mangled):
    assert _chip_smoke().kernel_label(mangled) == FLASH_SYMBOLS[mangled]


SOFTMAX_SYMBOLS = {
    "_ZN12_GLOBAL__N_119softmax_rows_kernelIfLi32ELb1EEEvPKT_PS1_xi":
        "softmax_rows_kernel<float, 32, true>",
    "_ZN12_GLOBAL__N_119softmax_rows_kernelI13__nv_bfloat16Li8ELb0EEEvPKT_PS2_xi":
        "softmax_rows_kernel<__nv_bfloat16, 8, false>",
    "_ZN12_GLOBAL__N_119softmax_rows_kernelI6__halfLi16ELb1EEEvPKT_PS2_xi":
        "softmax_rows_kernel<__half, 16, true>",
    "_ZN12_GLOBAL__N_122softmax_cluster_kernelIfLb0EEEvPKT_PS1_xxb":
        "softmax_cluster_kernel<float, false>",
    "_ZN12_GLOBAL__N_122softmax_cluster_kernelI13__nv_bfloat16Lb1EEEvPKT_PS2_xxb":
        "softmax_cluster_kernel<__nv_bfloat16, true>",
    # as nvcc names it: the namespace holds the file name, softmax_cu
    "_ZN43_GLOBAL__N__9b44374b_10_softmax_cu_ba69045822softmax_cluster_kernelI6__halfLb0EEEvPK"
    "T_PS2_xxb": "softmax_cluster_kernel<__half, false>",
}


@pytest.mark.parametrize("mangled", list(SOFTMAX_SYMBOLS))
def test_chip_smoke_labels_every_softmax_instantiation(mangled):
    """Phase 1 reads ptxas's registers, shared memory and spills per softmax
    instantiation by these labels (and fails on any spill)."""
    assert _chip_smoke().kernel_label(mangled) == SOFTMAX_SYMBOLS[mangled]


def test_chip_smoke_reads_static_shared_memory():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122softmax_cluster_kernelIf"
           "Lb0EEEvPKT_PS1_xxb' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 1 barriers, 96 bytes smem, 400 bytes "
           "cmem[0]\n")
    assert _chip_smoke().ptxas_report(log) == {
        "softmax_cluster_kernel<float, false>": {"spill_bytes": 0, "registers": 40,
                                                 "smem_bytes": 96}}


def _paged_counts():
    counts = {f"paged_f32_kernel<{d}>": 0 for d in (64, 112, 128)}
    counts |= {f"paged_mma_kernel<{d}, {kw}>": 24 for d in (64, 112, 128) for kw in (1, 2, 4)}
    return counts


@pytest.mark.parametrize("edit", ["none", "bf16 without HMMA", "float32 with HMMA",
                                  "no bf16 at D 128", "no bf16 at D 112",
                                  "bf16 at D 112 without HMMA"])
def test_chip_smoke_tensor_core_gate_for_the_paged_kernel(edit):
    """Phase 1's gate on the paged library: every bf16 instantiation on the
    tensor cores, D 64, 112 and 128 present, no float32 one with HMMA."""
    counts = _paged_counts()
    if edit == "bf16 without HMMA":
        counts["paged_mma_kernel<64, 2>"] = 0
    elif edit == "float32 with HMMA":
        counts["paged_f32_kernel<128>"] = 8
    elif edit == "no bf16 at D 128":
        counts = {k: n for k, n in counts.items() if not k.startswith("paged_mma_kernel<128")}
    elif edit == "no bf16 at D 112":
        counts = {k: n for k, n in counts.items() if not k.startswith("paged_mma_kernel<112")}
    elif edit == "bf16 at D 112 without HMMA":
        counts["paged_mma_kernel<112, 4>"] = 0
    gate = _chip_smoke().tensor_core_gate
    if edit == "none":
        gate(counts, "paged")
    else:
        with pytest.raises(AssertionError, match="paged instantiations"):
            gate(counts, "paged")


def test_editing_a_listed_header_changes_the_library_digest(tmp_path, monkeypatch):
    """A header from another directory (``headers=``) is hashed into the
    library's directory and its directory goes to nvcc as -I; the paged
    kernel lists the flash kernels' flash_mma.cuh so."""
    import subprocess

    src_dir, inc_dir = tmp_path / "csrc", tmp_path / "include"
    src_dir.mkdir()
    inc_dir.mkdir()
    src, header = src_dir / "k.cu", inc_dir / "blocks.cuh"
    src.write_text('#include "blocks.cuh"\n')
    header.write_text("// v1\n")
    monkeypatch.setattr(common, "KERNEL_BUILD_ROOT", tmp_path / "build")
    first = common.library_dir("k", [src], [header])
    assert common.library_dir("k", [src]) != first        # unlisted: not hashed
    header.write_text("// v2\n")
    second = common.library_dir("k", [src], [header])
    assert second != first and second.parent == first.parent

    cmds = []

    def fake_nvcc(cmd, **kw):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(common, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(common.subprocess, "run", fake_nvcc)
    lib = common.build_shared_library("k", [src], [header])
    assert lib.parent == second and lib.is_file()
    assert f"-I{inc_dir}" in cmds[0]
    assert [h.name for h in paged_kernel.HEADERS] == ["flash_mma.cuh"]
    assert all(h.is_file() and h.parent != paged_kernel.SOURCES[0].parent
               for h in paged_kernel.HEADERS)
    assert '#include "flash_mma.cuh"' in paged_kernel.SOURCES[0].read_text()


# dk/dv's q rows per sub-tile (the kernel's second template argument) per D
DKV_QW = {64: 64, 112: 16, 128: 32}


def _full_counts():
    counts = {}
    for d in (64, 112, 128):
        counts |= {f"flash_fwd_mma_kernel<{d}, true>": 96,
                   f"flash_fwd_mma_kernel<{d}, false>": 96,
                   f"flash_bwd_dq_mma_kernel<{d}>": 128,
                   f"flash_bwd_dkv_mma_kernel<{d}, {DKV_QW[d]}>": 192,
                   f"flash_fwd_f32_kernel<{d}, true>": 0, f"flash_bwd_dq_kernel<float, {d}>": 0,
                   f"flash_bwd_dkv_kernel<float, {d}>": 0}
    return counts


@pytest.mark.parametrize("edit", ["none", "bf16 dq without HMMA", "float32 dk/dv with HMMA",
                                  "no bf16 dk/dv at D 128", "no float32 instantiation",
                                  "no bf16 forward at D 112", "no bf16 dq at D 112",
                                  "bf16 dk/dv at D 112 without HMMA"])
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
    elif edit == "no bf16 forward at D 112":
        del counts["flash_fwd_mma_kernel<112, false>"], counts["flash_fwd_mma_kernel<112, true>"]
    elif edit == "no bf16 dq at D 112":
        del counts["flash_bwd_dq_mma_kernel<112>"]
    elif edit == "bf16 dk/dv at D 112 without HMMA":
        counts["flash_bwd_dkv_mma_kernel<112, 16>"] = 0
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
