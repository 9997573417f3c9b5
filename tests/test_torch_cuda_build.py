"""The port's kernel build helpers that need no ``nvcc``: the key that names
a built library, and the parsers of ``ptxas`` and ``cuobjdump`` output.

A library is rebuilt only when its key changes, so the key has to cover
every byte the compiler reads from the package: the source and the headers
it includes from ``csrc/``.
"""

from pathlib import Path

import pytest

from sparkdl_tpu_torch.ops.cuda_build import (
    CSRC,
    build_key,
    kernel_name,
    local_headers,
    ptxas_usage,
)
from sparkdl_tpu_torch.ops.flash_attention import FLASH_BWD_DQ, FLASH_FWD

FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a")


@pytest.fixture
def sources(tmp_path):
    """A source that includes a header that includes another, and a system
    header that is not the package's."""
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int kInner = 1;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "kernel.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n'
                   '  #  include "inner.cuh"\nint main() { return kInner; }\n')
    return src


def test_local_headers_follow_nested_includes(sources):
    d = sources.parent
    assert local_headers(sources) == [d / "outer.cuh", d / "inner.cuh"]


@pytest.mark.parametrize("edited", ["kernel.cu", "outer.cuh", "inner.cuh"])
def test_key_changes_when_the_source_or_an_included_header_changes(sources, edited):
    before = build_key(sources, FLAGS, "cuda/bin/nvcc")
    path = sources.parent / edited
    path.write_text(path.read_text() + "// edited\n")
    assert build_key(sources, FLAGS, "cuda/bin/nvcc") != before


def test_key_changes_with_flags_and_compiler(sources):
    key = build_key(sources, FLAGS, "nvcc")
    assert build_key(sources, FLAGS, "nvcc") == key
    assert build_key(sources, (*FLAGS, "-DFLASH_FWD_ROWS=32"), "nvcc") != key
    assert build_key(sources, FLAGS, "cuda-13/bin/nvcc") != key


def test_an_unrelated_file_beside_the_source_leaves_the_key(sources):
    key = build_key(sources, FLAGS, "nvcc")
    (sources.parent / "other.cuh").write_text("// not included\n")
    assert build_key(sources, FLAGS, "nvcc") == key


def test_both_flash_kernels_share_the_mma_header():
    header = CSRC / "flash_attention_mma.cuh"
    for kernel in (FLASH_FWD, FLASH_BWD_DQ):
        assert local_headers(kernel.source) == [header]


def test_kernel_name_reads_the_instances():
    assert (kernel_name("_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvNS_6ParamsE")
            == "flash_fwd_kernel<f32,64>")
    assert (kernel_name("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li128EEEvNS_6ParamsE")
            == "flash_bwd_dq_kernel<bf16,128>")
    assert kernel_name("some_other_symbol") == "some_other_symbol"


def test_ptxas_usage_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvNS_6ParamsE",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, 512 bytes cmem[0]",
    ])
    assert ptxas_usage(log) == {
        "flash_fwd_kernel<f32,64>": {"spill_stores": 8, "spill_loads": 12, "registers": 168}
    }
