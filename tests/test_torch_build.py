"""How the port names and shares its CUDA builds, checked without nvcc.

A kernel library's file name carries a hash of what it was built from
(``_build._lib_path``): its source, every header under ``csrc/`` and the
nvcc flags, so a library built from stale bytes is never reused. The PTX
helpers of the bf16 tensor-core flash kernels live in one header,
``mma_bf16.cuh``, that both flash sources include. ``chip_smoke.py``
reads each kernel's registers and spills from nvcc's ``-Xptxas -v``
report, and builds its forward faults by patching one line of
``flash_fwd.cu``: both are checked here too.
"""

import os
import shutil

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

from tpudist_torch.ops import _build

pytestmark = pytest.mark.torch_port

HEADER = "mma_bf16.cuh"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def _paths():
    return {name: _build._lib_path(name) for name in _build.SOURCES}


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_header_edit_renames_the_library(csrc, name):
    before = _paths()
    header = csrc / HEADER
    text = header.read_bytes()
    header.write_bytes(text + b"// edited\n")
    edited = _paths()
    assert edited[name] != before[name]
    assert os.path.dirname(edited[name]) == _build.BUILD_DIR
    header.write_bytes(text)
    assert _paths() == before


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_source_edit_renames_only_its_library(csrc, name):
    before = _paths()
    src = csrc / _build.SOURCES[name]
    src.write_bytes(src.read_bytes() + b"\n")
    after = _paths()
    assert after[name] != before[name]
    assert {k: v for k, v in after.items() if k != name} \
        == {k: v for k, v in before.items() if k != name}


def test_ptx_helpers_live_in_one_header():
    """The cp.async, ldmatrix and mma.sync wrappers are defined once, in
    the header, and both flash sources include it."""
    for fname in _build.SOURCES.values():
        with open(os.path.join(_build.CSRC_DIR, fname)) as f:
            text = f.read()
        for ptx in ("mma.sync", "ldmatrix", "cp.async"):
            assert f'"{ptx}' not in text, (fname, ptx)
        if fname.startswith("flash_"):
            assert f'#include "{HEADER}"' in text, fname
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        text = f.read()
    for ptx in ("mma.sync.aligned.m16n8k16", "ldmatrix.sync.aligned",
                "cp.async.cg", "cp.async.wait_group"):
        assert ptx in text


# Mangled kernel names as ptxas prints them, and the names chip_smoke.py
# reports them by.
MANGLED = [
    ("_ZN12_GLOBAL__N_113flash_fwd_mmaILi64EEEvPK13__nv_bfloat16S3_S3_PS1_"
     "PfiiiNS_7StridesEif", "flash_fwd_mma<64>"),
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelILi80EEEvPKfS2_S2_PfS3_iiiNS_"
     "7StridesEif", "flash_fwd_kernel<80>"),
    ("_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi80EEEvPKT_S3_S3_S3_PKfS5_"
     "PS1_S6_iiiNS_7StridesEif", "flash_bwd_dkv_kernel<f32,80>"),
    ("_ZN12_GLOBAL__N_117bn_act_bwd_kernelI13__nv_bfloat16Lb1EEEvPKT_S4_"
     "S4_PKfS6_PS2_S7_PfS8_lii", "bn_act_bwd_kernel<bf16,true>"),
    ("_Z6helperv", "_Z6helperv"),
]


@pytest.mark.parametrize("mangled,name", MANGLED)
def test_kernel_names_read_from_mangled(mangled, name):
    import chip_smoke
    assert chip_smoke._kernel_name(mangled) == name


def test_ptxas_report_gives_registers_and_spills_by_kernel():
    """chip_smoke.py fails its build phase on a spill in a bf16 ``_mma``
    kernel, reading the ``-Xptxas -v`` report as parsed here."""
    import chip_smoke
    fwd, dkv = MANGLED[0][0], MANGLED[2][0]
    log = (f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {fwd}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 126 registers, used 1 barriers\n"
           f"ptxas info    : Compiling entry function '{dkv}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {dkv}\n"
           "    48 bytes stack frame, 48 bytes spill stores, 44 bytes spill "
           "loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers\n")
    assert chip_smoke._ptxas_entries(log) == {
        "flash_fwd_mma<64>": {"registers": 126, "spill_stores": 0,
                              "spill_loads": 0},
        "flash_bwd_dkv_kernel<f32,80>": {"registers": 80,
                                         "spill_stores": 48,
                                         "spill_loads": 44}}


@pytest.mark.parametrize("name", ["fwd_key_tile_1_dropped",
                                  "fwd_l_from_rounded_p"])
def test_forward_mutants_patch_one_line_of_the_kernel(name):
    """``chip_smoke.py --mutations`` builds each forward fault by patching
    one line of flash_fwd.cu: the line is there exactly once, and the
    fault is not."""
    import chip_smoke
    old, new = chip_smoke.FWD_MUTANTS[name]
    src = os.path.join(_build.CSRC_DIR, _build.SOURCES["flash_fwd"])
    with open(src) as f:
        text = f.read()
    assert text.count(old) == 1
    assert new not in text
