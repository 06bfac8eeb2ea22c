"""The port's kernel builder, on the CPU (no nvcc is run): a library's file
name must change with every file its source can reach, so that a stale
build is never loaded, and the ``-Xptxas -v`` report must be read right,
since chip_smoke.py fails a run on what it finds there."""
import os

from repro_torch.kernels import build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for \
the wgmma pipeline in the function '_Z5otherv'
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 384 bytes cmem[0]
"""


def _tree(tmp_path):
    csrc = tmp_path / "kern" / "csrc"
    shared = tmp_path / "shared"
    csrc.mkdir(parents=True)
    shared.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n#include <cuda.h>\n'
                               '#include "../../shared/common.cuh"\n')
    (csrc / "k.cuh").write_text("// header\n")
    (csrc / "notes.txt").write_text("tiles\n")
    (shared / "common.cuh").write_text('#include "deeper.cuh"\n')
    (shared / "deeper.cuh").write_text("// deeper\n")
    (shared / "unrelated.cuh").write_text("// not included\n")
    return csrc / "k.cu", csrc, shared


def test_source_files_reach_csrc_and_quoted_includes(tmp_path):
    src, csrc, shared = _tree(tmp_path)
    got = build.source_files(str(src))
    assert got == sorted(os.path.abspath(p) for p in (
        src, csrc / "k.cuh", csrc / "notes.txt", shared / "common.cuh",
        shared / "deeper.cuh"))


def test_editing_any_reached_file_changes_the_library(tmp_path):
    src, csrc, shared = _tree(tmp_path)
    first = build._target("k", str(src))
    assert build._target("k", str(src)) == first     # deterministic
    seen = {first}
    for path, text in ((csrc / "k.cuh", "// header, edited\n"),
                       (shared / "deeper.cuh", "// deeper, edited\n"),
                       (csrc / "notes.txt", "other tiles\n"),
                       (src, src.read_text() + "// more\n")):
        path.write_text(text)
        target = build._target("k", str(src))
        assert target not in seen, f"editing {path.name} kept {target}"
        seen.add(target)
    before = build._target("k", str(src))
    (shared / "unrelated.cuh").write_text("// edited, still not included\n")
    assert build._target("k", str(src)) == before


def test_the_port_sources_hash_their_headers():
    from repro_torch.kernels.flash_attention import ops
    files = [os.path.basename(p) for p in build.source_files(ops.SOURCE)]
    assert files == ["flash_attention.cu", "hopper.cuh"]


def test_ptxas_report():
    rep = build.ptxas_report(PTXAS_LOG)
    assert rep["kernels"] == [
        {"name": "_Z6kernelILi64EEvv", "registers": 168, "stack_bytes": 0,
         "spill_stores": 0, "spill_loads": 0},
        {"name": "_Z5otherv", "registers": 255, "stack_bytes": 8,
         "spill_stores": 24, "spill_loads": 16}]
    assert len(rep["wgmma_serialized"]) == 1
    assert "_Z5otherv" in rep["wgmma_serialized"][0]
    clean = build.ptxas_report(PTXAS_LOG.split("ptxas info    : (C7515)")[0])
    assert clean["wgmma_serialized"] == []
    assert build.ptxas_report("") == {"kernels": [], "wgmma_serialized": []}
