"""The kernels' build helper (`repro_torch.kernels._build`) on the CPU:
library names that follow every byte a build reads, and the ptxas
report. Nothing is compiled here (there is no nvcc)."""
import shutil

from repro_torch.kernels import _build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tc11dkdv_kernelILi128EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc11dkdv_kernelILi128EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 236 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tc9dq_kernelILi64EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc9dq_kernelILi64EEEvv
    392 bytes stack frame, 868 bytes spill stores, 864 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 392 bytes cumulative stack size
"""


def _copy_kernels(tmp_path, monkeypatch):
    root = tmp_path / "kernels"
    for name in _build.NAMES:
        src = _build.source(name)
        dst = root / src.relative_to(_build.KERNELS_DIR)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    shutil.copy(_build.source("flash_attention").parent / "hopper.cuh",
                root / "flash_attention" / "csrc" / "hopper.cuh")
    monkeypatch.setattr(_build, "KERNELS_DIR", root)
    return root


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """Editing ``hopper.cuh`` renames both attention libraries (a stale
    build is never loaded) and leaves the kernels that do not sit beside
    it alone; so does editing a source, for its own library only."""
    root = _copy_kernels(tmp_path, monkeypatch)
    before = {n: _build.library_path(n) for n in _build.NAMES}
    assert before == {n: _build.library_path(n) for n in _build.NAMES}
    header = root / "flash_attention" / "csrc" / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.NAMES}
    for name in ("flash_attention", "flash_attention_bwd"):
        assert after[name] != before[name]
        assert after[name].parent == before[name].parent
    for name in ("decode_attention", "decode_attention_hd", "ssm_scan",
                 "ssm_scan_bwd"):
        assert after[name] == before[name]
    src = _build.source("ssm_scan")
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.library_path("ssm_scan") != after["ssm_scan"]
    assert _build.library_path("ssm_scan_bwd") == after["ssm_scan_bwd"]
    assert _build.library_path("flash_attention") == after["flash_attention"]


def test_every_library_has_its_source():
    """Six libraries, each from its own source: the two backwards' and
    the head_dim-slice decode pair's beside their forwards' in those
    kernels' packages."""
    assert _build.NAMES == ("flash_attention", "flash_attention_bwd",
                            "decode_attention", "decode_attention_hd",
                            "ssm_scan", "ssm_scan_bwd")
    for name in _build.NAMES:
        src = _build.source(name)
        assert src.is_file() and src.name == f"{name}.cu"
    assert _build.source("ssm_scan_bwd").parent == \
        _build.source("ssm_scan").parent
    assert _build.source("decode_attention_hd").parent == \
        _build.source("decode_attention").parent
    assert len({_build.library_path(n).name for n in _build.NAMES}) == 6


def test_attention_sources_share_one_header():
    """Both attention sources include ``hopper.cuh`` and define none of
    its TMA, mbarrier and wgmma helpers themselves."""
    header = (_build.source("flash_attention").parent
              / "hopper.cuh").read_text()
    for helper in ("int make_map(", "void mbar_wait(", "void tma_load(",
                   "uint64_t desc_b128(", "EncodeTiled encode_fn("):
        assert helper in header
        for name in ("flash_attention", "flash_attention_bwd"):
            text = _build.source(name).read_text()
            assert '#include "hopper.cuh"' in text
            assert helper not in text


def test_ptxas_report_reads_registers_and_spills():
    assert _build.ptxas_report(PTXAS_LOG) == [
        ("_ZN2tc11dkdv_kernelILi128EEEvv", 236, 0, 0),
        ("_ZN2tc9dq_kernelILi64EEEvv", 168, 868, 864)]
    assert _build.ptxas_report("") == []
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]


def test_substitute_answers_another_library_for_a_while():
    """`substitute` has `load` answer the library it was given (here the
    C library, since nothing is compiled on the CPU) inside the block, and
    give back the one it had after, without building anything."""
    import ctypes.util
    path = ctypes.util.find_library("c")
    assert path
    before = _build._libs.get("ssm_scan_bwd")
    with _build.substitute("ssm_scan_bwd", path) as lib:
        assert _build.load("ssm_scan_bwd") is lib
    assert _build._libs.get("ssm_scan_bwd") is before


def test_scan_bwd_ablation_cuts_apply_to_the_source():
    """Every copy the scan backward's ablation builds finds the lines it
    takes out in the source as it is, and differs from it."""
    from repro_torch.kernels.ssm_scan import ablation
    source = _build.source("ssm_scan_bwd").read_text()
    texts = ablation.copies(source)
    assert set(texts) == {"as is", *ablation.CUTS}
    assert texts["as is"] == source
    assert all(texts[name] != source for name in ablation.CUTS)
