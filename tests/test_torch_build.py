"""The kernel build's cache key: a library's file name hashes its source and
every csrc/ header that source includes, so an edited header is rebuilt and
never loaded stale. Runs without nvcc: only the hashing is exercised."""

from pysvihmm_tpu_torch import _build


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert _build.sources("k") == ["k.cu", "a.cuh", "b.cuh"]

    path = _build.library_path("k")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libk_")
    (tmp_path / "other.cuh").write_text("// not included, edited\n")
    assert _build.library_path("k") == path
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = _build.library_path("k")
    assert edited != path
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert _build.library_path("k") not in (path, edited)


def test_both_kernel_sources_share_the_header():
    """Every source includes the shared device code and the large-K layout;
    the three route sources also the fixed-order statistics and the
    S-sequences-a-block layout of their K <= 64 chains (one forward for all
    three, one backward for the fused and split pairs); the fused library's
    units also its kernels' tables and the any-width K <= 64 layout."""
    names = ("fused_fb", "split_fb", "duplex_fb", "split_probe")
    for name in names:
        seqs = ["fb_seqs.cuh"] if name != "split_probe" else []
        stats = [] if name == "split_probe" else ["fb_stats.cuh"]
        own = ["fused_fb_kernels.cuh", "fb_seqs_wf.cuh"] if name == "fused_fb" else []
        assert _build.sources(name) == [f"{name}.cu", "fb_common.cuh", *seqs, *stats,
                                        "fb_wide.cuh", *own]
    assert len({_build.library_path(n) for n in names}) == len(names)
    assert _build.units("fused_fb") == ("fused_fb", "fused_fb_modes", "fused_fb_wide",
                                        "fused_fb_wide_modes")
    for unit in _build.units("fused_fb")[1:]:
        assert _build.sources(unit) == [
            f"{unit}.cu", "fused_fb_kernels.cuh", "fb_common.cuh", "fb_seqs.cuh",
            "fb_seqs_wf.cuh", "fb_stats.cuh", "fb_wide.cuh"]


def test_library_path_follows_every_unit(tmp_path, monkeypatch):
    """A library of several translation units (the fused pair's default and
    modes' instances) hashes each unit and what each includes; a source of
    one library alone is its only unit."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "UNITS", {"k": ("k", "k_more")})
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "k_more.cu").write_text('#include "m.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "m.cuh").write_text("// m\n")
    (tmp_path / "j.cu").write_text("// j\n")
    assert _build.units("k") == ("k", "k_more") and _build.units("j") == ("j",)
    path = _build.library_path("k")
    assert path.name.startswith("libk_")
    (tmp_path / "m.cuh").write_text("// m, edited\n")
    edited = _build.library_path("k")
    assert edited != path
    (tmp_path / "k_more.cu").write_text('#include "m.cuh"\n// edited\n')
    assert _build.library_path("k") not in (path, edited)
