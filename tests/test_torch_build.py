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
    names = ("fused_fb", "split_fb", "duplex_fb", "split_probe")
    for name in names:
        assert _build.sources(name) == [f"{name}.cu", "fb_common.cuh"]
    assert len({_build.library_path(n) for n in names}) == len(names)
