"""The kernel build's cache key: a library is rebuilt when its source, a
header it includes from ``csrc/`` or the flags change (no nvcc needed)."""

import os

from pytv4d_tpu_torch.kernels import build


def test_library_path_follows_included_headers(tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n'
                                   '#include "not_here.h"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    src = str(tmp_path / "k.cu")
    assert [os.path.basename(p) for p in build._sources(src)] == \
        ["k.cu", "a.cuh", "b.cuh"]
    first = build._library_path(src)
    assert os.path.dirname(first) == build.BUILD_DIR
    assert os.path.basename(first).startswith("k-")
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    second = build._library_path(src)
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert build._library_path(src) not in (first, second)


def test_repo_kernels_include_the_shared_header():
    # one arithmetic: the per-launch kernels, the z-marching pass A and the
    # whole-solve kernels all take their per-voxel bodies from voxel.cuh
    for name in ("cp_fused", "tv_fused", "cp_zstream", "resident"):
        sources = build._sources(os.path.join(build.CSRC, f"{name}.cu"))
        assert [os.path.basename(p) for p in sources] == \
            [f"{name}.cu", "voxel.cuh", "stencil.cuh"]
    for name in ("tgv_stream", "tgv_resident"):
        sources = build._sources(os.path.join(build.CSRC, f"{name}.cu"))
        assert [os.path.basename(p) for p in sources] == \
            [f"{name}.cu", "tgv.cuh", "stencil.cuh"]


def test_every_library_has_its_entry_points_and_its_source():
    """Each library the wrappers bind is a source under ``csrc/``, and each
    launch function it names is defined there."""
    from pytv4d_tpu_torch.kernels import fused

    import pytv4d_tpu_torch.kernels  # noqa: F401  (every wrapper registers)

    assert set(fused._ENTRY_POINTS) == {"cp_fused", "tv_fused", "tgv_stream",
                                        "tgv_resident", "cp_zstream",
                                        "resident"}
    for name, (prefix, params, launches) in fused._ENTRY_POINTS.items():
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            text = f.read()
        assert f"{prefix}_error_string(" in text
        assert hasattr(params, "_fields_")
        for fn in launches:
            assert f"int {fn}(" in text
