"""The kernel build's cache key: a library is rebuilt when its source, a
header it includes from ``csrc/`` or the flags change (no nvcc needed)."""

import ctypes
import os
import re

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
    # one arithmetic: the L2 whole-solve kernels take their per-voxel bodies
    # from voxel.cuh, whose last per-launch caller, the generic pass B of
    # csrc/cp_fused.cu, is gone (pass B is specialised.cu's per table)
    sources = build._sources(os.path.join(build.CSRC, "resident.cu"))
    assert [os.path.basename(p) for p in sources] == \
        ["resident.cu", "voxel.cuh", "stencil.cuh"]
    assert not os.path.exists(os.path.join(build.CSRC, "cp_fused.cu"))
    for name in os.listdir(build.CSRC):
        if name.endswith(".cu") and name != "resident.cu":
            with open(os.path.join(build.CSRC, name)) as f:
                assert "cp_primal_voxel(" not in f.read(), name
    # the TGV kernels: the streaming pair and both whole-solve kernels take
    # theirs from tgv.cuh
    for name in ("tgv_stream", "tgv_resident", "tgv_onchip"):
        sources = build._sources(os.path.join(build.CSRC, f"{name}.cu"))
        assert [os.path.basename(p) for p in sources] == \
            [f"{name}.cu", "tgv.cuh", "stencil.cuh"]
    # the specialised kernels' sources (the sharded CP passes, the sharded
    # step's boundary kernels, the z-marching pass A and the on-chip whole
    # solves among them) share specialised.cuh: the channel tables, and
    # voxel.cuh for the fidelity dual
    for name in ("specialised", "specialised_tv", "specialised_cp",
                 "cp_boundary", "cp_zstream", "resident_onchip"):
        sources = build._sources(os.path.join(build.CSRC, f"{name}.cu"))
        assert [os.path.basename(p) for p in sources] == \
            [f"{name}.cu", "specialised.cuh", "tables.cuh", "voxel.cuh",
             "stencil.cuh"]


def test_only_the_specialised_source_splits_its_compile():
    """nvcc compiles the sources of the specialised kernels (a kernel per
    channel table and storage: B1 and B4 in specialised.cu, B3 and B5 in
    specialised_tv.cu, B1 and B2 on a shard in specialised_cp.cu, B8 in
    cp_boundary.cu, B10 in cp_zstream.cu, B9 on chip in
    resident_onchip.cu) on every core; the others as they were, and the
    flags are part of each library's cache key."""
    for name in ("specialised", "specialised_tv", "specialised_cp",
                 "cp_boundary", "cp_zstream", "resident_onchip"):
        assert build.nvcc_flags(name) == \
            build.NVCC_FLAGS + ("-split-compile", "0")
    assert set(build.SOURCE_FLAGS) == {"specialised", "specialised_tv",
                                       "specialised_cp", "cp_boundary",
                                       "cp_zstream", "resident_onchip"}
    for name in ("tgv_stream", "tgv_resident", "tgv_onchip", "resident"):
        assert build.nvcc_flags(name) == build.NVCC_FLAGS
    assert "-fmad=false" in build.NVCC_FLAGS


def test_every_library_has_its_entry_points_and_its_source():
    """Each library the wrappers bind is a source under ``csrc/``, and each
    launch function it names is defined there or in a header it includes."""
    from pytv4d_tpu_torch.kernels import fused

    import pytv4d_tpu_torch.kernels  # noqa: F401  (every wrapper registers)

    assert set(fused._ENTRY_POINTS) == {
        "tgv_stream", "tgv_resident", "tgv_onchip", "cp_zstream",
        "resident", "resident_onchip", "cp_boundary", "specialised",
        "specialised_tv", "specialised_cp"}
    # every library is a source, and every source a library
    assert {n[:-3] for n in os.listdir(build.CSRC) if n.endswith(".cu")} \
        == set(fused._ENTRY_POINTS)
    for name, (prefix, params, launches) in fused._ENTRY_POINTS.items():
        text = ""
        for path in build._sources(os.path.join(build.CSRC, f"{name}.cu")):
            with open(path) as f:
                text += f.read()
        assert f"{prefix}_error_string(" in text
        assert hasattr(params, "_fields_")
        for fn in launches:
            assert f"int {fn}(" in text


def test_params_struct_mirrors_the_header():
    """``kernels.fused._Params`` is ``struct Params`` of ``csrc/stencil.cuh``
    field for field: the same names in the same order, 4-byte ints and
    floats, arrays of MAX_CH.  The struct crosses to the kernels by value,
    so a field that drifts would shift every one after it."""
    from pytv4d_tpu_torch.kernels import fused

    with open(os.path.join(build.CSRC, "stencil.cuh")) as f:
        text = f.read()
    max_ch = int(re.search(r"#define MAX_CH (\d+)", text).group(1))
    assert max_ch == fused.MAX_CHANNELS
    body = re.search(r"struct Params \{(.*?)\n\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    want = []
    for ctype, decls in re.findall(r"\b(int|float)\s+([^;]+);", body):
        for decl in decls.split(","):
            name, array = re.fullmatch(r"\s*(\w+)\s*(\[MAX_CH\])?\s*",
                                       decl).groups()
            want.append((name, ctype, max_ch if array else 1))
    got = []
    for name, ftype in fused._Params._fields_:
        n = getattr(ftype, "_length_", 1)
        base = getattr(ftype, "_type_", ftype) if n > 1 else ftype
        assert base in (ctypes.c_int, ctypes.c_float), name
        assert ctypes.sizeof(base) == 4
        got.append((name, "int" if base is ctypes.c_int else "float", n))
    assert got == want
    assert ctypes.sizeof(fused._Params) == 4 * sum(n for _, _, n in want)
    assert [n for n, _, _ in want][-7:] == [
        "sharded", "t_free", "xe", "ye", "ne", "z_first", "z_last"]


class _Defines:
    """A stand-in library that has exactly the functions named."""

    def __init__(self, names):
        self.__dict__.update(dict.fromkeys(names))


def test_each_launch_with_partials_has_its_count():
    """A launch that writes TV or fidelity partials has a C function that
    counts them: its own ``<launch>_num_parts`` (the two passes of
    specialised_tv.cu, whose blocks differ, and their halo modes, and the
    unsharded CP pass B, whose runs are wider than pass A's), its mode's
    ``<prefix>_<mode>_num_parts`` (the sharded CP passes' interior
    launches) or the library's ``<prefix>_num_parts``; the generic B5 in
    its halo mode (csrc/tv_fused.cu), the generic B3 in its halo mode, the
    generic B1 and the generic B2 (csrc/cp_fused.cu) are gone with their
    entry points.  The boundary kernels count the interior launches'
    partials, whose edge rows they fill, as the interior launches count
    them (their halo mode counts its own blocks)."""
    from pytv4d_tpu_torch.kernels import fused

    counts = {}
    for name in ("specialised", "specialised_tv", "specialised_cp",
                 "cp_boundary"):
        prefix, _, launches = fused._ENTRY_POINTS[name]
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            text = f.read()
        defined = set(re.findall(r"long long (\w+_num_parts)\(", text))
        for fn in launches:
            counts[fn] = fused._num_parts_name(_Defines(defined), prefix, fn)
        assert set(counts[fn] for fn in launches) <= defined
    assert counts["spectv_norms_launch"] == "spectv_norms_num_parts"
    assert counts["spectv_dual_launch"] == "spectv_dual_num_parts"
    assert counts["spec_cp_dual_launch"] == "spec_num_parts"
    assert counts["spectv_norms_halo_launch"] == \
        "spectv_norms_halo_num_parts"
    assert counts["spectv_dual_halo_launch"] == "spectv_dual_halo_num_parts"
    assert "tv_fused" not in fused._ENTRY_POINTS
    assert counts["cp_dual_boundary_launch"] == "bnd_num_parts"
    assert counts["cp_primal_boundary_launch"] == "bnd_num_parts"
    assert counts["spcp_dual_halo_launch"] == "spcp_num_parts"
    assert counts["spcp_primal_halo_launch"] == "spcp_num_parts"
    assert counts["spcp_dual_interior_launch"] == "spcp_interior_num_parts"
    assert counts["spcp_primal_interior_launch"] == \
        "spcp_interior_num_parts"
    # the unsharded pass B counts its own blocks (VEC_B columns a run)
    assert counts["spec_cp_primal_launch"] == "spec_cp_primal_num_parts"
    # pass 2 with the GD epilogue counts its own blocks (a tile each)
    assert counts["spec_tv_gd_launch"] == "spec_tv_gd_num_parts"
    assert "cp_fused" not in fused._ENTRY_POINTS


def test_onchip_key_hashes_its_source_and_headers(tmp_path):
    """The on-chip B7 library's name changes with its source and with each
    header it includes (tgv.cuh, which the other TGV kernels share, and
    stencil.cuh), so a changed body is rebuilt everywhere it is used."""
    import shutil

    for name in ("tgv_onchip.cu", "tgv.cuh", "stencil.cuh"):
        shutil.copy(os.path.join(build.CSRC, name), tmp_path / name)
    src = str(tmp_path / "tgv_onchip.cu")
    keys = {build._library_path(src)}
    for name in ("tgv_onchip.cu", "tgv.cuh", "stencil.cuh"):
        with open(tmp_path / name, "a") as f:
            f.write("\n// changed\n")
        keys.add(build._library_path(src))
    assert len(keys) == 4
    assert all(os.path.basename(k).startswith("tgv_onchip-") for k in keys)
