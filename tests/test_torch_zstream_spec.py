"""The z-marching pass A (B10, ``csrc/cp_zstream.cu``) as far as the CPU
reaches it: its channel tables against the source's list and every
configuration the kernel takes, the raise on a table outside the list, what
the wrapper hands its library, the ring's constants, the source's entry
points and the library key, and that a CPU tensor launches nothing.  The
kernel itself runs on the card (``chip_smoke.py`` phase 22 holds it bit for
bit against B1); ``tests/test_torch_zstream.py`` holds the wrapper against
the JAX package's interpreted kernel."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import AXIS_Z, SCHEMES, num_channels
from pytv4d_tpu_torch.kernels import build, fused, tables, zstream
from pytv4d_tpu_torch.utils import profiling

SOURCE = os.path.join(build.CSRC, "cp_zstream.cu")
GATINGS = {"base": {}, "time": dict(reg_time=0.5),
           "zt": dict(reg_time=0.7, reg_z_over_reg=0.3),
           "noz": dict(reg_z_over_reg=0.0)}


def _source():
    with open(SOURCE) as f:
        return f.read()


def test_the_list_is_the_sources():
    with open(os.path.join(build.CSRC, "tables.cuh")) as f:
        listed = re.search(r"#define TABLES_WITH_Z\(X\)([^\n]*)",
                           f.read()).group(1)
    ids = tuple(int(i) for i in re.findall(r"X\((\d+)\)", listed))
    assert ids == tables.ZSTREAM_TABLES
    assert "TABLES_WITH_Z(ZS_CASE)" in _source()
    for tid in ids:  # each differences along z
        assert any(axis == AXIS_Z for axis, _ in tables.TABLES[tid])


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("gating", list(GATINGS))
def test_every_configuration_the_kernel_takes_has_a_table(scheme, gating):
    """Nz >= 3 with a z channel (the wrapper's guard) maps to a listed
    table; the rest is refused by the guard before any table is sought."""
    cfg = TVConfig(scheme=scheme, **GATINGS[gating])
    for Nz in (3, 4, 5, 8):
        for M in (1, 2, 3):
            x = torch.zeros((Nz, M, 4, 6))
            if gating == "noz":
                with pytest.raises(ValueError, match="z channels"):
                    zstream._check_zstream(x, cfg)
                continue
            zstream._check_zstream(x, cfg)
            assert tables.zstream_table_id(cfg, Nz, M) in \
                tables.ZSTREAM_TABLES


def test_every_listed_table_is_met():
    seen = {tables.zstream_table_id(TVConfig(scheme=s, **GATINGS[g]), Nz, M)
            for s in SCHEMES for g in ("base", "time", "zt")
            for Nz in (3, 4) for M in (1, 2, 3)}
    assert seen == set(tables.ZSTREAM_TABLES)


@pytest.mark.parametrize("cfg, dims", [
    (TVConfig(scheme="hybrid", reg_z_over_reg=0.0), (4, 2)),   # no z
    (TVConfig(scheme="central"), (2, 1)),                      # FWD z
    (TVConfig(scheme="upwind", reg_time=0.5), (1, 3)),         # no z
])
def test_a_table_outside_the_list_raises(cfg, dims):
    with pytest.raises(ValueError, match="cp_zstream.cu"):
        tables.zstream_table_id(cfg, *dims)


def _operands(x_dtype, d_dtype, cfg, shape=(4, 2, 5, 6)):
    rng = np.random.default_rng(0)
    Nz, M, Nr, Nc = shape
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)

    def arr(*s, dtype):
        return torch.as_tensor(rng.random(s, dtype=np.float32)).to(dtype)

    return (arr(*shape, dtype=x_dtype), arr(*shape, dtype=x_dtype),
            arr(*shape, dtype=x_dtype), arr(Nz, M, Nd, Nr, Nc, dtype=d_dtype))


@pytest.mark.parametrize("x_dtype, d_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_wrapper_passes_table_and_storage(monkeypatch, x_dtype, d_dtype):
    """What the launch hands its library: the table id first, then the
    storage flags, the operands in the C entry point's order, its partials
    asked for; it counts its launch."""
    seen = []
    monkeypatch.setattr(zstream, "_launch",
                        lambda *a, **k: seen.append((a, k)) or "parts")
    profiling.clear_counters()
    cfg = TVConfig(scheme="central", reg_time=0.5)
    x, x0, y_A, y_D = _operands(x_dtype, d_dtype, cfg, (4, 2, 5, 6))
    got = zstream._zstream_kernel(x, x0, y_A, y_D, cfg=cfg, sigma_D=0.5,
                                  sigma_A=1.0, reg=0.3, fidelity="kl",
                                  fid_weight=1.3)
    assert got == (y_A, y_D, "parts")
    tid = tables.zstream_table_id(cfg, 4, 2)
    assert tid == 20  # central, z CTR, t FWD (M == 2)
    ((args, kw),) = seen
    assert args[:3] == ("cp_zstream", "cp_dual_zstream_launch", x)
    assert args[4] == (tid, int(x_dtype == torch.bfloat16),
                       int(d_dtype == torch.bfloat16))
    assert all(a is b for a, b in zip(args[5], (x, x0, y_A, y_D)))
    assert kw == {"with_parts": True}
    p = args[3]
    assert (p.Nz, p.M, p.Nr, p.Nc, p.Nd, p.has_tmul) == (4, 2, 5, 6, 4, 0)
    assert p.fidelity == 2 and p.sharded == 0
    assert profiling.counters()["launch.B10"] == 1


def test_an_unlisted_table_launches_nothing(monkeypatch):
    seen = []
    monkeypatch.setattr(zstream, "_launch", lambda *a, **k: seen.append(a))
    profiling.clear_counters()
    cfg = TVConfig(scheme="hybrid", reg_z_over_reg=0.0)
    x, x0, y_A, y_D = _operands(torch.float32, torch.float32, cfg)
    with pytest.raises(ValueError, match="cp_zstream.cu"):
        zstream._zstream_kernel(x, x0, y_A, y_D, cfg=cfg, sigma_D=0.5,
                                sigma_A=1.0, reg=0.3, fidelity="l2",
                                fid_weight=1.0)
    assert seen == [] and profiling.counters()["launch.B10"] == 0


def test_a_cpu_tensor_launches_nothing(monkeypatch):
    profiling.clear_counters()
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x, x0, y_A, y_D = _operands(torch.float32, torch.float32, cfg)
    a, b = [y_A.clone(), y_D.clone()], [y_A.clone(), y_D.clone()]
    kw = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=0.3)
    _, _, tz = zstream.cp_dual_zstream(x, x0, *a, **kw)
    _, _, tp = fused.cp_dual_plain(x, x0, *b, None, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(tz, tp)
    assert profiling.counters()["launch.B10"] == 0


def test_the_ring_constants():
    """Four slots of two rows and their halo rows: the ring fits its 48 KB
    up to 768 float32 columns (the source's note), and a tile is one
    contiguous run of its plane; the partials are one per block of ZROWS
    rows of a t-plane."""
    text = _source()

    def const(name):
        return eval(re.search(rf"constexpr int {name} = ([^;]+);",
                              text).group(1))

    rows, slots, limit = const("ZROWS"), const("ZSLOTS"), const("ZRING_BYTES")
    assert (rows, slots, const("ZV")) == (2, 4, 2)
    assert slots * (rows + 2) * 768 * 4 <= limit < \
        slots * (rows + 2) * 769 * 4
    assert slots & (slots - 1) == 0  # the slot of z is z & (ZSLOTS - 1)
    assert "return (long long)M * ((Nr + ZROWS - 1) / ZROWS);" in text


def test_zstream_source_exports_its_entry_points():
    text = _source()
    prefix, params, launches = fused._ENTRY_POINTS["cp_zstream"]
    assert prefix == "cpz" and params is fused._Params
    assert launches == {"cp_dual_zstream_launch": (3, 5)}
    sig = re.search(r"int cp_dual_zstream_launch\(([^)]*)\)",
                    text).group(1)
    args = [a.strip() for a in sig.split(",")]
    assert args[:4] == ["const Params* p", "int id", "int x_bf16",
                        "int d_bf16"]
    # x, x0, y_A, y_D, the partials, the stream
    assert len(args) == 4 + 5 + 1 and all("void*" in a for a in args[4:])
    assert "long long cpz_num_parts(int Nz, int M, int Nr, int Nc)" in text
    assert "const char* cpz_error_string(int code)" in text
    assert "dual_spec_run<T, ZV, true, TX, TD>" in text
    assert "cp.async" in text


def test_zstream_key_hashes_its_source_and_headers(tmp_path):
    names = ("cp_zstream.cu", "specialised.cuh", "tables.cuh", "voxel.cuh",
             "stencil.cuh")
    assert [os.path.basename(p) for p in build._sources(SOURCE)] == \
        list(names)
    for name in names:
        shutil.copy(os.path.join(build.CSRC, name), tmp_path / name)
    src = str(tmp_path / "cp_zstream.cu")
    keys = {build._library_path(src)}
    for name in names:
        with open(tmp_path / name, "a") as f:
            f.write("\n// changed\n")
        keys.add(build._library_path(src))
    assert len(keys) == len(names) + 1
    assert all(os.path.basename(k).startswith("cp_zstream-") for k in keys)
