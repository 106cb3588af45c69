"""The on-chip whole-solve kernels (B9, ``csrc/resident_onchip.cu``) as far
as the CPU reaches them: which volumes take them (``resident_variant``), the
band split their launch uses, the shared-memory sizes the wrapper computes
against the constants of the source, the table each launch is handed, the source's entry points and the library key, and that a CPU
tensor launches nothing.  The kernels themselves run on the card
(``chip_smoke.py`` phases 20-21 hold them bit for bit against the L2
kernels); ``tests/test_torch_resident.py`` holds the solves against the JAX
package."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import SCHEMES, num_channels
from pytv4d_tpu_torch.kernels import build, fused, resident, tables
from pytv4d_tpu_torch.utils import profiling

HYB = TVConfig(scheme="hybrid", reg_time=0.5)
SOURCE = os.path.join(build.CSRC, "resident_onchip.cu")


def _source():
    with open(SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("shape, cfg, cp, gd", [
    ((1, 1, 256, 256), TVConfig(), "onchip", "onchip"),       # cameraman
    ((4, 2, 64, 64), HYB, "onchip", "onchip"),                # coupled
    ((3, 1, 32, 128), TVConfig(scheme="central"), "onchip", "onchip"),
    ((8, 4, 128, 128), HYB, "l2", "onchip"),  # CP's band needs 240 KB
    ((16, 4, 64, 128), HYB, "l2", "l2"),
])
def test_resident_variant_answers(shape, cfg, cp, gd):
    assert resident.resident_fits(shape, cfg)
    assert resident.resident_variant(shape, cfg) == cp
    assert resident.resident_variant(shape, cfg, "cp") == cp
    assert resident.resident_variant(shape, cfg, "gd") == gd
    for solver, want in (("cp", cp), ("gd", gd)):
        fit = resident.onchip_band(shape, cfg, solver)
        assert (fit is None) == (want == "l2")
        if fit is not None:
            blocks, R, smem = fit
            assert blocks <= resident.H100_SMS
            assert smem <= resident.ONCHIP_SMEM_BYTES


def test_fewer_sms_give_taller_bands():
    """On a card with fewer SMs the bands grow (one block an SM), and a
    volume whose taller bands no longer fit takes the L2 kernel."""
    shape = (1, 1, 256, 256)
    assert resident.onchip_band(shape, TVConfig())[:2] == (128, 2)
    assert resident.onchip_band(shape, TVConfig(), sms=114)[:2] == (86, 3)
    assert resident.resident_variant((8, 4, 128, 128), HYB, "gd") == "onchip"
    assert resident.resident_variant((8, 4, 128, 128), HYB, "gd",
                                     sms=32) == "l2"
    with pytest.raises(ValueError):
        resident.onchip_band(shape, TVConfig(), solver="admm")


@pytest.mark.parametrize("Nr", [1, 2, 3, 7, 64, 131, 132, 133, 256, 263,
                                300, 527])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_band_split_covers_every_row_once(Nr, sms):
    for cfg in (HYB, TVConfig(scheme="central")):
        for solver in ("cp", "gd"):
            fit = resident.onchip_band((1, 1, Nr, 32), cfg, solver, sms)
            blocks, R, _ = fit
            halo = resident.onchip_halo(cfg, 1, 1, solver)
            bands = resident.band_rows(Nr, R)
            assert len(bands) == blocks <= sms
            rows = [r for start, stop in bands for r in range(start, stop)]
            assert rows == list(range(Nr))  # each row once, in order
            # every band but the last holds the rows it lends each side
            assert all(stop - start == R >= min(halo, Nr)
                       for start, stop in bands[:-1])
            assert bands[-1][1] - bands[-1][0] >= 1


def _c_formula(name):
    """The arithmetic a constexpr function of the source returns, as a
    Python expression."""
    body = re.search(name + r"\([^)]*\)\s*\{\s*return ([^;]+);", _source(),
                     re.S).group(1)
    return re.sub(r"\(long long\)|LL\b", "", body)


def test_shared_memory_budget_mirrors_the_source():
    """The constants the wrapper sizes a launch by are the source's: the
    shared bytes a block may take, the threads a block, the exchange words
    a block (the wrapper allocates them) and GD's halo.  The shared bytes a
    band needs are the wrapper's alone (``onchip_floats``)."""
    text = _source()
    expr = re.search(r"#define RESO_SMEM_BYTES \(([^)]*)\)", text).group(1)
    assert eval(expr) == resident.ONCHIP_SMEM_BYTES
    assert int(re.search(r"#define RESO_THREADS (\d+)", text).group(1)) == \
        resident.ONCHIP_THREADS
    ex = _c_formula("exch_words")
    for P, Nc in ((1, 256), (8, 64), (3, 37)):
        assert eval(ex, dict(P=P, Nc=Nc)) == 12 * P * Nc
    # the halo: gd_halo is 2 exactly where a row channel is central
    assert "return tab_has(t, AX_ROW, K_CTR) ? 2 : 1;" in text
    assert "cp_floats" not in text and "gd_floats" not in text
    # the start state's flag: no iteration's, in the even slot
    flag = int(re.search(r"#define RESO_FSTART (0x[0-9a-f]+)u", text)
               .group(1), 16)
    assert flag >= 2 ** 31 and flag % 2 == 0 and flag < 2 ** 32


def test_smem_is_the_bytes_of_the_band():
    for shape, cfg in (((1, 1, 256, 256), TVConfig()), ((4, 2, 64, 64), HYB),
                       ((3, 1, 32, 128), TVConfig(scheme="central"))):
        Nz, M, Nr, Nc = shape
        Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                          cfg.reg_time)
        for solver in ("cp", "gd"):
            blocks, R, smem = resident.onchip_band(shape, cfg, solver)
            H = resident.onchip_halo(cfg, Nz, M, solver)
            assert smem == 4 * resident.onchip_floats(solver, Nd, H, Nz * M,
                                                      Nc, R)
    # cameraman, hybrid (Nd = 4): CP 18 KB, GD 14 KB a block
    assert resident.onchip_band((1, 1, 256, 256), TVConfig())[2] == 18432
    assert resident.onchip_band((1, 1, 256, 256), TVConfig(), "gd")[2] == \
        14336


def test_every_table_has_an_onchip_kernel():
    """Both launchers switch over the 21 tables of csrc/tables.cuh, and
    every configuration the factories take maps to one of them
    (``table_id``); an unlisted table raises."""
    text = _source()
    assert text.count("CHANNEL_TABLES(RESO_CASE)") == 2
    seen = set()
    for scheme in SCHEMES:
        for kw in ({}, dict(reg_time=0.5), dict(reg_z_over_reg=0.0),
                   dict(reg_time=0.7, reg_z_over_reg=0.3)):
            cfg = TVConfig(scheme=scheme, **kw)
            for Nz in (1, 2, 3):
                for M in (1, 2, 3):
                    seen.add(tables.table_id(cfg, Nz, M))
                    assert resident.onchip_halo(cfg, Nz, M, "gd") == (
                        2 if scheme == "central" else 1)
    assert seen == set(range(len(tables.TABLES)))
    with pytest.raises(ValueError):
        tables.table_of(((2, "fwd"), (2, "bwd"), (2, "ctr")))


def test_onchip_source_exports_its_entry_points():
    text = _source()
    prefix, params, launches = fused._ENTRY_POINTS["resident_onchip"]
    assert prefix == "reso" and params is fused._Params
    assert launches == {"reso_cp_launch": (4, 6), "reso_gd_launch": (4, 5)}
    for fn, (n_int, n_ptr) in launches.items():
        sig = re.search(r"int " + fn + r"\(([^)]*)\)", text).group(1)
        args = [a.strip() for a in sig.split(",")]
        assert args[0] == "const Params* p"
        assert all(a.startswith("int ") for a in args[1:1 + n_int])
        # the pointers, then the stream
        assert len(args) == 1 + n_int + n_ptr + 1
        assert all("void*" in a for a in args[1 + n_int:])
    assert "const char* reso_error_string(int code)" in text
    assert "cudaLaunchAttributeCooperative" in text
    assert "grid.sync" not in text and "this_grid" not in text


def test_onchip_key_hashes_its_source_and_headers(tmp_path):
    names = ("resident_onchip.cu", "specialised.cuh", "tables.cuh",
             "voxel.cuh", "stencil.cuh")
    assert [os.path.basename(p) for p in build._sources(SOURCE)] == \
        list(names)
    for name in names:
        shutil.copy(os.path.join(build.CSRC, name), tmp_path / name)
    src = str(tmp_path / "resident_onchip.cu")
    keys = {build._library_path(src)}
    for name in names:
        with open(tmp_path / name, "a") as f:
            f.write("\n// changed\n")
        keys.add(build._library_path(src))
    assert len(keys) == len(names) + 1
    assert all(os.path.basename(k).startswith("resident_onchip-")
               for k in keys)


def _counts():
    got = profiling.counters()
    return tuple(got[f"launch.B9.{k}"] for k in ("onchip", "l2", "cp", "gd"))


@pytest.mark.parametrize("shape, cfg", [
    ((3, 2, 8, 16), HYB), ((1, 1, 16, 16), TVConfig()),
    ((2, 1, 8, 16), TVConfig(scheme="central"))])
def test_a_cpu_tensor_launches_nothing(shape, cfg):
    Nz, M, Nr, Nc = shape
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.random(shape, dtype=np.float32))
    y_A = torch.zeros(shape)
    y_D = torch.zeros((Nz, Nd, M, Nr, Nc))
    kw = dict(reg=0.4, sigma_D=0.5, sigma_A=1.0, tau=0.1)
    before = _counts()
    x, _, _, losses = resident.make_resident_cp_solver(
        cfg, shape, 3, **kw)(x0, x0, y_A, y_D)
    ref = resident.resident_cp_plain(x0, x0, y_A, y_D, 3, cfg=cfg, **kw)
    assert torch.equal(x, ref[0]) and torch.equal(losses, ref[3])
    gx, gl = resident.make_resident_gd_solver(cfg, shape, 3)(x0, x0)
    rx, rl = resident.resident_gd_plain(x0, x0, 3, cfg=cfg, reg=1.0,
                                        step_size=5e-3)
    assert torch.equal(gx, rx) and torch.equal(gl, rl)
    assert _counts() == before


def test_the_launch_is_the_one_resident_variant_names(monkeypatch):
    """The factories take no choice of kernel: the volume's shape on the
    card's SM count picks it, before the launch."""
    for make in (resident.make_resident_cp_solver,
                 resident.make_resident_gd_solver):
        with pytest.raises(TypeError):
            make(HYB, (3, 2, 8, 16), 3, variant="l2")
    monkeypatch.setattr(resident, "_sm_count", lambda device: 132)
    cpu = torch.device("cpu")
    assert resident._kernel("cp", TVConfig(), (1, 1, 256, 256), cpu) is \
        resident.solve_onchip
    assert resident._kernel("cp", HYB, (8, 4, 128, 128), cpu) is \
        resident.solve_l2
    assert resident._kernel("gd", HYB, (8, 4, 128, 128), cpu) is \
        resident.solve_onchip
    monkeypatch.setattr(resident, "_sm_count", lambda device: 32)
    assert resident._kernel("gd", HYB, (8, 4, 128, 128), cpu) is \
        resident.solve_l2
    # GD's step size travels in the struct's tau
    p = resident.solver_params("gd", HYB, (3, 2, 8, 16), reg=0.4,
                               step_size=0.25)
    assert (p.reg, p.tau) == (pytest.approx(0.4), 0.25)
    p = resident.solver_params("cp", HYB, (3, 2, 8, 16), reg=0.4,
                               sigma_D=0.5, sigma_A=1.0, tau=0.125)
    assert (p.sigma_D, p.sigma_A, p.tau) == (0.5, 1.0, 0.125)


@pytest.mark.parametrize("solver", ["cp", "gd"])
def test_launches_hand_table_band_and_buffers(monkeypatch, solver):
    """What each kernel's launch hands its library (``_launch`` recording,
    CPU tensors): on chip the table id, n_iter, the band's rows and its
    shared bytes, the state in the C entry point's order, the partials and
    the zeroed exchange words; in L2 the launch shape and, for GD, the
    norms.  Each counts its launch."""
    seen = []
    monkeypatch.setattr(resident, "_launch",
                        lambda *a, **k: seen.append((a, k)))
    monkeypatch.setattr(resident, "_sm_count", lambda device: 132)
    monkeypatch.setattr(resident, "_launch_shape",
                        lambda x, vol: (7, resident.THREADS))
    profiling.clear_counters()
    shape, cfg = (4, 2, 64, 64), HYB
    Nd = num_channels(cfg.scheme, 4, 2, cfg.reg_z_over_reg, cfg.reg_time)
    x0 = torch.zeros(shape)
    if solver == "cp":
        state = (torch.zeros(shape), torch.zeros(shape),
                 torch.zeros((4, 2, Nd, 64, 64)))
    else:
        state = (torch.zeros(shape), torch.zeros(shape))
    p = fused._params(cfg, shape, False)
    losses = resident.solve_onchip(solver, cfg, x0, p, 5, state)
    blocks, R, smem = resident.onchip_band(shape, cfg, solver)
    assert tuple(losses.shape) == (5,)
    (args, kw), = seen
    assert args[:4] == ("resident_onchip", f"reso_{solver}_launch", x0, p)
    assert args[4] == (tables.table_id(cfg, 4, 2), 5, R, smem)
    ops = args[5]
    assert ops[0] is x0 and all(a is b for a, b in zip(ops[1:], state))
    assert tuple(ops[-2].shape) == (5, 2, blocks) and kw == {}
    ex = ops[-1]
    assert ex.dtype == torch.int64 and not ex.any()
    assert ex.numel() == blocks * 12 * 4 * 2 * 64
    seen.clear()
    losses = resident.solve_l2(solver, cfg, x0, p, 5, state)
    assert tuple(losses.shape) == (5,)
    (args, kw), = seen
    assert args[:2] == ("resident", f"resident_{solver}_launch")
    assert args[4] == (5, 7, resident.THREADS)
    assert len(args[5]) == 1 + len(state) + (solver == "gd") + 1
    assert tuple(args[5][-1].shape) == (5, 2, 7)
    assert profiling.counters() == {"launch.B9.onchip": 1, "launch.B9.l2": 1}
