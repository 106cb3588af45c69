"""The whole-solve TGV kernel's dispatch between its on-chip and its L2
kernel, the band split of the on-chip kernel, the launch shapes against the
compiled list in ``csrc/tgv_onchip.cu``, and the plain version (what the
wrapper runs on the CPU) against the interpreted Pallas kernel at a slice
whose rows do not divide into 16 bands."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.kernels.tgv_resident as jres
from pytv4d_tpu_torch.kernels import build, tgv_resident
from pytv4d_tpu_torch.utils import profiling

DELTA = 0.3

# (shape, compute_loss) -> the variant and, on chip, (C, R)
CASES = {
    "cameraman": ((1, 1, 256, 256), True, "onchip", (16, 16)),
    "cameraman-noloss": ((1, 1, 256, 256), False, "onchip", (16, 16)),
    "main4d": ((32, 8, 256, 256), True, "onchip", (16, 16)),
    "main4d-noloss": ((32, 8, 256, 256), False, "onchip", (16, 16)),
    "288-edge": ((1, 1, 288, 288), True, "onchip", (16, 18)),
    "290": ((1, 1, 290, 290), True, "l2", None),
    "290-noloss": ((1, 1, 290, 290), False, "onchip", (16, 19)),
    "336-edge-noloss": ((1, 1, 336, 336), False, "onchip", (16, 21)),
    "340": ((1, 1, 340, 340), True, "l2", None),
    "340-noloss": ((1, 1, 340, 340), False, "l2", None),
    "512": ((1, 1, 512, 512), True, "l2", None),
    "1024": ((1, 1, 1024, 1024), True, "l2", None),
    "300x300x8x8": ((300, 300, 8, 8), True, "onchip", (1, 8)),
    "37x33": ((1, 1, 37, 33), True, "onchip", (1, 37)),
    "97x151": ((3, 1, 97, 151), True, "onchip", (4, 25)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_variant_and_budget(name):
    """The variant by shape, and the cluster the smallest whose blocks hold
    the slice at 44 bytes a pixel with the loss and 32 without."""
    shape, loss, variant, band = CASES[name]
    assert tgv_resident.tgv_resident_variant(shape, loss) == variant
    assert tgv_resident.onchip_band(shape, loss) == band
    per_pixel = 44 if loss else 32
    Nr, Nc = shape[2:]
    fits = [C for C in tgv_resident.ONCHIP_CLUSTERS
            if -(-Nr // C) * Nc * per_pixel <= tgv_resident.ONCHIP_SMEM_BYTES]
    assert (min(fits), -(-Nr // min(fits))) == band if fits else band is None
    if band is None:
        with pytest.raises(ValueError, match="does not fit"):
            tgv_resident.onchip_launch_shape(shape, loss)
        return
    C, R, threads, ppt, smem = tgv_resident.onchip_launch_shape(shape, loss)
    assert (C, R) == band
    assert smem == R * Nc * per_pixel <= tgv_resident.ONCHIP_SMEM_BYTES
    # every pixel of a band has a thread slot: the fewest pixels a thread
    # of the compiled shapes that cover the band
    assert ppt == min(k for k in tgv_resident.ONCHIP_PPT[threads]
                      if k * threads >= R * Nc)
    assert threads == tgv_resident.ONCHIP_THREADS == 1024


def test_budget_is_the_cards_shared_memory():
    """The H100's 227 KB a block, less the loss's warp sums; about 290^2
    with the loss and 340^2 without at 16 blocks."""
    assert tgv_resident.ONCHIP_SMEM_BYTES + 256 == 227 * 1024
    assert tgv_resident.ONCHIP_PLANES == {True: 11, False: 8}
    for loss, edge in ((True, 288), (False, 336)):
        assert tgv_resident.tgv_resident_variant((1, 1, edge, edge),
                                                 loss) == "onchip"
        assert tgv_resident.tgv_resident_variant((1, 1, edge + 1, edge + 1),
                                                 loss) == "l2"


@pytest.mark.parametrize("Nr,C", [(256, 16), (37, 1), (97, 4), (250, 16),
                                  (8, 16), (17, 16), (288, 16), (1, 2),
                                  (33, 8), (1024, 16)])
def test_band_split_covers_every_row_once(Nr, C):
    """A Python mirror of the kernel's band split: block b owns rows
    [b R, min((b + 1) R, Nr)); together the at most C blocks cover each row
    exactly once, every band but the last non-empty one holds R rows (the
    DSMEM reads of the row above a band assume it), and a block past the
    slice's end owns none."""
    R = -(-Nr // C)
    bands = tgv_resident.band_rows(Nr, C, R)
    assert len(bands) == C
    rows = [r for start, stop in bands for r in range(start, stop)]
    assert rows == list(range(Nr))
    filled = [stop - start for start, stop in bands if stop > start]
    assert all(n == R for n in filled[:-1]) and 0 < filled[-1] <= R
    assert all(stop == start for start, stop in bands[len(filled):])


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def test_launch_shapes_mirror_the_source():
    """``ONCHIP_PPT`` and ``ONCHIP_PLANES`` are what ``csrc/tgv_onchip.cu``
    compiles and sizes its shared memory by."""
    text = _source("tgv_onchip.cu")
    cases = re.findall(r"^\s*ONCHIP_CASE\((\d+), (\d+)\)", text, re.M)
    compiled = {}
    for threads, ppt in cases:
        compiled.setdefault(int(threads), []).append(int(ppt))
    assert compiled == {t: list(k) for t, k in
                        tgv_resident.ONCHIP_PPT.items()}
    planes = re.search(r"return loss \? (\d+) : (\d+);", text).groups()
    assert tuple(map(int, planes)) == (tgv_resident.ONCHIP_PLANES[True],
                                       tgv_resident.ONCHIP_PLANES[False])
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in text
    # the cluster barrier orders the shared-memory writes: no fence
    assert "__threadfence()" not in re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("loss", [True, False])
def test_launch_shape_overrides(loss):
    """The probe's overrides: 8 blocks where a slice fits them, 512 or 1024
    threads; a cluster too small for the slice raises."""
    shape = (1, 1, 256, 160)
    assert tgv_resident.onchip_launch_shape(shape, loss, 8, 1024)[:4] == \
        (8, 32, 1024, 8)
    assert tgv_resident.onchip_launch_shape(shape, loss, 16, 512)[:4] == \
        (16, 16, 512, 8)
    with pytest.raises(ValueError, match="does not fit"):
        tgv_resident.onchip_launch_shape((1, 1, 256, 256), loss, 8)
    with pytest.raises(ValueError, match="does not fit"):
        tgv_resident.onchip_launch_shape(shape, loss, 16, 256)


@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_plain_matches_pallas_at_ragged_bands(norm):
    """``tgv_resident_plain`` against the interpreted whole-solve Pallas
    kernel at (1, 3, 19, 33): 19 rows, not a multiple of 16 (in 16 bands
    of 2 rows the last holds 1 and six blocks none), odd columns, 20
    iterations: the state and the losses; the wrapper on a CPU tensor is
    the plain version."""
    shape = (1, 3, 19, 33)
    x0 = np.random.default_rng(11).random(shape)
    solve = jres.make_resident_tgv_solver(
        shape, 20, 2.0, 4.0, dtype_name="float64", interpret=True, norm=norm,
        huber_delta=DELTA)
    ref = solve(jnp.asarray(x0))
    got = tgv_resident.tgv_resident_plain(torch.tensor(x0), 20, 2.0, 4.0,
                                          norm=norm, huber_delta=DELTA)
    for name, a, b in zip("x w xb wb p q".split(), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(ref[6]), rtol=1e-10)
    out = tgv_resident.tgv_resident_solve(torch.tensor(x0), 20, 2.0, 4.0,
                                          norm=norm, huber_delta=DELTA)
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    assert tgv_resident.tgv_resident_variant(shape) == "onchip"
    assert tgv_resident.onchip_band(shape) == (1, 19)
    assert [b for b in tgv_resident.band_rows(19, 16, 2) if b[1] > b[0]][-1] \
        == (18, 19)


def test_cpu_tensor_launches_nothing():
    """Each kernel has its own launch counter beside the solve's; a CPU
    tensor runs the plain version and counts nothing."""
    keys = ("launch.B7", "launch.B7.onchip", "launch.B7.l2")
    counts = tuple(profiling.counters()[k] for k in keys)
    tgv_resident.tgv_resident_solve(torch.rand(1, 1, 6, 7), 2, 1.0, 2.0)
    assert counts == tuple(profiling.counters()[k] for k in keys)
