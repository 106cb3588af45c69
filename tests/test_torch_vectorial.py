"""The port's ``denoise_tv_chambolle`` with ``eps``, ``channel_axis`` and
``coupled_channels`` (vectorial TV) against the JAX package's, in float64 on
the CPU: the same seeded image through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.denoise as jden
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import denoise

# float64, the same operations in the same order on both sides
RTOL, ATOL = 1e-9, 1e-12
RNG = np.random.default_rng(0)
IMG2 = RNG.random((14, 18))
IMG3 = RNG.random((3, 14, 18))
RGB = RNG.random((14, 18, 3))
STACK_RGB = RNG.random((3, 14, 18, 2))  # (Nz, H, W, C)

CASES = {
    "2d": (IMG2, {}),
    "2d-eps": (IMG2, dict(eps=2e-4)),
    "3d-eps-upwind": (IMG3, dict(eps=1e-3, scheme="upwind")),
    "rgb-independent": (RGB, dict(channel_axis=-1)),
    "rgb-independent-eps": (RGB, dict(channel_axis=-1, eps=5e-4)),
    "rgb-coupled": (RGB, dict(channel_axis=-1, coupled_channels=True)),
    "rgb-coupled-eps": (RGB, dict(channel_axis=-1, coupled_channels=True,
                                  eps=5e-4)),
    "rgb-coupled-first-axis": (np.moveaxis(RGB, -1, 0).copy(),
                               dict(channel_axis=0, coupled_channels=True,
                                    scheme="central")),
    "stack-independent": (STACK_RGB, dict(channel_axis=3)),
    "stack-coupled": (STACK_RGB, dict(channel_axis=3, coupled_channels=True)),
    "stack-coupled-eps": (STACK_RGB, dict(channel_axis=3,
                                          coupled_channels=True, eps=1e-3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_denoise_tv_chambolle_matches_jax(case):
    img, kw = CASES[case]
    want = jden.denoise_tv_chambolle(img, weight=0.15, max_num_iter=60, **kw)
    got = denoise.denoise_tv_chambolle(img, weight=0.15, max_num_iter=60,
                                       device="cpu", **kw)
    assert isinstance(got, np.ndarray) and got.shape == img.shape
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a tensor input is solved on its own device, to the same numbers
    np.testing.assert_array_equal(
        denoise.denoise_tv_chambolle(torch.tensor(img), weight=0.15,
                                     max_num_iter=60, **kw), got)


def test_eps_stops_early_and_changes_the_answer():
    full = denoise.denoise_tv_chambolle(IMG2, weight=0.15, max_num_iter=200,
                                        device="cpu")
    early = denoise.denoise_tv_chambolle(IMG2, weight=0.15, max_num_iter=200,
                                         eps=1e-2, device="cpu")
    assert np.abs(full - early).max() > 1e-6
    tight = denoise.denoise_tv_chambolle(IMG2, weight=0.15, max_num_iter=200,
                                         eps=0.0, device="cpu")
    np.testing.assert_allclose(tight, full, rtol=1e-12)


def test_coupled_differs_from_independent_and_aligns_edges():
    ind = denoise.denoise_tv_chambolle(RGB, weight=0.3, max_num_iter=80,
                                       channel_axis=-1, device="cpu")
    cpl = denoise.denoise_tv_chambolle(RGB, weight=0.3, max_num_iter=80,
                                       channel_axis=-1, coupled_channels=True,
                                       device="cpu")
    assert np.abs(ind - cpl).max() > 1e-3


@pytest.mark.parametrize("compute_loss", (False, True))
def test_cp_vectorial_run_matches_jax(compute_loss):
    stack = np.moveaxis(RGB, -1, 0)[:, None, None]  # (C, 1, 1, H, W)
    jcarry, jloss = jden._cp_vectorial_run(jnp.asarray(stack), None, 0.2, 7,
                                           JConfig(), compute_loss)
    carry, loss = denoise._cp_vectorial_run(torch.tensor(stack), None, 0.2,
                                            7, TVConfig(), compute_loss)
    for g, w in zip(carry, jcarry):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=RTOL)
    # the carry continues the run exactly
    a, la = denoise._cp_vectorial_run(torch.tensor(stack), None, 0.2, 3,
                                      TVConfig(), compute_loss)
    b, lb = denoise._cp_vectorial_run(torch.tensor(stack), a, 0.2, 4,
                                      TVConfig(), compute_loss)
    assert torch.equal(b[0], carry[0])
    assert torch.equal(torch.cat([la, lb]), loss)


def test_errors_speak_as_jax():
    for img, kw in ((IMG2, dict(coupled_channels=True)),
                    (IMG2, dict(channel_axis=0)),
                    (RNG.random((2, 3, 4, 5, 6)), dict(channel_axis=0)),
                    (IMG2, dict(channel_axis=0, coupled_channels=True)),
                    (RNG.random((2, 3, 4, 5, 6)),
                     dict(channel_axis=0, coupled_channels=True))):
        with pytest.raises(ValueError) as want:
            jden.denoise_tv_chambolle(img, max_num_iter=1, **kw)
        with pytest.raises(ValueError) as got:
            denoise.denoise_tv_chambolle(img, max_num_iter=1, device="cpu",
                                         **kw)
        assert str(got.value) == str(want.value)


def test_no_not_implemented_left():
    import inspect

    assert "NotImplementedError" not in inspect.getsource(denoise)
