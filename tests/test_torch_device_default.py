"""Where the port's entry points compute: a numpy input goes to the CUDA
device and raises where there is none (it never runs on the CPU unasked);
``device="cpu"`` or a CPU tensor asks for the CPU."""

import numpy as np
import pytest
import torch

import pytv4d_tpu_torch as ptt
from pytv4d_tpu_torch import interop, tv_GPU
from pytv4d_tpu_torch.core.schemes import SCHEMES
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.kernels.dispatch import t_plane_multiplier
from pytv4d_tpu_torch.models import TVDenoiser, ct, denoise_tv_chambolle
from pytv4d_tpu_torch.kernels import resident
from pytv4d_tpu_torch.ops import api
from pytv4d_tpu_torch.solvers import admm, chambolle_pock_precond, fista

IMG = np.random.default_rng(0).random((12, 16)).astype(np.float32)
VOL = np.random.default_rng(1).random((2, 2, 6, 8)).astype(np.float32)
DVOL = np.random.default_rng(2).random((2, 3, 2, 6, 8)).astype(np.float32)
MODEL = TVDenoiser(reg=0.3)
# fan- and cone-beam CT: a (Nz, M, N, N) volume, 4 angles, and the cone's
# sinogram
CT_VOL = np.random.default_rng(3).random((2, 2, 8, 8)).astype(np.float32)
ANGLES = np.linspace(0.0, 2 * np.pi, 4, endpoint=False)
FAN, CONE = ct.FanBeamGeometry(16.0, 8.0), ct.ConeBeamGeometry(16.0, 8.0)
CONE_SINO = ct.radon_cone(CT_VOL, ANGLES, CONE, device="cpu").numpy()

# name -> (call taking a numpy input and keywords, its numpy input)
ENTRY_POINTS = {
    "TVDenoiser.cp": (lambda a, **kw: MODEL.cp(a, n_iter=2, **kw).x, IMG),
    "TVDenoiser.gd": (lambda a, **kw: MODEL.gd(a, n_iter=2, **kw).x, IMG),
    "TVDenoiser.tgv": (lambda a, **kw: MODEL.tgv(a, n_iter=2, **kw).x, IMG),
    "denoise_tv_chambolle": (
        lambda a, **kw: denoise_tv_chambolle(a, max_num_iter=2, **kw), IMG),
    "denoise_tv_chambolle-channels": (
        lambda a, **kw: denoise_tv_chambolle(a, max_num_iter=2,
                                             channel_axis=0, **kw), VOL[0]),
    "TVDenoiser.admm": (lambda a, **kw: MODEL.admm(a, n_iter=2, **kw).x, IMG),
    "TVDenoiser.fista": (lambda a, **kw: MODEL.fista(a, n_iter=2, **kw).x,
                         IMG),
    "chambolle_pock_precond": (
        lambda a, **kw: chambolle_pock_precond(a, n_iter=2, reg=0.3, **kw).x,
        VOL),
    "admm": (lambda a, **kw: admm(a, n_iter=2, reg=0.3, **kw).x, VOL),
    "fista": (lambda a, **kw: fista(a, n_iter=2, reg=0.3, **kw).x, VOL),
    "denoise_tv_chambolle-eps": (
        lambda a, **kw: denoise_tv_chambolle(a, max_num_iter=4, eps=1e-3,
                                             **kw), IMG),
    "denoise_tv_chambolle-coupled": (
        lambda a, **kw: denoise_tv_chambolle(
            a, max_num_iter=2, channel_axis=0, coupled_channels=True, **kw),
        VOL[0]),
    "denoise_tv_chambolle-coupled-eps": (
        lambda a, **kw: denoise_tv_chambolle(
            a, max_num_iter=4, channel_axis=0, coupled_channels=True,
            eps=1e-3, **kw), VOL[0]),
    "api.tv_and_subgrad": (lambda a, **kw: api.tv_and_subgrad(a, **kw)[1],
                           VOL),
    "api.tv_hybrid": (lambda a, **kw: api.tv_hybrid(a, **kw)[1], VOL),
    "api.D_hybrid": (lambda a, **kw: api.D_hybrid(a, **kw), VOL),
    "api.D": (lambda a, **kw: api.D(a, "upwind", **kw), VOL),
    # the package root's names are ops.api's
    "root.tv_and_subgrad": (lambda a, **kw: ptt.tv_and_subgrad(a, **kw)[1],
                            VOL),
    "root.D": (lambda a, **kw: ptt.D(a, "central", **kw), VOL),
    "root.D_T": (lambda a, **kw: ptt.D_T(ptt.D(a, "hybrid", **kw), "hybrid",
                                         **kw), VOL),
    "root.compute_L21_norm": (
        lambda a, **kw: ptt.compute_L21_norm(a, **kw), DVOL),
    "ct.radon_fan": (lambda a, **kw: ct.radon_fan(a, ANGLES, FAN, **kw),
                     CT_VOL),
    "ct.radon_cone": (lambda a, **kw: ct.radon_cone(a, ANGLES, CONE, **kw),
                      CT_VOL),
    "ct.fdk": (lambda a, **kw: ct.fdk(a, ANGLES, CONE, CT_VOL.shape, **kw),
               CONE_SINO),
    "ct.sart": (lambda a, **kw: ct.sart(a, ANGLES, CT_VOL.shape, n_iter=1,
                                        n_subsets=2, geom=CONE, **kw).x,
                CONE_SINO),
    **{f"root.tv_{s}": (lambda a, s=s, **kw: getattr(ptt, f"tv_{s}")(
        a, **kw)[1], VOL) for s in SCHEMES},
    **{f"root.D_{s}": (lambda a, s=s, **kw: getattr(ptt, f"D_{s}")(a, **kw),
                       VOL) for s in SCHEMES},
    **{f"root.D_T_{s}": (lambda a, s=s, **kw: getattr(ptt, f"D_T_{s}")(
        getattr(ptt, f"D_{s}")(a, **kw), **kw), VOL) for s in SCHEMES},
}


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a numpy input runs there")


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_numpy_without_device_raises_where_no_cuda(name):
    _needs_no_cuda()
    call, arr = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA device"):
        call(arr)
    with pytest.raises(RuntimeError, match="CUDA device"):
        call(arr.tolist())


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_cpu_and_cpu_tensor_run_and_agree(name):
    call, arr = ENTRY_POINTS[name]
    asked = call(arr, device="cpu")
    if name.startswith("denoise_tv_chambolle"):
        # numpy out by contract; a tensor input is solved on its own device
        assert isinstance(asked, np.ndarray) and asked.shape == arr.shape
        np.testing.assert_array_equal(call(torch.tensor(arr)), asked)
        return
    tensor = call(torch.tensor(arr))
    assert asked.device.type == tensor.device.type == "cpu"
    assert torch.equal(asked, tensor)


def test_on_device_rule():
    from pytv4d_tpu_torch.utils.device import on_device

    t = torch.zeros(3, dtype=torch.float64)
    assert on_device(t) is t and on_device(t, "cpu", torch.float32) is t
    got = on_device(IMG, "cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert on_device(IMG.astype(np.float64), "cpu").dtype == torch.float64
    assert on_device([1.0, 2.0], "cpu", torch.float32).dtype == torch.float32
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA device"):
        on_device(IMG)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tv_GPU.tv_hybrid(VOL)


def test_state_and_multiplier_need_a_device():
    """No ``"cpu"`` default: the device is a required keyword."""
    x = np.zeros((2, 2, 4, 5))
    with pytest.raises(TypeError, match="device"):
        interop.state_from_numpy(x, x, None)
    with pytest.raises(TypeError, match="device"):
        interop.tgv_state_from_numpy(x, x, x, x, x, x)
    with pytest.raises(TypeError, match="device"):
        interop.precond_state_from_numpy(x, x, x, x)
    with pytest.raises(TypeError, match="device"):
        interop.admm_state_from_numpy(x, x, x)
    with pytest.raises(TypeError, match="device"):
        interop.fista_dual_from_numpy(x)
    with pytest.raises(TypeError, match="device"):
        t_plane_multiplier((2, 2, 4, 5), TVConfig(reg_time=0.5), None,
                           np.ones((1, 1, 4, 5)))
    st = interop.state_from_numpy(x, x, None, device="cpu")
    assert st.x.device.type == "cpu" and st.y_D is None
    tm = t_plane_multiplier((2, 2, 4, 5), TVConfig(reg_time=0.5), None,
                            np.ones((1, 1, 4, 5)), device="cpu")
    assert tm.device.type == "cpu" and tuple(tm.shape) == (4, 5)


@pytest.mark.parametrize("which", ("cp", "gd"))
def test_resident_solvers_follow_the_rule(which):
    """The whole-solve factories take no ``device``: a CPU tensor runs the
    plain loop on the CPU, a numpy array goes to the card or raises."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    shape = VOL.shape
    if which == "cp":
        solve = resident.make_resident_cp_solver(cfg, shape, 2, reg=0.3)
        Nd = 8
        args = (VOL, VOL, np.zeros_like(VOL),
                np.zeros((shape[0], Nd, shape[1]) + shape[2:], np.float32))
    else:
        solve = resident.make_resident_gd_solver(cfg, shape, 2, reg=0.3)
        args = (VOL, VOL)
    out = solve(*(torch.tensor(a) for a in args))
    assert all(t.device.type == "cpu" for t in out)
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA device"):
        solve(*args)
