"""The port's (z, t) mesh of shards: cutting a volume and putting it back,
the divisibility error of the JAX package, and the exchange's zeros at the
grid's ends (what ``lax.ppermute`` delivers there)."""

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.parallel import (
    T_AXIS,
    Z_AXIS,
    gather_d_volume,
    gather_volume,
    make_mesh,
    plane_from_left,
    plane_from_right,
    shard_d_volume,
    shard_volume,
)
from pytv4d_tpu_torch.parallel.mesh import check_divisible

SHAPE = (8, 4, 6, 10)


@pytest.mark.parametrize("zt", [(4, 2), (8, 1), (2, 4), (1, 1)])
@pytest.mark.parametrize("shard_time", [True, False])
def test_shard_and_gather_round_trip(zt, shard_time):
    rng = np.random.default_rng(0)
    mesh = make_mesh(*zt, device="cpu")
    assert mesh.shape == {Z_AXIS: zt[0], T_AXIS: zt[1]}
    nt = zt[1] if shard_time else 1
    x = rng.random(SHAPE)
    shards = shard_volume(x, mesh, shard_time)
    assert (len(shards), len(shards[0])) == (zt[0], nt)
    for iz, row in enumerate(shards):
        for it, s in enumerate(row):
            assert s.is_contiguous() and s.device.type == "cpu"
            assert s.dtype == torch.float64
            nz_l, m_l = SHAPE[0] // zt[0], SHAPE[1] // nt
            np.testing.assert_array_equal(
                s.numpy(), x[iz * nz_l:(iz + 1) * nz_l,
                             it * m_l:(it + 1) * m_l])
    np.testing.assert_array_equal(gather_volume(shards).numpy(), x)

    y = torch.tensor(rng.random((8, 5, 4, 6, 10)), dtype=torch.float32)
    d_shards = shard_d_volume(y, mesh, shard_time)
    assert d_shards[0][0].shape == (8 // zt[0], 5, 4 // nt, 6, 10)
    assert torch.equal(gather_d_volume(d_shards), y)
    # the kernels' internal (Nz, M, Nd, Nr, Nc) layout shards like a volume
    y_int = y.transpose(1, 2).contiguous()
    assert torch.equal(gather_volume(shard_volume(y_int, mesh, shard_time)),
                       y_int)


def test_not_divisible_raises_the_jax_text():
    mesh = make_mesh(3, 2, device="cpu")
    with pytest.raises(ValueError) as err:
        shard_volume(np.zeros(SHAPE), mesh)
    assert str(err.value) == (f"global shape {SHAPE[:2]} not divisible by "
                              f"mesh (z=3, t=2)")
    with pytest.raises(ValueError, match=r"not divisible by mesh \(z=4, t=3\)"):
        check_divisible(SHAPE, 4, 3)
    check_divisible(SHAPE, 4, 2)


def test_make_mesh_checks_and_device_rule():
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(0, 1, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(2, 0, device="cpu")
    assert make_mesh(2, device="cpu").shape == {"z": 2, "t": 1}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the mesh lives there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh(2, 2)


@pytest.mark.parametrize("axis", [0, 1])
def test_exchange_gives_the_neighbours_plane_or_zeros(axis):
    x = np.random.default_rng(1).random(SHAPE) + 1.0
    shards = shard_volume(x, make_mesh(4, 2, device="cpu"))
    n = (4, 2)[axis]
    for iz in range(4):
        for it in range(2):
            idx = (iz, it)[axis]
            own = shards[iz][it]
            left = plane_from_left(shards, axis, iz, it)
            right = plane_from_right(shards, axis, iz, it)
            want = list(own.shape)
            want[axis] = 1
            assert list(left.shape) == list(right.shape) == want
            lo = (iz - (axis == 0), it - (axis == 1))
            hi = (iz + (axis == 0), it + (axis == 1))
            if idx == 0:
                assert not left.any()
            else:
                nb = shards[lo[0]][lo[1]]
                assert torch.equal(left, nb.narrow(axis, nb.shape[axis] - 1, 1))
            if idx == n - 1:
                assert not right.any()
            else:
                assert torch.equal(right, shards[hi[0]][hi[1]].narrow(axis, 0, 1))
