"""The port's CP and TGV byte models equal the JAX package's minimal models,
and its device timer refuses a CPU device."""

import jax.numpy as jnp
import pytest
import torch

import pytv4d_tpu.utils.profiling as jprof
import pytv4d_tpu_torch.utils.profiling as tprof


@pytest.mark.parametrize("dtype,dual_dtype", [
    (torch.float32, None), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, None)])
@pytest.mark.parametrize("shape,Nd", [((32, 8, 256, 256), 6),
                                      ((1, 1, 256, 256), 2),
                                      ((96, 16, 512, 512), 8)])
def test_cp_traffic_model_equals_jax_minimal(shape, Nd, dtype, dual_dtype):
    jnp_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = jprof.cp_traffic_model(
        shape, Nd, dtype=jnp_dtype[dtype], model="minimal",
        dual_dtype=None if dual_dtype is None else jnp_dtype[dual_dtype])
    assert tprof.cp_traffic_model(shape, Nd, dtype=dtype,
                                  dual_dtype=dual_dtype) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,planes", [("2d", 28), ("3d", 44), ("4d", 63)])
@pytest.mark.parametrize("shape", [(32, 8, 256, 256), (1, 1, 256, 256),
                                   (96, 16, 512, 512)])
def test_tgv_traffic_model_equals_jax_minimal(shape, mode, planes, dtype):
    jnp_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    pass_pq, pass_xw = tprof.tgv_traffic_model(shape, mode, dtype)
    want = jprof.tgv_traffic_model(shape, mode, jnp_dtype[dtype],
                                   model="minimal")
    assert pass_pq + pass_xw == want
    voxel_bytes = shape[0] * shape[1] * shape[2] * shape[3] * dtype.itemsize
    assert want == planes * voxel_bytes


def test_roofline_fraction_and_timer_device():
    # 3.35 TB/s peak: 3.35 GB per iteration at 1000 it/s is the roofline
    assert tprof.roofline_fraction(3_350_000_000, 1000.0) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tprof.time_iterations(lambda n: None, 10, "cpu")
