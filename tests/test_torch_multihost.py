"""The port's ``parallel.multihost`` on ``torch.distributed``: the cluster
rule and the bootstrap that refuses to run on as one process (twins of
``tests/test_utils.py``'s multihost tests), and a real two-process run on
the CPU (gloo) of the sharded CP solvers and the sharded TGV stream solver,
bit for bit across the ranks and against the one-process sharded solve, and
within 1e-5 of the JAX package's ``chambolle_pock``
(``tests/test_multihost.py``)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.parallel import (
    Mesh,
    d_volume_spec,
    gather_volume,
    make_mesh,
    make_sharded_cp_solver,
    make_sharded_cp_solver_fused,
    make_sharded_tgv_stream_solver,
    multihost,
    shard_d_volume,
    shard_volume,
)
from pytv4d_tpu_torch.kernels.fused import to_internal_layout
from pytv4d_tpu_torch.solvers.cp import init_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 2, 16, 16)
CFG = dict(scheme="hybrid", reg_time=0.5)
CLUSTER_VARS = ("TORCHELASTIC_RUN_ID", "WORLD_SIZE", "MASTER_ADDR", "RANK",
                "MASTER_PORT")

# Each worker joins a gloo group of two, holds half the z-rows and runs:
# the plain sharded CP on 8 z-shards (4 per process: exchanges inside a
# process and across), the fused CP's ghost path on the same mesh and its
# overlapped path on 2 z-shards, and the 4d TGV stream solver on 4 z-shards.
WORKER = textwrap.dedent("""
    import sys
    root, pid, nproc, port, out = sys.argv[1:6]
    sys.path.insert(0, root)
    import numpy as np, torch
    from pytv4d_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address="127.0.0.1:" + port,
                         num_processes=int(nproc), process_id=int(pid),
                         device="cpu")
    from tests.test_torch_multihost import run_all
    np.savez(out, **run_all(multihost, int(pid)))
""")


def _inputs():
    noisy = (np.random.default_rng(0).random(SHAPE) + 3.0).astype(np.float32)
    st = init_state(torch.tensor(noisy), TVConfig(**CFG))
    return noisy, st


def run_all(mh, pid=None):
    """The four sharded solves, on ``mh.global_mesh`` when ``mh`` is the
    multihost module of a process of two (``pid`` its rank), else on one
    process's mesh (``mh`` None): a dict of numpy arrays, each the block of
    z-rows the process holds (all of them alone)."""
    noisy, st = _inputs()
    cfg = TVConfig(**CFG)
    out = {}

    def mesh_of(z):
        return (mh.global_mesh(z=z) if mh is not None
                else make_mesh(z, 1, device="cpu"))

    def place(mesh, a, spec=None):
        if mh is None:
            return (shard_volume(a, mesh, False) if spec is None
                    else shard_d_volume(a, mesh, False))
        k = a.shape[0] // 2
        return mh.host_local_to_global(mesh, a[pid * k:(pid + 1) * k], spec)

    def take(mesh, grid):
        return (gather_volume(grid) if mh is None
                else mh.global_to_host_local(mesh, grid)).numpy()

    mesh = mesh_of(8)
    solve = make_sharded_cp_solver(mesh, cfg, SHAPE, reg=0.4, n_iter=10,
                                   shard_time=False)
    x, _, _, losses = solve(place(mesh, noisy), place(mesh, st.x),
                            place(mesh, st.y_A),
                            place(mesh, st.y_D, d_volume_spec(False)))
    out["cp_x"], out["cp_loss"] = take(mesh, x), losses.numpy()

    y_int = to_internal_layout(st.y_D)
    for name, z in (("ghost", 8), ("overlap", 2)):
        mesh = mesh_of(z)
        solve = make_sharded_cp_solver_fused(mesh, cfg, SHAPE, reg=0.4,
                                             n_iter=10, shard_time=False)
        assert solve.overlap is (name == "overlap")
        x, _, _, losses = solve(place(mesh, noisy), place(mesh, st.x),
                                place(mesh, st.y_A), place(mesh, y_int))
        out[f"fused_{name}_x"] = take(mesh, x)
        out[f"fused_{name}_loss"] = losses.numpy()

    mesh = mesh_of(4)
    solve = make_sharded_tgv_stream_solver(mesh, SHAPE, "4d", alpha1=0.5,
                                           alpha0=1.0, n_iter=8)
    out["tgv_x"] = take(mesh, solve(place(mesh, noisy)).x)
    return out


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_process_sharded_solves(tmp_path):
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig as JConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock as j_chambolle_pock

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS}
    procs = [subprocess.Popen(
        [sys.executable, str(script), ROOT, str(pid), "2", port,
         str(tmp_path / f"rank{pid}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for pid in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [dict(np.load(tmp_path / f"rank{pid}.npz")) for pid in range(2)]
    alone = run_all(None)
    for key, want in alone.items():
        if key.endswith("_loss"):
            # every rank holds the whole history, summed in one order
            for got in ranks:
                np.testing.assert_array_equal(got[key], want, key)
        else:
            np.testing.assert_array_equal(
                np.concatenate([r[key] for r in ranks]), want, key)

    noisy, _ = _inputs()
    ref = j_chambolle_pock(jnp.asarray(noisy), n_iter=10, reg=0.4,
                           cfg=JConfig(**CFG), fused=False)
    np.testing.assert_allclose(ranks[0]["cp_loss"], np.asarray(ref.loss),
                               rtol=1e-5)


def test_cluster_configured_by_torch_variables(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not multihost.cluster_configured()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not multihost.cluster_configured()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert not multihost.cluster_configured()  # no RANK yet
    monkeypatch.setenv("RANK", "0")
    assert multihost.cluster_configured()
    monkeypatch.delenv("MASTER_ADDR")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multihost.cluster_configured()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("TORCHELASTIC_RUN_ID", "job")
    assert multihost.cluster_configured()


def test_multihost_initialize_single_process(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setattr(multihost, "_device", None)
    multihost.initialize(device="cpu")  # must no-op cleanly alone
    assert multihost._initialized
    assert not dist.is_initialized()
    multihost.initialize(device="cpu")  # safe to call twice
    mesh = multihost.global_mesh(z=4, t=2)
    assert (mesh.process_index, mesh.process_count) == (0, 1)
    assert mesh.device == torch.device("cpu")
    assert mesh.shape == {"z": 4, "t": 2}
    assert multihost.global_mesh().shape["z"] == 1  # one row per process
    x = np.random.default_rng(3).random(SHAPE)
    grid = multihost.host_local_to_global(mesh, x)
    assert len(grid) == 4 and len(grid[0]) == 2
    np.testing.assert_array_equal(gather_volume(grid).numpy(), x)
    np.testing.assert_array_equal(
        multihost.global_to_host_local(mesh, grid).numpy(), x)


def test_multihost_initialize_raises_on_misconfigured_cluster(monkeypatch):
    """A declared cluster whose bootstrap fails must raise, never silently
    degrade to one process (wrong-mesh results downstream)."""
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setattr(multihost, "_device", None)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "badhost")

    def boom(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="refusing to silently degrade"):
        multihost.initialize(device="cpu")
    assert not multihost._initialized
    with pytest.raises(RuntimeError, match="refusing to silently degrade"):
        multihost.initialize("badhost:1234", num_processes=2, process_id=0,
                             device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("badhost:1234", device="cpu")
    if torch.cuda.is_available():
        return
    # the backend follows the device rule: no CUDA device is no NCCL, and
    # nothing falls back to gloo unasked
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize()
    assert not multihost._initialized


def test_mesh_splits_rows_evenly_among_processes():
    assert list(make_mesh(4, 1, device="cpu").local_rows()) == [0, 1, 2, 3]
    assert list(Mesh(4, 1, "cpu", process_index=1,
                     process_count=2).local_rows()) == [2, 3]
    with pytest.raises(ValueError, match="split"):
        Mesh(3, 1, "cpu", process_index=0, process_count=2)
