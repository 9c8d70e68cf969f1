"""The port's parallel runtime pieces against the JAX package's, on the CPU.

* ``parallel.mesh.create_mesh``: rank r at (r // num_model, r % num_model),
  as JAX's ``create_mesh`` places device r; the data and model groups are
  the grid's columns and rows; a cuda group is nccl or raises, never gloo.
* ``parallel.sequence_sharding.shard_token_batch``: each rank's part of a
  global batch equals the shard JAX's ``shard_token_batch`` places on the
  device at that position of its mesh.
* ``parallel.zero``: the moments it shards are the leaves JAX's
  ``opt_state_specs`` shards (leading dimension divisible).
* ``train.tasks.micro_segments``: a rank's rows cut where the global
  micro-batches cut them.
* ``parallel.mesh.create_pipe_mesh``: the JAX CLI's ('data', 'pipe') layout.
* ``parallel.dryrun.dryrun_multichip(4)``: exits cleanly on four gloo
  processes (the counterpart of ``__graft_entry__.dryrun_multichip``),
  with its dp x tp and dp x pp variants.
* the preemption rule in one process: the local flag, at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.parallel import create_mesh as jax_create_mesh
from mmt_tpu.parallel.sequence_sharding import shard_token_batch as jax_shard_token_batch
from mmt_tpu.parallel.zero import opt_state_specs
from mmt_tpu_torch.parallel import mesh as pm
from mmt_tpu_torch.parallel import zero
from mmt_tpu_torch.parallel.sequence_sharding import shard_token_batch
from mmt_tpu_torch.train.tasks import micro_segments


def _fake_mesh(rank, num_data, num_model):
    return pm.Mesh(num_data, num_model, rank)


@pytest.mark.parametrize("layout", [(8, 1), (4, 2), (2, 4)])
def test_rank_layout_is_jax_device_layout(layout):
    num_data, num_model = layout
    devices = jax_create_mesh(num_data=num_data, num_model=num_model).devices
    for i in range(num_data):
        for j in range(num_model):
            rank = int(devices[i, j].id)
            mesh = _fake_mesh(rank, num_data, num_model)
            assert (mesh.data_rank, mesh.model_rank) == (i, j)


@pytest.mark.parametrize("layout", [(4, 2), (2, 4), (1, 8)])
def test_pipe_mesh_layout_is_the_jax_cli_layout(layout):
    """``create_pipe_mesh``: rank r at (r // num_pipe, r % num_pipe), as the
    JAX CLI reshapes its devices into ('data', 'pipe')
    (``mmt_tpu/cli/train.py:174-185``)."""
    num_data, num_pipe = layout
    devices = np.asarray(jax.devices()[:num_data * num_pipe]).reshape(num_data, num_pipe)
    for i in range(num_data):
        for j in range(num_pipe):
            rank = int(devices[i, j].id)
            mesh = pm.Mesh(num_data, 1, rank, num_pipe=num_pipe, axis_names=("data", "pipe"))
            assert (mesh.data_rank, mesh.pipe_rank, mesh.model_rank) == (i, j, 0)
    one = pm.create_pipe_mesh()
    assert (one.axis_names, one.num_pipe, one.distributed) == (("data", "pipe"), 1, False)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.create_pipe_mesh(1, 2)


@pytest.mark.parametrize("layout", [(4, 2), (2, 4)])
def test_token_batch_shards_are_jax_placement(layout):
    num_data, num_model = layout
    rng = np.random.default_rng(0)
    batch = {"word_ids": rng.integers(0, 9, (8, 16)).astype(np.int32),
             "segment_ids": rng.integers(0, 3, (8, 16)).astype(np.int32),
             "lengths": rng.integers(1, 16, (8,)).astype(np.int32),
             "patch_embeddings": rng.normal(size=(8, 4, 3)).astype(np.float32)}
    jmesh = jax_create_mesh(num_data=num_data, num_model=num_model)
    placed = jax_shard_token_batch(jmesh, {k: jnp.asarray(v) for k, v in batch.items()})
    for key, array in placed.items():
        for shard in array.addressable_shards:
            rank = int(shard.device.id)
            got = shard_token_batch(_fake_mesh(rank, num_data, num_model), batch)[key]
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=f"{key} {rank}")


def test_zero_shards_the_leaves_jax_shards():
    jmesh = jax_create_mesh(num_data=8, num_model=1)
    shapes = {"w": (16, 4), "b": (3,), "e": (24,), "s": ()}
    specs = opt_state_specs(jmesh, {k: jnp.zeros(s) for k, s in shapes.items()})
    for name, shape in shapes.items():
        assert zero.sharded(shape, 8) == (specs[name] != jax.sharding.PartitionSpec()), name


def test_micro_segments_cut_where_the_global_micro_batches_cut():
    # global 16 = 4 ranks x 4 rows, micro-batches of 8 (2) and of 2 (8).
    assert list(micro_segments(4, 1, 4, 2)) == [(0, 0, 4, 4)]
    assert list(micro_segments(4, 2, 4, 2)) == [(1, 0, 4, 0)]
    assert list(micro_segments(4, 3, 4, 8)) == [(6, 0, 2, 0), (7, 2, 4, 0)]
    # global 12 = 2 ranks x 6 rows in 3 micro-batches of 4: rank 1 holds 4..11
    assert list(micro_segments(6, 1, 2, 3)) == [(1, 0, 2, 2), (2, 2, 6, 0)]
    rows = [r for rank in range(4) for m, lo, hi, _ in micro_segments(4, rank, 4, 8)
            for r in range(rank * 4 + lo, rank * 4 + hi)]
    assert rows == list(range(16))


def test_one_process_mesh_and_refusals(monkeypatch):
    mesh = pm.create_mesh()
    assert (mesh.num_data, mesh.num_model, mesh.distributed, mesh.is_chief) == (1, 1, False, True)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.create_mesh(2, 1)
    assert pm.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pm.backend_for("cuda")
    for key in pm.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        pm.init_distributed("cpu")
    batch = {"x": np.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(pm.data_slice(pm.Mesh(3, 1, 2), batch)["x"], batch["x"][4:])


def test_preemption_flag_in_one_process():
    from mmt_tpu_torch.train.preemption import PreemptionWatcher

    watcher = PreemptionWatcher()
    assert not watcher.should_save(True)
    watcher.trigger()
    assert watcher.should_save(False) and watcher.should_save(True)


def test_dryrun_multichip_four_processes(capsys):
    from mmt_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dp mesh 4x1 ok" in out and "dp x model mesh 2x2 ok" in out
    assert "dp x tp mesh 2x2 ok" in out and "dp x pp mesh 1x4 pipelined train ok" in out
    assert "ring sequence-sharded attention ok" in out
