"""The port's device mesh and placement rules (`parallel/mesh.py`), the
counterpart of the JAX package's `test_make_mesh_shapes` and
`test_param_sharding_rule` (tests/test_parallel_training.py), and its
placements held against JAX `param_shardings` on a real HRNet tree.
"""

import pytest
import torch

from human_body_proportion_estimation_tpu_torch.parallel import mesh as M


def test_make_mesh_shapes():
    mesh = M.make_mesh(8, model_parallel=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.axis_names == ("data", "model")
    assert M.make_mesh(devices=["cpu"] * 8).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError):
        M.make_mesh(6, model_parallel=4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="2 devices asked for"):
        M.make_mesh(2, devices=["cpu"])
    # the default is every CUDA device; tests/conftest.py hides them all
    with pytest.raises(ValueError, match="0 CUDA devices available"):
        M.make_mesh(2)


def test_param_sharding_rule():
    mesh = M.make_mesh(8, model_parallel=2, devices=["cpu"] * 8)
    state = {
        "big.weight": torch.zeros(128, 32, 3, 3),     # HWIO (3,3,32,128)
        "small.weight": torch.zeros(32, 3, 3, 3),     # HWIO (3,3,3,32)
        "bn.weight": torch.zeros(128),
        "bn.running_mean": torch.zeros(128),
        "bn.num_batches_tracked": torch.zeros((), dtype=torch.long),
        "deconv.weight": torch.zeros(32, 128, 4, 4),  # (in, out, kh, kw)
    }
    got = M.param_shardings(state, mesh)
    assert got == {"big.weight": 0, "small.weight": None, "bn.weight": 0,
                   "bn.running_mean": 0, "bn.num_batches_tracked": None,
                   "deconv.weight": 1}
    assert all(v is None for v in M.param_shardings(
        state, M.make_mesh(devices=["cpu"] * 4)).values())
    local = M.shard_tree(state, got, mesh, 1)
    assert local["big.weight"].shape == (64, 32, 3, 3)
    assert local["deconv.weight"].shape == (32, 64, 4, 4)
    assert local["small.weight"].shape == (32, 3, 3, 3)


def test_param_shardings_match_jax_on_a_real_hrnet_tree():
    """The port's placement of every state_dict key of the full-width
    HRNet-W32 is JAX `param_shardings`' on the flax tree of the same
    model: sharded on the same leaves, along the dim that is the flax
    leaf's last."""
    import jax

    from human_body_proportion_estimation_tpu.models.hrnet import (
        create_hrnet,
    )
    from human_body_proportion_estimation_tpu.parallel import mesh as JM
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        create_hrnet as tcreate,
    )

    jmesh = JM.make_mesh(8, model_parallel=2)
    variables = jax.eval_shape(create_hrnet("hrnet_w32").init,
                               jax.random.PRNGKey(0),
                               jax.numpy.zeros((1, 64, 64, 3)))
    jspecs = {
        ".".join(p.key for p in path): s.spec
        for col in ("params", "batch_stats")
        for path, s in jax.tree_util.tree_flatten_with_path(
            JM.param_shardings(variables[col], jmesh))[0]}
    state = tcreate("hrnet_w32").state_dict()
    got = M.param_shardings(state, M.make_mesh(
        8, model_parallel=2, devices=["cpu"] * 8))
    leaf = {"weight": "kernel", "bias": "bias", "running_mean": "mean",
            "running_var": "var"}
    checked = sharded_n = 0
    for key, dim in got.items():
        module, name = key.rsplit(".", 1)
        if name == "num_batches_tracked":
            continue
        is_bn = f"{module}.running_mean" in state
        flax_name = "scale" if (name == "weight" and is_bn) else leaf[name]
        spec = jspecs[f"{module}.{flax_name}"]
        jax_sharded = len(spec) > 0 and spec[-1] == "model"
        assert (dim is not None) == jax_sharded, key
        if dim is not None:
            assert dim == 0   # OIHW out-channels / a vector: flax's last dim
            sharded_n += 1
        checked += 1
    assert checked == len(jspecs) and sharded_n > 100


@pytest.mark.parametrize("first", ["program", "pose"])
def test_replicas_share_submodules_whichever_comes_first(first):
    """The serving program and the registry's pose model hold one copy
    of the pose per device, whichever is replicated first (the meta
    device stands in for a second card)."""
    pose = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU())
    program = torch.nn.ModuleDict({"backend": torch.nn.Linear(2, 2),
                                   "pose": pose})
    meta = torch.device("meta")
    if first == "pose":
        pose_copy = M.replica(pose, meta)
        program_copy = M.replica(program, meta)
    else:
        program_copy = M.replica(program, meta)
        pose_copy = M.replica(pose, meta)
    assert program_copy["pose"] is pose_copy
    assert pose_copy is not pose and pose_copy[0].weight.is_meta
    assert M.replica(program, meta) is program_copy
    assert M.replica(pose[0], meta) is pose_copy[0]
    assert M.replica(program, "cpu") is program   # where it lives


def test_multihost_serves_on_the_card_unless_asked_otherwise():
    """With no local devices given a process serves on its current CUDA
    device, and raises where it has none (tests/conftest.py hides them);
    the CPU is used only when asked for."""
    from human_body_proportion_estimation_tpu_torch.parallel import (
        multihost,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost._local_devices(None)
    assert multihost._local_devices(["cpu"]) == [torch.device("cpu")]
