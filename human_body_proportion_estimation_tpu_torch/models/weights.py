"""Checkpoint loading: the compact `.npz` format and the flax-tree ->
`state_dict` converter.

`load_compact_checkpoint` is this package's own copy of the JAX package's
reader (`models/weights.py:103-118`): keys are '/'-joined flax pytree
paths, float16 at rest, float32 on load.

The port names its modules after the flax modules, so a flax leaf path maps
to a `state_dict` key one to one:
  params/.../kernel  [kh, kw, in, out] (HWIO)   -> .../weight  OIHW
                     depthwise [kh, kw, 1, C]   -> .../weight  [C, 1, kh, kw]
  params/.../deconv/kernel (flax ConvTranspose, [kh, kw, in, out],
                     unflipped)                 -> .../deconv.weight
                     [in, out, kh, kw], spatially flipped (torch's
                     transposed conv is the adjoint of a conv; the JAX
                     package's `_deconv_to_torch`, weights.py:338)
  params/.../bias                               -> .../bias
  params/.../scale   (BatchNorm)                -> .../weight
  batch_stats/.../mean, var                     -> .../running_mean, running_var
(+ a zero `num_batches_tracked` per BatchNorm, which inference never
reads). Loaded with `load_state_dict(..., strict=True)`, a flax leaf the
port has no place for, or a port tensor the checkpoint does not fill,
raises. `state_dict_to_flax` is the exact inverse.

Writers, for the trainers (`training/`):
  * `save_compact_checkpoint`: the JAX package's compact `.npz`
    (weights.py:85-100): f16 leaves under '/'-joined flax paths, in the
    order of flax's sorted trees, so the JAX `load_compact_checkpoint`
    reads what the port writes.
  * `save_training_checkpoint` / `load_training_checkpoint`: the
    `{params, batch_stats, step}` tree the JAX trainers checkpoint, as an
    f32 `.npz`. The JAX package writes it with Orbax
    (weights.py:39-66, training/loop.py:81-94).

Orbax checkpoints (`--checkpoint-dir`): `load_pipeline_checkpoint` /
`load_pose_checkpoint` read the directories the JAX package's
`save_pipeline_checkpoint` / `save_pose_checkpoint` write, and the
`save_*` twins write directories those read. `orbax.checkpoint` imports
jax, so the port reads and writes the format itself through
`tensorstore`, imported inside these functions: one PyTree checkpoint
a slot (`det/`, `pose/`), its tree in `_METADATA`, every leaf a zarr v2
array named by its '.'-joined keys in an OCDBT key-value store.

Importers of the official torch pose checkpoints (numpy only; the port of
weights.py:159-477): `import_torch_hrnet` / `export_torch_hrnet`
(pose_hrnet) and `import_torch_higherhrnet` / `export_torch_higherhrnet`
(PoseHigherResolutionNet) map a torch `state_dict` (numpy values) onto a
flax tree and back; `flax_to_state_dict` then gives the port's weights.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNET_W32,
    HRNetConfig,
)

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_certified_checkpoint() -> str:
    """The committed synthetic-certified EfficientDet-Lite4 @ 480x640 +
    HRNet-W32 @ 384x288 weights (read in place, never copied)."""
    return os.path.join(
        _REPO_DIR, "human_body_proportion_estimation_tpu", "checkpoints",
        "certified_lite4_w32.npz",
    )


def default_certified_bottomup_checkpoint() -> str:
    """Where the JAX package keeps its synthetic-certified bottom-up
    checkpoint (HigherHRNet @ 512x512, pose slot only), the weights
    `serve.server --bottom-up` serves when the file is there."""
    return os.path.join(
        _REPO_DIR, "human_body_proportion_estimation_tpu", "checkpoints",
        "certified_higherhrnet.npz",
    )


def maybe_load_certified(bottom_up: bool = False):
    """(det_state, pose_state) port `state_dict`s of the committed
    synthetic-certified checkpoint (the bottom-up one with `bottom_up`,
    whose detector slot is empty: None), or (None, None) when the file is
    absent or HBPE_DISABLE_CERTIFIED_FALLBACK is set. The rule of the JAX
    package's `maybe_load_certified`; callers label the slots they use
    "synthetic-certified"."""
    if os.environ.get("HBPE_DISABLE_CERTIFIED_FALLBACK"):
        return None, None
    path = (default_certified_bottomup_checkpoint() if bottom_up
            else default_certified_checkpoint())
    if not os.path.exists(path):
        return None, None
    return tuple(flax_to_state_dict(tree) if tree else None
                 for tree in load_compact_checkpoint(path))


def load_compact_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """(det_vars, pose_vars) flax-style trees of float32 numpy arrays."""
    data = np.load(path)
    trees: Dict[str, Dict] = {"det": {}, "pose": {}}
    for name in data.files:
        parts = name.split("/")
        node = trees[parts[0]]
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        arr = data[name]
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        node[parts[-1]] = arr
    return trees["det"], trees["pose"]


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
# flax modules that are transposed convs (HigherHRNet's `deconv`)
_TRANSPOSED_CONVS = ("deconv",)
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} flax tree (numpy leaves) -> the
    port's `state_dict` (float32)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, mapping in (("params", _PARAM_LEAF),
                                ("batch_stats", _STAT_LEAF)):
        for path, leaf in _leaves(variables.get(collection, {})):
            arr = np.array(leaf, np.float32)  # a writable copy
            if path[-1] not in mapping:
                raise KeyError(f"{collection}/{'/'.join(path)}: unknown leaf")
            if path[-1] == "kernel" and path[-2] in _TRANSPOSED_CONVS:
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            elif path[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))   # HWIO -> OIHW
            key = ".".join(path[:-1] + (mapping[path[-1]],))
            if key in sd:
                raise KeyError(f"{key}: two flax leaves map to one key")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if path[-1] == "mean":
                sd[".".join(path[:-1] + ("num_batches_tracked",))] = (
                    torch.zeros((), dtype=torch.long))
    return sd


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's `state_dict` -> {'params': ..., 'batch_stats': ...} flax
    tree of f32 numpy arrays: the exact inverse of `flax_to_state_dict`
    (OIHW -> HWIO, the transposed conv's flip undone, BatchNorm weight ->
    scale, running statistics -> batch_stats; `num_batches_tracked`, which
    flax has no leaf for, is dropped)."""
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        is_bn = f"{module}.running_mean" in state
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and is_bn:
            collection, name = "params", "scale"
        elif leaf == "weight":
            collection, name = "params", "kernel"
            if module.rsplit(".", 1)[-1] in _TRANSPOSED_CONVS:
                arr = np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1))
            else:
                arr = np.transpose(arr, (2, 3, 1, 0))   # OIHW -> HWIO
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"{key}: unknown leaf")
        node = tree[collection]
        for part in module.split(".") if module else ():
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr, np.float32)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree


def _flat_flax(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined leaf paths of a flax tree in the order of
    `jax.tree_util.tree_flatten_with_path` (dict keys sorted)."""
    out: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], Mapping):
            out.update(_flat_flax(tree[k], name))
        else:
            out[name] = np.asarray(tree[k])
    return out


def save_compact_checkpoint(path: str, det_state, pose_state) -> None:
    """Write the detector and pose slots (port `state_dict`s; None or {}
    for an empty slot) into one compressed `.npz` that the JAX package's
    `load_compact_checkpoint` reads: float leaves stored float16 under
    'det/...' and 'pose/...' flax paths."""
    flat: Dict[str, np.ndarray] = {}
    for prefix, slot in (("det", det_state), ("pose", pose_state)):
        tree = state_dict_to_flax(slot) if slot else {}
        for name, arr in _flat_flax(tree, prefix).items():
            if arr.dtype in (np.float32, np.float64):
                arr = arr.astype(np.float16)
            flat[name] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def save_training_checkpoint(path: str, state: Mapping[str, torch.Tensor],
                             step: int = 0) -> None:
    """Write one model's `state_dict` as the `{params, batch_stats, step}`
    tree, an f32 `.npz`, exactly."""
    flat = _flat_flax(state_dict_to_flax(state))
    flat["step"] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_training_checkpoint(path: str) -> Tuple[Dict, int]:
    """(flax tree {'params', 'batch_stats'} of f32 numpy arrays, step) of a
    `save_training_checkpoint` file; `flax_to_state_dict` turns the tree
    into the port's `state_dict`."""
    data = np.load(path)
    tree: Dict[str, Dict] = {}
    for name in data.files:
        if name == "step":
            continue
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[name]
    return tree, int(data["step"])


# --------------------------------------------------------------------- #
# Orbax checkpoints, through tensorstore


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading or writing an Orbax checkpoint (--checkpoint-dir) "
            f"needs the tensorstore package: {e}") from e
    return tensorstore


def _ocdbt_spec(directory: str, name: str) -> Dict[str, Any]:
    return {"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{os.path.abspath(directory)}/",
        "path": f"{name}/"}}


def load_orbax_tree(directory: str) -> Dict[str, Any]:
    """The tree of one Orbax PyTree checkpoint directory of arrays (as the
    JAX package's `PyTreeCheckpointer().restore` gives a pipeline slot):
    nested dicts of numpy arrays. Every leaf is opened and read at once
    (tensorstore futures)."""
    ts = _tensorstore()
    with open(os.path.join(directory, "_METADATA")) as fh:
        meta = json.load(fh)
    ctx = ts.Context()
    paths = [[str(k["key"]) for k in e["key_metadata"]]
             for e in meta["tree_metadata"].values()]
    opened = [ts.open(_ocdbt_spec(directory, ".".join(keys)), open=True,
                      context=ctx) for keys in paths]
    reads = [f.result().read() for f in opened]
    tree: Dict[str, Any] = {}
    for keys, read in zip(paths, reads):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = read.result()
    return tree


def save_orbax_tree(directory: str, tree: Mapping[str, Any]) -> None:
    """Write a nested dict of arrays as the Orbax PyTree checkpoint the JAX
    package writes (OCDBT, zarr v2 leaves, `_METADATA`), replacing
    `directory` (orbax's `force=True`); one tensorstore transaction, so
    the store commits once."""
    ts = _tensorstore()
    directory = os.path.abspath(directory)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.makedirs(directory)
    ctx, txn = ts.Context(), ts.Transaction()
    leaves = {name: np.ascontiguousarray(arr)
              for name, arr in _flat_flax(tree).items()}
    opened = []
    for name, arr in leaves.items():
        spec = _ocdbt_spec(directory, name.replace("/", "."))
        spec["metadata"] = {
            "shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": arr.dtype.str, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": "."}
        opened.append(ts.open(spec, create=True, context=ctx,
                              transaction=txn))
    writes = [f.result().write(arr) for f, arr in zip(opened,
                                                     leaves.values())]
    for w in writes:
        w.result()
    txn.commit_sync()
    meta = {str(tuple(name.split("/"))): {
        "key_metadata": [{"key": k, "key_type": 2}
                         for k in name.split("/")],
        "value_metadata": {"value_type": "np.ndarray",
                           "skip_deserialize": False}}
        for name in leaves}
    with open(os.path.join(directory, "_METADATA"), "w") as fh:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, fh)


def load_pipeline_checkpoint(directory: str) -> Tuple[Dict, Dict]:
    """(det_vars, pose_vars) flax trees of a pipeline checkpoint directory
    (`det/` and `pose/`, the JAX package's `save_pipeline_checkpoint`);
    `flax_to_state_dict` turns each into the port's `state_dict`."""
    return (load_orbax_tree(os.path.join(directory, "det")),
            load_orbax_tree(os.path.join(directory, "pose")))


def save_pipeline_checkpoint(directory: str, det_vars: Mapping,
                             pose_vars: Mapping) -> None:
    """Write detector + pose flax trees (`state_dict_to_flax` of port
    weights) as the JAX package's pipeline checkpoint."""
    save_orbax_tree(os.path.join(directory, "det"), det_vars)
    save_orbax_tree(os.path.join(directory, "pose"), pose_vars)


def load_pose_checkpoint(directory: str) -> Dict:
    """The pose slot alone (bottom-up checkpoints have no detector)."""
    return load_orbax_tree(os.path.join(directory, "pose"))


def save_pose_checkpoint(directory: str, pose_vars: Mapping) -> None:
    save_orbax_tree(os.path.join(directory, "pose"), pose_vars)


# --------------------------------------------------------------------- #
# torch pose_hrnet <-> flax name mapping
#
# Official naming (pose_hrnet): conv1/bn1, conv2/bn2, layer1.{k}.conv{c}/
# bn{c} (+ downsample.0/.1), transition{t}.{i}[.0].{0,1}, stage{s}.{m}.
# branches.{b}.{k}.conv{c}/bn{c}, stage{s}.{m}.fuse_layers.{i}.{j}[...],
# final_layer. Ours (and flax's): stem1/2, layer1_{k}.conv{c}
# (+downsample), transition{t+1}.adapt_/new_{i},
# stage{s}_module{m}.branch{b}_block{k}, .fuse.up_{j}_{i}/down_{j}_{i}_
# {step}, head (models/hrnet.py).


def _hrnet_pairs(cfg: HRNetConfig) -> List[Tuple[Tuple[str, ...], str, str]]:
    """[(flax ConvBN module path, torch conv key, torch bn prefix)] of every
    ConvBN of the model; the head is handled separately."""
    pairs: List[Tuple[Tuple[str, ...], str, str]] = [
        (("stem1",), "conv1.weight", "bn1"),
        (("stem2",), "conv2.weight", "bn2"),
    ]
    for k in range(4):
        for c in (1, 2, 3):
            pairs.append(((f"layer1_{k}", f"conv{c}"),
                          f"layer1.{k}.conv{c}.weight", f"layer1.{k}.bn{c}"))
        if k == 0:  # only the first bottleneck changes channels
            pairs.append(((f"layer1_{k}", "downsample"),
                          f"layer1.{k}.downsample.0.weight",
                          f"layer1.{k}.downsample.1"))

    prev: Tuple[int, ...] = (cfg.bottleneck_channels * 4,)
    for stage_idx, (n_modules, channels) in enumerate(
        zip(cfg.stage_modules, cfg.branch_channels)
    ):
        t_ours = f"transition{stage_idx + 2}"
        t_torch = f"transition{stage_idx + 1}"
        for i, ch in enumerate(channels):
            if i < len(prev):
                if prev[i] != ch:
                    pairs.append(((t_ours, f"adapt_{i}"),
                                  f"{t_torch}.{i}.0.weight",
                                  f"{t_torch}.{i}.1"))
            else:
                pairs.append(((t_ours, f"new_{i}"),
                              f"{t_torch}.{i}.0.0.weight",
                              f"{t_torch}.{i}.0.1"))
        s_torch = f"stage{stage_idx + 2}"
        for m in range(n_modules):
            mod = f"stage{stage_idx + 2}_module{m}"
            for b in range(len(channels)):
                for k in range(cfg.blocks_per_branch):
                    base = f"{s_torch}.{m}.branches.{b}.{k}"
                    for c in (1, 2):
                        pairs.append(((mod, f"branch{b}_block{k}", f"conv{c}"),
                                      f"{base}.conv{c}.weight",
                                      f"{base}.bn{c}"))
            n = len(channels)
            fuse = f"{s_torch}.{m}.fuse_layers"
            for i in range(n):
                for j in range(n):
                    if j > i:
                        pairs.append(((mod, "fuse", f"up_{j}_{i}"),
                                      f"{fuse}.{i}.{j}.0.weight",
                                      f"{fuse}.{i}.{j}.1"))
                    elif j < i:
                        for step in range(i - j):
                            pairs.append((
                                (mod, "fuse", f"down_{j}_{i}_{step}"),
                                f"{fuse}.{i}.{j}.{step}.0.weight",
                                f"{fuse}.{i}.{j}.{step}.1"))
        prev = channels
    return pairs


def _higherhrnet_head_pairs(
    num_deconv_blocks: int = 4,
) -> List[Tuple[Tuple[str, ...], str, str]]:
    """ConvBN pairs of the deconv residual blocks of the official
    PoseHigherResolutionNet (`deconv_layers.0.{1+i}.0.*`: each BasicBlock
    sits in an nn.Sequential of its own, hence the trailing `.0`)."""
    pairs: List[Tuple[Tuple[str, ...], str, str]] = []
    for i in range(num_deconv_blocks):
        base = f"deconv_layers.0.{1 + i}.0"
        for c in ("conv1", "conv2"):
            pairs.append(((f"deconv_block{i}", c), f"{base}.{c}.weight",
                          f"{base}.bn{c[-1]}"))
    return pairs


def _node(tree: Mapping, path: Sequence[str]):
    for p in path:
        tree = tree[p]
    return tree


def _copy_tree(tree: Mapping) -> Dict:
    """A nested dict of numpy copies of `tree`'s leaves."""
    return {k: _copy_tree(v) if isinstance(v, Mapping) else np.array(v)
            for k, v in tree.items()}


def _conv_to_flax(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (2, 3, 1, 0))  # OIHW -> HWIO


def _conv_to_torch(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (3, 2, 0, 1))  # HWIO -> OIHW


def _deconv_to_flax(t: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight (in, out, kh, kw) -> flax ConvTranspose
    kernel (kh, kw, in, out), spatially flipped (torch's transposed conv
    is the conv adjoint; flax keeps the kernel unflipped)."""
    return np.ascontiguousarray(
        np.transpose(t[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def _deconv_to_torch(t: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(
        np.transpose(t, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _import_pairs(state_dict, params, stats, pairs, strict: bool) -> int:
    imported = 0
    for path, conv_key, bn_prefix in pairs:
        if conv_key not in state_dict:
            if strict:
                raise KeyError(conv_key)
            continue
        _node(params, path)["conv"]["kernel"] = _conv_to_flax(
            state_dict[conv_key]).astype(np.float32)
        bn_p, bn_s = _node(params, path)["bn"], _node(stats, path)["bn"]
        for leaf, node, torch_leaf in (
                ("scale", bn_p, "weight"), ("bias", bn_p, "bias"),
                ("mean", bn_s, "running_mean"), ("var", bn_s, "running_var")):
            node[leaf] = state_dict[f"{bn_prefix}.{torch_leaf}"].astype(
                np.float32)
        imported += 1
    return imported


def _export_pairs(params, stats, pairs) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for path, conv_key, bn_prefix in pairs:
        out[conv_key] = _conv_to_torch(
            np.asarray(_node(params, path)["conv"]["kernel"]))
        bn_p, bn_s = _node(params, path)["bn"], _node(stats, path)["bn"]
        out[f"{bn_prefix}.weight"] = np.asarray(bn_p["scale"])
        out[f"{bn_prefix}.bias"] = np.asarray(bn_p["bias"])
        out[f"{bn_prefix}.running_mean"] = np.asarray(bn_s["mean"])
        out[f"{bn_prefix}.running_var"] = np.asarray(bn_s["var"])
    return out


def import_torch_hrnet(
    state_dict: Mapping[str, np.ndarray],
    flax_vars: Mapping[str, Any],
    config: HRNetConfig = HRNET_W32,
    strict: bool = False,
) -> Dict[str, Any]:
    """Map a pose_hrnet `state_dict` (numpy values) onto a flax HRNet tree
    ({'params', 'batch_stats'}, e.g. `state_dict_to_flax` of the port's
    model); returns a new tree. Missing torch keys are skipped unless
    `strict` (official checkpoints lack the unused fuse rows of the last
    stage-4 module)."""
    params = _copy_tree(flax_vars["params"])
    stats = _copy_tree(flax_vars["batch_stats"])
    imported = _import_pairs(state_dict, params, stats,
                             _hrnet_pairs(config), strict)
    if "final_layer.weight" in state_dict:
        params["head"]["kernel"] = _conv_to_flax(
            state_dict["final_layer.weight"]).astype(np.float32)
        params["head"]["bias"] = state_dict["final_layer.bias"].astype(
            np.float32)
        imported += 1
    if imported == 0:
        raise ValueError("no tensors imported — wrong state_dict format?")
    return {"params": params, "batch_stats": stats}


def export_torch_hrnet(flax_vars: Mapping[str, Any],
                       config: HRNetConfig = HRNET_W32
                       ) -> Dict[str, np.ndarray]:
    """Inverse of `import_torch_hrnet`: a pose_hrnet `state_dict` of numpy
    arrays."""
    params, stats = flax_vars["params"], flax_vars["batch_stats"]
    out = _export_pairs(params, stats, _hrnet_pairs(config))
    out["final_layer.weight"] = _conv_to_torch(
        np.asarray(params["head"]["kernel"]))
    out["final_layer.bias"] = np.asarray(params["head"]["bias"])
    return out


def import_torch_higherhrnet(
    state_dict: Mapping[str, np.ndarray],
    flax_vars: Mapping[str, Any],
    config: HRNetConfig = HRNET_W32,
    num_deconv_blocks: int = 4,
    strict: bool = False,
) -> Dict[str, Any]:
    """Map an official PoseHigherResolutionNet `state_dict` onto a flax
    HigherHRNet tree: the trunk shares pose_hrnet's names
    (`_hrnet_pairs`), plus `final_layers.{0,1}` -> head1 / head2, the
    deconv transposed conv + BN, and the deconv residual blocks."""
    params = _copy_tree(flax_vars["params"])
    stats = _copy_tree(flax_vars["batch_stats"])
    pairs = _hrnet_pairs(config) + _higherhrnet_head_pairs(num_deconv_blocks)
    imported = _import_pairs(state_dict, params, stats, pairs, strict)
    for torch_name, ours in (("final_layers.0", "head1"),
                             ("final_layers.1", "head2")):
        if f"{torch_name}.weight" in state_dict:
            params[ours]["kernel"] = _conv_to_flax(
                state_dict[f"{torch_name}.weight"]).astype(np.float32)
            params[ours]["bias"] = state_dict[f"{torch_name}.bias"].astype(
                np.float32)
            imported += 1
    if "deconv_layers.0.0.0.weight" in state_dict:
        params["deconv"]["kernel"] = _deconv_to_flax(
            state_dict["deconv_layers.0.0.0.weight"]).astype(np.float32)
        bn = "deconv_layers.0.0.1"
        params["deconv_bn"]["scale"] = state_dict[f"{bn}.weight"].astype(
            np.float32)
        params["deconv_bn"]["bias"] = state_dict[f"{bn}.bias"].astype(
            np.float32)
        stats["deconv_bn"]["mean"] = state_dict[
            f"{bn}.running_mean"].astype(np.float32)
        stats["deconv_bn"]["var"] = state_dict[
            f"{bn}.running_var"].astype(np.float32)
        imported += 1
    if imported == 0:
        raise ValueError("no tensors imported — wrong state_dict format?")
    return {"params": params, "batch_stats": stats}


def export_torch_higherhrnet(
    flax_vars: Mapping[str, Any],
    config: HRNetConfig = HRNET_W32,
    num_deconv_blocks: int = 4,
) -> Dict[str, np.ndarray]:
    """Inverse of `import_torch_higherhrnet`."""
    params, stats = flax_vars["params"], flax_vars["batch_stats"]
    out = _export_pairs(params, stats, _hrnet_pairs(config)
                        + _higherhrnet_head_pairs(num_deconv_blocks))
    for torch_name, ours in (("final_layers.0", "head1"),
                             ("final_layers.1", "head2")):
        out[f"{torch_name}.weight"] = _conv_to_torch(
            np.asarray(params[ours]["kernel"]))
        out[f"{torch_name}.bias"] = np.asarray(params[ours]["bias"])
    out["deconv_layers.0.0.0.weight"] = _deconv_to_torch(
        np.asarray(params["deconv"]["kernel"]))
    bn = "deconv_layers.0.0.1"
    out[f"{bn}.weight"] = np.asarray(params["deconv_bn"]["scale"])
    out[f"{bn}.bias"] = np.asarray(params["deconv_bn"]["bias"])
    out[f"{bn}.running_mean"] = np.asarray(stats["deconv_bn"]["mean"])
    out[f"{bn}.running_var"] = np.asarray(stats["deconv_bn"]["var"])
    return out


@contextlib.contextmanager
def _calibrating_batch_norm():
    """While inside, every inference BatchNorm of the port (all go through
    `F.batch_norm`, `models/layers.batch_norm`) first sets its running
    mean to its input's per-channel mean and its running variance to the
    per-channel variance, floored at that layer's mean variance."""
    plain = F.batch_norm

    def calibrate(x, mean, var, *args, **kwargs):
        dims = [d for d in range(x.dim()) if d != 1]
        v = x.var(dims)
        mean.copy_(x.mean(dims))
        var.copy_(v.clamp_min(float(v.mean())))
        return plain(x, mean, var, *args, **kwargs)

    F.batch_norm = calibrate
    try:
        yield
    finally:
        F.batch_norm = plain


def seeded_state(
    model: nn.Module,
    seed: int,
    calibrate: Callable[[nn.Module], Any],
    heads: Sequence[str] = (),
    bias: Optional[Mapping[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """A random `state_dict` for `model` (f32 numpy) made from
    `np.random.default_rng(seed)` and calibrated by `calibrate(model)`, a
    forward of the float64 model on the CPU over the inputs it will see.

    1. Draws, key after key in the module's order: LeCun-normal conv and
       transposed-conv weights (std fan_in^-1/2, fan_in the inputs one
       output sums over at stride 1, as flax initializes them), BatchNorm
       scales uniform in [0.5, 1.5] and shifts normal with mean 1 and std
       0.1, conv biases 0. The shifts keep most units of the ReLU / ReLU6
       that follow in their linear range: a calibrated network whose
       units are cut half the time amplifies rounding by ~1.2x a layer
       (EfficientDet-Lite0's f32 logits were 1.1e-3 off its float64 ones
       at shift 0, 2.7e-5 at shift 1), and two f32 stacks could then not
       be held to each other.
    2. Calibrates: in the forward, every BatchNorm's running statistics
       become its input's per-channel mean and variance (the variance
       floored at the layer's mean), so that every normalized activation
       has the drawn scale and shift on these inputs: a deep random
       network's signal dies out or grows by orders of magnitude on the
       way to its heads otherwise. Each module named in `heads` then has
       its weight divided by its outputs' standard deviation there.
    3. Adds `bias[key]` to every entry of the bias tensor `key`.

    float64 on the CPU makes the result the same on every machine to far
    below what an f32 forward can resolve (the heads that compute in f32
    whatever the trunk's dtype are calibrated in f32). The same recipe as
    `models/yolo_weights.seeded_state`, for any module of the port."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, value in model.state_dict().items():
        module_name, leaf = key.rsplit(".", 1)
        module, shape = model.get_submodule(module_name), tuple(value.shape)
        if leaf == "num_batches_tracked":
            state[key] = np.zeros(shape, np.int64)
        elif isinstance(module, nn.BatchNorm2d) and leaf == "weight":
            state[key] = rng.uniform(0.5, 1.5, shape)
        elif isinstance(module, nn.BatchNorm2d) and leaf == "bias":
            state[key] = rng.normal(1.0, 0.1, shape)
        elif leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = shape[0] * shape[2] * shape[3] // (
                    module.stride[0] * module.stride[1])
            state[key] = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == "running_var":
            state[key] = np.ones(shape)
        else:       # conv biases, running means
            state[key] = np.zeros(shape)
    model = model.to(device="cpu", dtype=torch.float64).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})

    moments: Dict[str, list] = {name: [0.0, 0.0, 0] for name in heads}

    def record(name, out):
        out = out.double()
        m = moments[name]
        m[0] += float(out.sum())
        m[1] += float((out * out).sum())
        m[2] += out.numel()

    hooks = [model.get_submodule(name).register_forward_hook(
        lambda mod, i, o, name=name: record(name, o)) for name in heads]
    try:
        with torch.no_grad(), _calibrating_batch_norm():
            calibrate(model)
    finally:
        for h in hooks:
            h.remove()
    out: Dict[str, np.ndarray] = {}
    for key, value in model.state_dict().items():
        arr = value.numpy().copy()
        module_name = key.rsplit(".", 1)[0]
        if module_name in moments and key.endswith(".weight"):
            s1, s2, n = moments[module_name]
            arr /= np.sqrt(s2 / n - (s1 / n) ** 2)
        if bias and key in bias:
            arr += bias[key]
        out[key] = arr if arr.dtype == np.int64 else arr.astype(np.float32)
    return out
