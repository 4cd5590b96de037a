"""EfficientDet-Lite pretrained-weight importer, TF checkpoint / SavedModel
-> flax variable tree (port of the JAX package's `models/tf_import.py`;
numpy only, TensorFlow imported inside the two readers).

The reference's flagship detector is a pretrained EfficientDet-Lite4
SavedModel served by Triton (the reference's `models/conv.py:15-18`;
weights distributed through the README download step,
`README.md:13-26`). The canonical public source of those
weights is the google/automl EfficientDet release (TF checkpoints with
TF1-style variable names). This module maps that naming onto the flax
tree, which names the port's modules too (`models/weights.
flax_to_state_dict` then gives the port's `state_dict`):

  backbone   efficientnet-lite{N}/stem|blocks_{k}/... (tpu_batch_normalization*)
  pre-cell   resample_p6/conv2d + resample_p6/bn
  BiFPN      fpn_cells/cell_{c}/fnode{f}/resample_0_{off}_{nid}/...
             fpn_cells/cell_{c}/fnode{f}/op_after_combine{nid}/conv|bn
  heads      class_net/class-{r}[/|-bn-{lvl}]..., class-predict (box_net same)

fnode numbering follows the automl node graph for levels 3..7: input nodes
0..4 are P3raw..P7; fnode f creates node (f+5); top-down fnodes 0..3
produce P6',P5',P4',P3' (td_3..td_0) and bottom-up fnodes 4..7 produce
P4''..P7'' (bu_1..bu_4). Only cell_0 fnodes that consume a raw backbone
feature hold resample convs: separate weights for the top-down and
bottom-up consumers (`BiFPNLayer` mirrors this topology).

Layout conversions: TF conv kernels are already HWIO (no transpose);
depthwise kernels are (kh, kw, C, 1) -> flax grouped-conv (kh, kw, 1, C).
No real automl checkpoint has been through this importer offline; the
JAX package validates the table against a TF re-implementation
(`tests/test_tf_efficientdet_import.py`), and the port's is held against
the JAX package's (`tests/test_torch_port_importers.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EFFICIENTDET_LITE4,
    EfficientDetConfig,
)
from human_body_proportion_estimation_tpu_torch.models.efficientnet_lite import (  # noqa: E501
    EfficientNetLiteConfig,
)

# automl variable-name prefix of each EfficientNet-Lite backbone, by its
# (width, depth) multipliers (the JAX config's `tf_name`)
_TF_NAMES = {(1.0, 1.0): "efficientnet-lite0",
             (1.0, 1.1): "efficientnet-lite1",
             (1.1, 1.2): "efficientnet-lite2",
             (1.2, 1.4): "efficientnet-lite3",
             (1.4, 1.8): "efficientnet-lite4"}


def tf_name(backbone: EfficientNetLiteConfig) -> str:
    """The automl prefix of `backbone` ("efficientnet-lite0" for a
    backbone of no published variant, the JAX config's default)."""
    return _TF_NAMES.get((backbone.width_mult, backbone.depth_mult),
                         "efficientnet-lite0")

# --------------------------------------------------------------------- #
# name-mapping table


class MapEntry:
    """One flax module <- TF variable-group correspondence.

    kind: 'conv' (HWIO kernel, verbatim), 'dw' (depthwise kernel,
    (h,w,C,1) -> (h,w,1,C)), 'bias', or 'bn' (gamma/beta/moving_mean/
    moving_variance -> scale/bias + batch_stats mean/var).
    """

    def __init__(self, kind: str, flax_path: Tuple[str, ...], tf_name: str):
        self.kind = kind
        self.flax_path = flax_path
        self.tf_name = tf_name

    def __repr__(self):
        return f"MapEntry({self.kind}, {'/'.join(self.flax_path)}, {self.tf_name})"


def _convbn(path: Tuple[str, ...], conv: str, bn: str,
            dw: bool = False) -> List[MapEntry]:
    kind = "dw" if dw else "conv"
    return [
        MapEntry(kind, path + ("conv", "kernel"), conv),
        MapEntry("bn", path + ("bn",), bn),
    ]


def _sepconv(path: Tuple[str, ...], prefix: str, bn: str) -> List[MapEntry]:
    """SeparableConvBN <- automl SeparableConv2D (+ its own bn)."""
    return [
        MapEntry("dw", path + ("depthwise", "kernel"),
                 f"{prefix}/depthwise_kernel"),
        MapEntry("conv", path + ("pointwise", "kernel"),
                 f"{prefix}/pointwise_kernel"),
        MapEntry("bias", path + ("pointwise", "bias"), f"{prefix}/bias"),
        MapEntry("bn", path + ("bn",), bn),
    ]


def efficientdet_map(
    config: EfficientDetConfig = EFFICIENTDET_LITE4,
) -> List[MapEntry]:
    """The full flax<->TF correspondence for one EfficientDet-Lite model."""
    bb = tf_name(config.backbone)
    entries: List[MapEntry] = []

    # ---- backbone ----
    entries += _convbn(("backbone", "stem"), f"{bb}/stem/conv2d/kernel",
                       f"{bb}/stem/tpu_batch_normalization")
    k = 0  # automl global block index
    for si, (e, _c, r, _s, _k) in enumerate(config.backbone.stages):
        for bi in range(r):
            p = ("backbone", f"stage{si}_block{bi}")
            blk = f"{bb}/blocks_{k}"
            if e != 1:
                entries += _convbn(p + ("expand",), f"{blk}/conv2d/kernel",
                                   f"{blk}/tpu_batch_normalization")
                entries += _convbn(
                    p + ("depthwise",),
                    f"{blk}/depthwise_conv2d/depthwise_kernel",
                    f"{blk}/tpu_batch_normalization_1", dw=True,
                )
                entries += _convbn(p + ("project",),
                                   f"{blk}/conv2d_1/kernel",
                                   f"{blk}/tpu_batch_normalization_2")
            else:
                entries += _convbn(
                    p + ("depthwise",),
                    f"{blk}/depthwise_conv2d/depthwise_kernel",
                    f"{blk}/tpu_batch_normalization", dw=True,
                )
                entries += _convbn(p + ("project",), f"{blk}/conv2d/kernel",
                                   f"{blk}/tpu_batch_normalization_1")
            k += 1

    # ---- pre-cell P6 resample (P7 is pool-only, no vars) ----
    entries += _convbn(("p6_down", "adapt"), "resample_p6/conv2d/kernel",
                       "resample_p6/bn")

    # ---- BiFPN cells ----
    # (our module name, fnode index, input node id for cell-0 resample)
    # node ids: P3..P7 raw are 0..4; fnode f creates node f+5
    fnodes = [
        ("td_3", 0, None),   # P6' <- [P6, P7]         node 5
        ("td_2", 1, 2),      # P5' <- [P5raw, 5]       node 6
        ("td_1", 2, 1),      # P4' <- [P4raw, 6]       node 7
        ("td_0", 3, 0),      # P3' <- [P3raw, 7]       node 8
        ("bu_1", 4, 1),      # P4''<- [P4raw, 7, 8]    node 9
        ("bu_2", 5, 2),      # P5''<- [P5raw, 6, 9]    node 10
        ("bu_3", 6, None),   # P6''<- [P6, 5, 10]      node 11 (P6 pre-resampled)
        ("bu_4", 7, None),   # P7''<- [P7, 11]         node 12
    ]
    for c in range(config.fpn_repeats):
        cell = f"fpn_cells/cell_{c}"
        for ours, f, raw_in in fnodes:
            nid = f + 5
            if c == 0 and raw_in is not None:
                # our resample module is named by the level index it adapts
                level = ours.split("_")[1]
                kind = "td" if ours.startswith("td") else "bu"
                entries += _convbn(
                    (f"bifpn{c}", f"{kind}_resample_{level}"),
                    f"{cell}/fnode{f}/resample_0_{raw_in}_{nid}/conv2d/kernel",
                    f"{cell}/fnode{f}/resample_0_{raw_in}_{nid}/bn",
                )
            entries += _sepconv(
                (f"bifpn{c}", ours),
                f"{cell}/fnode{f}/op_after_combine{nid}/conv",
                f"{cell}/fnode{f}/op_after_combine{nid}/bn",
            )

    # ---- heads (convs shared across levels, BN per level) ----
    for net, tag in (("class_net", "class"), ("box_net", "box")):
        for r in range(config.head_repeats):
            entries.append(MapEntry("dw", (net, f"dw{r}", "kernel"),
                                    f"{net}/{tag}-{r}/depthwise_kernel"))
            entries.append(MapEntry("conv", (net, f"pw{r}", "kernel"),
                                    f"{net}/{tag}-{r}/pointwise_kernel"))
            entries.append(MapEntry("bias", (net, f"pw{r}", "bias"),
                                    f"{net}/{tag}-{r}/bias"))
            for li in range(5):  # levels 3..7
                entries.append(MapEntry(
                    "bn", (net, f"bn{r}_l{li}"),
                    f"{net}/{tag}-{r}-bn-{li + 3}",
                ))
        entries.append(MapEntry("dw", (net, "predict_dw", "kernel"),
                                f"{net}/{tag}-predict/depthwise_kernel"))
        entries.append(MapEntry("conv", (net, "predict_pw", "kernel"),
                                f"{net}/{tag}-predict/pointwise_kernel"))
        entries.append(MapEntry("bias", (net, "predict_pw", "bias"),
                                f"{net}/{tag}-predict/bias"))
    return entries


# --------------------------------------------------------------------- #
# array sources


_SKIP_SUBSTRINGS = ("Momentum", "RMSProp", "ExponentialMovingAverage",
                    "global_step", "optimizer", "save_counter")


def load_tf_checkpoint_arrays(path: str, prefer_ema: bool = True
                              ) -> Dict[str, np.ndarray]:
    """Read every model variable of a TF checkpoint as numpy.

    automl training checkpoints carry ExponentialMovingAverage shadows;
    eval/serving uses the EMA values, so with `prefer_ema` a variable whose
    `<name>/ExponentialMovingAverage` twin exists reads the EMA tensor.
    """
    import tensorflow as tf

    reader = tf.train.load_checkpoint(path)
    shape_map = reader.get_variable_to_shape_map()
    out: Dict[str, np.ndarray] = {}
    for name in shape_map:
        if any(s in name for s in _SKIP_SUBSTRINGS):
            continue
        src = name
        if prefer_ema and f"{name}/ExponentialMovingAverage" in shape_map:
            src = f"{name}/ExponentialMovingAverage"
        out[name] = np.asarray(reader.get_tensor(src))
    return out


def load_saved_model_arrays(export_dir: str) -> Dict[str, np.ndarray]:
    """Read variables of a TF SavedModel (the format the reference actually
    serves, `models/conv.py:15`) as {tf1-style name: numpy}."""
    import tensorflow as tf

    loaded = tf.saved_model.load(export_dir)
    out: Dict[str, np.ndarray] = {}
    for v in loaded.variables:
        name = v.name.split(":")[0]
        out[name] = v.numpy()
    return out


# --------------------------------------------------------------------- #
# import


def _copy_tree(tree) -> Dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def _get(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray):
    node = _get(tree, path[:-1])
    old = node[path[-1]]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: "
            f"flax {tuple(old.shape)} vs tf {tuple(value.shape)}"
        )
    node[path[-1]] = value.astype(np.float32)


def import_tf_efficientdet(
    arrays: Dict[str, np.ndarray],
    flax_vars: Any,
    config: EfficientDetConfig = EFFICIENTDET_LITE4,
    strict: bool = True,
) -> Any:
    """Map automl-named TF arrays onto our EfficientDet variable tree.

    `strict` raises on any expected-but-missing TF variable; non-strict
    skips them (useful for partial checkpoints). Shape mismatches always
    raise — they indicate a config/variant mismatch, never a benign skip.
    """
    params = _copy_tree(flax_vars["params"])
    stats = _copy_tree(flax_vars["batch_stats"])
    missing: List[str] = []
    imported = 0
    for ent in efficientdet_map(config):
        if ent.kind == "bn":
            names = {
                "scale": f"{ent.tf_name}/gamma",
                "bias": f"{ent.tf_name}/beta",
            }
            stat_names = {
                "mean": f"{ent.tf_name}/moving_mean",
                "var": f"{ent.tf_name}/moving_variance",
            }
            if any(n not in arrays for n in
                   list(names.values()) + list(stat_names.values())):
                missing.append(ent.tf_name)
                continue
            for leaf, tf_n in names.items():
                _set(params, ent.flax_path + (leaf,), arrays[tf_n])
            for leaf, tf_n in stat_names.items():
                _set(stats, ent.flax_path + (leaf,), arrays[tf_n])
        else:
            if ent.tf_name not in arrays:
                missing.append(ent.tf_name)
                continue
            t = arrays[ent.tf_name]
            if ent.kind == "dw":
                t = np.transpose(t, (0, 1, 3, 2))  # (h,w,C,1) -> (h,w,1,C)
            _set(params, ent.flax_path, t)
        imported += 1
    if missing and strict:
        raise KeyError(
            f"{len(missing)} expected TF variables missing, e.g. "
            f"{missing[:5]}"
        )
    if imported == 0:
        raise ValueError("no tensors imported — wrong checkpoint format?")
    return {"params": params, "batch_stats": stats}


def export_tf_efficientdet(
    flax_vars: Any, config: EfficientDetConfig = EFFICIENTDET_LITE4
) -> Dict[str, np.ndarray]:
    """Inverse mapping (flax -> automl-named arrays); validates the table
    by exact round trip and lets fine-tuned weights flow back to TF."""
    params = flax_vars["params"]
    stats = flax_vars["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    for ent in efficientdet_map(config):
        if ent.kind == "bn":
            bn_p = _get(params, ent.flax_path)
            bn_s = _get(stats, ent.flax_path)
            out[f"{ent.tf_name}/gamma"] = np.asarray(bn_p["scale"])
            out[f"{ent.tf_name}/beta"] = np.asarray(bn_p["bias"])
            out[f"{ent.tf_name}/moving_mean"] = np.asarray(bn_s["mean"])
            out[f"{ent.tf_name}/moving_variance"] = np.asarray(bn_s["var"])
        else:
            t = np.asarray(_get(params, ent.flax_path))
            if ent.kind == "dw":
                t = np.transpose(t, (0, 1, 3, 2))
            out[ent.tf_name] = t
    return out
