"""The work of arch `edet_lite_hrnet`: a served image's model FLOPs and
each hand-written kernel's call in a serving forward."""

from __future__ import annotations

from typing import Dict

from port_bench.counts import kernels, model


def image_flops(config: dict) -> float:
    """Model FLOPs of one served image: one detector forward and one pose
    forward a person slot (every slot is computed, valid or not)."""
    return model.detector_flops(config["detector"]) + \
        config["detector"]["max_persons"] * model.pose_flops(config["pose"])


def serving_calls(config: dict, batch: int) -> Dict[str, tuple]:
    """(bytes, operations, peak) of each kernel's one call in a serving
    forward of `batch` images of `config`."""
    det = config["detector"]
    return {
        "head_score": kernels.head_score(
            batch, kernels.level_cells(det["input_height"],
                                       det["input_width"]),
            det["fpn_channels"], 9, det["num_classes"]),
        "nms_sweep": kernels.nms_sweep(batch, det["nms_top_k"]),
    }
