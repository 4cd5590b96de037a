"""Quantitative evaluation: detection mAP, pose OKS-AP and PCK (the port's
own copy of the JAX package's `metrics/`, numpy only).

COCO-protocol detection AP and keypoint OKS-AP plus MPII-style PCK, so a
pipeline's accuracy is measured against ground truth (`cli/evaluate.py`).
Aggregation is host-side numpy: evaluation is offline, variable-shape and
bandwidth-trivial; the forwards being evaluated run on the card through
the pipelines.
"""

from human_body_proportion_estimation_tpu_torch.metrics.detection import (  # noqa: F401,E501
    average_precision,
    detection_ap,
    match_image,
)
from human_body_proportion_estimation_tpu_torch.metrics.pose import (  # noqa: F401
    COCO_KP_SIGMAS,
    oks,
    oks_ap,
    pck,
)
