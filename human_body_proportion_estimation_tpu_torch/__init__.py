"""PyTorch/CUDA port of the body-proportion estimation main path.

The EfficientDet-Lite4 -> HRNet-W32 -> centimetre pipeline of
`human_body_proportion_estimation_tpu`, written in PyTorch for one NVIDIA
H100. The three Pallas kernels of the JAX package are hand-written CUDA
kernels here (`csrc/`, bound in `ops/kernels.py`); everything else is plain
PyTorch.

Layout (mirrors the JAX package):
    utils/      config tree, JSON logging, stage timer, media IO, drawing
    ops/        boxes, NMS, crop, heatmap decode, proportions, and the
                CUDA kernel wrappers
    models/     anchors, EfficientNet-Lite / EfficientDet, HRNet, weight
                conversion
    pipeline/   the fused forward, the detector backend, host orchestration
    serve/      the HTTP edge, its batchers (Python, and the C++ core of
                native/ built at first use), tracing, OpenAPI document
    cli/        the main-path CLI (detect_pose)
    csrc/       CUDA C++ sources (built at first use, see ops/build.py)

Entry points run on CUDA unless the caller passes `device="cpu"`; there is
no silent fallback from one device to the other.
"""

__version__ = "0.1.0"

from human_body_proportion_estimation_tpu_torch.utils.config import (  # noqa: F401
    PipelineConfig,
)
