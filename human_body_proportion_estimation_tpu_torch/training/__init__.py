"""Training (port of the JAX package's `training/`): the pose, detector and
bottom-up train steps, the resident-dataset loops of the synthetic
certification, and its numpy/cv2 scene and crop functions."""

from human_body_proportion_estimation_tpu_torch.training.trainer import (  # noqa: F401
    PoseTrainState,
    create_train_state,
    make_sharded_train_step,
    train_step,
)
