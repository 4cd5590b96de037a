"""Host media IO: image/video streaming and result writing.

Covers the reference's `DataStreamer` (`modules/utils.py:19-82`) and the
video handling inside `extract_data_from_media`
(`modules/triton_utils.py:95-127`): iterate a single image, a directory of
images, or a video file, yielding original RGB frames. Writing mirrors the
drivers' frame_XXXXXX.jpg / res_video.mp4 outputs
(`person_det_pose_edet4_trtserver.py:190-195`).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
MAX_VIDEO_FRAMES = 10_000  # reference cap, triton_utils.py:100-101


def list_media(path: str) -> List[str]:
    """A file, or all image files in a directory (sorted)."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        files = [
            os.path.join(path, f)
            for f in sorted(os.listdir(path))
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS
            and os.path.isfile(os.path.join(path, f))
        ]
        return files
    raise FileNotFoundError(path)


def stream_images(path: str) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames from an image path or directory."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        load_image_path,
    )

    for f in list_media(path):
        try:
            yield load_image_path(f)
        except Exception as e:  # parity: per-file failures are logged, not
            print(f"{e}. Failed to process image {f}")  # fatal (:93-94)


def stream_video(path: str) -> Tuple[Iterator[np.ndarray], float]:
    """Yield RGB frames of a video + its fps.

    The reference subtracts 10 from the writer fps (`triton_utils.py:99`,
    an output-speed quirk); that adjustment is applied by the CLI writer,
    not here.
    """
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if n > MAX_VIDEO_FRAMES:
        cap.release()
        raise ValueError(f"Video must have less than {MAX_VIDEO_FRAMES} frames")
    fps = cap.get(cv2.CAP_PROP_FPS)

    def gen():
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            yield frame[..., ::-1].copy()  # BGR -> RGB
        cap.release()

    return gen(), fps


def stream_video_bytes(
    data: bytes, frame_stride: int = 1
) -> Tuple[Iterator[np.ndarray], float]:
    """Yield RGB frames from in-memory video bytes + the video's fps.

    cv2.VideoCapture reads from paths only, so the bytes land in a
    temporary file that is unlinked when the generator is exhausted (or
    closed). `frame_stride` > 1 subsamples frames (every stride-th frame
    is yielded) — bounded work for long uploads. The 10k-frame cap
    matches the reference's video guard (`triton_utils.py:100-101`).
    """
    import tempfile

    if frame_stride < 1:
        raise ValueError(f"frame_stride must be >= 1, got {frame_stride}")
    # a suffix of its own: the JAX package's tests count its "*.video"
    # files in the shared temporary directory
    tmp = tempfile.NamedTemporaryFile(suffix=".hbpe-video", delete=False)
    try:
        tmp.write(data)
        tmp.close()
        frames, fps = stream_video(tmp.name)
    except BaseException:
        os.unlink(tmp.name)
        raise

    def gen():
        try:
            for i, frame in enumerate(frames):
                if i % frame_stride == 0:
                    yield frame
        finally:
            try:
                os.unlink(tmp.name)
            except OSError:
                pass

    return gen(), fps


class VideoWriter:
    """mp4 writer taking RGB frames (thin cv2 wrapper)."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        import cv2

        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), max(fps, 1.0),
            (width, height),
        )

    def write(self, frame_rgb: np.ndarray):
        self._writer.write(frame_rgb[..., ::-1])

    def close(self):
        self._writer.release()


def save_image(path: str, frame_rgb: np.ndarray):
    import cv2

    cv2.imwrite(path, frame_rgb[..., ::-1])
