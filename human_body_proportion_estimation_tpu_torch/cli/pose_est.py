"""Pose-estimation-only CLI on pre-cropped person images (the port of the
JAX package's `cli/pose_est.py`, on the GPU).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.pose_est \\
        -i <image, image directory or video> \\
        [--model hrnet_w32|hrnet_w48|higherhrnet] [-g PORT]

Counterpart of the reference pose demo (`pose_est_hrnet_trtserver.py`):
RGB/255 preprocess to 288x384, heatmaps, argmax decode, keypoints scaled
from heatmap dims to the display image (:126-129), skeleton/keypoint
rendering and summed-heatmap plots (drawn with cv2).

Two execution modes, mirroring the reference's client/server split:
in process (default: `PosePipeline` on the GPU, the decode kernel on its
heatmaps; no weights for this CLI are in the repository, so the model
is initialized at random as the JAX CLI initializes its flax model, from
`PRNGKey(0)`), and remote via
`-g/--grpc_port`: the CLI calls the serving edge's named
`hrnet`/`higherhrnet` model through the tensor-level ModelInfer RPC and
decodes the heatmaps that come back over the wire on the host
(`pose_est_hrnet_trtserver.py:31-52`, `modules/triton_utils.py:131-177`).

Its `main` also prints one "frame i: ..." line a frame (the JAX CLI prints
only its timing), so that a subprocess run can be checked.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.cli.args import build_parser
from human_body_proportion_estimation_tpu_torch.pipeline.pose import (
    PosePipeline,
    preprocess_crop_host,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    draw,
    io as media_io,
)


def _decode_heatmaps_np(hm: np.ndarray):
    """Host-side argmax decode for remote heatmaps: (x=idx%w, y=idx//w),
    conf=max — reference `pose_estimator.py:75-99`."""
    b, k, h, w = hm.shape
    flat = hm.reshape(b, k, -1)
    idx = flat.argmax(-1)
    conf = flat.max(-1)
    kp = np.stack([idx % w, idx // w], axis=-1).astype(np.float32)
    return kp, conf.astype(np.float32)


def _remote_infer_fn(grpc_target: str, model_name: str):
    """Inference closure driving the serving edge's named model via the
    tensor-level ModelInfer RPC (the tritonclient role)."""
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    if ":" not in grpc_target:
        grpc_target = f"127.0.0.1:{grpc_target}"
    client = GrpcClient(grpc_target)
    reg_name = "higherhrnet" if model_name == "higherhrnet" else "hrnet"
    # hrnet heatmaps arrive as "output", higherhrnet's as "output_2" —
    # the same dual contract the reference postprocess dispatches on
    # (pose_est_hrnet_trtserver.py:22-28)
    out_name = "output_2" if reg_name == "higherhrnet" else "output"
    # metadata-driven input sizing (parse_model_grpc, triton_utils.py:54-72)
    # with the reference's 512x512 fallback for dynamic dims (:51-52)
    meta = client.model_metadata(reg_name)
    _, _, mh, mw = meta["inputs"][0]["shape"]
    in_w = 512 if mw == -1 else mw
    in_h = 512 if mh == -1 else mh

    def infer(model_in_nhwc: np.ndarray):
        nchw = np.ascontiguousarray(
            np.transpose(model_in_nhwc, (0, 3, 1, 2)), dtype=np.float32
        )
        hm = client.infer(reg_name, {"input": nchw}, [out_name])[out_name]
        kp, conf = _decode_heatmaps_np(hm)
        return hm[0], kp[0], conf[0]

    return infer, (in_w, in_h)


def _local_infer_fn(model_name: str, device: str, dtype: torch.dtype):
    """In-process closure: the named pose model at random (flax's init
    with PRNGKey(0)), `PosePipeline` on `device`."""
    from human_body_proportion_estimation_tpu_torch.models import (
        higherhrnet,
        hrnet,
        layers,
    )

    if device == "cuda":
        # the heads are f32 convs, as in the JAX package: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if model_name == "higherhrnet":
        model = higherhrnet.HigherHRNetHeatmaps(dtype=dtype)
    else:
        model = hrnet.create_hrnet(model_name, dtype=dtype)
    program = PosePipeline(layers.init_random(model).to(device).eval())

    def infer(model_in_nhwc: np.ndarray):
        res = program(torch.from_numpy(model_in_nhwc).to(device))
        return tuple(t[0].cpu().numpy() for t in
                     (res.heatmaps, res.keypoints, res.scores))

    return infer, (288, 384)  # reference crop W x H (conv.py:61)


def run_demo_pose_est(
    media_filename: str,
    model_name: str = "hrnet_w32",
    inference_mode: str = "image",
    save_result_dir: str | None = None,
    debug: bool = True,
    grpc_target: str | None = None,
    device: str = "cuda",
    dtype: torch.dtype = torch.bfloat16,
):
    """Returns per-frame (keypoints, scores, heatmaps) numpy. `device` /
    `dtype`: where and in what the in-process model runs (the GPU in bf16
    unless the caller asks otherwise)."""
    start = time.time()
    if grpc_target:
        infer_fn, (in_w, in_h) = _remote_infer_fn(grpc_target, model_name)
    else:
        infer_fn, (in_w, in_h) = _local_infer_fn(model_name, device, dtype)

    save_dir = None
    if save_result_dir:
        save_dir = os.path.join(save_result_dir, f"tpu_{model_name}")
        os.makedirs(save_dir, exist_ok=True)

    if inference_mode == "video":
        frames, fps = media_io.stream_video(media_filename)
    else:
        frames = media_io.stream_images(media_filename)
        fps = 1.0

    writer = None
    outputs = []
    for counter, frame in enumerate(frames):
        model_in = preprocess_crop_host(frame, in_w, in_h)
        heatmap, kp, scores = infer_fn(model_in[None])
        outputs.append((kp, scores, heatmap))

        if save_dir is not None:
            draw.save_heatmap_plot(
                heatmap, os.path.join(save_dir, f"heatmap_{counter:06d}.jpg")
            )
            ih, iw = frame.shape[:2]
            _, hm_h, hm_w = heatmap.shape
            kp_img = kp / [hm_w, hm_h] * [iw, ih]  # :126-129
            draw.draw_skeleton(
                frame, kp_img, np.ones(11, bool), color=(0, 0, 255),
                thickness=2,
            )
            draw.draw_keypoints(frame, kp_img, None, (0, 0, 255))
            if inference_mode == "video":
                if writer is None:
                    writer = media_io.VideoWriter(
                        os.path.join(save_dir, "res_video.mp4"),
                        max(fps - 10, 1.0), frame.shape[1], frame.shape[0],
                    )
                writer.write(frame)
            else:
                media_io.save_image(
                    os.path.join(save_dir, f"frame_{counter:06d}.jpg"), frame
                )
    if writer is not None:
        writer.close()
    if debug:
        print(f"Time to process {len(outputs)} image(s)="
              f"{time.time()-start:.3f}s")
    return outputs


def main():
    parser = build_parser("Single Person Pose Estimation (GPU)")
    parser.add_argument("--model", default="hrnet_w32",
                        choices=("hrnet_w32", "hrnet_w48", "higherhrnet"))
    args = parser.parse_args()
    outputs = run_demo_pose_est(
        args.input_path,
        model_name=args.model,
        inference_mode=args.media_type,
        save_result_dir=args.output_dir or None,
        debug=args.debug,
        grpc_target=args.grpc_port,
    )
    for i, (kp, scores, heatmap) in enumerate(outputs):
        print(f"frame {i}: heatmaps {list(heatmap.shape)} keypoints "
              f"{kp.astype(int).tolist()} scores "
              f"{[round(float(s), 6) for s in scores]}")


if __name__ == "__main__":
    main()
