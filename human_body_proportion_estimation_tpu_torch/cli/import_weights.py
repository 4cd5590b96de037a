"""Offline weight-conversion CLI: upstream pretrained formats -> one Orbax
pipeline checkpoint that `serve.server --checkpoint-dir` reads (the port
of the JAX package's `cli/import_weights.py`; a CPU conversion step).

The reference distributes weights as a download of SavedModel / ONNX /
TensorRT blobs that Triton loads by directory convention
(the reference's `README.md:13-26`). Here conversion is an explicit,
verifiable step:

  python -m human_body_proportion_estimation_tpu_torch.cli.import_weights \\
      --efficientdet-ckpt /path/to/efficientdet-lite4/model \\
      --hrnet-torch /path/to/pose_hrnet_w32_384x288.pth \\
      --out /path/to/ckpt_dir

Sources (any subset; a slot given none keeps flax's init with PRNGKey(0),
as in JAX, and serves at random with the server's loud warning):
  --efficientdet-ckpt         automl TF checkpoint prefix (needs TensorFlow)
  --efficientdet-saved-model  TF SavedModel dir (needs TensorFlow)
  --hrnet-torch               official pose_hrnet state_dict (.pth)
  --higherhrnet-torch         official pose_higher_hrnet state_dict (.pth)
  --yolo-torch                ultralytics yolov5 state_dict (.pt); fills
                              the detector slot instead of EfficientDet

The checkpoint is written through tensorstore (`models/weights.
save_pipeline_checkpoint`), in the layout the JAX package's
`load_pipeline_checkpoint` reads too.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, option for option."""
    parser = argparse.ArgumentParser(
        description="Convert upstream pretrained weights to an orbax "
                    "pipeline checkpoint"
    )
    parser.add_argument("--efficientdet-ckpt", default=None,
                        help="automl TF checkpoint path/prefix")
    parser.add_argument("--efficientdet-saved-model", default=None,
                        help="TF SavedModel export dir")
    parser.add_argument("--efficientdet-variant", default="lite4",
                        choices=["lite0", "lite4"])
    parser.add_argument("--yolo-torch", default=None,
                        help="ultralytics yolov5 .pt state_dict; takes the "
                             "detector slot instead of EfficientDet")
    parser.add_argument("--yolo-variant", default="yolov5m",
                        choices=["yolov5s", "yolov5m", "yolov5l"])
    parser.add_argument("--hrnet-torch", default=None,
                        help="pose_hrnet .pth state_dict")
    parser.add_argument("--higherhrnet-torch", default=None,
                        help="official pose_higher_hrnet .pth state_dict; "
                             "fills the pose slot with HigherHRNet for the "
                             "bottom-up server mode (--bottom-up "
                             "--checkpoint-dir)")
    parser.add_argument("--pose-name", default="hrnet_w32",
                        choices=["hrnet_w32", "hrnet_w48"])
    parser.add_argument("--out", required=True,
                        help="output orbax checkpoint dir")
    return parser


def _torch_state(path: str) -> dict:
    """A .pth / .pt state_dict (or {'state_dict': ...}) as numpy."""
    import torch

    state = torch.load(path, map_location="cpu")
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.numpy() for k, v in state.items()}


def _flax_init(model) -> dict:
    """flax's init tree of `model`'s JAX twin at PRNGKey(0)."""
    from human_body_proportion_estimation_tpu_torch.models.flax_init import (
        init_state_dict,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        state_dict_to_flax,
    )

    return state_dict_to_flax(init_state_dict(model, 0))


def main(argv=None):
    args = build_parser().parse_args(argv)

    from human_body_proportion_estimation_tpu_torch.models import (
        weights as W,
    )
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (  # noqa: E501
        EFFICIENTDET_LITE0,
        EFFICIENTDET_LITE4,
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNET_W32,
        HRNET_W48,
        create_hrnet,
    )

    det_cfg = (EFFICIENTDET_LITE0 if args.efficientdet_variant == "lite0"
               else EFFICIENTDET_LITE4)
    if args.yolo_torch:
        import torch

        from human_body_proportion_estimation_tpu_torch.models import (
            yolo_weights,
        )
        from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
            VARIANTS,
        )

        state_np = _torch_state(args.yolo_torch)
        state = yolo_weights.import_torch_yolov5(
            state_np, VARIANTS[args.yolo_variant])
        det_vars = W.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in state.items()})
        print(f"imported {args.yolo_variant} ({len(state_np)} torch tensors)")
    else:
        det_vars = _flax_init(EfficientDet(det_cfg))
        if args.efficientdet_ckpt or args.efficientdet_saved_model:
            from human_body_proportion_estimation_tpu_torch.models import (
                tf_import,
            )

            arrays = (tf_import.load_tf_checkpoint_arrays(
                args.efficientdet_ckpt) if args.efficientdet_ckpt else
                tf_import.load_saved_model_arrays(
                    args.efficientdet_saved_model))
            det_vars = tf_import.import_tf_efficientdet(
                arrays, det_vars, det_cfg, strict=True)
            print(f"imported EfficientDet-{args.efficientdet_variant} "
                  f"({len(arrays)} TF tensors)")
        else:
            print("WARNING: no EfficientDet source given — detector slot "
                  "stays random-init")

    if args.higherhrnet_torch:
        from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (  # noqa: E501
            HigherHRNet,
        )

        state_np = _torch_state(args.higherhrnet_torch)
        pose_vars = W.import_torch_higherhrnet(
            state_np, _flax_init(HigherHRNet()))
        print(f"imported HigherHRNet ({len(state_np)} torch tensors)")
    elif args.hrnet_torch:
        state_np = _torch_state(args.hrnet_torch)
        hr_cfg = HRNET_W32 if args.pose_name == "hrnet_w32" else HRNET_W48
        pose_vars = W.import_torch_hrnet(
            state_np, _flax_init(create_hrnet(args.pose_name)), hr_cfg)
        print(f"imported HRNet ({len(state_np)} torch tensors)")
    else:
        pose_vars = _flax_init(create_hrnet(args.pose_name))
        print("WARNING: no HRNet source given — pose slot stays random-init")

    W.save_pipeline_checkpoint(args.out, det_vars, pose_vars)
    print(f"wrote pipeline checkpoint to {args.out}")


if __name__ == "__main__":
    main()
