"""Offline artifact-build CLI: models + weights -> one serving artifact (the
port of the JAX package's `cli/export_artifact.py`).

The deployable unit is one directory holding the fused det + pose +
proportions program exported with `torch.export` (its weights inside) and
`meta.json` (`pipeline/export.py`):

  python -m human_body_proportion_estimation_tpu_torch.cli.export_artifact \\
      --detector efficientdet_lite4 --batch-size 16 --out /path/to/artifact

  python -m human_body_proportion_estimation_tpu_torch.serve.server \\
      --artifact-dir /path/to/artifact

The serving side (`pipeline/export.ArtifactPipeline`) restores and runs it
without building a model. The program is exported on the GPU and serves
there; `--cpu` exports an f32 program for the CPU instead. The JAX flags,
plus `--cpu`. `--detector ssd_mobilenet` (the JAX default) bakes in the
real weights of the reference's ssd.tflite, and exits 2 naming the file
when it is absent; `--checkpoint-dir` reads an Orbax checkpoint
(`models/orbax_store`), of which the SSD slot takes only the pose side, as
in JAX.
"""

from __future__ import annotations

import argparse

from human_body_proportion_estimation_tpu_torch.utils import compile_cache


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, option for option, and `--cpu`."""
    parser = argparse.ArgumentParser(
        description="Export the fused serving pipeline as a deployable "
                    "artifact (torch.export program + meta.json)"
    )
    parser.add_argument(
        "--detector", default="ssd_mobilenet",
        choices=["efficientdet_lite4", "efficientdet_lite0",
                 "ssd_mobilenet", "yolov5s", "yolov5m"],
        help="detector slot baked into the fused program (default "
             "ssd_mobilenet, as the JAX CLI: the real weights of the "
             "reference's ssd.tflite, exits 2 naming the file when it is "
             "absent); efficientdet_lite4 carries the committed "
             "synthetic-certified weights, the other slots a random "
             "detector",
    )
    parser.add_argument("--checkpoint-dir", default=None,
                        help="orbax checkpoint dir with det/pose params")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="fixed batch size of the exported program")
    parser.add_argument(
        "--bottom-up", action="store_true",
        help="export the bottom-up pipeline instead (HigherHRNet + AE "
             "grouping, no detector); --detector is ignored",
    )
    parser.add_argument("--out", required=True,
                        help="output artifact directory")
    compile_cache.add_flags(parser)
    parser.add_argument("--cpu", action="store_true",
                        help="export an f32 program for the CPU (the "
                             "artifact then serves on the CPU only)")
    return parser


def main(argv=None):
    from human_body_proportion_estimation_tpu_torch.cli.common import (
        checkpoint_states,
        exit_on_problems,
        option_problems,
    )

    args = build_parser().parse_args(argv)
    exit_on_problems(option_problems(args.detector,
                                     bottom_up=args.bottom_up))

    import torch

    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        export_serving_artifact,
    )
    compile_cache.apply_flags(args)
    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float32 if args.cpu else torch.bfloat16

    if args.bottom_up:
        from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (  # noqa: E501
            build_default,
        )

        pose_state = (checkpoint_states(args.checkpoint_dir)[1]
                      if args.checkpoint_dir else None)
        pipeline = build_default(device=device, dtype=dtype,
                                 pose_state=pose_state)
        if pipeline.weights_origin["pose"] == "random":
            print(
                "WARNING: exporting RANDOM-INIT HigherHRNet — the artifact "
                "will serve garbage (recorded in meta.json weights_origin)",
                flush=True,
            )
        d = export_serving_artifact(pipeline, args.out,
                                    batch_size=args.batch_size)
        print(f"exported bottom-up serving artifact to {d} "
              f"(batch_size={args.batch_size})")
        return

    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )

    # --checkpoint-dir's slots, else the certified fallback: the committed
    # checkpoint fills the pose slot, and the detector slot for
    # efficientdet_lite4; the SSD serves the tflite's; others are random
    det_state = pose_state = None
    if args.checkpoint_dir:
        det_state, pose_state = checkpoint_states(args.checkpoint_dir,
                                                  args.detector)
    pipeline = InferencePipeline(device=device, dtype=dtype,
                                 detector=args.detector, det_state=det_state,
                                 pose_state=pose_state)
    if "random" in pipeline.weights_origin.values():
        print(
            "WARNING: exporting RANDOM-INIT weights for "
            + ", ".join(k for k, v in pipeline.weights_origin.items()
                        if v == "random")
            + " — the artifact will serve garbage for that slot "
              "(recorded in meta.json weights_origin)",
            flush=True,
        )
    d = export_serving_artifact(pipeline, args.out,
                                batch_size=args.batch_size)
    print(f"exported serving artifact to {d} "
          f"(detector={args.detector}, batch_size={args.batch_size})")


if __name__ == "__main__":
    main()
