"""kiss_icp_tpu_torch_pipeline CLI: a whole drive, from the data to the result files.

The port of the JAX package's `tools/cmd.py` (itself the reference typer CLI,
python/kiss_icp/tools/cmd.py:89-235): the same flags, validation and return
codes, built on argparse, plus `--device` (default `cuda`: the port runs on
the GPU unless asked for the CPU). Entry points:
  * `python -m kiss_icp_tpu_torch.tools.cmd <data> [--device cpu]` or the
    console script `kiss_icp_tpu_torch_pipeline`
  * `kiss_icp_tpu_torch_dump_config` -> `dump_config()`
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kiss_icp_tpu_torch.datasets import (
    available_dataloaders,
    dataset_factory,
    guess_dataloader,
    jumpable_dataloaders,
    sequence_dataloaders,
)
from kiss_icp_tpu_torch.version import __version__


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kiss_icp_tpu_torch_pipeline",
        description="KISS-ICP LiDAR odometry pipeline, PyTorch + CUDA",
    )
    p.add_argument("data", type=Path, nargs="?", help="Path to the dataset")
    p.add_argument("--dataloader", "-d", choices=available_dataloaders(),
                   help="Format of the dataset (guessed from the path if omitted)")
    p.add_argument("--config", "-c", type=Path, default=None,
                   help="Path to a YAML configuration file")
    p.add_argument("--sequence", "-s", default=None,
                   help="Sequence id (for kitti/kitti_raw/nuscenes/helipr)")
    p.add_argument("--topic", "-t", default=None,
                   help="Point cloud topic (for rosbag/mcap)")
    p.add_argument("--n-scans", "-n", type=int, default=-1,
                   help="Number of scans to process (default: all)")
    p.add_argument("--jump", "-j", type=int, default=0,
                   help="Start processing at this frame")
    p.add_argument("--max-range", type=float, default=None,
                   help="Override config max_range")
    p.add_argument("--deskew", action="store_true", default=None,
                   help="Force motion deskewing on")
    p.add_argument("--meta", type=Path, default=None,
                   help="Metadata file (ouster pcap)")
    p.add_argument("--visualize", "-v", action="store_true",
                   help="Open the interactive visualizer (not ported yet)")
    p.add_argument("--profile", type=Path, default=None, metavar="DIR",
                   help="Write a host and device trace (torch.profiler, "
                        "Chrome format) to DIR/trace.json for Perfetto")
    p.add_argument("--resume-from", type=Path, default=None, metavar="CKPT",
                   help="Resume from a checkpoint.npz (pair with --jump to "
                        "skip the frames it already covers)")
    p.add_argument("--save-checkpoint", action="store_true",
                   help="Write checkpoint.npz (full odometry state incl. the "
                        "local map) into the results dir at the end")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="Also write checkpoint.npz every N frames (atomic; "
                        "crash recovery via --resume-from + --jump)")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default: cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--version", action="version",
                   version=f"kiss_icp_tpu_torch {__version__}")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.data is None:
        print("[ERROR] Missing data path argument", file=sys.stderr)
        return 2
    if args.visualize:
        raise NotImplementedError(
            "--visualize: the interactive visualizer is not ported yet "
            "(ROADMAP item 17)")

    dataloader = args.dataloader or guess_dataloader(args.data) or "generic"

    # Validation mirroring the reference (cmd.py:203-213).
    if dataloader in sequence_dataloaders() and args.sequence is None:
        print(f"[ERROR] Missing --sequence option for '{dataloader}' dataset",
              file=sys.stderr)
        return 2
    if args.jump != 0 and dataloader not in jumpable_dataloaders():
        print(f"[ERROR] '{dataloader}' does not support --jump", file=sys.stderr)
        return 2

    try:
        # Keywords only: loaders name their second parameter differently
        # (sequence/topic/meta) and every loader swallows unused keywords,
        # so keyword passing can never collide with a positional binding
        # (a positional sequence-or-topic arg made rosbag/mcap/ouster raise
        # "got multiple values for argument").
        dataset = dataset_factory(
            dataloader,
            args.data,
            sequence=args.sequence,
            topic=args.topic,
            meta=args.meta,
        )
    except (FileNotFoundError, ImportError, ValueError) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1

    from kiss_icp_tpu_torch.pipeline import OdometryPipeline

    pipeline = OdometryPipeline(
        dataset,
        config=args.config,
        max_range=args.max_range,
        deskew=args.deskew,
        n_scans=args.n_scans,
        jump=args.jump,
        profile_dir=args.profile,
        resume_from=args.resume_from,
        save_checkpoint=args.save_checkpoint,
        checkpoint_every=args.checkpoint_every,
        device=args.device,
    )
    pipeline.run()
    pipeline.print_()
    return 0


def dump_config(argv=None) -> int:
    """Write the default configuration to ./kiss_icp_tpu_torch.yml
    (reference `kiss_icp_dump_config`, pyproject.toml:72)."""
    from kiss_icp_tpu_torch.config.parser import load_config, write_config

    out = Path("kiss_icp_tpu_torch.yml")
    write_config(load_config(None), out)
    print(f"Wrote default config to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
