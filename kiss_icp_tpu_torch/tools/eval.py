"""Multi-sequence evaluation harness.

Port of the JAX package's `tools/eval.py`, itself the equivalent of the
reference's notebook harness (eval/kiss_icp_eval.py:41-109): run the port's
pipeline over a set of sequences, aggregate per-sequence metrics, render a
markdown table, and optionally plot trajectories:

    from kiss_icp_tpu_torch.tools.eval import run_sequence, print_metrics_table
    results = {}
    for seq in range(2):
        run_sequence(results, lambda s: SyntheticDataset(sequence=s), seq)
    print(print_metrics_table(results))

CLI: python -m kiss_icp_tpu_torch.tools.eval --dataloader synthetic --sequences 0 1
     [--device cpu]

The engine runs on the card unless `device` (`--device`) asks for the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np


def run_sequence(
    results: Dict,
    dataset_fn: Callable,
    sequence,
    config=None,
    n_scans: int = -1,
    device=None,
) -> Dict:
    """Run one sequence, store metrics + trajectories in `results[seq]`
    (reference kiss_icp_eval.py:41-67)."""
    from kiss_icp_tpu_torch.pipeline import OdometryPipeline

    dataset = dataset_fn(sequence)
    pipeline = OdometryPipeline(dataset, config=config, n_scans=n_scans, device=device)
    seq_results = pipeline.run()
    results[str(sequence)] = {
        "metrics": seq_results.as_dict_with_units(),
        "poses": pipeline.poses,
        "gt_poses": pipeline.gt_poses,
    }
    return results


def print_metrics_table(results: Dict) -> str:
    """Markdown metrics table over sequences (kiss_icp_eval.py:70-75)."""
    if not results:
        return "(no results)"
    metric_names = sorted(
        {name for r in results.values() for name in r["metrics"]}
    )
    lines = ["| Sequence | " + " | ".join(metric_names) + " |"]
    lines.append("|" + "---|" * (len(metric_names) + 1))
    # Numeric-aware row order: '10' after '9', not after '1'.
    def _seq_key(item):
        s = str(item[0])
        return (0, int(s)) if s.isdigit() else (1, s)

    for seq, r in sorted(results.items(), key=_seq_key):
        cells = [
            f"{r['metrics'][m]:.3f}" if m in r["metrics"] else "-"
            for m in metric_names
        ]
        lines.append(f"| {seq} | " + " | ".join(cells) + " |")
    avgs = []
    for m in metric_names:
        vals = [r["metrics"][m] for r in results.values() if m in r["metrics"]]
        avgs.append(f"{np.mean(vals):.3f}" if vals else "-")
    lines.append("| **avg** | " + " | ".join(avgs) + " |")
    return "\n".join(lines)


def plot_trajectories(results: Dict, out_dir: Optional[Path] = None):
    """Top-down trajectory plots, one png per sequence (est vs GT), when
    matplotlib is available (reference uses evo, kiss_icp_eval.py:78-109)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping trajectory plots")
        return
    out_dir = Path(out_dir or "eval_plots")
    out_dir.mkdir(parents=True, exist_ok=True)
    for seq, r in results.items():
        fig, ax = plt.subplots(figsize=(6, 6))
        est = r["poses"]
        ax.plot(est[:, 0, 3], est[:, 1, 3], label="estimate")
        if r.get("gt_poses") is not None:
            gt = r["gt_poses"]
            ax.plot(gt[:, 0, 3], gt[:, 1, 3], "--", label="ground truth")
        ax.set_aspect("equal")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.legend()
        ax.set_title(f"sequence {seq}")
        fig.savefig(out_dir / f"trajectory_{seq}.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Multi-sequence evaluation")
    parser.add_argument("--dataloader", default="synthetic")
    parser.add_argument("--data", type=Path, default=Path("."))
    parser.add_argument("--sequences", nargs="+", default=["0"])
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--n-scans", type=int, default=-1)
    parser.add_argument("--plots", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    from kiss_icp_tpu_torch.datasets import dataset_factory

    results: Dict = {}
    for seq in args.sequences:
        run_sequence(
            results,
            lambda s: dataset_factory(args.dataloader, args.data, s),
            seq,
            config=args.config,
            n_scans=args.n_scans,
            device=args.device,
        )
    print(print_metrics_table(results))
    if args.plots:
        plot_trajectories(results)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
