"""QAT end-to-end on the PyTorch/CUDA port: train a small LM at a paper
precision and watch the loss (the counterpart of ``examples/train_qat.py``).

Run:  PYTHONPATH=src python examples/torch_train_qat.py               # the card
      PYTHONPATH=src python examples/torch_train_qat.py --device cpu  # the host
                                       [--precision 2xT] [--steps 300]

Uses the full training stack (``ElasticTrainer`` + checkpoints + straggler
monitor + the synthetic data pipeline, through ``repro_torch.launch.train``)
at reduced scale, so it runs on the CPU in about a minute.  The straight-
through fake-quant forms train; packed with ``models.to_serving``, the
trained weights serve through the kernels.
"""
import argparse
import sys
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="2xT")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="repro_torch_qat_") as ckpt_dir:
        losses = train_launcher.main([       # a fresh run every time
            "--arch", "smollm-135m", "--reduced", "--precision",
            args.precision, "--steps", str(args.steps), "--batch", "8",
            "--seq", "64", "--lr", "3e-3", "--save-every", "100",
            "--ckpt-dir", ckpt_dir, "--device", args.device,
        ])
    w = min(25, max(len(losses) // 4, 1))
    first = sum(losses[:w]) / w
    means = [sum(losses[i:i + w]) / w for i in range(0, len(losses) - w + 1)]
    best = min(means)
    last = means[-1]
    print(f"\nQAT @ {args.precision}: loss first {first:.3f} -> "
          f"best-window {best:.3f} (last {last:.3f}) over {len(losses)} steps")
    if best >= first - 0.05:
        print("WARNING: no measurable improvement (QAT at tiny scale is "
              "noisy; try more --steps)", file=sys.stderr)
        sys.exit(1)
    return losses


if __name__ == "__main__":
    main()
