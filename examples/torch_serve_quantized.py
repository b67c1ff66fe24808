"""End-to-end serving example on the PyTorch/CUDA port: batched requests
against a quantized model (the counterpart of
``examples/serve_quantized.py``).

Run:  PYTHONPATH=src python examples/torch_serve_quantized.py
      PYTHONPATH=src python examples/torch_serve_quantized.py --precision 1x1
      PYTHONPATH=src python examples/torch_serve_quantized.py --device cpu

Serves the paper's PE menu over the same request batch through the serving
CLI (``repro_torch.launch.serve``: a ``ServingConfig``-built continuous
batcher) and prints each run's weight storage and latency.  Runs on the
card unless ``--device cpu`` is passed.
"""
import argparse

from repro_torch.launch import serve as serve_launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default=None,
                    help="single config; default sweeps the menu")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu")
    args = ap.parse_args(argv)

    menu = [args.precision] if args.precision else ["8x8", "8xT", "4x4", "2xT"]
    for prec in menu:
        print(f"\n=== precision {prec} ===")
        serve_launcher.main([
            "--arch", "smollm-135m", "--reduced", "--precision", prec,
            "--kv-bits", "8", "--requests", str(args.requests),
            "--prompt-len", "32", "--gen", str(args.gen),
            "--device", args.device,
        ])


if __name__ == "__main__":
    main()
