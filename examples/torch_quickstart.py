"""Quickstart on the PyTorch/CUDA port — the paper's precision knob in five
steps (the counterpart of ``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py               # the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

On the card every packed matmul, quantizer and attention runs through the
hand-written CUDA kernels (built with nvcc at first use); on the CPU their
plain PyTorch versions run.  The forward of step 3 runs the packed serving
form; ``examples/torch_train_qat.py`` trains the fake-quant (QAT) form.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import PAPER_CONFIGS, fuse_bns, reference_bn_scale
from repro_torch.kernels import engine
from repro_torch.models import build_model, reduce_for_smoke, to_serving
from repro_torch.models.convert import serving_param_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to run the plain PyTorch versions)")
    device = torch.device(args.device)

    # 1. pick an architecture and a PE config from the paper's menu (Table II)
    cfg = reduce_for_smoke(get_config("smollm-135m", precision="2xT",
                                      kv_bits=8))
    print(f"arch={cfg.name}  precision={cfg.precision} (2-bit activations x "
          f"ternary weights — the Arria 10 PoC config), device={device}")

    # 2. init, then convert to the serving form: weights quantize + bit-pack
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    sparams = to_serving(params, cfg, tp=1)
    print(f"serving form: {serving_param_bytes(params)/1e6:.2f} MB -> "
          f"{serving_param_bytes(sparams)/1e6:.2f} MB packed")

    # 3. a forward and the next-token loss through the packed kernels
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))).to(device)
    batch = {"tokens": tokens, "labels": tokens}
    engine.reset_launch_counts()
    logits, _ = model.forward(sparams, batch)
    print(f"serving-form forward: logits {tuple(logits.shape)}, loss "
          f"{float(model.loss(sparams, batch)):.3f}; kernel launches "
          f"{ {k: v for k, v in engine.launch_counts().items() if v} }")

    # 4. the BNS fold itself, in isolation (paper §III.A)
    acc = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    mean, var = torch.zeros(8), torch.ones(8)
    scale, shift, alpha = (torch.full((8,), 2.0), torch.full((8,), -1.0),
                           torch.full((8,), 0.5))
    fused = fuse_bns(mean, var, 1e-5, scale, shift, alpha=alpha)
    ref = reference_bn_scale(acc, mean, var, 1e-5, scale, shift, alpha=alpha)
    print(f"BNS fusion max err: "
          f"{float((acc * fused.gamma + fused.beta - ref).abs().max()):.2e}")

    # 5. serve: prefill a prompt, decode greedily with the int8 KV cache
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(device)
    logits, cache = model.prefill(sparams, {"tokens": prompt}, 24)
    tok = logits[:, -1:].argmax(-1)
    for i in range(4):
        logits, cache = model.decode_step(sparams, tok, cache, 16 + i)
        tok = logits[:, -1:].argmax(-1)
    print(f"decoded tokens: {tok.reshape(-1).tolist()}  (finite: "
          f"{bool(torch.isfinite(logits).all())})")
    print("\nPE menu available:", ", ".join(sorted(PAPER_CONFIGS)))


if __name__ == "__main__":
    main()
