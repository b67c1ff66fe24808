"""The paper's Fig. 6 mechanism on the PyTorch/CUDA port: widening buys back
QAT accuracy (the counterpart of ``examples/widening_tradeoff.py``).

Run:  PYTHONPATH=src python examples/torch_widening_tradeoff.py --device cpu
                                                   [--steps 250]

Trains the same tiny LM three ways on the synthetic corpus:
    fp32 1x-wide     (the paper's baseline)
    2xT  1x-wide     (quantized: loses quality)
    2xT  2x-wide     (quantized + WRPN widening: recovers)
and prints each point with its MODELED Stratix-10 throughput from the
paper's performance model (``repro_torch.core.pe_model``) — the
accuracy/throughput frontier of Fig. 6.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import pe_model as pm
from repro_torch.core.widening import widen_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.optim import make_optimizer


def _on(batch, device):
    return {k: torch.from_numpy(v).to(device, torch.int64)
            for k, v in batch.items()}


def train_eval(cfg, steps, device, seed=0):
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=3e-3)
    params = model.init(torch.Generator().manual_seed(seed), device)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8)
    eval_data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=16,
                            seed=123)
    for _ in range(steps):
        params, opt_state, _ = step(params, opt_state, _on(next(data), device))
    with torch.no_grad():
        return float(model.loss(params, _on(next(eval_data), device)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to train on the host)")
    device = torch.device(args.device)

    base = reduce_for_smoke(get_config("smollm-135m"))
    runs = [
        ("fp32 1x", dataclasses.replace(base, precision="fp32"),
         pm.fp32_images_per_sec(pm.STRATIX10, pm.GOPS["alexnet"])),
        ("2xT  1x", dataclasses.replace(base, precision="2xT"),
         pm.images_per_sec(pm.TABLE4_PE[("2", "T")], pm.STRATIX10,
                           pm.GOPS["alexnet"], 1.0)),
        ("2xT  2x", widen_config(dataclasses.replace(base, precision="2xT"),
                                 2.0),
         pm.images_per_sec(pm.TABLE4_PE[("2", "T")], pm.STRATIX10,
                           pm.GOPS["alexnet"], 2.0)),
    ]
    results = []
    for name, cfg, modeled in runs:
        loss = train_eval(cfg, args.steps, device)
        results.append((name, loss, modeled))
        print(f"{name}: eval_loss={loss:.4f}  "
              f"modeled S10 throughput={modeled:,.0f} img/s-equiv")

    fp32_loss, q1, q2 = (r[1] for r in results)
    print(f"\nquantization gap (2xT 1x vs fp32): {q1 - fp32_loss:+.4f}")
    print(f"after 2x widening:                  {q2 - fp32_loss:+.4f}")
    if q2 < q1:
        print("=> widening recovered quality while the modeled throughput "
              "remains above the fp32 baseline — the paper's Fig. 6 frontier.")
    else:
        print("NOTE: widening did not help at this scale/step budget "
              "(rerun with more --steps).")
    return results


if __name__ == "__main__":
    main()
