"""The card against the CPU: loss and every parameter's gradient of one
train-mode forward and backward from the same weights, with dropout 0.

    python -m pointcloudlib_tpu_torch.tools.grad_check \
        [--model pointnet2|pointnet2_msg] [--clouds 8 ...] [--seeds 5 ...] \
        [--n-points 1024] [--jitter REL]

On the card the model runs the hand-written kernels with bf16 dense
operands, on the CPU their plain versions with f32 dense layers. The
bounds are fixed (:data:`LOSS_RTOL`, :data:`GRAD_COS`,
:data:`GRAD_NORM`): a last-bit difference can move a max-pool's winner and
reroute that point's gradient, so the gradients agree in direction and
size, not element by element. MSG's norm bound is wider than SSG's: the
BN scales of its narrow scales (32 to 64 channels, k = 16 or 32) are what
is left of sums that mostly cancel under the next train-mode BatchNorm,
and their norms move by up to 19 % between the card and the CPU.

Two kinds of gradient are not compared, because they are exactly 0 in
exact arithmetic and hold rounding residue:

* one whose CPU norm is below :data:`FLOOR` of the largest gradient's
  (SA3's last BN bias when the head's train-mode BatchNorm removes its
  shift);
* the last BN bias of a fused set abstraction whose every pooled output
  is positive in the CPU run: ReLU then clips nothing, so the bias shifts
  every output of its channel by the same amount, and the next layer's
  train-mode BatchNorm removes that shift. Both sides must hold it below
  :data:`CANCELLED_NORM` of the largest gradient's norm.

``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` call
:func:`grad_agreement`. The command line prints one JSON line per seed
and cloud count (synthetic surface clouds, seeded random weights) with
the worst cosine and norm ratio; it needs a CUDA device unless ``--jitter
REL`` is given, which compares the CPU with itself after every weight is
scaled by ``1 + REL·N(0, 1)`` instead: how far the gradients move under a
change the size of a rounding error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import torch

from pointcloudlib_tpu_torch.data.synthetic import SyntheticModelNet
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.nn.layers import FusedSetAbstraction
from pointcloudlib_tpu_torch.train import soft_cross_entropy
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

# Measured on an H100 at N=1024 (this tool over seeds 5 to 8 and 8, 16 and
# 32 clouds, and the card test's sphere-shell clouds): SSG cosine ≥ 0.925,
# norms within 10.4 %; MSG cosine ≥ 0.890, norms within 19.1 %.
LOSS_RTOL, GRAD_COS = 1e-2, 0.85
GRAD_NORM = {"pointnet2": 0.15, "pointnet2_msg": 0.25}
FLOOR, CANCELLED_NORM = 1e-6, 1e-3


def loss_and_grads(name: str, variables, batch: Dict[str, torch.Tensor],
                   dev: torch.device, jitter: float = 0.0
                   ) -> Tuple[float, Dict[str, torch.Tensor], set]:
    """``(loss, gradients, cancelled)`` of one train-mode forward and
    backward of model ``name`` on ``dev`` with dropout 0. ``cancelled``
    names the last BN bias of every fused set abstraction whose pooled
    output was positive throughout. ``jitter`` scales every weight by
    ``1 + jitter·N(0, 1)`` first."""
    model = get_cls_model(name, dropout=0.0)
    from_jax_variables(model, variables)
    if jitter:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + jitter * torch.randn(p.shape, generator=g))
    model = model.to(dev).train()
    cancelled = set()

    def note(layer):
        def hook(_module, _inputs, output):
            if bool((output[1] > 0).all()):
                cancelled.add(f"{layer}.bn3_bias")
        return hook

    for layer, module in model.named_modules():
        if isinstance(module, FusedSetAbstraction):
            module.register_forward_hook(note(layer))
    logits = model(batch["xyz"].to(dev), batch["feats"].to(dev))
    loss = soft_cross_entropy(logits, batch["label"].to(dev))
    loss.backward()
    return loss.item(), {k: p.grad.double().cpu() for k, p in
                         model.named_parameters()}, cancelled


def _cos_ratio(a: torch.Tensor, b: torch.Tensor) -> Tuple[float, float]:
    return (float(a.ravel() @ b.ravel() / (a.norm() * b.norm())),
            float(a.norm() / b.norm()))


def grad_agreement(name: str, variables, batch: Dict[str, torch.Tensor],
                   dev: torch.device, jitter: float = 0.0) -> dict:
    """One forward and backward on ``dev`` and one on the CPU (or, with
    ``jitter``, on the CPU with jittered weights and on the CPU). Returns
    ``loss`` and ``loss_cpu``, ``agree`` (parameter → ``(cosine, norm
    ratio)`` against the CPU's gradient), ``not_compared`` (parameter →
    why, and its norm on both sides relative to the largest gradient's)
    and ``failures``, one sentence per bound that does not hold."""
    cpu = torch.device("cpu")
    loss, grads, _ = loss_and_grads(name, variables, batch, dev, jitter)
    loss_cpu, grads_cpu, cancelled = loss_and_grads(name, variables, batch,
                                                    cpu)
    largest = max(float(g.norm()) for g in grads_cpu.values())
    agree, not_compared, failures = {}, {}, []
    if abs(loss - loss_cpu) > LOSS_RTOL * abs(loss_cpu):
        failures.append(f"loss {loss} against the CPU's {loss_cpu}")
    for k, g in grads_cpu.items():
        rel = float(g.norm()) / largest, float(grads[k].norm()) / largest
        if rel[0] <= FLOOR:
            not_compared[k] = {"why": f"below {FLOOR} of the largest",
                               "norm_cpu": rel[0], "norm": rel[1]}
        elif k in cancelled:
            not_compared[k] = {
                "why": "every pooled output positive: the next train-mode "
                       "BatchNorm removes the shift",
                "norm_cpu": rel[0], "norm": rel[1]}
            if max(rel) > CANCELLED_NORM:
                failures.append(f"cancelled gradient of {k}: norms {rel} of "
                                f"the largest, above {CANCELLED_NORM}")
        else:
            cos, ratio = agree[k] = _cos_ratio(grads[k], g)
            if cos < GRAD_COS or abs(ratio - 1) > GRAD_NORM[name]:
                failures.append(f"gradient of {k}: cosine {cos}, norm "
                                f"ratio {ratio}")
    return {"loss": loss, "loss_cpu": loss_cpu, "agree": agree,
            "not_compared": not_compared, "failures": failures}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="pointnet2_msg",
                    choices=["pointnet2", "pointnet2_msg"])
    ap.add_argument("--clouds", type=int, nargs="+", default=[8])
    ap.add_argument("--seeds", type=int, nargs="+", default=[5])
    ap.add_argument("--n-points", type=int, default=1024)
    ap.add_argument("--jitter", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.jitter:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        sys.exit("grad_check: needs a CUDA device (or --jitter)")
    variables = random_jax_variables(get_cls_model(args.model), seed=0)
    failed = False
    for seed in args.seeds:
        for clouds in args.clouds:
            xyz, normals, labels = SyntheticModelNet(
                n_points=args.n_points, size=clouds, seed=seed
            ).batch(0, clouds)
            batch = {"xyz": torch.from_numpy(xyz),
                     "feats": torch.from_numpy(normals),
                     "label": torch.from_numpy(labels).long()}
            got = grad_agreement(args.model, variables, batch, dev,
                                 args.jitter)
            agree = got.pop("agree")
            cosines = sorted(c for c, _ in agree.values())
            failed |= bool(got["failures"]) and not args.jitter
            print(json.dumps({
                "model": args.model, "device": str(dev), "seed": seed,
                "clouds": clouds, "n_points": args.n_points,
                "jitter": args.jitter, "compared": len(agree),
                "worst_cos": min(agree.items(), key=lambda kv: kv[1][0]),
                "median_cos": cosines[len(cosines) // 2],
                "below_0.97": sum(c < 0.97 for c in cosines),
                "worst_norm_ratio": max(agree.items(),
                                        key=lambda kv: abs(kv[1][1] - 1)),
                **got}), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
