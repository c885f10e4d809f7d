"""The card against the CPU: loss and every parameter's gradient of one
train-mode forward and backward from the same weights, with dropout 0.

    python -m pointcloudlib_tpu_torch.tools.grad_check \
        [--model pointnet|pointnet_partseg|pointnet2|pointnet2_msg|
                 pointnet2_partseg|dgcnn|dgcnn_partseg|pointconv|
                 pointconv_partseg|pointcnn|pointcnn_partseg|kpconv|
                 kpconv_deform] \
        [--clouds 8 ...] [--seeds 5 ...] [--n-points N] [--jitter REL]

On the card the model runs the hand-written kernels with bf16 dense
operands (PointNet's, PointConv's, PointCNN's and KPConv's Dense layers
in f32), on the CPU their plain versions with f32 dense layers. KPConv
builds its pyramid at the shapes ``bench.py`` calibrates on the batch's
clouds (:func:`model_kwargs`), the same on both sides. The
bounds are fixed (:data:`LOSS_RTOL`, :data:`GRAD_COS`,
:data:`GRAD_NORM`): a last-bit difference can move a max-pool's winner and
reroute that point's gradient, so the gradients agree in direction and
size, not element by element. MSG's norm bound is wider than SSG's: the
BN scales of its narrow scales (32 to 64 channels, k = 16 or 32) are what
is left of sums that mostly cancel under the next train-mode BatchNorm,
and their norms move by up to 19 % between the card and the CPU.

Three kinds of gradient are not compared, because they are exactly 0 in
exact arithmetic and hold rounding residue:

* one whose CPU norm is below :data:`FLOOR` of the largest gradient's
  (SA3's last BN bias when the head's train-mode BatchNorm removes its
  shift);
* the last BN bias of a fused set abstraction whose every pooled output
  is positive in the CPU run: ReLU then clips nothing, so the bias shifts
  every output of its channel by the same amount, and the next layer's
  train-mode BatchNorm removes that shift;
* the Dense bias of a ``DenseBNAct`` (part segmentation's head, DGCNN's
  ``fc2``, every PointConv ``DensityNet`` and ``WeightNet`` layer and
  PointConv's head), of a PointConv layer's output Dense or of a PointCNN
  ``DenseBlock`` whose BatchNorm directly follows its Dense: its own
  train-mode BatchNorm removes the shift;
* the BN bias of PointNet part segmentation's ``conv5`` (BatchNorm
  without an activation): it shifts every point's map and the global max
  of it by the same amount, which the head's first train-mode BatchNorm
  removes;
* the BN bias of DGCNN part segmentation's ``conv6`` when every cloud's
  global max of it is positive in the CPU run: the bias then moves every
  max by the same amount, which reaches the decoder as a constant of all
  clouds and points, and the decoder's first train-mode BatchNorm
  removes it.

KPConv's layer types make no gradient 0 by their structure: its Dense
layers have no bias, and every bias sits after a normalisation or where
no train-mode BatchNorm follows (:func:`cancelled_by_structure` names
none of its parameters).

The last three must stay below :data:`CANCELLED_NORM` of the largest
gradient's norm on both sides. One more is held to the cosine bound
alone, its norm ratio not bounded: the Dense weight of a PointConv
``DensityNet``'s first layer. Its one input is the KDE density, nearly
constant over the points, and its train-mode BatchNorm leaves it a part
only through the BN epsilon, so its gradient Σᵢ dyᵢ·xᵢ, with dy summing
to 0, is what rounding leaves of a cancellation: on the CPU alone its
norm moves by 7.6 % under a 1e-6 weight jitter (part segmentation's
``fp2``, seed 5, ``--jitter 1e-6``), while its direction holds.

``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` call
:func:`grad_agreement`. ``pointnet2_partseg`` is PointNet++ part
segmentation with xyz as features, ``pointnet_partseg``,
``dgcnn_partseg``, ``pointconv_partseg`` and ``pointcnn_partseg``
PointNet, DGCNN, PointConv and PointCNN part segmentation on xyz alone,
all with plain per-point cross entropy; the classification models take
the label-smoothed loss, with normals as features where their bench rows
take them (:data:`NORMALS`), else xyz alone. The
command line prints one JSON line per seed and cloud count (synthetic
surface clouds, seeded random weights; N defaults to 1024, 2048 for part
segmentation) with the worst cosine and norm ratio; it needs a CUDA device unless ``--jitter
REL`` is given, which compares the CPU with itself after every weight is
scaled by ``1 + REL·N(0, 1)`` instead: how far the gradients move under a
change the size of a rounding error. :func:`model_grads` and
:func:`compare_grads` are the two halves of :func:`grad_agreement`, for
a caller that builds the models itself (``tools/dense_precision.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import torch

import numpy as np

from pointcloudlib_tpu_torch.data.synthetic import (
    SyntheticModelNet,
    SyntheticShapeNetPart,
)
from pointcloudlib_tpu_torch.models import get_cls_model, get_seg_model
from pointcloudlib_tpu_torch.models.dgcnn import DGCNNPartSeg
from pointcloudlib_tpu_torch.models.pointcnn import DenseBlock
from pointcloudlib_tpu_torch.models.pointconv import (
    DensityNet,
    PointConvInterp,
    PointConvSA,
)
from pointcloudlib_tpu_torch.models.pointnet import PointNetPartSeg
from pointcloudlib_tpu_torch.models.pointnet2 import N_CATEGORIES
from pointcloudlib_tpu_torch.nn.layers import DenseBNAct, FusedSetAbstraction
from pointcloudlib_tpu_torch.train import cross_entropy_seg, soft_cross_entropy
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

# Measured on an H100 at N=1024 (this tool over seeds 5 to 8 and 8, 16 and
# 32 clouds, and the card test's sphere-shell clouds): SSG cosine ≥ 0.925,
# norms within 10.4 %; MSG cosine ≥ 0.890, norms within 19.1 %. Part
# segmentation at N=2048 on 8 synthetic ShapeNet-part-shaped clouds
# (chip_smoke.py and the card test): cosine ≥ 0.956, norms within 9.1 %.
# DGCNN at N=1024 (this tool at seeds 5 to 7 on 8 and 16 clouds,
# chip_smoke.py and the card test): cosine ≥ 0.955, norms within 10.4 %.
# PointNet (every Dense f32) and PointCNN at seeds 5 and 6 on 8 clouds
# (N=1024; part segmentation N=2048; an NVIDIA H100 80GB HBM3 at 700 W):
# cosine ≥ 0.99996 and ≥ 0.9995, norms within 0.18 % and 1.3 %.
LOSS_RTOL, GRAD_COS = 1e-2, 0.85
GRAD_NORM = {"pointnet": 0.15, "pointnet_partseg": 0.15,
             "pointnet2": 0.15, "pointnet2_msg": 0.25,
             "pointnet2_partseg": 0.15, "dgcnn": 0.15,
             "dgcnn_partseg": 0.15, "pointconv": 0.15,
             "pointconv_partseg": 0.15, "pointcnn": 0.15,
             "pointcnn_partseg": 0.15, "kpconv": 0.15,
             "kpconv_deform": 0.15}
FLOOR, CANCELLED_NORM = 1e-6, 1e-3
# the part-segmentation models by this tool's name -> the seg registry's
SEG = {"pointnet_partseg": "pointnet", "pointnet2_partseg": "pointnet2",
       "dgcnn_partseg": "dgcnn", "pointconv_partseg": "pointconv",
       "pointcnn_partseg": "pointcnn"}
# the classification models whose bench rows take normals as features
# (bench.py:333-346)
NORMALS = ("pointnet2", "pointnet2_msg", "pointconv")
KPCONV = ("kpconv", "kpconv_deform")


def build_model(name: str, **kw) -> torch.nn.Module:
    """Model ``name``: a classification model, or one of :data:`SEG`."""
    return get_seg_model(SEG[name], **kw) if name in SEG else \
        get_cls_model(name, **kw)


def model_kwargs(name: str, xyz) -> Dict:
    """For a KPConv model, the pyramid shapes ``bench.py:129-155``
    calibrates on the clouds ``xyz [S, N, 3]`` (an array or a tensor on
    any device; calibrated on the CPU, the model's own architecture), as
    ``caps`` and ``neighborhood_limits``; for any other model none."""
    if name not in KPCONV:
        return {}
    from pointcloudlib_tpu_torch.models.kpconv.calibrate import (
        bench_calibration,
    )

    if torch.is_tensor(xyz):
        xyz = xyz.detach().cpu().numpy()
    arch = get_cls_model(name).cfg.architecture
    cal = bench_calibration(np.asarray(xyz, np.float32), arch, device="cpu")
    return {"caps": cal.caps, "neighborhood_limits": cal.neighborhood_limits}


def synthetic_batch(name: str, clouds: int, seed: int, n_points: int
                    ) -> Dict[str, torch.Tensor]:
    """A batch of labelled synthetic clouds for model ``name`` on the
    CPU: surface clouds and class labels, with normals as features for
    :data:`NORMALS`, or for :data:`SEG` ShapeNet-part-shaped clouds, the
    category one-hot and part labels, with xyz as features for
    PointNet++."""
    if name in SEG:
        xyz, labels, seg = SyntheticShapeNetPart(
            n_points=n_points, size=clouds, seed=seed).batch(0, clouds)
        x = torch.from_numpy(xyz)
        batch = {"xyz": x, "cls_onehot": torch.from_numpy(
                     np.eye(N_CATEGORIES, dtype=np.float32)[labels]),
                 "seg": torch.from_numpy(seg).long()}
        if name == "pointnet2_partseg":
            batch["feats"] = x
        return batch
    xyz, normals, labels = SyntheticModelNet(
        n_points=n_points, size=clouds, seed=seed).batch(0, clouds)
    batch = {"xyz": torch.from_numpy(xyz),
             "label": torch.from_numpy(labels).long()}
    if name in NORMALS:
        batch["feats"] = torch.from_numpy(normals)
    return batch


def cancelled_by_structure(model: torch.nn.Module) -> set:
    """Names of the parameters of ``model`` whose gradient its layers make
    0 in exact arithmetic on any data: the Dense bias of every
    ``DenseBNAct`` with one, of every PointConv layer's output Dense and
    of every PointCNN ``DenseBlock`` whose BatchNorm directly follows its
    Dense (its own train-mode BatchNorm removes the shift), and the BN
    bias of PointNet part segmentation's ``conv5`` (the head's first
    train-mode BatchNorm removes it)."""
    out = {"conv5.bn.bias"} if isinstance(model, PointNetPartSeg) else set()
    for layer, module in model.named_modules():
        if (isinstance(module, (PointConvSA, PointConvInterp))
                or isinstance(module, DenseBNAct)
                and module.dense.bias is not None
                or isinstance(module, DenseBlock)
                and module.bn is not None and not module.act_before_bn):
            out.add(f"{layer}.dense.bias")
    return out


def model_grads(model: torch.nn.Module, name: str,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[float, Dict[str, torch.Tensor], set, set]:
    """``(loss, gradients, cancelled, fragile)`` of one train-mode forward
    and backward of ``model`` (model ``name``, on its device, dropout 0)
    on ``batch``. ``cancelled`` names the last BN bias of every fused set
    abstraction whose pooled output was positive throughout, every
    ``DenseBNAct``'s Dense bias, every PointConv layer's output Dense bias,
    the Dense bias of every PointCNN ``DenseBlock`` with BatchNorm right
    after its Dense, PointNet part segmentation's ``conv5`` BN bias and
    DGCNN part segmentation's ``conv6`` BN bias where every global max
    of it was positive; ``fragile`` the first Dense weight of every
    PointConv ``DensityNet``."""
    model.train()
    dev = next(model.parameters()).device
    cancelled, fragile = set(), set()

    def note(layer):
        def hook(_module, _inputs, output):
            if bool((output[1] > 0).all()):
                cancelled.add(f"{layer}.bn3_bias")
        return hook

    def note_max(_module, _inputs, output):
        if bool((output.amax(dim=1) > 0).all()):
            cancelled.add("conv6.bn.bias")

    hooks = []
    if isinstance(model, DGCNNPartSeg):
        hooks.append(model.conv6.register_forward_hook(note_max))
    cancelled |= cancelled_by_structure(model)
    for layer, module in model.named_modules():
        if isinstance(module, FusedSetAbstraction):
            hooks.append(module.register_forward_hook(note(layer)))
        if isinstance(module, DensityNet):
            fragile.add(f"{layer}.0.dense.weight")
    put = {k: v.to(dev) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    if name in SEG:
        logits = model(put["xyz"], put["cls_onehot"], put.get("feats"))
        loss = cross_entropy_seg(logits, put["seg"])
    else:
        logits = model(put["xyz"], put.get("feats"))
        loss = soft_cross_entropy(logits, put["label"])
        reg = getattr(model, "aux", {}).get("reg_loss")
        if reg is not None:  # the deformable KPConv's, as the step adds
            loss = loss + reg
    loss.backward()
    for h in hooks:
        h.remove()
    return loss.item(), {k: p.grad.double().cpu() for k, p in
                         model.named_parameters()}, cancelled, fragile


def loss_and_grads(name: str, variables, batch: Dict[str, torch.Tensor],
                   dev: torch.device, jitter: float = 0.0
                   ) -> Tuple[float, Dict[str, torch.Tensor], set, set]:
    """:func:`model_grads` of model ``name`` built with dropout 0 (and
    KPConv's :func:`model_kwargs` for the batch) from ``variables`` on
    ``dev``. ``jitter`` scales every weight by ``1 + jitter·N(0, 1)``
    first."""
    model = build_model(name, dropout=0.0,
                        **model_kwargs(name, batch["xyz"]))
    from_jax_variables(model, variables)
    if jitter:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + jitter * torch.randn(p.shape, generator=g))
    return model_grads(model.to(dev), name, batch)


def _cos_ratio(a: torch.Tensor, b: torch.Tensor) -> Tuple[float, float]:
    return (float(a.ravel() @ b.ravel() / (a.norm() * b.norm())),
            float(a.norm() / b.norm()))


def compare_grads(name: str, got: tuple, cpu: tuple) -> dict:
    """:func:`model_grads`' ``got`` against the CPU's ``cpu`` under the
    bounds of model ``name``; the result of :func:`grad_agreement`."""
    loss, grads = got[:2]
    loss_cpu, grads_cpu, cancelled, fragile = cpu
    largest = max(float(g.norm()) for g in grads_cpu.values())
    agree, cosine_only, not_compared, failures = {}, {}, {}, []
    if abs(loss - loss_cpu) > LOSS_RTOL * abs(loss_cpu):
        failures.append(f"loss {loss} against the CPU's {loss_cpu}")
    for k, g in grads_cpu.items():
        rel = float(g.norm()) / largest, float(grads[k].norm()) / largest
        if k in cancelled:
            not_compared[k] = {
                "why": "a shift that a train-mode BatchNorm removes",
                "norm_cpu": rel[0], "norm": rel[1]}
            if max(rel) > CANCELLED_NORM:
                failures.append(f"cancelled gradient of {k}: norms {rel} of "
                                f"the largest, above {CANCELLED_NORM}")
        elif rel[0] <= FLOOR:
            not_compared[k] = {"why": f"below {FLOOR} of the largest",
                               "norm_cpu": rel[0], "norm": rel[1]}
        elif k in fragile:
            cos, _ = cosine_only[k] = _cos_ratio(grads[k], g)
            if cos < GRAD_COS:
                failures.append(f"gradient of {k}: cosine {cos}")
        else:
            cos, ratio = agree[k] = _cos_ratio(grads[k], g)
            if cos < GRAD_COS or abs(ratio - 1) > GRAD_NORM[name]:
                failures.append(f"gradient of {k}: cosine {cos}, norm "
                                f"ratio {ratio}")
    return {"loss": loss, "loss_cpu": loss_cpu, "agree": agree,
            "cosine_only": cosine_only, "not_compared": not_compared,
            "failures": failures}


def grad_agreement(name: str, variables, batch: Dict[str, torch.Tensor],
                   dev: torch.device, jitter: float = 0.0) -> dict:
    """One forward and backward on ``dev`` and one on the CPU (or, with
    ``jitter``, on the CPU with jittered weights and on the CPU). Returns
    ``loss`` and ``loss_cpu``, ``agree`` (parameter → ``(cosine, norm
    ratio)`` against the CPU's gradient), ``cosine_only`` (the same for
    the parameters held to the cosine bound alone), ``not_compared``
    (parameter → why, and its norm on both sides relative to the largest
    gradient's) and ``failures``, one sentence per bound that does not
    hold."""
    return compare_grads(
        name, loss_and_grads(name, variables, batch, dev, jitter),
        loss_and_grads(name, variables, batch, torch.device("cpu")))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="pointnet2_msg",
                    choices=sorted(GRAD_NORM))
    ap.add_argument("--clouds", type=int, nargs="+", default=[8])
    ap.add_argument("--seeds", type=int, nargs="+", default=[5])
    ap.add_argument("--n-points", type=int, default=None)
    ap.add_argument("--jitter", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.jitter:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        sys.exit("grad_check: needs a CUDA device (or --jitter)")
    n_points = args.n_points or (2048 if args.model in SEG else 1024)
    variables = random_jax_variables(build_model(args.model), seed=0)
    failed = False
    for seed in args.seeds:
        for clouds in args.clouds:
            batch = synthetic_batch(args.model, clouds, seed, n_points)
            got = grad_agreement(args.model, variables, batch, dev,
                                 args.jitter)
            agree = got.pop("agree")
            cosines = sorted(c for c, _ in agree.values())
            failed |= bool(got["failures"]) and not args.jitter
            print(json.dumps({
                "model": args.model, "device": str(dev), "seed": seed,
                "clouds": clouds, "n_points": n_points,
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
