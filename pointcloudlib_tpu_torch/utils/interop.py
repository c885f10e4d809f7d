"""Weight bridge from the JAX package's variables to the port's modules.

``from_jax_variables`` takes a flax ``{"params", "batch_stats"}`` tree
as nested dicts of numpy arrays (``jax.device_get`` of the JAX model's
variables gives one) and loads it into a port model. The tree must be
in the **fused** layout the JAX model has when its fused set
abstraction is on:

* ``SetAbstraction_{0,1}/FusedSetAbstraction_0/{w1,w2,w3,
  bn{1,2,3}_scale,bn{1,2,3}_bias}`` with batch stats ``mean{l}/var{l}``
  (SSG), or ``SetAbstractionMSG_{0,1}/FusedSetAbstraction_{0,1,2}/…``
  with the same leaves, one per scale (MSG);
* ``SetAbstraction_2`` (SSG) or ``SetAbstraction_0`` (MSG: flax numbers
  each class on its own) ``/PointMLP_0/DenseBNAct_i/{Dense_0/kernel,
  BatchNorm_0/{scale,bias}}`` with batch stats ``BatchNorm_0/{mean,var}``;
* ``_ClsHead_0/DenseBNAct_{0,1}/…`` and ``_ClsHead_0/Dense_0/{kernel,bias}``;
* part segmentation: ``SetAbstraction_{0,1}/FusedSetAbstraction_0``,
  ``SetAbstraction_2/PointMLP_0/…``,
  ``FeaturePropagation_{0,1,2}/PointMLP_0/DenseBNAct_i/…`` (FP3, FP2,
  FP1 in that order), a top-level ``DenseBNAct_0`` whose ``Dense_0`` has
  a kernel and a bias, and ``Dense_0/{kernel,bias}``;
* DGCNN: ``EdgeConv_{0..3}/FusedEdgeConv_0/{w,bn_scale,bn_bias}`` with
  batch stats ``mean``/``var``, ``DenseBNAct_{0,1,2}/…`` (conv5 and the
  head; ``DenseBNAct_2``'s ``Dense_0`` has a bias) and
  ``Dense_0/{kernel,bias}``;
* DGCNN part segmentation: ``Fused2EdgeConv_{0,1}/{w,w2,
  bn{1,2}_scale,bn{1,2}_bias}`` with batch stats ``mean{1,2}``/``var{1,2}``,
  ``FusedEdgeConv_0`` as in DGCNN, ``DenseBNAct_{0..4}`` (conv6, the
  label embedding, the three decoder layers) and a bias-free
  ``Dense_0/kernel``;
* PointConv: ``PointConvSA_{0,1,2}`` (classification; ``_{0..3}`` and
  the decoders ``PointConvInterp_{0..3}`` for part segmentation), each
  with ``DensityNet_0/DenseBNAct_{0,1,2}``, ``PointMLP_0/DenseBNAct_i``
  and ``WeightNet_0/DenseBNAct_{0,1,2}`` (every ``DensityNet`` and
  ``WeightNet`` Dense has a bias), ``Dense_0/{kernel,bias}`` and
  ``BatchNorm_0/{scale,bias}`` with batch stats ``mean``/``var``; then
  ``DenseBNAct_{0,1}`` (classification's head; part segmentation's
  ``DenseBNAct_0``), each Dense with a bias, and ``Dense_0/{kernel,bias}``.

A checkpoint in the unfused layout goes through the JAX package's own
``pointcloudlib_tpu.utils.interop.convert_variables`` first, with an
init of the fused JAX model as its template.

Dense kernels are ``[in, out]`` in flax and ``[out, in]`` in
``nn.Linear``; the bridge transposes them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from pointcloudlib_tpu_torch.models.dgcnn import DGCNN, DGCNNPartSeg
from pointcloudlib_tpu_torch.models.pointconv import (
    PointConvDensityCls,
    PointConvPartSeg,
)
from pointcloudlib_tpu_torch.models.pointnet2 import (
    ClsHead,
    PointNet2MSG,
    PointNet2PartSeg,
    PointNet2SSG,
)
from pointcloudlib_tpu_torch.nn.layers import (
    DenseBNAct,
    FusedSetAbstraction,
    SetAbstraction,
    SetAbstractionMSG,
)

# (collection, *module path, leaf) -> (tensor, transposed)
_Entries = Dict[Tuple[str, ...], Tuple[torch.Tensor, bool]]


def _dense_bn(blk: DenseBNAct, path: Tuple[str, ...], out: _Entries):
    out[("params", *path, "Dense_0", "kernel")] = (blk.dense.weight, True)
    if blk.dense.bias is not None:
        out[("params", *path, "Dense_0", "bias")] = (blk.dense.bias, False)
    bn = (*path, "BatchNorm_0")
    out[("params", *bn, "scale")] = (blk.bn.weight, False)
    out[("params", *bn, "bias")] = (blk.bn.bias, False)
    out[("batch_stats", *bn, "mean")] = (blk.bn.running_mean, False)
    out[("batch_stats", *bn, "var")] = (blk.bn.running_var, False)


def _fused(sa: FusedSetAbstraction, path: Tuple[str, ...], out: _Entries):
    for name in ("w1", "w2", "w3"):
        out[("params", *path, name)] = (getattr(sa, name), False)
    for l in (1, 2, 3):
        for leaf in ("scale", "bias"):
            out[("params", *path, f"bn{l}_{leaf}")] = (
                getattr(sa, f"bn{l}_{leaf}"), False)
        out[("batch_stats", *path, f"mean{l}")] = (getattr(sa, f"mean{l}"),
                                                   False)
        out[("batch_stats", *path, f"var{l}")] = (getattr(sa, f"var{l}"),
                                                  False)


def _set_abstraction(sa: SetAbstraction, path, out: _Entries):
    if sa.n_points is not None:
        _fused(sa.fused, (*path, "FusedSetAbstraction_0"), out)
        return
    for i, blk in enumerate(sa.mlp):
        _dense_bn(blk, (*path, "PointMLP_0", f"DenseBNAct_{i}"), out)


def _dense(dense, path, out: _Entries):
    out[("params", *path, "Dense_0", "kernel")] = (dense.weight, True)
    out[("params", *path, "Dense_0", "bias")] = (dense.bias, False)


def _head(head: ClsHead, path, out: _Entries):
    _dense_bn(head.fc1, (*path, "DenseBNAct_0"), out)
    _dense_bn(head.fc2, (*path, "DenseBNAct_1"), out)
    _dense(head.out, path, out)


def _partseg(model: PointNet2PartSeg) -> _Entries:
    out: _Entries = {}
    for i, sa in enumerate((model.sa1, model.sa2, model.sa3)):
        _set_abstraction(sa, (f"SetAbstraction_{i}",), out)
    for i, fp in enumerate((model.fp3, model.fp2, model.fp1)):
        for j, blk in enumerate(fp.mlp):
            _dense_bn(blk, (f"FeaturePropagation_{i}", "PointMLP_0",
                            f"DenseBNAct_{j}"), out)
    _dense_bn(model.head, ("DenseBNAct_0",), out)
    _dense(model.out, (), out)
    return out


def _dgcnn(model: DGCNN) -> _Entries:
    out: _Entries = {}
    for i, ec in enumerate(model.edge):
        _leaves(ec.fused, (f"EdgeConv_{i}", "FusedEdgeConv_0"),
                ("w", "bn_scale", "bn_bias"), ("mean", "var"), out)
    for i, blk in enumerate((model.conv5, model.fc1, model.fc2)):
        _dense_bn(blk, (f"DenseBNAct_{i}",), out)
    _dense(model.out, (), out)
    return out


def _leaves(module, path, params, stats, out: _Entries):
    for leaf in params:
        out[("params", *path, leaf)] = (getattr(module, leaf), False)
    for leaf in stats:
        out[("batch_stats", *path, leaf)] = (getattr(module, leaf), False)


def _dgcnn_partseg(model: DGCNNPartSeg) -> _Entries:
    out: _Entries = {}
    for i, ec in enumerate((model.edge1, model.edge2)):
        _leaves(ec, (f"Fused2EdgeConv_{i}",),
                ("w", "w2", "bn1_scale", "bn1_bias", "bn2_scale", "bn2_bias"),
                ("mean1", "var1", "mean2", "var2"), out)
    _leaves(model.edge3, ("FusedEdgeConv_0",), ("w", "bn_scale", "bn_bias"),
            ("mean", "var"), out)
    for i, blk in enumerate((model.conv6, model.label, model.dec1,
                             model.dec2, model.dec3)):
        _dense_bn(blk, (f"DenseBNAct_{i}",), out)
    out[("params", "Dense_0", "kernel")] = (model.out.weight, True)
    return out


def _pointconv_layer(layer, path, out: _Entries):
    """A ``PointConvSA`` or ``PointConvInterp`` at ``path``."""
    for sub, seq in (("DensityNet_0", layer.density_net),
                     ("PointMLP_0", layer.mlp),
                     ("WeightNet_0", layer.weight_net)):
        for i, blk in enumerate(seq):
            _dense_bn(blk, (*path, sub, f"DenseBNAct_{i}"), out)
    _dense(layer.dense, path, out)
    bn = (*path, "BatchNorm_0")
    out[("params", *bn, "scale")] = (layer.bn.weight, False)
    out[("params", *bn, "bias")] = (layer.bn.bias, False)
    out[("batch_stats", *bn, "mean")] = (layer.bn.running_mean, False)
    out[("batch_stats", *bn, "var")] = (layer.bn.running_var, False)


def _pointconv(model) -> _Entries:
    out: _Entries = {}
    if isinstance(model, PointConvPartSeg):
        sas = (model.sa1, model.sa2, model.sa3, model.sa4)
        decoders = (model.fp4, model.fp3, model.fp2, model.fp1)
        heads = (model.head,)
    else:
        sas, decoders = (model.sa1, model.sa2, model.sa3), ()
        heads = (model.fc1, model.fc2)
    for i, sa in enumerate(sas):
        _pointconv_layer(sa, (f"PointConvSA_{i}",), out)
    for i, fp in enumerate(decoders):
        _pointconv_layer(fp, (f"PointConvInterp_{i}",), out)
    for i, blk in enumerate(heads):
        _dense_bn(blk, (f"DenseBNAct_{i}",), out)
    _dense(model.out, (), out)
    return out


def _entries(model) -> _Entries:
    if isinstance(model, (PointConvDensityCls, PointConvPartSeg)):
        return _pointconv(model)
    if isinstance(model, PointNet2PartSeg):
        return _partseg(model)
    if isinstance(model, DGCNN):
        return _dgcnn(model)
    if isinstance(model, DGCNNPartSeg):
        return _dgcnn_partseg(model)
    if not isinstance(model, (PointNet2SSG, PointNet2MSG)):
        raise NotImplementedError(
            f"no JAX weight mapping for {type(model).__name__} yet")
    out: _Entries = {}
    seen: Dict[str, int] = {}  # flax numbers the modules of each class
    for sa in (model.sa1, model.sa2, model.sa3):
        cls = type(sa).__name__
        path = (f"{cls}_{seen.setdefault(cls, 0)}",)
        seen[cls] += 1
        if isinstance(sa, SetAbstractionMSG):
            for j, scale in enumerate(sa.scales):
                _fused(scale, (*path, f"FusedSetAbstraction_{j}"), out)
        else:
            _set_abstraction(sa, path, out)
    _head(model.head, ("_ClsHead_0",), out)
    return out


def _flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flatten(val, (*prefix, key)))
        else:
            flat[(*prefix, key)] = val
    return flat


def _shape(t: torch.Tensor, transposed: bool) -> Tuple[int, ...]:
    return tuple(t.shape[::-1]) if transposed else tuple(t.shape)


def jax_variable_shapes(model) -> Dict:
    """The nested ``{"params", "batch_stats"}`` tree of shapes that
    :func:`from_jax_variables` expects for ``model``."""
    tree: Dict = {}
    for path, (t, transposed) in _entries(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _shape(t, transposed)
    return tree


@torch.no_grad()
def from_jax_variables(model, variables: Mapping):
    """Load the JAX fused-layout ``variables`` (numpy leaves) into
    ``model`` in place and return it. Raises ``KeyError`` on a missing
    or extra key and ``ValueError`` on a wrong shape; nothing is copied
    unless every key and shape matches."""
    want = _entries(model)
    got = _flatten(variables)
    missing = sorted("/".join(k) for k in want.keys() - got.keys())
    extra = sorted("/".join(k) for k in got.keys() - want.keys())
    if missing or extra:
        raise KeyError(f"JAX variables do not match {type(model).__name__}: "
                       f"missing {missing}, extra {extra}")
    arrays = {}
    for key, (t, transposed) in want.items():
        a = np.asarray(got[key], dtype=np.float32)
        if a.shape != _shape(t, transposed):
            raise ValueError(f"{'/'.join(key)}: shape {a.shape}, expected "
                             f"{_shape(t, transposed)}")
        arrays[key] = torch.tensor(a.T if transposed else a)
    for key, (t, _) in want.items():
        t.copy_(arrays[key])
    return model


@torch.no_grad()
def to_jax_variables(model) -> Dict:
    """The inverse of :func:`from_jax_variables`: ``model``'s parameters
    and BN running statistics as the JAX fused-layout ``{"params",
    "batch_stats"}`` tree of float32 numpy arrays (Dense kernels
    transposed back to ``[in, out]``)."""
    tree: Dict = {}
    for path, (t, transposed) in _entries(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        a = t.detach().float().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(a.T if transposed else a)
    return tree


def random_jax_variables(model, seed: int = 0) -> Dict:
    """A seeded numpy tree in the layout :func:`from_jax_variables`
    takes: kernels (Dense ``kernel``, the fused layers' ``w`` and
    ``w1``–``w3``) U(±1/√fan_in), BN scales U(0.8, 1.2), biases and
    running means N(0, 0.05²), running variances U(0.05, 0.5). For
    tests and the chip smoke run, where no trained checkpoint exists."""
    rng = np.random.default_rng(seed)

    def leaf(name: str, shape):
        if name in ("kernel", "w", "w1", "w2", "w3"):
            bound = 1.0 / np.sqrt(shape[0])
            return rng.uniform(-bound, bound, shape)
        if name.endswith("scale"):
            return rng.uniform(0.8, 1.2, shape)
        if name.startswith("var"):
            return rng.uniform(0.05, 0.5, shape)
        return rng.normal(0.0, 0.05, shape)  # biases, means

    def build(node):
        return {key: build(val) if isinstance(val, dict)
                else leaf(key, val).astype(np.float32)
                for key, val in sorted(node.items())}

    return build(jax_variable_shapes(model))
