"""NN building blocks (counterpart of ``pointcloudlib_tpu/nn``)."""

from pointcloudlib_tpu_torch.nn.layers import (
    DenseBNAct,
    FeaturePropagation,
    FusedSetAbstraction,
    PointMLP,
    SetAbstraction,
    SetAbstractionMSG,
    compute_dtype,
    reference_linear_init,
)

__all__ = [
    "DenseBNAct",
    "FeaturePropagation",
    "FusedSetAbstraction",
    "PointMLP",
    "SetAbstraction",
    "SetAbstractionMSG",
    "compute_dtype",
    "reference_linear_init",
]
