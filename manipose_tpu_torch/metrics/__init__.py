from .consistency import (
    measure_bones_length,
    segments_time_consistency,
    smoothness_regularization,
)
from .losses import (
    STANDARD_H36M_WEIGHTS,
    binary_cross_entropy,
    mean_velocity_error,
    weighted_mpjpe_loss,
    weighted_mse_loss,
    wta_l2_loss_and_activate_head,
)

__all__ = [
    "measure_bones_length",
    "segments_time_consistency",
    "smoothness_regularization",
    "STANDARD_H36M_WEIGHTS",
    "binary_cross_entropy",
    "mean_velocity_error",
    "weighted_mpjpe_loss",
    "weighted_mse_loss",
    "wta_l2_loss_and_activate_head",
]
