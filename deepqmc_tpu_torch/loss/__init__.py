"""The VMC loss, its clipping, its energy terms and the excited states' penalties."""

from .clip import (  # noqa: F401
    median_clip_and_mask,
    median_log_squeeze_and_mask,
    psi_ratio_clip_and_mask,
)
from .loss_function import VMCLoss, create_loss_fn  # noqa: F401
from .overlap import OverlapPenalty  # noqa: F401
