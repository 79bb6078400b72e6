"""The VMC loss, its clipping and its energy terms."""

from .clip import median_clip_and_mask, median_log_squeeze_and_mask  # noqa: F401
from .loss_function import VMCLoss, create_loss_fn  # noqa: F401
