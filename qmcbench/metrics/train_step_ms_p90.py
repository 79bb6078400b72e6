"""The 90th percentile of the window's training steps, host clock to host clock."""

import numpy as np


def read(ctx):
    if ctx['suffix'] != 'train':
        return None
    return float(np.percentile(1e3 * np.asarray(ctx['step_s']), 90))
