"""General helpers: inverse sigmoid, the exponential lr schedule and seeding
with stdout stamping (port of ``gaussian_transformer_tpu/utils/general.py``)."""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1000000):
    """The Plenoxels exponential lr schedule as a function of the step (the
    reference's helper): ``train/optim.py expon_lr`` with these settings,
    a float32 0-dim tensor (0.0 when both rates are 0)."""
    from gaussian_transformer_tpu_torch.train.optim import expon_lr

    def helper(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        return expon_lr(step, lr_init, lr_final, lr_delay_steps=lr_delay_steps,
                        lr_delay_mult=lr_delay_mult, max_steps=max_steps)

    return helper


def safe_state(silent: bool, seed: int = 0):
    """Timestamp every stdout line and seed Python, numpy and torch.

    Replaces ``sys.stdout``; a caller that must get the original stream back
    (a CLI ``main`` run inside another program) restores it itself."""
    old_f = sys.stdout

    class _F:
        def __init__(self, silent):
            self.silent = silent

        def write(self, x):
            if not self.silent:
                if x.endswith("\n"):
                    old_f.write(x.replace("\n", " [{}]\n".format(datetime.now().strftime("%d/%m %H:%M:%S"))))
                else:
                    old_f.write(x)

        def flush(self):
            old_f.flush()

    sys.stdout = _F(silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
