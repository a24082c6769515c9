"""General helpers: inverse sigmoid and seeding with stdout stamping (port of
``gaussian_transformer_tpu/utils/general.py``)."""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


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
