"""Adafactor as optax builds it for the stacked campaign:
``optax.adafactor(learning_rate=1.0, min_dim_size_to_factor=128)`` with its
other defaults, as a ``torch.optim.Optimizer``, followed by the JAX step's
``updates * lr`` (``tools/stacked_campaign.py``, ``train/stacked.py
make_train_step``).

optax chains, per parameter:
  1. ``scale_by_factored_rms``: g2 = g^2 + 1e-30; decay d_t = 1 - (t+1)^-0.8
     at step t (0-based); when the second largest dim is >= 128, a factored
     second moment over the two largest dims (v_row = d v_row + (1-d)
     mean(g2) over the largest, v_col over the second; the update g /
     sqrt(v_row / mean(v_row)) / sqrt(v_col)); otherwise a full v;
  2. ``clip_by_block_rms(1.0)``: u / max(1, rms(u));
  3. scaling by the learning rate of 1.0 (exact: left out here);
  4. ``scale_by_param_block_rms(1e-3)``: u * max(rms(p), 1e-3);
  5. ``scale(-1)``.
``step`` then applies ``p + u * lr`` with the param group's ``lr``: the JAX
step's ``updates * lr`` after the chain (at lr 1.0, optax's update itself).

Numbers as optax's:
  * the state (v_row, v_col, v) is held in the parameter's dtype and
    rounded to it after each update, as optax casts it; the decay blend is
    float32 (optax's decay rate is a float32 array), every other stage runs
    in the parameter's dtype with one rounding per operation, and means
    accumulate in float32, as ``jnp.mean`` does;
  * a 2-D parameter is an ``nn.Linear`` weight [out, in]: its statistics
    are those of the flax kernel [in, out], so the factored dims and every
    state leaf are optax's, one to one, and a checkpoint carries them over
    as they are (``train/stacked.py save_checkpoint``);
  * with bf16 parameters an update under half a ulp of its parameter
    rounds away in ``p + u``, as ``optax.apply_updates`` rounds it; the
    zero-initialised biases (rms 0, so the 1e-3 floor) do move.
``torch.optim.Adafactor`` is not this update: it has no parameter-scale
stage and another decay rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


MIN_DIM_SIZE_TO_FACTOR = 128  # the campaign's
DECAY_RATE = 0.8  # optax.adafactor's defaults
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (second largest, largest) axis of
    ``shape``, or None when there are fewer than two axes or the second
    largest is under ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def jax_view(t: torch.Tensor) -> torch.Tensor:
    """A parameter (or its gradient) in the flax layout: a 2-D ``nn.Linear``
    weight [out, in] as the kernel [in, out] (a view)."""
    return t.T if t.ndim == 2 else t


def state_shapes(shape):
    """optax's shapes of (v_row, v_col, v) for a flax-layout ``shape``;
    (1,) where a leaf is unused."""
    dims = factored_dims(shape)
    if dims is None:
        return (1,), (1,), tuple(shape)
    d1, d0 = dims
    return tuple(np.delete(shape, d0)), tuple(np.delete(shape, d1)), (1,)


def _in(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (a host scalar: no device copy)."""
    return float(torch.tensor(value, dtype=dtype))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate=1.0, min_dim_size_to_factor=128)``
    (decay 0.8, eps 1e-30, clipping 1.0, parameter scale with floor 1e-3,
    no momentum, no weight decay), its update then scaled by ``lr``. State
    per parameter: ``step`` (optax's count) and ``v_row``, ``v_col``, ``v``
    in optax's shapes and dtype."""

    def __init__(self, params, lr: float = 1.0):
        super().__init__(params, dict(lr=lr))

    @staticmethod
    def init_state(p: torch.Tensor) -> dict:
        """optax's initial state of one parameter: count 0, zeros."""
        rows, cols, full = state_shapes(tuple(jax_view(p).shape))
        z = lambda s: torch.zeros(s, dtype=p.dtype, device=p.device)
        return {"step": 0, "v_row": z(rows), "v_col": z(cols), "v": z(full)}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.init_state(p))
                u = self._update(jax_view(p.grad), jax_view(p), state)
                u = (jax_view(u) * _in(group["lr"], p.dtype)).to(p.dtype)  # the JAX step's updates * lr
                p.copy_(p.float() + u.float())  # optax.apply_updates: (p + u).astype(p.dtype)
                state["step"] += 1
        return loss

    @staticmethod
    def _update(g, p, state) -> torch.Tensor:
        """The chain's update (steps 1-5) of one flax-layout parameter ``p``
        with gradient ``g``, in the parameter's dtype; writes the new
        v_row/v_col/v into ``state``. Each operation runs in float32 and is
        rounded to the dtype (torch's own bf16 ``pow`` is not correctly
        rounded on the CPU)."""
        dtype = p.dtype

        def rd(x):  # one rounding to the parameter's dtype
            return x if dtype == torch.float32 else x.to(dtype).float()

        def mean(x, dim=None, keepdim=False):  # jnp.mean: float32 sum, one rounding
            return rd(x.mean() if dim is None else x.mean(dim, keepdim=keepdim))

        def rms(x):
            return rd(torch.sqrt(mean(rd(x * x))))

        g, p = g.float(), p.float()
        t = np.float32(state["step"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-DECAY_RATE)  # float32, as optax's
        keep = float(np.float32(1.0) - decay)
        decay = float(decay)
        g2 = rd(rd(g * g) + EPS)
        dims = factored_dims(tuple(p.shape))
        if dims is not None:
            d1, d0 = dims
            v_row = rd(decay * state["v_row"].float() + keep * mean(g2, d0))
            v_col = rd(decay * state["v_col"].float() + keep * mean(g2, d1))
            state["v_row"], state["v_col"] = v_row.to(dtype), v_col.to(dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = rd(rd(v_row / mean(v_row, reduced_d1, keepdim=True)) ** -0.5)
            u = rd(rd(g * row_factor.unsqueeze(d0)) * rd(v_col ** -0.5).unsqueeze(d1))
        else:
            v = rd(decay * state["v"].float() + keep * g2)
            state["v"] = v.to(dtype)
            u = rd(g * rd(v ** -0.5))
        u = rd(u / torch.clamp(rd(rms(u) / _in(CLIPPING_THRESHOLD, dtype)), min=1.0))
        rms_p = rms(p)
        floor = _in(MIN_SCALE, dtype)
        u = rd(u * torch.where(rms_p <= floor, floor, rms_p))
        return -u
