"""Port parity: the fused SSIM backward (ops/fused_ssim.py). The plain
version of kernel K4 against ``jax.grad`` of the JAX ``ssim`` and of the JAX
fused SSIM with its Pallas backward in interpret mode, at the JAX suite's own
1e-8 absolute (``tests/test_ops_basic.py``), on CHW, BCHW and unaligned
shapes; the port's ``fused_ssim``/``ssim``/``l1_loss`` gradients on CPU
tensors too. Kernel K4 itself is checked on the card by
tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.ops.fused_ssim import fused_ssim as jax_fused_ssim
from gaussian_transformer_tpu.ops.losses import l1_loss as jax_l1, ssim as jax_ssim
from gaussian_transformer_tpu_torch.ops import fused_ssim
from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim

ATOL = 1e-8


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _plain_grads(a, b, g=1.0):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    flat = lambda x: x.reshape(-1, *x.shape[-2:])
    d1, d2 = fused_ssim.ssim_bwd_plain(flat(ta), flat(tb), torch.tensor(g, dtype=torch.float32))
    return d1.reshape(a.shape).numpy(), d2.reshape(b.shape).numpy()


# The kernels' tile edges (tests/test_torch_ssim.py EDGE_SHAPES). The single
# column has 70 rows and 3 channels here: at 1 x 20 x 1 the gradients reach
# 0.12 (g / N H W with N H W = 20), where the suite's absolute 1e-8 is under
# 2 float32 ulps, and jax.grad of ``ssim`` and of the Pallas version are
# themselves 3e-8 from a float64 evaluation.
EDGE_SHAPES = [(3, 31, 63), (3, 32, 64), (3, 33, 65), (1, 7, 70), (1, 40, 9), (3, 70, 1),
               (4, 3, 33, 65)]


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 3, 64, 200), (1, 65, 131)] + EDGE_SHAPES)
def test_plain_backward_matches_reference_grad(shape):
    a, b = _pair(shape)
    ga, gb = jax.grad(lambda x, y: jax_ssim(x, y), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    d1, d2 = _plain_grads(a, b)
    assert np.abs(d1 - np.asarray(ga)).max() < ATOL
    assert np.abs(d2 - np.asarray(gb)).max() < ATOL


@pytest.mark.parametrize("shape,seed", [((3, 70, 140), 1)] + [(s, 2) for s in EDGE_SHAPES])
def test_plain_backward_matches_pallas_interpret(shape, seed):
    a, b = _pair(shape, seed)
    fa, fb = jax.grad(lambda x, y: jax_fused_ssim(x, y, "pallas_interpret"), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b)
    )
    d1, d2 = _plain_grads(a, b)
    assert np.abs(d1 - np.asarray(fa)).max() < ATOL
    assert np.abs(d2 - np.asarray(fb)).max() < ATOL


@pytest.mark.parametrize("shape", [(2, 3, 20, 33)])
def test_port_losses_are_differentiable_on_cpu(shape):
    """fused_ssim (the autograd node with the plain K4), the generic ssim and
    the L1 loss, through torch autograd, against jax.grad of the reference's
    training loss 0.8 L1 + 0.2 (1 - SSIM)."""
    a, b = _pair(shape, seed=3)

    def jax_loss(x, y):
        return 0.8 * jax_l1(x, y) + 0.2 * (1.0 - jax_ssim(x, y))

    ga, gb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    for ssim_fn in (fused_ssim.fused_ssim, ssim):
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        loss = 0.8 * l1_loss(ta, tb) + 0.2 * (1.0 - ssim_fn(ta, tb))
        d1, d2 = torch.autograd.grad(loss, (ta, tb))
        assert np.abs(d1.numpy() - np.asarray(ga)).max() < ATOL
        assert np.abs(d2.numpy() - np.asarray(gb)).max() < ATOL


def test_backward_scales_with_the_cotangent():
    a, b = _pair((3, 24, 31), seed=5)
    d1, d2 = _plain_grads(a, b, g=1.0)
    e1, e2 = _plain_grads(a, b, g=-2.0)  # a power of two scales exactly
    np.testing.assert_array_equal(e1, -2.0 * d1)
    np.testing.assert_array_equal(e2, -2.0 * d2)
