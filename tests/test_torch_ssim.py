"""Port parity: SSIM (ops/losses.py, ops/fused_ssim.py). The plain version of
kernel K3 against the JAX ``ssim`` and the JAX fused SSIM in Pallas
interpret mode to 1e-6, on CHW and BCHW images of unaligned sizes; the
generic (non-fused) path too. Kernel K3 itself is checked on the card by
tests/test_torch_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_transformer_tpu.ops.fused_ssim import fused_ssim as jax_fused_ssim
from gaussian_transformer_tpu.ops.losses import l1_loss as jax_l1, ssim as jax_ssim
from gaussian_transformer_tpu_torch.ops import fused_ssim
from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 37, 53), (3, 70, 129), (2, 3, 64, 200)])
def test_plain_matches_reference(shape):
    a, b = _pair(shape)
    ref = float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    out = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(out - ref) < 1e-6
    assert abs(float(fused_ssim.ssim_plain(torch.from_numpy(a), torch.from_numpy(b))) - ref) < 1e-6


def test_plain_matches_pallas_interpret():
    a, b = _pair((3, 70, 140), seed=1)
    ref = float(jax_fused_ssim(jnp.asarray(a), jnp.asarray(b), "pallas_interpret"))
    out = float(fused_ssim.fused_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(out - ref) < 1e-6


@pytest.mark.parametrize("window_size,size_average", [(7, True), (11, False)])
def test_generic_path_matches_reference(window_size, size_average):
    a, b = _pair((2, 3, 41, 57), seed=2)
    ref = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b), window_size, size_average))
    out = ssim(torch.from_numpy(a), torch.from_numpy(b), window_size, size_average).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    a = a[0]  # CHW: per-batch mean of the single image
    ref = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b[0]), window_size, size_average))
    out = ssim(torch.from_numpy(a), torch.from_numpy(b[0]), window_size, size_average).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_identical_images_and_l1():
    a, b = _pair((3, 24, 30), seed=3)
    ta = torch.from_numpy(a)
    assert abs(float(ssim(ta, ta)) - 1.0) < 1e-6
    assert abs(float(l1_loss(ta, torch.from_numpy(b))) - float(jax_l1(jnp.asarray(a), jnp.asarray(b)))) < 1e-6

