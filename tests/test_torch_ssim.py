"""Port parity: SSIM (ops/losses.py, ops/fused_ssim.py). The plain version of
kernel K3 against the JAX ``ssim`` and the JAX fused SSIM in Pallas
interpret mode to 1e-6, on CHW and BCHW images of unaligned sizes; the
generic (non-fused) path too. Kernel K3 itself is checked on the card by
tests/test_torch_kernels.py."""

import re
from pathlib import Path

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


# The kernels' tile is 32 rows x 64 columns: the shapes one below, at and one
# above a tile side in each axis, sides under the window, a single column, a
# batch of 4 x 3 channels.
EDGE_SHAPES = [(3, 31, 63), (3, 32, 64), (3, 33, 65), (1, 7, 70), (1, 40, 9), (1, 20, 1),
               (4, 3, 33, 65)]


@pytest.mark.parametrize("shape", [(3, 37, 53), (3, 70, 129), (2, 3, 64, 200)] + EDGE_SHAPES)
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


def test_kernel_taps_are_the_window_bits():
    """The taps the kernels compile in (csrc/ssim_common.cuh ``tap``) are the
    bits of ``taps()``, tap by tap."""
    src = (Path(fused_ssim.__file__).resolve().parent.parent / "csrc" / "ssim_common.cuh").read_text()
    body = src[src.index("constexpr float tap(int k)"):]
    body = body[:body.index("}")]
    literals = {}
    for ks, lit in re.findall(r"\(k == (\d+)(?: \|\| k == \d+)?\)\s*\?\s*(0x[0-9a-fp.+-]+)f", body):
        literals[int(ks)] = float.fromhex(lit)
    last = re.findall(r":\s*(0x[0-9a-fp.+-]+)f;", body)
    t = fused_ssim.taps()
    assert sorted(literals) == [0, 1, 2, 3, 4] and len(last) == 1
    literals[5] = float.fromhex(last[0])
    for k in range(11):
        assert np.float32(literals[min(k, 10 - k)]).tobytes() == t[k].tobytes(), k


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

