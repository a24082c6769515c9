"""Port parity: the layout probe (``gaussian_transformer_tpu_torch/tools/
layout_probe.py``, kernel K9).

The JAX probe (``tools/layout_probe.py``) cannot run here: its kernel is a
closure inside ``main`` that is only compiled, never run, for a ``v5e:2x2``
TPU topology. So numpy in float64 is K9's reference on the CPU: the plain
block sums (what CPU tensors take) against it for the four layouts of the
reference in both dtypes, at an N whose last block is partial (the reference
reads whole blocks only). K9 itself is checked on the card by
tests/test_torch_kernels.py."""

import json

import numpy as np
import pytest
import torch

from gaussian_transformer_tpu_torch.tools import layout_probe

N = 2048 * 3 + 1024  # three whole blocks and half of one in every layout
BLOCKS = {
    "rows16": (lambda n: (n, 16), (2048, 16)),
    "rows128": (lambda n: (n // 8, 128), (256, 128)),
    "planes": (lambda n: (16, n), (16, 2048)),
}


def _numpy_block_sums(a, block):
    rows, cols = a.shape
    if block[1] == cols:
        nb = rows // block[0]
        return a[: nb * block[0]].reshape(nb, -1).sum(axis=1)
    nb = cols // block[1]
    return a[:, : nb * block[1]].reshape(rows, nb, block[1]).sum(axis=(0, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(BLOCKS))
def test_plain_block_sums_match_numpy(layout, dtype):
    shape, block = BLOCKS[layout]
    x = torch.from_numpy(np.random.RandomState(7).uniform(-1.0, 2.0, shape(N)).astype(np.float32)).to(dtype)
    want = _numpy_block_sums(x.to(torch.float64).numpy(), block)
    got = layout_probe.block_sums(x, block)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # The TPU kernel's one cell holds the last block's sum.
    last = x[2 * block[0]: 3 * block[0]] if block[1] == x.shape[1] else x[:, 2 * block[1]: 3 * block[1]]
    np.testing.assert_allclose(float(got[-1]), last.double().sum().item(), rtol=1e-6)
    np.testing.assert_allclose(layout_probe.library_sums(x, block).numpy(), want, rtol=1e-5)


def test_layouts_are_the_reference_probes():
    assert [(name, shape(64), dtype, block) for name, shape, dtype, block in layout_probe.LAYOUTS] == [
        ("[N,16] f32", (64, 16), torch.float32, (2048, 16)),
        ("[N,16] bf16", (64, 16), torch.bfloat16, (2048, 16)),
        ("[N/8,128] bf16", (8, 128), torch.bfloat16, (256, 128)),
        ("[16,N] f32", (16, 64), torch.float32, (16, 2048)),
    ]
    assert layout_probe.ROWS == 3_232_768


def test_main_prints_one_line_per_layout(capsys):
    records = layout_probe.main(["--rows", str(N), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(layout_probe.LAYOUTS) == len(records)
    for line, rec, (name, shape, dtype, block) in zip(lines, records, layout_probe.LAYOUTS):
        assert json.loads(line) == rec
        assert rec["layout"] == name and rec["blocks"] == 3 and "ms" not in rec
        x = layout_probe.make_layout(name, N, "cpu")
        assert tuple(x.shape) == shape(N) and x.dtype == dtype
        assert rec["last_block_sum"] == float(layout_probe.block_sums_plain(x, block)[-1])
        assert rec["bytes"] == 3 * 2048 * 16 * x.element_size() + 3 * 4


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        layout_probe.block_sums(torch.zeros(64, 16, dtype=torch.float64), (32, 16))
    with pytest.raises(ValueError):
        layout_probe.block_sums(torch.zeros(64, 16), (32, 8))
    with pytest.raises(SystemExit):
        layout_probe.main(["--rows", "100", "--device", "cpu"])
