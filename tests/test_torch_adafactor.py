"""Port parity for train/adafactor.py: ``Adafactor`` against
``optax.adafactor(learning_rate=1.0, min_dim_size_to_factor=128)`` on the
same seeded numpy parameters and gradients, as the JAX trainers apply it
(jitted, ``updates * lr`` after it, ``optax.apply_updates``). The tree: a
factored square kernel, a factored non-square kernel, a kernel whose
second dim is just under 128 (a full v), biases and LayerNorm vectors,
carried into ``nn.Linear`` layouts with ``params_from_jax``.

Tolerances, written before the first run: five updates in float32 within
1e-6 x max|p| of optax's, per tensor; with bf16 parameters every element
of the parameters and of the state leaves (v_row, v_col, v) within one
bf16 ulp of optax's (each stage rounds to bf16 on both sides; optax's
float32 sums run in another order); the state's shapes and dtypes optax's,
leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.train import orbax_ckpt
from gaussian_transformer_tpu_torch.train.adafactor import Adafactor, factored_dims

from tests.torch_port_support import bf16_ulp

F32_REL = 1e-6
LR = 5e-4
SHAPES = {  # flax layouts: kernels [in, out]
    "square": {"kernel": (160, 160), "bias": (160,)},
    "wide": {"kernel": (130, 200), "bias": (200,)},
    "under": {"kernel": (127, 300), "bias": (300,)},
    "norm": {"a_2": (64,), "b_2": (64,)},
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tree(r, jdt):
    """Parameters: kernels N(0, 0.05), biases zero, LayerNorm ones/zeros;
    kernels and biases in ``jdt``, the LayerNorm vectors float32 (as the
    flax model keeps them)."""
    out = {}
    for mod, leaves in SHAPES.items():
        out[mod] = {}
        for k, shape in leaves.items():
            x = np.ones(shape, np.float32) if k == "a_2" else (
                r.randn(*shape) * 0.05 if k == "kernel" else np.zeros(shape)).astype(np.float32)
            out[mod][k] = jnp.asarray(x, jnp.float32 if mod == "norm" else jdt)
    return out


def _close(got: torch.Tensor, ref, dtype, what):
    got = got.detach().float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if dtype == "f32":
        assert np.abs(got - ref).max() <= F32_REL * max(float(np.abs(ref).max()), 1e-30), what
    else:
        assert np.all(np.abs(got - ref) <= bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))), what


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_five_updates_match_optax(dtype):
    jdt, tdt = DTYPES[dtype]
    r = np.random.RandomState(0)
    params = _tree(r, jdt)
    opt = optax.adafactor(learning_rate=1.0, min_dim_size_to_factor=128)
    state = opt.init(params)

    @jax.jit
    def step(g, s, p, lr):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, jax.tree.map(lambda x: x * (lr / 1.0), u)), s

    sd = tf.params_from_jax(jax.tree.map(np.asarray, params))
    names = sorted(sd, key=tf._jax_path)  # jax.tree_util flatten order
    tp = {n: torch.nn.Parameter(sd[n].clone()) for n in names}
    assert tp["square.weight"].dtype == tdt and tp["norm.a_2"].dtype == torch.float32
    ada = Adafactor([tp[n] for n in names], lr=LR)
    for _ in range(5):
        grads = jax.tree.map(lambda x: jnp.asarray(r.randn(*x.shape).astype(np.float32) * 0.3, x.dtype), params)
        gsd = tf.params_from_jax(jax.tree.map(np.asarray, grads))
        for n in names:
            tp[n].grad = gsd[n].clone()
        ada.step()
        params, state = step(grads, state, params, jnp.asarray(LR))
        ref = tf.params_from_jax(jax.tree.map(np.asarray, params))
        for n in names:
            assert tp[n].dtype == ref[n].dtype, n
            tol = "f32" if tp[n].dtype == torch.float32 else "bf16"
            _close(tp[n], ref[n].float(), tol, n)

    fs = state[0]
    assert int(fs.count) == 5
    for key in ("v_row", "v_col", "v"):
        for n, leaf in zip(names, jax.tree.leaves(getattr(fs, key))):
            st = ada.state[tp[n]]
            assert st["step"] == 5
            assert tuple(st[key].shape) == leaf.shape and str(st[key].dtype)[6:] == str(leaf.dtype), (key, n)
            _close(st[key], leaf, "f32" if st[key].dtype == torch.float32 else "bf16", f"{key} {n}")


def test_factoring_follows_the_flax_layout():
    """The factored dims are optax's on the kernel's [in, out] shape: the
    square and wide kernels factor, the one under 128 keeps a full v, and
    every v_row/v_col/v has optax's shape."""
    assert factored_dims((160, 160)) == (0, 1)
    assert factored_dims((130, 200)) == (0, 1)
    assert factored_dims((200, 130)) == (1, 0)
    assert factored_dims((127, 300)) is None
    assert factored_dims((300,)) is None
    w = torch.nn.Parameter(torch.zeros(200, 130))  # nn.Linear(130, 200): the kernel is [130, 200]
    st = Adafactor.init_state(w)
    ref = optax.adafactor(learning_rate=1.0).init({"k": jnp.zeros((130, 200))})[0]
    assert tuple(st["v_row"].shape) == ref.v_row["k"].shape == (130,)
    assert tuple(st["v_col"].shape) == ref.v_col["k"].shape == (200,)
    assert tuple(st["v"].shape) == ref.v["k"].shape == (1,)


def test_small_bf16_updates_round_away_and_zero_biases_move():
    """lr * max(rms(p), 1e-3) * g_hat (~2.5e-5 |g_hat| at rms 0.05) is under
    half a ulp (|p| 2^-9) of every weight above ~0.013 |g_hat|, ~85% of
    N(0, 0.05) weights: ``p + u`` leaves them as they were, as optax's
    ``apply_updates`` does; the zero biases (rms 0: the 1e-3 floor) move."""
    r = np.random.RandomState(1)
    lin = torch.nn.Linear(300, 300, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(r.randn(300, 300).astype(np.float32) * 0.05))
        lin.bias.zero_()
    before = lin.weight.detach().clone()
    ada = Adafactor(lin.parameters(), lr=LR)
    lin.weight.grad = torch.from_numpy(r.randn(300, 300).astype(np.float32)).to(torch.bfloat16)
    lin.bias.grad = torch.from_numpy(r.randn(300).astype(np.float32)).to(torch.bfloat16)
    ada.step()
    unchanged = float((lin.weight == before).float().mean())
    assert 0.8 < unchanged < 0.95, unchanged
    assert bool((lin.bias != 0).all()) and float(lin.bias.abs().max()) <= 2 * LR * 1e-3


def test_bf16_state_survives_a_snapshot_and_resume(tmp_path):
    """bf16 parameters and Adafactor state through ``train/orbax_ckpt.py``
    (the campaign's ``--orbax``): a run resumed from a snapshot at step 2
    ends, after step 3, bit for bit where the uninterrupted run ends."""
    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(140, 150), torch.nn.LayerNorm(150)).to(torch.bfloat16)

    grads = [[torch.from_numpy(np.random.RandomState(s * 10 + i).randn(*p.shape).astype(np.float32))
              .to(torch.bfloat16) for i, p in enumerate(model().parameters())] for s in range(3)]

    def run(m, opt, steps):
        for s in steps:
            for p, g in zip(m.parameters(), grads[s]):
                p.grad = g.clone()
            opt.param_groups[0]["lr"] = LR
            opt.step()

    full, full_opt = model(), None
    full_opt = Adafactor(full.parameters())
    run(full, full_opt, range(3))

    first = model()
    first_opt = Adafactor(first.parameters())
    run(first, first_opt, range(2))
    mgr = orbax_ckpt.make_manager(str(tmp_path), async_save=False)
    orbax_ckpt.save(mgr, 2, {"params": first.state_dict(), "opt_state": first_opt.state_dict()})
    resumed = model()
    resumed_opt = Adafactor(resumed.parameters())
    snap = orbax_ckpt.restore(orbax_ckpt.make_manager(str(tmp_path)), {"params": None, "opt_state": None})
    resumed.load_state_dict(snap["params"])
    resumed_opt.load_state_dict(snap["opt_state"])
    for p in resumed.parameters():
        st = resumed_opt.state[p]
        assert st["step"] == 2 and all(st[k].dtype == p.dtype == torch.bfloat16 for k in ("v_row", "v_col", "v"))
    run(resumed, resumed_opt, [2])
    for a, b in zip(full.parameters(), resumed.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
