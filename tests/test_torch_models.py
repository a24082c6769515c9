"""Port parity for the transformer's modules: the token codec and the box
sort (models/codec.py, models/box_sort.py), attention and Chamfer
(ops/attention.py, ops/chamfer.py), the encoder-decoder
(models/transformer.py) and the cached decode (models/decode_cache.py),
each against the JAX package on the same seeded numpy inputs, the weights
carried over with ``params_from_jax``. Small size: STACK 2 (D 104),
d_model 104, h 8, N 1-2, dropout 0.

Tolerances: the codec, the stacking fold, the fuzzy masks and the box-sort
order exact; LayerNorm, FFN, attention modules and the full forward 1e-5 x
max(1, max|ref|); attention functions 1e-5 x max(1, max|ref|); Chamfer
distances and gradients 1e-5 (indices equal where the minimum is unique);
the cached decode 1e-4 x max(1, max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.models import box_sort as jax_box_sort
from gaussian_transformer_tpu.models import codec as jax_codec
from gaussian_transformer_tpu.models import transformer as jax_tf
from gaussian_transformer_tpu.models.decode_cache import decode_step as jax_decode_step
from gaussian_transformer_tpu.models.decode_cache import greedy_decode_cached as jax_greedy_cached
from gaussian_transformer_tpu.models.decode_cache import init_decode_state as jax_init_state
from gaussian_transformer_tpu.ops import attention as jax_attention
from gaussian_transformer_tpu.ops.chamfer import chamfer_distance as jax_chamfer
from gaussian_transformer_tpu_torch.models import codec
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.models.box_sort import GaussianHandler
from gaussian_transformer_tpu_torch.models.decode_cache import (
    decode_step,
    greedy_decode_cached,
    init_decode_state,
)
from gaussian_transformer_tpu_torch.ops import attention
from gaussian_transformer_tpu_torch.ops.chamfer import chamfer_distance

from tests.test_render import make_scene
from tests.torch_port_support import torch_scene

D = 104  # STACK 2
MODULE_REL = 1e-5
DECODE_REL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _models(N=2, block_k=0, seed=0):
    jm = jax_tf.make_model(2, D, D, N=N, d_model=D, dropout=0.0, block_k=block_k)
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(seed))
    tm = tf.make_model(2, D, D, N=N, d_model=D, dropout=0.0, block_k=block_k, device="cpu")
    tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------------ codec ---


def test_special_tokens_match():
    for name in ("START_GAUSSIAN", "PAD_GAUSSIAN", "END_GAUSSIAN"):
        np.testing.assert_array_equal(getattr(codec, name).numpy(), np.asarray(getattr(jax_codec, name)))
    assert codec.TOKEN_DIM == jax_codec.TOKEN_DIM == 26


def test_flatten_unflatten_and_fuzzy_masks_exact():
    scene = make_scene(40, seed=3, capacity=48)
    ref = np.array(jax_codec.flatten_gaussians(scene))
    got = codec.flatten_gaussians(torch_scene(scene)).detach().numpy()
    np.testing.assert_array_equal(got, ref)
    back_j = jax_codec.unflatten_gaussians(jnp.asarray(ref))
    back_t = codec.unflatten_gaussians(torch.from_numpy(ref))
    for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "alive"):
        np.testing.assert_array_equal(_np(getattr(back_t, k)), np.asarray(getattr(back_j, k)), err_msg=k)
    assert back_t.active_sh_degree == back_j.active_sh_degree == 1
    # Rows near, at and far from each special token.
    rng = np.random.RandomState(0)
    rows = np.concatenate([ref[:6], np.stack([np.asarray(jax_codec.PAD_GAUSSIAN)] * 3)
                           + rng.uniform(-0.03, 0.03, (3, 26)).astype(np.float32)])
    for tok in ("START_GAUSSIAN", "PAD_GAUSSIAN", "END_GAUSSIAN"):
        np.testing.assert_array_equal(
            codec.fuzzy_token_equal(torch.from_numpy(rows), getattr(codec, tok)).numpy(),
            np.asarray(jax_codec.fuzzy_token_equal(jnp.asarray(rows), getattr(jax_codec, tok))))


@pytest.mark.parametrize("times", [0, 1, 2, 3])
def test_stack_unstack_tokens_exact(times):
    x = np.random.RandomState(times).randn(64, 26).astype(np.float32)
    ref = np.asarray(jax_codec.stack_tokens(jnp.asarray(x), times))
    got = codec.stack_tokens(torch.from_numpy(x), times).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(codec.unstack_tokens(torch.from_numpy(got), times).numpy(),
                                  np.asarray(jax_codec.unstack_tokens(jnp.asarray(ref), times)))
    np.testing.assert_array_equal(codec.unstack_tokens(torch.from_numpy(got), times).numpy(), x)


# --------------------------------------------------------------- box sort ---


@pytest.mark.parametrize("interval_num", [3, 10, 40])
def test_box_sort_exact(interval_num):
    scene = make_scene(300, seed=interval_num, capacity=320)
    # An alive Gaussian exactly on the upper boundary lands in the last voxel.
    scene = scene.replace(xyz=scene.xyz.at[5].set(jnp.max(scene.xyz[:300], axis=0)))
    jh = jax_box_sort.GaussianHandler.create(scene, interval_num)
    ts = torch_scene(scene)
    th = GaussianHandler.create(ts, interval_num)
    for k in ("world_min", "world_max", "scaling_min", "scaling_max"):
        np.testing.assert_array_equal(_np(getattr(th, k)), np.asarray(getattr(jh, k)), err_msg=k)
    norm_j = jh.normalize(scene)
    norm_t = th.normalize(ts)
    np.testing.assert_array_equal(_np(norm_t.xyz), np.asarray(norm_j.xyz))
    np.testing.assert_array_equal(_np(th.voxel_ids(norm_t.xyz)), np.asarray(jh.voxel_ids(norm_j.xyz)))
    np.testing.assert_array_equal(_np(th.box_sort(ts)), np.asarray(jh.box_sort(scene)))
    back_t, back_j = th.denormalize(norm_t), jh.denormalize(norm_j)
    np.testing.assert_array_equal(_np(back_t.scaling), np.asarray(back_j.scaling))
    np.testing.assert_array_equal(_np(back_t.xyz), np.asarray(back_j.xyz))


# ------------------------------------------------------------- attention ---


def _qkv_mask(seed, lq=5, lk=7, d=8, lead=(2, 3)):
    r = np.random.RandomState(seed)
    q = r.randn(*lead, lq, d).astype(np.float32)
    k = r.randn(*lead, lk, d).astype(np.float32)
    v = r.randn(*lead, lk, d).astype(np.float32)
    mask = r.rand(lead[0], 1, lq, lk) > 0.3
    mask[0, 0, 2] = False  # a fully masked row: uniform over the keys
    mask[1, 0, :, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("block_k", [1, 2, 3, 7, 16])
def test_blockwise_attention_matches_reference(block_k):
    q, k, v, mask = _qkv_mask(block_k)
    tq, tk, tv, tm = _tensors(q, k, v, mask)
    ref = attention.reference_attention(tq, tk, tv, tm)
    got = attention.blockwise_attention(tq, tk, tv, tm, block_k=block_k)
    _close(got, ref, MODULE_REL, "port blockwise vs port reference")
    _close(ref, jax_attention.reference_attention(q, k, v, mask), MODULE_REL, "port vs JAX reference")
    # The JAX blockwise pads the keys to a multiple of block_k with masked
    # keys, which a fully masked row then counts in its uniform average
    # (its own reference does not); the two agree where block_k divides Lk.
    jref = np.asarray(jax_attention.blockwise_attention(q, k, v, mask, block_k=block_k))
    if 7 % block_k == 0:
        _close(got, jref, MODULE_REL, "port vs JAX blockwise")
    else:
        rows = np.ones(mask.shape[:-1], bool).repeat(3, 1)
        rows[0, :, 2] = False
        np.testing.assert_allclose(_np(got)[rows], jref[rows], rtol=0,
                                   atol=MODULE_REL * max(1.0, np.abs(jref).max()))


def test_blockwise_attention_no_mask_and_dropout_semantics():
    q, k, v, _ = _qkv_mask(11)
    tq, tk, tv = _tensors(q, k, v)
    _close(attention.blockwise_attention(tq, tk, tv, None, block_k=3),
           jax_attention.blockwise_attention(q, k, v, None, block_k=7), MODULE_REL)
    # Dropout on the numerator only: with the keep masks drawn alike, the
    # blockwise output equals dropout(softmax(s)) @ v.
    rate = 0.4
    got = attention.blockwise_attention(tq, tk, tv, None, block_k=3, dropout_rate=rate,
                                        generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    keep = torch.cat([attention.dropout_keep((2, 3, 5, n), rate, g, "cpu") for n in (3, 3, 1)], dim=-1)
    p = torch.softmax(torch.matmul(tq, tk.transpose(-1, -2)) / np.sqrt(8), dim=-1)
    _close(got, torch.matmul(p * keep / (1 - rate), tv), MODULE_REL)



@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("masked", [False, True])
def test_blockwise_recompute_matches_the_plain_loop(rate, masked):
    """Per-block recompute (``remat``, the default) gives the outputs and
    the gradients of the plain loop bit for bit, draws the same keep masks,
    and leaves the generator where the plain loop leaves it."""
    q, k, v, mask = _qkv_mask(21, lq=9, lk=23, d=8)
    w = np.random.RandomState(22).randn(*q.shape).astype(np.float32)
    runs = []
    for remat in (True, False):
        tq, tk, tv = (t.requires_grad_() for t in _tensors(q, k, v))
        g = torch.Generator().manual_seed(7)
        out = attention.blockwise_attention(tq, tk, tv, torch.from_numpy(mask) if masked else None, block_k=4,
                                            dropout_rate=rate, generator=g if rate else None, remat=remat)
        (out * torch.from_numpy(w)).sum().backward()
        runs.append((out.detach(), tq.grad, tk.grad, tv.grad, torch.rand(4, generator=g)))
    for what, a, b in zip(("out", "dq", "dk", "dv", "generator after"), *runs):
        assert torch.equal(a, b), what
    assert float(runs[0][1].abs().max()) > 0


def test_blockwise_recompute_keeps_only_the_carries():
    """What autograd saves (``saved_tensors_hooks``, unique storages) with
    per-block recompute: q, k, v and the mask once, and each block's incoming
    (m, l, acc) carries, O(Lq * (D + 2)) per block, which is within O(Lq *
    (D + block_k)); no score, probability or keep mask of O(Lq * Lk). The
    plain loop keeps several [Lq, Lk] float tensors."""
    lead, Lq, Lk, D, bk = (1, 2), 256, 256, 8, 32
    r = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(r.randn(*lead, n, D).astype(np.float32)).requires_grad_() for n in (Lq, Lk, Lk))
    mask = torch.from_numpy(r.rand(1, 1, Lq, Lk) > 0.3)
    saved = {}
    for remat in (True, False):
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            attention.blockwise_attention(q, k, v, mask, block_k=bk, dropout_rate=0.2,
                                          generator=torch.Generator().manual_seed(0), remat=remat)
        saved[remat] = sum(storages.values())
    n_blocks, rows = Lk // bk, int(np.prod(lead)) * Lq
    inputs = sum(t.untyped_storage().nbytes() for t in (q, k, v, mask))
    bound = inputs + (n_blocks + 1) * rows * (D + 2) * 4  # the carries of each block and the final division's
    assert saved[True] <= bound, (saved[True], bound)
    assert rows * (D + 2) * 4 < rows * (D + bk) * 4
    scores = rows * Lk * 4  # one [Lq, Lk] float32 tensor
    assert saved[False] > bound + 3 * scores, (saved[False], bound)

# ----------------------------------------------------------------- chamfer ---


@pytest.mark.parametrize("case", ["dense", "invalid_targets", "all_invalid", "blocks"])
def test_chamfer_matches_jax(case):
    r = np.random.RandomState(len(case))
    a = r.randn(2, 37, 26).astype(np.float32)
    b = r.randn(2, 29, 26).astype(np.float32)
    av, bv = np.ones((2, 37), bool), np.ones((2, 29), bool)
    if case == "invalid_targets":
        av[0, 30:] = False
        bv[1, ::3] = False
    if case == "all_invalid":
        bv[0] = False
        av[1] = False
    block = 8 if case == "blocks" else 512
    wa = r.randn(2, 37).astype(np.float32)
    wb = r.randn(2, 29).astype(np.float32)

    def jloss(a, b):
        d1, d2, i1, i2 = jax_chamfer(a, b, jnp.asarray(av), jnp.asarray(bv), block=block)
        return jnp.sum(d1 * wa) + jnp.sum(d2 * wb), (d1, d2, i1, i2)

    (_, (jd1, jd2, ji1, ji2)), (jga, jgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    d1, d2, i1, i2 = chamfer_distance(ta, tb, torch.from_numpy(av), torch.from_numpy(bv), block=block)
    ((d1 * torch.from_numpy(wa)).sum() + (d2 * torch.from_numpy(wb)).sum()).backward()
    for got, ref, what in ((d1, jd1, "dist1"), (d2, jd2, "dist2"), (ta.grad, jga, "grad a"),
                           (tb.grad, jgb, "grad b")):
        _close(got, ref, 1e-5, what)
    # Indices where the minimum is unique (and a valid target exists).
    for i_t, i_j, x, y, yv in ((i1, ji1, a, b, bv), (i2, ji2, b, a, av)):
        d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1) + np.where(yv[:, None], 0, np.inf)
        srt = np.sort(d, axis=-1)
        with np.errstate(invalid="ignore"):  # inf - inf where no target is valid
            unique = (srt[..., 1] - srt[..., 0] > 1e-3) & np.isfinite(srt[..., 0])
        np.testing.assert_array_equal(_np(i_t)[unique], np.asarray(i_j)[unique])
    if case == "all_invalid":
        assert float(d1[0].detach().abs().sum()) == 0.0 and float(d2[1].detach().abs().sum()) == 0.0


# ---------------------------------------------------- transformer modules ---


def test_torch_layer_norm_matches():
    x = np.random.RandomState(0).randn(3, 5, D).astype(np.float32) * 3 + 1
    a2 = np.random.RandomState(1).randn(D).astype(np.float32)
    b2 = np.random.RandomState(2).randn(D).astype(np.float32)
    ref = jax_tf.TorchLayerNorm().apply({"params": {"a_2": a2, "b_2": b2}}, x)
    ln = tf.TorchLayerNorm(D, device="cpu")
    ln.load_state_dict({"a_2": torch.from_numpy(a2), "b_2": torch.from_numpy(b2)})
    _close(ln(torch.from_numpy(x)), ref, MODULE_REL)


def test_feed_forward_matches():
    jff = jax_tf.FeedForward(D, 2 * D, dropout=0.0)
    x = np.random.RandomState(3).randn(2, 6, D).astype(np.float32)
    variables = jff.init(jax.random.PRNGKey(1), x)
    ff = tf.FeedForward(D, 2 * D, dropout=0.0, device="cpu")
    ff.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    _close(ff(torch.from_numpy(x)), jff.apply(variables, x), MODULE_REL)


@pytest.mark.parametrize("block_k", [0, 4])
def test_multi_headed_attention_matches(block_k):
    jmha = jax_tf.MultiHeadedAttention(8, D, dropout=0.0, block_k=block_k)
    r = np.random.RandomState(4)
    qx = r.randn(2, 5, D).astype(np.float32)
    kx = r.randn(2, 9, D).astype(np.float32)
    mask = r.rand(2, 5, 9) > 0.3
    mask[0, 1] = False
    variables = jmha.init(jax.random.PRNGKey(2), qx, kx, kx, mask)
    mha = tf.MultiHeadedAttention(8, D, dropout=0.0, block_k=block_k, device="cpu")
    mha.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    got = mha(*_tensors(qx, kx, kx, mask))
    if block_k == 0:
        _close(got, jmha.apply(variables, qx, kx, kx, mask), MODULE_REL)
    else:  # the JAX blockwise's padded fully masked row aside (see above)
        ref = jax_tf.MultiHeadedAttention(8, D, dropout=0.0).apply(variables, qx, kx, kx, mask)
        _close(got, ref, MODULE_REL)


@pytest.mark.parametrize("N", [1, 2])
def test_encoder_decoder_forward_matches(N):
    jm, variables, tm = _models(N=N, seed=N)
    r = np.random.RandomState(N)
    src = r.randn(2, 7, D).astype(np.float32)
    tgt = r.randn(2, 5, D).astype(np.float32)
    src_mask = np.ones((2, 1, 7), bool)
    src_mask[1, 0, 4:] = False
    tgt_mask = np.asarray(jax_tf.subsequent_mask(5)) & (r.rand(2, 1, 5) > 0.2)
    ref_out = jm.apply(variables, src, tgt, src_mask, tgt_mask)
    ref_gen = jm.apply(variables, ref_out, method=jax_tf.EncoderDecoder.generator)
    with torch.no_grad():
        out = tm(*_tensors(src, tgt, src_mask, tgt_mask))
        _close(out, ref_out, MODULE_REL, "decoder output")
        _close(tm.generator(out), ref_gen, MODULE_REL, "generator")
        _close(tm.encode(*_tensors(src, src_mask)),
               jm.apply(variables, src, src_mask, method=jax_tf.EncoderDecoder.encode), MODULE_REL, "memory")
    np.testing.assert_array_equal(tf.subsequent_mask(5).numpy(), np.asarray(jax_tf.subsequent_mask(5)))


def test_weights_carry_both_ways_in_jax_order():
    _, variables, tm = _models(N=2)
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    names = tf.jax_order(tm)
    assert len(names) == len(flat)
    params = dict(tm.named_parameters())
    for name, (path, leaf) in zip(names, flat):
        assert tuple(k.key for k in path)[1:] == tf._jax_path(name)
        np.testing.assert_array_equal(tf.tensor_to_jax(name, params[name]), np.asarray(leaf))


def test_init_model_is_xavier_and_seeded():
    tm = tf.init_model(tf.make_model(2, D, D, N=1, d_model=D, device="cpu"), seed=3)
    again = tf.init_model(tf.make_model(2, D, D, N=1, d_model=D, device="cpu"), seed=3)
    jm = jax_tf.make_model(2, D, D, N=1, d_model=D)
    ref = jax.tree.map(np.asarray, jax_tf.init_model(jm, jax.random.PRNGKey(0)))
    ref_flat = dict(zip(tf.jax_order(tm), jax.tree.leaves(ref)))
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p, dict(again.named_parameters())[name], rtol=0, atol=0)
        r = ref_flat[name]
        if p.ndim == 2:
            bound = np.sqrt(6.0 / sum(p.shape))
            assert float(p.abs().max()) <= bound and float(p.abs().max()) > 0.9 * bound
            assert np.abs(r).max() <= bound
        else:
            np.testing.assert_array_equal(_np(p), r)
    assert tf.count_params(tm) == sum(x.size for x in jax.tree.leaves(ref))


def test_bf16_raises():
    """bf16 is ported (tests/test_torch_bf16.py); any other dtype raises."""
    tf.make_model(2, D, D, d_model=D, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cpu")
    for kw in ({"dtype": torch.float16}, {"param_dtype": torch.float16}, {"dtype": torch.float64}):
        with pytest.raises(NotImplementedError):
            tf.make_model(2, D, D, d_model=D, device="cpu", **kw)


# ----------------------------------------------------------- cached decode ---


@pytest.mark.parametrize("masked", [False, True])
def test_greedy_decode_cached_matches_jax(masked):
    jm, variables, tm = _models(N=2, seed=7)
    src = np.random.RandomState(7).randn(1, 8, D).astype(np.float32)
    src_mask = None
    if masked:
        src_mask = np.ones((1, 1, 8), bool)
        src_mask[0, 0, 5:] = False
    start = np.tile(np.asarray(jax_codec.START_GAUSSIAN), 4)
    ref = jax_greedy_cached(jm, variables, jnp.asarray(src), None if src_mask is None else jnp.asarray(src_mask),
                            6, jnp.asarray(start))
    got = greedy_decode_cached(tm, torch.from_numpy(src),
                               None if src_mask is None else torch.from_numpy(src_mask), 6,
                               torch.from_numpy(start))
    _close(got, ref, DECODE_REL)


def test_decode_step_teacher_forced_matches_jax_and_decoder_rows():
    """Each position of ``decode_step`` fed a fixed prefix equals the JAX
    step and the full decoder's row at that position."""
    jm, variables, tm = _models(N=2, seed=8)
    r = np.random.RandomState(8)
    src = r.randn(1, 6, D).astype(np.float32)
    ys = r.randn(1, 5, D).astype(np.float32)
    jstate = jax_init_state(jm, variables, jnp.asarray(src), None, 5)
    state = init_decode_state(tm, torch.from_numpy(src), None, 5)
    with torch.no_grad():
        full = tm.generator(tm.decode(tm.encode(torch.from_numpy(src), None), None, torch.from_numpy(ys),
                                      tf.subsequent_mask(5)))
    for pos in range(5):
        jout, jstate = jax_decode_step(jm, variables, jstate, jnp.asarray(ys[:, pos:pos + 1]), pos)
        out = decode_step(tm, state, torch.from_numpy(ys[:, pos:pos + 1]), pos)
        _close(out, jout, DECODE_REL, f"step {pos} vs JAX")
        _close(out, full[:, pos], DECODE_REL, f"step {pos} vs decoder row")
