"""Port parity for the bf16 transformer: the ``dtype``/``param_dtype`` of
models/transformer.py, ops/attention.py blockwise attention in bf16 and the
bf16 cached decode (models/decode_cache.py), against the JAX package's flax
modules on the same seeded numpy inputs, weights carried over with
``params_from_jax``. Small sizes: d_model 32-64, h 8, N 1-2, dropout 0.

Tolerances, written before the first run:
  * the encoder-decoder (bf16 compute, both attention paths) within 3e-2 x
    max|JAX output| of the JAX package's: both round every product to bf16
    (8 significant bits), so two right implementations differ by rounding
    noise of ~1e-2 of the output at these widths;
  * the port's bf16 output within 0.15 of its float32 output (the JAX
    suite's own bound, tests/test_models.py TestBf16);
  * every parameter's dtype equal to the flax tree's leaf; bf16 leaves
    through ``params_from_jax``/``tensor_to_jax`` bit for bit;
  * blockwise attention in bf16 within 2e-2 x max|JAX output| of the JAX
    function (one bf16 ulp is 2^-8 = 3.9e-3 relative), and its per-block
    recompute equal to the plain loop bit for bit;
  * the bf16 cached decode, teacher-forced, within 2e-2 x max|row| of the
    bf16 decoder's rows (a product over one row may round otherwise than
    over the sequence)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.models import transformer as jax_tf
from gaussian_transformer_tpu.ops import attention as jax_attention
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.models.decode_cache import decode_step, init_decode_state
from gaussian_transformer_tpu_torch.ops import attention

MODEL_REL = 3e-2
VS_FP32 = 0.15
ATTN_REL = 2e-2
DECODE_REL = 2e-2
BF16 = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _models(d, N, block_k, param_dtype, seed=0):
    """The JAX model (bf16 compute) with its variables, the port's twin with
    the same weights, and the port's float32 model with them too."""
    jpd, tpd = BF16[param_dtype]
    jm = jax_tf.make_model(2, d, d, N=N, d_model=d, dropout=0.0, block_k=block_k, dtype=jnp.bfloat16,
                           param_dtype=jpd)
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(seed))
    sd = tf.params_from_jax(jax.tree.map(np.asarray, variables))
    tm = tf.make_model(2, d, d, N=N, d_model=d, dropout=0.0, block_k=block_k, dtype=torch.bfloat16,
                       param_dtype=tpd, device="cpu")
    tm.load_state_dict(sd)
    t32 = tf.make_model(2, d, d, N=N, d_model=d, dropout=0.0, block_k=block_k, device="cpu")
    t32.load_state_dict({k: v.float() for k, v in sd.items()})
    return jm, variables, tm.eval(), t32.eval()


def _inputs(d, seed=1):
    r = np.random.RandomState(seed)
    src = r.randn(2, 11, d).astype(np.float32)
    tgt = r.randn(2, 9, d).astype(np.float32)
    src_mask = np.ones((2, 1, 11), bool)
    src_mask[1, 0, 7:] = False
    return src, tgt, src_mask, np.asarray(jax_tf.subsequent_mask(9))


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block_k,d,N", [(0, 64, 2), (8, 32, 1)], ids=["dense", "blockwise"])
def test_encoder_decoder_matches_jax(param_dtype, block_k, d, N):
    jm, variables, tm, t32 = _models(d, N, block_k, param_dtype)
    jleaves = dict(zip(tf.jax_order(tm), jax.tree.leaves(variables)))
    for name, p in tm.named_parameters():
        assert str(p.dtype).removeprefix("torch.") == str(jleaves[name].dtype), name
    assert tm.generator_proj.weight.dtype == tm.encoder.norm.a_2.dtype == torch.float32

    src, tgt, sm, tmask = _inputs(d)
    out = jm.apply(variables, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(sm), jnp.asarray(tmask))
    ref = np.asarray(jm.apply(variables, out, method=jax_tf.EncoderDecoder.generator))
    args = [torch.from_numpy(a) for a in (src, tgt, sm, tmask)]
    with torch.no_grad():
        hidden = tm(*args)
        got = tm.generator(hidden)
        got32 = t32.generator(t32(*args))
    assert hidden.dtype == torch.float32 and out.dtype == jnp.float32  # the decoder's final norm is float32
    assert got.dtype == torch.float32
    scale = float(np.abs(ref).max())
    err = float(np.abs(_np(got) - ref).max())
    assert err <= MODEL_REL * scale, (err, scale)
    assert float((got - got32).abs().max()) < VS_FP32


def test_residual_stream_and_scores_dtypes():
    """The embeddings' bf16 output makes the residual bf16; a norm of it is
    float32; the dense path's scores are float32 and its output bf16."""
    _, _, tm, _ = _models(32, 1, 0, "bf16")
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 5, 32).astype(np.float32))
    with torch.no_grad():
        emb = tm.src_embed(x)
        normed = tm.encoder.layer0.sub0.norm(emb)
        attn = tm.encoder.layer0.self_attn(normed, normed, normed)
    assert emb.dtype == torch.bfloat16 and normed.dtype == torch.float32 and attn.dtype == torch.bfloat16


def test_other_dtypes_raise():
    with pytest.raises(NotImplementedError):
        tf.make_model(2, 32, 32, d_model=32, dtype=torch.float16, device="cpu")
    with pytest.raises(NotImplementedError):
        tf.make_model(2, 32, 32, d_model=32, param_dtype=torch.float64, device="cpu")


def test_bf16_leaves_round_trip_bit_for_bit():
    jm = jax_tf.make_model(2, 32, 32, N=1, d_model=32, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    variables = jax.tree.map(np.asarray, jax_tf.init_model(jm, jax.random.PRNGKey(3)))
    sd = tf.params_from_jax(variables)
    tm = tf.make_model(2, 32, 32, N=1, d_model=32, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(sd)
    n_bf16 = 0
    for name, leaf in zip(tf.jax_order(tm), jax.tree.leaves(variables)):
        back = tf.tensor_to_jax(name, sd[name])
        if tf.is_bf16(leaf):
            n_bf16 += 1
            assert back.dtype == np.uint16  # the JAX package's npz view
            np.testing.assert_array_equal(back, leaf.view(np.uint16), err_msg=name)
            again = tf.numpy_to_tensor(back, torch.bfloat16)
            assert torch.equal(again.view(torch.int16), (sd[name].T if name.endswith("weight") else sd[name])
                               .contiguous().view(torch.int16)), name
        else:
            np.testing.assert_array_equal(back, leaf, err_msg=name)
    assert n_bf16 == sum(1 for n, p in tm.named_parameters() if p.dtype == torch.bfloat16) > 0


def _qkv(seed, lq=6, lk=13, d=16, lead=(2, 3)):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(*lead, n, d).astype(np.float32) for n in (lq, lk, lk))
    mask = r.rand(lead[0], 1, lq, lk) > 0.3
    mask[..., 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("block_k", [4, 8])
def test_blockwise_attention_bf16_matches_jax(block_k):
    q, k, v, mask = _qkv(4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_attention.blockwise_attention(jq, jk, jv, jnp.asarray(mask), block_k=block_k))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention.blockwise_attention(tq, tk, tv, torch.from_numpy(mask), block_k=block_k)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = ref.astype(np.float32)
    assert float(np.abs(_np(got) - ref).max()) <= ATTN_REL * float(np.abs(ref).max())


def test_blockwise_recompute_bf16_matches_the_plain_loop():
    """bf16 outputs and gradients with each key block recomputed in
    backward equal the plain loop's bit for bit, dropout included."""
    q, k, v, mask = _qkv(5)
    outs, grads = [], []
    for remat in (True, False):
        t = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]
        gen = torch.Generator().manual_seed(7)
        out = attention.blockwise_attention(*t, torch.from_numpy(mask), block_k=4, dropout_rate=0.2,
                                            generator=gen, remat=remat)
        (out.float() ** 2).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad for x in t])
    assert outs[0].dtype == torch.bfloat16 and torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_cached_decode_matches_the_bf16_scan_decode(param_dtype):
    """Teacher-forced: each position of ``decode_step`` against the bf16
    decoder's row there; the caches are held in bf16."""
    _, _, tm, _ = _models(64, 2, 0, param_dtype, seed=6)
    r = np.random.RandomState(6)
    src = torch.from_numpy(r.randn(1, 7, 64).astype(np.float32))
    ys = torch.from_numpy(r.randn(1, 6, 64).astype(np.float32))
    with torch.no_grad():
        rows = tm.generator(tm.decode(tm.encode(src, None), None, ys, tf.subsequent_mask(6)))
        state = init_decode_state(tm, src, None, 6)
        assert all(t.dtype == torch.bfloat16 for t in state["layers"][0].values())
        steps = torch.stack([decode_step(tm, state, ys[:, i:i + 1], i) for i in range(6)], 1)
    assert steps.dtype == rows.dtype == torch.float32
    err = float((steps - rows).abs().max())
    assert err <= DECODE_REL * float(rows.abs().max()), err
