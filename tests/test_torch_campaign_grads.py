"""Port parity for the stacked campaign's bf16 gradients: the bf16 decode's
backward (train/stacked.py greedy_decode on a bf16 model) against the JAX
package's, both given one cotangent, in both chamfer-gate branches, on
tests/test_torch_campaign.py's STACK-2 model, scene and batch.

The cotangent is the port's loss's gradient in the JAX decode's rows. The
rows are the float32 generator's output, so that gradient is the float32
loss that tests/test_torch_stacked.py holds to the JAX package's. The split
keeps the check well conditioned: end to end, the image branch's bf16
gradient also moves far in the JAX package itself when a few of its bf16
weights move by one ulp (renders of decoded rows that differ by bf16
noise). ``python -m tests.test_torch_campaign_grads --seeds 5 8 9`` prints
the readings: this check's, its planted faults', the two packages' end to
end, and the JAX package's own under that one-ulp noise.

Tolerances, set from those readings: per parameter tensor the norm of the
difference within 0.25 of the JAX gradient's norm (seeds 5, 8 and 9 read
0.03-0.12 in both branches); the attention key biases, whose exact
gradient is zero (a row's softmax ignores a shift of its scores), within
1e-2 of the median leaf norm. A bias gradient of the wrong sign reads ~2
and a halved gradient ~0.5: the test plants both and requires that they
fail."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.train import stacked as js
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.train import stacked as ps

from tests.test_torch_campaign import STACK, _batch_pair, _case, scenes  # noqa: F401 (scenes: the fixture)

GRAD_REL = 0.25  # the decode's backward of one cotangent: per tensor, ||port - JAX|| / ||JAX||
K_BIAS_SHARE = 1e-2  # the attention key biases' gradient norms (exactly 0 in exact arithmetic) / median leaf norm
PLANTS = {
    "bias sign flipped": lambda n, g: -g if n.endswith(".bias") else g,
    "halved": lambda n, g: 0.5 * g,
}


def _grad_readings(names, got: dict, jax_grads) -> tuple:
    """Per leaf, ||got - ref|| / ||ref|| (flax layouts) for every leaf but
    the attention key biases, and for those the larger of the two norms
    over the median leaf norm of ``ref``. Returns (the worst leaf's ratio,
    its name, the key biases' worst share)."""
    rel, k_bias, norms = {}, [], []
    for name, leaf in zip(names, jax.tree.leaves(jax_grads)):
        g, ref = got[name], np.asarray(leaf).astype(np.float32)
        assert g.shape == ref.shape and np.all(np.isfinite(g)), name
        norms.append(np.linalg.norm(ref))
        if name.endswith(".k.bias"):
            k_bias.append(max(np.linalg.norm(g), np.linalg.norm(ref)))
        else:
            rel[name] = float(np.linalg.norm(g - ref) / np.linalg.norm(ref))
    worst = max(rel, key=rel.get)
    return rel[worst], worst, float(max(k_bias) / np.median(norms))


def _port_grads(tm) -> dict:
    return {n: tf.tensor_to_jax(n, p.grad.float()) for n, p in tm.named_parameters()}


def decode_backward(scenes, near_target: bool, seed: int = 5):
    """Both packages' decode backward given one cotangent (the port's loss's
    gradient in the JAX decode's rows). Returns (names, the port's
    gradients by name in flax layouts, the JAX gradient tree)."""
    _, pts = scenes
    jm, variables, tm, trg_y = _case(scenes, near_target, seed)
    jb, pb = _batch_pair(scenes)
    pt = pb.trg_y if trg_y is None else torch.from_numpy(np.array(trg_y))
    L = pt.shape[1] + 1
    rows, decode_vjp = jax.vjp(lambda v: js.greedy_decode(jm, v, jb.src, jb.src_mask, L, STACK)[:, 1:], variables)

    r = torch.from_numpy(np.array(rows)).requires_grad_()
    with mock.patch.object(ps, "greedy_decode", lambda *a, **k: torch.cat([torch.zeros_like(r[:, :1]), r], 1)):
        loss, met = ps.make_loss_fn(tm, pts.handler, pts.render_cfg, STACK)(pb.src, pt, pb.cameras, pb.src_mask)
    assert (float(met["chamfer"]) < 3.0) == near_target
    loss.backward()

    (jax_grads,) = decode_vjp(jnp.asarray(r.grad.numpy()))
    ps.greedy_decode(tm, pb.src, pb.src_mask, L, STACK)[:, 1:].backward(r.grad)
    return tf.jax_order(tm), _port_grads(tm), jax_grads


@pytest.mark.parametrize("near_target", [False, True], ids=["chamfer_only", "image_branch"])
def test_bf16_gradients_match_jax(scenes, near_target):
    """Per parameter tensor the decode backward's difference within
    GRAD_REL of the JAX gradient's norm, the key biases within
    K_BIAS_SHARE of the median leaf norm; the planted faults fail."""
    names, got, jax_grads = decode_backward(scenes, near_target)
    worst, name, k_share = _grad_readings(names, got, jax_grads)
    assert worst <= GRAD_REL and k_share <= K_BIAS_SHARE, (worst, name, k_share)
    for what, plant in PLANTS.items():
        planted, _, _ = _grad_readings(names, {n: plant(n, g) for n, g in got.items()}, jax_grads)
        assert planted > GRAD_REL, (what, planted)


def end_to_end(scenes, near_target: bool, seed: int):
    """The step's whole gradient in both packages, each from its own decode:
    (names, the port's by name, the JAX tree), and the JAX package's at
    weights where a tenth of the nonzero bf16 elements moved one ulp up or
    down (numpy seed ``seed``)."""
    jts, pts = scenes
    jm, variables, tm, trg_y = _case(scenes, near_target, seed)
    jb, pb = _batch_pair(scenes)
    jt = jb.trg_y if trg_y is None else jnp.asarray(trg_y)
    pt = pb.trg_y if trg_y is None else torch.from_numpy(np.array(trg_y))
    grad_fn = jax.jit(jax.grad(lambda v: js.make_loss_fn(jm, jts.handler, jts.render_cfg, STACK)(
        v, jb.src, jt, jb.cameras, jb.src_mask)[0]))
    r = np.random.RandomState(seed)

    def one_ulp(x):
        x = np.asarray(x)
        if x.dtype != jnp.bfloat16:
            return jnp.asarray(x)
        step = r.choice([-1, 1], size=x.shape) * (r.rand(*x.shape) < 0.1) * (x != 0)
        return jnp.asarray((x.view(np.uint16).astype(np.int32) + step).astype(np.uint16).view(jnp.bfloat16))

    loss, _ = ps.make_loss_fn(tm, pts.handler, pts.render_cfg, STACK)(pb.src, pt, pb.cameras, pb.src_mask)
    loss.backward()
    names, jax_grads = tf.jax_order(tm), grad_fn(variables)
    moved = grad_fn(jax.tree.map(one_ulp, variables))
    return names, _port_grads(tm), jax_grads, {n: np.asarray(g, np.float32) for n, g in zip(names, jax.tree.leaves(moved))}


if __name__ == "__main__":
    # The readings behind the tolerances (CPU, a few minutes):
    # python -m tests.test_torch_campaign_grads [--seeds 5 8 9]
    import argparse

    from tests.test_torch_campaign import scenes as scenes_fixture

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 8, 9])
    a = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    sc = scenes_fixture._get_wrapped_function()()
    print("seed | branch | decode backward: worst leaf, key-bias share | planted: " + ", ".join(PLANTS)
          + " | end to end: port vs JAX | JAX vs JAX at one-ulp noise")
    for seed in a.seeds:
        for near in (False, True):
            names, got, jg = decode_backward(sc, near, seed)
            worst, name, k_share = _grad_readings(names, got, jg)
            planted = [_grad_readings(names, {n: f(n, g) for n, g in got.items()}, jg)[0] for f in PLANTS.values()]
            names, got, jg, moved = end_to_end(sc, near, seed)
            e2e, self_ = _grad_readings(names, got, jg)[0], _grad_readings(names, moved, jg)[0]
            print(f"{seed} | {'image' if near else 'chamfer-only'} | {worst:.4f} ({name}), {k_share:.2e} | "
                  + ", ".join(f"{x:.3f}" for x in planted) + f" | {e2e:.4f} | {self_:.4f}", flush=True)
