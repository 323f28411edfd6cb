"""The port's losses against ``mrp_gnn_tpu.losses``: values and gradients,
with padded nodes, pixels without ground truth (target 0) and, for berHu,
a tie at the maximum residual (its gradient flows through the max).

Tolerance 1e-5 relative: the same f32 arithmetic, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import losses as JL
from mrp_gnn_tpu_torch import losses as TL

TOL = dict(rtol=1e-5, atol=1e-6)
V, H, W, K = 5, 6, 7, 6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.2, 10.0, size=(V, H, W)).astype(np.float32)
    target = rng.uniform(0.2, 10.0, size=(V, H, W)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = 0.0  # no ground truth
    node_mask = np.array([True, True, False, True, False])
    logits = rng.normal(size=(V, H, W, K)).astype(np.float32)
    labels = rng.integers(0, K, size=(V, H, W)).astype(np.int32)
    return pred, target, node_mask, logits, labels


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("kind", ["l1", "berhu", "silog"])
def test_depth_loss_value_and_grad_match_jax(kind):
    pred, target, node_mask, _, _ = _batch(1)
    if kind == "berhu":
        # two valid pixels share the largest residual: a tie at the max
        valid = (target > 0) & node_mask[:, None, None]
        (a, b) = np.argwhere(valid)[:2]
        target[tuple(a)], pred[tuple(a)] = 1.0, 40.0
        target[tuple(b)], pred[tuple(b)] = 2.0, 41.0
    jfn, tfn = JL.DEPTH_LOSSES[kind], TL.DEPTH_LOSSES[kind]
    want, want_g = jax.value_and_grad(jfn)(pred, target, node_mask)
    p, t, m = _torch(pred, target, node_mask)
    p.requires_grad_()
    got = tfn(p, t, m)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)
    masked = ~(np.asarray(target > 0) & node_mask[:, None, None])
    assert (p.grad.numpy()[masked] == 0).all()


def test_seg_ce_value_and_grad_match_jax():
    _, _, node_mask, logits, labels = _batch(2)
    want, want_g = jax.value_and_grad(JL.masked_seg_ce)(
        logits, jnp.asarray(labels), node_mask)
    lg, lb, m = _torch(logits, labels, node_mask)
    lg.requires_grad_()
    got = TL.masked_seg_ce(lg, lb, m)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), **TOL)
    assert (lg.grad.numpy()[~node_mask] == 0).all()


@pytest.mark.parametrize("depth_loss", ["l1", "berhu"])
def test_total_loss_terms_match_jax(depth_loss):
    pred, target, node_mask, logits, labels = _batch(3)
    out_j = {"depth": pred, "seg_logits": logits}
    batch_j = {"depth": target, "seg": jnp.asarray(labels)}
    loss_j, terms_j = JL.total_loss(out_j, batch_j, node_mask, 1.0, 0.5,
                                    depth_loss=depth_loss)
    p, t, m, lg, lb = _torch(pred, target, node_mask, logits, labels)
    loss_t, terms_t = TL.total_loss({"depth": p, "seg_logits": lg},
                                    {"depth": t, "seg": lb}, m, 1.0, 0.5,
                                    depth_loss=depth_loss)
    assert sorted(terms_t) == sorted(terms_j) == sorted(
        [f"depth_{depth_loss}", "seg_ce", "total"])
    for key in terms_j:
        np.testing.assert_allclose(float(terms_t[key]), float(terms_j[key]),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
