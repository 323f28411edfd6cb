"""The port's evaluation metrics against the JAX package's, on CPU.

Seeded numpy predictions and targets with zero-depth pixels, a zero
prediction, masked (padded) views and a class absent from the truth, and
a batch with no valid pixel. Tolerances: counts, the confusion matrix and
the per-class IoU are equal (exact integer counts, the same float32
division); float sums and the finalized metrics within 1e-6 relative
(float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from mrp_gnn_tpu import metrics as JM
from mrp_gnn_tpu_torch import metrics as TM

RTOL = 1e-6
K = 5


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    V, H, W = 6, 8, 8
    pred = rng.uniform(0.1, 10.0, size=(V, H, W)).astype(np.float32)
    pred[0, 0, :3] = 0.0  # the 1e-6 clamp of the prediction
    target = rng.uniform(0.1, 10.0, size=(V, H, W)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.2] = 0.0  # no depth there
    target[1, :2] = pred[1, :2] * 1.2  # inside delta1
    node_mask = np.array([True, True, True, True, False, False])
    logits = rng.normal(size=(V, H, W, K)).astype(np.float32)
    labels = rng.integers(0, K - 1, size=(V, H, W)).astype(np.int32)
    labels[4:] = K - 1  # class K-1 only on padded views: absent from truth
    if case == "empty":
        node_mask[:] = False
    return pred, target, node_mask, logits, labels


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", ["mixed", "empty"])
def test_depth_metrics_match_jax(case):
    pred, target, node_mask, _, _ = _inputs(case)
    want = _np(JM.depth_metrics_accumulate(pred, target, node_mask))
    got = TM.depth_metrics_accumulate(torch.from_numpy(pred),
                                      torch.from_numpy(target),
                                      torch.from_numpy(node_mask))
    assert sorted(got) == sorted(want)
    for k in ("n", "d1", "d2", "d3"):
        assert int(got[k]) == int(want[k]), k
    if case == "empty":
        assert int(got["n"]) == 0
    for k in ("sq_err", "abs_rel"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    fin_want = _np(JM.depth_metrics_finalize(want))
    fin_got = TM.depth_metrics_finalize(got)
    assert sorted(fin_got) == sorted(fin_want)
    for k in fin_want:
        np.testing.assert_allclose(float(fin_got[k]), float(fin_want[k]),
                                   rtol=RTOL, err_msg=k)
        assert np.isfinite(float(fin_got[k]))


@pytest.mark.parametrize("case", ["mixed", "empty"])
def test_seg_metrics_match_jax(case):
    _, _, node_mask, logits, labels = _inputs(case)
    want = np.asarray(JM.seg_confusion_accumulate(logits, labels, node_mask, K))
    got = TM.seg_confusion_accumulate(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(node_mask), K)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    per_want = np.asarray(JM.seg_per_class_iou(want))
    per_got = TM.seg_per_class_iou(got).numpy()
    np.testing.assert_array_equal(per_got, per_want)
    if case == "mixed":
        assert per_got[K - 1] == -1.0  # absent from the truth
        assert (per_got[:K - 1] >= 0).all()
    np.testing.assert_allclose(float(TM.seg_miou(got)),
                               float(JM.seg_miou(want)), rtol=RTOL)


def test_tree_add_matches_jax():
    pred, target, node_mask, logits, labels = _inputs("mixed")
    pred2, target2, _, logits2, labels2 = _inputs("mixed", seed=1)
    t = lambda a: torch.from_numpy(a)  # noqa: E731

    def jres(p, tg, lg, lb):
        return {"depth": JM.depth_metrics_accumulate(p, tg, node_mask),
                "conf": JM.seg_confusion_accumulate(lg, lb, node_mask, K)}

    def tres(p, tg, lg, lb):
        m = t(node_mask)
        return {"depth": TM.depth_metrics_accumulate(t(p), t(tg), m),
                "conf": TM.seg_confusion_accumulate(t(lg), t(lb), m, K)}

    want = JM.tree_add(jres(pred, target, logits, labels),
                       jres(pred2, target2, logits2, labels2))
    got = TM.tree_add(tres(pred, target, logits, labels),
                      tres(pred2, target2, logits2, labels2))
    np.testing.assert_array_equal(got["conf"].numpy(), np.asarray(want["conf"]))
    for k, v in want["depth"].items():
        np.testing.assert_allclose(float(got["depth"][k]), float(v),
                                   rtol=RTOL, err_msg=k)
