"""``metrics`` of the port against the JAX package's, on the CPU: every
class fed the same numpy data in both packages gives exactly equal
results (both are numpy on the host), ``DetectionMAP`` in both modes
with difficult ground truth and -1 padding rows included. The port's
``update`` also takes fetched torch tensors, read on the host."""
import numpy as np
import pytest
import torch

import paddle_tpu.metrics as jm
import paddle_tpu_torch.metrics as tm


def both(name, *args, **kwargs):
    return getattr(jm, name)(*args, **kwargs), \
        getattr(tm, name)(*args, **kwargs)


def feed_both(pair, *updates):
    for args in updates:
        pair[0].update(*args)
        pair[1].update(*[torch.from_numpy(np.asarray(a))
                         if isinstance(a, np.ndarray) else a for a in args])
    return pair[0].eval(), pair[1].eval()


def test_the_exports_are_the_jax_packages():
    assert tm.__all__ == jm.__all__
    assert len(tm.__all__) == 9


RNG = np.random.RandomState(0)


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_equal_jax(name):
    ups = []
    for _ in range(3):
        p = RNG.rand(50).astype(np.float32)
        if name == "Auc":
            p = np.stack([1 - p, p], 1)
        ups.append((p, RNG.randint(0, 2, (50, 1)).astype(np.int64)))
    j, t = feed_both(both(name), *ups)
    assert j == t


def test_accuracy_composite_chunk_and_edit_distance_equal_jax():
    j, t = feed_both(both("Accuracy"), (np.array([0.75], np.float32), 4),
                     (np.array([0.5], np.float32), 2))
    assert j == t
    jc, tc = both("CompositeMetric")
    for c, mod in ((jc, jm), (tc, tm)):
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
    p = RNG.rand(40).astype(np.float32)
    lab = RNG.randint(0, 2, 40).astype(np.int64)
    j, t = feed_both((jc, tc), (p, lab))
    assert j == t and len(t) == 2
    j, t = feed_both(both("ChunkEvaluator"), (np.array([5]), np.array([6]),
                                             np.array([4])),
                     (np.array([3]), np.array([2]), np.array([2])))
    assert j == t
    j, t = feed_both(both("EditDistance"),
                     (np.array([0.0, 2.0, 1.0], np.float32), 3),
                     (np.array([0.0, 3.0], np.float32), 2))
    assert j == t


def detections(rng, n_img=4, classes=3):
    """Per image: -1-padded NMS rows and ground truth with a difficult
    flag, boxes on a 1/16 grid so the IoUs are exact."""
    ups = []
    for _ in range(n_img):
        g = rng.randint(1, 5)
        gt = np.zeros((g, 6))
        gt[:, 0] = rng.randint(0, classes, g)
        xy = np.round(rng.rand(g, 2) * 8) / 16
        gt[:, 1:3], gt[:, 3:5] = xy, xy + 0.25 + np.round(
            rng.rand(g, 2) * 4) / 16
        gt[:, 5] = rng.rand(g) < 0.3
        d = 10
        det = -np.ones((d, 6), np.float32)
        k = rng.randint(3, d)
        src = gt[rng.randint(0, g, k)]
        det[:k, 0] = np.where(rng.rand(k) < 0.8, src[:, 0],
                              rng.randint(0, classes, k))
        det[:k, 1] = rng.permutation(k) / 16.0 + 0.0625
        det[:k, 2:] = src[:, 1:5] + np.round(rng.randn(k, 4)) / 32
        ups.append((det.astype(np.float32), gt))
    return ups


@pytest.mark.parametrize("ap_version", ["11point", "integral"])
@pytest.mark.parametrize("difficult", [False, True])
def test_detection_map_equals_jax(ap_version, difficult):
    ups = detections(np.random.RandomState(3))
    j, t = feed_both(both("DetectionMAP", overlap_threshold=0.5,
                          evaluate_difficult=difficult,
                          ap_version=ap_version), *ups)
    assert j == t and 0.0 < t < 1.0


def test_detection_map_refuses_an_unknown_mode_and_no_ground_truth():
    with pytest.raises(ValueError, match="ap_version"):
        tm.DetectionMAP(ap_version="voc")
    with pytest.raises(ValueError, match="no ground truths"):
        tm.DetectionMAP().eval()
