"""Host-side metrics of the port (counterpart of ``paddle_tpu/metrics.py``,
every class of it), in numpy. ``update`` takes numpy arrays, Python
numbers or fetched torch tensors, a tensor on the card included: it is
copied to the host (``_host``) before anything is read."""
from __future__ import annotations

import numpy as np
import torch


def _host(v, dtype=None):
    """``v`` as a numpy array; a torch tensor is detached and copied to
    the host first."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)

__all__ = ["MetricBase", "Accuracy", "Precision", "Recall", "Auc",
           "CompositeMetric", "ChunkEvaluator", "EditDistance"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {"name": self._name}


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(_host(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates yet")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Histogram AUC matching the auc op's binning."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        nt = self._num_thresholds
        self._stat_pos = np.zeros(nt + 1, np.int64)
        self._stat_neg = np.zeros(nt + 1, np.int64)

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        p1 = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        bins = np.clip((p1 * self._num_thresholds).astype(np.int64), 0,
                       self._num_thresholds)
        pos_mask = labels.astype(bool)
        np.add.at(self._stat_pos, bins[pos_mask], 1)
        np.add.at(self._stat_neg, bins[~pos_mask], 1)

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    """F1 over chunk counts (reference metrics.py ChunkEvaluator)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer = 0
        self.num_label = 0
        self.num_correct = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer += int(_host(num_infer_chunks).reshape(-1)[0])
        self.num_label += int(_host(num_label_chunks).reshape(-1)[0])
        self.num_correct += int(_host(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        precision = self.num_correct / self.num_infer if self.num_infer else 0
        recall = self.num_correct / self.num_label if self.num_label else 0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _host(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no updates yet")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference metrics.py:695
    DetectionMAP; math follows the detection_map op's '11point'/'integral'
    modes). Host-side accumulation: update() takes per-image detections
    [[label, score, x0, y0, x1, y1], ...] and ground truths
    [[label, x0, y0, x1, y1], ...] (difficult GTs may append a 7th/6th
    flag column)."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="11point",
                 class_num=None):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        if ap_version not in ("11point", "integral"):
            raise ValueError("ap_version must be '11point' or 'integral'")
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = []   # (img_id, label, score, box)
        self._gts = []    # (img_id, label, box, difficult)
        self._img = 0

    @staticmethod
    def _iou(a, b):
        ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
        ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gts):
        img = self._img
        self._img += 1
        for d in _host(detections, np.float64).reshape(-1, 6):
            if d[0] < 0:
                continue  # -1 padding rows from multiclass_nms
            self._dets.append((img, int(d[0]), float(d[1]), d[2:6]))
        for g in _host(gts, np.float64):
            diff = bool(g[5]) if len(g) > 5 else False
            self._gts.append((img, int(g[0]), g[1:5], diff))

    def eval(self):
        labels = sorted({l for _, l, _, _ in self._gts})
        if not labels:
            raise ValueError("DetectionMAP: no ground truths")
        aps = []
        for cls in labels:
            gts = [(i, b, d) for i, l, b, d in self._gts if l == cls]
            n_pos = sum(1 for _, _, d in gts
                        if self.evaluate_difficult or not d)
            dets = sorted((d for d in self._dets if d[1] == cls),
                          key=lambda d: -d[2])
            matched = set()
            tp, fp = [], []
            for img, _, score, box in dets:
                cand = [(k, self._iou(box, b))
                        for k, (gi, b, _) in enumerate(gts) if gi == img]
                k_best, iou_best = max(cand, key=lambda kv: kv[1],
                                       default=(None, 0.0))
                if k_best is not None and iou_best >= self.overlap_threshold:
                    _, _, difficult = gts[k_best]
                    if difficult and not self.evaluate_difficult:
                        continue  # difficult GT: detection neither tp nor fp
                    if k_best in matched:
                        fp.append(1); tp.append(0)
                    else:
                        matched.add(k_best)
                        tp.append(1); fp.append(0)
                else:
                    fp.append(1); tp.append(0)
            if n_pos == 0:
                continue
            tp = np.cumsum(tp, dtype=np.float64)
            fp = np.cumsum(fp, dtype=np.float64)
            rec = tp / n_pos
            prec = tp / np.maximum(tp + fp, 1e-12)
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                    ap += p / 11.0
            else:  # integral / VOC2010-style
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


__all__.append("DetectionMAP")
