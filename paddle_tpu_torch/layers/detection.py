"""Detection layers of the port (counterpart of
``paddle_tpu/layers/detection.py``, every function of it): one op of
``ops/detection.py`` each, built as the JAX package builds it."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["prior_box", "anchor_generator", "iou_similarity", "box_coder",
           "box_clip", "yolo_box", "multiclass_nms", "roi_align", "roi_pool"]


def _one_out(helper, dtype="float32", stop_gradient=False):
    return helper.create_variable_for_type_inference(dtype, stop_gradient)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes = _one_out(helper, input.dtype, True)
    var = _one_out(helper, input.dtype, True)
    helper.append_op("prior_box", inputs={"Input": input, "Image": image},
                     outputs={"Boxes": boxes, "Variances": var},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios),
                            "variances": list(variance), "flip": flip,
                            "clip": clip, "step_w": steps[0],
                            "step_h": steps[1], "offset": offset,
                            "min_max_aspect_ratios_order":
                                min_max_aspect_ratios_order})
    return boxes, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = _one_out(helper, input.dtype, True)
    var = _one_out(helper, input.dtype, True)
    helper.append_op(
        "anchor_generator", inputs={"Input": input},
        outputs={"Anchors": anchors, "Variances": var},
        attrs={"anchor_sizes": list(anchor_sizes or [64., 128., 256., 512.]),
               "aspect_ratios": list(aspect_ratios or [0.5, 1.0, 2.0]),
               "variances": list(variance),
               "stride": list(stride or [16.0, 16.0]), "offset": offset})
    return anchors, var


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = _one_out(helper, x.dtype, True)
    helper.append_op("iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"box_normalized": box_normalized})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    out = _one_out(helper, target_box.dtype)
    ins = {"PriorBox": prior_box, "TargetBox": target_box}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = prior_box_var
    helper.append_op("box_coder", inputs=ins, outputs={"OutputBox": out},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized, "axis": axis})
    return out


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = _one_out(helper, input.dtype)
    helper.append_op("box_clip", inputs={"Input": input, "ImInfo": im_info},
                     outputs={"Output": out})
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = _one_out(helper, x.dtype, True)
    scores = _one_out(helper, x.dtype, True)
    helper.append_op("yolo_box", inputs={"X": x, "ImgSize": img_size},
                     outputs={"Boxes": boxes, "Scores": scores},
                     attrs={"anchors": list(anchors),
                            "class_num": int(class_num),
                            "conf_thresh": float(conf_thresh),
                            "downsample_ratio": int(downsample_ratio)})
    return boxes, scores


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = _one_out(helper, bboxes.dtype, True)
    helper.append_op("multiclass_nms",
                     inputs={"BBoxes": bboxes, "Scores": scores},
                     outputs={"Out": out},
                     attrs={"background_label": background_label,
                            "score_threshold": float(score_threshold),
                            "nms_top_k": int(nms_top_k),
                            "nms_threshold": float(nms_threshold),
                            "nms_eta": float(nms_eta),
                            "keep_top_k": int(keep_top_k),
                            "normalized": normalized})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch_idx=None,
              name=None):
    helper = LayerHelper("roi_align", name=name)
    out = _one_out(helper, input.dtype)
    ins = {"X": input, "ROIs": rois}
    if rois_batch_idx is not None:
        ins["RoisBatchIdx"] = rois_batch_idx
    helper.append_op("roi_align", inputs=ins, outputs={"Out": out},
                     attrs={"spatial_scale": float(spatial_scale),
                            "pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width),
                            "sampling_ratio": int(sampling_ratio)})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch_idx=None, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = _one_out(helper, input.dtype)
    ins = {"X": input, "ROIs": rois}
    if rois_batch_idx is not None:
        ins["RoisBatchIdx"] = rois_batch_idx
    helper.append_op("roi_pool", inputs=ins, outputs={"Out": out},
                     attrs={"spatial_scale": float(spatial_scale),
                            "pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width)})
    return out
