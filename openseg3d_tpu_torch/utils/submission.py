"""Waymo 3D semantic segmentation submission writer.

A copy of ``openseg3d_tpu/utils/submission.py`` (numpy and the optional
waymo_open_dataset protos; that package's ``utils/__init__`` imports JAX,
so the port keeps its own). Per-frame point predictions are
scattered back into the 64 x 2650 x 2 range image (two returns) using the
(col, row, return_index) columns carried through the pipeline; each range
image is packed as a zlib-compressed ``MatrixInt32`` into a ``Laser`` proto
(``ri_return1/ri_return2.segmentation_label_compressed``) appended to the
frame's repeated ``segmentation_labels`` field — the exact schema the Waymo
eval server accepts (reference submission.py:47-57).

The waymo_open_dataset protos are an optional dependency; the range-image
assembly (the numpy logic) is pure and testable without it, and the proto
path is exercised in tests against a stub module.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

RANGE_IMAGE_SHAPE = (64, 2650)


def assemble_range_image_labels(pred_labels: np.ndarray, points_ri: np.ndarray):
    """Scatter per-point class predictions (0-based) into the two-return range
    image as 1-based labels (0 = undefined). points_ri columns: (col, row,
    return_index). Mirrors reference submission.py:28-43 (channel 0, the
    instance id, stays 0 for semseg; labels go into channel 1)."""
    h, w = RANGE_IMAGE_SHAPE
    out = [np.zeros((h, w, 2), np.int32) for _ in range(2)]
    ri = np.asarray(points_ri)
    lab = np.asarray(pred_labels).astype(np.int32) + 1
    for r in (0, 1):
        m = ri[:, 2] == r
        cols, rows = ri[m, 0], ri[m, 1]
        ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        out[r][rows[ok], cols[ok], 1] = lab[m][ok]
    return out


def compress_array(array: np.ndarray, is_int32: bool = False) -> bytes:
    """zlib-compressed serialized MatrixInt32/MatrixFloat proto
    (reference submission.py:8-25): shape dims + flattened data."""
    from waymo_open_dataset import dataset_pb2

    m = dataset_pb2.MatrixInt32() if is_int32 else dataset_pb2.MatrixFloat()
    m.shape.dims.extend(list(array.shape))
    m.data.extend(array.reshape([-1]).tolist())
    return zlib.compress(m.SerializeToString())


def construct_seg_frame(pred_labels, points_ri, context_name, timestamp):
    """Build one frame's SegmentationFrame proto (reference
    submission.py:27-57): a TOP ``Laser`` with both returns' compressed label
    range images, appended to the repeated ``segmentation_labels`` field."""
    try:
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.protos import segmentation_metrics_pb2
    except ImportError as e:  # pragma: no cover - external dependency
        raise ImportError(
            'waymo_open_dataset is required to write eval-server submissions; '
            'install it in the offline tooling environment '
            '(docs/INSTALL parity: the reference has the same dependency)') from e

    ri1, ri2 = assemble_range_image_labels(pred_labels, points_ri)

    segmentation_frame = segmentation_metrics_pb2.SegmentationFrame()
    segmentation_frame.context_name = str(context_name)
    segmentation_frame.frame_timestamp_micros = int(timestamp)
    laser_semseg = dataset_pb2.Laser()
    laser_semseg.name = dataset_pb2.LaserName.TOP
    laser_semseg.ri_return1.segmentation_label_compressed = compress_array(
        ri1, is_int32=True)
    laser_semseg.ri_return2.segmentation_label_compressed = compress_array(
        ri2, is_int32=True)
    segmentation_frame.segmentation_labels.append(laser_semseg)
    return segmentation_frame


def write_submission_file(frames, save_dir, account='', method_name='openseg3d_tpu_torch',
                          description=''):
    """Pack frames into a SemanticSegmentationSubmission file (reference
    submission.py:60-77): ``inference_results`` is a SegmentationFrameList."""
    from waymo_open_dataset.protos import (segmentation_metrics_pb2,
                                           segmentation_submission_pb2)

    frame_list = segmentation_metrics_pb2.SegmentationFrameList()
    for f in frames:
        frame_list.frames.append(f)

    sub = segmentation_submission_pb2.SemanticSegmentationSubmission()
    sub.account_name = account
    sub.unique_method_name = method_name
    sub.description = description
    sub.sensor_type = 1
    sub.number_past_frames_exclude_current = 0
    sub.number_future_frames_exclude_current = 0
    sub.inference_results.CopyFrom(frame_list)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, 'wod_test_set_pred_semantic_seg.bin')
    with open(path, 'wb') as fp:
        fp.write(sub.SerializeToString())
    return path
