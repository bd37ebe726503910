"""Minimal waymo_open_dataset proto stand-in (test/rehearsal use ONLY).

A copy of ``openseg3d_tpu/utils/wod_stub.py``, plus ``read_submission``,
which decodes a file written through it.

Mimics the exact proto API surface the submission writer uses (reference
seg3d/utils/submission.py:8-77): repeated fields append/extend, message fields
CopyFrom, SerializeToString. Serialization here is pickle, NOT protobuf — a
file written through this stub is useless for the real Waymo eval server, so
installation is explicit: tests install via install(); tools/test.py only
falls back to it when OPENSEG3D_ALLOW_WOD_STUB=1 (tools/rehearsal.py sets it)
and logs loudly (and so does ``openseg3d_tpu_torch.tools.test``).
"""

from __future__ import annotations

import pickle
import sys
import types
import zlib

import numpy as np


class Repeated(list):
    pass  # append/extend from list; no CopyFrom — like real repeated fields


class Shape:
    def __init__(self):
        self.dims = Repeated()


class Matrix:
    def __init__(self):
        self.shape = Shape()
        self.data = Repeated()

    def SerializeToString(self):
        return pickle.dumps((list(self.shape.dims), list(self.data)))


class RiReturn:
    def __init__(self):
        self.segmentation_label_compressed = b''


class Laser:
    def __init__(self):
        self.name = 0
        self.ri_return1 = RiReturn()
        self.ri_return2 = RiReturn()


class LaserName:
    TOP = 1


class SegmentationFrame:
    def __init__(self):
        self.context_name = ''
        self.frame_timestamp_micros = 0
        self.segmentation_labels = Repeated()


class SegmentationFrameList:
    def __init__(self):
        self.frames = Repeated()


class _InferenceResults(SegmentationFrameList):
    def CopyFrom(self, other):
        self.frames = Repeated(other.frames)


class SemanticSegmentationSubmission:
    def __init__(self):
        self.account_name = ''
        self.unique_method_name = ''
        self.description = ''
        self.affiliation = ''
        self.sensor_type = 0
        self.number_past_frames_exclude_current = 0
        self.number_future_frames_exclude_current = 0
        self.inference_results = _InferenceResults()

    def SerializeToString(self):
        frames = [(f.context_name, f.frame_timestamp_micros,
                   [(l.name, l.ri_return1.segmentation_label_compressed,
                     l.ri_return2.segmentation_label_compressed)
                    for l in f.segmentation_labels])
                  for f in self.inference_results.frames]
        return pickle.dumps((self.unique_method_name, frames))


def build_modules() -> dict:
    """{module name: stub module} for sys.modules installation."""
    wod = types.ModuleType('waymo_open_dataset')
    dataset_pb2 = types.ModuleType('waymo_open_dataset.dataset_pb2')
    dataset_pb2.MatrixInt32 = Matrix
    dataset_pb2.MatrixFloat = Matrix
    dataset_pb2.Laser = Laser
    dataset_pb2.LaserName = LaserName
    protos = types.ModuleType('waymo_open_dataset.protos')
    seg_metrics = types.ModuleType(
        'waymo_open_dataset.protos.segmentation_metrics_pb2')
    seg_metrics.SegmentationFrame = SegmentationFrame
    seg_metrics.SegmentationFrameList = SegmentationFrameList
    seg_sub = types.ModuleType(
        'waymo_open_dataset.protos.segmentation_submission_pb2')
    seg_sub.SemanticSegmentationSubmission = SemanticSegmentationSubmission
    wod.dataset_pb2 = dataset_pb2
    wod.protos = protos
    protos.segmentation_metrics_pb2 = seg_metrics
    protos.segmentation_submission_pb2 = seg_sub
    return {'waymo_open_dataset': wod,
            'waymo_open_dataset.dataset_pb2': dataset_pb2,
            'waymo_open_dataset.protos': protos,
            'waymo_open_dataset.protos.segmentation_metrics_pb2': seg_metrics,
            'waymo_open_dataset.protos.segmentation_submission_pb2': seg_sub}


def install() -> None:
    """Register the stub modules (no-op for names already importable)."""
    for name, mod in build_modules().items():
        sys.modules.setdefault(name, mod)


def read_submission(path: str) -> tuple:
    """Decode a submission file written through the stub: (method name,
    [(context name, timestamp, [(laser name, return-1 labels [64, 2650, 2],
    return-2 labels)])]), the range images as int32 arrays."""
    def matrix(blob):
        dims, data = pickle.loads(zlib.decompress(blob))
        return np.asarray(data, np.int32).reshape(dims)

    with open(path, 'rb') as fh:
        method, frames = pickle.loads(fh.read())
    return method, [(ctx, ts, [(name, matrix(r1), matrix(r2)) for name, r1, r2 in lasers])
                    for ctx, ts, lasers in frames]
