from .scatter import (segment_sum, segment_count, segment_mean, segment_max,
                      voxel_to_point)
from .sparse_conv import (SparseTensor, Rulebook, DownsamplePlan, linearize,
                          delinearize, sort_match, build_subm_rulebook,
                          build_downsample, apply_sparse_conv, apply_subm,
                          downsample_shape, kernel_offsets)
from .attention import (window_attention_packed, window_attention_packed_plain,
                        fused_window_attention, fused_window_attention_plain,
                        attention_group)

__all__ = [
    'segment_sum', 'segment_count', 'segment_mean', 'segment_max',
    'voxel_to_point', 'SparseTensor', 'Rulebook', 'DownsamplePlan', 'linearize',
    'delinearize', 'sort_match', 'build_subm_rulebook', 'build_downsample',
    'apply_sparse_conv', 'apply_subm', 'downsample_shape', 'kernel_offsets',
    'window_attention_packed', 'window_attention_packed_plain',
    'fused_window_attention', 'fused_window_attention_plain',
    'attention_group',
]
