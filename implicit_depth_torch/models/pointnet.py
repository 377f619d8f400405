"""Two-stage PointNet voxel feature encoder (counterpart of
``implicit_depth_tpu/models/pointnet.py::PointNet2Stage``).

Per-point MLPs with a voxel max-pool between stages over the dense B·G³ cell
space; empty voxels read exactly 0 (torch_scatter's zero init on the
post-ReLU features). Every max-pool goes through ``ops/segment.segment_max0``
(kernel K5 on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from implicit_depth_torch.models.init import dense, linear
from implicit_depth_torch.ops.segment import segment_max0


class PointNet2Stage(nn.Module):
    def __init__(self, in_dim: int = 6, out_channels: int = 128,
                 gf_dim: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        half = out_channels // 2
        self.l0 = dense(in_dim, gf_dim, generator)
        self.l1 = dense(gf_dim, half, generator)
        self.v1_mlp = dense(half, half, generator)
        self.l3 = dense(out_channels, out_channels, generator)
        self.l4 = dense(out_channels, out_channels, generator)
        self.v2_mlp = dense(out_channels, out_channels, generator)

    def forward(self, inp_feat, seg_ids, num_segments, valid=None,
                dtype=torch.float32):
        """inp_feat (N, C_in); seg_ids (N,) -> (num_segments, out) f32."""
        return self.call_split([(inp_feat, seg_ids, valid)], num_segments, dtype)

    def call_split(self, parts, num_segments: int, dtype=torch.float32):
        """The forward over the row-concatenation of ``parts`` ((inp, seg,
        valid) tuples), each part pooled separately and combined with an
        elementwise max — exact, since max is associative and 0 is neutral
        for post-ReLU data."""
        p2s = [F.relu(linear(F.relu(linear(inp, self.l0, dtype)), self.l1, dtype))
               for inp, _, _ in parts]
        v1 = None
        for p2, (_, seg, valid) in zip(p2s, parts):
            m = segment_max0(p2, seg, num_segments, valid)
            v1 = m if v1 is None else torch.maximum(v1, m)
        v1 = F.relu(linear(v1, self.v1_mlp, dtype))
        v2 = None
        for p2, (_, seg, valid) in zip(p2s, parts):
            p3 = torch.cat([v1[seg.long()], p2.to(dtype)], dim=-1)
            p5 = F.relu(linear(F.relu(linear(p3, self.l3, dtype)), self.l4, dtype))
            m = segment_max0(p5, seg, num_segments, valid)
            v2 = m if v2 is None else torch.maximum(v2, m)
        return F.relu(linear(v2, self.v2_mlp, dtype)).float()
