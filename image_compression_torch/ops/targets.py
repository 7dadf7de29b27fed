"""Classical edge costs and pretraining targets.

Port of the reference's ops/targets.py: dispatch on the classical
extractor, and pack [..., H, W, 4] targets (cost_right, cost_down,
mask_right, mask_down) with the padding column/row masked.
"""

from __future__ import annotations

import torch

from image_compression_torch.config import EdgeTarget
from image_compression_torch.ops.canny import canny_edge_costs
from image_compression_torch.ops.edges import edge_validity_masks
from image_compression_torch.ops.graph_based import graph_based_edge_costs
from image_compression_torch.ops.slic import slic_edge_costs
from image_compression_torch.ops.watershed import watershed_edge_costs

_EXTRACTORS = {
    EdgeTarget.SLIC: slic_edge_costs,
    EdgeTarget.CANNY: canny_edge_costs,
    EdgeTarget.GRAPH: graph_based_edge_costs,
    EdgeTarget.WATERSHED: watershed_edge_costs,
}


def compute_edge_costs(images: torch.Tensor,
                       target: EdgeTarget = EdgeTarget.GRAPH
                       ) -> torch.Tensor:
    """[B, H, W, C] float [0, 1] -> {0, 1} edge-cost planes [B, H, W, 2]
    (GRAPH is the configured default)."""
    return _EXTRACTORS[target](images)


def create_target_with_mask(images: torch.Tensor,
                            target: EdgeTarget = EdgeTarget.GRAPH
                            ) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 4]: (cost_right, cost_down, mask_right,
    mask_down), the masks zero on the padding column/row."""
    costs = compute_edge_costs(images, target)
    height, width = costs.shape[-3], costs.shape[-2]
    masks = edge_validity_masks(height, width, device=costs.device
                                ).expand(costs.shape)
    return torch.cat([costs * masks, masks], dim=-1)
