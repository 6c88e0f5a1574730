"""Detection zoo of the port (counterpart of
``paddle_tpu/vision/models/detection``; ref: PaddleDetection
ppdet/modeling): PP-YOLOE and DETR, their inference paths, and the box
utilities. The training losses, the assigner and the matcher raise,
naming ROADMAP.md queue 1 item 6."""
from .box_utils import (  # noqa: F401
    cxcywh_to_xyxy, xyxy_to_cxcywh, box_area, pairwise_iou, pairwise_giou,
    elementwise_giou,
)
from .ppyoloe import (  # noqa: F401
    PPYOLOE, PPYOLOECriterion, PPYOLOELoss, CSPResNet, CustomCSPPAN,
    PPYOLOEHead, task_aligned_assign, multiclass_nms,
)
from .detr import (  # noqa: F401
    DETR, DETRLoss, auction_match, sine_position_embedding,
)
