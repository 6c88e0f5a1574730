"""Detection zoo of the port (counterpart of
``paddle_tpu/vision/models/detection``; ref: PaddleDetection
ppdet/modeling): PP-YOLOE and DETR for inference and training (their
losses, PP-YOLOE's task-aligned assigner and DETR's auction matcher), and
the box utilities."""
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
