"""Vision model zoo of the port (counterpart of
``paddle_tpu/vision/models``): LeNet, the ResNet family and the detection
models (PP-YOLOE, DETR) so far."""
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     SpaceToDepthStem, resnet18, resnet34, resnet50,
                     resnet101, resnet152, resnext50_32x4d,
                     resnext101_32x4d, resnext101_64x4d, resnext152_64x4d,
                     s2d_weights_from_7x7, space_to_depth, wide_resnet50_2,
                     wide_resnet101_2)
from .detection import (  # noqa: F401
    PPYOLOE, PPYOLOECriterion, PPYOLOELoss, CSPResNet, CustomCSPPAN,
    PPYOLOEHead, task_aligned_assign, multiclass_nms, DETR, DETRLoss,
    auction_match, sine_position_embedding, cxcywh_to_xyxy, xyxy_to_cxcywh,
    box_area, pairwise_iou, pairwise_giou, elementwise_giou,
)
