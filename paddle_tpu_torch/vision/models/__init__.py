"""Vision model zoo of the port (counterpart of
``paddle_tpu/vision/models``): LeNet, the ResNet family, the
classification zoo (VGG, AlexNet, SqueezeNet, MobileNet v1/v2/v3,
DenseNet, ShuffleNetV2, GoogLeNet, Inception v3) and the detection
models (PP-YOLOE, DETR). Every factory takes ``pretrained``: False, or the
path of a checkpoint that either package saved."""
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     SpaceToDepthStem, resnet18, resnet34, resnet50,
                     resnet101, resnet152, resnext50_32x4d,
                     resnext101_32x4d, resnext101_64x4d, resnext152_64x4d,
                     s2d_weights_from_7x7, space_to_depth, wide_resnet50_2,
                     wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .squeezenet import (  # noqa: F401
    SqueezeNet, squeezenet1_0, squeezenet1_1,
)
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, MobileNetV3Small, MobileNetV3Large,
    mobilenet_v1, mobilenet_v2, mobilenet_v3_small, mobilenet_v3_large,
)
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish,
)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .detection import (  # noqa: F401
    PPYOLOE, PPYOLOECriterion, PPYOLOELoss, CSPResNet, CustomCSPPAN,
    PPYOLOEHead, task_aligned_assign, multiclass_nms, DETR, DETRLoss,
    auction_match, sine_position_embedding, cxcywh_to_xyxy, xyxy_to_cxcywh,
    box_area, pairwise_iou, pairwise_giou, elementwise_giou,
)
