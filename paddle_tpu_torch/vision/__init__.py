"""Vision of the port (counterpart of ``paddle_tpu/vision``): the datasets,
the transforms, and the model zoo so far (LeNet, the ResNet family and
the detection models, PP-YOLOE and DETR).
``vision.ops`` comes with ROADMAP.md queue 1 item 6."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
from .models import LeNet  # noqa: F401
