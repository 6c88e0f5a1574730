"""Vision of the port (counterpart of ``paddle_tpu/vision``): the datasets,
the transforms, the model zoo (LeNet, ResNet, the classification zoo and
the detection models) and ``ops``."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .models import LeNet  # noqa: F401
