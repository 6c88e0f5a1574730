"""Data IO of the port (counterpart of ``paddle_tpu/io``, ref:
python/paddle/io/*): datasets, samplers, the DataLoader and the device
feed. ``io/checkpoint.py`` and ``io/atomic.py`` come with ROADMAP.md
queue 1 item 8; the C++ prefetch ring (``io/native.py``) is listed there
too."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)
from .dataloader import (  # noqa: F401
    DataLoader, WorkerInfo, default_collate_fn, default_convert_fn,
    device_prefetch, get_worker_info,
)
