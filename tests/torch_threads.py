"""One intra-op torch thread for the test modules that run many small ops.

Under pytest-xdist (six workers on the machine's cores) each worker's torch
keeps a thread a core by default, and every small op's parallel region
then waits on threads the other workers have descheduled: a module of
small ops ran 10-20x slower in the whole suite than alone. Importing this
fixture into a module sets one thread for the module's tests and restores
the count after. Every port module imports it but two that fail with one
thread (test_torch_resnet_steps.py, test_torch_detection_steps.py): each
holds a bf16 or PP-YOLOE training step tightly enough that the order of a
reduction, which the thread count decides, shows.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
