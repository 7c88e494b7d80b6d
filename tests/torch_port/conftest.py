"""The port's CPU tests run torch on one intra-op thread.

The suite runs several pytest workers on the machine's cores, and the tensors
here are small: torch's thread pool gains them nothing, while its threads'
spin-waits take the cores from the other workers (on an eight-core CPU
machine, one generation-eval test ran 15 s alone and 1,063 s among six
workers; the whole suite took 1,269 s with torch's default threads and 585 s
with one). Each test's thread count
is set to 1 and restored after it, so the JAX package's tests in the same
worker keep the default.

`DEFAULT_THREADS` names the modules that keep torch's default (none now:
the algebraic step test, which holds parameter directions where a gradient
is down to 1e-6 of its tensor's largest, takes the signs it holds from an
f64 gradient, which no summation order sets)."""

import pytest
import torch

DEFAULT_THREADS: set = set()


@pytest.fixture(autouse=True)
def _one_torch_thread(request):
    if request.module.__name__.rsplit(".", 1)[-1] in DEFAULT_THREADS:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
