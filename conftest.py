"""Test isolation for the test modules that run the JAX package's
Trainer.fit: each of their tests leaves the process's SIGTERM disposition as
it found it.

That fit installs a SIGTERM handler (checkpoint on preemption) and leaves it
installed when it returns. A later test in the same process that loads FITS
maps through sunerf_tpu.data.loaders forks a multiprocessing pool; the forked
workers inherit that handler, so the pool's terminate() cannot end a worker
that is still waiting for a task, and the test waits on it forever. Putting
the disposition back after each test of those modules keeps one test's
handler out of the next. The port's own tests that call JAX's fit put the
handler back themselves.
"""
import signal

import pytest

# the test modules whose tests call the JAX package's Trainer.fit without
# putting the SIGTERM handler back
_JAX_FIT_MODULES = frozenset({'test_end_to_end.py', 'test_sharding.py'})


@pytest.fixture(autouse=True)
def _restore_sigterm(request):
    if request.node.path.name not in _JAX_FIT_MODULES:
        yield
        return
    handler = signal.getsignal(signal.SIGTERM)
    yield
    if handler is not None and signal.getsignal(signal.SIGTERM) is not handler:
        signal.signal(signal.SIGTERM, handler)
