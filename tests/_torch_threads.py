"""``one_thread``: a module-scoped autouse fixture that runs a test
module's PyTorch work on one intra-op thread.

The suite runs six test processes at once (``-n 6``). PyTorch's default
of a thread per core in each of them oversubscribes the machine, and
its many small ops then wait on each other's threads: with six busy
processes beside it, ``tests/test_torch_spec_decode.py`` took 219 s on
a thread per core and 56 s on one thread (an 8-core machine), and in a
six-process run of the suite the rehearsal's spec-engine phase took
578 s, against ~24 s alone. Import it into a test module::

    from _torch_threads import one_thread  # noqa: F401
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
