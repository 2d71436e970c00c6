"""Repo-wide pytest settings: the default run leaves out `slow` tests, and
every test runs under one wall limit."""
import faulthandler
import hashlib
import os
import pathlib
import signal
import threading
import time

import pytest

pytest_plugins = ("pytester",)

# One wall limit a test, setup and teardown included.  The slowest sound
# phase is the port's dry-run fixture (tests/test_torch_dryrun.py): 94 s on
# eight cores, 341 s on three shared ones.  600 s is 1.75x that and under
# half of a whole run's clock, so a stuck wait fails under its own name and
# the run goes on.  No wait in the port's tests outlasts it.
LIMIT_S = 600
# after the alarm, the time a test stuck in code that never returns to the
# interpreter has before the backstop ends its process
BACKSTOP_S = 60

_STDERR_FD = pytest.StashKey[int]()
_WORKER_DIED = pytest.StashKey[bool]()


def pytest_configure(config):
    # the default run is tier-1: `slow` tests are out of it, -m slow runs them
    if not config.option.markexpr:
        config.option.markexpr = "not slow"
    # the real stderr, taken while capture is off: the backstop's dump must
    # not land in a capture file that dies with the worker
    config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


def _running_mark(item):
    """Under xdist, a file that stands while ``item`` runs, in the run's
    temporary directory.  A worker that dies leaves it standing, and
    xdist's loadfile scheduler hands the test to another worker, which
    finds it and does not run the test into the backstop again."""
    if not hasattr(item.config, "workerinput") or not item.config.option.basetemp:
        return None
    test = hashlib.sha1(item.nodeid.encode()).hexdigest()
    # each worker's basetemp lies in the run's own
    return pathlib.Path(item.config.option.basetemp).parent / f"running-{test}"


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if (threading.current_thread() is not threading.main_thread()
            or not hasattr(signal, "SIGALRM")):
        yield
        return

    def overran(signum, frame):
        pytest.fail(f"{item.nodeid} overran the per-test wall limit of "
                    f"{LIMIT_S} s (conftest.py)")

    fd = item.config.stash[_STDERR_FD]
    # where this test's backstop stands, for a limit armed inside it (a
    # pytest run in process) to arm again when it ends
    overran.backstop = (time.monotonic() + LIMIT_S + BACKSTOP_S, fd)
    mark = _running_mark(item)
    if mark is not None:
        item.stash[_WORKER_DIED] = mark.exists()
        mark.touch()
    outer = signal.signal(signal.SIGALRM, overran)
    outer_left, _ = signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    t0 = time.monotonic()
    # the backstop: every thread's stack, then the process exits and xdist
    # fails this test
    faulthandler.dump_traceback_later(LIMIT_S + BACKSTOP_S, exit=True, file=fd)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer)
        # an alarm armed before this test's belongs to a test this one runs
        # inside: it gets back what is left of it, and its backstop
        if outer_left:
            signal.setitimer(signal.ITIMER_REAL,
                             max(outer_left - (time.monotonic() - t0), 1e-6))
        backstop = getattr(outer, "backstop", None)
        if backstop is not None:
            at, outer_fd = backstop
            faulthandler.dump_traceback_later(
                max(at - time.monotonic(), 1e-3), exit=True, file=outer_fd)
        if mark is not None:
            mark.unlink()


def pytest_runtest_setup(item):
    if item.stash.get(_WORKER_DIED, False):
        pytest.fail(f"{item.nodeid}: its worker died while it ran earlier "
                    f"in this run; it is not run again", pytrace=False)
