"""The per-test wall limit of the repo's conftest.py, held on an inner
pytest that runs the same conftest with the limit and the backstop cut to
1 s."""
import pathlib
import re
import signal
import time

import pytest

CONFTEST = pathlib.Path(__file__).parents[1].joinpath("conftest.py").read_text()
LIMIT_S = int(re.search(r"^LIMIT_S = (\d+)$", CONFTEST, re.M).group(1))


def _run_limited(pytester, body, *args):
    src, n = re.subn(r"^(LIMIT_S|BACKSTOP_S) = \d+$", r"\1 = 1", CONFTEST,
                     flags=re.M)
    assert n == 2, "LIMIT_S or BACKSTOP_S is no longer set as this test expects"
    pytester.makeconftest(src)
    pytester.makepyfile(test_inner=body)
    t0 = time.monotonic()
    result = pytester.runpytest_inprocess(*args)
    return result, time.monotonic() - t0


@pytest.mark.parametrize("wait", ["time.sleep(30)",
                                  "threading.Event().wait(30)"])
def test_overrun_fails_under_its_name_and_the_next_test_runs(pytester, wait):
    result, wall = _run_limited(pytester, f"""
        import threading
        import time

        def test_overrun():
            {wait}

        def test_next():
            pass
    """)
    result.assert_outcomes(failed=1, passed=1)
    result.stdout.fnmatch_lines([
        "E * Failed: test_inner.py::test_overrun overran the per-test wall "
        "limit of 1 s *",
        "FAILED test_inner.py::test_overrun - *"])
    assert wall < 15          # the limit ended the wait, not its own 30 s


def test_passing_test_leaves_no_alarm_armed(pytester):
    """The inner test leaves no alarm of its own: this test's alarm, armed
    by the same conftest, is armed again with what is left of it, under
    its own handler."""
    handler = signal.getsignal(signal.SIGALRM)
    before, _ = signal.getitimer(signal.ITIMER_REAL)
    result, wall = _run_limited(pytester, """
        def test_fast():
            pass
    """)
    result.assert_outcomes(passed=1)
    left, interval = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < before <= LIMIT_S and interval == 0
    assert before - wall - 1 < left <= before
    assert signal.getsignal(signal.SIGALRM) is handler


def test_backstop_ends_a_worker_stuck_in_c_and_the_run_goes_on(pytester):
    """A sum in C never returns to the interpreter, so the alarm cannot
    fail it: the backstop ends the worker, xdist fails the test and hands
    it to a fresh worker, which fails it at once and runs the next test."""
    result, wall = _run_limited(pytester, """
        import itertools

        def test_stuck():
            sum(itertools.repeat(1, 10**10))

        def test_next():
            pass
    """, "-p", "xdist", "-n", "1", "--dist", "loadfile")
    result.assert_outcomes(failed=1, errors=1, passed=1)
    result.stdout.fnmatch_lines(
        ["*crashed while running 'test_inner.py::test_stuck'*"])
    result.stdout.fnmatch_lines(
        ["*test_inner.py::test_stuck: its worker died while it ran earlier "
         "in this run*"])
    assert wall < 60          # the backstop, not the sum, ended the test
