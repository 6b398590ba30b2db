"""The measured window of a closed loop with one call in flight (lag one),
as the port's training and predict loops keep it: call N+1 is dispatched
before call N's results are read on the host.

The window opens at the first dispatch and closes when the results of the
last call dispatched are on the host; the loop stops dispatching once
`seconds` have passed. A rate is all the work completed over all that
time; a call's latency runs from its dispatch until its results are read,
so a stall shows in both.
"""

import time

import numpy as np


def lag_one(dispatch, complete, seconds, clock=time.perf_counter):
    """Run the loop for `seconds`.

    :param dispatch: dispatch(k) enqueues call k and returns its handle
    :param complete: complete(handle) waits for its results on the host
    :return: dict calls (completed), window_s, latencies_s (one a call, in
        dispatch order), thirds (calls completed in each third of the
        window), intervals_ms (between completions; the first spans two
        dispatches, the last follows the one before at once)
    """
    t0 = clock()
    pending, k, latencies, done_at = None, 0, [], []
    while True:
        t = clock()
        handle = dispatch(k)
        k += 1
        if pending is not None:
            complete(pending[1])
            done_at.append(clock())
            latencies.append(done_at[-1] - pending[0])
        pending = (t, handle)
        if clock() - t0 >= seconds:
            break
    complete(pending[1])
    done_at.append(clock())
    latencies.append(done_at[-1] - pending[0])
    window_s = done_at[-1] - t0
    done_s = [t - t0 for t in done_at]
    return {"calls": k, "window_s": window_s, "latencies_s": latencies,
            "thirds": thirds(done_s, window_s),
            "intervals_ms": [round(1e3 * (b - a), 1)
                             for a, b in zip([0.0] + done_s, done_s)]}


def thirds(done_s, window_s):
    """Calls completed in each third of a window, from their completion
    times in seconds after its start: a drift or a stall inside the run
    shows as unequal thirds, a slow run as even ones (under lag one the
    first third holds about one call fewer, as the first completion waits
    for two dispatches)."""
    counts = [0, 0, 0]
    for t in done_s:
        counts[min(int(3 * t / window_s), 2)] += 1
    return counts


def percentile(values, q):
    """The q-th percentile (0-100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))
