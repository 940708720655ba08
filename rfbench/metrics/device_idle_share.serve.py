"""Share of a batcher call's time (from its start to its output on the host)
in which no device operation ran, in %: the host's part of a call, which a
request waits on. The device's seconds a batch come from the traced slice
(a batch has a fixed shape, so the same work every time); the calls' time
comes from the measured window, which ran without the profiler (its
callbacks lengthen a call on the host by some tens of percent). The time
between calls, when the open loop waits for arrivals, is left out;
``device.busy_s / window_s`` of the result line has it."""


def batches(calls, batch):
    return sum(-(-c["images"] // batch) for c in calls)


def read(run):
    batch = run.traffic["service_batch"]
    traced, timed = batches(run.window_calls(), batch), batches(run.timed, batch)
    seconds = sum(c["seconds"] for c in run.timed)
    if not traced or seconds <= 0:
        return None
    return 100.0 * (1.0 - run.summary.busy_s / traced * timed / seconds)
