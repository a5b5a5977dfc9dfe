"""Share of an evaluation cell's untraced window in which no operation ran
on the card: 1 less the device's busy time of the traced call (the union of
kernels, copies and fills on its timeline) over the time the window took
for the same chunk (``paced_s``, its calls' mean), since the profiler's
host work lengthens the traced call itself."""


def read(w):
    if w.info.get("kind") != "eval" or not w.device:
        return None
    return 100.0 * (1.0 - w.busy_s / w.info["paced_s"])
