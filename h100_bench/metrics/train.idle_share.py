"""Share of a training cell's untraced window in which no operation ran on
the card: 1 less the device's busy time of the traced pass (the union of
kernels, copies and fills on its timeline; with several cards, the first
rank's) over the time the window took for a pass (``paced_s``), since the
profiler's host work lengthens the traced pass itself."""


def read(w):
    if w.info.get("kind") != "train" or not w.device:
        return None
    return 100.0 * (1.0 - w.busy_s / w.info["paced_s"])
