"""Time on the card's timeline from each step's last forward kernel to its
first optimizer kernel, per step of the traced stretch of a training cell:
the backward (autograd launches it from its own thread, outside the
``semseg::backward`` range), DDP's and BN's all-reduces included."""


def read(w):
    if w.info.get("kind") != "train":
        return None
    fwd = w.under_each("semseg::forward")
    opt = w.under_each("semseg::optimizer")
    spans = [min(o.start for o in b) - max(o.end for o in f)
             for f, b in zip(fwd, opt) if f and b]
    return sum(spans) * 1e-3 / len(spans) if spans else None
