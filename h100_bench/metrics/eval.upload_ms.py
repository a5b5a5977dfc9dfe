"""Host time the engine spends putting its input on the card and waiting
for it (the union of its ``semseg::eval.stage`` and ``semseg::eval.wait``
spans, ``engine.py``, which run on the calling thread: the windows'
originals and labels packed and sent, each chunk's canvases assembled, the
chunk loop blocked on the uploader thread), per image, in the traced call
of an evaluation cell."""

from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ranges = w.ranges("semseg::eval.stage") + w.ranges("semseg::eval.wait")
    return union_s(ranges) * 1e3 / w.info["images"] if ranges else None
