"""Host time the step loop of a training cell waits for its next batch in
the program's own span (``semseg::data.wait``,
``parallel/mesh.device_prefetch``, on the consumer's thread: the wait for
the prefetch thread and the stream's wait on the upload), per step of the
traced stretch."""

from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "train":
        return None
    ranges = w.ranges("semseg::data.wait")
    return union_s(ranges) * 1e3 / w.info["steps"] if ranges else None
