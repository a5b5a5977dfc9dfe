"""Host time the step loop of a training cell waits for its next batch
(``next()`` on ``parallel/mesh.device_prefetch``, which packs and uploads
it on its own thread), per step of the traced stretch, from the driver's
own spans."""


def read(w):
    waits = w.info.get("data_wait_s")
    if w.info.get("kind") != "train" or not waits:
        return None
    return sum(waits) * 1e3 / len(waits)
