"""Device ms per decode step: CUDA events around the engine's ``_decode``
(a burst of graph-replayed steps over every slot), over the burst's
length."""


def read(h):
    ms = h.facts.get("decode_ms")
    if not ms:
        return None
    return sum(x for x, _ in ms) / sum(w for _, w in ms)
