"""Device ms per admitted request: CUDA events around the engine's
``_admit`` (the wave's prefill through the cache, graph replays), over the
requests each wave admitted."""


def read(h):
    ms = [(x, w) for x, w in h.facts.get("prefill_ms") or [] if w]
    if not ms:
        return None
    return sum(x for x, _ in ms) / sum(w for _, w in ms)
