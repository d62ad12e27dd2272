"""Host ms a round spends outside its clients' local runs (the server's
replay, aggregate, update, GradIP and codec, and the host's glue): the
round's host time less its clients' device time (CUDA events around each
``FederatedZO._run`` call, set by the harness at set-up)."""


def read(h):
    rounds = h.spans.host.get("round") if h.spans else None
    ms = h.facts.get("client_ms")
    if not rounds or not ms:
        return None
    return (1e3 * sum(rounds) - sum(ms)) / len(rounds)
