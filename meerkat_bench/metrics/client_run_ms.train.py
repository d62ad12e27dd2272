"""Device ms of one client's local run (its T zeroth-order steps): CUDA
events around each ``FederatedZO._run`` call over the window, read once
it has closed."""


def read(h):
    ms = h.facts.get("client_ms")
    return sum(ms) / len(ms) if ms else None
