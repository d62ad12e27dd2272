"""Checkpointing (``repro.checkpoint``): the v2 MessagePack file format
(``io.py``, with the port's own codec) and the server snapshot
(``state.py``)."""
from repro_torch.checkpoint.io import (FORMAT_VERSION, CheckpointError,
                                       load_manifest, load_pytree,
                                       save_pytree)
from repro_torch.checkpoint.state import (STATE_VERSION,
                                          restore_server_state,
                                          save_server_state)

__all__ = ["CheckpointError", "FORMAT_VERSION", "STATE_VERSION",
           "load_manifest", "load_pytree", "save_pytree",
           "restore_server_state", "save_server_state"]
