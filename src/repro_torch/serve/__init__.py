"""Twin as a service (port of ``repro.serve``): persistent simulation
sessions with snapshot and fork what-if branching.

* ``snapshot``: the byte-faithful codec for the carry (the checkpoint
  and download format, byte for byte the JAX package's) and the
  Scenario delta wire form;
* ``session``: the branch manager: interval checkpoints, forks from any
  checkpoint, each tick's advances coalesced into one batched segment.

The request dialect, the socket server and the ``serve`` CLI ride the
scheduler wire and come with its port; a session is driven directly
until then.
"""
from repro_torch.serve.session import Branch, SessionError, TwinSession
from repro_torch.serve.snapshot import (SNAPSHOT_VERSION, SnapshotError,
                                        apply_scenario_delta, decode_carry,
                                        encode_carry, encode_scenario,
                                        snapshot_digest)

__all__ = ["Branch", "SessionError", "TwinSession", "SNAPSHOT_VERSION",
           "SnapshotError", "apply_scenario_delta", "decode_carry",
           "encode_carry", "encode_scenario", "snapshot_digest"]
