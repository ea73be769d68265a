"""Twin as a service (port of ``repro.serve``): persistent simulation
sessions with snapshot and fork what-if branching (docs/serving.md).

Layers, bottom up:

* ``snapshot``: the byte-faithful codec for the carry (the checkpoint
  and download format, byte for byte the JAX package's) and the
  Scenario delta wire form;
* ``session``: the branch manager: interval checkpoints, forks from any
  checkpoint, each tick's advances coalesced into one batched segment;
* ``protocol``: the NDJSON request dialect over ``core.transport``;
* ``server``: sockets, threads, the coalescing executor, the flight
  recorder;
* ``cli``: ``python -m repro_torch.launch.simulate serve ...``.

The stdlib-only client lives outside the package
(``tools/twin_client.py``): anything that reads lines of JSON can talk
to the twin, and it talks to the port's server as to the reference's.
"""
from repro_torch.serve.session import Branch, SessionError, TwinSession
from repro_torch.serve.server import TwinServer
from repro_torch.serve.snapshot import (SNAPSHOT_VERSION, SnapshotError,
                                        apply_scenario_delta, decode_carry,
                                        encode_carry, encode_scenario,
                                        snapshot_digest)
from repro_torch.serve.protocol import SERVE_VERSION

__all__ = ["Branch", "SessionError", "TwinSession", "TwinServer",
           "SNAPSHOT_VERSION", "SnapshotError", "apply_scenario_delta",
           "decode_carry", "encode_carry", "encode_scenario",
           "snapshot_digest", "SERVE_VERSION"]
