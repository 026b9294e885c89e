"""The socket plane: nodes that federate over TCP.

The counterpart of ``p2pfl_tpu/p2p``, on the same wire:

- ``protocol``: P2W2 frames (a msgpack header and the raw payload) and
  the gossip dedup ring;
- ``session``: the aggregation session (contributor sets, partial
  aggregates, completion on coverage or timeout);
- ``node``: ``P2PNode``, an asyncio node (listener, per-peer lanes,
  gossip, heartbeats, the round state machine) whose learner trains on
  the card (``learning.learner.TorchLearner``);
- ``launch``: ``run_simulation`` (every node in one event loop) and the
  multi-process launcher, ``python -m p2pfl_tpu_torch.p2p.launch``;
- the transport layers, each off unless a scenario asks for it:
  ``tls`` (mutual TLS and origin signatures; needs ``cryptography``,
  imported only then), ``netem`` (seeded link shaping and partition
  windows) and ``aggd`` (the aggregation sidecar: a worker process that
  decodes and fuses the payloads in a shared-memory arena).
"""

from p2pfl_tpu_torch.p2p.protocol import (
    Message,
    MsgType,
    read_message,
    write_message,
)
from p2pfl_tpu_torch.p2p.session import AggregationSession
from p2pfl_tpu_torch.p2p.node import P2PNode

__all__ = [
    "Message",
    "MsgType",
    "read_message",
    "write_message",
    "AggregationSession",
    "P2PNode",
]
