"""Scheduler-as-a-service: the distributed deployment mode.

The simulator (`sim/cluster.py`) and a real deployment are two clients
of one scheduler core:

  * `wire`      — message schema, codec, and the sequence-gating that
                  makes every RPC idempotent (dups/reorders are no-ops)
  * `comm`      — listener/connector transport abstraction: an
                  in-process transport for deterministic tests plus an
                  asyncio-socket transport for real deployment, with the
                  ``comm_send`` fault seam injected at every send
  * `scheduler` — the central scheduler process: streaming
                  ``submit(dag) -> handle``, lease-based placements,
                  heartbeat-silence lease reclaim
  * `agent`     — worker agents: real heartbeats, lease execution,
                  wall-clock-aware reconnect backoff
  * `client`    — client API + the virtual-time driver that replays a
                  simulator workload through the service for the
                  decision-parity suite
"""

from .client import Client, ServiceResult, run_service_workload
from .comm import Channel, Comm, CommClosed, connect, listen
from .scheduler import SchedulerCore, SchedulerService, ServiceConfig
from .wire import Msg, SeqGate, decode, encode

__all__ = [
    "Channel", "Client", "Comm", "CommClosed", "Msg", "SchedulerCore",
    "SchedulerService", "SeqGate", "ServiceConfig", "ServiceResult",
    "connect", "decode", "encode", "listen", "run_service_workload",
]
