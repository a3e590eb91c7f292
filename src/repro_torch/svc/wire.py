"""Wire protocol: message schema, codec, and idempotency machinery.

Every message is ``Msg(kind, sender, seq, payload)``.  Senders number
the messages of each reliable conversation 1, 2, 3, ... and retransmit
until acked; receivers push every incoming message through a `SeqGate`
that admits each (sender, seq) exactly once and in order.  Together
those two halves make the RPC layer *idempotent by construction*:
duplicated, reordered or dropped-then-retried deliveries all collapse
to the clean-delivery schedule (property-tested in
tests/test_service.py against a clean oracle).

The codec is tagged JSON — self-describing, endian-stable and safe to
decode from an untrusted peer (no pickle).  numpy arrays ride as
(dtype, shape, base64(tobytes)) triples; DAGs as their five constructor
fields, rebuilt through `core.dag.DAG` on decode so derived state
(children, stages, reachability) is recomputed, never trusted.
"""

from __future__ import annotations

import base64
import dataclasses
import json

import numpy as np

from ..core.dag import DAG

# -- message kinds -----------------------------------------------------
# agent -> scheduler
REGISTER = "register"        # machine joins: {machine}
HEARTBEAT = "heartbeat"      # {machine, t, beat}; unsequenced, superseded
TASK_DONE = "task_done"      # {lease, t}; reliable, exactly-once
# scheduler -> agent
PLACE = "place"              # lease grant: {lease, job, task, machine,
                             #  demand, t, expected}
REVOKE = "revoke"            # lease reclaimed after silence: {lease}
# client -> scheduler
SUBMIT = "submit"            # {sub, dag, group}; reliable
STATS_REQ = "stats_req"      # {}; unsequenced read
# scheduler -> client
JOB_DONE = "job_done"        # {sub, job, t, arrival, n_tasks}; reliable
STATS = "stats"              # {fault_stats, mutation_stats, core}
# both directions
ACK = "ack"                  # {ack: seq}; unsequenced by definition

#: kinds outside the reliable conversation: never sequenced, never acked,
#: never retransmitted.  Heartbeats are superseded by the next beat;
#: acks of acks would regress infinitely; stats are idempotent reads.
UNSEQUENCED = frozenset({ACK, HEARTBEAT, STATS_REQ, STATS})


@dataclasses.dataclass
class Msg:
    """One wire message.  ``seq`` is 0 for unsequenced kinds, else the
    sender's 1-based position in this conversation."""

    kind: str
    sender: str
    seq: int = 0
    payload: dict = dataclasses.field(default_factory=dict)


# -- codec -------------------------------------------------------------

def _enc(obj):
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, DAG):
        return {"__dag__": {
            "duration": obj.duration.tolist(),
            "demand": obj.demand.tolist(),
            "stage_of": obj.stage_of.tolist(),
            "parents": [p.tolist() for p in obj.parents],
            "name": obj.name,
        }}
    if isinstance(obj, np.ndarray):
        return {"__nd__": [obj.dtype.str, list(obj.shape),
                           base64.b64encode(np.ascontiguousarray(obj)
                                            .tobytes()).decode("ascii")]}
    if isinstance(obj, (bytes, bytearray)):
        return {"__bytes__": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _dec(obj):
    if isinstance(obj, dict):
        if "__dag__" in obj:
            d = obj["__dag__"]
            return DAG(duration=np.asarray(d["duration"], dtype=np.float64),
                       demand=np.asarray(d["demand"], dtype=np.float64),
                       stage_of=np.asarray(d["stage_of"], dtype=np.int64),
                       parents=[np.asarray(p, dtype=np.int64)
                                for p in d["parents"]],
                       name=d["name"])
        if "__nd__" in obj:
            dt, shape, b64 = obj["__nd__"]
            return np.frombuffer(base64.b64decode(b64),
                                 dtype=np.dtype(dt)).reshape(shape).copy()
        if "__bytes__" in obj:
            return base64.b64decode(obj["__bytes__"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def encode(msg: Msg) -> bytes:
    return json.dumps({"kind": msg.kind, "sender": msg.sender,
                       "seq": msg.seq, "payload": _enc(msg.payload)},
                      separators=(",", ":")).encode("utf-8")


def decode(raw: bytes) -> Msg:
    obj = json.loads(raw.decode("utf-8"))
    return Msg(kind=obj["kind"], sender=obj["sender"],
               seq=int(obj["seq"]), payload=_dec(obj["payload"]))


# -- receiver-side idempotency -----------------------------------------

class SeqGate:
    """Exactly-once, in-order admission of sequenced messages.

    Per sender: the next expected seq starts at 1; an already-seen seq
    is a counted no-op (duplicate), a future seq is parked until the gap
    fills (reorder), and admitting a seq releases any parked successors.
    Unsequenced kinds pass straight through.
    """

    def __init__(self):
        self._next: dict[str, int] = {}
        self._held: dict[str, dict[int, Msg]] = {}
        self.stats = {"admitted": 0, "dups": 0, "reorders": 0}

    def admit(self, msg: Msg) -> list[Msg]:
        """Messages now applicable, in order (possibly empty)."""
        if msg.kind in UNSEQUENCED:
            return [msg]
        nxt = self._next.get(msg.sender, 1)
        if msg.seq < nxt:
            self.stats["dups"] += 1
            return []
        if msg.seq > nxt:
            held = self._held.setdefault(msg.sender, {})
            if msg.seq in held:
                self.stats["dups"] += 1
            else:
                held[msg.seq] = msg
                self.stats["reorders"] += 1
            return []
        out = [msg]
        nxt += 1
        held = self._held.get(msg.sender, {})
        while nxt in held:
            out.append(held.pop(nxt))
            nxt += 1
        self._next[msg.sender] = nxt
        self.stats["admitted"] += len(out)
        return out
