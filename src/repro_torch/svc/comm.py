"""Comm layer: listener/connector transports + reliable channels.

Modeled on the dask.distributed ``comm/{core,inproc}`` split: an address
scheme picks the transport —

  * ``inproc://<name>``  in-process queue pairs.  Sends are synchronous
    and single-threaded callers see fully deterministic delivery order,
    which is what the decision-parity suite needs.
  * ``tcp://host:port``  length-prefixed frames over asyncio streams,
    run on a private background event loop so the rest of the stack
    stays synchronous.  Port 0 binds an ephemeral port (read it back
    from ``listener.addr``).

Every physical ``Comm.send`` consults the ``comm_send`` fault seam
(core/faults.py) with a per-comm send counter in the context, so
retransmissions of one logical message get independent (but seeded,
deterministic) drop/delay/dup decisions:

  * ``drop``  the frame vanishes
  * ``dup``   the frame is delivered twice
  * ``delay`` inproc: parked until the receiver's next poll cycle (a
    deterministic reorder); tcp: written ``spec.delay`` seconds late

`Channel` stacks the reliability protocol on a raw comm: outbound
sequencing + ack-gated retransmit with capped exponential backoff
(RecoveryPolicy.rpc_timeout/backoff_cap), inbound auto-ack + `SeqGate`
exactly-once admission.  See docs/architecture.md ("Scheduler service &
comm fault model").
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from collections import deque

from ..core import faults
from . import wire
from .wire import ACK, Msg, SeqGate

COMM_STATS_KEYS = ("sent", "delivered", "dropped", "duped", "delayed")


class CommClosed(Exception):
    """The peer is gone (connection refused, reset, or closed)."""


class Comm:
    """One bidirectional message pipe.  Subclasses implement
    ``_deliver`` (push one encoded frame toward the peer) and expose a
    thread-safe inbound queue via ``recv_nowait``."""

    def __init__(self, label: str = "?"):
        self.label = label
        self.closed = False
        self._sent = 0
        self.stats = dict.fromkeys(COMM_STATS_KEYS, 0)

    # -- outbound ------------------------------------------------------

    def send(self, msg: Msg) -> None:
        """Send through the ``comm_send`` fault seam."""
        if self.closed:
            raise CommClosed(f"comm {self.label} is closed")
        self._sent += 1
        self.stats["sent"] += 1
        sp = faults.query("comm_send", src=msg.sender, kind=msg.kind,
                          seq=msg.seq or msg.payload.get("ack", 0),
                          n=self._sent)
        if sp is not None and sp.kind == "drop":
            self.stats["dropped"] += 1
            return
        if sp is not None and sp.kind == "delay":
            self.stats["delayed"] += 1
            self._deliver(msg, delay=max(sp.delay, 0.0))
            return
        self._deliver(msg)
        if sp is not None and sp.kind == "dup":
            self.stats["duped"] += 1
            self._deliver(msg)

    def _deliver(self, msg: Msg, delay: float = 0.0) -> None:
        raise NotImplementedError

    # -- inbound -------------------------------------------------------

    def recv_nowait(self) -> Msg | None:
        raise NotImplementedError

    def flush_delayed(self) -> None:
        """Release delay-parked inbound messages into the live queue
        (transports without parking override as a no-op)."""

    def close(self) -> None:
        self.closed = True


# ----------------------------------------------------------------------
# inproc transport
# ----------------------------------------------------------------------

_INPROC_LISTENERS: dict[str, "InprocListener"] = {}
_INPROC_LOCK = threading.Lock()
_INPROC_IDS = itertools.count()


class InprocComm(Comm):
    """One side of an in-process pipe.  ``_q`` is this side's inbound
    queue; sends append to the peer's.  A ``delay``-kind injection parks
    the frame on the peer's delayed list until its next poll cycle —
    time-free, so virtual-clock runs stay deterministic."""

    def __init__(self, label: str):
        super().__init__(label)
        self._q: deque = deque()
        self._delayed: list = []
        self._lock = threading.Lock()
        self.peer: InprocComm | None = None

    def _deliver(self, msg: Msg, delay: float = 0.0) -> None:
        peer = self.peer
        if peer is None or peer.closed:
            return                       # peer gone: frames fall on the floor
        # encode/decode round-trip even in-process: the transports must
        # not differ in what object graph the receiver observes
        copy = wire.decode(wire.encode(msg))
        with peer._lock:
            (peer._delayed if delay > 0.0 else peer._q).append(copy)
        if delay <= 0.0:
            self.stats["delivered"] += 1

    def recv_nowait(self) -> Msg | None:
        with self._lock:
            return self._q.popleft() if self._q else None

    def flush_delayed(self) -> None:
        with self._lock:
            if self._delayed:
                self._q.extend(self._delayed)
                self.stats["delivered"] += len(self._delayed)
                self._delayed.clear()

    def close(self) -> None:
        super().close()
        peer = self.peer
        if peer is not None:
            peer.closed = True


class InprocListener:
    def __init__(self, addr: str, on_connect):
        self.addr = addr
        self.on_connect = on_connect
        self.closed = False

    def close(self) -> None:
        self.closed = True
        with _INPROC_LOCK:
            if _INPROC_LISTENERS.get(self.addr) is self:
                del _INPROC_LISTENERS[self.addr]


def _inproc_connect(addr: str) -> Comm:
    with _INPROC_LOCK:
        lst = _INPROC_LISTENERS.get(addr)
    if lst is None or lst.closed:
        raise CommClosed(f"no inproc listener at {addr}")
    cid = next(_INPROC_IDS)
    a = InprocComm(f"{addr}#c{cid}")
    b = InprocComm(f"{addr}#s{cid}")
    a.peer, b.peer = b, a
    lst.on_connect(b)
    return a


# ----------------------------------------------------------------------
# tcp transport (asyncio streams on a private background loop)
# ----------------------------------------------------------------------

_LOOP: asyncio.AbstractEventLoop | None = None
_LOOP_LOCK = threading.Lock()


def _loop() -> asyncio.AbstractEventLoop:
    global _LOOP
    with _LOOP_LOCK:
        if _LOOP is None or _LOOP.is_closed():
            _LOOP = asyncio.new_event_loop()
            t = threading.Thread(target=_LOOP.run_forever,
                                 name="repro-svc-io", daemon=True)
            t.start()
        return _LOOP


class TcpComm(Comm):
    """Frames are 4-byte big-endian length + wire.encode payload."""

    def __init__(self, label: str, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        super().__init__(label)
        self._reader = reader
        self._writer = writer
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._read_task = asyncio.run_coroutine_threadsafe(
            self._read_loop(), _loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self._reader.readexactly(4)
                raw = await self._reader.readexactly(
                    int.from_bytes(head, "big"))
                msg = wire.decode(raw)
                with self._lock:
                    self._q.append(msg)
                self.stats["delivered"] += 1
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self.closed = True

    def _write(self, frame: bytes) -> None:
        if not self._writer.is_closing():
            self._writer.write(frame)

    def _deliver(self, msg: Msg, delay: float = 0.0) -> None:
        raw = wire.encode(msg)
        frame = len(raw).to_bytes(4, "big") + raw
        loop = _loop()
        if delay > 0.0:
            loop.call_soon_threadsafe(loop.call_later, delay,
                                      self._write, frame)
        else:
            loop.call_soon_threadsafe(self._write, frame)

    def recv_nowait(self) -> Msg | None:
        with self._lock:
            return self._q.popleft() if self._q else None

    def close(self) -> None:
        super().close()
        self._read_task.cancel()
        _loop().call_soon_threadsafe(self._writer.close)


class TcpListener:
    def __init__(self, host: str, port: int, on_connect):
        self.on_connect = on_connect
        self.closed = False

        async def _serve():
            return await asyncio.start_server(self._accept, host, port)

        self._server = asyncio.run_coroutine_threadsafe(
            _serve(), _loop()).result(timeout=10.0)
        sock = self._server.sockets[0].getsockname()
        self.addr = f"tcp://{sock[0]}:{sock[1]}"

    async def _accept(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        self.on_connect(TcpComm(f"tcp-srv{peer}", reader, writer))

    def close(self) -> None:
        self.closed = True
        _loop().call_soon_threadsafe(self._server.close)


def _tcp_connect(addr: str, timeout: float) -> Comm:
    host, _, port = addr[len("tcp://"):].rpartition(":")

    async def _open():
        return await asyncio.open_connection(host, int(port))

    fut = asyncio.run_coroutine_threadsafe(_open(), _loop())
    try:
        reader, writer = fut.result(timeout=timeout)
    except (ConnectionError, OSError, asyncio.TimeoutError, TimeoutError) \
            as e:
        fut.cancel()
        raise CommClosed(f"connect to {addr} failed: {e}") from e
    return TcpComm(f"tcp-cli{addr}", reader, writer)


# ----------------------------------------------------------------------
# address-dispatched entry points
# ----------------------------------------------------------------------

def listen(addr: str, on_connect):
    """Start a listener; ``on_connect(comm)`` fires per inbound
    connection (synchronously for inproc, on the io thread for tcp —
    keep it cheap and thread-safe)."""
    if addr.startswith("inproc://"):
        lst = InprocListener(addr, on_connect)
        with _INPROC_LOCK:
            _INPROC_LISTENERS[addr] = lst
        return lst
    if addr.startswith("tcp://"):
        host, _, port = addr[len("tcp://"):].rpartition(":")
        return TcpListener(host or "127.0.0.1", int(port), on_connect)
    raise ValueError(f"unknown comm scheme in {addr!r}")


def connect(addr: str, timeout: float = 5.0) -> Comm:
    """Open a connection to a listener (raises `CommClosed` on failure)."""
    if addr.startswith("inproc://"):
        return _inproc_connect(addr)
    if addr.startswith("tcp://"):
        return _tcp_connect(addr, timeout)
    raise ValueError(f"unknown comm scheme in {addr!r}")


# ----------------------------------------------------------------------
# reliable channel
# ----------------------------------------------------------------------

class _Pending:
    __slots__ = ("msg", "attempt", "due")

    def __init__(self, msg: Msg, due: float):
        self.msg = msg
        self.attempt = 0
        self.due = due


class Channel:
    """Reliable conversation over one comm.

    ``send`` sequences and records the message for retransmission until
    the peer acks it; ``cast`` is fire-and-forget for the unsequenced
    kinds.  ``poll`` drains the comm: acks clear pending state, every
    sequenced inbound message is (re-)acked — the peer may have missed
    the first ack — and admitted through the `SeqGate`, so the caller
    sees each logical message exactly once, in the sender's order.
    Unacked messages are retransmitted on a capped exponential backoff
    (`RecoveryPolicy.rpc_timeout` base, ``backoff_cap`` ceiling), each
    retransmission drawing fresh ``comm_send`` seam decisions.
    """

    def __init__(self, comm: Comm, name: str,
                 recovery: faults.RecoveryPolicy | None = None,
                 clock=time.monotonic):
        self.comm = comm
        self.name = name
        rec = recovery or faults.RecoveryPolicy()
        self._t0 = rec.rpc_timeout
        self._cap = rec.backoff_cap
        self._clock = clock
        self._next_seq = itertools.count(1)
        self._pending: dict[int, _Pending] = {}
        self.gate = SeqGate()
        self.stats = {"retransmits": 0, "acked": 0}

    def send(self, kind: str, **payload) -> int:
        seq = next(self._next_seq)
        msg = Msg(kind, self.name, seq, payload)
        self._pending[seq] = _Pending(msg, self._clock() + self._t0)
        self.comm.send(msg)
        return seq

    def cast(self, kind: str, **payload) -> None:
        self.comm.send(Msg(kind, self.name, 0, payload))

    @property
    def unacked(self) -> int:
        return len(self._pending)

    def poll(self, now: float | None = None) -> list[Msg]:
        now = self._clock() if now is None else now
        self.comm.flush_delayed()
        out: list[Msg] = []
        while (m := self.comm.recv_nowait()) is not None:
            if m.kind == ACK:
                if self._pending.pop(int(m.payload["ack"]), None) is not None:
                    self.stats["acked"] += 1
                continue
            if m.seq:
                try:
                    self.comm.send(Msg(ACK, self.name, 0, {"ack": m.seq}))
                except CommClosed:
                    pass
            out.extend(self.gate.admit(m))
        for ent in self._pending.values():
            if now >= ent.due and not self.comm.closed:
                ent.attempt += 1
                self.stats["retransmits"] += 1
                self.comm.send(ent.msg)
                # exponent clamp: a peer that never acks (crashed agent)
                # drives attempt unboundedly; past ~2^32 the cap rules
                ent.due = now + min(
                    self._t0 * 2.0 ** min(ent.attempt, 32), self._cap)
        return out

    def close(self) -> None:
        self.comm.close()
