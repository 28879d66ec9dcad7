"""Host↔client communication (paper §III).

A copy of ``repro/core/transport.py``; ZMQ is imported only by the ZMQ
transports, so the loopback pair runs where pyzmq is missing.

The paper uses ZMQ PUSH/PULL socket pairs ("each socket has a certain job"):
the host PUSHes testConfigs to each client's PULL socket and PULLs results
that clients PUSH back.  ``ZmqHostTransport``/``ZmqClientTransport`` keep that
protocol verbatim over TCP (the paper's SSH tunnelling removes the same-subnet
requirement on real fleets; not implemented here).

``LoopbackPair`` is an in-process queue transport with the same interface so
unit tests and single-process exploration need no sockets.

Batch wire format
-----------------
Scalar mode sends one testConfig dict per message and gets one result dict
back — N configs cost 2N serialized messages plus N poll cycles.  The batched
fast path frames a whole chunk into **one** message per direction, and —
because every config/result in a chunk shares the same schema — transposes
the payload into *columns* so each key is serialized once per frame instead
of once per config:

    host → client   {"cmd": "batchc", "n": N,
                     "plain":  {"config_id": [...], "arch": [...], ...},
                     "nested": {"knobs": {knob_name: [N values], ...}}}
    client → host   same frame shape with result fields; "metrics" is the
                    nested column.  Batch results omit the knobs/arch/shape
                    echo — the host rehydrates them from its in-flight table,
                    so the dominant result payload is just the metric columns.

A chunk whose messages disagree on keys (e.g. nothing in common to
transpose) falls back to the row frame {"cmd": "batch", "items": [...]};
a *column* whose dict values disagree on sub-keys (e.g. ok metrics next to
{"error": ...}) falls back to a row list for that column only.
``push_many``/``pull_many`` do the (un)framing on top of the existing
``push``/``pull`` primitives, so every transport implementation — ZMQ and
loopback alike — gets batching without touching its socket code, and a
batched host interoperates with a scalar peer: ``pull_many`` transparently
wraps a lone scalar message into a one-element list, and a one-element
``push_many`` degenerates to a plain ``push``.

Codec layer
-----------
How a framed dict becomes wire bytes is pluggable per transport
(``codec="json"`` | ``"binary"`` | a ``repro_torch.core.codec.Codec`` instance).
The binary codec packs a columnar frame's numeric columns as typed arrays —
see ``repro_torch.core.codec``.  Every receive path decodes by sniffing
(``decode_wire``), so mixed fleets interoperate; client transports
additionally answer in the codec of the last frame they received, so a
binary host gets binary results back from a json-configured client.

Artifact verbs (fleet store)
----------------------------
The fleet-wide artifact store (``repro_torch.core.fleet``) rides the same two
sockets as configs/results — clients have exactly one PUSH to the host and
one PULL from it — using five frame commands:

* ``ARTIFACT_QUERY`` (client→host) — "I miss fingerprint X in both my LRU
  and disk tiers; does the fleet have it?"  Carries ``addr`` (the content
  address, SHA-256 of ``repr((JConfig.identity(), cache_key))``) and ``fp``
  (``repr(cache_key)``, keying the host's residency map).
* ``ARTIFACT_PUT`` (both ways) — a pickled ``BuildResult`` blob (``blob``
  bytes), or a blob-less residency announcement (relay mode), or a
  ``status: "gone"`` apology when a relayed fetch finds nothing.
* ``ARTIFACT_CHUNK`` (both ways) — one slice of a large blob
  (``seq``/``n_chunks``); ``chunk_blob``/``ChunkAssembler`` split and
  reassemble, so multi-MB engines never occupy one giant frame.
* ``ARTIFACT_FETCH`` (host→client) — relay mode: "push me fingerprint X
  from your cache" (answered with a PUT, or a ``gone`` PUT).
* ``ARTIFACT_MISS`` (host→client) — the fleet has nothing: the asking
  client compiles, becoming the fingerprint's designated compiler.

``WireStats`` classifies these frames separately (``blob_*`` counters), so
the wire summary distinguishes artifact-blob traffic from config/result
traffic.
"""
from __future__ import annotations

import queue
from typing import Dict, List, Optional, Union

from repro_torch.core.codec import (Codec, decode_wire, resolve_codec, sniff_codec)

# frame markers for a list-of-messages payload (host→client carries
# testConfigs, client→host carries results)
BATCH_CMD = "batch"          # row frame: {"items": [dict, ...]}
BATCH_COLS_CMD = "batchc"    # columnar frame: keys serialized once

# fleet artifact-store verbs (see module docstring + repro_torch.core.fleet)
ARTIFACT_QUERY = "artifact_query"
ARTIFACT_PUT = "artifact_put"
ARTIFACT_CHUNK = "artifact_chunk"
ARTIFACT_FETCH = "artifact_fetch"
ARTIFACT_MISS = "artifact_miss"
ARTIFACT_CMDS = frozenset((ARTIFACT_QUERY, ARTIFACT_PUT, ARTIFACT_CHUNK,
                           ARTIFACT_FETCH, ARTIFACT_MISS))


def is_artifact_msg(msg) -> bool:
    """True for any fleet artifact-store frame."""
    return isinstance(msg, dict) and msg.get("cmd") in ARTIFACT_CMDS


# dynamic fleet membership verbs — ride the client→host result stream the
# same way ARTIFACT_* frames do (see repro_torch.core.scheduler add/remove_client)
CLIENT_HELLO = "client_hello"       # join: {client_id, resident_fps?, endpoint?}
CLIENT_GOODBYE = "client_goodbye"   # leave: {client_id, drain?}
MEMBERSHIP_CMDS = frozenset((CLIENT_HELLO, CLIENT_GOODBYE))


def is_membership_msg(msg) -> bool:
    """True for a fleet-membership frame (HELLO/GOODBYE)."""
    return isinstance(msg, dict) and msg.get("cmd") in MEMBERSHIP_CMDS


# multi-tenant service control verbs — a control plane riding the same
# client→host stream (or stdin, for launch.serve_explore): SUBMIT registers
# a new tenant sweep on the long-lived ExploreService, STATUS asks for a
# per-tenant progress snapshot, CANCEL drops a tenant's queued work and
# orphans its in-flight configs (see repro_torch.core.tenancy)
CONTROL_SUBMIT = "control_submit"   # {tenant, spec{...}}
CONTROL_STATUS = "control_status"   # {tenant?}
CONTROL_CANCEL = "control_cancel"   # {tenant}
CONTROL_CMDS = frozenset((CONTROL_SUBMIT, CONTROL_STATUS, CONTROL_CANCEL))


def is_control_msg(msg) -> bool:
    """True for a multi-tenant service control frame."""
    return isinstance(msg, dict) and msg.get("cmd") in CONTROL_CMDS


def chunk_blob(base: dict, blob: bytes, chunk_bytes: int) -> List[dict]:
    """Frame ``blob`` onto ``base`` (an ARTIFACT_PUT-shaped dict): one PUT
    frame when it fits, else a run of ARTIFACT_CHUNK frames carrying the
    base's metadata plus ``seq``/``n_chunks``.  ``ChunkAssembler`` on the
    far side reconstructs the identical PUT frame."""
    if chunk_bytes <= 0 or len(blob) <= chunk_bytes:
        return [dict(base, cmd=ARTIFACT_PUT, blob=blob)]
    n = (len(blob) + chunk_bytes - 1) // chunk_bytes
    return [dict(base, cmd=ARTIFACT_CHUNK, seq=i, n_chunks=n,
                 blob=blob[i * chunk_bytes:(i + 1) * chunk_bytes])
            for i in range(n)]


class ChunkAssembler:
    """Reassemble ARTIFACT_CHUNK runs into the PUT frame they sliced.

    Keyed by (sender, addr) so interleaved streams from different peers —
    or for different artifacts — cannot corrupt each other.  ``feed``
    returns the completed PUT frame once every chunk arrived, else None.
    A restarted run for the same key (seq 0 seen again, or a changed
    n_chunks) discards the stale partial state.
    """

    def __init__(self):
        self._parts: Dict[tuple, List[Optional[bytes]]] = {}

    def feed(self, msg: dict) -> Optional[dict]:
        key = (msg.get("client_id"), msg.get("addr"))
        seq, n = msg.get("seq"), msg.get("n_chunks")
        if not isinstance(seq, int) or not isinstance(n, int) \
                or not 0 <= seq < n:
            return None                       # malformed: drop
        parts = self._parts.get(key)
        if parts is None or len(parts) != n or (seq == 0 and parts[0]
                                                is not None):
            parts = self._parts[key] = [None] * n
        blob = msg.get("blob")
        parts[seq] = bytes(blob) if isinstance(blob, (bytes, bytearray)) \
            else b""
        if any(p is None for p in parts):
            return None
        del self._parts[key]
        out = {k: v for k, v in msg.items() if k not in ("seq", "n_chunks")}
        out["cmd"] = ARTIFACT_PUT
        out["blob"] = b"".join(parts)
        return out


def frame_batch(msgs: List[dict]) -> dict:
    """Frame a chunk, transposing to columns when the schema is uniform."""
    keys = msgs[0].keys()
    if any(m.keys() != keys for m in msgs[1:]):
        return {"cmd": BATCH_CMD, "items": list(msgs)}
    plain: Dict[str, list] = {}
    nested: Dict[str, Dict[str, list]] = {}
    for k in keys:
        vals = [m[k] for m in msgs]
        if isinstance(vals[0], dict):
            sub = vals[0].keys()
            if all(isinstance(v, dict) and v.keys() == sub for v in vals[1:]):
                nested[k] = {s: [v[s] for v in vals] for s in sub}
                continue
        plain[k] = vals
    return {"cmd": BATCH_COLS_CMD, "n": len(msgs),
            "plain": plain, "nested": nested}


def unframe_batch(msg: Optional[dict]) -> List[dict]:
    """Normalise a pulled message to a list of payload dicts.

    Frame-level sidecar fields (currently ``cache_info``, the artifact-cache
    summary a client attaches once per result frame) are re-attached to the
    *last* payload dict, so per-frame metadata survives the row/column
    transpose without being duplicated onto every result.
    """
    if msg is None:
        return []
    cmd = msg.get("cmd")
    if cmd == BATCH_CMD:
        items: List[dict] = list(msg["items"])
    elif cmd == BATCH_COLS_CMD:
        items = [{} for _ in range(msg["n"])]
        for k, col in msg["plain"].items():
            for it, v in zip(items, col):
                it[k] = v
        for k, sub in msg["nested"].items():
            if not sub:               # a column of uniformly-empty dicts
                for it in items:
                    it[k] = {}
                continue
            rebuilt = [dict(zip(sub.keys(), row)) for row in zip(*sub.values())]
            for it, v in zip(items, rebuilt):
                it[k] = v
    else:
        return [msg]
    sidecar = msg.get("cache_info")
    if sidecar is not None and items:
        items[-1] = dict(items[-1], cache_info=sidecar)
    return items


class WireStats:
    """Post-codec bytes/frames actually put on the wire, per peer.

    Host transports count outbound bytes per client and inbound bytes per
    reporting client (attributed from the decoded frame's ``client_id``
    field/column).  The host attaches ``wire_summary`` to the scheduler so
    ``DispatchScheduler.stats()`` — and the ``progress=True`` line — can
    show what each codec really costs on the wire.

    Frames are additionally accounted *per class*: artifact-store frames
    (``ARTIFACT_*`` commands — dominated by pickled ``BuildResult`` blobs)
    land in the ``blob_*`` counters as well as the totals, so the summary
    separates what the fleet cache moves from what dispatch/results move.
    """

    def __init__(self):
        self.out_bytes: Dict[int, int] = {}
        self.out_frames: Dict[int, int] = {}
        self.in_bytes: Dict[int, int] = {}
        self.in_frames: Dict[int, int] = {}
        # artifact-class subset of the totals above
        self.blob_out_bytes: Dict[int, int] = {}
        self.blob_out_frames: Dict[int, int] = {}
        self.blob_in_bytes: Dict[int, int] = {}
        self.blob_in_frames: Dict[int, int] = {}

    def sent(self, client_id: int, nbytes: int,
             msg: Optional[dict] = None) -> None:
        self.out_bytes[client_id] = self.out_bytes.get(client_id, 0) + nbytes
        self.out_frames[client_id] = self.out_frames.get(client_id, 0) + 1
        if is_artifact_msg(msg):
            self.blob_out_bytes[client_id] = \
                self.blob_out_bytes.get(client_id, 0) + nbytes
            self.blob_out_frames[client_id] = \
                self.blob_out_frames.get(client_id, 0) + 1

    def received(self, msg: Optional[dict], nbytes: int) -> None:
        """Attribute an inbound frame to its reporting client (-1 unknown)."""
        cid = -1
        if isinstance(msg, dict):
            v = msg.get("client_id")
            if v is None and msg.get("cmd") == BATCH_COLS_CMD:
                col = msg.get("plain", {}).get("client_id")
                v = col[0] if col else None
            elif v is None and msg.get("cmd") == BATCH_CMD:
                items = msg.get("items")
                v = items[0].get("client_id") if items else None
            if isinstance(v, int):
                cid = v
        self.in_bytes[cid] = self.in_bytes.get(cid, 0) + nbytes
        self.in_frames[cid] = self.in_frames.get(cid, 0) + 1
        if is_artifact_msg(msg):
            self.blob_in_bytes[cid] = self.blob_in_bytes.get(cid, 0) + nbytes
            self.blob_in_frames[cid] = self.blob_in_frames.get(cid, 0) + 1

    def summary(self) -> Dict:
        per_client = {}
        for cid in sorted(set(self.out_bytes) | set(self.in_bytes)):
            row = {"out_kb": round(self.out_bytes.get(cid, 0) / 1e3, 2),
                   "out_frames": self.out_frames.get(cid, 0),
                   "in_kb": round(self.in_bytes.get(cid, 0) / 1e3, 2),
                   "in_frames": self.in_frames.get(cid, 0)}
            if self.blob_out_bytes.get(cid) or self.blob_in_bytes.get(cid):
                row["blob_out_kb"] = round(
                    self.blob_out_bytes.get(cid, 0) / 1e3, 2)
                row["blob_in_kb"] = round(
                    self.blob_in_bytes.get(cid, 0) / 1e3, 2)
            per_client[cid] = row
        s = {
            "wire_out_mb": round(sum(self.out_bytes.values()) / 1e6, 6),
            "wire_in_mb": round(sum(self.in_bytes.values()) / 1e6, 6),
            "wire_out_frames": sum(self.out_frames.values()),
            "wire_in_frames": sum(self.in_frames.values()),
            "wire_per_client": per_client,
        }
        if self.blob_out_bytes or self.blob_in_bytes:
            s["wire_blob_out_mb"] = round(
                sum(self.blob_out_bytes.values()) / 1e6, 6)
            s["wire_blob_in_mb"] = round(
                sum(self.blob_in_bytes.values()) / 1e6, 6)
            s["wire_blob_frames"] = (sum(self.blob_out_frames.values())
                                     + sum(self.blob_in_frames.values()))
        return s


class HostTransport:
    def push(self, client_id: int, msg: dict) -> None:
        raise NotImplementedError

    def pull(self, timeout_s: float) -> Optional[dict]:
        raise NotImplementedError

    def _wire(self) -> WireStats:
        w = getattr(self, "wire", None)
        if w is None:
            w = self.wire = WireStats()
        return w

    def wire_summary(self) -> Dict:
        """Codec + bytes-on-wire stats; {} until something was counted."""
        w = getattr(self, "wire", None)
        if w is None:
            return {}
        s = w.summary()
        codec = getattr(self, "_codec", None)
        if codec is not None:
            s["codec"] = codec.name
        return s

    def push_many(self, client_id: int, msgs: List[dict]) -> None:
        """Ship a whole chunk of testConfigs as one framed message."""
        if len(msgs) == 1:
            self.push(client_id, msgs[0])
        elif msgs:
            self.push(client_id, frame_batch(msgs))

    def pull_many(self, timeout_s: float) -> List[dict]:
        """Pull one message and unframe it: 0, 1, or many results."""
        return unframe_batch(self.pull(timeout_s))

    def client_ids(self) -> List[int]:
        raise NotImplementedError

    # -- dynamic membership (optional per transport) --------------------------
    def add_client(self, client_id: int,
                   endpoint: Optional[str] = None) -> None:
        """Open a push path to a client that joined mid-run (HELLO)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support dynamic membership")

    def remove_client(self, client_id: int) -> None:
        """Tear down the push path of a departed client (GOODBYE)."""

    def close(self) -> None:
        pass


class ClientTransport:
    # wire-codec negotiation: answer in the codec the host last spoke
    _codec: Codec = resolve_codec("json")
    _peer_codec: Optional[Codec] = None

    def _note_wire(self, data) -> None:
        self._peer_codec = resolve_codec(sniff_codec(data))

    def _wire_codec(self) -> Codec:
        return self._peer_codec or self._codec

    def pull(self, timeout_s: float) -> Optional[dict]:
        raise NotImplementedError

    def push(self, msg: dict) -> None:
        raise NotImplementedError

    def push_many(self, msgs: List[dict],
                  extra: Optional[dict] = None) -> None:
        """Ship a whole batch of results as one framed message.

        ``extra`` keys ride on the frame dict itself (once per frame, not
        per result) and are re-attached by ``unframe_batch`` on the far
        side — how a client reports ``cache_info`` per chunk reply.
        """
        if len(msgs) == 1 and not extra:
            self.push(msgs[0])
        elif msgs:
            frame = frame_batch(msgs)
            if extra:
                frame.update(extra)
            self.push(frame)

    def pull_many(self, timeout_s: float) -> List[dict]:
        return unframe_batch(self.pull(timeout_s))

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# ZMQ (paper-faithful)
# ---------------------------------------------------------------------------


class ZmqHostTransport(HostTransport):
    """Host: one PUSH socket per client + one bound PULL for results.

    ``zmq.Context.instance()`` is process-global, so by default close() only
    closes this transport's sockets and leaves the shared context alone;
    pass ``own_ctx=True`` for a private context that close() terminates.
    close() is idempotent and linger-free either way.
    """

    def __init__(self, result_bind: str, client_endpoints: Dict[int, str],
                 codec: Union[str, Codec] = "json", own_ctx: bool = False):
        import zmq

        self._codec = resolve_codec(codec)
        self._own_ctx = own_ctx
        self._ctx = zmq.Context() if own_ctx else zmq.Context.instance()
        self._closed = False
        self._pull = self._ctx.socket(zmq.PULL)
        self._pull.setsockopt(zmq.LINGER, 0)
        self._pull.bind(result_bind)
        self._push = {}
        for cid, ep in client_endpoints.items():
            s = self._ctx.socket(zmq.PUSH)
            s.setsockopt(zmq.LINGER, 0)
            s.connect(ep)
            self._push[cid] = s

    def push(self, client_id: int, msg: dict) -> None:
        data = self._codec.encode(msg)
        self._wire().sent(client_id, len(data), msg)
        self._push[client_id].send(data)

    def pull(self, timeout_s: float) -> Optional[dict]:
        import zmq

        if self._pull.poll(int(timeout_s * 1000), zmq.POLLIN):
            data = self._pull.recv()
            msg = decode_wire(data)
            self._wire().received(msg, len(data))
            return msg
        return None

    def client_ids(self) -> List[int]:
        return sorted(self._push)

    def add_client(self, client_id: int,
                   endpoint: Optional[str] = None) -> None:
        """Connect a PUSH socket to a client that announced itself (its
        HELLO carries the config endpoint it bound)."""
        import zmq

        if client_id in self._push:
            return
        if not endpoint:
            raise ValueError("ZMQ membership needs the joining client's "
                             "config endpoint (HELLO 'endpoint' field)")
        s = self._ctx.socket(zmq.PUSH)
        s.setsockopt(zmq.LINGER, 0)
        s.connect(endpoint)
        self._push[client_id] = s

    def remove_client(self, client_id: int) -> None:
        s = self._push.pop(client_id, None)
        if s is not None:
            s.close(0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for s in self._push.values():
            s.close(0)
        self._pull.close(0)
        if self._own_ctx:
            self._ctx.term()


class ZmqClientTransport(ClientTransport):
    """Client: bound PULL for configs + PUSH connected to the host.

    Same context/teardown policy as ``ZmqHostTransport``.
    """

    def __init__(self, config_bind: str, result_endpoint: str,
                 codec: Union[str, Codec] = "json", own_ctx: bool = False):
        import zmq

        self._codec = resolve_codec(codec)
        self._peer_codec = None
        self._own_ctx = own_ctx
        self._ctx = zmq.Context() if own_ctx else zmq.Context.instance()
        self._closed = False
        self._pull = self._ctx.socket(zmq.PULL)
        self._pull.setsockopt(zmq.LINGER, 0)
        self._pull.bind(config_bind)
        self._push = self._ctx.socket(zmq.PUSH)
        self._push.setsockopt(zmq.LINGER, 0)
        self._push.connect(result_endpoint)

    def pull(self, timeout_s: float) -> Optional[dict]:
        import zmq

        if self._pull.poll(int(timeout_s * 1000), zmq.POLLIN):
            data = self._pull.recv()
            self._note_wire(data)
            return decode_wire(data)
        return None

    def push(self, msg: dict) -> None:
        self._push.send(self._wire_codec().encode(msg))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pull.close(0)
        self._push.close(0)
        if self._own_ctx:
            self._ctx.term()


# ---------------------------------------------------------------------------
# In-process loopback (tests / single-process exploration)
# ---------------------------------------------------------------------------


class LoopbackPair:
    """Queues shared by a LoopbackHost and its LoopbackClients."""

    def __init__(self, n_clients: int, codec: Union[str, Codec] = "json"):
        self.to_client = {i: queue.Queue() for i in range(n_clients)}
        self.to_host: "queue.Queue" = queue.Queue()
        self.codec = resolve_codec(codec)

    def add_client(self, client_id: int) -> None:
        """Provision queues for a client joining mid-run (idempotent)."""
        self.to_client.setdefault(client_id, queue.Queue())

    def host(self, codec: Union[str, Codec, None] = None
             ) -> "LoopbackHostTransport":
        return LoopbackHostTransport(
            self, self.codec if codec is None else resolve_codec(codec))

    def client(self, client_id: int, codec: Union[str, Codec, None] = None
               ) -> "LoopbackClientTransport":
        return LoopbackClientTransport(
            self, client_id,
            self.codec if codec is None else resolve_codec(codec))


class LoopbackHostTransport(HostTransport):
    def __init__(self, pair: LoopbackPair, codec: Optional[Codec] = None):
        self._pair = pair
        self._codec = codec or pair.codec

    def push(self, client_id: int, msg: dict) -> None:
        # round-trip through the codec to keep wire-format parity with ZMQ
        data = self._codec.encode(msg)
        self._wire().sent(client_id, len(data), msg)
        self._pair.to_client[client_id].put(data)

    def pull(self, timeout_s: float) -> Optional[dict]:
        try:
            data = self._pair.to_host.get(timeout=timeout_s)
        except queue.Empty:
            return None
        msg = decode_wire(data)
        self._wire().received(msg, len(data))
        return msg

    def client_ids(self) -> List[int]:
        return sorted(self._pair.to_client)

    def add_client(self, client_id: int,
                   endpoint: Optional[str] = None) -> None:
        self._pair.add_client(client_id)

    def remove_client(self, client_id: int) -> None:
        # the queue stays (a rejoin reuses it); membership is the
        # scheduler's business, the loopback just moves frames
        pass


class LoopbackClientTransport(ClientTransport):
    def __init__(self, pair: LoopbackPair, client_id: int,
                 codec: Optional[Codec] = None):
        self._pair = pair
        self._cid = client_id
        self._codec = codec or pair.codec
        self._peer_codec = None

    def pull(self, timeout_s: float) -> Optional[dict]:
        try:
            data = self._pair.to_client[self._cid].get(timeout=timeout_s)
        except queue.Empty:
            return None
        self._note_wire(data)
        return decode_wire(data)

    def push(self, msg: dict) -> None:
        self._pair.to_host.put(self._wire_codec().encode(msg))
