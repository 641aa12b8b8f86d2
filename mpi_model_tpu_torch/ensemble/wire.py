"""The fleet's wire format, TW1 (counterpart of
``mpi_model_tpu/ensemble/wire.py``; its frames are byte for byte the JAX
package's for the same message).

Frame::

    b"TW1 <len:08x> <crc:08x>\\n" + payload + b"\\n"

with the CRC32 over the whole payload. A payload is the message's JSON
metadata (which carries ``kind``), optionally followed by ``b"\\x00"`` and a
raw binary blob whose slices the metadata's ``arrays`` table describes,
each with its own CRC32. The ticket journal (``ensemble.journal``) writes
the same payloads (:func:`encode_payload`/:func:`parse_payload`) in a file
envelope.

Arrays cross as their raw little-endian bytes under numpy's dtype name.
A torch tensor is copied to the host first; a ``torch.bfloat16`` tensor
crosses as its raw bytes named ``"bfloat16"`` (the name ``io.checkpoint``
uses). :func:`parse_payload` returns every array as a CPU torch tensor of
its dtype, bfloat16 included.

Rules, each typed:

- a torn, short, oversized or CRC-failing frame raises :class:`WireError`,
  never a partial apply and never a hang;
- a peer that closes mid-frame raises :class:`WireClosed`;
- every receive carries a deadline: silence past it raises
  :class:`WireTimeout`. Any failure closes the connection.

:func:`tcp_listener`/:func:`tcp_dial` put the same frames on TCP behind a
mutual HMAC-SHA256 challenge and response at accept
(:func:`serve_handshake`/:func:`client_handshake`, the secret from the
environment variable :data:`SECRET_ENV`): a wrong secret, a truncated
exchange or a peer slower than :data:`HANDSHAKE_DEADLINE_S` raises
:class:`HandshakeError` and closes the socket before any frame is parsed.

Chaos seams (``resilience.inject``): ``wire_torn`` tears one outgoing
frame (``tear="corrupt"`` flips bytes, so the receiver's CRC check fires;
``tear="truncate"`` sends a prefix and closes); ``tcp_partition`` makes one
send or receive behave as a partition (the connection closes,
``WireTimeout``); ``handshake_fail`` garbles one handshake proof, so the
peer refuses. Disarmed, each costs one module-global read.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import json
import secrets as _secrets
import socket as _socket
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ..resilience import inject

__all__ = [
    "WireError",
    "WireTimeout",
    "WireClosed",
    "HandshakeError",
    "RemoteError",
    "FrameConn",
    "encode_payload",
    "parse_payload",
    "frame",
    "serve_handshake",
    "client_handshake",
    "tcp_listener",
    "tcp_dial",
    "REQUEST_KINDS",
    "REPLY_KINDS",
    "MAX_FRAME_BYTES",
    "TRACE_META_KEY",
    "SECRET_ENV",
    "HANDSHAKE_DEADLINE_S",
    "TCP_HEARTBEAT_DEADLINE_S",
    "TCP_RPC_DEADLINE_S",
]

_MAGIC = b"TW1 "
_HEADER_LEN = 22  # b"TW1 " + 8 hex + b" " + 8 hex + b"\n"

#: the largest declared length a receiver allocates for (a corrupt header
#: fails typed, not as an out-of-memory)
MAX_FRAME_BYTES = 1 << 30

#: the member RPC vocabulary (supervisor → member); every request gets one
#: reply frame
REQUEST_KINDS = ("submit", "poll", "migrate", "queued", "pump", "drain",
                 "dispatch_log", "heartbeat", "shutdown")
#: reply kinds (member → supervisor)
REPLY_KINDS = ("ok", "pending", "overloaded", "err")

#: the meta key a submit frame carries its trace context under
#: (``utils.tracing.TraceContext.to_meta``)
TRACE_META_KEY = "trace"

#: the dtype name of a bfloat16 array (numpy's, with ml_dtypes loaded)
BF16_NAME = "bfloat16"


class WireError(ValueError):
    """A frame failed to parse or verify (bad magic, short read, oversized
    length, a payload or per-array CRC mismatch, malformed metadata). The
    connection is unsynchronized after it. A ``ValueError``, so the
    journal's truncate-to-verified-prefix scan catches it."""


class WireTimeout(WireError):
    """The receive deadline passed with the frame incomplete."""


class WireClosed(WireError):
    """The peer closed (EOF), mid-frame or between frames."""


class HandshakeError(WireError):
    """The accept-time HMAC challenge and response failed (a wrong secret,
    a truncated or garbled exchange, a peer slower than the deadline). The
    socket is closed before any frame is parsed."""


class RemoteError(RuntimeError):
    """A member-side exception rebuilt on the supervisor's side of the
    wire: ``remote_type`` names the original class, ``detail`` is its
    message."""

    def __init__(self, remote_type: str, detail: str):
        super().__init__(f"{remote_type}: {detail}")
        self.remote_type = remote_type
        self.detail = detail


# -- payload codec (shared with the journal: one format, two envelopes) ------

def _host_bytes(a) -> tuple[str, list, bytes]:
    """``(dtype name, shape, raw bytes)`` of one array or tensor, as the
    JAX package's ``np.asarray(a).tobytes()`` gives them."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            return BF16_NAME, list(t.shape), raw
        a = t.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return str(a.dtype), list(a.shape), a.tobytes()


def _from_bytes(raw: bytes, dtype: str, shape: tuple) -> torch.Tensor:
    """One array back from its bytes, as a CPU tensor (a bfloat16 array
    through its uint16 bits)."""
    if dtype == BF16_NAME:
        u16 = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(u16).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy())


def encode_payload(meta: dict, arrays: Optional[dict] = None) -> bytes:
    """JSON metadata plus an optional NUL-separated binary blob whose
    slices (dtype, shape, offset, nbytes, crc32) the metadata's ``arrays``
    table describes. ``meta`` is copied, not changed."""
    body = dict(meta)
    blob = b""
    if arrays is not None:
        table = {}
        parts = []
        off = 0
        for name in sorted(arrays):
            dtype, shape, raw = _host_bytes(arrays[name])
            table[name] = {
                "dtype": dtype, "shape": shape,
                "offset": off, "nbytes": len(raw),
                "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            }
            parts.append(raw)
            off += len(raw)
        body["arrays"] = table
        blob = b"\x00" + b"".join(parts)
    return json.dumps(body, sort_keys=True).encode() + blob


def parse_payload(payload: bytes) -> tuple[dict, Optional[dict]]:
    """One payload back to ``(meta, arrays)``, every per-array CRC32
    verified. Raises :class:`WireError` on any malformation."""
    cut = payload.find(b"\x00")
    meta_bytes = payload if cut < 0 else payload[:cut]
    try:
        meta = json.loads(meta_bytes.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"payload metadata failed to decode: {e}") from e
    if not isinstance(meta, dict):
        raise WireError(
            f"payload metadata is {type(meta).__name__}, expected dict")
    arrays = None
    if "arrays" in meta:
        if cut < 0:
            raise WireError("payload declares arrays but carries no blob")
        blob = payload[cut + 1:]
        arrays = {}
        try:
            items = meta["arrays"].items()
        except AttributeError as e:
            raise WireError("payload arrays table is not a mapping") from e
        for name, spec in items:
            try:
                raw = blob[spec["offset"]:spec["offset"] + spec["nbytes"]]
                if len(raw) != spec["nbytes"]:
                    raise WireError(f"array {name!r} blob slice short")
                if (zlib.crc32(raw) & 0xFFFFFFFF) != spec["crc32"]:
                    raise WireError(
                        f"array {name!r} failed its per-array CRC32")
                arrays[name] = _from_bytes(raw, spec["dtype"],
                                           tuple(spec["shape"]))
            except (KeyError, TypeError, ValueError, RuntimeError) as e:
                if isinstance(e, WireError):
                    raise
                raise WireError(
                    f"array {name!r} table entry malformed: {e}") from e
    return meta, arrays


def frame(payload: bytes) -> bytes:
    """One complete frame around ``payload``. An over-cap payload is
    refused on the sender, with its size named."""
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            f"payload is {len(payload)} bytes — over the "
            f"{MAX_FRAME_BYTES}-byte frame cap (a scenario too large "
            "for the wire; shrink the state or raise the cap on BOTH "
            "sides)")
    header = b"TW1 %08x %08x\n" % (
        len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
    return header + payload + b"\n"


# -- accept-time authentication and TCP ---------------------------------------

#: the environment variable a spawned member reads its shared secret from
#: (never the command line, where ``ps`` would show it)
SECRET_ENV = "MMTPU_WIRE_SECRET"

#: the handshake's wall budget
HANDSHAKE_DEADLINE_S = 5.0

#: TCP deadlines, tolerant of network jitter
TCP_HEARTBEAT_DEADLINE_S = 5.0
TCP_RPC_DEADLINE_S = 60.0

_HS_MAGIC = b"TWA1 "
#: ``b"TWA1 " + 32-hex nonce + b"\n"``: each side's challenge
_HS_CHALLENGE_LEN = len(_HS_MAGIC) + 32 + 1
#: ``b"TWA1 " + 64-hex digest + b" " + 32-hex nonce + b"\n"``: the client's
#: proof and its counter-challenge
_HS_REPLY_LEN = len(_HS_MAGIC) + 64 + 1 + 32 + 1
#: ``b"TWA1 " + 64-hex digest + b"\n"``: the server's proof
_HS_PROOF_LEN = len(_HS_MAGIC) + 64 + 1


def _hs_digest(secret: str, role: bytes, nonce: bytes) -> bytes:
    """HMAC-SHA256 over ``role + b":" + nonce``: the role tag keeps the two
    directions' proofs distinct."""
    return _hmac.new(secret.encode(), role + b":" + nonce,
                     hashlib.sha256).hexdigest().encode()


def _hs_read(sock, n: int, t_end: float, *, what: str) -> bytes:
    """Exactly ``n`` handshake bytes before ``t_end``, or
    :class:`HandshakeError`."""
    chunks: list = []
    total = 0
    while total < n:
        remaining = t_end - time.monotonic()
        if remaining <= 0:
            raise HandshakeError(
                f"handshake {what} incomplete at its deadline "
                f"({total}/{n} bytes) — peer too slow")
        sock.settimeout(remaining)
        try:
            chunk = sock.recv(n - total)
        except _socket.timeout as e:
            raise HandshakeError(
                f"handshake {what} incomplete at its deadline "
                f"({total}/{n} bytes) — peer too slow") from e
        except OSError as e:
            raise HandshakeError(f"handshake {what} failed: {e}") from e
        if not chunk:
            raise HandshakeError(
                f"peer closed during handshake {what} "
                f"({total}/{n} bytes)")
        chunks.append(chunk)
        total += len(chunk)
    return b"".join(chunks)


def _hs_nonce_of(line: bytes, *, what: str) -> bytes:
    if line[:len(_HS_MAGIC)] != _HS_MAGIC or line[-1:] != b"\n":
        raise HandshakeError(f"malformed handshake {what} {line[:8]!r}")
    return line[len(_HS_MAGIC):-1]


def _hs_maybe_garbled(digest: bytes, chaos_id: Optional[str]) -> bytes:
    """The ``handshake_fail`` seam: a live fault aimed at ``chaos_id``
    garbles this side's proof, so the peer refuses."""
    st = inject.active()
    if st is None:
        return digest
    f = st.member_fault(chaos_id, ("handshake_fail",),
                        site="handshake", count=True)
    if f is None:
        return digest
    return bytes(reversed(digest))


def _close_quietly(sock) -> None:
    try:
        sock.close()
    except OSError:  # pragma: no cover - close is best effort
        pass


def serve_handshake(sock, secret: str,
                    deadline_s: float = HANDSHAKE_DEADLINE_S,
                    chaos_id: Optional[str] = None) -> None:
    """Authenticate an accepted connection (server side) before any frame:
    challenge the peer, verify its proof, then prove ourselves against its
    counter-challenge. Any failure raises :class:`HandshakeError` and
    closes the socket."""
    t_end = time.monotonic() + float(deadline_s)
    try:
        nonce = _secrets.token_hex(16).encode()
        sock.settimeout(deadline_s)
        sock.sendall(_HS_MAGIC + nonce + b"\n")
        reply = _hs_read(sock, _HS_REPLY_LEN, t_end, what="reply")
        body = _hs_nonce_of(reply, what="reply")
        proof, sep, peer_nonce = body.partition(b" ")
        if not sep or len(peer_nonce) != 32:
            raise HandshakeError("malformed handshake reply")
        want = _hs_digest(secret, b"client", nonce)
        if not _hmac.compare_digest(proof, want):
            raise HandshakeError(
                "peer failed the challenge (wrong wire secret)")
        ours = _hs_maybe_garbled(
            _hs_digest(secret, b"server", peer_nonce), chaos_id)
        sock.sendall(_HS_MAGIC + ours + b"\n")
    except (HandshakeError, OSError) as e:
        _close_quietly(sock)
        if isinstance(e, HandshakeError):
            raise
        raise HandshakeError(f"handshake failed: {e}") from e


def client_handshake(sock, secret: str,
                     deadline_s: float = HANDSHAKE_DEADLINE_S,
                     chaos_id: Optional[str] = None) -> None:
    """The dialing side of :func:`serve_handshake`: answer the listener's
    challenge, counter-challenge it, verify its proof. Same failure
    contract."""
    t_end = time.monotonic() + float(deadline_s)
    try:
        challenge = _hs_read(sock, _HS_CHALLENGE_LEN, t_end,
                             what="challenge")
        nonce = _hs_nonce_of(challenge, what="challenge")
        if len(nonce) != 32:
            raise HandshakeError("malformed handshake challenge")
        ours = _hs_maybe_garbled(
            _hs_digest(secret, b"client", nonce), chaos_id)
        my_nonce = _secrets.token_hex(16).encode()
        sock.settimeout(deadline_s)
        sock.sendall(_HS_MAGIC + ours + b" " + my_nonce + b"\n")
        proof_line = _hs_read(sock, _HS_PROOF_LEN, t_end, what="proof")
        proof = _hs_nonce_of(proof_line, what="proof")
        want = _hs_digest(secret, b"server", my_nonce)
        if not _hmac.compare_digest(proof, want):
            raise HandshakeError(
                "listener failed the counter-challenge (wrong wire "
                "secret)")
    except (HandshakeError, OSError) as e:
        _close_quietly(sock)
        if isinstance(e, HandshakeError):
            raise
        raise HandshakeError(f"handshake failed: {e}") from e


def tcp_listener(host: str = "127.0.0.1", port: int = 0):
    """A listening TCP socket (``port=0``: the system picks one, read back
    with ``getsockname()``)."""
    return _socket.create_server((host, port))


def tcp_dial(addr: str, deadline_s: float = HANDSHAKE_DEADLINE_S):
    """Dial a ``host:port`` address (an IPv6 host may be bracketed);
    :class:`WireClosed` when the peer is unreachable within
    ``deadline_s``."""
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"not a host:port address: {addr!r}")
    host = host.strip("[]") or "127.0.0.1"
    try:
        return _socket.create_connection((host, int(port)),
                                         timeout=float(deadline_s))
    except OSError as e:
        raise WireClosed(f"dial {addr} failed: {e}") from e


# -- the connection -----------------------------------------------------------

class FrameConn:
    """Frame-at-a-time messaging over one stream socket. Not locked: each
    side serializes its own use. ``chaos_id`` names the member this
    connection belongs to, so the wire faults can target it by
    ``channel``; ``bytes_in``/``bytes_out`` count the bytes moved."""

    def __init__(self, sock, chaos_id: Optional[str] = None):
        self._sock = sock
        self.chaos_id = chaos_id
        self.bytes_in = 0
        self.bytes_out = 0
        self._buf = b""
        self._closed = False

    # -- sending -------------------------------------------------------------

    def send(self, kind: str, meta: Optional[dict] = None,
             arrays: Optional[dict] = None,
             deadline_s: Optional[float] = None) -> None:
        """Frame and send one message. ``kind`` must be a request or reply
        kind: a misspelt one fails here, on the sender."""
        if kind not in REQUEST_KINDS and kind not in REPLY_KINDS:
            raise ValueError(
                f"unknown wire message kind {kind!r} (expected one of "
                f"{REQUEST_KINDS + REPLY_KINDS})")
        body = dict(meta or {})
        body["kind"] = kind
        data = frame(encode_payload(body, arrays))
        st = inject.active()
        if st is not None:
            self._maybe_partitioned(st)
            f = st.member_fault(self.chaos_id, ("wire_torn",),
                                site="wire", count=False)
            if f is not None:
                self._send_torn(data, f)
                return
        self._sendall(data, deadline_s)
        self.bytes_out += len(data)

    def _maybe_partitioned(self, st) -> None:
        """The ``tcp_partition`` seam: the connection closes and the call
        raises :class:`WireTimeout`, as a real partition does at the
        deadline."""
        f = st.member_fault(self.chaos_id, ("tcp_partition",),
                            site="wire", count=False)
        if f is not None:
            self.close()
            raise WireTimeout(
                "injected tcp partition: peer unreachable at the "
                "deadline")

    def _send_torn(self, data: bytes, fault) -> None:
        """The ``wire_torn`` seam: ``corrupt`` flips ``nbytes`` at
        ``offset``; ``truncate`` sends the first ``offset`` bytes and
        closes."""
        if fault.tear == "truncate":
            cut = min(max(fault.offset, 0), len(data))
            self._sendall(data[:cut], None)
            self.bytes_out += cut
            self.close()
            return
        off = min(max(fault.offset, 0), max(len(data) - 1, 0))
        chunk = data[off:off + fault.nbytes]
        data = (data[:off] + bytes(b ^ 0xFF for b in chunk)
                + data[off + len(chunk):])
        self._sendall(data, None)
        self.bytes_out += len(data)

    def _sendall(self, data: bytes, deadline_s: Optional[float]) -> None:
        if self._closed:
            raise WireClosed("connection already closed")
        try:
            self._sock.settimeout(deadline_s)
            self._sock.sendall(data)
        except _socket.timeout as e:
            raise WireTimeout(
                f"send blocked past its {deadline_s}s deadline") from e
        except OSError as e:
            raise WireClosed(f"send failed: {e}") from e

    # -- receiving -----------------------------------------------------------

    def recv(self, deadline_s: Optional[float] = None
             ) -> tuple[str, dict, Optional[dict]]:
        """Read one frame: ``(kind, meta, arrays)``. :class:`WireTimeout`
        when ``deadline_s`` wall seconds pass with the frame incomplete,
        :class:`WireClosed` on EOF, :class:`WireError` on any framing or
        CRC failure; any failure closes the connection (a late reply must
        never pair with the next request)."""
        st = inject.active()
        if st is not None:
            self._maybe_partitioned(st)
        try:
            return self._recv(deadline_s)
        except WireError:
            self.close()
            raise

    def _recv(self, deadline_s: Optional[float]
              ) -> tuple[str, dict, Optional[dict]]:
        t_end = (None if deadline_s is None
                 else time.monotonic() + float(deadline_s))
        header = self._read_exact(_HEADER_LEN, t_end)
        if header[:4] != _MAGIC or header[12:13] != b" " \
                or header[21:22] != b"\n":
            raise WireError(f"bad frame header {header!r}")
        try:
            n = int(header[4:12], 16)
            want = int(header[13:21], 16)
        except ValueError as e:
            raise WireError(f"bad frame header {header!r}") from e
        if n > MAX_FRAME_BYTES:
            raise WireError(
                f"frame declares {n} bytes (> {MAX_FRAME_BYTES} cap) — "
                "refusing a corrupt length")
        body = self._read_exact(n + 1, t_end)
        payload, trailer = body[:n], body[n:]
        if trailer != b"\n":
            raise WireError("frame trailer missing")
        if (zlib.crc32(payload) & 0xFFFFFFFF) != want:
            raise WireError("frame payload failed its CRC32")
        meta, arrays = parse_payload(payload)
        kind = meta.get("kind")
        if not isinstance(kind, str):
            raise WireError("frame metadata carries no kind")
        return kind, meta, arrays

    def _read_exact(self, n: int, t_end: Optional[float]) -> bytes:
        # chunks gather in a list and join once (a running bytes += would
        # copy quadratically on a large frame)
        chunks = [self._buf]
        total = len(self._buf)
        try:
            while total < n:
                if self._closed:
                    raise WireClosed("connection already closed")
                if t_end is not None:
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        raise WireTimeout(
                            "frame incomplete at its receive deadline "
                            f"({total}/{n} bytes)")
                    self._sock.settimeout(remaining)
                else:
                    self._sock.settimeout(None)
                try:
                    chunk = self._sock.recv(65536)
                except _socket.timeout as e:
                    raise WireTimeout(
                        "frame incomplete at its receive deadline "
                        f"({total}/{n} bytes)") from e
                except OSError as e:
                    raise WireClosed(f"recv failed: {e}") from e
                if not chunk:
                    raise WireClosed(
                        f"peer closed mid-frame ({total}/{n} bytes)")
                chunks.append(chunk)
                total += len(chunk)
                self.bytes_in += len(chunk)
        finally:
            # what arrived stays in the buffer even on an error path
            self._buf = b"".join(chunks)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    # -- lifecycle -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        _close_quietly(self._sock)

    def __enter__(self) -> "FrameConn":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
