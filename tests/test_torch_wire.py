"""The port's TW1 wire (``mpi_model_tpu_torch/ensemble/wire.py``) on the
CPU: counterparts of the JAX package's ``tests/test_wire.py`` (the
round-trips, the torn and bit-flipped frame walls, the deadlines, the
``wire_torn``/``tcp_partition``/``handshake_fail`` seams, the HMAC handshake
over a socketpair and over TCP on ``127.0.0.1`` port 0), then the formats
across the packages: the same message encodes to the same bytes in both
(f64, f32, int, bool and bf16 arrays; a bf16 array is a torch tensor on the
port's side and an ``ml_dtypes`` array on JAX's), and each package's
``FrameConn`` reads the other's frames bit for bit.

Real sockets, no subprocess; every receive carries a deadline.
"""

import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from mpi_model_tpu.ensemble import wire as jwire
from mpi_model_tpu.resilience import inject as jinject

from mpi_model_tpu_torch.ensemble import wire
from mpi_model_tpu_torch.ensemble.wire import (
    MAX_FRAME_BYTES,
    REPLY_KINDS,
    REQUEST_KINDS,
    FrameConn,
    HandshakeError,
    RemoteError,
    WireClosed,
    WireError,
    WireTimeout,
    client_handshake,
    encode_payload,
    frame,
    parse_payload,
    serve_handshake,
    tcp_dial,
    tcp_listener,
)
from mpi_model_tpu_torch.resilience import inject
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan


def conn_pair():
    a, b = socket.socketpair()
    return FrameConn(a), FrameConn(b)


RNG = np.random.default_rng(7)

#: a full scenario-state payload: an f64 grid, a bool mask, an int32 lane
#: and an f32 block
SCENARIO_ARRAYS = {
    "value": RNG.uniform(0.5, 2.0, (16, 16)),
    "mask": RNG.uniform(size=(16, 16)) > 0.5,
    "ids": RNG.integers(0, 1 << 30, (16,), dtype=np.int32),
    "f32": RNG.uniform(-1, 1, (4, 4)).astype(np.float32),
}
#: the same bf16 values as a port tensor and as a JAX-side numpy array
BF16_BITS = RNG.integers(0, 1 << 16, (8, 8), dtype=np.uint16)
BF16_T = torch.from_numpy(BF16_BITS.copy()).view(torch.bfloat16)
BF16_NP = BF16_BITS.view(ml_dtypes.bfloat16)


@pytest.fixture(autouse=True)
def _no_plan_left():
    yield
    assert inject.active() is None and jinject.active() is None


# -- round-trips --------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(REQUEST_KINDS + REPLY_KINDS))
def test_roundtrip_every_kind_with_scenario_payload(kind):
    """Every message kind crosses a socketpair with a scenario payload and
    rich metadata and comes back bit for bit: bytes, dtypes, shapes."""
    c, s = conn_pair()
    meta = {"ticket": 3, "steps": 8, "dim_x": 16, "dim_y": 16,
            "model": {"flows": [{"type": "Diffusion",
                                 "params": {"rate": 0.05}}]},
            "nested": {"a": [1, 2.5, None, True], "b": "text"}}
    c.send(kind, meta, SCENARIO_ARRAYS)
    got_kind, got_meta, got_arrays = s.recv(deadline_s=5.0)
    assert got_kind == kind
    for k, v in meta.items():
        assert got_meta[k] == v
    assert set(got_arrays) == set(SCENARIO_ARRAYS)
    for k, a in SCENARIO_ARRAYS.items():
        assert isinstance(got_arrays[k], torch.Tensor)
        assert got_arrays[k].numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(got_arrays[k].numpy(), np.asarray(a))
    c.close()
    s.close()


def test_roundtrip_no_arrays_and_empty_meta():
    c, s = conn_pair()
    c.send("heartbeat")
    kind, meta, arrays = s.recv(deadline_s=5.0)
    assert kind == "heartbeat" and arrays is None
    c.close(), s.close()


def test_payload_codec_roundtrip_is_bitwise():
    payload = encode_payload({"kind": "submit", "x": 1}, SCENARIO_ARRAYS)
    meta, arrays = parse_payload(payload)
    assert meta["kind"] == "submit" and meta["x"] == 1
    for k, a in SCENARIO_ARRAYS.items():
        assert arrays[k].numpy().tobytes() == np.ascontiguousarray(
            np.asarray(a)).tobytes()


def test_torch_tensors_and_bf16_roundtrip_bitwise():
    """Torch tensors cross as their numpy bytes; a bf16 tensor crosses as
    raw bytes named "bfloat16"; every array parses back to a CPU tensor of
    its dtype."""
    arrays = {"t64": torch.from_numpy(SCENARIO_ARRAYS["value"]),
              "b16": BF16_T, "t32": torch.arange(6.0).reshape(2, 3)}
    meta, got = parse_payload(encode_payload({"kind": "ok"}, arrays))
    assert meta["arrays"]["b16"]["dtype"] == "bfloat16"
    assert isinstance(got["b16"], torch.Tensor)
    assert got["b16"].dtype == torch.bfloat16 and got["b16"].shape == (8, 8)
    assert torch.equal(got["b16"].view(torch.int16),
                       BF16_T.view(torch.int16))
    np.testing.assert_array_equal(got["t64"].numpy(),
                                  SCENARIO_ARRAYS["value"])
    assert got["t32"].dtype == torch.float32 and got["t32"].is_cpu


def test_unknown_kind_fails_on_the_sender():
    c, _s = conn_pair()
    with pytest.raises(ValueError, match="unknown wire message kind"):
        c.send("not-a-kind", {})


def test_byte_counters_move_both_ways():
    c, s = conn_pair()
    c.send("poll", {"ticket": 1})
    s.recv(deadline_s=5.0)
    s.send("pending", {})
    c.recv(deadline_s=5.0)
    assert c.bytes_out > 0 and s.bytes_in == c.bytes_out
    assert s.bytes_out > 0 and c.bytes_in == s.bytes_out
    c.close(), s.close()


# -- the adversarial half -----------------------------------------------------

def _small_frame() -> bytes:
    return frame(encode_payload({"kind": "poll", "ticket": 7},
                                {"v": np.arange(3.0)}))


def test_torn_at_every_boundary_raises_typed_never_hangs():
    """A peer that dies after any prefix of a frame: a typed wire error at
    every byte boundary, never a hang or a partial message."""
    data = _small_frame()
    for i in range(len(data)):
        a, b = socket.socketpair()
        c, s = FrameConn(a), FrameConn(b)
        a.sendall(data[:i])
        c.close()  # EOF mid-frame: the crash shape
        with pytest.raises(WireError):
            s.recv(deadline_s=5.0)
        s.close()


def test_bit_flip_at_every_position_raises_typed():
    """Any single corrupted byte surfaces as a typed wire error."""
    data = _small_frame()
    for i in range(len(data)):
        flipped = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        a, b = socket.socketpair()
        c, s = FrameConn(a), FrameConn(b)
        a.sendall(flipped)
        c.close()
        with pytest.raises(WireError):
            s.recv(deadline_s=5.0)
        s.close()


def test_per_array_crc_failure_is_typed_even_with_valid_frame_crc():
    payload = bytearray(encode_payload({"kind": "poll"},
                                       {"v": np.arange(8.0)}))
    cut = bytes(payload).find(b"\x00")
    payload[cut + 1] ^= 0xFF  # corrupt the blob, then frame it validly
    with pytest.raises(WireError, match="per-array CRC32"):
        parse_payload(bytes(payload))
    a, b = socket.socketpair()
    c, s = FrameConn(a), FrameConn(b)
    a.sendall(frame(bytes(payload)))
    with pytest.raises(WireError, match="per-array CRC32"):
        s.recv(deadline_s=5.0)
    c.close(), s.close()


def test_oversized_payload_refused_on_the_sender(monkeypatch):
    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 64)
    big = encode_payload({"kind": "submit"}, {"v": np.zeros(64)})
    with pytest.raises(ValueError, match="frame cap"):
        wire.frame(big)
    a, b = socket.socketpair()
    c = FrameConn(a)
    with pytest.raises(ValueError, match="frame cap"):
        c.send("submit", {}, {"v": np.zeros(64)})
    c.close(), b.close()


def test_oversized_declared_length_refused():
    header = b"TW1 %08x %08x\n" % (MAX_FRAME_BYTES + 1, 0)
    a, b = socket.socketpair()
    s = FrameConn(b)
    a.sendall(header)
    with pytest.raises(WireError, match="refusing a corrupt length"):
        s.recv(deadline_s=5.0)
    a.close()
    s.close()


def test_recv_deadline_is_a_classified_timeout():
    """Silence past the deadline is ``WireTimeout``, and the failure closes
    the connection."""
    a, b = socket.socketpair()
    s = FrameConn(b)
    with pytest.raises(WireTimeout):
        s.recv(deadline_s=0.05)
    assert s.closed
    with pytest.raises(WireClosed):
        s.recv(deadline_s=0.05)
    a.close()
    a2, b2 = socket.socketpair()
    s2 = FrameConn(b2)
    a2.sendall(_small_frame()[:10])
    with pytest.raises(WireTimeout):
        s2.recv(deadline_s=0.05)
    assert s2.closed
    a2.close()


def test_trailing_garbage_after_valid_frame_fails_next_recv():
    data = _small_frame() + b"garbage-that-is-not-a-frame-header!!"
    a, b = socket.socketpair()
    c, s = FrameConn(a), FrameConn(b)
    a.sendall(data)
    kind, meta, arrays = s.recv(deadline_s=5.0)
    assert kind == "poll" and meta["ticket"] == 7
    with pytest.raises(WireError, match="bad frame header"):
        s.recv(deadline_s=5.0)
    c.close(), s.close()


def test_payload_malformations_are_typed():
    with pytest.raises(WireError, match="failed to decode"):
        parse_payload(b"\xff\xfe not json")
    with pytest.raises(WireError, match="expected dict"):
        parse_payload(b"[1, 2, 3]")
    with pytest.raises(WireError, match="carries no blob"):
        parse_payload(b'{"kind": "ok", "arrays": {"v": {}}}')
    bad = (b'{"arrays": {"v": {"dtype": "float64", "shape": [64], '
           b'"offset": 0, "nbytes": 512, "crc32": 0}}, "kind": "ok"}'
           b"\x00" + b"\x00" * 8)
    with pytest.raises(WireError, match="short"):
        parse_payload(bad)


def test_frame_missing_kind_is_typed():
    a, b = socket.socketpair()
    s = FrameConn(b)
    a.sendall(frame(encode_payload({"no_kind": True})))
    with pytest.raises(WireError, match="no kind"):
        s.recv(deadline_s=5.0)
    a.close(), s.close()


def test_remote_error_preserves_the_member_side_class():
    e = RemoteError("EnsembleConservationError", "lane 3 diverged")
    assert e.remote_type == "EnsembleConservationError"
    assert "EnsembleConservationError" in str(e)
    assert "lane 3 diverged" in str(e)


# -- the wire_torn seam -------------------------------------------------------

def test_wire_torn_corrupt_fires_the_receivers_crc():
    c, s = conn_pair()
    c.chaos_id = "m0g0"
    plan = FaultPlan((Fault("wire_torn", channel="m0g0", offset=30,
                            nbytes=4, tear="corrupt"),))
    with inject.armed(plan) as st:
        c.send("poll", {"ticket": 1})
    assert [f["kind"] for f in st.fired] == ["wire_torn"]
    with pytest.raises(WireError):
        s.recv(deadline_s=5.0)
    c.close(), s.close()


def test_wire_torn_truncate_closes_like_a_crash_mid_write():
    c, s = conn_pair()
    c.chaos_id = "m0g0"
    plan = FaultPlan((Fault("wire_torn", channel="m0g0", offset=9,
                            tear="truncate"),))
    with inject.armed(plan) as st:
        c.send("poll", {"ticket": 1})
    assert [f["kind"] for f in st.fired] == ["wire_torn"]
    assert c.closed
    with pytest.raises(WireClosed):
        s.recv(deadline_s=5.0)
    s.close()


def test_wire_torn_pinned_to_another_member_does_not_fire():
    c, s = conn_pair()
    c.chaos_id = "m0g0"
    plan = FaultPlan((Fault("wire_torn", channel="m9g9",
                            tear="corrupt"),))
    with inject.armed(plan) as st:
        c.send("poll", {"ticket": 1})
        kind, meta, _ = s.recv(deadline_s=5.0)
    assert kind == "poll" and meta["ticket"] == 1
    assert not st.fired
    c.close(), s.close()


def test_sticky_wire_faults_must_pin_their_member():
    for kind in ("wire_torn", "heartbeat_loss", "proc_kill",
                 "tcp_partition"):
        with pytest.raises(ValueError, match="must pin its"):
            Fault(kind, once=False)


def test_a_jax_plan_arms_the_ports_wire_seam():
    """``inject.armed`` takes the JAX package's plan: the same firing."""
    c, s = conn_pair()
    c.chaos_id = "m0g0"
    plan = jinject.FaultPlan((jinject.Fault(
        "wire_torn", channel="m0g0", offset=30, nbytes=4, tear="corrupt"),))
    with inject.armed(plan) as st:
        c.send("poll", {"ticket": 1})
    assert [f["kind"] for f in st.fired] == ["wire_torn"]
    with pytest.raises(WireError):
        s.recv(deadline_s=5.0)
    c.close(), s.close()


# -- TCP and the HMAC handshake -----------------------------------------------

HS_SECRET = "tw-test-secret"


def _serve_on_thread(sock, secret=HS_SECRET, chaos_id=None, serve=None):
    """``serve_handshake`` on a thread; a failure lands in ``errs``."""
    errs: list = []
    serve = serve_handshake if serve is None else serve

    def run():
        try:
            serve(sock, secret, chaos_id=chaos_id)
        except (WireError, jwire.WireError) as e:
            errs.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, errs


def authed_pair():
    """A mutually authenticated socketpair: (server sock, client sock)."""
    a, b = socket.socketpair()
    t, errs = _serve_on_thread(a)
    client_handshake(b, HS_SECRET)
    t.join(5.0)
    assert not errs, errs
    return a, b


def test_handshake_then_bitwise_roundtrip_over_socketpair():
    a, b = authed_pair()
    c, s = FrameConn(b), FrameConn(a)
    c.send("submit", {"ticket": 11}, SCENARIO_ARRAYS)
    kind, meta, arrays = s.recv(deadline_s=5.0)
    assert kind == "submit" and meta["ticket"] == 11
    for k, v in SCENARIO_ARRAYS.items():
        assert arrays[k].numpy().tobytes() == np.ascontiguousarray(
            np.asarray(v)).tobytes()
    c.close(), s.close()


def test_tcp_listener_dial_handshake_roundtrip():
    """Ephemeral listener, ``tcp_dial``, the mutual handshake, one frame
    bit for bit."""
    srv = tcp_listener()
    host, port = srv.getsockname()[:2]
    got = {}

    def accept():
        sock, _ = srv.accept()
        serve_handshake(sock, HS_SECRET)
        got["sock"] = sock

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    cs = tcp_dial(f"{host}:{port}")
    client_handshake(cs, HS_SECRET)
    t.join(5.0)
    c, s = FrameConn(cs), FrameConn(got["sock"])
    c.send("poll", {"ticket": 5}, SCENARIO_ARRAYS)
    kind, meta, arrays = s.recv(deadline_s=5.0)
    assert kind == "poll" and meta["ticket"] == 5
    for k, v in SCENARIO_ARRAYS.items():
        assert arrays[k].numpy().tobytes() == np.ascontiguousarray(
            np.asarray(v)).tobytes()
    c.close(), s.close(), srv.close()


def test_tcp_dial_unreachable_is_typed():
    srv = tcp_listener()
    host, port = srv.getsockname()[:2]
    srv.close()
    with pytest.raises(WireClosed):
        tcp_dial(f"{host}:{port}", deadline_s=2.0)
    with pytest.raises(ValueError, match="host:port"):
        tcp_dial("no-port-here")


def test_handshake_wrong_secret_refused_both_sides():
    a, b = socket.socketpair()
    t, errs = _serve_on_thread(a, secret=HS_SECRET)
    with pytest.raises(HandshakeError):
        client_handshake(b, "the-wrong-secret")
    t.join(5.0)
    assert len(errs) == 1 and isinstance(errs[0], HandshakeError)
    assert "wrong wire secret" in str(errs[0])


def test_handshake_truncated_challenge_is_typed():
    a, b = socket.socketpair()
    a.sendall(b"TWA1 abc")
    a.close()
    with pytest.raises(HandshakeError):
        client_handshake(b, HS_SECRET)


def test_handshake_garbled_magic_is_typed():
    a, b = socket.socketpair()
    a.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 999999\r\n\r\n")
    with pytest.raises(HandshakeError):
        client_handshake(b, HS_SECRET)
    a.close()


def test_handshake_slow_peer_hits_the_deadline():
    a, b = socket.socketpair()  # the listener never sends a challenge
    with pytest.raises(HandshakeError):
        client_handshake(b, HS_SECRET, deadline_s=0.2)
    a.close()


def test_handshake_fail_chaos_seam_garbles_the_proof():
    a, b = socket.socketpair()
    plan = FaultPlan((Fault("handshake_fail", channel="m7g0"),))
    with inject.armed(plan) as st:
        t, errs = _serve_on_thread(a)
        with pytest.raises(HandshakeError):
            client_handshake(b, HS_SECRET, chaos_id="m7g0")
        t.join(5.0)
    assert [f["kind"] for f in st.fired] == ["handshake_fail"]
    assert len(errs) == 1 and "wrong wire secret" in str(errs[0])


def test_tcp_torn_at_every_boundary_after_handshake():
    data = _small_frame()
    for i in range(len(data)):
        a, b = authed_pair()
        a.sendall(data[:i])
        a.close()
        s = FrameConn(b)
        with pytest.raises(WireError):
            s.recv(deadline_s=5.0)
        s.close()


def test_tcp_bit_flip_at_every_position_after_handshake():
    data = _small_frame()
    for i in range(len(data)):
        flipped = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        a, b = authed_pair()
        a.sendall(flipped)
        a.close()
        s = FrameConn(b)
        with pytest.raises(WireError):
            s.recv(deadline_s=5.0)
        s.close()


def test_tcp_partition_seam_closes_and_times_out_on_send():
    c, s = conn_pair()
    c.chaos_id = "m0g0"
    plan = FaultPlan((Fault("tcp_partition", channel="m0g0"),))
    with inject.armed(plan) as st:
        with pytest.raises(WireTimeout):
            c.send("poll", {"ticket": 1})
    assert [f["kind"] for f in st.fired] == ["tcp_partition"]
    assert c.closed
    s.close()


def test_tcp_partition_seam_fires_on_recv_too():
    c, s = conn_pair()
    s.chaos_id = "m1g0"
    plan = FaultPlan((Fault("tcp_partition", channel="m1g0"),))
    with inject.armed(plan) as st:
        c.send("poll", {"ticket": 1})
        with pytest.raises(WireTimeout):
            s.recv(deadline_s=5.0)
    assert [f["kind"] for f in st.fired] == ["tcp_partition"]
    c.close()


# -- the formats across the packages ------------------------------------------

CROSS_META = {"ticket": 9, "steps": 8, "dim_x": 8, "dim_y": 8,
              "t_wall": 1700000000.25, "service_id": "m0g0",
              "trace": {"trace_id": "ab" * 8, "span_id": "cd" * 4}}


@pytest.mark.parametrize("which", ["f64", "f32", "int", "bool", "bf16",
                                   "all"])
def test_payload_and_frame_bytes_equal_jax(which):
    """``frame(encode_payload(...))`` of the same message is the same bytes
    in both packages, for each array type and for all of them at once; a
    port tensor gives the bytes of the numpy array JAX encodes."""
    port = {"f64": torch.from_numpy(SCENARIO_ARRAYS["value"]),
            "f32": torch.from_numpy(SCENARIO_ARRAYS["f32"]),
            "int": torch.from_numpy(SCENARIO_ARRAYS["ids"]),
            "bool": torch.from_numpy(SCENARIO_ARRAYS["mask"]),
            "bf16": BF16_T}
    jax_side = {"f64": SCENARIO_ARRAYS["value"],
                "f32": SCENARIO_ARRAYS["f32"],
                "int": SCENARIO_ARRAYS["ids"],
                "bool": SCENARIO_ARRAYS["mask"], "bf16": BF16_NP}
    keys = list(port) if which == "all" else [which]
    pa = {k: port[k] for k in keys}
    ja = {k: jax_side[k] for k in keys}
    mine = frame(encode_payload(dict(CROSS_META, kind="submit"), pa))
    theirs = jwire.frame(jwire.encode_payload(dict(CROSS_META,
                                                   kind="submit"), ja))
    assert mine == theirs
    # numpy input to the port's codec gives the same bytes too
    assert frame(encode_payload(dict(CROSS_META, kind="submit"),
                                {k: v for k, v in ja.items()
                                 if k != "bf16"} or None)) == jwire.frame(
        jwire.encode_payload(dict(CROSS_META, kind="submit"),
                             {k: v for k, v in ja.items()
                              if k != "bf16"} or None))


def test_each_package_reads_the_others_frames():
    """A port frame read by JAX's ``FrameConn`` and a JAX frame read by the
    port's: the same kind, meta and bits (bf16 included)."""
    jarrays = dict(SCENARIO_ARRAYS, b16=BF16_NP)
    parrays = dict(SCENARIO_ARRAYS, b16=BF16_T)
    a, b = socket.socketpair()
    pc, jc = FrameConn(a), jwire.FrameConn(b)
    pc.send("submit", CROSS_META, parrays)
    kind, meta, got = jc.recv(deadline_s=5.0)
    assert kind == "submit" and meta["ticket"] == 9
    assert got["b16"].dtype == ml_dtypes.bfloat16
    assert got["b16"].view(np.uint16).tobytes() == BF16_BITS.tobytes()
    for k, v in SCENARIO_ARRAYS.items():
        assert got[k].tobytes() == v.tobytes() and got[k].dtype == v.dtype
    jc.send("ok", CROSS_META, jarrays)
    kind, meta, got = pc.recv(deadline_s=5.0)
    assert kind == "ok" and meta["trace"] == CROSS_META["trace"]
    assert torch.equal(got["b16"].view(torch.int16),
                       BF16_T.view(torch.int16))
    for k, v in SCENARIO_ARRAYS.items():
        g = got[k].numpy()
        assert g.tobytes() == v.tobytes() and g.dtype == v.dtype
    assert pc.bytes_out == jc.bytes_in and jc.bytes_out == pc.bytes_in
    pc.close(), jc.close()


def test_handshakes_interoperate_across_the_packages():
    """A JAX listener authenticates a port dialer and the other way round;
    a wrong secret is refused across the packages too."""
    for serve, client in ((jwire.serve_handshake, client_handshake),
                          (serve_handshake, jwire.client_handshake)):
        a, b = socket.socketpair()
        t, errs = _serve_on_thread(a, serve=serve)
        client(b, HS_SECRET)
        t.join(5.0)
        assert not errs
        a.close(), b.close()
    a, b = socket.socketpair()
    t, errs = _serve_on_thread(a, serve=jwire.serve_handshake)
    with pytest.raises(HandshakeError):
        client_handshake(b, "the-wrong-secret")
    t.join(5.0)
    assert len(errs) == 1 and "wrong wire secret" in str(errs[0])


def test_constants_equal_jax():
    assert (REQUEST_KINDS, REPLY_KINDS, MAX_FRAME_BYTES) == (
        jwire.REQUEST_KINDS, jwire.REPLY_KINDS, jwire.MAX_FRAME_BYTES)
    assert (wire.TRACE_META_KEY, wire.SECRET_ENV, wire.HANDSHAKE_DEADLINE_S,
            wire.TCP_HEARTBEAT_DEADLINE_S, wire.TCP_RPC_DEADLINE_S) == (
        jwire.TRACE_META_KEY, jwire.SECRET_ENV, jwire.HANDSHAKE_DEADLINE_S,
        jwire.TCP_HEARTBEAT_DEADLINE_S, jwire.TCP_RPC_DEADLINE_S)
