"""The port's wire (tendermint_tpu_torch/p2p/, crypto/softcrypto.py,
crypto/xchacha20poly1305.py, libs/flowrate.py) against the JAX package's,
on the CPU:

- NodeInfo, NodeAddress and PEX frames, and the address book's file, are
  byte-equal to the reference's;
- softcrypto's ChaCha20-Poly1305, X25519 and HKDF-SHA256, and the
  XChaCha20-Poly1305 AEAD, equal the reference's softcrypto and the
  OpenSSL-backed `cryptography` on inputs seeded with numpy;
- the flowrate RateLimiter and Meter give the reference's sleeps and
  rates on a manual clock;
- a SecretStream handshake and frame exchange between the port and the
  reference, in both directions, over a socket pair, and a tampered frame
  rejected by both;
- a port TCPTransport dials a reference TCPTransport, and the reverse.

The tolerance is zero (bytes)."""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import types

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes as c_hashes
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

import tendermint_tpu.crypto.ed25519 as j_ed
import tendermint_tpu.crypto.softcrypto as j_soft
import tendermint_tpu.crypto.xchacha20poly1305 as j_xc
import tendermint_tpu.libs.flowrate as j_flow
import tendermint_tpu.p2p.addrbook as j_book
import tendermint_tpu.p2p.pex as j_pex
import tendermint_tpu.p2p.secret as j_secret
import tendermint_tpu.p2p.tcp as j_tcp
import tendermint_tpu.p2p.types as j_types
import tendermint_tpu_torch.crypto.ed25519 as p_ed
import tendermint_tpu_torch.crypto.softcrypto as p_soft
import tendermint_tpu_torch.crypto.xchacha20poly1305 as p_xc
import tendermint_tpu_torch.libs.flowrate as p_flow
import tendermint_tpu_torch.p2p.addrbook as p_book
import tendermint_tpu_torch.p2p.pex as p_pex
import tendermint_tpu_torch.p2p.secret as p_secret
import tendermint_tpu_torch.p2p.tcp as p_tcp
import tendermint_tpu_torch.p2p.types as p_types

REF = types.SimpleNamespace(name="ref", ed=j_ed, secret=j_secret, tcp=j_tcp, types=j_types)
PORT = types.SimpleNamespace(name="port", ed=p_ed, secret=p_secret, tcp=p_tcp, types=p_types)
PAIRS = [(PORT, REF), (REF, PORT), (PORT, PORT)]
PAIR_IDS = ["port-dials-ref", "ref-dials-port", "port-dials-port"]


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# -- frames ----------------------------------------------------------------


def test_node_info_and_address_bytes_equal_the_reference():
    rng = _rng(1)
    for i in range(8):
        kw = dict(
            node_id=_bytes(rng, 20).hex(), network=f"chain-{i}",
            listen_addr=f"tcp://10.0.0.{i}:{26656 + i}", version=f"0.{i}.0",
            channels=_bytes(rng, i), moniker="m" * i,
        )
        p, j = p_types.NodeInfo(**kw), j_types.NodeInfo(**kw)
        assert p.encode() == j.encode()
        assert p_types.NodeInfo.decode(j.encode()) == p
        assert j_types.NodeInfo.decode(p.encode()) == j
    other = p_types.NodeInfo(node_id="cd" * 20, network="chain-y")
    assert p.compatible_with(other) == j.compatible_with(j_types.NodeInfo(**other.__dict__))
    for s in ("tcp://ABCD1234@127.0.0.1:26656", "memory:ff00", "unix://aa@/run/x.sock:0"):
        p, j = p_types.NodeAddress.parse(s), j_types.NodeAddress.parse(s)
        assert (str(p), p.endpoint(), p.__dict__) == (str(j), j.endpoint(), j.__dict__)
        assert p_types.NodeAddress.parse(str(p)) == p
    key = p_ed.Ed25519PrivKey(bytes(range(32)))
    assert p_types.node_id_from_pubkey(key.pub_key()) == j_types.node_id_from_pubkey(
        j_ed.Ed25519PrivKey(bytes(range(32))).pub_key())


def test_pex_frames_equal_the_reference():
    addrs = tuple(f"tcp://{'ab' * 20}@10.0.0.{i}:{i}" for i in range(5)) + ("memory:ff",)
    for pm, jm in ((p_pex.PexRequest(), j_pex.PexRequest()),
                   (p_pex.PexResponse(addrs), j_pex.PexResponse(addrs)),
                   (p_pex.PexResponse(()), j_pex.PexResponse(()))):
        raw = p_pex.encode_message(pm)
        assert raw == j_pex.encode_message(jm)
        assert p_pex.decode_message(raw) == pm
    too_many = j_pex.encode_message(j_pex.PexResponse(("memory:a",) * (p_pex.MAX_ADDRESSES + 1)))
    for mod in (p_pex, j_pex):
        with pytest.raises(ValueError, match="exceeds"):
            mod.decode_message(too_many)


def test_address_book_file_equals_the_reference(tmp_path):
    entries = lambda T: [  # noqa: E731
        {"address": T.NodeAddress.parse(f"tcp://{'%02x' % i * 20}@10.0.0.{i}:{100 + i}"),
         "persistent": i % 2 == 0, "good": i % 3 == 0, "attempts": i, "last_success_ms": 7 * i}
        for i in range(6)
    ] + [{"address": T.NodeAddress.parse("memory:ee"), "persistent": False}]
    p_path, j_path = tmp_path / "p" / "addrbook.json", tmp_path / "j" / "addrbook.json"
    p_book.AddressBook(str(p_path)).save(entries(p_types))
    j_book.AddressBook(str(j_path)).save(entries(j_types))
    assert p_path.read_bytes() == j_path.read_bytes()
    loaded = p_book.AddressBook(str(j_path)).load()
    ref = j_book.AddressBook(str(p_path)).load()
    assert [(str(e["address"]), e["persistent"], e["good"]) for e in loaded] == \
        [(str(e["address"]), e["persistent"], e["good"]) for e in ref]
    # a corrupt file and a malformed entry are skipped alike
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"addrs": [{"addr": "no-scheme"}, {"addr": "memory:aa"}]}))
    assert [str(e["address"]) for e in p_book.AddressBook(str(bad)).load()] == ["memory:aa"]
    bad.write_text("{not json")
    assert p_book.AddressBook(str(bad)).load() == j_book.AddressBook(str(bad)).load() == []


# -- softcrypto ----------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1026, 4099])
def test_chacha20poly1305_equals_the_reference_and_openssl(n):
    rng = _rng(100 + n)
    key, nonce, data, aad = _bytes(rng, 32), _bytes(rng, 12), _bytes(rng, n), _bytes(rng, n % 17)
    sealed = p_soft.ChaCha20Poly1305(key).encrypt(nonce, data, aad or None)
    assert sealed == j_soft.ChaCha20Poly1305(key).encrypt(nonce, data, aad or None)
    assert sealed == ChaCha20Poly1305(key).encrypt(nonce, data, aad or None)
    assert p_soft.ChaCha20Poly1305(key).decrypt(nonce, sealed, aad or None) == data
    forged = bytearray(sealed)
    forged[len(forged) // 2] ^= 1
    with pytest.raises(p_soft.InvalidTag):
        p_soft.ChaCha20Poly1305(key).decrypt(nonce, bytes(forged), aad or None)


def test_x25519_and_hkdf_equal_the_reference_and_openssl():
    rng = _rng(7)
    for _ in range(4):
        a, b = _bytes(rng, 32), _bytes(rng, 32)
        pa, pb = p_soft.X25519PrivateKey(a), p_soft.X25519PrivateKey(b)
        oa, ob = X25519PrivateKey.from_private_bytes(a), X25519PrivateKey.from_private_bytes(b)
        assert pa.public_key().public_bytes_raw() == oa.public_key().public_bytes_raw() \
            == j_soft.X25519PrivateKey(a).public_key().public_bytes_raw()
        shared = pa.exchange(pb.public_key())
        assert shared == pb.exchange(pa.public_key()) == oa.exchange(ob.public_key())
        assert shared == j_soft.x25519(a, pb.public_key().public_bytes_raw())
        for length, info in ((96, p_secret.HKDF_INFO), (42, b"other")):
            out = p_soft.hkdf_sha256(shared, length, info)
            assert out == j_soft.hkdf_sha256(shared, length, info)
            assert out == HKDF(algorithm=c_hashes.SHA256(), length=length, salt=None,
                               info=info).derive(shared)


def test_xchacha20poly1305_equals_the_reference():
    rng = _rng(9)
    for n in (0, 5, 200, 3000):
        key, nonce, data, aad = _bytes(rng, 32), _bytes(rng, 24), _bytes(rng, n), _bytes(rng, 3)
        assert p_xc.hchacha20(key, nonce[:16]) == j_xc.hchacha20(key, nonce[:16])
        sealed = p_xc.XChaCha20Poly1305(key).seal(nonce, data, aad)
        assert sealed == j_xc.XChaCha20Poly1305(key).seal(nonce, data, aad)
        assert p_xc.XChaCha20Poly1305(key).open(nonce, sealed, aad) == data
        with pytest.raises(p_xc.InvalidTag):
            p_xc.XChaCha20Poly1305(key).open(nonce, sealed[:-1] + bytes([sealed[-1] ^ 1]), aad)
    # the draft's HChaCha20 test vector (draft-irtf-cfrg-xchacha-03 §2.2.1)
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a0000000031415927")
    assert p_xc.hchacha20(key, nonce).hex() == (
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")


# -- flowrate ------------------------------------------------------------------


class _ManualTime:
    def __init__(self):
        self.t = 100.0

    def monotonic(self) -> float:
        return self.t


def _flow_run(mod, monkeypatch) -> tuple[list, list]:
    clock, slept = _ManualTime(), []

    async def sleep(s):
        slept.append(round(s, 9))
        clock.t += s

    monkeypatch.setattr(mod.time, "monotonic", clock.monotonic)
    monkeypatch.setattr(mod.asyncio, "sleep", sleep)

    async def go():
        lim = mod.RateLimiter(1000, burst=500)
        meter = mod.Meter(window_s=1.0)
        rates = []
        for n in (200, 400, 800, 100, 5000, 50):
            await lim.throttle(n)
            meter.update(n)
            rates.append((round(meter.rate, 6), meter.total, lim.would_block(300)))
            clock.t += 0.1
        clock.t += 10
        rates.append((meter.rate, meter.total, lim.would_block(300)))
        return rates

    return asyncio.run(go()), slept


def test_flowrate_equals_the_reference_on_a_manual_clock(monkeypatch):
    p_rates, p_slept = _flow_run(p_flow, monkeypatch)
    monkeypatch.undo()
    j_rates, j_slept = _flow_run(j_flow, monkeypatch)
    assert p_rates == j_rates and p_slept == j_slept
    assert p_slept and p_rates[-1][0] == 0.0  # it throttled, and the idle rate decays


# -- the secret connection -----------------------------------------------------


async def _stream_pair(server_pkg, client_pkg, server_priv, client_priv):
    """A socket pair carrying a SecretStream of each package, handshaken."""
    a, b = socket.socketpair()
    ra, wa = await asyncio.open_connection(sock=a)
    rb, wb = await asyncio.open_connection(sock=b)
    srv = server_pkg.secret.SecretStream(ra, wa)
    cli = client_pkg.secret.SecretStream(rb, wb)
    peer_of_srv, peer_of_cli = await asyncio.gather(
        srv.handshake(server_priv), cli.handshake(client_priv))
    return srv, cli, peer_of_srv, peer_of_cli, (wa, wb)


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_secret_stream_handshake_and_frames_across_packages(server, client):
    seed = bytes(range(32))

    async def go():
        s_priv = server.ed.Ed25519PrivKey(seed)
        c_priv = client.ed.Ed25519PrivKey(bytes(reversed(seed)))
        srv, cli, peer_of_srv, peer_of_cli, writers = await _stream_pair(
            server, client, s_priv, c_priv)
        assert peer_of_srv.bytes() == c_priv.pub_key().bytes()
        assert peer_of_cli.bytes() == s_priv.pub_key().bytes()
        payload = _bytes(_rng(3), 5000)  # spans five sealed frames
        await cli.write_all(payload)
        got = await srv.read_exactly(5000)
        await srv.write_all(got[::-1])
        back = await cli.read_exactly(5000)
        # tampered: a garbage sealed frame after a good one is refused
        await srv.write_all(b"ok")
        writers[0].write(b"\x00" * p_secret.SEALED_FRAME_SIZE)
        await writers[0].drain()
        assert await cli.read_exactly(2) == b"ok"
        with pytest.raises(Exception):
            await cli.read_exactly(1)
        srv.close()
        cli.close()
        return got, back

    got, back = asyncio.run(go())
    assert got == _bytes(_rng(3), 5000) and back == got[::-1]


@pytest.mark.parametrize("impl", [PORT, REF], ids=["port", "ref"])
def test_secret_stream_refuses_a_bad_ephemeral_key_length(impl):
    async def go():
        a, b = socket.socketpair()
        ra, wa = await asyncio.open_connection(sock=a)
        _rb, wb = await asyncio.open_connection(sock=b)
        wb.write(struct.pack(">H", 4096) + bytes(64))
        await wb.drain()
        s = impl.secret.SecretStream(ra, wa)
        with pytest.raises(impl.secret.AuthError, match="ephemeral key length"):
            await s.handshake(impl.ed.Ed25519PrivKey(bytes(32)))
        s.close()
        wb.close()

    asyncio.run(go())


# -- TCP transports ------------------------------------------------------------


@pytest.mark.parametrize("dialer,listener", PAIRS, ids=PAIR_IDS)
def test_tcp_transport_across_packages(dialer, listener):
    async def go():
        d_priv = dialer.ed.Ed25519PrivKey(b"\x11" * 32)
        l_priv = listener.ed.Ed25519PrivKey(b"\x22" * 32)
        d_info = dialer.types.NodeInfo(
            node_id=dialer.types.node_id_from_pubkey(d_priv.pub_key()), network="c")
        l_info = listener.types.NodeInfo(
            node_id=listener.types.node_id_from_pubkey(l_priv.pub_key()), network="c")
        td, tl = dialer.tcp.TCPTransport(), listener.tcp.TCPTransport()
        await tl.listen("127.0.0.1:0")
        host, port = tl.endpoint().rsplit(":", 1)

        async def serve():
            conn = await tl.accept()
            peer = await conn.handshake(l_info, l_priv)
            ch, data = await conn.receive_message()
            await conn.send_message(ch, data.upper())
            return conn, peer

        task = asyncio.create_task(serve())
        conn = await td.dial(dialer.types.NodeAddress(
            node_id=l_info.node_id, host=host, port=int(port)))
        peer = await conn.handshake(d_info, d_priv)
        await conn.send_message(0x42, b"hello" * 700)  # spans frames
        got = await conn.receive_message()
        sconn, speer = await task
        moved = (conn.send_meter.total, conn.recv_meter.total,
                 sconn.send_meter.total, sconn.recv_meter.total)
        await conn.close()
        await sconn.close()
        await td.close()
        await tl.close()
        return peer, speer, got, moved, l_info, d_info

    peer, speer, got, moved, l_info, d_info = asyncio.run(go())
    assert (peer.node_id, speer.node_id) == (l_info.node_id, d_info.node_id)
    assert got == (0x42, b"HELLO" * 700)
    assert moved == (3506, 3506, 3506, 3506)  # payload + the 6-byte header, each way
