"""Authenticated encrypted stream (reference
internal/p2p/conn/secret_connection.go:92).

Station-to-Station handshake: X25519 ephemeral ECDH → HKDF-SHA256 derives
one AEAD key per direction plus a 32-byte challenge → each side proves
its node identity with an ed25519 signature over the challenge, sent on
the already-encrypted link (secret_connection.go:55,120-150,371).

Data moves in fixed-size sealed frames (1024 data bytes + 2-byte length
prefix per frame, like the reference's 1024/1028+16 frame layout) so
message sizes do not leak; per-direction 96-bit nonces are little-endian
frame counters.

The port's copy of tendermint_tpu/p2p/secret.py: the same handshake and
frames, so a port node and a reference node talk to each other. The
challenge signature is checked on the host (one ed25519 verification a
connection, as in the reference); no device takes part."""

from __future__ import annotations

import asyncio
import struct

try:
    from cryptography.hazmat.primitives import hashes as c_hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    def _hkdf96(shared: bytes) -> bytes:
        return HKDF(
            algorithm=c_hashes.SHA256(), length=96, salt=None, info=HKDF_INFO
        ).derive(shared)

except ImportError:  # degraded path: pure-Python RFC 7748/5869/8439
    from ..crypto.softcrypto import (
        ChaCha20Poly1305,
        X25519PrivateKey,
        X25519PublicKey,
        hkdf_sha256,
    )

    def _hkdf96(shared: bytes) -> bytes:
        return hkdf_sha256(shared, 96, HKDF_INFO)

from ..crypto import ed25519
from ..libs import protoenc as pe

DATA_LEN_SIZE = 2
DATA_MAX_SIZE = 1024
FRAME_SIZE = DATA_LEN_SIZE + DATA_MAX_SIZE  # plaintext frame
SEALED_FRAME_SIZE = FRAME_SIZE + 16  # + poly1305 tag
HKDF_INFO = b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"
# handshake frame bounds (the never-load-tested path hardened for
# RouterNet-XL): the cleartext ephemeral key is exactly 32 bytes and
# the encrypted auth frame (pubkey + challenge signature, protoenc) is
# ~100 bytes — reject anything bigger BEFORE allocating for it
EPH_KEY_LEN = 32
MAX_AUTH_FRAME = 512


class AuthError(ConnectionError):
    pass


class _Nonce:
    """96-bit little-endian counter nonce, one per direction."""

    __slots__ = ("counter",)

    def __init__(self):
        self.counter = 0

    def next(self) -> bytes:
        n = b"\x00\x00\x00\x00" + struct.pack("<Q", self.counter)
        self.counter += 1
        return n


class SecretStream:
    """Encrypted framed stream over an asyncio reader/writer pair."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._send_aead: ChaCha20Poly1305 | None = None
        self._recv_aead: ChaCha20Poly1305 | None = None
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()
        self._recv_buf = b""
        self.remote_pub_key: ed25519.Ed25519PubKey | None = None

    # -- handshake -------------------------------------------------------

    async def handshake(self, priv_key: ed25519.Ed25519PrivKey) -> ed25519.Ed25519PubKey:
        """Run the STS handshake; returns the authenticated peer pubkey."""
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        # exchange ephemeral pubkeys in the clear
        self._writer.write(struct.pack(">H", len(eph_pub)) + eph_pub)
        await self._writer.drain()
        (n,) = struct.unpack(">H", await self._reader.readexactly(2))
        if n != EPH_KEY_LEN:
            # a torn or hostile dialer: refuse before reading a single
            # byte of whatever it claims to be sending
            raise AuthError("bad ephemeral key length")
        their_eph = await self._reader.readexactly(EPH_KEY_LEN)

        shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(their_eph))
        loc_is_least = eph_pub < their_eph
        okm = _hkdf96(shared)
        if loc_is_least:
            recv_key, send_key = okm[:32], okm[32:64]
        else:
            send_key, recv_key = okm[:32], okm[32:64]
        challenge = okm[64:]
        self._send_aead = ChaCha20Poly1305(send_key)
        self._recv_aead = ChaCha20Poly1305(recv_key)

        # prove node identity over the encrypted link
        sig = priv_key.sign(challenge)
        auth = pe.bytes_field(1, priv_key.pub_key().bytes()) + pe.bytes_field(2, sig)
        if len(auth) > MAX_AUTH_FRAME:
            raise AuthError("auth frame exceeds handshake bound")
        await self.write_all(auth)
        their_auth = await self.read_exactly(len(auth))
        r = pe.Reader(their_auth)
        their_pub = their_sig = b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                their_pub = r.read_bytes()
            elif f == 2:
                their_sig = r.read_bytes()
            else:
                r.skip(wt)
        peer_key = ed25519.Ed25519PubKey(their_pub)
        if not peer_key.verify_signature(challenge, their_sig):
            raise AuthError("challenge signature verification failed")
        self.remote_pub_key = peer_key
        return peer_key

    # -- sealed frames ---------------------------------------------------

    async def write_all(self, data: bytes) -> None:
        """Chunk into sealed frames and send."""
        view = memoryview(data)
        while True:
            chunk = view[:DATA_MAX_SIZE]
            view = view[DATA_MAX_SIZE:]
            frame = struct.pack(">H", len(chunk)) + bytes(chunk)
            frame += b"\x00" * (FRAME_SIZE - len(frame))
            sealed = self._send_aead.encrypt(self._send_nonce.next(), frame, None)
            self._writer.write(sealed)
            if not view:
                break
        await self._writer.drain()

    async def _read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
        frame = self._recv_aead.decrypt(self._recv_nonce.next(), sealed, None)
        (n,) = struct.unpack(">H", frame[:DATA_LEN_SIZE])
        if n > DATA_MAX_SIZE:
            raise ConnectionError("corrupt frame length")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + n]

    async def read_exactly(self, n: int) -> bytes:
        while len(self._recv_buf) < n:
            self._recv_buf += await self._read_frame()
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass
