"""The port's Router, PeerManager, TestNetwork and PEX reactor
(tendermint_tpu_torch/p2p/) on the CPU, against the JAX package's:

- `TestNetwork(4)`: broadcast and point-to-point delivery, a PeerError
  that disconnects, a malformed message that the receiver's channel
  turns into a PeerError (and a disconnect), and a redial after a drop —
  the port's mirror of tests/test_p2p.py's router cases, with the same
  outcome in both packages;
- the PeerManager call sequences of tests/test_p2p.py's peer-manager
  cases, on a manual clock, give the reference's dial order, scores,
  bans and updates;
- PEX discovery: a node that knows one peer learns the other's address
  through PexRequest / PexResponse and dials it.

Every port entry point runs on device="cpu"; the routers touch no
device."""

from __future__ import annotations

import asyncio
import types

import pytest

import tendermint_tpu.p2p.peermanager as j_pm
import tendermint_tpu.p2p.pex as j_pex
import tendermint_tpu.p2p.tcp as j_tcp
import tendermint_tpu.p2p.testing as j_testing
import tendermint_tpu.p2p.types as j_types
import tendermint_tpu_torch.p2p.peermanager as p_pm
import tendermint_tpu_torch.p2p.pex as p_pex
import tendermint_tpu_torch.p2p.tcp as p_tcp
import tendermint_tpu_torch.p2p.testing as p_testing
import tendermint_tpu_torch.p2p.types as p_types

REF = types.SimpleNamespace(pm=j_pm, pex=j_pex, testing=j_testing, types=j_types, tcp=j_tcp,
                            kw={})
PORT = types.SimpleNamespace(pm=p_pm, pex=p_pex, testing=p_testing, types=p_types,
                             tcp=p_tcp, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])


async def _until(cond, timeout: float = 10.0) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline
        await asyncio.sleep(0.01)


# -- the router over TestNetwork ---------------------------------------------


async def _broadcast_and_direct(pkg):
    net = pkg.testing.TestNetwork(4, **pkg.kw)
    chans = net.open_channel(0x77, name="test")
    await net.start()
    try:
        a, b, c, d = net.nodes
        await chans[a.node_id].send(
            pkg.types.Envelope(channel_id=0x77, message=b"hi-all", broadcast=True))
        got = []
        for node in (b, c, d):
            env = await asyncio.wait_for(chans[node.node_id].receive(), 5)
            got.append((env.message, env.from_ == a.node_id))
        await chans[b.node_id].send(
            pkg.types.Envelope(channel_id=0x77, message=b"direct", to=c.node_id))
        env = await asyncio.wait_for(chans[c.node_id].receive(), 5)
        got.append((env.message, env.from_ == b.node_id))
        await asyncio.sleep(0.05)
        quiet = [chans[n.node_id].in_q.empty() for n in (a, b, d)]
        return got, quiet, [len(n.peer_manager.connected_peers()) for n in net.nodes]
    finally:
        await net.stop()


@PKGS
def test_broadcast_and_point_to_point(pkg):
    got, quiet, peers = asyncio.run(_broadcast_and_direct(pkg))
    assert got == [(b"hi-all", True)] * 3 + [(b"direct", True)]
    assert quiet == [True] * 3 and peers == [3] * 4


async def _error_and_malformed(pkg):
    import json

    net = pkg.testing.TestNetwork(3, **pkg.kw)
    chans = net.open_channel(0x50, name="json", encode=lambda m: json.dumps(m).encode(),
                             decode=lambda b: json.loads(b.decode()))
    await net.start()
    try:
        a, b, c = net.nodes
        # the codec: an object out, the same object in
        await chans[a.node_id].send(pkg.types.Envelope(0x50, {"x": 1}, to=b.node_id))
        env = await asyncio.wait_for(chans[b.node_id].receive(), 5)
        out = [env.message]
        # a PeerError reported on a channel disconnects the peer
        sub = a.peer_manager.subscribe()
        await chans[a.node_id].error(pkg.types.PeerError(b.node_id, "misbehaved"))
        upd = await asyncio.wait_for(sub.get(), 5)
        out.append((upd.node_id == b.node_id, upd.status.value,
                    b.node_id in a.peer_manager.connected_peers()))
        # malformed bytes: c's channel cannot decode them, so c's router
        # reports a PeerError against a and drops it
        c_sub = c.peer_manager.subscribe()
        await chans[a.node_id].send(pkg.types.Envelope(0x50, b"\xff not json", to=c.node_id))
        upd = await asyncio.wait_for(c_sub.get(), 5)
        out.append((upd.node_id == a.node_id, upd.status.value,
                    c.peer_manager.peer_score(a.node_id)))
        return out
    finally:
        await net.stop()


@PKGS
def test_peer_error_and_malformed_message_disconnect(pkg):
    out = asyncio.run(_error_and_malformed(pkg))
    # connect +1, then the malformed message's PeerError -5
    assert out == [{"x": 1}, (True, "down", False), (True, "down", -4)]


async def _reconnect(pkg):
    net = pkg.testing.TestNetwork(2, **pkg.kw)
    net.open_channel(0x77, name="test")
    await net.start()
    try:
        a, b = net.nodes
        await a.router._disconnect_peer(b.node_id)
        dropped = b.node_id not in a.peer_manager.connected_peers()
        await _until(lambda: b.node_id in a.peer_manager.connected_peers())
        return dropped
    finally:
        await net.stop()


@PKGS
def test_reconnect_after_disconnect(pkg):
    assert asyncio.run(_reconnect(pkg))


async def _chaos_shells(pkg, chaos_mod) -> tuple:
    """Two shells of `pkg` under one seeded ChaosNetwork (every message
    corrupted, one extra transport each): the wrapping, and the frames
    shell 0's router delivers to shell 1's channel."""
    net = chaos_mod.ChaosNetwork(chaos_mod.ChaosConfig(seed=9, corrupt_rate=1.0))
    mem = pkg.testing.MemoryNetwork()
    extra = [pkg.tcp.TCPTransport() for _ in range(2)]  # registered, never listening
    shells = [pkg.testing.RouterShell(mem, i, "c", chaos=net, extra_transports=[extra[i]],
                                      **pkg.kw) for i in range(2)]
    chans = [sh.router.open_channel(0x77, name="t", priority=1, encode=bytes,
                                    decode=bytes) for sh in shells]
    for sh in shells:
        await sh.router.start()
    shells[0].peer_manager.add_address(shells[1].address())
    try:
        for _ in range(200):
            if shells[1].node_id in shells[0].peer_manager.connected_peers():
                break
            await asyncio.sleep(0.01)
        for i in range(5):
            await chans[0].out_q.put(pkg.types.Envelope(0x77, bytes([i]) * 40,
                                                        to=shells[1].node_id))
        got = [(await asyncio.wait_for(chans[1].in_q.get(), 5)).message for _ in range(5)]
    finally:
        for sh in shells:
            await sh.router.stop()
    wrapped = [(type(sh.transport).__name__, type(sh.transport.inner).__name__,
                [type(t).__name__ for t in sh.extra_transports]) for sh in shells]
    return wrapped, got, net.faults["corrupt"]


def test_router_shell_refuses_chaos():
    """`RouterShell(chaos=)` wraps its memory transport and its extra
    transports in the ChaosNetwork's `ChaosTransport`, as the reference
    does, and the live byte path carries the fault plan: the frames
    shell 0 sends arrive corrupted, byte-equal to the reference's. (The
    port refused a chaos network until libs/chaos.py was ported.)"""
    import tendermint_tpu.libs.chaos as j_chaos
    import tendermint_tpu_torch.libs.chaos as p_chaos

    a = p_testing.RouterShell(p_testing.MemoryNetwork(), 3, "c", device="cpu")
    j = j_testing.RouterShell(j_testing.MemoryNetwork(), 3, "c")
    assert (a.node_id, a.node_info, str(a.address())) == (
        j.node_id, p_types.NodeInfo(**j.node_info.__dict__), str(j.address()))
    ref = asyncio.run(asyncio.wait_for(_chaos_shells(REF, j_chaos), 30))
    port = asyncio.run(asyncio.wait_for(_chaos_shells(PORT, p_chaos), 30))
    assert port == ref
    wrapped, got, corrupt = port
    assert wrapped == [("ChaosTransport", "MemoryTransport", ["ChaosTransport"])] * 2
    assert [type(t.inner).__name__ for t in (p_testing.RouterShell(
        p_testing.MemoryNetwork(), 0, "c", chaos=p_chaos.ChaosNetwork(),
        extra_transports=[p_tcp.TCPTransport()], device="cpu").extra_transports)] == \
        ["TCPTransport"]
    assert corrupt >= 5 and all(g != bytes([i]) * 40 for i, g in enumerate(got))


# -- the peer manager ----------------------------------------------------------


def _pm_sequence(pkg, monkeypatch) -> list:
    """tests/test_p2p.py's peer-manager cases, one after another, on a
    manual clock; every observable recorded."""
    import time as _time

    now = {"t": 1000.0}
    monkeypatch.setattr(_time, "monotonic", lambda: now["t"])
    PM, T = pkg.pm.PeerManager, pkg.types
    out: list = []
    addr = lambda nid: T.NodeAddress(node_id=nid, protocol="memory")  # noqa: E731

    # dial retry and backoff
    pm = PM("self", min_retry_time=10.0)
    pm.add_address(addr("peer1"))
    out.append(str(pm.try_dial_next()))
    pm.dial_failed(addr("peer1"))
    out.append(pm.try_dial_next())
    now["t"] += 10.0
    out.append(str(pm.try_dial_next()))
    # dial order: persistent first, then score, then fewer failures
    pm = PM("self")
    for nid, persistent in (("p1", False), ("p2", False), ("p3", True), ("self", False)):
        out.append(pm.add_address(addr(nid), persistent=persistent))
    order = []
    while (a := pm.try_dial_next()) is not None:
        order.append(a.node_id)
        pm.connected(a.node_id, inbound=False)
    out.append(order)
    # connected limits and updates
    pm = PM("self", max_connected=1, max_connected_upper=2)
    sub = pm.subscribe()
    out.append([pm.connected(p, inbound=True) for p in ("p1", "p1", "p2", "p3")])
    out.append(pm.evict_candidate())
    pm.disconnected("p1")
    out.append(pm.connected_peers())
    out.append(_drain(sub))
    # scores, bans and the escalating quarantine
    pm = PM("self")
    pm.add_address(addr("bad"))
    pm.connected("bad", inbound=False)
    pm.errored(T.PeerError("bad", "bad vote"))
    out.append(pm.peer_score("bad"))
    pm.errored(T.PeerError("bad", "repeated timeouts", ban=True))
    pm.disconnected("bad")
    out.append((pm.peer_score("bad"), pm.is_banned("bad"), pm.try_dial_next(),
                pm.connected("bad", inbound=True)))
    now["t"] += PM.BAN_BASE_COOLDOWN + 1
    out.append((pm.is_banned("bad"), str(pm.try_dial_next())))
    pm.connected("bad", inbound=False)
    pm.errored(T.PeerError("bad", "again", ban=True))
    pm.disconnected("bad")
    now["t"] += PM.BAN_BASE_COOLDOWN + 1
    out.append(pm.is_banned("bad"))
    now["t"] += PM.BAN_BASE_COOLDOWN
    out.append((pm.is_banned("bad"), pm.peer_score("bad"), pm.peer_score("nobody")))
    return out


def _drain(q) -> list:
    out = []
    while not q.empty():
        u = q.get_nowait()
        out.append((u.node_id, u.status.value))
    return out


def test_peer_manager_sequences_equal_the_reference(monkeypatch):
    port = _pm_sequence(PORT, monkeypatch)
    monkeypatch.undo()
    ref = _pm_sequence(REF, monkeypatch)
    assert port == ref
    assert port[7] == ["p3", "p1", "p2"] and port[-1] == (False, -43, None)


# -- PEX -----------------------------------------------------------------------


async def _pex_discovery(pkg):
    net = pkg.testing.TestNetwork(3, **pkg.kw)
    chans = net.open_channel(pkg.pex.PEX_CHANNEL, name="pex", priority=1,
                             encode=pkg.pex.encode_message, decode=pkg.pex.decode_message)
    reactors = [pkg.pex.PexReactor(n.peer_manager, chans[n.node_id],
                                   n.peer_manager.subscribe()) for n in net.nodes]
    await net.start(mesh=False)
    for r in reactors:
        await r.start()
    try:
        a, b, c = net.nodes
        a.peer_manager.add_address(b.address())  # a knows b; c knows only a
        c.peer_manager.add_address(a.address())
        await _until(lambda: set(c.peer_manager.connected_peers()) == {a.node_id, b.node_id},
                     timeout=20)
        return sorted(str(x) for x in c.peer_manager.all_known())
    finally:
        for r in reactors:
            await r.stop()
        await net.stop()


@PKGS
def test_pex_discovery(pkg, monkeypatch):
    monkeypatch.setattr(pkg.pex, "REQUEST_INTERVAL", 0.05)
    known = asyncio.run(_pex_discovery(pkg))
    assert len(known) == 2
