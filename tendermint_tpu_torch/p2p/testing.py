"""In-process p2p test network (reference internal/p2p/p2ptest/network.go
MakeNetwork) — N routers over the shared in-memory transport, fully
meshed. The load-bearing fixture that lets every distributed protocol be
unit-tested without sockets (SURVEY.md §4). The port's copy of
tendermint_tpu/p2p/testing.py.

`RouterShell` and `TestNetwork` take `device=` like every entry point of
the port: "cuda" by default, which raises without a card; "cpu" asks for
the host. The routers themselves touch no device; the device is what a
caller's reactors on the shell or network run on (`.device`)."""

from __future__ import annotations

import asyncio
import hashlib

from ..crypto import ed25519
from ..device import DEFAULT_DEVICE, resolve
from .memory import MemoryNetwork
from .peermanager import PeerManager, PeerStatus
from .router import Router
from .types import NodeAddress, NodeInfo, node_id_from_pubkey


class RouterShell:
    """The router-backed p2p shell shared by the chaos harnesses
    (tests/chaos_net.py blocksync nets, consensus/routernet.py consensus
    nets): deterministic node key, in-memory transport — chaos-wrapped
    when a `ChaosNetwork` is given — peer manager, and a Router. Callers
    open their reactor channels on `shell.router` and subscribe peer
    updates on `shell.peer_manager`.

    Keys are derived from (key_seed, index), so rebuilding a shell with
    the same coordinates yields the same node id — the in-process analog
    of a process restart keeping its node key."""

    def __init__(
        self,
        memory: MemoryNetwork,
        index: int,
        chain_id: str,
        *,
        chaos=None,  # libs/chaos.ChaosNetwork — wraps the transport
        key_seed: str = "router-shell",
        moniker: str = "",
        max_connected: int = 64,
        peer_queue_size: int = 4096,
        # additional transports (e.g. a TCP/UDS socket transport for
        # RouterNet-XL inter-process links) — chaos-wrapped like the
        # memory transport, registered on the router by PROTOCOL
        extra_transports: list | None = None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve(device)
        self.index = index
        self.priv_key = ed25519.Ed25519PrivKey(
            hashlib.sha256(f"tmtpu:{key_seed}:{index}".encode()).digest()
        )
        self.node_id = node_id_from_pubkey(self.priv_key.pub_key())
        self.node_info = NodeInfo(
            node_id=self.node_id,
            network=chain_id,
            moniker=moniker or f"node{index}",
        )
        inner = memory.create_transport(self.node_id)
        self.transport = (
            chaos.wrap(inner, self.node_id) if chaos is not None else inner
        )
        self.extra_transports = [
            chaos.wrap(t, self.node_id) if chaos is not None else t
            for t in (extra_transports or [])
        ]
        self.peer_manager = PeerManager(
            self.node_id, max_connected=max_connected
        )
        self.router = Router(
            self.node_info,
            self.priv_key,
            self.peer_manager,
            [self.transport, *self.extra_transports],
            peer_queue_size=peer_queue_size,
        )

    def address(self) -> NodeAddress:
        return NodeAddress(node_id=self.node_id, protocol="memory")


class TestNode:
    __test__ = False  # not a pytest class

    def __init__(self, network: "TestNetwork", index: int, chain_id: str):
        self.priv_key = ed25519.Ed25519PrivKey(
            bytes([index + 1]) * 31 + bytes([0x7F])
        )
        self.node_id = node_id_from_pubkey(self.priv_key.pub_key())
        self.node_info = NodeInfo(
            node_id=self.node_id, network=chain_id, moniker=f"node{index}"
        )
        self.transport = network.memory.create_transport(self.node_id)
        self.peer_manager = PeerManager(self.node_id, max_connected=64)
        self.router = Router(
            self.node_info, self.priv_key, self.peer_manager, [self.transport]
        )

    def address(self) -> NodeAddress:
        return NodeAddress(node_id=self.node_id, protocol="memory")


class TestNetwork:
    __test__ = False

    def __init__(self, n: int, chain_id: str = "test-chain", *, device=DEFAULT_DEVICE):
        self.device = resolve(device)
        self.memory = MemoryNetwork()
        self.nodes = [TestNode(self, i, chain_id) for i in range(n)]

    def open_channel(self, channel_id: int, **kwargs) -> dict[str, object]:
        """Open the same channel on every node; returns node_id → Channel."""
        return {
            node.node_id: node.router.open_channel(channel_id, **kwargs)
            for node in self.nodes
        }

    async def start(self, *, mesh: bool = True) -> None:
        for node in self.nodes:
            await node.router.start()
        if mesh:
            for i, a in enumerate(self.nodes):
                for b in self.nodes[i + 1 :]:
                    a.peer_manager.add_address(b.address())
            await self.wait_for_mesh()

    async def wait_for_mesh(self, timeout: float = 10.0) -> None:
        """Wait until every node sees every other node UP."""

        async def _one(node: TestNode):
            want = {n.node_id for n in self.nodes} - {node.node_id}
            while set(node.peer_manager.connected_peers()) != want:
                await asyncio.sleep(0.01)

        await asyncio.wait_for(
            asyncio.gather(*(_one(n) for n in self.nodes)), timeout
        )

    async def stop(self) -> None:
        for node in self.nodes:
            await node.router.stop()
