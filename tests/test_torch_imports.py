"""Guards of the port's package boundary and of its device rule:

- tendermint_tpu_torch imports neither jax nor tendermint_tpu (an AST scan,
  and a fresh interpreter in which importing jax fails);
- its entry points run on the card by default and raise without one,
  unless the caller asks for the CPU;
- importing it builds no kernel.
"""

import ast
import asyncio
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# the plain versions run on small tensors: one intra-op thread per process
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tendermint_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tendermint_tpu")


def _port_modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_ast_scan_finds_no_jax_or_reference_import():
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders
    assert len(_port_modules()) >= 20


def test_whole_port_imports_with_jax_blocked():
    mods = _port_modules()
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tendermint_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "from tendermint_tpu_torch.crypto.cuda import _build\n"
        "assert sorted(_build.KERNELS) == ['bls_final_exp', 'bls_miller', 'fe_mul', 'fe_pow22523', 'scan_blocks', 'sha256_bytes']\n"
        "assert not _build._libs and all(k.launches == 0 for k in _build.KERNELS.values())\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _entry_points():
    from tendermint_tpu_torch import convert
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.types import validation

    vals, keys = tt.make_validator_set(2)
    bid = tt.make_block_id(b"x")
    commit = tt.make_commit("c", 1, 0, bid, vals, keys)
    pub = vals.validators[0].pub_key
    return {
        "verify_commit": lambda **kw: validation.verify_commit("c", vals, bid, 1, commit, **kw),
        "verify_commit_light": lambda **kw: validation.verify_commit_light(
            "c", vals, bid, 1, commit, **kw
        ),
        "verify_commit_range": lambda **kw: validation.verify_commit_range(
            "c", [(vals, bid, 1, commit)], **kw
        ),
        "create_batch_verifier": lambda **kw: batch.create_batch_verifier(pub, **kw),
        "verify_batch_eq": lambda **kw: V.verify_batch_eq([], **kw),
        "verify_resolved": lambda **kw: V.verify_resolved([], **kw),
        "DeviceBatchVerifier": lambda **kw: V.DeviceBatchVerifier(**kw),
        "convert.limbs": lambda **kw: convert.limbs([[0] * 32], **kw),
    }


ENTRY_POINTS = [
    "DeviceBatchVerifier", "convert.limbs", "create_batch_verifier", "verify_batch_eq",
    "verify_commit", "verify_commit_light", "verify_commit_range", "verify_resolved",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _entry_points()
    assert sorted(points) == ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


def test_resolve_refuses_unknown_devices():
    from tendermint_tpu_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")


FUNNEL_MODULES = [
    "tendermint_tpu_torch.config",
    "tendermint_tpu_torch.crypto.batch",
    "tendermint_tpu_torch.crypto.secp256k1",
    "tendermint_tpu_torch.crypto.softcrypto",
    "tendermint_tpu_torch.crypto.sr25519",
    "tendermint_tpu_torch.crypto.verify_hub",
    "tendermint_tpu_torch.libs.clock",
    "tendermint_tpu_torch.libs.metrics",
    "tendermint_tpu_torch.libs.trace",
]


BLS_MODULES = [
    "tendermint_tpu_torch.crypto.bls",
    "tendermint_tpu_torch.crypto.bls_math",
    "tendermint_tpu_torch.crypto.cuda.bls_field",
    "tendermint_tpu_torch.crypto.cuda.bls_pairing",
]


def test_scan_and_blocked_import_cover_the_funnel_modules():
    """The AST scan and the jax-blocked import above walk every module of
    the package; the verification funnel's and the BLS path's modules are
    among them."""
    assert set(FUNNEL_MODULES + BLS_MODULES) <= set(_port_modules())


def _bls_entry_points():
    """BLS entry points, each on an input it refuses before any pairing
    (an all-zero aggregate signature does not decode)."""
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import batch, verify_hub
    from tendermint_tpu_torch.crypto.cuda import bls_pairing

    pub = tt.make_validator_set(1, key_types=("bls12381",))[0].validators[0].pub_key
    return {
        "bls_aggregate_verify": lambda **kw: batch.bls_aggregate_verify(
            [pub], [b"m"], bytes(96), **kw
        ),
        "verify_aggregate": lambda **kw: verify_hub.verify_aggregate(
            [pub], [b"m"], bytes(96), **kw
        ),
        "verify_items": lambda **kw: bls_pairing.verify_items([], **kw),
    }


@pytest.mark.parametrize("name", ["bls_aggregate_verify", "verify_aggregate", "verify_items"])
def test_bls_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    fn = _bls_entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    assert not fn(device="cpu").any() if name == "verify_items" else not fn(device="cpu")


def _funnel_entry_points():
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import batch, verify_hub
    from tendermint_tpu_torch.types import validation

    def commit_path(key_types, entry):
        vals, keys = tt.make_validator_set(2, key_types=key_types)
        bid = tt.make_block_id(b"y")
        commit = tt.make_commit("c", 1, 0, bid, vals, keys)
        if entry == "range":
            return lambda **kw: validation.verify_commit_range("c", [(vals, bid, 1, commit)], **kw)
        return lambda **kw: validation.verify_commit_light("c", vals, bid, 1, commit, **kw)

    def hub(**kw):
        verify_hub.acquire_hub(**kw)
        verify_hub.release_hub()

    sr_pub = tt.make_validator_set(1, key_types=("sr25519",))[0].validators[0].pub_key
    return {
        "AdaptiveBatchVerifier": lambda **kw: batch.AdaptiveBatchVerifier(**kw),
        "VerifyHub": lambda **kw: verify_hub.VerifyHub(**kw),
        "acquire_hub": hub,
        "create_batch_verifier[sr25519]": lambda **kw: batch.create_batch_verifier(sr_pub, **kw),
        "verify_commit_light[secp256k1]": commit_path(("secp256k1",), "light"),
        "verify_commit_light[sr25519]": commit_path(("sr25519",), "light"),
        "verify_commit_range[mixed]": commit_path(("ed25519", "secp256k1"), "range"),
        "verify_commit_range[sr25519]": commit_path(("sr25519",), "range"),
    }


FUNNEL_ENTRY_POINTS = [
    "AdaptiveBatchVerifier", "VerifyHub", "acquire_hub", "create_batch_verifier[sr25519]",
    "verify_commit_light[secp256k1]", "verify_commit_light[sr25519]",
    "verify_commit_range[mixed]", "verify_commit_range[sr25519]",
]


@pytest.mark.parametrize("name", FUNNEL_ENTRY_POINTS)
def test_funnel_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from tendermint_tpu_torch.crypto import verify_hub

    points = _funnel_entry_points()
    assert sorted(points) == FUNNEL_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    assert verify_hub.running_hub() is None  # a refused hub never starts
    fn(device="cpu")  # the host, when asked for, works


BLOCKSYNC_MODULES = [
    "tendermint_tpu_torch.abci.application",
    "tendermint_tpu_torch.abci.client",
    "tendermint_tpu_torch.abci.kvstore",
    "tendermint_tpu_torch.abci.types",
    "tendermint_tpu_torch.blocksync",
    "tendermint_tpu_torch.blocksync.messages",
    "tendermint_tpu_torch.blocksync.pool",
    "tendermint_tpu_torch.blocksync.reactor",
    "tendermint_tpu_torch.consensus.replay",
    "tendermint_tpu_torch.crypto.hash_hub",
    "tendermint_tpu_torch.crypto.merkle",
    "tendermint_tpu_torch.evidence",
    "tendermint_tpu_torch.libs.bits",
    "tendermint_tpu_torch.libs.fail",
    "tendermint_tpu_torch.libs.pubsub",
    "tendermint_tpu_torch.libs.service",
    "tendermint_tpu_torch.mempool",
    "tendermint_tpu_torch.p2p.peermanager",
    "tendermint_tpu_torch.p2p.router",
    "tendermint_tpu_torch.p2p.types",
    "tendermint_tpu_torch.proxy",
    "tendermint_tpu_torch.state.execution",
    "tendermint_tpu_torch.state.state",
    "tendermint_tpu_torch.state.store",
    "tendermint_tpu_torch.state.validation",
    "tendermint_tpu_torch.store.blockstore",
    "tendermint_tpu_torch.store.db",
    "tendermint_tpu_torch.types.events",
    "tendermint_tpu_torch.types.evidence",
    "tendermint_tpu_torch.types.genesis",
    "tendermint_tpu_torch.types.params",
    "tendermint_tpu_torch.types.part_set",
    "tendermint_tpu_torch.types.vote",
]


def test_scan_and_blocked_import_cover_the_blocksync_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; the block-sync slice's modules are among them."""
    assert set(BLOCKSYNC_MODULES) <= set(_port_modules())


def _blocksync_entry_points():
    import asyncio

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.blocksync import messages as bsm
    from tendermint_tpu_torch.blocksync.reactor import BlockSyncReactor
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.p2p.router import Channel
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB

    keys = tt.det_priv_keys(2)
    genesis = tt.make_genesis(keys, "c")
    conns = AppConns.local(KVStoreApp())
    state = state_from_genesis(genesis)

    def executor(**kw):
        return BlockExecutor(StateStore(MemDB()), conns.consensus, **kw)

    def reactor(**kw):
        ch = Channel(0x40, "blocksync", 5, bsm.encode_message, bsm.decode_message)
        return BlockSyncReactor(
            state, executor(device="cpu"), BlockStore(MemDB()), ch, asyncio.Queue(), **kw
        )

    return {
        "BlockExecutor": executor,
        "BlockSyncReactor": reactor,
        "Handshaker": lambda **kw: Handshaker(
            StateStore(MemDB()), state, BlockStore(MemDB()), genesis, **kw
        ),
        "build_kvstore_chain": lambda **kw: asyncio.run(
            tt.build_kvstore_chain(genesis, keys, 2, **kw)
        ),
    }


BLOCKSYNC_ENTRY_POINTS = ["BlockExecutor", "BlockSyncReactor", "Handshaker", "build_kvstore_chain"]


@pytest.mark.parametrize("name", BLOCKSYNC_ENTRY_POINTS)
def test_blocksync_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _blocksync_entry_points()
    assert sorted(points) == BLOCKSYNC_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


LIGHT_MODULES = [
    "tendermint_tpu_torch.libs.retry",
    "tendermint_tpu_torch.light",
    "tendermint_tpu_torch.light.client",
    "tendermint_tpu_torch.light.provider",
    "tendermint_tpu_torch.light.types",
    "tendermint_tpu_torch.light.verifier",
]


def test_scan_and_blocked_import_cover_the_light_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; the light client's modules are among them, and the types it
    adds elsewhere are there."""
    assert set(LIGHT_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch.types import evidence, validation

    assert callable(validation.verify_commit_light_trusting)
    assert evidence.LightClientAttackEvidence.TYPE == evidence.EVIDENCE_LIGHT_CLIENT_ATTACK


def _light_entry_points():
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.light import client, verifier
    from tendermint_tpu_torch.types import validation

    vals, keys = tt.make_validator_set(2)
    chain = tt.make_light_chain(3, vals, keys, "c")
    now = chain[-1].header.time_ns + 10**9
    period = 10**18

    def light_client(**kw):
        opts = client.TrustOptions(period, 1, chain[0].header.hash())
        lc = client.LightClient("c", opts, tt.make_list_provider(chain, "c"), **kw)
        return asyncio.run(lc.verify_light_block_at_height(3, now))

    return {
        "LightClient": light_client,
        "verify": lambda **kw: verifier.verify("c", chain[0], chain[2], period, now, **kw),
        "verify_adjacent": lambda **kw: verifier.verify_adjacent(
            "c", chain[0], chain[1], period, now, **kw
        ),
        "verify_adjacent_chain": lambda **kw: verifier.verify_adjacent_chain(
            "c", chain[0], chain[1:], period, now, **kw
        ),
        "verify_commit_light_trusting": lambda **kw: validation.verify_commit_light_trusting(
            "c", vals, chain[2].signed_header.commit, **kw
        ),
        "verify_non_adjacent": lambda **kw: verifier.verify_non_adjacent(
            "c", chain[0], chain[2], period, now, **kw
        ),
    }


LIGHT_ENTRY_POINTS = [
    "LightClient", "verify", "verify_adjacent", "verify_adjacent_chain",
    "verify_commit_light_trusting", "verify_non_adjacent",
]


@pytest.mark.parametrize("name", LIGHT_ENTRY_POINTS)
def test_light_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _light_entry_points()
    assert sorted(points) == LIGHT_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


STATESYNC_MODULES = [
    "tendermint_tpu_torch.crypto.cuda.sha256",
    "tendermint_tpu_torch.statesync",
    "tendermint_tpu_torch.statesync.fleet",
    "tendermint_tpu_torch.statesync.messages",
    "tendermint_tpu_torch.statesync.reactor",
]


def test_scan_and_blocked_import_cover_the_statesync_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; state sync's and the SHA-256 kernel's are among them."""
    assert set(STATESYNC_MODULES) <= set(_port_modules())


def _statesync_entry_points():
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.crypto import hash_hub
    from tendermint_tpu_torch.crypto.cuda import sha256
    from tendermint_tpu_torch.p2p.router import Channel
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.statesync import fleet
    from tendermint_tpu_torch.statesync import messages as ssm
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB

    vals, keys = tt.make_validator_set(2)
    chain = tt.make_light_chain(2, vals, keys, "c")

    def reactor(**kw):
        chs = [Channel(cid, "c", 5, ssm.encode_message, ssm.decode_message)
               for cid in (0x60, 0x61, 0x62, 0x63)]
        return StateSyncReactor("c", AppConns.local(KVStoreApp()), StateStore(MemDB()),
                                BlockStore(MemDB()), *chs, asyncio.Queue(), **kw)

    def use_device(device="cuda"):
        try:
            hash_hub.use_device(device)
        finally:
            hash_hub.use_device(None)

    return {
        "StateSyncReactor": reactor,
        "sha256_device": lambda **kw: sha256.sha256_device([b"abc"], **kw),
        "use_device": use_device,
        "verify_backfill_batch": lambda **kw: asyncio.run(
            fleet.verify_backfill_batch("c", chain, **kw)
        ),
    }


STATESYNC_ENTRY_POINTS = ["StateSyncReactor", "sha256_device", "use_device", "verify_backfill_batch"]


@pytest.mark.parametrize("name", STATESYNC_ENTRY_POINTS)
def test_statesync_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _statesync_entry_points()
    assert sorted(points) == STATESYNC_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


FLEET_MODULES = [
    "tendermint_tpu_torch.libs.watchdog",
    "tendermint_tpu_torch.light.byzantine",
    "tendermint_tpu_torch.light.fleet",
    "tendermint_tpu_torch.statesync.byzantine",
]


def test_scan_and_blocked_import_cover_the_fleet_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; LightD's, the lunatic provider's, the poisoned donor's and
    the watchdog's are among them, and the config and scenario they add
    elsewhere are there."""
    assert set(FLEET_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch import config
    from tendermint_tpu_torch import testing as tt

    assert config.LightDConfig().max_sessions == 64
    assert callable(tt.statesync_fleet_scenario)


def _fleet_entry_points():
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.light import client, fleet

    vals, keys = tt.make_validator_set(2)
    chain = tt.make_light_chain(3, vals, keys, "c")
    now = chain[-1].header.time_ns + 10**9
    opts = client.TrustOptions(10**18, 1, chain[0].header.hash())

    def lightd(**kw):
        async def go():
            d = fleet.LightD("c", opts, tt.make_list_provider(chain, "c"), **kw)
            await d.start()
            try:
                return await d.sync(3, now_ns=now)
            finally:
                await d.stop()

        return asyncio.run(go())

    return {
        "LightD": lightd,
        "statesync_fleet_scenario": lambda **kw: asyncio.run(
            tt.statesync_fleet_scenario(12, 2, 1, **kw)
        ),
        "verify_hop_proof": lambda **kw: fleet.verify_hop_proof(
            "c", chain[0], fleet.make_hop_proof(chain[2]), 10**18, now, **kw
        ),
    }


FLEET_ENTRY_POINTS = ["LightD", "statesync_fleet_scenario", "verify_hop_proof"]


@pytest.mark.parametrize("name", FLEET_ENTRY_POINTS)
def test_fleet_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _fleet_entry_points()
    assert sorted(points) == FLEET_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


MESH_MODULES = [
    "tendermint_tpu_torch.crypto.cuda.mesh",
]


def test_scan_and_blocked_import_cover_the_mesh_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; the sharded verifier's registry is among them, and the sharded kernels are in crypto/cuda/verify.py."""
    assert set(MESH_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch.crypto.cuda import verify

    assert callable(verify.make_sharded_kernel_eq) and callable(verify.make_sharded_kernel)


SIDECAR_MODULES = [
    "tendermint_tpu_torch.cli",
    "tendermint_tpu_torch.crypto.backend_telemetry",
    "tendermint_tpu_torch.crypto.verifyd",
    "tendermint_tpu_torch.evidence.pool",
    "tendermint_tpu_torch.evidence.reactor",
    "tendermint_tpu_torch.mempool.ingress",
    "tendermint_tpu_torch.mempool.pool",
    "tendermint_tpu_torch.mempool.reactor",
]


def test_scan_and_blocked_import_cover_the_sidecar_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; the sidecar's, the CLI's, the mempool's and the evidence
    pool's are among them, and the config sections they read are there."""
    assert set(SIDECAR_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch import config

    assert config.VerifyHubConfig().verifyd_sock == ""
    assert config.MempoolConfig().ingress.depth == 2048
    assert config.EvidenceConfig().max_pending == 1000


def _sidecar_entry_points():
    import os
    import tempfile

    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto.verifyd import VerifyDaemon
    from tendermint_tpu_torch.evidence.pool import EvidencePool
    from tendermint_tpu_torch.store.db import MemDB

    def daemon(**kw):
        async def go():
            d = VerifyDaemon(os.path.join(tempfile.mkdtemp(prefix="vd-"), "s"), **kw)
            await d.start()
            await d.stop()

        asyncio.run(go())

    def cli_verifyd(device=None):
        sock = os.path.join(tempfile.mkdtemp(prefix="vd-"), "s")
        args = ["verifyd", "--sock", sock, "--no-warm"] + (["--device", device] if device else [])
        if device != "cpu":
            return cli.main(args)
        # on the host: the daemon serves `--stats` and exits 0 on SIGTERM
        import signal
        import subprocess
        import sys
        import time

        proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.cli", *args],
                                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            deadline = time.monotonic() + 60
            while True:
                st = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch.cli", "verifyd",
                                     "--sock", sock, "--stats"], cwd=REPO, capture_output=True,
                                    text=True, timeout=60)
                if st.returncode == 0 or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            assert st.returncode == 0, st.stderr
            assert '"protocol_version": 1' in st.stdout
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def evidence_pool(**kw):
        bstore, sstore, _conns, _state = asyncio.run(tt.build_kvstore_chain(
            tt.make_genesis(tt.det_priv_keys(2), "c"), tt.det_priv_keys(2), 2, device="cpu"
        ))
        return EvidencePool(MemDB(), sstore, bstore, **kw)

    return {"EvidencePool": evidence_pool, "VerifyDaemon": daemon, "cli verifyd": cli_verifyd}


SIDECAR_ENTRY_POINTS = ["EvidencePool", "VerifyDaemon", "cli verifyd"]


@pytest.mark.parametrize("name", SIDECAR_ENTRY_POINTS)
def test_sidecar_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _sidecar_entry_points()
    assert sorted(points) == SIDECAR_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


CONSENSUS_MODULES = [
    "tendermint_tpu_torch.consensus.harness",
    "tendermint_tpu_torch.consensus.ingest",
    "tendermint_tpu_torch.consensus.messages",
    "tendermint_tpu_torch.consensus.peer_state",
    "tendermint_tpu_torch.consensus.reactor",
    "tendermint_tpu_torch.consensus.state",
    "tendermint_tpu_torch.consensus.ticker",
    "tendermint_tpu_torch.consensus.types",
    "tendermint_tpu_torch.consensus.wal",
    "tendermint_tpu_torch.libs.chaosfs",
    "tendermint_tpu_torch.privval",
    "tendermint_tpu_torch.types.vote_set",
]


def test_scan_and_blocked_import_cover_the_consensus_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; consensus's are among them, with the pieces it reads from
    modules ported earlier."""
    assert set(CONSENSUS_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch import config
    from tendermint_tpu_torch.consensus.replay import report_wal_repair
    from tendermint_tpu_torch.libs.metrics import STORAGE
    from tendermint_tpu_torch.types.events import EventDataRoundState
    from tendermint_tpu_torch.types.vote import Proposal

    cfg = config.ConsensusConfig()
    assert (cfg.ingest_pipeline, cfg.ingest_max_inflight, cfg.commit_scheme) == (True, 64, "per-sig")
    assert callable(report_wal_repair) and "wal_repairs" in STORAGE
    assert Proposal and EventDataRoundState


def _consensus_entry_points(tmp):
    import os

    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB

    genesis, keys = harness.make_genesis(1)

    def node(**kw):
        harness.Node(genesis, keys[0], wal_dir=os.path.join(tmp, "node"), **kw)

    def network(**kw):
        net = harness.LocalNetwork(1, **kw)
        for n in net.nodes:
            import shutil

            shutil.rmtree(n.wal_dir, ignore_errors=True)

    def consensus_state(**kw):
        # the state machine's device is its executor's, built by default
        executor = BlockExecutor(StateStore(MemDB()), LocalClient(KVStoreApp()), **kw)
        cs = ConsensusState(harness.fast_config(), state_from_genesis(genesis), executor,
                            BlockStore(MemDB()))
        assert cs.device == executor.device

    return {"ConsensusState": consensus_state, "LocalNetwork": network, "Node": node}


CONSENSUS_ENTRY_POINTS = ["ConsensusState", "LocalNetwork", "Node"]


@pytest.mark.parametrize("name", CONSENSUS_ENTRY_POINTS)
def test_consensus_entry_points_raise_without_cuda_unless_cpu_requested(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _consensus_entry_points(str(tmp_path))
    assert sorted(points) == CONSENSUS_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    fn(device="cpu")  # the host, when asked for, works


NODE_MODULES = [
    "tendermint_tpu_torch.crypto.softcrypto",
    "tendermint_tpu_torch.crypto.xchacha20poly1305",
    "tendermint_tpu_torch.libs.flowrate",
    "tendermint_tpu_torch.libs.metrics",
    "tendermint_tpu_torch.libs.trace",
    "tendermint_tpu_torch.node",
    "tendermint_tpu_torch.p2p.addrbook",
    "tendermint_tpu_torch.p2p.memory",
    "tendermint_tpu_torch.p2p.peermanager",
    "tendermint_tpu_torch.p2p.pex",
    "tendermint_tpu_torch.p2p.router",
    "tendermint_tpu_torch.p2p.secret",
    "tendermint_tpu_torch.p2p.tcp",
    "tendermint_tpu_torch.p2p.testing",
    "tendermint_tpu_torch.p2p.transport",
    "tendermint_tpu_torch.p2p.types",
    "tendermint_tpu_torch.state.indexer",
]


def test_scan_and_blocked_import_cover_the_node_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; the p2p stack's and the full node's are among them, with the
    pieces they read from modules ported earlier."""
    assert set(NODE_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch import config
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.libs.metrics import NodeMetrics, observe_block

    cfg = config.VerifyHubConfig()
    assert (cfg.enabled, cfg.mesh_scale) == (True, True)
    assert config.TraceConfig().ring_size == trace.DEFAULT_RING
    assert callable(trace.configure_once) and callable(trace.auto_dump)
    assert NodeMetrics and callable(observe_block)


def _node_entry_points():
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.p2p.memory import MemoryNetwork
    from tendermint_tpu_torch.p2p.testing import RouterShell, TestNetwork

    genesis, _ = harness.make_genesis(1)
    return {
        "Node": lambda **kw: Node(NodeConfig(), genesis, KVStoreApp(),
                                  ed25519.Ed25519PrivKey(bytes(32)),
                                  [MemoryNetwork().create_transport("n")], **kw),
        "RouterShell": lambda **kw: RouterShell(MemoryNetwork(), 0, "c", **kw),
        "TestNetwork": lambda **kw: TestNetwork(2, **kw),
    }


NODE_ENTRY_POINTS = ["Node", "RouterShell", "TestNetwork"]


@pytest.mark.parametrize("name", NODE_ENTRY_POINTS)
def test_node_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    points = _node_entry_points()
    assert sorted(points) == NODE_ENTRY_POINTS
    fn = points[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    assert fn(device="cpu").device == torch.device("cpu")  # the host, when asked for


SCENARIO_MODULES = [
    "tendermint_tpu_torch.consensus.byzantine",
    "tendermint_tpu_torch.consensus.routernet",
    "tendermint_tpu_torch.consensus.scenarios",
    "tendermint_tpu_torch.libs.chaos",
    "tendermint_tpu_torch.libs.chaosfs",
]


def test_scan_and_blocked_import_cover_the_scenario_modules():
    """The AST scan and the jax-blocked import walk every module of the
    package; the scenario harness's are among them, with the config
    sections and the device error they read."""
    assert set(SCENARIO_MODULES) <= set(_port_modules())
    from tendermint_tpu_torch import config
    from tendermint_tpu_torch.consensus import scenarios
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.libs import chaos, chaosfs

    assert config.ChaosNetConfig().enabled is False and config.ChaosFSConfig().enabled is False
    assert not chaos.ChaosConfig().enabled() and not chaosfs.ChaosFSConfig().enabled()
    assert issubclass(batch.DeviceError, RuntimeError)
    assert len(scenarios.SCENARIOS) == 17
    for fn in (scenarios.run_scenario, scenarios.run_sweep, scenarios.run_light_attack,
               scenarios.run_boot_wave):
        assert callable(fn)
