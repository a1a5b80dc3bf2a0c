"""Command line of the port (the part of tendermint_tpu/cli.py ported so
far): the ``verifyd`` subcommand, which runs the verification sidecar
(crypto/verifyd.py) or queries a running one.

    python -m tendermint_tpu_torch.cli verifyd --sock /path/vd.sock [--device cuda]
    python -m tendermint_tpu_torch.cli verifyd --sock /path/vd.sock --stats

The daemon verifies on ``--device`` ("cuda" by default; without a card
it exits with an error unless ``--device cpu`` is given) and stops on
SIGINT or SIGTERM. The node commands (init, start, testnet, …) wait for
the node (ROADMAP item 17).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def cmd_verifyd(args) -> int:
    """Run the verification sidecar: one process owns the card and
    serves batched signature verification to every node process on this
    host over a Unix-domain socket. Point nodes at it with
    TMTPU_VERIFYD_SOCK or `VerifyHubConfig.verifyd_sock`. With --stats,
    query a running daemon's telemetry instead (attach counts,
    occupancy, shed) and print JSON."""
    import logging

    from .crypto.verifyd import VerifyDaemon, client_for

    sock = os.path.expanduser(args.sock) or os.path.join(
        os.path.expanduser(args.home), "verifyd.sock"
    )
    if args.stats:
        stats = client_for(sock).remote_stats()
        if stats is None:
            print(f"no verifyd reachable on {sock}", file=sys.stderr)
            return 1
        print(json.dumps(stats, indent=2, sort_keys=True))
        return 0

    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")

    async def run() -> None:
        daemon = VerifyDaemon(
            sock,
            device=args.device,
            max_batch=args.max_batch,
            window_ms=args.window_ms,
            cache_size=args.cache,
            max_inflight=args.max_inflight,
            warm_backend=not args.no_warm,
        )
        await daemon.start()
        print(f"verifyd listening on {sock}", flush=True)
        stop = asyncio.Event()
        import signal

        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        try:
            await stop.wait()
        finally:
            await daemon.stop()

    asyncio.run(run())
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tendermint-tpu-torch",
        description="BFT node tools of the PyTorch/CUDA port",
    )
    parser.add_argument("--home", default="~/.tendermint_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    p_vd = sub.add_parser(
        "verifyd",
        help="run the verification sidecar (one card shared by every node "
        "process on this host over a Unix socket)",
    )
    p_vd.add_argument("--sock", default="", help="UDS path (default <home>/verifyd.sock)")
    p_vd.add_argument(
        "--device", default="cuda",
        help="where the daemon verifies: cuda (default; needs a card) or cpu",
    )
    p_vd.add_argument("--max-batch", type=int, default=None)
    p_vd.add_argument("--window-ms", type=float, default=None)
    p_vd.add_argument("--cache", type=int, default=None)
    p_vd.add_argument(
        "--max-inflight",
        type=int,
        default=None,
        help="in-flight signature cap before busy-shedding",
    )
    p_vd.add_argument(
        "--no-warm",
        action="store_true",
        help="skip building and loading the kernels at start",
    )
    p_vd.add_argument(
        "--stats",
        action="store_true",
        help="query a running daemon's telemetry as JSON and exit",
    )
    p_vd.set_defaults(fn=cmd_verifyd)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
