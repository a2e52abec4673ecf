"""Serve the port's control plane: ``python -m agentfield_tpu_torch.control_plane
--host 127.0.0.1 --port 8800 [--db PATH]``. SIGTERM or Ctrl-C stops it (the
execution journal drained first)."""

from __future__ import annotations

import argparse
import asyncio
import signal

from agentfield_tpu_torch.control_plane.server import ControlPlane, run_server


async def _main(args) -> None:
    cp = ControlPlane(db_path=args.db)
    runner = await run_server(cp, args.host, args.port)
    print(f"control plane serving on http://{args.host}:{runner.addresses[0][1]}", flush=True)
    done = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, done.set)
    await done.wait()
    await runner.cleanup()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--db", default=":memory:", help="SQLite path (':memory:' by default)")
    asyncio.run(_main(ap.parse_args()))


if __name__ == "__main__":
    main()
